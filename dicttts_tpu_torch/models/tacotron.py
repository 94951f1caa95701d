"""Tacotron-family registry entries of FastSpeech2 (the CBHG encoder, the
Tacotron2 conv + BiLSTM encoder, the BiLSTM decoder) and the BertEncoder
scaffold.

Port of ``dicttts_tpu/models/tacotron.py``. As there, the norms are
stateless LayerNorms (eps 1e-4), the convolutions pad flax's "SAME" way
(even kernels one more on the right), and the bidirectional RNNs run over
the full padded length without packing: the backward direction reads the
sequence from its last padded step, as flax's ``nn.RNN(reverse=True,
keep_order=True)`` does. Both carries start at zero.

flax's cells map onto torch's fused ones:
- ``GRUCell``: input paths ``ir``, ``iz``, ``in`` with bias, recurrent
  paths ``hr`` and ``hz`` without and ``hn`` with bias; torch's gate order
  (r, z, n), with ``b_hr`` and ``b_hz`` held at 0;
- ``OptimizedLSTMCell``: input paths without bias and recurrent paths with
  bias; torch's gate order (i, f, g, o), with ``b_ih`` held at 0.

The biases flax does not have get a gradient hook that zeroes their
gradient, so training keeps them at 0 (AdamW steps a zero gradient by 0,
and decoupled weight decay keeps 0 at 0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dicttts_tpu_torch.models.fft_blocks import FFTBlocks
from dicttts_tpu_torch.models.layers import LayerNorm, conv1d_tc, dropout


def _hold_at_zero(param: nn.Parameter, rows: slice) -> None:
    """Zero ``param`` on ``rows`` and the gradient there on every backward."""
    with torch.no_grad():
        param[rows].zero_()

    def hook(g: torch.Tensor) -> torch.Tensor:
        g = g.clone()
        g[rows].zero_()
        return g

    param.register_hook(hook)


class BiGRU(nn.Module):
    """flax's pair of ``GRUCell`` RNNs, forward and reversed: [B, T, C] ->
    [B, T, 2 * features]."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.rnn = nn.GRU(in_features, features, batch_first=True, bidirectional=True)
        for name in ("bias_hh_l0", "bias_hh_l0_reverse"):  # b_hr, b_hz
            _hold_at_zero(getattr(self.rnn, name), slice(0, 2 * features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rnn(x)[0]


class BiLSTM(nn.Module):
    """flax's pair of ``OptimizedLSTMCell`` RNNs: [B, T, C] -> [B, T, 2 *
    features]."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.rnn = nn.LSTM(in_features, features, batch_first=True, bidirectional=True)
        for name in ("bias_ih_l0", "bias_ih_l0_reverse"):
            _hold_at_zero(getattr(self.rnn, name), slice(None))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rnn(x)[0]


class PreNet(nn.Module):
    """fc-relu-dropout, twice."""

    def __init__(self, in_dims: int, fc1_dims: int = 256, fc2_dims: int = 128, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.fc1 = nn.Linear(in_dims, fc1_dims)
        self.fc2 = nn.Linear(fc1_dims, fc2_dims)

    def forward(self, x, generator=None):
        x = dropout(torch.relu(self.fc1(x)), self.dropout, self.training, generator)
        return dropout(torch.relu(self.fc2(x)), self.dropout, self.training, generator)


class HighwayNetwork(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.W1 = nn.Linear(size, size)
        self.W2 = nn.Linear(size, size)

    def forward(self, x):
        g = torch.sigmoid(self.W2(x))
        return g * torch.relu(self.W1(x)) + (1.0 - g) * x


class NormConv(nn.Module):
    """conv (no bias, "SAME": an even kernel pads one more on the right) ->
    optional relu -> LayerNorm."""

    def __init__(self, in_channels: int, channels: int, kernel: int, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.pad = ((kernel - 1) // 2, kernel // 2)
        self.conv = nn.Conv1d(in_channels, channels, kernel, bias=False)
        self.norm = LayerNorm(channels)

    def forward(self, x):
        x = conv1d_tc(F.pad(x, (0, 0, *self.pad)), self.conv)
        return self.norm(torch.relu(x) if self.relu else x)


class CBHG(nn.Module):
    """Conv bank (k = 1..K) -> max-pool (2, stride 1, -inf on the right) ->
    two projection convs -> residual -> highways -> BiGRU."""

    def __init__(self, K: int, channels: int, proj_channels: tuple = (), num_highways: int = 4):
        super().__init__()
        proj = tuple(proj_channels) or (channels, channels)
        self.bank = nn.ModuleList(NormConv(channels, channels, k) for k in range(1, K + 1))
        self.proj1 = NormConv(K * channels, proj[0], 3)
        self.proj2 = NormConv(proj[0], proj[1], 3, relu=False)
        self.pre_highway = nn.Linear(proj[1], channels, bias=False) if proj[-1] != channels else None
        self.highways = nn.ModuleList(HighwayNetwork(channels) for _ in range(num_highways))
        self.rnn = BiGRU(channels, channels)

    def forward(self, x):
        residual = x
        bank = torch.cat([conv(x) for conv in self.bank], dim=-1)
        pooled = torch.maximum(bank, F.pad(bank, (0, 0, 0, 1), value=float("-inf"))[:, 1:])
        x = self.proj2(self.proj1(pooled)) + residual
        if self.pre_highway is not None:
            x = self.pre_highway(x)
        for highway in self.highways:
            x = highway(x)
        return self.rnn(x)


class TacotronEncoder(nn.Module):
    """embed -> PreNet -> CBHG -> linear."""

    def __init__(self, n_vocab: int, channels: int, K: int = 8, num_highways: int = 4,
                 dropout: float = 0.5):
        super().__init__()
        self.embed = nn.Embedding(n_vocab, channels)
        self.prenet = PreNet(channels, channels, channels, dropout)
        self.cbhg = CBHG(K, channels, num_highways=num_highways)
        self.proj = nn.Linear(2 * channels, channels)

    def forward(self, tokens, generator=None):
        x = self.prenet(self.embed(tokens.long()), generator)
        return self.proj(self.cbhg(x))


class Tacotron2Encoder(nn.Module):
    """embed -> 3 x [conv5, relu, norm, dropout 0.5, residual] -> BiLSTM,
    masked."""

    def __init__(self, n_vocab: int, channels: int, n_convolutions: int = 3, kernel_size: int = 5):
        super().__init__()
        self.embed = nn.Embedding(n_vocab, channels)
        self.convs = nn.ModuleList(NormConv(channels, channels, kernel_size)
                                   for _ in range(n_convolutions))
        self.rnn = BiLSTM(channels, channels // 2)

    def forward(self, tokens, generator=None):
        x = self.embed(tokens.long())
        for conv in self.convs:
            x = x + dropout(conv(x), 0.5, self.training, generator)
        x = self.rnn(x)
        return x * (tokens > 0).to(x.dtype)[:, :, None]


class DecoderRNN(nn.Module):
    """2 x conv9 (relu between) -> LayerNorm -> BiLSTM -> conv3, masked."""

    def __init__(self, hidden_size: int, decoder_rnn_dim: int = 0, dropout: float = 0.1):
        super().__init__()
        rnn_dim = decoder_rnn_dim or hidden_size * 2
        self.conv1 = nn.Conv1d(hidden_size, hidden_size, 9, padding="same")
        self.conv2 = nn.Conv1d(hidden_size, hidden_size, 9, padding="same")
        self.norm = LayerNorm(hidden_size)
        self.rnn = BiLSTM(hidden_size, rnn_dim)
        self.conv_out = nn.Conv1d(2 * rnn_dim, hidden_size, 3, padding="same")

    def forward(self, x, nonpadding, generator=None):
        mask = nonpadding[:, :, None].to(x.dtype)
        h = conv1d_tc(torch.relu(conv1d_tc(x, self.conv1)), self.conv2)
        h = self.norm(h) * mask
        h = self.rnn(h) * mask
        return conv1d_tc(h, self.conv_out) * mask


class BertEncoderScaffold(nn.Module):
    """FFT blocks + a char-prediction head (the masked-char pretraining
    scaffold): [B, T, H] -> (hidden [B, T, H], logits [B, T, num_chars])."""

    def __init__(self, num_chars: int, hidden_size: int, num_layers: int = 4, kernel_size: int = 3):
        super().__init__()
        self.blocks = FFTBlocks(hidden_size, num_layers, kernel_size)
        self.out = nn.Linear(hidden_size, num_chars)

    def forward(self, x, generator=None):
        nonpadding = (x.abs().sum(-1) > 0).to(x.dtype)
        h = self.blocks(x, nonpadding, generator)
        return h, self.out(h)
