"""GE2E speaker encoder (Resemblyzer's VoiceEncoder) and the GE2E loss.

Port of ``dicttts_tpu/models/speaker_encoder.py``: a 3-layer LSTM (40 ->
256) over mel frames, a linear layer with ReLU on the last layer's final
hidden state, L2-normalized (the norm floored at 1e-5). The module is
Resemblyzer's own layout (``lstm`` a ``torch.nn.LSTM``, ``linear``), so a
Resemblyzer ``state_dict`` loads as it is.

- ``embed_utterance``: Resemblyzer's partial windows (160 frames, half
  overlap, the last window flush with the end; an utterance shorter than a
  window zero-padded to one) through one batched forward, averaged and
  renormalized;
- ``ge2e_loss``: the GE2E softmax loss, whose own-speaker centroid leaves
  the utterance out;
- ``load_resemblyzer``: a Resemblyzer-format checkpoint as a module on the
  card (or on ``device``). One utterance's embedding from a checkpoint is
  ``ops/speaker.speaker_embed``, which raises on a checkpoint it cannot
  read.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dicttts_tpu_torch.utils.device import resolve_device

MEL_N_CHANNELS = 40  # Resemblyzer's mel front end
PARTIAL_N_FRAMES = 160


class GE2ESpeakerEncoder(nn.Module):
    def __init__(self, n_layers: int = 3, hidden_size: int = 256, embed_size: int = 256,
                 mel_n_channels: int = MEL_N_CHANNELS):
        super().__init__()
        self.lstm = nn.LSTM(mel_n_channels, hidden_size, n_layers, batch_first=True)
        self.linear = nn.Linear(hidden_size, embed_size)

    @classmethod
    def from_state_dict(cls, state_dict: dict) -> "GE2ESpeakerEncoder":
        """A module of the widths a Resemblyzer ``state_dict`` holds, loaded
        (keys outside ``lstm.`` and ``linear.`` are ignored)."""
        n_layers = sum(1 for k in state_dict if k.startswith("lstm.weight_ih_l"))
        hidden, mel_n = np.shape(state_dict["lstm.weight_hh_l0"])[1], np.shape(state_dict["lstm.weight_ih_l0"])[1]
        model = cls(n_layers, hidden, np.shape(state_dict["linear.weight"])[0], mel_n)
        model.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in state_dict.items()
                               if k.startswith(("lstm.", "linear."))})
        return model

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        """mels [B, T, 40] -> l2-normalized embeddings [B, embed_size]."""
        _, (h, _) = self.lstm(mels)
        e = torch.relu(self.linear(h[-1]))
        return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-5)


def partial_windows(mel: np.ndarray, partial_frames: int = PARTIAL_N_FRAMES,
                    overlap: float = 0.5) -> np.ndarray:
    """[T, C] -> [n, partial_frames, C]: windows every partial_frames *
    (1 - overlap) frames, plus one flush with the end where the last
    misses it."""
    T = len(mel)
    hop = max(int(partial_frames * (1 - overlap)), 1)
    if T < partial_frames:
        mel = np.pad(mel, ((0, partial_frames - T), (0, 0)))
        T = partial_frames
    starts = list(range(0, T - partial_frames + 1, hop))
    if starts[-1] + partial_frames < T:
        starts.append(T - partial_frames)
    return np.stack([mel[s:s + partial_frames] for s in starts])


@torch.no_grad()
def embed_utterance(model: GE2ESpeakerEncoder, mel: np.ndarray,
                    partial_frames: int = PARTIAL_N_FRAMES, overlap: float = 0.5) -> np.ndarray:
    """mel [T, 40] (numpy) -> the utterance's float32 embedding, computed on
    the model's device."""
    device = next(model.parameters()).device
    windows = torch.as_tensor(partial_windows(mel, partial_frames, overlap), dtype=torch.float32)
    e = model(windows.to(device)).mean(0).cpu().numpy()
    n = np.linalg.norm(e)
    return (e / n if n > 0 else e).astype(np.float32)


def ge2e_loss(embeds: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GE2E softmax loss. embeds [n_spk, n_utt, D] (l2-normalized); w, b the
    learned scale (floored at 1e-6) and bias: sim[j, i, k] = w cos(e_ji,
    c_k) + b, with c_j leaving utterance i out."""
    S, U, _ = embeds.shape
    centroids = embeds.mean(1)
    excl = (embeds.sum(1, keepdim=True) - embeds) / max(U - 1, 1)
    excl = excl / torch.clamp(torch.linalg.vector_norm(excl, dim=-1, keepdim=True), min=1e-5)
    cnorm = centroids / torch.clamp(torch.linalg.vector_norm(centroids, dim=-1, keepdim=True), min=1e-5)
    sim = torch.einsum("jud,kd->juk", embeds, cnorm)
    own = torch.einsum("jud,jud->ju", embeds, excl)
    eye = torch.eye(S, dtype=embeds.dtype, device=embeds.device)[:, None, :]
    logits = torch.clamp(w, min=1e-6) * (sim * (1 - eye) + own[:, :, None] * eye) + b
    labels = torch.arange(S, device=embeds.device)[:, None].expand(S, U)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[:, :, None]).mean()


def load_resemblyzer(ckpt_path: str, device="cuda") -> GE2ESpeakerEncoder:
    """A Resemblyzer checkpoint (a torch file holding ``model_state`` or the
    ``state_dict`` itself) as an eval-mode module on ``device``."""
    device = resolve_device(device)
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state = payload.get("model_state", payload)
    return GE2ESpeakerEncoder.from_state_dict(state).to(device).eval()
