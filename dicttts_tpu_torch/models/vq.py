"""EMA vector quantization (VQ-VAE) embedding.

Port of ``dicttts_tpu/models/vq.py`` (``VQEmbeddingEMA``): each input
vector takes its nearest codebook row (squared distance, the first on a
tie); the output passes the input's gradient straight through; the
commitment loss is the mean squared distance to the detached codes. In
training mode the codebook follows exponential moving averages of the
assignment counts (Laplace-smoothed) and of the assigned vectors' sums,
updated after the codes are read. The codebook and both averages are
buffers: they are saved with the module and get no gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class VQEmbeddingEMA(nn.Module):
    def __init__(self, n_embeddings: int, embedding_dim: int, decay: float = 0.999,
                 epsilon: float = 1e-5, generator: torch.Generator | None = None):
        super().__init__()
        self.n_embeddings, self.embedding_dim = n_embeddings, embedding_dim
        self.decay, self.epsilon = decay, epsilon
        embedding = torch.randn(n_embeddings, embedding_dim, generator=generator) * 0.1
        self.register_buffer("embedding", embedding)
        self.register_buffer("ema_count", torch.zeros(n_embeddings))
        self.register_buffer("ema_weight", embedding.clone())

    def forward(self, x: torch.Tensor):
        """x [..., D] -> (quantized [..., D] with the straight-through
        gradient, indices [...], {'commitment', 'perplexity'})."""
        flat = x.reshape(-1, self.embedding_dim)
        emb = self.embedding
        d = (flat.square().sum(1, keepdim=True) - 2 * flat @ emb.t() + emb.square().sum(1)[None, :])
        idx = torch.argmin(d, dim=-1)
        onehot = F.one_hot(idx, self.n_embeddings).to(flat.dtype)
        quantized = (onehot @ emb).reshape(x.shape)
        if self.training:
            with torch.no_grad():
                count = self.decay * self.ema_count + (1 - self.decay) * onehot.sum(0)
                n = count.sum()
                count = (count + self.epsilon) / (n + self.n_embeddings * self.epsilon) * n
                weight = self.decay * self.ema_weight + (1 - self.decay) * (onehot.t() @ flat.detach())
                self.ema_count.copy_(count)
                self.ema_weight.copy_(weight)
                self.embedding.copy_(weight / count[:, None])
        quantized = quantized.detach()
        commitment = torch.mean(torch.square(x - quantized))
        avg_probs = onehot.mean(0)
        perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
        return x + (quantized - x).detach(), idx.reshape(x.shape[:-1]), {
            "commitment": commitment, "perplexity": perplexity}
