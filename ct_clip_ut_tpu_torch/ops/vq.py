"""Cosine-similarity vector quantisation with a straight-through estimator.

Counterpart of ct_clip_ut_tpu/ops/vq.py: inputs and codebook rows are
l2-normalised, the nearest code is the argmax cosine similarity (the
vq_nearest kernel, computed in the input's dtype as on the TPU, outside
the autograd graph), the output is the selected row with the
straight-through form x + (quant - x).detach(), so d out / d x is the
identity. Training (freeze=False) also returns the EMA-updated codebook
(vq.py:97-162). The batch statistics are computed with `index_add_` over
the assignments, not the JAX package's [n, codebook] one-hot product (a
27,648 x 8,192 fp32 one-hot would be 0.9 GB at two flagship volumes); the
sums are the same.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from .layers import l2norm
from .vq_nearest import vq_nearest, vq_nearest_plain


class VQState(NamedTuple):
    embed: torch.Tensor          # [codebook, dim], l2-normalised rows
    embed_avg: torch.Tensor      # [codebook, dim] EMA accumulator
    cluster_size: torch.Tensor   # [codebook] EMA of assignment counts


class _Codebook(nn.Module):
    def __init__(self, codebook_size: int, dim: int):
        super().__init__()
        self.register_buffer("embed", torch.zeros(codebook_size, dim))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, dim))
        self.register_buffer("cluster_size", torch.zeros(codebook_size))


class VectorQuantize(nn.Module):
    """Holds the codebook buffers under `_codebook`, the reference's naming
    (its `embed` carries a leading num_codebooks axis of 1; here it is
    [codebook, dim])."""

    def __init__(self, codebook_size: int, dim: int):
        super().__init__()
        self._codebook = _Codebook(codebook_size, dim)

    def state(self) -> VQState:
        cb = self._codebook
        return VQState(cb.embed, cb.embed_avg, cb.cluster_size)


def vq_lookup(state: VQState, x: torch.Tensor,
              plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantise [..., d] inputs -> (quantized value, int32 indices) (vq.py:83-94).
    The similarity runs in x's dtype; the l2norm in fp32."""
    shape = x.shape
    flat = l2norm(x.reshape(-1, shape[-1]).float())
    cb = state.embed.to(x.dtype)
    idx = (vq_nearest_plain if plain else vq_nearest)(flat.to(x.dtype), cb)
    quant = cb[idx.long()]
    return quant.reshape(shape), idx.reshape(shape[:-1])


def vq_stats_input(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The input view the EMA statistics are computed from: flattened,
    l2-normalised fp32, detached (vq.py:97-105)."""
    return l2norm(x.detach().reshape(-1, dim).float())


def vq_batch_stats(idx: torch.Tensor, flat: torch.Tensor,
                   codebook_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts [codebook], embed_sum [codebook, dim]): the number of inputs
    assigned to each code and the sum of those (normalised) inputs
    (vq.py:108-121), by index_add_ over the assignments."""
    idx = idx.reshape(-1).long()
    counts = torch.zeros((codebook_size,), dtype=torch.float32, device=flat.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    embed_sum = torch.zeros((codebook_size, flat.shape[-1]), dtype=torch.float32,
                            device=flat.device)
    embed_sum.index_add_(0, idx, flat.float())
    return counts, embed_sum


def vq_ema_update(state: VQState, counts: torch.Tensor, embed_sum: torch.Tensor, *,
                  decay: float = 0.8, eps: float = 1e-5) -> VQState:
    """One EMA codebook update with Laplace-smoothed cluster sizes and
    re-normalised rows (vq.py:124-140)."""
    codebook_size = state.embed.shape[0]
    cluster_size = state.cluster_size * decay + counts * (1.0 - decay)
    embed_avg = state.embed_avg * decay + embed_sum * (1.0 - decay)
    n = cluster_size.sum()
    smoothed = (cluster_size + eps) / (n + codebook_size * eps) * n
    embed = l2norm(embed_avg / smoothed[:, None])
    return VQState(embed=embed, embed_avg=embed_avg, cluster_size=cluster_size)


def vq_apply(state: VQState, x: torch.Tensor, *, freeze: bool = True, decay: float = 0.8,
             eps: float = 1e-5,
             plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor, VQState]:
    """(out, indices, new state), out = x + (quant - x).detach()
    (vq.py:143-162). With freeze=True the state comes back unchanged."""
    with torch.no_grad():
        quant, idx = vq_lookup(state, x.detach(), plain=plain)
    out = x + (quant - x).detach()
    if freeze:
        return out, idx, state
    dim = state.embed.shape[1]
    counts, embed_sum = vq_batch_stats(idx, vq_stats_input(x, dim), state.embed.shape[0])
    return out, idx, vq_ema_update(state, counts, embed_sum, decay=decay, eps=eps)
