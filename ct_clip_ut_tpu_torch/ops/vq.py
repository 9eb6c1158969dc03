"""Cosine-similarity vector quantisation, frozen codebook.

Counterpart of ct_clip_ut_tpu/ops/vq.py: inputs and codebook rows are
l2-normalised, the nearest code is the argmax cosine similarity (the
vq_nearest kernel, computed in the input's dtype as on the TPU), the output
is the selected row with a straight-through form. The EMA codebook update
(freeze=False) belongs to training and is not ported yet.
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


def vq_apply(state: VQState, x: torch.Tensor, *, freeze: bool = True,
             plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor, VQState]:
    """(out, indices, state), out = x + (quant - x) (vq.py:143-156)."""
    if not freeze:
        raise NotImplementedError(
            "the VQ EMA codebook update (freeze=False) is not ported yet "
            "(ROADMAP, Queue 1 item 8: train/)")
    quant, idx = vq_lookup(state, x, plain=plain)
    return x + (quant - x), idx, state
