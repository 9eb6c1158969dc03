"""Transformer block stack: PEG -> self-attention -> GEGLU FF, then norm_out.

Counterpart of the non-remat, untapped path of
ct_clip_ut_tpu/ops/transformer.py. Each layer is the reference ModuleList
[PEG, self-attention, cross-attention (None here), FF]; both residual adds
ride the block kernels' output writes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import TransformerConfig
from .attention import Attention, attention
from .layers import PEG, FeedForward, FrozenBiasLayerNorm, layernorm


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "the MoE feed-forward is not ported yet (ROADMAP, Queue 1 item 11)")
        if cfg.has_cross_attn:
            raise NotImplementedError(
                "cross-attention is not ported yet (ROADMAP, Queue 1 item 10: CTGenerate)")
        if cfg.peg_pallas:
            raise NotImplementedError(
                "the fused PEG stencil is not ported yet (ROADMAP, Queue 2 item 12)")
        self.cfg = cfg
        self.layers = nn.ModuleList(
            nn.ModuleList([PEG(cfg.dim, cfg.peg_causal) if cfg.peg else None,
                           Attention(cfg.self_attn()), None,
                           FeedForward(cfg.dim, cfg.ff_inner_dim)])
            for _ in range(cfg.depth))
        self.norm_out = FrozenBiasLayerNorm(cfg.dim)


def transformer(tf: Transformer, x: torch.Tensor, *,
                video_shape: Optional[Tuple[int, int, int, int]] = None,
                attn_bias: Optional[torch.Tensor] = None,
                return_weights: bool = False,
                plain: bool = False):
    """(out, per-layer self-attention weights or None) for x [b, n, dim]."""
    weights = []
    for peg, attn, _, ff in tf.layers:
        if peg is not None:
            x = peg(x, video_shape)
        x, w = attention(attn, x, attn_bias=attn_bias, return_weights=return_weights,
                         residual=True, plain=plain)
        weights.append(w)
        x = ff(x, residual=True, plain=plain)
    return layernorm(x, tf.norm_out.gamma), (tuple(weights) if return_weights else None)
