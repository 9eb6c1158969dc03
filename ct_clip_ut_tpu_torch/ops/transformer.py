"""Transformer block stack: PEG -> self-attention -> (cross-attention) -> GEGLU FF.

Counterpart of the non-remat path of ct_clip_ut_tpu/ops/transformer.py.
Each layer is the reference ModuleList [PEG, self-attention,
cross-attention (None without `has_cross_attn`), FF], then norm_out. The
residual adds ride the block kernels' output writes. With `cfg.peg_pallas` the PEG runs the
peg stencil kernel and, in the backward, the peg_weight_grads kernel
(ops/peg.py); without it, F.conv3d and autograd.

`self_attn_block` routes self-attention through the query-row-block path
(ops/attention_blockwise.py, the attn_qrows kernel) for long token grids;
`self_attn_bias_fn` then streams the bias as row stripes. Self-attention
weights are not observable there (asserted, as in the JAX package).
Cross-attention (MaskGit's, to the T5 context) is the plain path.

Tap points of layer i (transformer.py:168-222), under a `scope` prefix
(the CT-ViT's "spatial." / "temporal."; MaskGit's ""):
{scope}{i}.attn_weights, {scope}{i}.attn_out, {scope}{i}.cross_attn_weights,
{scope}{i}.cross_attn_out, {scope}{i}.ff_out. A block output is tapped
BEFORE its residual: a block whose output is captured or injected runs its
kernel with residual=False and the residual is added after the tap; an
untapped block keeps the residual fused into its kernel's output write.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import TransformerConfig
from .attention import Attention, attention
from .attention_blockwise import blockwise_cosine_attention_qrows
from .layers import PEG, FeedForward, FrozenBiasLayerNorm, layernorm
from .taps import NULL_TAPS, Taps


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "the MoE feed-forward is not ported yet (ROADMAP, Queue 1 item 11h: moe)")
        self.cfg = cfg
        self.layers = nn.ModuleList(
            nn.ModuleList([PEG(cfg.dim, cfg.peg_causal, cfg.peg_pallas) if cfg.peg else None,
                           Attention(cfg.self_attn()),
                           Attention(cfg.cross_attn()) if cfg.has_cross_attn else None,
                           FeedForward(cfg.dim, cfg.ff_inner_dim)])
            for _ in range(cfg.depth))
        self.norm_out = FrozenBiasLayerNorm(cfg.dim)


def transformer(tf: Transformer, x: torch.Tensor, *,
                video_shape: Optional[Tuple[int, int, int, int]] = None,
                attn_bias: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None,
                self_attn_mask: Optional[torch.Tensor] = None,
                cross_attn_context_mask: Optional[torch.Tensor] = None,
                return_weights: bool = False,
                taps: Taps = NULL_TAPS,
                scope: str = "",
                self_attn_block: Optional[int] = None,
                self_attn_bias_fn=None,
                plain: bool = False):
    """(out, per-layer self-attention weights or None) for x [b, n, dim],
    with the tap points of the module docstring under `scope`."""
    if self_attn_block is not None:
        assert self_attn_mask is None, \
            "blockwise self-attention does not support a key-padding mask"
        assert not return_weights, "self-attention weights are not observable blockwise"
    else:
        assert self_attn_bias_fn is None, \
            "self_attn_bias_fn without self_attn_block would silently drop the positional bias"

    def observed(name):
        return name in taps.inject or taps.wants(name)

    weights = []
    for i, (peg, attn, cross, ff) in enumerate(tf.layers):
        if peg is not None:
            x = peg(x, video_shape, plain=plain)

        name = f"{scope}{i}.attn_out"
        tapped = observed(name)
        want_w = return_weights or taps.wants(f"{scope}{i}.attn_weights")
        if self_attn_block is not None:
            if want_w:
                raise ValueError("self-attention weights requested (taps) on the blockwise "
                                 "path: they are not observable there")
            out = blockwise_cosine_attention_qrows(
                attn, x, q_block=self_attn_block, attn_bias=attn_bias,
                bias_row_fn=self_attn_bias_fn, residual=not tapped, plain=plain)
            w = None
        else:
            out, w = attention(attn, x, attn_bias=attn_bias, mask=self_attn_mask,
                               return_weights=want_w, residual=not tapped, plain=plain)
        if w is not None:
            w = taps.tap(f"{scope}{i}.attn_weights", w)
        weights.append(w)
        x = taps.tap(name, out) + x if tapped else out

        if cross is not None and context is not None:
            name = f"{scope}{i}.cross_attn_out"
            tapped = observed(name)
            wname = f"{scope}{i}.cross_attn_weights"
            out, cw = attention(cross, x, context=context, mask=cross_attn_context_mask,
                                return_weights=taps.wants(wname), residual=not tapped,
                                plain=plain)
            if cw is not None:
                taps.tap(wname, cw)
            x = taps.tap(name, out) + x if tapped else out

        name = f"{scope}{i}.ff_out"
        tapped = observed(name)
        out = ff(x, residual=not tapped, plain=plain)
        x = taps.tap(name, out) + x if tapped else out
    return layernorm(x, tf.norm_out.gamma), (tuple(weights) if return_weights else None)
