"""CT-ViT: 3-D patch embed, factorised spatial/temporal attention, cosine VQ.

Counterpart of ct_clip_ut_tpu/models/ctvit.py for the ctclip model type.
The patch embed is patchify -> LN -> Linear -> LN, either as written
(`patch_embed_conv=False`) or, at the default `patch_embed_conv=True`,
with the first LN folded into the projection (the patch_embed kernel). For
a [b, 1, 240, 480, 480] volume: a [b, 24, 24, 24, 512] token grid, 4
spatial layers over (b t) x 576 tokens with a 2-D CPB bias, 4 temporal
layers over (b h w) x 24 tokens, VQ against 8192 codes.

Training (`ctvit_apply(freeze_vq=False)`, under autograd) runs the same
kernels through their autograd Functions: the conv embed takes the
residual-saving patch embed and its dkw backward, the blocks their
backward chains; the VQ returns its EMA-updated codebook.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import CTViTConfig
from ..ops.layers import layernorm, linear
from ..ops.patch_embed import (fold_patch_embed, patch_embed_fused, patch_embed_grad,
                               patch_embed_plain)
from ..ops.posbias import ContinuousPositionBias, continuous_pos_bias
from ..ops.transformer import Transformer, transformer
from ..ops.vq import VectorQuantize, VQState, vq_apply


def patchify(image: torch.Tensor, patch: int, t_patch: int) -> torch.Tensor:
    """[b, c, T, H, W] -> [b, t, h, w, c * t_patch * patch^2], the einops
    'b c (t pt) (h p1) (w p2) -> b t h w (c pt p1 p2)' (ctvit.py:152-161)."""
    b, c, T, H, W = image.shape
    t, h, w = T // t_patch, H // patch, W // patch
    x = image.reshape(b, c, t, t_patch, h, patch, w, patch)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, t, h, w, c * t_patch * patch * patch)


class Patchify(nn.Module):
    """Index 0 of `to_patch_emb` (the reference's Rearrange)."""

    def __init__(self, patch: int, t_patch: int):
        super().__init__()
        self.patch, self.t_patch = patch, t_patch

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return patchify(image, self.patch, self.t_patch)


class CTViT(nn.Module):
    def __init__(self, cfg: CTViTConfig):
        super().__init__()
        if cfg.model_type != "ctclip":
            raise NotImplementedError(
                "the ctgenerate CT-ViT is not ported yet (ROADMAP, Queue 1 item 10)")
        self.cfg = cfg
        self.spatial_rel_pos_bias = ContinuousPositionBias(cfg.dim, cfg.heads, num_dims=2)
        self.to_patch_emb = nn.Sequential(
            Patchify(cfg.patch_size, cfg.temporal_patch_size),
            nn.LayerNorm(cfg.patch_dim), nn.Linear(cfg.patch_dim, cfg.dim),
            nn.LayerNorm(cfg.dim))
        self.enc_spatial_transformer = Transformer(cfg.spatial_transformer())
        self.enc_temporal_transformer = Transformer(cfg.temporal_transformer())
        self.vq = VectorQuantize(cfg.codebook_size, cfg.dim)


class CTViTOutput(NamedTuple):
    tokens: torch.Tensor            # [b, t, h, w, d] quantized tokens
    codebook_ids: torch.Tensor      # [b, t, h, w] int32
    spatial_attn: Optional[tuple]
    temporal_attn: Optional[tuple]
    vq_state: VQState


def _patch_embed(emb: nn.Sequential, patches: torch.Tensor) -> torch.Tensor:
    """LN -> Linear -> LN over raw patch pixels (ctvit.py:56-60)."""
    h = layernorm(patches, emb[1].weight, emb[1].bias)
    h = linear(h, emb[2].weight, emb[2].bias)
    return layernorm(h, emb[3].weight, emb[3].bias)


def _patch_embed_conv(vit: CTViT, image: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The LN-folded embed of a [b, c, T, H, W] volume (ctvit.py:63-99):
    the patch_embed kernel for one channel and T, H, W that the patch sizes
    divide (the JAX package's gate, ctvit.py:92-93), the plain version
    otherwise or with plain=True. Under autograd the kernel path is the
    residual-saving forward with its backward (`patch_embed_grad`). The
    fold runs per call, in fp32."""
    cfg = vit.cfg
    b, c, T, H, W = image.shape
    p, tp = cfg.patch_size, cfg.temporal_patch_size
    emb = vit.to_patch_emb
    kw, s1, b1 = fold_patch_embed(emb, p, tp, c)
    kernel = not plain and c == 1 and T % tp == 0 and H % p == 0 and W % p == 0
    if not kernel:
        fn = patch_embed_plain
    else:
        fn = patch_embed_grad if torch.is_grad_enabled() else patch_embed_fused
    return fn(image, kw, s1, b1, emb[3].weight.float(), emb[3].bias.float(), p, tp)


def ctvit_temporal_encode(vit: CTViT, x: torch.Tensor, *, return_weights: bool = False,
                          plain: bool = False):
    """[b, t, h, w, d] -> temporal transformer over (b h w) x t -> [b, t, h, w, d]."""
    b, t, h, w, d = x.shape
    x = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, d)
    x, weights = transformer(vit.enc_temporal_transformer, x, video_shape=(b, t, h, w),
                             return_weights=return_weights, plain=plain)
    return x.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4), weights


def ctvit_encode(vit: CTViT, tokens: torch.Tensor, *, return_weights: bool = False,
                 plain: bool = False):
    """Factorised spatial + temporal encoding of a [b, t, h, w, d] token grid.
    Returns (x, spatial weights, temporal weights)."""
    cfg = vit.cfg
    b, t, h, w, d = tokens.shape
    attn_bias = continuous_pos_bias(vit.spatial_rel_pos_bias, cfg.patch_height,
                                    cfg.patch_width)
    x, sp_w = transformer(vit.enc_spatial_transformer, tokens.reshape(b * t, h * w, d),
                          video_shape=(b, t, h, w), attn_bias=attn_bias,
                          return_weights=return_weights, plain=plain)
    x, tm_w = ctvit_temporal_encode(vit, x.reshape(b, t, h, w, d),
                                    return_weights=return_weights, plain=plain)
    return x, sp_w, tm_w


def token_grid_shape(cfg: CTViTConfig, image_shape) -> tuple:
    """(t, h, w) codebook-id grid of a [b, c, T, H, W] input (ctvit.py:235-246)."""
    T, H, W = (int(s) for s in image_shape[-3:])
    if cfg.model_type == "ctgenerate":
        t = 1 + (T - 1) // cfg.temporal_patch_size
    else:
        t = T // cfg.temporal_patch_size
    return (t, H // cfg.patch_size, W // cfg.patch_size)


def ctvit_apply(vit: CTViT, image: torch.Tensor, *, freeze_vq: bool = True,
                return_weights: bool = False, taps=None, deterministic: bool = True,
                plain: bool = False) -> CTViTOutput:
    """Full CT-ViT forward of a [b, c, T, H, W] volume (ctvit.py:249-296).
    freeze_vq=False returns the EMA-updated codebook in `vq_state` (the
    caller writes it back). CT-ViT dropout is not ported: its rates are 0
    in every configuration the JAX package ships, and a train-mode call
    with a rate above 0 raises."""
    cfg = vit.cfg
    if taps is not None:
        raise NotImplementedError(
            "tap capture/injection is not ported yet (ROADMAP, Queue 1 item 9: attribution)")
    if not deterministic and (cfg.attn_dropout > 0.0 or cfg.ff_dropout > 0.0):
        raise NotImplementedError(
            "CT-ViT attention / FF dropout is not ported (the kernels take no dropout); "
            "the configurations use rate 0")
    if cfg.patch_embed_conv:
        tokens = _patch_embed_conv(vit, image, plain=plain)
    else:
        tokens = _patch_embed(vit.to_patch_emb, vit.to_patch_emb[0](image))
    x, sp_w, tm_w = ctvit_encode(vit, tokens, return_weights=return_weights, plain=plain)
    b, t, h, w, d = x.shape
    quant, idx, state = vq_apply(vit.vq.state(), x.reshape(b, t * h * w, d),
                                 freeze=freeze_vq, decay=cfg.vq_decay, eps=cfg.vq_eps,
                                 plain=plain)
    return CTViTOutput(tokens=quant.reshape(b, t, h, w, d),
                       codebook_ids=idx.reshape(b, t, h, w),
                       spatial_attn=sp_w, temporal_attn=tm_w, vq_state=state)
