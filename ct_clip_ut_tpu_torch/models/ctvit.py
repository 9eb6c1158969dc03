"""CT-ViT: 3-D patch embed, factorised spatial/temporal attention, cosine VQ.

Counterpart of ct_clip_ut_tpu/models/ctvit.py. The patch embed is
patchify -> LN -> Linear -> LN, either as written
(`patch_embed_conv=False`) or, at the default `patch_embed_conv=True`,
with the first LN folded into the projection (the patch_embed kernel). For
a [b, 1, 240, 480, 480] volume: a [b, 24, 24, 24, 512] token grid, 4
spatial layers over (b t) x 576 tokens with a 2-D CPB bias, 4 temporal
layers over (b h w) x 24 tokens, VQ against 8192 codes. The ctgenerate
model type (CTGenerate's tokenizer) embeds the first frame on its own
(`to_patch_emb_first_frame`, temporal patch 1) and the rest at the
temporal patch size, then concatenates them along t (ctvit.py:284-290):
a [b, 1, 201, 128, 128] scan becomes a 101 x 8 x 8 grid.

Training (`ctvit_apply(freeze_vq=False)`, under autograd) runs the same
kernels through their autograd Functions: the conv embed takes the
residual-saving patch embed and its dkw backward, the blocks their
backward chains; the VQ returns its EMA-updated codebook.

`taps` (ops/taps.py) thread through the encoder with the scopes
"spatial." and "temporal.", plus vq.input before the VQ and vq.features
after its straight-through (ctvit.py:191-232, 308-313): the gradient
attribution methods inject zeros there. `prepatchified=True` feeds a [b,
t, h, w, patch_dim] patch tensor to the matmul embed (ctvit.py:270-276):
integrated gradients differentiates with respect to it, and
`unpatchify_np` maps a map in patch space back to the volume on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..config import CTViTConfig
from ..ops.layers import layernorm, linear
from ..ops.patch_embed import (fold_patch_embed, patch_embed_fused, patch_embed_grad,
                               patch_embed_plain)
from ..ops.posbias import ContinuousPositionBias, continuous_pos_bias
from ..ops.taps import NULL_TAPS, Taps
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


def unpatchify_np(patches, patch: int, t_patch: int, channels: int = 1) -> np.ndarray:
    """The host (numpy) inverse of `patchify` for one volume: [t, h, w,
    patch_dim] -> [c, t * t_patch, h * patch, w * patch], the channel axis
    dropped for c == 1 (ctvit.py:164-178). Attribution maps computed in
    patch space come back to the volume's layout here, once."""
    p = np.asarray(patches)
    t, h, w, _ = p.shape
    x = p.reshape(t, h, w, channels, t_patch, patch, patch).transpose(3, 0, 4, 1, 5, 2, 6)
    x = x.reshape(channels, t * t_patch, h * patch, w * patch)
    return x[0] if channels == 1 else x


class Patchify(nn.Module):
    """Index 0 of `to_patch_emb` (the reference's Rearrange)."""

    def __init__(self, patch: int, t_patch: int):
        super().__init__()
        self.patch, self.t_patch = patch, t_patch

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return patchify(image, self.patch, self.t_patch)


def _embed(patch: int, t_patch: int, patch_dim: int, dim: int) -> nn.Sequential:
    return nn.Sequential(Patchify(patch, t_patch), nn.LayerNorm(patch_dim),
                         nn.Linear(patch_dim, dim), nn.LayerNorm(dim))


class CTViT(nn.Module):
    def __init__(self, cfg: CTViTConfig):
        super().__init__()
        if cfg.model_type not in ("ctclip", "ctgenerate"):
            raise ValueError(f"unknown CT-ViT model_type {cfg.model_type!r}")
        self.cfg = cfg
        self.spatial_rel_pos_bias = ContinuousPositionBias(cfg.dim, cfg.heads, num_dims=2)
        self.to_patch_emb = _embed(cfg.patch_size, cfg.temporal_patch_size, cfg.patch_dim,
                                   cfg.dim)
        if cfg.model_type == "ctgenerate":
            self.to_patch_emb_first_frame = _embed(cfg.patch_size, 1, cfg.first_frame_patch_dim,
                                                   cfg.dim)
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


def _patch_embed_conv(vit: CTViT, image: torch.Tensor, plain: bool = False, *,
                      emb: Optional[nn.Sequential] = None,
                      t_patch: Optional[int] = None) -> torch.Tensor:
    """The LN-folded embed of a [b, c, T, H, W] volume (ctvit.py:63-99)
    through `emb` at temporal patch `t_patch` (default: `to_patch_emb` at
    the config's): the patch_embed kernel for one channel and T, H, W that
    the patch sizes divide (the JAX package's gate, ctvit.py:92-93), the
    plain version otherwise or with plain=True. Under autograd the kernel
    path is the residual-saving forward with its backward
    (`patch_embed_grad`). The fold runs per call, in fp32."""
    cfg = vit.cfg
    b, c, T, H, W = image.shape
    p = cfg.patch_size
    tp = cfg.temporal_patch_size if t_patch is None else t_patch
    emb = vit.to_patch_emb if emb is None else emb
    kw, s1, b1 = fold_patch_embed(emb, p, tp, c)
    kernel = not plain and c == 1 and T % tp == 0 and H % p == 0 and W % p == 0
    if not kernel:
        fn = patch_embed_plain
    else:
        fn = patch_embed_grad if torch.is_grad_enabled() else patch_embed_fused
    return fn(image, kw, s1, b1, emb[3].weight.float(), emb[3].bias.float(), p, tp)


def ctvit_temporal_encode(vit: CTViT, x: torch.Tensor, *, return_weights: bool = False,
                          taps: Taps = NULL_TAPS, plain: bool = False):
    """[b, t, h, w, d] -> temporal transformer over (b h w) x t -> [b, t, h, w, d]."""
    b, t, h, w, d = x.shape
    x = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, d)
    x, weights = transformer(vit.enc_temporal_transformer, x, video_shape=(b, t, h, w),
                             return_weights=return_weights, taps=taps, scope="temporal.",
                             plain=plain)
    return x.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4), weights


def ctvit_encode(vit: CTViT, tokens: torch.Tensor, *, return_weights: bool = False,
                 taps: Taps = NULL_TAPS, plain: bool = False):
    """Factorised spatial + temporal encoding of a [b, t, h, w, d] token grid.
    Returns (x, spatial weights, temporal weights)."""
    cfg = vit.cfg
    b, t, h, w, d = tokens.shape
    attn_bias = continuous_pos_bias(vit.spatial_rel_pos_bias, cfg.patch_height,
                                    cfg.patch_width)
    x, sp_w = transformer(vit.enc_spatial_transformer, tokens.reshape(b * t, h * w, d),
                          video_shape=(b, t, h, w), attn_bias=attn_bias,
                          return_weights=return_weights, taps=taps, scope="spatial.",
                          plain=plain)
    x, tm_w = ctvit_temporal_encode(vit, x.reshape(b, t, h, w, d),
                                    return_weights=return_weights, taps=taps, plain=plain)
    return x, sp_w, tm_w


def token_grid_shape(cfg: CTViTConfig, image_shape) -> tuple:
    """(t, h, w) codebook-id grid of a [b, c, T, H, W] input (ctvit.py:235-246)."""
    T, H, W = (int(s) for s in image_shape[-3:])
    if cfg.model_type == "ctgenerate":
        t = 1 + (T - 1) // cfg.temporal_patch_size
    else:
        t = T // cfg.temporal_patch_size
    return (t, H // cfg.patch_size, W // cfg.patch_size)


def check_image_dtype(dtype: torch.dtype, device_type: str, plain: bool) -> None:
    """Raise for an image the card's image-tower kernels do not take: on a
    CUDA device (`device_type` "cuda") without plain=True, bf16 or fp32 (the
    fp32 variants of the patch embed, block, FF and VQ kernels and their
    backwards: CTGenerate's one-scan route, the attribution suite and the
    fp32 train step)."""
    if device_type != "cuda" or plain or dtype in (torch.bfloat16, torch.float32):
        return
    raise NotImplementedError(f"a {dtype} image on the card: the CT-ViT kernels take "
                              "bfloat16 or float32")


def ctvit_encode_tokens(vit: CTViT, tokens: torch.Tensor, *, freeze_vq: bool = True,
                        return_weights: bool = False, taps: Taps = NULL_TAPS,
                        plain: bool = False, vq_axis=None) -> CTViTOutput:
    """Transformer encode + VQ of an embedded [b, t, h, w, d] token grid
    (ctvit.py:299-322, `_ctvit_encode_tokens`), with the taps vq.input and
    vq.features around the VQ. `vq_axis`: a data-axis mesh over whose ranks
    the VQ's EMA statistics are summed (ops.vq.vq_apply)."""
    cfg = vit.cfg
    x, sp_w, tm_w = ctvit_encode(vit, tokens, return_weights=return_weights, taps=taps,
                                 plain=plain)
    b, t, h, w, d = x.shape
    flat = taps.tap("vq.input", x.reshape(b, t * h * w, d))
    quant, idx, state = vq_apply(vit.vq.state(), flat, freeze=freeze_vq, decay=cfg.vq_decay,
                                 eps=cfg.vq_eps, plain=plain, axis=vq_axis)
    quant = taps.tap("vq.features", quant)
    return CTViTOutput(tokens=quant.reshape(b, t, h, w, d),
                       codebook_ids=idx.reshape(b, t, h, w),
                       spatial_attn=sp_w, temporal_attn=tm_w, vq_state=state)


def ctvit_apply(vit: CTViT, image: torch.Tensor, *, freeze_vq: bool = True,
                return_weights: bool = False, taps: Taps = NULL_TAPS,
                deterministic: bool = True, prepatchified: bool = False,
                plain: bool = False, vq_axis=None) -> CTViTOutput:
    """Full CT-ViT forward of a [b, c, T, H, W] volume (ctvit.py:249-296),
    or with prepatchified=True of a [b, t, h, w, patch_dim] patch tensor
    through the matmul embed (the ctclip model type only).
    freeze_vq=False returns the EMA-updated codebook in `vq_state` (the
    caller writes it back; over `vq_axis`'s ranks' statistics where given). CT-ViT dropout is not ported: its rates are 0
    in every configuration the JAX package ships, and a train-mode call
    with a rate above 0 raises. On the card the image must be bf16 or fp32
    (`check_image_dtype`)."""
    cfg = vit.cfg
    if not deterministic and (cfg.attn_dropout > 0.0 or cfg.ff_dropout > 0.0):
        raise NotImplementedError(
            "CT-ViT attention / FF dropout is not ported (the kernels take no dropout); "
            "the configurations use rate 0")
    if prepatchified:
        assert cfg.model_type != "ctgenerate", \
            "prepatchified input is only supported for the ctclip embed"
        check_image_dtype(image.dtype, image.device.type, plain)
        return ctvit_encode_tokens(vit, _patch_embed(vit.to_patch_emb, image),
                                   freeze_vq=freeze_vq, return_weights=return_weights, taps=taps,
                                   plain=plain, vq_axis=vq_axis)
    check_image_dtype(image.dtype, image.device.type, plain)
    if cfg.patch_embed_conv:
        def embed(emb, img, t_patch):
            return _patch_embed_conv(vit, img.contiguous(), plain=plain, emb=emb,
                                     t_patch=t_patch)
    else:
        def embed(emb, img, t_patch):
            return _patch_embed(emb, patchify(img, cfg.patch_size, t_patch))
    if cfg.model_type == "ctgenerate":
        # the first frame embedded on its own (ctvit.py:284-290)
        tokens = torch.cat([embed(vit.to_patch_emb_first_frame, image[:, :, :1], 1),
                            embed(vit.to_patch_emb, image[:, :, 1:], cfg.temporal_patch_size)],
                           dim=1)
    else:
        tokens = embed(vit.to_patch_emb, image, cfg.temporal_patch_size)
    return ctvit_encode_tokens(vit, tokens, freeze_vq=freeze_vq, return_weights=return_weights,
                               taps=taps, plain=plain, vq_axis=vq_axis)
