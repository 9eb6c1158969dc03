"""Shared attribution machinery: scored forwards, weight capture,
intermediate gradients without hooks, and the post-processing every
method shares.

Counterpart of ct_clip_ut_tpu/attribution/capture.py. The reference drives
every method off the per-sample similarity score sim[0, 0]:

  * `score_and_weights`: one forward returning it with the per-layer
    attention weights as outputs;
  * `score_captures_and_grads`: one forward over zero injections at named
    tap points (ops/taps.py) and one `torch.autograd.grad`, returning the
    score, the captured activations and d score / d activation for each:
    what the reference's register_hook delivered, without hooks.

All attribution math runs in fp32 (saliency band <= 1e-3), with the matmul
patch embed (`parity_cfg`): on the card the image tower runs the fp32
variants of the block, FF and VQ kernels, and under autograd the fp32
data-gradient chains of the blocks and the FF. The forward methods run
under `forward_only` (no_grad), the gradient methods under `with_grad`;
both under `full_fp32`: cuDNN would run the fp32 PEG convs, forward and
backward, in TF32 by default (~3 decimal digits), which the bands do not
allow. `with_grad` also freezes the model's parameters for its duration
(`frozen`): the methods differentiate with respect to activations and
patches, and the card computes the fp32 data gradient alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CTCLIPConfig
from ..models.ctclip import (CTCLIP, CTCLIPOutput, encode_image_latents_from_tokens,
                             text_latents_of)
from ..models.ctvit import _patch_embed, patchify, token_grid_shape
from ..ops.taps import NULL_TAPS, Taps


def parity_cfg(cfg: CTCLIPConfig) -> CTCLIPConfig:
    """The attribution variant of a model config: the bit-stable matmul patch
    embed (`patch_embed_conv=False`), whose per-patch rows give the same
    token whether a patch is embedded alone or in the whole volume, so VQ
    argmaxes near ties do not flip between the masked and the clean
    forwards of occlusion (scores are differenced at the 1e-2 scale)."""
    return dataclasses.replace(
        cfg, ctvit=dataclasses.replace(cfg.ctvit, patch_embed_conv=False))


@contextlib.contextmanager
def full_fp32():
    """cuDNN convolutions and cuBLAS matmuls in full fp32 (no TF32) inside
    the block, the flags restored after it."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def forward_only(fn):
    """Run `fn` under no_grad and full_fp32 (the forward methods' entry points)."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with torch.no_grad(), full_fp32():
            return fn(*args, **kw)

    return wrapped


@contextlib.contextmanager
def frozen(model: torch.nn.Module):
    """Every parameter of `model` with requires_grad off inside the block,
    each one's flag restored after it."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def with_grad(fn):
    """Run `fn(model, ...)` with autograd on, under full_fp32 (its forward
    and its torch.autograd.grad calls alike: cuDNN reads the TF32 flag when
    each op runs, the PEG's backward convolution too) and with the model's
    parameters frozen (the gradient methods' entry points)."""
    @functools.wraps(fn)
    def wrapped(model, *args, **kw):
        with torch.enable_grad(), full_fp32(), frozen(model):
            return fn(model, *args, **kw)

    return wrapped


def embed_volume(model: CTCLIP, image: torch.Tensor) -> torch.Tensor:
    """The matmul patch embed (`parity_cfg`'s) of a [b, 1, T, H, W] volume:
    patchify -> LN -> Linear -> LN, a [b, t, h, w, d] token grid."""
    cfg = model.visual_transformer.cfg
    return _patch_embed(model.visual_transformer.to_patch_emb,
                        patchify(image, cfg.patch_size, cfg.temporal_patch_size))


def scored_forward(model: CTCLIP, text_tokens, image: torch.Tensor, text_embeds=None, *,
                   taps: Taps = NULL_TAPS, return_weights: bool = False,
                   prepatchified: bool = False, plain: bool = False):
    """(sim[0, 0], CTCLIPOutput): the scored forward of the batch-1
    convention, frozen VQ, through the matmul patch embed (the JAX
    package's `similarity_score`: `ctclip_apply` under `parity_cfg`), with
    autograd as the caller has it. prepatchified=True takes a [b, t, h, w,
    patch_dim] patch tensor for `image`; plain=True runs every kernel's
    plain version."""
    cfg = model.visual_transformer.cfg
    patches = image if prepatchified else patchify(image, cfg.patch_size,
                                                   cfg.temporal_patch_size)
    txt = text_latents_of(model, text_tokens, text_embeds, image.dtype, plain)
    img, vit_out = encode_image_latents_from_tokens(
        model, _patch_embed(model.visual_transformer.to_patch_emb, patches),
        return_weights=return_weights, taps=taps, plain=plain)
    temp = model.temperature.exp()
    sim = (img.float() @ txt.float().t()) * temp
    out = CTCLIPOutput(sim_matrix=sim, image_latents=img, text_latents=txt, temperature=temp,
                       image_tokens=vit_out.tokens, spatial_attn=vit_out.spatial_attn,
                       temporal_attn=vit_out.temporal_attn, vq_state=vit_out.vq_state)
    return sim[0, 0], out


@forward_only
def similarity_score(model: CTCLIP, text_tokens, image: torch.Tensor, text_embeds=None, **kw):
    """`scored_forward` under no_grad and full_fp32."""
    return scored_forward(model, text_tokens, image, text_embeds, **kw)


def score_and_weights(model: CTCLIP, text_tokens, image: torch.Tensor, text_embeds=None, *,
                      plain: bool = False):
    """(score, spatial weights, temporal weights): fp32 per-layer tuples of
    [b*t, heads, hw, hw] / [b*h*w, heads, t, t]."""
    score, out = similarity_score(model, text_tokens, image, text_embeds,
                                  return_weights=True, plain=plain)
    return score, out.spatial_attn, out.temporal_attn


def tap_shapes(cfg: CTCLIPConfig, image_shape, tap_names: Sequence[str]) -> Dict[str, tuple]:
    """Shapes of the CT-ViT's tap points for an image of `image_shape` [b,
    c, T, H, W], from the config alone (the JAX package's abstract
    evaluation, capture.py:71-79): a spatial layer's block outputs [b t,
    h w, dim] and weights [b t, heads, h w, h w], a temporal layer's [b h w,
    t, dim] and [b h w, heads, t, t], vq.input and vq.features [b, t h w,
    dim]. An unknown name raises KeyError."""
    vit = cfg.ctvit
    b = int(image_shape[0])
    t, h, w = token_grid_shape(vit, image_shape)
    stacks = {"spatial": (b * t, h * w, vit.spatial_depth),
              "temporal": (b * h * w, t, vit.temporal_depth)}
    shapes = {}
    for name in tap_names:
        parts = name.split(".")
        if name in ("vq.input", "vq.features"):
            shapes[name] = (b, t * h * w, vit.dim)
        elif (len(parts) == 3 and parts[0] in stacks and parts[1].isdigit()
              and int(parts[1]) < stacks[parts[0]][2]
              and parts[2] in ("attn_out", "ff_out", "attn_weights")):
            rows, n, _ = stacks[parts[0]]
            shapes[name] = ((rows, vit.heads, n, n) if parts[2] == "attn_weights"
                            else (rows, n, vit.dim))
        else:
            raise KeyError(f"no tap point {name!r} in the CT-ViT")
    return shapes


@with_grad
def score_captures_and_grads(model: CTCLIP, text_tokens, image: torch.Tensor,
                             tap_names: Sequence[str], text_embeds=None, *,
                             plain: bool = False) -> Tuple[torch.Tensor, dict, dict]:
    """One pass: the scalar score, the activations captured at `tap_names`
    and d score / d activation for each (the register_hook gradients,
    reference visualizations.py:147-218), fp32: zero injections that need
    their gradients, one forward, one torch.autograd.grad. A point the
    score does not reach gets a zero gradient, as JAX's."""
    shapes = tap_shapes(model.cfg, image.shape, tap_names)
    names = sorted(shapes)
    zeros = {k: torch.zeros(shapes[k], device=image.device, requires_grad=True) for k in names}
    taps = Taps(capture=set(tap_names), inject=zeros)
    score, _ = scored_forward(model, text_tokens, image, text_embeds, taps=taps, plain=plain)
    grads = torch.autograd.grad(score, [zeros[k] for k in names], allow_unused=True)
    captured = {k: v.detach().float() for k, v in taps.collected.items()}
    grads = {k: torch.zeros_like(zeros[k]) if d is None else d.float()
             for k, d in zip(names, grads)}
    return score.detach(), captured, grads


# ---------------------------------------------------------------------------
# shared post-processing (fp32, the reference's numpy math)
# ---------------------------------------------------------------------------

def minmax(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(v - min) / (max - min + eps) (reference visualizations.py:414, 814,
    839)."""
    v = v.float()
    return (v - v.min()) / (v.max() - v.min() + eps)


def shiftmax(v: torch.Tensor, eps: float = 1e-8, batched: bool = False) -> torch.Tensor:
    """(v - min) / (max + eps), the max taken BEFORE the shift: the
    reference's (sic) normalisation in grad-cam / raw attention
    (visualizations.py:620-621, 674, 946-947, 971-972); batched=True
    normalises each entry of the leading axis alone."""
    v = v.float()
    dims = tuple(range(1 if batched else 0, v.dim()))
    return (v - v.amin(dims, keepdim=True)) / (v.amax(dims, keepdim=True) + eps)


def upsample_to(volume: torch.Tensor, target_shape) -> torch.Tensor:
    """Trilinear (align_corners=False) upsample of a [D, H, W] volume on its
    device (reference _upsample, visualizations.py:289-293)."""
    return F.interpolate(volume.float()[None, None], size=tuple(int(s) for s in target_shape),
                         mode="trilinear", align_corners=False)[0, 0]


def _lin_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] half-pixel-centre linear interpolation matrix, the
    per-axis factor of trilinear upsampling with align_corners=False."""
    c = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(c)
    w = c - lo
    i0 = np.clip(lo.astype(np.int64), 0, n_in - 1)
    i1 = np.clip(lo.astype(np.int64) + 1, 0, n_in - 1)
    m = np.zeros((n_out, n_in), np.float64)
    m[np.arange(n_out), i0] += 1.0 - w
    m[np.arange(n_out), i1] += w
    return m


def upsample_to_host(volume, target_shape) -> np.ndarray:
    """Host (numpy) twin of `upsample_to`, upsampling only: three separable
    fp32 products, so a caller fetches maps at grid resolution (a few
    hundred KB) and expands them on the host instead of copying the ~221 MB
    upsampled volume per map."""
    v = np.asarray(volume, np.float32)
    for ax in range(3):
        assert target_shape[ax] >= v.shape[ax], (v.shape, target_shape)
        m = _lin_matrix(v.shape[ax], target_shape[ax]).astype(np.float32)
        v = np.moveaxis(np.tensordot(m, np.moveaxis(v, ax, 0), axes=1), 0, ax)
    return v


def rot90_ct(volume, k: int = -1) -> np.ndarray:
    """np.rot90(k=-1, axes=(1, 2)): puts the CT table down (reference
    visualizations.py:423, 628-630)."""
    return np.rot90(np.asarray(volume), k=k, axes=(1, 2))
