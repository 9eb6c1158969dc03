"""CT-ViT patch embed in the LN-folded conv form: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_patch_embed.py:patch_embed_fused (the
forward, `_forward_impl`). The CUDA chain is `csrc/patch_embed.cu`; its
header says what bounds it on the H100 and what the design does about it.

patchify -> LN1 -> Linear -> LN2 (ctvit.py:56-60) is computed with LN1
folded into the projection (models/ctvit.py:63-99 of the JAX package):

    LN1(x) @ W + b = ((x @ (gamma * W)) - mean(x) * s1) * rsqrt(var(x) + eps) + b1,
    s1 = sum_i gamma_i W_i,   b1 = beta @ W + b,

so the projection runs on the raw pixels and the per-patch moments are
applied afterwards. `fold_patch_embed` builds the folded weights in fp32;
`patch_embed_fused` launches the kernel for CUDA tensors and takes the plain
version for CPU tensors; `patch_embed_plain` is the `_xla_twin` math
(pallas_patch_embed.py:164-194) with the kernel's rounding points: the
folded weights cast once to the image dtype, the product and the moments
in fp32, h rounded to the image dtype before LN2 (two-pass variance).
"""

from __future__ import annotations

import torch

from .. import _build
from . import launches

EPS = 1e-5


def fold_patch_embed(emb, patch: int, t_patch: int, channels: int = 1) -> tuple:
    """(kw [patch, cin, dim], s1 [dim], b1 [dim]) in fp32 from the plain
    embed's LN1 / Linear (`to_patch_emb[1]`, `[2]`); cin = channels *
    t_patch * patch, rows ordered (c, pt, p1), kw's leading axis the
    within-patch column wv (the `k1d` of ctvit.py:95)."""
    gamma = emb[1].weight.float()                          # [patch_dim]
    beta = emb[1].bias.float()
    w = emb[2].weight.float().t()                          # [patch_dim, dim]
    wg = w * gamma[:, None]
    dim = w.shape[1]
    kw = wg.reshape(channels * t_patch * patch, patch, dim).permute(1, 0, 2).contiguous()
    return kw, wg.sum(0), beta @ w + emb[2].bias.float()


def _kernel_weight(kw: torch.Tensor, dtype) -> torch.Tensor:
    """kw [patch(wv), cin, dim] -> [dim, cin * patch] in `dtype`: column
    (cin, wv), the order of a patch's pixels in the volume."""
    patch, cin, dim = kw.shape
    return kw.to(dtype).permute(2, 1, 0).reshape(dim, cin * patch).contiguous()


def patch_embed_plain(image: torch.Tensor, kw: torch.Tensor, s1: torch.Tensor,
                      b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                      patch: int, t_patch: int) -> torch.Tensor:
    """image [b, c, T, H, W]; kw [patch, cin, dim] fp32; s1/b1/g2/b2 [dim].
    Returns [b, T/t_patch, H/patch, W/patch, dim] in the image dtype."""
    b, c, T, H, W = image.shape
    t, hp, wp = T // t_patch, H // patch, W // patch
    dim = kw.shape[-1]
    x = image.reshape(b, c, t, t_patch, hp, patch, wp, patch)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b * t * hp * wp, -1).float()
    conv = x @ _kernel_weight(kw, image.dtype).float().t()
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    h = (conv - mean * s1.float()) * torch.rsqrt(var + EPS) + b1.float()
    h = h.to(image.dtype).float()
    mu = h.mean(-1, keepdim=True)
    v = h.var(-1, unbiased=False, keepdim=True)
    out = (h - mu) * torch.rsqrt(v + EPS) * g2.float() + b2.float()
    return out.reshape(b, t, hp, wp, dim).to(image.dtype)


def patch_embed_fused(image: torch.Tensor, kw: torch.Tensor, s1: torch.Tensor,
                      b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                      patch: int, t_patch: int) -> torch.Tensor:
    """The patch_embed kernel on CUDA tensors (a bf16 [b, 1, T, H, W] volume
    with T, H, W multiples of the patch sizes; fp32 kw, s1, b1, g2, b2), the
    plain version on CPU tensors."""
    if not _build.on_cuda(image):
        return patch_embed_plain(image, kw, s1, b1, g2, b2, patch, t_patch)
    b, c, T, H, W = image.shape
    if c != 1 or T % t_patch or H % patch or W % patch:
        raise ValueError(f"the patch_embed kernel takes one channel and T, H, W that the "
                         f"patch sizes ({t_patch}, {patch}, {patch}) divide; got "
                         f"{tuple(image.shape)}")
    dim = kw.shape[-1]
    dev = image.device
    for t, name, dtype, shape in ((image, "image", torch.bfloat16, (b, 1, T, H, W)),
                                  (kw, "kw", torch.float32, (patch, t_patch * patch, dim)),
                                  (s1, "s1", torch.float32, (dim,)),
                                  (b1, "b1", torch.float32, (dim,)),
                                  (g2, "g2", torch.float32, (dim,)),
                                  (b2, "b2", torch.float32, (dim,))):
        _build.require(t, name, dtype, shape, dev)
    t, hp, wp = T // t_patch, H // patch, W // patch
    m = b * t * hp * wp
    kwd = _kernel_weight(kw, image.dtype)
    stats = torch.empty((m, 2), dtype=torch.float32, device=dev)
    out = torch.empty((b, t, hp, wp, dim), dtype=image.dtype, device=dev)
    err = _build.load().ctc_patch_embed(
        image.data_ptr(), kwd.data_ptr(), s1.data_ptr(), b1.data_ptr(), g2.data_ptr(),
        b2.data_ptr(), stats.data_ptr(), out.data_ptr(), b, T, H, W, patch, t_patch, dim,
        _build.stream_of(image))
    _build.check(err, "patch_embed")
    launches.count("patch_embed")
    return out
