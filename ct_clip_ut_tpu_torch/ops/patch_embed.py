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

Training takes `patch_embed_grad`, an autograd Function whose forward is
the residual-saving chain (`patch_embed_res`: the port of
`_forward_res_impl`, which also keeps the fp32 product and each patch's LN1
mean and rstd) and whose backward is `_pe_bwd` (pallas_patch_embed.py:
223-280): the LayerNorm chain in plain PyTorch (elementwise, as it is XLA
in the JAX package) from those residuals, then the projection weight grad
`patch_embed_dkw` (`csrc/patch_embed_dkw.cu`, the port of `_dkw_impl`; its
plain version `patch_embed_dkw_plain` on CPU tensors). The image cotangent
is autograd of the plain version, and only when the image requires grad
(the JAX package's `_xla_twin` VJP); training never asks for it.
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


def _check_embed_args(image, kw, s1, b1, g2, b2, patch: int, t_patch: int) -> None:
    """Raise unless the patch_embed kernels take these arguments."""
    b, c, T, H, W = image.shape
    if c != 1 or T % t_patch or H % patch or W % patch:
        raise ValueError(f"the patch_embed kernel takes one channel and T, H, W that the "
                         f"patch sizes ({t_patch}, {patch}, {patch}) divide; got "
                         f"{tuple(image.shape)}")
    dim = kw.shape[-1]
    for t, name, dtype, shape in ((image, "image", torch.bfloat16, (b, 1, T, H, W)),
                                  (kw, "kw", torch.float32, (patch, t_patch * patch, dim)),
                                  (s1, "s1", torch.float32, (dim,)),
                                  (b1, "b1", torch.float32, (dim,)),
                                  (g2, "g2", torch.float32, (dim,)),
                                  (b2, "b2", torch.float32, (dim,))):
        _build.require(t, name, dtype, shape, image.device)


def patch_embed_fused(image: torch.Tensor, kw: torch.Tensor, s1: torch.Tensor,
                      b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                      patch: int, t_patch: int) -> torch.Tensor:
    """The patch_embed kernel on CUDA tensors (a bf16 [b, 1, T, H, W] volume
    with T, H, W multiples of the patch sizes; fp32 kw, s1, b1, g2, b2), the
    plain version on CPU tensors."""
    if not _build.on_cuda(image):
        return patch_embed_plain(image, kw, s1, b1, g2, b2, patch, t_patch)
    b, c, T, H, W = image.shape
    _check_embed_args(image, kw, s1, b1, g2, b2, patch, t_patch)
    dim = kw.shape[-1]
    dev = image.device
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


def _patches(image: torch.Tensor, patch: int, t_patch: int) -> torch.Tensor:
    """[b, c, T, H, W] -> [b * t * hp * wp, c * t_patch * patch * patch] in
    the image dtype, column (c, tv, p1, wv)."""
    b, c, T, H, W = image.shape
    t, hp, wp = T // t_patch, H // patch, W // patch
    x = image.reshape(b, c, t, t_patch, hp, patch, wp, patch)
    return x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b * t * hp * wp, -1)


def patch_embed_res_plain(image: torch.Tensor, kw: torch.Tensor, s1: torch.Tensor,
                          b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                          patch: int, t_patch: int) -> tuple:
    """(out as patch_embed_plain, conv [M, dim] fp32 (the product before
    the folded LN1), stats [M, 2] fp32 (each patch's LN1 mean and rstd))."""
    b, c, T, H, W = image.shape
    x = _patches(image, patch, t_patch).float()
    conv = x @ _kernel_weight(kw, image.dtype).float().t()
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + EPS)
    out = patch_embed_plain(image, kw, s1, b1, g2, b2, patch, t_patch)
    return out, conv, torch.cat([mean, rstd], dim=-1)


def patch_embed_res(image: torch.Tensor, kw: torch.Tensor, s1: torch.Tensor,
                    b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                    patch: int, t_patch: int) -> tuple:
    """The residual-saving patch_embed chain on CUDA tensors (the forward's
    inputs), the plain version on CPU tensors."""
    if not _build.on_cuda(image):
        return patch_embed_res_plain(image, kw, s1, b1, g2, b2, patch, t_patch)
    b, dim, dev = image.shape[0], kw.shape[-1], image.device
    T, H, W = image.shape[2:]
    _check_embed_args(image, kw, s1, b1, g2, b2, patch, t_patch)
    m = b * (T // t_patch) * (H // patch) * (W // patch)
    kwd = _kernel_weight(kw, image.dtype)
    stats = torch.empty((m, 2), dtype=torch.float32, device=dev)
    conv = torch.empty((m, dim), dtype=torch.float32, device=dev)
    out = torch.empty((b, T // t_patch, H // patch, W // patch, dim), dtype=image.dtype,
                      device=dev)
    err = _build.load().ctc_patch_embed_res(
        image.data_ptr(), kwd.data_ptr(), s1.data_ptr(), b1.data_ptr(), g2.data_ptr(),
        b2.data_ptr(), stats.data_ptr(), out.data_ptr(), conv.data_ptr(), b, T, H, W, patch,
        t_patch, dim, _build.stream_of(image))
    _build.check(err, "patch_embed_res")
    launches.count("patch_embed_res")
    return out, conv, stats


def patch_embed_dkw_plain(image: torch.Tensor, dconv: torch.Tensor, patch: int,
                          t_patch: int) -> torch.Tensor:
    """dkw [patch(wv), cin, dim] fp32 = sum over patches of x^T dconv, with
    the patches in the image dtype and dconv [M, dim] (image dtype), fp32
    accumulation (`_dkw_kernel`)."""
    x = _patches(image, patch, t_patch).float()
    dk = x.t() @ dconv.float()                            # [(cin, wv), dim]
    cin = x.shape[1] // patch
    return dk.reshape(cin, patch, -1).permute(1, 0, 2).contiguous()


def patch_embed_dkw(image: torch.Tensor, dconv: torch.Tensor, patch: int,
                    t_patch: int) -> torch.Tensor:
    """The patch_embed_dkw kernel on CUDA tensors (the bf16 volume and a
    bf16 dconv [M, dim]), the plain version on CPU tensors."""
    if not _build.on_cuda(image):
        return patch_embed_dkw_plain(image, dconv, patch, t_patch)
    b, c, T, H, W = image.shape
    m, dim = dconv.shape
    k = t_patch * patch * patch
    if c != 1 or T % t_patch or H % patch or W % patch:
        raise ValueError(f"patch_embed_dkw takes one channel and T, H, W that the patch sizes "
                         f"divide; got {tuple(image.shape)}")
    _build.require(image, "image", torch.bfloat16, (b, 1, T, H, W), image.device)
    _build.require(dconv, "dconv", torch.bfloat16,
                   (b * (T // t_patch) * (H // patch) * (W // patch), dim), image.device)
    out = torch.zeros((k, dim), dtype=torch.float32, device=image.device)
    err = _build.load().ctc_patch_embed_dkw(image.data_ptr(), dconv.data_ptr(), out.data_ptr(),
                                            b, T, H, W, patch, t_patch, dim,
                                            _build.stream_of(image))
    _build.check(err, "patch_embed_dkw")
    launches.count("patch_embed_dkw")
    return out.reshape(k // patch, patch, dim).permute(1, 0, 2).contiguous()


def patch_embed_ln_bwd(conv: torch.Tensor, stats: torch.Tensor, s1: torch.Tensor,
                       b1: torch.Tensor, g2: torch.Tensor, g: torch.Tensor,
                       dtype: torch.dtype) -> tuple:
    """`_pe_bwd`'s LayerNorm chain (pallas_patch_embed.py:245-270) from the
    saved residuals: (dconv [M, dim] fp32, ds1, db1, dg2, db2). With pre =
    (conv - mean s1) rstd + b1 and out = LN2(cast(pre)) g2 + b2 (LN2 in the
    one-pass form there)."""
    n, dim = conv.shape
    meanc, rs = stats[:, :1], stats[:, 1:]
    pre = (conv - meanc * s1.float()) * rs + b1.float()
    h = pre.to(dtype).float()
    mu = h.mean(-1, keepdim=True)
    v = ((h * h).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    r = torch.rsqrt(v + EPS)
    xhat = (h - mu) * r
    gf = g.reshape(n, dim).float()
    dg2, db2 = (gf * xhat).sum(0), gf.sum(0)
    gq = gf * g2.float()
    dpre = r * (gq - gq.mean(-1, keepdim=True) - xhat * (gq * xhat).mean(-1, keepdim=True))
    dconv = dpre * rs
    return dconv, -(dconv * meanc).sum(0), dpre.sum(0), dg2, db2


class _PatchEmbedFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, kw, s1, b1, g2, b2, patch, t_patch):
        out, conv, stats = patch_embed_res(image, kw, s1, b1, g2, b2, patch, t_patch)
        ctx.save_for_backward(image, kw, s1, b1, g2, b2, conv, stats)
        ctx.patch, ctx.t_patch = patch, t_patch
        return out

    @staticmethod
    def backward(ctx, g):
        image, kw, s1, b1, g2, b2, conv, stats = ctx.saved_tensors
        patch, t_patch = ctx.patch, ctx.t_patch
        dconv, ds1, db1, dg2, db2 = patch_embed_ln_bwd(conv, stats, s1, b1, g2, g, image.dtype)
        dkw = patch_embed_dkw(image, dconv.to(image.dtype), patch, t_patch)
        dimage = None
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                im = image.detach().requires_grad_(True)
                out = patch_embed_plain(im, kw.detach(), s1.detach(), b1.detach(), g2.detach(),
                                        b2.detach(), patch, t_patch)
                dimage, = torch.autograd.grad(out, im, g)
        return (dimage, dkw.to(kw.dtype), ds1.to(s1.dtype), db1.to(b1.dtype), dg2.to(g2.dtype),
                db2.to(b2.dtype), None, None)


def patch_embed_grad(image: torch.Tensor, kw: torch.Tensor, s1: torch.Tensor,
                     b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                     patch: int, t_patch: int) -> torch.Tensor:
    """patch_embed_fused's value with the residual-based backward (the
    training path); kernels on CUDA tensors, plain versions on CPU ones."""
    return _PatchEmbedFn.apply(image, kw, s1, b1, g2, b2, patch, t_patch)
