"""CT-ViT patch embed in the LN-folded conv form: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_patch_embed.py:patch_embed_fused (the
forward, `_forward_impl`). The CUDA chain is `csrc/patch_embed.cu`: a
patchify pass writes the patch matrix P (and each patch's LN1 moments), the
Hopper GEMM core reads it through TMA (`tma_operands` is the plan), and an
LN2 pass finishes; its header says what bounds it on the H100 and what the
design does about it.

patchify -> LN1 -> Linear -> LN2 (ctvit.py:56-60) is computed with LN1
folded into the projection (models/ctvit.py:63-99 of the JAX package):

    LN1(x) @ W + b = ((x @ (gamma * W)) - mean(x) * s1) * rsqrt(var(x) + eps) + b1,
    s1 = sum_i gamma_i W_i,   b1 = beta @ W + b,

so the projection runs on the raw pixels and the per-patch moments are
applied afterwards. `fold_patch_embed` builds the folded weights in fp32;
`patch_embed_fused` launches the kernel for CUDA tensors (bf16; an fp32
volume takes the fp32 variant `patch_embed_f32`, the product as three bf16
products of hi / lo planes) and takes the plain version for CPU tensors;
`patch_embed_plain` is the `_xla_twin` math
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
plain version `patch_embed_dkw_plain` on CPU tensors). On the card the
forward's patch matrix P is kept for the weight grad, which then reads it
instead of writing it again (221 MB more held across a B = 2 step). The
image cotangent is autograd of the plain version, and only when the image
requires grad (the JAX package's `_xla_twin` VJP); training never asks
for it. An fp32 volume (the fp32 train step) takes the fp32 forms of both
kernels: `patch_embed_res_f32` (`ctc_patch_embed_res_f32`, row 5f's chain
also storing conv and the moments; its product on the staged split
products of split_sm90.cuh) keeps P's hi / lo planes (rows of 4,032, 446
MB at B = 2), and `patch_embed_dkw` reads them on the split
weight-gradient plan (`ctc_patch_embed_dkw_f32`), dconv staying fp32 as
in JAX's `_pe_bwd`.
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


def _plane_pitch(k: int) -> int:
    """The row length, in elements, of the fp32 chains' bf16 planes of P and
    of the folded weight: K rounded up to 64 (128-B rows, so that each
    64-wide K slice the staged product loads starts on a 128-B line)."""
    return -(-k // 64) * 64


def _check_embed_args(image, kw, s1, b1, g2, b2, patch: int, t_patch: int,
                      dtype=torch.bfloat16) -> None:
    """Raise unless the patch_embed kernels take these arguments (a volume
    in `dtype`: bf16, or fp32 for the fp32 variant)."""
    b, c, T, H, W = image.shape
    if c != 1 or T % t_patch or H % patch or W % patch:
        raise ValueError(f"the patch_embed kernel takes one channel and T, H, W that the "
                         f"patch sizes ({t_patch}, {patch}, {patch}) divide; got "
                         f"{tuple(image.shape)}")
    dim = kw.shape[-1]
    for t, name, dt, shape in ((image, "image", dtype, (b, 1, T, H, W)),
                               (kw, "kw", torch.float32, (patch, t_patch * patch, dim)),
                               (s1, "s1", torch.float32, (dim,)),
                               (b1, "b1", torch.float32, (dim,)),
                               (g2, "g2", torch.float32, (dim,)),
                               (b2, "b2", torch.float32, (dim,))):
        _build.require(t, name, dt, shape, image.device)


def tma_operands(image: torch.Tensor, kw: torch.Tensor, patch: int, t_patch: int) -> dict:
    """The operands the patch_embed GEMM reads through TMA, name -> (tensor,
    rows, cols, row stride in elements): the patch matrix P [M, K] as a
    fresh workspace [M, ldp] (ldp = K rounded up to 16 B; the patchify pass
    writes it whole, zeros past K), and the folded weight [dim, K] in the
    image dtype, column (tv, p1, wv), as it is where its rows are 16-B
    strided, else a zero-padded copy made on this call."""
    b, c, T, H, W = image.shape
    m = b * (T // t_patch) * (H // patch) * (W // patch)
    k = t_patch * patch * patch
    kwd, ldk = _build.tma_rows(_kernel_weight(kw, image.dtype))
    ldp = _build.tma_pitch(k, image.element_size())
    return {"patches": (torch.empty((m, ldp), dtype=image.dtype, device=image.device), m, k, ldp),
            "kwd": (kwd, kw.shape[-1], k, ldk)}


def _launch(entry: str, image, kw, s1, b1, g2, b2, patch: int, t_patch: int,
            conv: bool) -> tuple:
    """Run ctc_patch_embed(_res) on CUDA tensors: (out, conv or None, stats,
    the patch matrix P [M, ldp])."""
    b, c, T, H, W = image.shape
    _check_embed_args(image, kw, s1, b1, g2, b2, patch, t_patch)
    dim = kw.shape[-1]
    dev = image.device
    t, hp, wp = T // t_patch, H // patch, W // patch
    m = b * t * hp * wp
    ops = tma_operands(image, kw, patch, t_patch)
    stats = torch.empty((m, 2), dtype=torch.float32, device=dev)
    out = torch.empty((b, t, hp, wp, dim), dtype=image.dtype, device=dev)
    res = torch.empty((m, dim), dtype=torch.float32, device=dev) if conv else None
    err = getattr(_build.load(), entry)(
        image.data_ptr(), ops["kwd"][0].data_ptr(), s1.data_ptr(), b1.data_ptr(),
        g2.data_ptr(), b2.data_ptr(), ops["patches"][0].data_ptr(), stats.data_ptr(),
        out.data_ptr(), *([res.data_ptr()] if conv else []), b, T, H, W, patch, t_patch, dim,
        ops["patches"][3], ops["kwd"][3], _build.stream_of(image))
    _build.check(err, entry)
    return out, res, stats, ops["patches"][0]


def _launch_f32(entry: str, image, kw, s1, b1, g2, b2, patch: int, t_patch: int,
                one_pass: bool, conv: bool) -> tuple:
    """Run the fp32 chain `entry` (ctc_patch_embed_f32, or
    ctc_patch_embed_res_f32 with conv) on CUDA tensors: (out, conv or None,
    stats, P's planes [2, M, ld]). The one place that knows its workspaces
    (P's and the folded weight's hi / lo planes, rows padded to 16 B; each
    patch's LN1 moments). one_pass zeroes every lo plane (the control)."""
    b, c, T, H, W = image.shape
    _check_embed_args(image, kw, s1, b1, g2, b2, patch, t_patch, torch.float32)
    dim = kw.shape[-1]
    if dim % 4:
        raise ValueError(f"the fp32 patch_embed kernel takes a width that 4 divides, got {dim}")
    dev = image.device
    t, hp, wp = T // t_patch, H // patch, W // patch
    m, k = b * t * hp * wp, t_patch * patch * patch
    ld = _plane_pitch(k)
    kwd = _kernel_weight(kw, torch.float32)
    if ld != k:
        kwd = torch.nn.functional.pad(kwd, (0, ld - k))
    image = _build.aligned16(image)
    b16 = dict(dtype=torch.bfloat16, device=dev)
    patches, kw_s = torch.empty((2, m, ld), **b16), torch.empty((2, dim, ld), **b16)
    stats = torch.empty((m, 2), dtype=torch.float32, device=dev)
    out = torch.empty((b, t, hp, wp, dim), dtype=torch.float32, device=dev)
    res = torch.empty((m, dim), dtype=torch.float32, device=dev) if conv else None
    err = getattr(_build.load(), entry)(
        image.data_ptr(), kwd.data_ptr(), s1.data_ptr(), b1.data_ptr(), g2.data_ptr(),
        b2.data_ptr(), patches.data_ptr(), kw_s.data_ptr(), stats.data_ptr(), out.data_ptr(),
        *([res.data_ptr()] if conv else []), b, T, H, W, patch, t_patch, dim, ld, int(one_pass),
        _build.stream_of(image))
    _build.check(err, entry)
    return out, res, stats, patches


def patch_embed_f32(image: torch.Tensor, kw: torch.Tensor, s1: torch.Tensor,
                    b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor, patch: int,
                    t_patch: int, one_pass: bool = False) -> torch.Tensor:
    """Run the fp32 chain ctc_patch_embed_f32 on CUDA tensors (no count);
    one_pass zeroes every lo plane (the control)."""
    return _launch_f32("ctc_patch_embed_f32", image, kw, s1, b1, g2, b2, patch, t_patch,
                       one_pass, False)[0]


def patch_embed_res_f32(image: torch.Tensor, kw: torch.Tensor, s1: torch.Tensor,
                        b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor, patch: int,
                        t_patch: int, one_pass: bool = False) -> tuple:
    """Run the fp32 residual-saving chain ctc_patch_embed_res_f32 on CUDA
    tensors (no count): (out, conv [M, dim], stats [M, 2], P's planes [2,
    M, ld] bf16 for the weight gradient), all but P fp32."""
    return _launch_f32("ctc_patch_embed_res_f32", image, kw, s1, b1, g2, b2, patch, t_patch,
                       one_pass, True)


def patch_embed_fused(image: torch.Tensor, kw: torch.Tensor, s1: torch.Tensor,
                      b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                      patch: int, t_patch: int) -> torch.Tensor:
    """The patch_embed kernel on CUDA tensors (a bf16 [b, 1, T, H, W] volume
    with T, H, W multiples of the patch sizes; fp32 kw, s1, b1, g2, b2; an
    fp32 volume takes the fp32 variant), the plain version on CPU tensors."""
    if not _build.on_cuda(image):
        return patch_embed_plain(image, kw, s1, b1, g2, b2, patch, t_patch)
    if image.dtype == torch.float32:
        out = patch_embed_f32(image, kw, s1, b1, g2, b2, patch, t_patch)
        launches.count("patch_embed_f32")
        return out
    out = _launch("ctc_patch_embed", image, kw, s1, b1, g2, b2, patch, t_patch, False)[0]
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
    return _res_with_patches(image, kw, s1, b1, g2, b2, patch, t_patch)[:3]


def _res_with_patches(image, kw, s1, b1, g2, b2, patch: int, t_patch: int) -> tuple:
    """patch_embed_res and the patch matrix P its chain wrote (None on CPU
    tensors, whose weight grad takes the plain version)."""
    if not _build.on_cuda(image):
        return (*patch_embed_res_plain(image, kw, s1, b1, g2, b2, patch, t_patch), None)
    if image.dtype == torch.float32:
        out = patch_embed_res_f32(image, kw, s1, b1, g2, b2, patch, t_patch)
        launches.count("patch_embed_res_f32")
        return out
    out = _launch("ctc_patch_embed_res", image, kw, s1, b1, g2, b2, patch, t_patch, True)
    launches.count("patch_embed_res")
    return out


def patch_embed_dkw_plain(image: torch.Tensor, dconv: torch.Tensor, patch: int,
                          t_patch: int) -> torch.Tensor:
    """dkw [patch(wv), cin, dim] fp32 = sum over patches of x^T dconv, with
    the patches in the image dtype and dconv [M, dim] (image dtype), fp32
    accumulation (`_dkw_kernel`)."""
    x = _patches(image, patch, t_patch).float()
    dk = x.t() @ dconv.float()                            # [(cin, wv), dim]
    cin = x.shape[1] // patch
    return dk.reshape(cin, patch, -1).permute(1, 0, 2).contiguous()


def _patch_matrix(image: torch.Tensor, patch: int, t_patch: int) -> torch.Tensor:
    """The patch matrix P [M, ldp] bf16 of a bf16 volume on the card, as
    the forward's patchify pass writes it (zeros past K): the weight
    gradient's operand for a call from the volume alone."""
    b, _, T, H, W = image.shape
    m = b * (T // t_patch) * (H // patch) * (W // patch)
    patches = torch.empty((m, _build.tma_pitch(t_patch * patch * patch, image.element_size())),
                          dtype=torch.bfloat16, device=image.device)
    err = _build.load().ctc_patchify(image.data_ptr(), patches.data_ptr(), b, T, H, W, patch,
                                     t_patch, patches.shape[1], _build.stream_of(image))
    _build.check(err, "ctc_patchify")
    return patches


def _patch_planes_f32(image: torch.Tensor, patch: int, t_patch: int,
                      one_pass: bool = False) -> torch.Tensor:
    """P's hi / lo planes [2, M, ld] bf16 of an fp32 volume on the card, as
    the fp32 forward's patchify pass writes them (zeros past K): the fp32
    weight gradient's operand for a call from the volume alone."""
    b, _, T, H, W = image.shape
    m = b * (T // t_patch) * (H // patch) * (W // patch)
    ld = _plane_pitch(t_patch * patch * patch)
    image = _build.aligned16(image)
    planes = torch.empty((2, m, ld), dtype=torch.bfloat16, device=image.device)
    err = _build.load().ctc_patchify_f32(image.data_ptr(), planes.data_ptr(), b, T, H, W, patch,
                                         t_patch, ld, int(one_pass), _build.stream_of(image))
    _build.check(err, "ctc_patchify_f32")
    return planes


def patch_embed_dkw(image: torch.Tensor, dconv: torch.Tensor, patch: int, t_patch: int,
                    patches=None, *, one_pass: bool = False) -> torch.Tensor:
    """The patch_embed_dkw kernel on CUDA tensors (the volume and dconv [M,
    dim] in one dtype, bf16 or fp32; dim a multiple of 8), the plain version
    on CPU tensors. The kernel reads the patch matrix P of this volume:
    `patches` as the forward wrote it (`_res_with_patches`, the train
    step's form: [M, ldp] bf16, or its hi / lo planes [2, M, ld] for an
    fp32 volume), else written from the volume on this call. The output is
    written whole, in one summation order: the same bits from call to call.
    one_pass (fp32, from the volume only) zeroes every lo plane, the
    control, and does not count as a launch of the path."""
    if not _build.on_cuda(image):
        return patch_embed_dkw_plain(image, dconv, patch, t_patch)
    b, c, T, H, W = image.shape
    dim = dconv.shape[-1]
    k = t_patch * patch * patch
    if c != 1 or T % t_patch or H % patch or W % patch:
        raise ValueError(f"patch_embed_dkw takes one channel and T, H, W that the patch sizes "
                         f"divide; got {tuple(image.shape)}")
    if dim % 8:
        raise ValueError(f"patch_embed_dkw reads dconv through TMA (16-B rows); dim {dim} is "
                         "not a multiple of 8")
    dt = image.dtype if image.dtype == torch.float32 else torch.bfloat16
    _build.require(image, "image", dt, (b, 1, T, H, W), image.device)
    m = b * (T // t_patch) * (H // patch) * (W // patch)
    _build.require(dconv, "dconv", dt, (m, dim), image.device)
    out = torch.empty((patch, k // patch, dim), dtype=torch.float32, device=image.device)
    if dt == torch.float32:
        if one_pass and patches is not None:
            raise ValueError("the one-pass control writes its own one-pass planes of P")
        ld = _plane_pitch(k)
        if patches is None:
            patches = _patch_planes_f32(image, patch, t_patch, one_pass)
        _build.require(patches, "patches", torch.bfloat16, (2, m, ld), image.device)
        dconv = _build.aligned16(dconv)
        dconv_s = torch.empty((2, m, dim), dtype=torch.bfloat16, device=image.device)
        err = _build.load().ctc_patch_embed_dkw_f32(
            patches.data_ptr(), dconv.data_ptr(), dconv_s.data_ptr(), out.data_ptr(), b, T, H, W,
            patch, t_patch, dim, ld, int(one_pass), _build.stream_of(image))
        _build.check(err, "patch_embed_dkw_f32")
        if not one_pass:
            launches.count("patch_embed_dkw_f32")
        return out
    if one_pass:
        raise ValueError("one_pass is the fp32 chain's control")
    ldp = _build.tma_pitch(k, image.element_size())
    if patches is None:
        patches = _patch_matrix(image, patch, t_patch)
    _build.require(patches, "patches", torch.bfloat16, (m, ldp), image.device)
    err = _build.load().ctc_patch_embed_dkw(patches.data_ptr(), dconv.data_ptr(), out.data_ptr(),
                                            b, T, H, W, patch, t_patch, dim, ldp,
                                            _build.stream_of(image))
    _build.check(err, "patch_embed_dkw")
    launches.count("patch_embed_dkw")
    return out


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
        out, conv, stats, patches = _res_with_patches(image, kw, s1, b1, g2, b2, patch, t_patch)
        ctx.save_for_backward(image, kw, s1, b1, g2, b2, conv, stats)
        ctx.patch, ctx.t_patch, ctx.patches = patch, t_patch, patches
        return out

    @staticmethod
    def backward(ctx, g):
        image, kw, s1, b1, g2, b2, conv, stats = ctx.saved_tensors
        patch, t_patch = ctx.patch, ctx.t_patch
        dconv, ds1, db1, dg2, db2 = patch_embed_ln_bwd(conv, stats, s1, b1, g2, g, image.dtype)
        dkw = patch_embed_dkw(image, dconv.to(image.dtype), patch, t_patch, ctx.patches)
        ctx.patches = None
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
