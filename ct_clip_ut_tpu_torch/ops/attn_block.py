"""Cosine-attention block with a position bias: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_attn_block.py:attention_block_fused (the
CT-ViT spatial stack). The CUDA chain is `csrc/attn_block.cu`; its header
says what bounds it on the H100 and what the design does about it.
`attn_block` launches it for CUDA tensors (bf16; fp32 tensors take its fp32
variant, every product three bf16 products of hi / lo planes) and takes the
plain version for CPU tensors.

`attn_block_plain` is the block in plain PyTorch with the TPU kernel's
rounding points (pallas_attn_block.py:51-101): LN without bias (one-pass
moments) rounded to the compute dtype; q, k, v projected in fp32 (q from the
LN output, k and v from the PRE-norm x); q and k l2-normalised per head and
scaled in fp32; fp32 scores + bias and softmax; p and v rounded to the
compute dtype before PV; the per-head output rounded before the output
projection; the residual added in fp32.

The backward (pallas_attn_block._backward_impl, the custom VJP's kernel)
is `attn_block_bwd`: the CUDA chain `csrc/attn_block_bwd.cu` for CUDA
tensors (its chain is `csrc/attn_bwd.cuh`), `attn_block_bwd_plain` for CPU
tensors. The plain backward is the
TPU kernel's `_bwd_kernel` in plain PyTorch with its rounding points (dO,
P, dS, the per-head output and dq / dk / dv rounded to the compute dtype
before their products; softmax, l2-norm backward and sums in fp32). At
fp32 the chain is `csrc/attn_bwd_f32.cuh` (every product three bf16
products of hi / lo planes) in two forms: `attn_block_bwd` on fp32 CUDA
tensors returns every gradient (the fp32 train step's backward; the
weight gradients on the split planes in one wgrad_sm90.cuh launch, every
sum over tokens in a fixed order), `attn_block_bwd_f32` dx alone (the
gradient attribution methods', whose parameters are frozen). Its attention
passes are `csrc/attn_bwd_wg.cuh`'s; given `saved`, the o planes and row
statistics the fp32 forward kept (`attn_block(..., keep=True)`, as
`attention._BlockFn` does where a backward may follow), neither form
reruns the forward core. The weight gradients' token slices are cut into
chunks summed in order (`block_wgrad_partition`).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from . import launches
from .fp32_grads import ln_parts

DIM_HEAD = 32   # the head width the CUDA attention cores take
WG_ROWS = 64    # query or key rows a block of the wgmma backward passes (csrc/attn_bwd_wg.cuh)
PACKED_MAX_N = 64   # the longest sequence of the temporal backward's fused pass (attn_bwd_packed.cuh)
WGRAD_TILE = 128    # rows and columns of a weight-gradient tile (csrc/wgrad_sm90.cuh)
WGRAD_SLICE = 64    # tokens a slice of its K loop
WGRAD_BLOCKS = 132  # blocks a chunked weight gradient aims at: one an SM of the H100


def block_wgrad_partition(tokens: int, d: int, hd: int) -> tuple:
    """(slices a chunk, chunks) of BlockWgradSplitPlan's launch
    (csrc/attn_bwd_f32.cuh): its 4 ceil(d / 128) hd / 128 tiles' token
    slices cut into equal chunks, as many as keep about WGRAD_BLOCKS
    blocks busy, the last one ragged; (0, 1) where one chunk would take
    them all (each tile then sums every token itself). Chunk c holds
    tokens [c slices_a_chunk 64, min((c + 1) slices_a_chunk 64, tokens))."""
    tiles = 4 * -(-d // WGRAD_TILE) * (hd // WGRAD_TILE)
    slices = -(-tokens // WGRAD_SLICE)
    chunks = max(1, min(slices, WGRAD_BLOCKS // tiles))
    per = -(-slices // chunks)
    chunks = -(-slices // per)
    return (per, chunks) if chunks > 1 else (0, 1)


def attn_block_plain(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
                     wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
                     qs: torch.Tensor, ks: torch.Tensor, bias: Optional[torch.Tensor],
                     scale: float = 8.0, residual: bool = False) -> torch.Tensor:
    """x [R, n, D]; gamma [D]; wq/wk/wv [h*dh, D]; wo [D, h*dh]; qs/ks [dh];
    bias [h, n, n] or None. Returns [R, n, D] in x's dtype."""
    dt = x.dtype
    r, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    xn = ((x32 - mean) * torch.rsqrt(var + 1e-5) * gamma.float()).to(dt).float()

    def heads_of(t):   # [r, n, h*dh] -> [r, h, n, dh]
        return t.reshape(r, n, heads, dh).transpose(1, 2)

    q = heads_of(xn @ wq.to(dt).float().t())
    k = heads_of(x32 @ wk.to(dt).float().t())
    v = heads_of(x32 @ wv.to(dt).float().t()).to(dt).float()
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12) \
        * (qs.float() * scale)
    k = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12) * ks.float()
    s = q @ k.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1).to(dt).float()
    o = (p @ v).to(dt).float().transpose(1, 2).reshape(r, n, heads * dh)
    out = o @ wo.to(dt).float().t()
    if residual:
        out = out + x32
    return out.to(dt)


def check_block_args(x, gamma, wq, wk, wv, wo, qs, ks, max_n: int,
                     dtype=torch.bfloat16) -> tuple:
    """Validate the block kernels' arguments (x and the weights in `dtype`:
    bf16, or fp32 for the fp32 variants); returns (R, n, D, heads)."""
    r, n, d = x.shape
    hd = wq.shape[0]
    heads = hd // DIM_HEAD
    if qs.shape != (DIM_HEAD,) or hd % 128 != 0:
        raise ValueError(f"the attention kernels take heads of {DIM_HEAD} and "
                         f"heads*{DIM_HEAD} a multiple of 128; got dh={tuple(qs.shape)}, "
                         f"h*dh={hd}")
    if n > max_n:
        raise ValueError(f"sequence length {n} over the kernel's {max_n}")
    if d % 8:
        raise ValueError(f"the attention kernels take a width that 8 divides (16-B TMA rows), "
                         f"got {d}")
    dev = x.device
    for t, name, dt, shape in ((x, "x", dtype, (r, n, d)),
                               (gamma, "gamma", torch.float32, (d,)),
                               (wq, "wq", dtype, (hd, d)),
                               (wk, "wk", dtype, (hd, d)),
                               (wv, "wv", dtype, (hd, d)),
                               (wo, "wo", dtype, (d, hd)),
                               (qs, "q_scale", torch.float32, (DIM_HEAD,)),
                               (ks, "k_scale", torch.float32, (DIM_HEAD,))):
        _build.require(t, name, dt, shape, dev)
    return r, n, d, heads


def launch_block(entry: str, x, gamma, wq, wk, wv, wo, qs, ks, bias, scale: float,
                 residual: bool) -> torch.Tensor:
    """Run the forward chain `entry` (ctc_attn_block with a bias [h, n, n]
    fp32, ctc_attn_packed with None) on CUDA tensors: the one place that
    knows the two entries' workspaces (xn; q and k as bf16 hi / lo planes;
    v; o)."""
    lib = _build.load()
    max_n = lib.ctc_attn_block_max_n() if bias is not None else lib.ctc_attn_packed_max_n()
    r, n, d, heads = check_block_args(x, gamma, wq, wk, wv, wo, qs, ks, max_n)
    if bias is not None:
        _build.require(bias, "bias", torch.float32, (heads, n, n), x.device)
    m, hd = r * n, heads * DIM_HEAD
    x, wq, wk, wv, wo = (_build.aligned16(t) for t in (x, wq, wk, wv, wo))
    b16 = dict(dtype=torch.bfloat16, device=x.device)
    ws = (torch.empty((m, d), **b16), torch.empty((4, m, hd), **b16),
          torch.empty((m, hd), **b16), torch.empty((m, hd), **b16))
    out = torch.empty_like(x)
    ins = [x, gamma, wq, wk, wv, wo, qs, ks] + ([bias] if bias is not None else [])
    err = getattr(lib, entry)(*(t.data_ptr() for t in ins), *(w.data_ptr() for w in ws),
                              out.data_ptr(), r, n, d, heads, float(scale), int(residual),
                              _build.stream_of(x))
    _build.check(err, entry)
    return out


def launch_block_f32(entry: str, x, gamma, wq, wk, wv, wo, qs, ks, bias, scale: float,
                     residual: bool, one_pass: bool = False, keep: bool = False):
    """Run the fp32 forward chain `entry` (ctc_attn_block_f32 with a bias,
    ctc_attn_packed_f32 with None) on CUDA tensors: the one place that knows
    their workspaces (xn's and x's hi / lo planes; the weights' planes, wq |
    wk | wv stacked; q and k, v, o as hi / lo planes). one_pass zeroes every
    lo plane (the control). keep (with a bias) returns (out, (o, mld)): o's
    planes [2, R*n, h*dh] bf16 and each row's (m log2 e, 1 / l, 0, 0) [R*h*n,
    4] fp32, what ctc_attn_block_bwd_f32 takes in place of rerunning the
    core."""
    lib = _build.load()
    r, n, d, heads = check_block_args(x, gamma, wq, wk, wv, wo, qs, ks,
                                      lib.ctc_attn_f32_max_n(), torch.float32)
    if bias is not None:
        _build.require(bias, "bias", torch.float32, (heads, n, n), x.device)
    m, hd = r * n, heads * DIM_HEAD
    x, gamma, wq, wk, wv, wo = (_build.aligned16(t) for t in (x, gamma, wq, wk, wv, wo))
    b16 = dict(dtype=torch.bfloat16, device=x.device)
    ws = (torch.empty((4, m, d), **b16), torch.empty((2, 3 * hd, d), **b16),
          torch.empty((2, d, hd), **b16), torch.empty((4, m, hd), **b16),
          torch.empty((2, m, hd), **b16), torch.empty((2, m, hd), **b16))
    out = torch.empty_like(x)
    ins = [x, gamma, wq, wk, wv, wo, qs, ks] + ([bias] if bias is not None else [])
    mld = [] if bias is None else [torch.empty((m * heads, 4), dtype=torch.float32,
                                               device=x.device) if keep else None]
    err = getattr(lib, entry)(*(t.data_ptr() for t in ins), *(w.data_ptr() for w in ws),
                              *(None if t is None else t.data_ptr() for t in mld),
                              out.data_ptr(), r, n, d, heads, float(scale), int(residual),
                              int(one_pass), _build.stream_of(x))
    _build.check(err, entry)
    return (out, (ws[5], mld[0])) if keep else out


def attn_block(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
               wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
               qs: torch.Tensor, ks: torch.Tensor, bias: torch.Tensor,
               scale: float = 8.0, residual: bool = False, *, keep: bool = False):
    """The attn_block kernel on CUDA tensors (bf16 x and weights, a width
    that 8 divides; fp32 gamma, scales and bias [h, n, n]; fp32 x and
    weights take the fp32 variant), the plain version on CPU tensors. keep
    (fp32 on CUDA tensors) returns (out, saved): what the fp32 backward
    chain takes in place of rerunning the forward core (`saved` of
    attn_block_bwd_f32 / attn_block_bwd); elsewhere (out, None)."""
    if not _build.on_cuda(x):
        out = attn_block_plain(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual)
        return (out, None) if keep else out
    if bias is None:
        raise ValueError("attn_block takes a bias [h, n, n]; attn_packed is the block without")
    if x.dtype == torch.float32:
        out = launch_block_f32("ctc_attn_block_f32", x, gamma, wq, wk, wv, wo, qs, ks, bias,
                               scale, residual, keep=keep)
        launches.count("attn_block_f32")
        return out
    out = launch_block("ctc_attn_block", x, gamma, wq, wk, wv, wo, qs, ks, bias, scale,
                       residual)
    launches.count("attn_block")
    return (out, None) if keep else out


def attn_block_bwd_plain(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
                         wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
                         qs: torch.Tensor, ks: torch.Tensor, bias: Optional[torch.Tensor],
                         g: torch.Tensor, scale: float = 8.0, residual: bool = False, *,
                         faults: tuple = ()) -> tuple:
    """Gradients of attn_block_plain's output against cotangent g [R, n, D]:
    (dx in x's dtype; dgamma, dwq, dwk, dwv [h*dh, D], dwo [D, h*dh], dqs,
    dks and dbias [h, n, n] (None without a bias) in fp32).

    `faults` builds the wrong gradients a faulty kernel would give, the
    controls of the card's checks: "row_term" drops the softmax row term,
    "l2norm" the l2-norm projection, "gamma" the LN gain from dx."""
    dt = x.dtype
    r, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    m = r * n
    x32 = x.float().reshape(m, d)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + 1e-5)
    xhat = (x32 - mean) * rstd
    xn = (xhat * gamma.float()).to(dt).float()
    wqf, wkf, wvf, wof = (w.to(dt).float() for w in (wq, wk, wv, wo))

    def heads_of(t):   # [m, h*dh] -> [r, h, n, dh]
        return t.reshape(r, n, heads, dh).transpose(1, 2)

    def merged(t):     # [r, h, n, dh] -> [m, h*dh]
        return t.transpose(1, 2).reshape(m, heads * dh)

    def rounded(t):
        return t.to(dt).float()

    q, k = heads_of(xn @ wqf.t()), heads_of(x32 @ wkf.t())
    v = rounded(heads_of(x32 @ wvf.t()))
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    kn = torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12)
    uq, uk = q / qn, k / kn
    qsc, ksc = qs.float() * scale, ks.float()
    qh, kh = uq * qsc, uk * ksc
    s = qh @ kh.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1)
    pt = rounded(p)
    o = rounded(merged(pt @ v))
    gb = rounded(g.reshape(m, d))
    do = rounded(heads_of(gb @ wof))
    dp = do @ v.transpose(-1, -2)
    dv = pt.transpose(-1, -2) @ do
    ds = p * dp if "row_term" in faults else p * (dp - (dp * p).sum(-1, keepdim=True))
    dbias = ds.sum(0) if bias is not None else None
    dsb = rounded(ds)
    dqh = dsb @ rounded(kh)
    dkh = dsb.transpose(-1, -2) @ rounded(qh)
    dqs = (uq * dqh).sum((0, 1, 2)) * scale
    dks = (uk * dkh).sum((0, 1, 2))
    duq, duk = dqh * qsc, dkh * ksc
    if "l2norm" not in faults:
        duq = duq - uq * (uq * duq).sum(-1, keepdim=True)
        duk = duk - uk * (uk * duk).sum(-1, keepdim=True)
    dq, dk = rounded(merged(duq / qn)), rounded(merged(duk / kn))
    dv = rounded(merged(dv))
    dwo = gb.t() @ o
    dxn = dq @ wqf
    dx_direct = dk @ wkf + dv @ wvf
    dwq, dwk, dwv = dq.t() @ xn, dk.t() @ x32, dv.t() @ x32
    dgamma = (dxn * xhat).sum(0)
    dxhat = dxn if "gamma" in faults else dxn * gamma.float()
    dx = (dxhat - dxhat.mean(-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * rstd + dx_direct
    if residual:
        dx = dx + g.reshape(m, d).float()
    return (dx.reshape(r, n, d).to(dt), dgamma, dwq, dwk, dwv, dwo, dqs, dks, dbias)


def launch_attn_bwd(entry: str, x, gamma, wq, wk, wv, wo, qs, ks, bias, g, scale: float,
                    residual: bool) -> tuple:
    """Run the backward chain `entry` (ctc_attn_block_bwd, or
    ctc_attn_packed_bwd when bias is None) on CUDA tensors; returns the
    gradients of attn_block_bwd_plain, in fp32 but dx. The one place that
    knows the entries' workspaces."""
    lib = _build.load()
    r, n, d, heads = check_block_args(x, gamma, wq, wk, wv, wo, qs, ks, lib.ctc_attn_bwd_max_n())
    dev = x.device
    hd = heads * DIM_HEAD
    m = r * n
    _build.require(g, "g", torch.bfloat16, (r, n, d), dev)
    x, g, wq, wk, wv = (_build.aligned16(t) for t in (x, g, wq, wk, wv))
    wqt = wq.t().contiguous()
    wkvt = torch.cat([wk, wv]).t().contiguous()
    wot = wo.t().contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    b16 = dict(dtype=torch.bfloat16, device=dev)
    spatial = entry == "ctc_attn_block_bwd"   # takes bias, biasT and dbias (each may be null)
    biasT = dbias = None
    if bias is not None:
        _build.require(bias, "bias", torch.float32, (heads, n, n), dev)
        biasT = torch.empty((heads, n, n), **f32)
        dbias = torch.empty((heads, n, n), **f32)   # written whole by its pass
    # xn, LN stats; q / k hi, lo planes; their unit rows; their norms
    work = [torch.empty((m, d), **b16), torch.empty((m, 2), **f32),
            torch.empty((4, m, hd), **b16), torch.empty((2, m, hd), **f32),
            torch.empty((2, m, heads), **f32)]
    if spatial:
        work.append(biasT)
    # v, dO, o, dq, dk | dv, each row's (m log2 e, 1 / l, D, 0), dxn, dxd
    work += [torch.empty((m, hd), **b16), torch.empty((m, hd), **b16),
             torch.empty((m, hd), **b16), torch.empty((m, hd), **b16),
             torch.empty((m, 2 * hd), **b16), torch.empty((m * heads, 4), **f32),
             torch.empty((m, d), **f32), torch.empty((m, d), **f32)]
    dx = torch.empty_like(x)
    dgamma, dwq = torch.zeros((d,), **f32), torch.zeros((hd, d), **f32)
    dwkv, dwo = torch.zeros((2 * hd, d), **f32), torch.zeros((d, hd), **f32)
    dqs, dks = torch.zeros((DIM_HEAD,), **f32), torch.zeros((DIM_HEAD,), **f32)
    ins = [x, gamma, wq, wk, wv, wqt, wkvt, wot, qs, ks] + ([bias] if spatial else [])
    outs = [dx, dgamma, dwq, dwkv, dwo, dqs, dks] + ([dbias] if spatial else [])
    err = getattr(lib, entry)(*(None if t is None else t.data_ptr() for t in ins), g.data_ptr(),
                              *(None if t is None else t.data_ptr() for t in work),
                              *(None if t is None else t.data_ptr() for t in outs),
                              r, n, d, heads, float(scale), int(residual), _build.stream_of(x))
    _build.check(err, entry)
    return dx, dgamma, dwq, dwkv[:hd], dwkv[hd:], dwo, dqs, dks, dbias


def attn_block_bwd(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
                   wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
                   qs: torch.Tensor, ks: torch.Tensor, bias: torch.Tensor,
                   g: torch.Tensor, scale: float = 8.0, residual: bool = False, *,
                   one_pass: bool = False, saved=None) -> tuple:
    """The attn_block backward kernel chain on CUDA tensors (the forward's
    types; g like x: bf16, or fp32 for the fp32 chain with every parameter
    gradient, where one_pass=True zeroes every lo plane, the control, and
    does not count as a launch of the path, and `saved` is what
    attn_block(..., keep=True) returned, or None to rerun the forward core),
    the plain backward on CPU tensors."""
    if not _build.on_cuda(x):
        return attn_block_bwd_plain(x, gamma, wq, wk, wv, wo, qs, ks, bias, g, scale, residual)
    if x.dtype == torch.float32:
        grads = launch_attn_bwd_f32("ctc_attn_block_bwd_f32", x, gamma, wq, wk, wv, wo, qs, ks,
                                    bias, g, scale, residual, one_pass, params=True, saved=saved)
        if not one_pass:
            launches.count("attn_block_bwd_f32_full")
        return grads
    grads = launch_attn_bwd("ctc_attn_block_bwd", x, gamma, wq, wk, wv, wo, qs, ks, bias, g,
                            scale, residual)
    launches.count("attn_block_bwd")
    return grads


def launch_attn_bwd_f32(entry: str, x, gamma, wq, wk, wv, wo, qs, ks, bias, g, scale: float,
                        residual: bool, one_pass: bool = False, params: bool = False,
                        saved=None):
    """Run the fp32 backward chain `entry` (ctc_attn_block_bwd_f32 with a
    bias, ctc_attn_packed_bwd_f32 with None) on CUDA tensors: dx (+ g under
    residual) alone, or with params=True the gradients of
    attn_block_bwd_plain (dx, dgamma, dwq, dwk, dwv, dwo, dqs, dks, dbias;
    dbias None without a bias), all fp32. The one place that knows their
    workspaces, and allocates only what the route uses: the temporal
    block's fused pass (no bias, n <= PACKED_MAX_N) takes no row statistics
    and writes o's planes only for dWo. one_pass zeroes every lo plane (the
    control). saved (with a bias): the forward's (o planes, row statistics)
    from attn_block(..., keep=True), taken in place of rerunning the core
    (its query pass writes D and lse into the statistics' free columns)."""
    lib = _build.load()
    r, n, d, heads = check_block_args(x, gamma, wq, wk, wv, wo, qs, ks,
                                      lib.ctc_attn_bwd_f32_max_n(), torch.float32)
    dev = x.device
    _build.require(g, "g", torch.float32, (r, n, d), dev)
    if bias is not None:
        _build.require(bias, "bias", torch.float32, (heads, n, n), dev)
    elif saved is not None:
        raise ValueError("saved statistics are the spatial block's (with a bias); the temporal "
                         "chain keeps nothing from the forward")
    m, hd = r * n, heads * DIM_HEAD
    fused = bias is None and n <= PACKED_MAX_N   # the temporal fused pass: no core, no statistics
    x, g, gamma, wq, wk, wv, wo = (_build.aligned16(t) for t in (x, g, gamma, wq, wk, wv, wo))
    f32 = dict(dtype=torch.float32, device=dev)
    b16 = dict(dtype=torch.bfloat16, device=dev)
    # xn's and x's planes; the weights' (wq | wk | wv stacked, wo); g's; q / k
    # planes, their unit rows and norms; [biasT]; v, dO, o planes; row
    # statistics; dq, dk | dv planes; dxn, dx_direct
    work = [torch.empty((4, m, d), **b16), torch.empty((2, 3 * hd, d), **b16),
            torch.empty((2, d, hd), **b16), torch.empty((2, m, d), **b16),
            torch.empty((4, m, hd), **b16), torch.empty((2, m, hd), **f32),
            torch.empty((2, m, heads), **f32)]
    if bias is not None:
        work.append(torch.empty((heads, n, n), **f32))
    if saved is not None:
        o, mld = saved
        _build.require(o, "saved o", torch.bfloat16, (2, m, hd), dev)
        _build.require(mld, "saved statistics", torch.float32, (m * heads, 4), dev)
    else:
        o = torch.empty((2, m, hd), **b16) if params or not fused else None
        mld = None if fused else torch.empty((m * heads, 4), **f32)
    work += [torch.empty((2, m, hd), **b16), torch.empty((2, m, hd), **b16), o, mld,
             torch.empty((2, m, hd), **b16), torch.empty((2, m, 2 * hd), **b16),
             torch.empty((m, d), **f32), torch.empty((m, d), **f32)]
    dx = torch.empty_like(x)
    # the parameter gradients, written whole, then the partial sums of
    # dgamma (with a dbeta half the block has no use for), dq_scale, dk_scale
    # and the weight gradient's partial tiles
    outs = [None] * (6 if bias is not None else 5)
    parts = [None] * 4
    chunk = 0
    if params:
        outs = [torch.empty((d,), **f32), torch.empty((3 * hd, d), **f32),
                torch.empty((d, hd), **f32), torch.empty((DIM_HEAD,), **f32),
                torch.empty((DIM_HEAD,), **f32)]
        if bias is not None:
            outs.append(torch.empty((heads, n, n), **f32))
        blocks = r * heads if fused else r * -(-n // WG_ROWS) * heads
        chunk, chunks = block_wgrad_partition(m, d, hd)
        tiles = 4 * -(-d // WGRAD_TILE) * (hd // WGRAD_TILE)
        parts = [torch.empty((ln_parts(m), 2 * d), **f32), torch.empty((blocks, DIM_HEAD), **f32),
                 torch.empty((blocks, DIM_HEAD), **f32),
                 torch.empty((chunks * tiles, 64, 256), **f32) if chunk else None]
    ins = [x, gamma, wq, wk, wv, wo, qs, ks] + ([bias] if bias is not None else []) + [g]
    err = getattr(lib, entry)(*(t.data_ptr() for t in ins),
                              *(None if w is None else w.data_ptr() for w in work),
                              dx.data_ptr(), *(None if t is None else t.data_ptr()
                                               for t in outs + parts),
                              r, n, d, heads, float(scale), int(residual), chunk,
                              int(one_pass) | (2 if saved is not None else 0),
                              _build.stream_of(x))
    _build.check(err, entry)
    if not params:
        return dx
    dgamma, dw_qkv, dwo, dqs, dks = outs[:5]
    dbias = outs[5] if bias is not None else None
    return dx, dgamma, dw_qkv[:hd], dw_qkv[hd:2 * hd], dw_qkv[2 * hd:], dwo, dqs, dks, dbias


def attn_block_bwd_f32(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
                       wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
                       qs: torch.Tensor, ks: torch.Tensor, bias: torch.Tensor,
                       g: torch.Tensor, scale: float = 8.0, residual: bool = False, *,
                       one_pass: bool = False, saved=None) -> torch.Tensor:
    """dx of attn_block_plain at fp32 against cotangent g: the fp32
    data-gradient chain on CUDA tensors (fp32 x, weights, g and bias [h,
    n, n]; one_pass=True zeroes every lo plane, the control, and does not
    count as a launch of the path; saved as attn_block_bwd's), the plain
    backward's dx on CPU tensors."""
    if not _build.on_cuda(x):
        return attn_block_bwd_plain(x, gamma, wq, wk, wv, wo, qs, ks, bias, g, scale,
                                    residual)[0]
    if bias is None:
        raise ValueError("attn_block_bwd_f32 takes a bias [h, n, n]; attn_packed_bwd_f32 is the "
                         "block without")
    dx = launch_attn_bwd_f32("ctc_attn_block_bwd_f32", x, gamma, wq, wk, wv, wo, qs, ks, bias, g,
                             scale, residual, one_pass, saved=saved)
    if not one_pass:
        launches.count("attn_block_bwd_f32")
    return dx
