"""Cosine-attention block with a position bias: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_attn_block.py:attention_block_fused (the
CT-ViT spatial stack). The CUDA chain is `csrc/attn_block.cu`; its header
says what bounds it on the H100 and what the design does about it.
`attn_block` launches it for CUDA tensors and takes the plain version for
CPU tensors.

`attn_block_plain` is the block in plain PyTorch with the TPU kernel's
rounding points (pallas_attn_block.py:51-101): LN without bias (one-pass
moments) rounded to the compute dtype; q, k, v projected in fp32 (q from the
LN output, k and v from the PRE-norm x); q and k l2-normalised per head and
scaled in fp32; fp32 scores + bias and softmax; p and v rounded to the
compute dtype before PV; the per-head output rounded before the output
projection; the residual added in fp32.

The backward (pallas_attn_block._backward_impl, the custom VJP's kernel)
is `attn_block_bwd`: the CUDA chain `csrc/attn_block_bwd.cu` for CUDA
tensors, `attn_block_bwd_plain` for CPU tensors. The plain backward is the
TPU kernel's `_bwd_kernel` in plain PyTorch with its rounding points (dO,
P, dS, the per-head output and dq / dk / dv rounded to the compute dtype
before their products; softmax, l2-norm backward and sums in fp32).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from . import launches

DIM_HEAD = 32   # the head width the CUDA attention cores take


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


def check_block_args(x, gamma, wq, wk, wv, wo, qs, ks, max_n: int) -> tuple:
    """Validate the block kernels' arguments; returns (R, n, D, heads)."""
    r, n, d = x.shape
    hd = wq.shape[0]
    heads = hd // DIM_HEAD
    if qs.shape != (DIM_HEAD,) or hd % 128 != 0:
        raise ValueError(f"the attention kernels take heads of {DIM_HEAD} and "
                         f"heads*{DIM_HEAD} a multiple of 128; got dh={tuple(qs.shape)}, "
                         f"h*dh={hd}")
    if n > max_n:
        raise ValueError(f"sequence length {n} over the kernel's {max_n}")
    dev = x.device
    for t, name, dtype, shape in ((x, "x", torch.bfloat16, (r, n, d)),
                                  (gamma, "gamma", torch.float32, (d,)),
                                  (wq, "wq", torch.bfloat16, (hd, d)),
                                  (wk, "wk", torch.bfloat16, (hd, d)),
                                  (wv, "wv", torch.bfloat16, (hd, d)),
                                  (wo, "wo", torch.bfloat16, (d, hd)),
                                  (qs, "q_scale", torch.float32, (DIM_HEAD,)),
                                  (ks, "k_scale", torch.float32, (DIM_HEAD,))):
        _build.require(t, name, dtype, shape, dev)
    return r, n, d, heads


def workspaces(m: int, hd: int, dev) -> tuple:
    """q, k (fp32) and v, o (bf16) [m, hd] buffers of the attention chains."""
    f32 = dict(dtype=torch.float32, device=dev)
    b16 = dict(dtype=torch.bfloat16, device=dev)
    return (torch.empty((m, hd), **f32), torch.empty((m, hd), **f32),
            torch.empty((m, hd), **b16), torch.empty((m, hd), **b16))


def attn_block(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
               wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
               qs: torch.Tensor, ks: torch.Tensor, bias: torch.Tensor,
               scale: float = 8.0, residual: bool = False) -> torch.Tensor:
    """The attn_block kernel on CUDA tensors (bf16 x and weights; fp32
    gamma, scales and bias [h, n, n]), the plain version on CPU tensors."""
    if not _build.on_cuda(x):
        return attn_block_plain(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual)
    lib = _build.load()
    r, n, d, heads = check_block_args(x, gamma, wq, wk, wv, wo, qs, ks,
                                      lib.ctc_attn_block_max_n())
    _build.require(bias, "bias", torch.float32, (heads, n, n), x.device)
    ws = workspaces(r * n, heads * DIM_HEAD, x.device)
    out = torch.empty_like(x)
    err = lib.ctc_attn_block(
        x.data_ptr(), gamma.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        wo.data_ptr(), qs.data_ptr(), ks.data_ptr(), bias.data_ptr(),
        *(w.data_ptr() for w in ws), out.data_ptr(), r, n, d, heads, float(scale),
        int(residual), _build.stream_of(x))
    _build.check(err, "attn_block")
    launches.count("attn_block")
    return out


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
    gradients of attn_block_bwd_plain, in fp32 but dx."""
    lib = _build.load()
    r, n, d, heads = check_block_args(x, gamma, wq, wk, wv, wo, qs, ks, lib.ctc_attn_bwd_max_n())
    dev = x.device
    hd = heads * DIM_HEAD
    m = r * n
    _build.require(g, "g", torch.bfloat16, (r, n, d), dev)
    x, g = _build.aligned16(x), _build.aligned16(g)
    wqt = wq.t().contiguous()
    wkvt = torch.cat([wk, wv]).t().contiguous()
    wot = wo.t().contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    b16 = dict(dtype=torch.bfloat16, device=dev)
    work = (torch.empty((m, d), **b16), torch.empty((m, 2), **f32),
            torch.empty((m, hd), **f32), torch.empty((m, hd), **f32),
            torch.empty((m, hd), **b16), torch.empty((m, hd), **b16),
            torch.empty((m, hd), **b16), torch.empty((m, hd), **b16),
            torch.empty((m, 2 * hd), **b16), torch.empty((m * heads, 4), **f32),
            torch.empty((m, d), **f32), torch.empty((m, d), **f32))
    dx = torch.empty_like(x)
    dgamma, dwq = torch.zeros((d,), **f32), torch.zeros((hd, d), **f32)
    dwkv, dwo = torch.zeros((2 * hd, d), **f32), torch.zeros((d, hd), **f32)
    dqs, dks = torch.zeros((DIM_HEAD,), **f32), torch.zeros((DIM_HEAD,), **f32)
    ins = [x, gamma, wq, wk, wv, wqt, wkvt, wot, qs, ks]
    outs = [dx, dgamma, dwq, dwkv, dwo, dqs, dks]
    dbias = None
    if bias is not None:
        _build.require(bias, "bias", torch.float32, (heads, n, n), dev)
        dbias = torch.zeros((heads, n, n), **f32)
        ins.append(bias)
        outs.append(dbias)
    err = getattr(lib, entry)(*(t.data_ptr() for t in ins), g.data_ptr(),
                              *(w.data_ptr() for w in work), *(t.data_ptr() for t in outs),
                              r, n, d, heads, float(scale), int(residual), _build.stream_of(x))
    _build.check(err, entry)
    return dx, dgamma, dwq, dwkv[:hd], dwkv[hd:], dwo, dqs, dks, dbias


def attn_block_bwd(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
                   wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
                   qs: torch.Tensor, ks: torch.Tensor, bias: torch.Tensor,
                   g: torch.Tensor, scale: float = 8.0, residual: bool = False) -> tuple:
    """The attn_block backward kernel chain on CUDA tensors (the forward's
    types; g bf16 like x), the plain backward on CPU tensors."""
    if not _build.on_cuda(x):
        return attn_block_bwd_plain(x, gamma, wq, wk, wv, wo, qs, ks, bias, g, scale, residual)
    grads = launch_attn_bwd("ctc_attn_block_bwd", x, gamma, wq, wk, wv, wo, qs, ks, bias, g,
                            scale, residual)
    launches.count("attn_block_bwd")
    return grads
