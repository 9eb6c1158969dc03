"""GEGLU feed-forward block: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_ff.py:geglu_ff_fused. The CUDA chain is
`csrc/geglu_ff.cu`; its header says what bounds it on the H100 and what the
design does about it. `geglu_ff` launches it for CUDA tensors and takes the
plain version for CPU tensors; `geglu_ff_plain` is the same function in
plain PyTorch, with the TPU kernel's rounding points: LN (one-pass moments)
rounded to the compute dtype, value and gate in fp32, h rounded before the
second projection, the residual added in fp32.

The backward (pallas_ff._backward_impl) is `geglu_ff_bwd`: the CUDA chain
`csrc/geglu_ff_bwd.cu` for CUDA tensors, `geglu_ff_bwd_plain` for CPU
tensors; the plain backward keeps the TPU kernel's rounding points (xn, h,
dvalue and dgate rounded to the compute dtype before their products) with
the exact-erf GELU and its closed-form derivative.
"""

from __future__ import annotations

import torch

from .. import _build
from . import launches


def geglu_ff_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   w_in: torch.Tensor, w_out: torch.Tensor,
                   residual: bool = False) -> torch.Tensor:
    """x [N, D]; gamma/beta [D]; w_in [2*inner, D] (value rows, then gate
    rows); w_out [D, inner]. Returns [N, D] in x's dtype."""
    dt = x.dtype
    inner = w_out.shape[1]
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    xn = ((x32 - mean) * torch.rsqrt(var + 1e-5) * gamma.float() + beta.float()).to(dt).float()
    w = w_in.to(dt).float()
    value = xn @ w[:inner].t()
    gate = xn @ w[inner:].t()
    h = (0.5 * gate * (1.0 + torch.erf(gate * 0.7071067811865476)) * value).to(dt)
    out = h.float() @ w_out.to(dt).float().t()
    if residual:
        out = out + x32
    return out.to(dt)


def geglu_ff(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             w_in: torch.Tensor, w_out: torch.Tensor,
             residual: bool = False) -> torch.Tensor:
    """The geglu_ff kernel on CUDA tensors (bf16 x and weights, fp32
    gamma/beta), the plain version on CPU tensors."""
    if not _build.on_cuda(x):
        return geglu_ff_plain(x, gamma, beta, w_in, w_out, residual)
    n, d = x.shape
    inner = w_out.shape[1]
    dev = x.device
    for t, name, dtype, shape in ((x, "x", torch.bfloat16, (n, d)),
                                  (gamma, "gamma", torch.float32, (d,)),
                                  (beta, "beta", torch.float32, (d,)),
                                  (w_in, "w_in", torch.bfloat16, (2 * inner, d)),
                                  (w_out, "w_out", torch.bfloat16, (d, inner))):
        _build.require(t, name, dtype, shape, dev)
    ldh = (inner + 7) // 8 * 8            # 16-B aligned rows for the second GEMM
    hbuf = torch.empty((n, ldh), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    err = _build.load().ctc_geglu_ff(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w_in.data_ptr(),
        w_out.data_ptr(), hbuf.data_ptr(), out.data_ptr(), n, d, inner, ldh,
        int(residual), _build.stream_of(x))
    _build.check(err, "geglu_ff")
    launches.count("geglu_ff")
    return out


def _gelu_parts(gate: torch.Tensor) -> tuple:
    """(gelu(gate), gelu'(gate)) of the exact-erf GELU: x Phi(x) and
    Phi(x) + x phi(x)."""
    cdf = 0.5 * (1.0 + torch.erf(gate * 0.7071067811865476))
    return gate * cdf, cdf + gate * 0.3989422804014327 * torch.exp(-0.5 * gate * gate)


def geglu_ff_bwd_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       w_in: torch.Tensor, w_out: torch.Tensor, g: torch.Tensor,
                       residual: bool = False, *, faults: tuple = ()) -> tuple:
    """Gradients of geglu_ff_plain's output against cotangent g [N, D]:
    (dx in x's dtype; dgamma, dbeta, dw_in [2*inner, D], dw_out [D, inner]
    in fp32). `faults` builds a faulty kernel's gradients, the card checks'
    controls: "gelu_prime" takes GELU for its derivative, "gamma" drops the
    LN gain from dx."""
    dt = x.dtype
    inner = w_out.shape[1]
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + 1e-5)
    xhat = (x32 - mean) * rstd
    xn = (xhat * gamma.float() + beta.float()).to(dt).float()
    w = w_in.to(dt).float()
    wv, wg = w[:inner], w[inner:]
    value, gate = xn @ wv.t(), xn @ wg.t()
    gel, gprime = _gelu_parts(gate)
    if "gelu_prime" in faults:
        gprime = gel
    h = (gel * value).to(dt).float()
    gb = g.to(dt).float()
    dw_out = gb.t() @ h
    dh = gb @ w_out.to(dt).float()
    dvalue = (dh * gel).to(dt).float()
    dgate = (dh * value * gprime).to(dt).float()
    dw_in = torch.cat([dvalue.t() @ xn, dgate.t() @ xn])
    dxn = dvalue @ wv + dgate @ wg
    dgamma, dbeta = (dxn * xhat).sum(0), dxn.sum(0)
    dxhat = dxn if "gamma" in faults else dxn * gamma.float()
    dx = (dxhat - dxhat.mean(-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * rstd
    if residual:
        dx = dx + g.float()
    return dx.to(dt), dgamma, dbeta, dw_in, dw_out


def geglu_ff_bwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 w_in: torch.Tensor, w_out: torch.Tensor, g: torch.Tensor,
                 residual: bool = False) -> tuple:
    """The geglu_ff backward kernel chain on CUDA tensors (the forward's
    types; g bf16 like x), the plain backward on CPU tensors."""
    if not _build.on_cuda(x):
        return geglu_ff_bwd_plain(x, gamma, beta, w_in, w_out, g, residual)
    n, d = x.shape
    inner = w_out.shape[1]
    dev = x.device
    for t, name, dtype, shape in ((x, "x", torch.bfloat16, (n, d)),
                                  (gamma, "gamma", torch.float32, (d,)),
                                  (beta, "beta", torch.float32, (d,)),
                                  (w_in, "w_in", torch.bfloat16, (2 * inner, d)),
                                  (w_out, "w_out", torch.bfloat16, (d, inner)),
                                  (g, "g", torch.bfloat16, (n, d))):
        _build.require(t, name, dtype, shape, dev)
    if d % 8:
        raise ValueError(f"the geglu_ff backward takes a width that 8 divides, got {d}")
    ldh = (inner + 7) // 8 * 8            # 16-B aligned rows of the [N, inner] intermediates
    w2t = w_out.t().contiguous()
    wvgt = torch.zeros((d, 2 * ldh), dtype=torch.bfloat16, device=dev)
    wvgt[:, :inner] = w_in[:inner].t()
    wvgt[:, ldh:ldh + inner] = w_in[inner:].t()
    f32 = dict(dtype=torch.float32, device=dev)
    b16 = dict(dtype=torch.bfloat16, device=dev)
    work = (torch.empty((n, d), **b16), torch.empty((n, 2), **f32),
            torch.empty((n, ldh), **f32), torch.empty((n, ldh), **b16),
            torch.empty((n, 2 * ldh), **b16), torch.empty((n, d), **f32))
    x, g = _build.aligned16(x), _build.aligned16(g)
    dx = torch.empty_like(x)
    dgamma, dbeta = torch.zeros((d,), **f32), torch.zeros((d,), **f32)
    dw_vg, dw_out = torch.zeros((2 * ldh, d), **f32), torch.zeros((d, inner), **f32)
    err = _build.load().ctc_geglu_ff_bwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w_in.data_ptr(), w2t.data_ptr(),
        wvgt.data_ptr(), g.data_ptr(), *(w.data_ptr() for w in work), dx.data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(), dw_vg.data_ptr(), dw_out.data_ptr(), n, d, inner,
        ldh, int(residual), _build.stream_of(x))
    _build.check(err, "geglu_ff_bwd")
    launches.count("geglu_ff_bwd")
    return dx, dgamma, dbeta, torch.cat([dw_vg[:inner], dw_vg[ldh:ldh + inner]]), dw_out


class _GegluFFFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w_in, w_out, residual):
        ctx.save_for_backward(x, gamma, beta, w_in, w_out)
        ctx.residual = residual
        return geglu_ff(x, gamma, beta, w_in, w_out, residual=residual)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, w_in, w_out = ctx.saved_tensors
        dx, dgamma, dbeta, dw_in, dw_out = geglu_ff_bwd(x, gamma, beta, w_in, w_out,
                                                        g.contiguous(), ctx.residual)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), dw_in.to(w_in.dtype),
                dw_out.to(w_out.dtype), None)


def geglu_ff_grad(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w_in: torch.Tensor, w_out: torch.Tensor, residual: bool = False) -> torch.Tensor:
    """geglu_ff with its backward (the custom VJP of pallas_ff.geglu_ff_fused):
    the kernels on CUDA tensors, the plain versions on CPU tensors."""
    return _GegluFFFn.apply(x, gamma, beta, w_in, w_out, residual)
