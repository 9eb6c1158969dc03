"""GEGLU feed-forward block: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_ff.py:geglu_ff_fused. The CUDA chain is
`csrc/geglu_ff.cu`; its header says what bounds it on the H100 and what the
design does about it. `geglu_ff` launches it for CUDA tensors (bf16, or the
fp32 variant `geglu_ff_f32` for fp32 tensors: three bf16 products of hi /
lo planes for each fp32 product, both products on the persistent
split4_kernel of `csrc/split_sm90.cuh`, each K slice's four planes staged
once) and takes the plain version for CPU tensors; `geglu_ff_plain` is the same function in
plain PyTorch, with the TPU kernel's rounding points: LN (one-pass moments)
rounded to the compute dtype, value and gate in fp32, h rounded before the
second projection, the residual added in fp32.

The backward (pallas_ff._backward_impl) is `geglu_ff_bwd`: the CUDA chain
`csrc/geglu_ff_bwd.cu` for CUDA tensors, `geglu_ff_bwd_plain` for CPU
tensors; the plain backward keeps the TPU kernel's rounding points (xn, h,
dvalue and dgate rounded to the compute dtype before their products) with
the exact-erf GELU and its closed-form derivative. At fp32 the chain is
`csrc/geglu_ff_bwd_f32.cu` (every product three bf16 products of hi / lo
planes) in two forms: `geglu_ff_bwd` on fp32 CUDA tensors returns every
gradient (the fp32 train step's; dW2 | dWv | dWg in one wgrad_sm90.cuh
launch over the split planes, dgamma and dbeta summed in a fixed order),
`geglu_ff_bwd_f32` dx alone. `_GegluFFFn` takes the second when no
parameter needs its gradient (the gradient attribution methods' case), the
first otherwise.
"""

from __future__ import annotations

import torch

from .. import _build
from . import launches
from .fp32_grads import fp32_data_grad_only, ln_parts


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


def tma_operands(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> dict:
    """The operands the geglu_ff kernel reads through TMA, name -> (tensor,
    rows, cols, row stride in elements): xn [N, D] and hbuf [N, ldh], fresh
    workspaces (ldh = inner rounded up to 16 B); w_in's value and gate rows
    as two [inner, D] matrices; w_out [D, inner] as it is where its rows are
    16-B strided, else a zero-padded copy made on this call."""
    n, d = x.shape
    inner = w_out.shape[1]
    w2, ldw = _build.tma_rows(w_out)
    ldh = _build.tma_pitch(inner)
    b16 = dict(dtype=torch.bfloat16, device=x.device)
    return {"xn": (torch.empty((n, d), **b16), n, d, d),
            "w_value": (w_in[:inner], inner, d, d),
            "w_gate": (w_in[inner:], inner, d, d),
            "hbuf": (torch.empty((n, ldh), **b16), n, inner, ldh),
            "w_out": (w2, d, inner, ldw)}


def geglu_ff(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             w_in: torch.Tensor, w_out: torch.Tensor,
             residual: bool = False) -> torch.Tensor:
    """The geglu_ff kernel on CUDA tensors (bf16 x and weights, fp32
    gamma/beta, a width that 8 divides; fp32 x and weights take the fp32
    variant, `geglu_ff_f32`), the plain version on CPU tensors."""
    if not _build.on_cuda(x):
        return geglu_ff_plain(x, gamma, beta, w_in, w_out, residual)
    if x.dtype == torch.float32:
        return geglu_ff_f32(x, gamma, beta, w_in, w_out, residual)
    n, d = x.shape
    inner = w_out.shape[1]
    dev = x.device
    for t, name, dtype, shape in ((x, "x", torch.bfloat16, (n, d)),
                                  (gamma, "gamma", torch.float32, (d,)),
                                  (beta, "beta", torch.float32, (d,)),
                                  (w_in, "w_in", torch.bfloat16, (2 * inner, d)),
                                  (w_out, "w_out", torch.bfloat16, (d, inner))):
        _build.require(t, name, dtype, shape, dev)
    if d % 8:
        raise ValueError(f"the geglu_ff kernel takes a width that 8 divides (16-B TMA rows), "
                         f"got {d}")
    x, w_in = _build.aligned16(x), _build.aligned16(w_in)
    ops = tma_operands(x, w_in, w_out)
    out = torch.empty_like(x)
    err = _build.load().ctc_geglu_ff(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w_in.data_ptr(),
        ops["w_out"][0].data_ptr(), ops["xn"][0].data_ptr(), ops["hbuf"][0].data_ptr(),
        out.data_ptr(), n, d, inner, ops["hbuf"][3], ops["w_out"][3], int(residual),
        _build.stream_of(x))
    _build.check(err, "geglu_ff")
    launches.count("geglu_ff")
    return out


def _bf16_plane_rows(w_out: torch.Tensor, align: int = _build.TMA_ALIGN) -> tuple:
    """(fp32 w_out [D, ld], ld): its rows zero-padded to the `align`-B pitch
    of its bf16 planes (the fp32 chains' h / dvalue | dgate columns and W2's
    rows), a copy made on this call where inner is not already that pitch.
    The forward takes 128 B, a whole 128-B swizzle row of a K slice: each
    slice's TMA boxes then start on whole 128-B lines."""
    d, inner = w_out.shape
    ld = -(-inner * 2 // align) * align // 2
    if ld == inner:
        return w_out, ld
    w2 = w_out.new_zeros((d, ld))
    w2[:, :inner] = w_out
    return w2, ld


def geglu_ff_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 w_in: torch.Tensor, w_out: torch.Tensor, residual: bool = False, *,
                 one_pass: bool = False) -> torch.Tensor:
    """The fp32 variant of the geglu_ff kernel (`ctc_geglu_ff_f32`: every
    product as three bf16 products of hi / lo planes) on CUDA tensors: fp32
    x, gamma, beta and weights, a width that 8 divides. one_pass=True zeroes
    every lo plane (one bf16 product each: the control that shows the fp32
    band needs the split); it does not count as a launch of the path."""
    n, d = x.shape
    inner = w_out.shape[1]
    dev = x.device
    f32 = torch.float32
    for t, name, shape in ((x, "x", (n, d)), (gamma, "gamma", (d,)), (beta, "beta", (d,)),
                           (w_in, "w_in", (2 * inner, d)), (w_out, "w_out", (d, inner))):
        _build.require(t, name, f32, shape, dev)
    if d % 8:
        raise ValueError(f"the geglu_ff kernels take a width that 8 divides, got {d}")
    w2, ld = _bf16_plane_rows(w_out, 128)
    x, gamma, beta, w_in, w2 = (_build.aligned16(t) for t in (x, gamma, beta, w_in, w2))
    b16 = dict(dtype=torch.bfloat16, device=dev)
    work = (torch.empty((2, n, d), **b16), torch.empty((2, 2 * inner, d), **b16),
            torch.empty((2, d, ld), **b16), torch.empty((2, n, ld), **b16))
    out = torch.empty_like(x)
    err = _build.load().ctc_geglu_ff_f32(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w_in.data_ptr(), w2.data_ptr(),
        *(w.data_ptr() for w in work), out.data_ptr(), n, d, inner, ld, ld, int(residual),
        int(one_pass), _build.stream_of(x))
    _build.check(err, "geglu_ff_f32")
    if not one_pass:
        launches.count("geglu_ff_f32")
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
                 residual: bool = False, *, one_pass: bool = False) -> tuple:
    """The geglu_ff backward kernel chain on CUDA tensors (the forward's
    types; g like x: bf16, or fp32 for the fp32 chain with every parameter
    gradient, where one_pass=True zeroes every lo plane, the control, and
    does not count as a launch of the path), the plain backward on CPU
    tensors."""
    if not _build.on_cuda(x):
        return geglu_ff_bwd_plain(x, gamma, beta, w_in, w_out, g, residual)
    if x.dtype == torch.float32:
        grads = _launch_bwd_f32(x, gamma, beta, w_in, w_out, g, residual, one_pass, params=True)
        if not one_pass:
            launches.count("geglu_ff_bwd_f32_full")
        return grads
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
            torch.empty((n, ldh), **b16), torch.empty((n, 2 * ldh), **b16),
            torch.empty((n, d), **f32))
    dx = torch.empty((n, d), **b16)
    dgamma, dbeta = torch.zeros((d,), **f32), torch.zeros((d,), **f32)
    dw_in, dw_out = torch.empty((2 * inner, d), **f32), torch.empty((d, inner), **f32)
    x, g, w_in = _build.aligned16(x), _build.aligned16(g), _build.aligned16(w_in)
    err = _build.load().ctc_geglu_ff_bwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w_in.data_ptr(), w2t.data_ptr(),
        wvgt.data_ptr(), g.data_ptr(), *(w.data_ptr() for w in work), dx.data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(), dw_in.data_ptr(), dw_out.data_ptr(), n, d, inner,
        ldh, int(residual), _build.stream_of(x))
    _build.check(err, "geglu_ff_bwd")
    launches.count("geglu_ff_bwd")
    return dx, dgamma, dbeta, dw_in, dw_out


def _launch_bwd_f32(x, gamma, beta, w_in, w_out, g, residual: bool, one_pass: bool,
                    params: bool):
    """Run `ctc_geglu_ff_bwd_f32` on CUDA tensors: dx alone, or with
    params=True (dx, dgamma, dbeta, dw_in, dw_out), all fp32. The one place
    that knows its workspaces."""
    n, d = x.shape
    inner = w_out.shape[1]
    dev = x.device
    for t, name, shape in ((x, "x", (n, d)), (gamma, "gamma", (d,)), (beta, "beta", (d,)),
                           (w_in, "w_in", (2 * inner, d)), (w_out, "w_out", (d, inner)),
                           (g, "g", (n, d))):
        _build.require(t, name, torch.float32, shape, dev)
    if d % 8:
        raise ValueError(f"the geglu_ff kernels take a width that 8 divides, got {d}")
    w2, ld = _bf16_plane_rows(w_out)
    x, gamma, beta, w_in, w2, g = (_build.aligned16(t) for t in (x, gamma, beta, w_in, w2, g))
    b16 = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    # the weights' planes (w_in's zero-padded to [2 ld, D]: value rows, then
    # the gate rows at row ld), xn's and g's planes, [dvalue | dgate]'s
    # planes, dxn
    work = (torch.zeros((2, 2 * ld, d), **b16), torch.empty((2, d, ld), **b16),
            torch.empty((2, n, d), **b16), torch.empty((2, n, d), **b16),
            torch.empty((2, n, 2 * ld), **b16), torch.empty((n, d), **f32))
    dx = torch.empty_like(x)
    # the train form: h's planes and the LN gains' partial sums (workspaces);
    # dgamma | dbeta, dw_in, dw_out (written whole)
    train = [None] * 5
    if params:
        train = [torch.empty((2, n, ld), **b16), torch.empty((ln_parts(n), 2 * d), **f32),
                 torch.empty((2, d), **f32), torch.empty((2 * inner, d), **f32),
                 torch.empty((d, inner), **f32)]
    err = _build.load().ctc_geglu_ff_bwd_f32(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w_in.data_ptr(), w2.data_ptr(),
        g.data_ptr(), *(w.data_ptr() for w in work), dx.data_ptr(),
        *(None if t is None else t.data_ptr() for t in train), n, d, inner, ld, ld,
        int(residual), int(one_pass), _build.stream_of(x))
    _build.check(err, "geglu_ff_bwd_f32")
    if not params:
        return dx
    dgb, dw_in, dw_out = train[2:]
    return dx, dgb[0], dgb[1], dw_in, dw_out


def geglu_ff_bwd_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     w_in: torch.Tensor, w_out: torch.Tensor, g: torch.Tensor,
                     residual: bool = False, *, one_pass: bool = False) -> torch.Tensor:
    """dx of geglu_ff_plain at fp32 against cotangent g [N, D]: the fp32
    data-gradient chain `ctc_geglu_ff_bwd_f32` on CUDA tensors (fp32 x, g,
    gains and weights, a width that 8 divides; one_pass=True zeroes every
    lo plane, the control, and does not count as a launch of the path), the
    plain backward's dx on CPU tensors."""
    if not _build.on_cuda(x):
        return geglu_ff_bwd_plain(x, gamma, beta, w_in, w_out, g, residual)[0]
    dx = _launch_bwd_f32(x, gamma, beta, w_in, w_out, g, residual, one_pass, params=False)
    if not one_pass:
        launches.count("geglu_ff_bwd_f32")
    return dx


class _GegluFFFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w_in, w_out, residual):
        ctx.save_for_backward(x, gamma, beta, w_in, w_out)
        ctx.residual = residual
        return geglu_ff(x, gamma, beta, w_in, w_out, residual=residual)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, w_in, w_out = ctx.saved_tensors
        if fp32_data_grad_only(ctx, x):
            return (geglu_ff_bwd_f32(x, gamma, beta, w_in, w_out, g.contiguous(), ctx.residual),
                    None, None, None, None, None)
        dx, dgamma, dbeta, dw_in, dw_out = geglu_ff_bwd(x, gamma, beta, w_in, w_out,
                                                        g.contiguous(), ctx.residual)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), dw_in.to(w_in.dtype),
                dw_out.to(w_out.dtype), None)


def geglu_ff_grad(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w_in: torch.Tensor, w_out: torch.Tensor, residual: bool = False) -> torch.Tensor:
    """geglu_ff with its backward (the custom VJP of pallas_ff.geglu_ff_fused):
    the kernels on CUDA tensors, the plain versions on CPU tensors."""
    return _GegluFFFn.apply(x, gamma, beta, w_in, w_out, residual)
