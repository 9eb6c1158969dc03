"""GEGLU feed-forward block: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_ff.py:geglu_ff_fused. The CUDA chain is
`csrc/geglu_ff.cu`; its header says what bounds it on the H100 and what the
design does about it. `geglu_ff` launches it for CUDA tensors and takes the
plain version for CPU tensors; `geglu_ff_plain` is the same function in
plain PyTorch, with the TPU kernel's rounding points: LN (one-pass moments)
rounded to the compute dtype, value and gate in fp32, h rounded before the
second projection, the residual added in fp32.
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
