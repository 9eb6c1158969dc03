"""Query-row-stripe cosine attention (MaskGit): kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_attn_qrows.py:attention_qrows_fused
(`_forward_impl`, both of its pallas_call sites). The CUDA chain is
`csrc/attn_qrows.cu` (LN pass, the q / k / v projections and the output
projection on the Hopper GEMM core, a two-pass wgmma attention core whose
blocks take 256 query rows at B = 1 and 128 otherwise); its header says
what bounds it on the H100 and what the design does about it. `attn_qrows` launches it for CUDA tensors
(bf16; fp32 tensors take its fp32 variant, the per-item grid's function
with every product three bf16 products of hi / lo planes) and takes the
plain version for CPU tensors; `attn_qrows_grad` adds the TPU
kernel's backward, autograd through the plain version recomputed (the JAX
custom VJP recomputes `_xla_reference_block`; no backward kernel exists).

`attn_qrows_plain` follows the rounding points of the TPU kernel's kv
variant (the bf16 serving route, pallas_attn_qrows.py:110-159, 264-278):
LN without bias (one-pass moments, eps 1e-5) rounded to the compute dtype;
q projected in fp32 from it, l2-normalised, times q_scale * scale, rounded;
k projected from the PRE-norm x and rounded, l2-normalised in fp32, times
k_scale, rounded; v projected and rounded; the bias rounded to the compute
dtype; fp32 scores plus bias and a full-row fp32 softmax; p rounded before
PV; the per-head output rounded before the output projection; the residual
added in fp32. In fp32 every rounding is the identity and the per-item
variant (:40-107) computes the same function. The stripes of `q_block` rows
only bound the plain version's score memory.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from . import launches

DIM_HEAD = 64   # the head width the CUDA core takes


def attn_qrows_plain(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
                     wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
                     qs: torch.Tensor, ks: torch.Tensor, bias: Optional[torch.Tensor],
                     scale: float = 8.0, residual: bool = False, *, q_block: int = 64,
                     faults: tuple = ()) -> torch.Tensor:
    """x [B, N, D]; gamma [D]; wq/wk/wv [h*dh, D]; wo [D, h*dh]; qs/ks [dh];
    bias [h, N, N] or None. Returns [B, N, D] in x's dtype.

    `faults` builds what a faulty kernel would give, the controls of the
    card's checks: "k_from_ln" takes k from the LN'd x, "unnormalised"
    leaves p = exp(s - max) without its division by the row sum."""
    dt = x.dtype
    b, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    xn = ((x32 - mean) * torch.rsqrt(var + 1e-5) * gamma.float()).to(dt).float()

    def heads_of(t):   # [b, n, h*dh] -> [b, h, n, dh]
        return t.reshape(b, n, heads, dh).transpose(1, 2)

    def unit(t):
        return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-12)

    def rounded(t):
        return t.to(dt).float()

    q = rounded(unit(heads_of(xn @ wq.to(dt).float().t())) * (qs.float() * scale))
    k_in = xn if "k_from_ln" in faults else x32
    k = rounded(unit(heads_of(rounded(k_in @ wk.to(dt).float().t()))) * ks.float())
    v = heads_of(rounded(x32 @ wv.to(dt).float().t()))
    o = torch.empty((b, heads, n, dh), dtype=torch.float32, device=x.device)
    kt = k.transpose(-1, -2)
    for r0 in range(0, n, q_block):
        s = q[:, :, r0:r0 + q_block] @ kt                       # [b, h, rows, n]
        if bias is not None:
            s = s + rounded(bias[:, r0:r0 + q_block])
        if "unnormalised" in faults:
            p = torch.exp(s - s.amax(-1, keepdim=True))
        else:
            p = torch.softmax(s, dim=-1)
        o[:, :, r0:r0 + q_block] = rounded(p) @ v
    o = rounded(o).transpose(1, 2).reshape(b, n, heads * dh)
    out = o @ wo.to(dt).float().t()
    if residual:
        out = out + x32
    return out.to(dt)


def attn_qrows(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
               wv: torch.Tensor, wo: torch.Tensor, qs: torch.Tensor, ks: torch.Tensor,
               bias: Optional[torch.Tensor], scale: float = 8.0,
               residual: bool = False) -> torch.Tensor:
    """The attn_qrows kernel on CUDA tensors (bf16 x, weights and bias
    [h, N, N] or None; fp32 gamma and scales; heads of 64, h*64 a multiple
    of 128; fp32 x, weights and bias take the fp32 variant), the plain
    version on CPU tensors. A bias whose rows are not 16-B strided (N not a
    multiple of 8 in bf16, of 4 in fp32) goes as a zero-padded copy made on
    every call (about 0.67 GB for a bf16 table of MaskGit's size; MaskGit's
    N = 6464 needs none)."""
    if not _build.on_cuda(x):
        return attn_qrows_plain(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual)
    if x.dtype == torch.float32:
        out = launch_chain_f32(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual)
        launches.count("attn_qrows_f32")
        return out
    out, _ = launch_chain(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual)
    launches.count("attn_qrows")
    return out


def _check_chain(x, gamma, wq, wk, wv, wo, qs, ks, bias, dtype) -> tuple:
    """Raise unless the chain in `dtype` (bf16, or fp32 for the fp32
    variant) takes these operands; returns (B, N, D, heads, the operands
    16-B aligned, the bias as TMA reads it [h*N, ldb] or None, ldb)."""
    b, n, d = x.shape
    hd = wq.shape[0]
    heads = hd // DIM_HEAD
    if qs.shape != (DIM_HEAD,) or hd % 128 != 0 or d % 8 != 0:
        raise ValueError(f"attn_qrows takes heads of {DIM_HEAD}, heads*{DIM_HEAD} a multiple of "
                         f"128 and a width that 8 divides; got dh={tuple(qs.shape)}, h*dh={hd}, "
                         f"D={d}")
    dev = x.device
    for t, name, dt, shape in ((x, "x", dtype, (b, n, d)),
                               (gamma, "gamma", torch.float32, (d,)),
                               (wq, "wq", dtype, (hd, d)),
                               (wk, "wk", dtype, (hd, d)),
                               (wv, "wv", dtype, (hd, d)),
                               (wo, "wo", dtype, (d, hd)),
                               (qs, "q_scale", torch.float32, (DIM_HEAD,)),
                               (ks, "k_scale", torch.float32, (DIM_HEAD,))):
        _build.require(t, name, dt, shape, dev)
    if bias is not None:
        _build.require(bias, "bias", dtype, (heads, n, n), dev)
    ops = tuple(_build.aligned16(t) for t in (x, gamma, wq, wk, wv, wo))
    ldb = 0
    if bias is not None:   # TMA reads [h*N, N]; rows not 16-B strided go as a padded copy
        bias, ldb = _build.tma_rows(bias.view(heads * n, n))
    return b, n, d, heads, ops, bias, ldb


def launch_chain_f32(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual,
                     one_pass: bool = False) -> torch.Tensor:
    """Checks the fp32 operands and launches the fp32 chain once (no
    count): the one place that knows its workspaces, bf16 hi / lo planes:
    xn's and x's [4, B*N, D]; the weights' (wq | wk | wv stacked [2, 3 h*64,
    D], wo [2, D, h*64]); q, k and o [2, B*N, h*64]; v transposed per head
    [2, B*h*64, pitch]. one_pass zeroes every lo plane (the control)."""
    b, n, d, heads, (x, gamma, wq, wk, wv, wo), bias, ldb = _check_chain(
        x, gamma, wq, wk, wv, wo, qs, ks, bias, torch.float32)
    m, hd = b * n, heads * DIM_HEAD
    b16 = dict(dtype=torch.bfloat16, device=x.device)
    ws = (torch.empty((4, m, d), **b16), torch.empty((2, 3 * hd, d), **b16),
          torch.empty((2, d, hd), **b16), torch.empty((2, m, hd), **b16),
          torch.empty((2, m, hd), **b16), torch.empty((2, b * hd, _build.tma_pitch(n)), **b16),
          torch.empty((2, m, hd), **b16))
    out = torch.empty_like(x)
    err = _build.load().ctc_attn_qrows_f32(
        x.data_ptr(), gamma.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        wo.data_ptr(), qs.data_ptr(), ks.data_ptr(), None if bias is None else bias.data_ptr(),
        *(w.data_ptr() for w in ws), out.data_ptr(), b, n, d, heads, ldb, float(scale),
        int(residual), int(one_pass), _build.stream_of(x))
    _build.check(err, "attn_qrows_f32")
    return out


def launch_chain(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual):
    """Checks the operands and launches the CUDA chain once (no count).
    Returns the output and the chain's workspaces, bf16: xn = LN(x) gamma
    [B*N, D]; q and k [B*N, h*64]; v transposed per head [B*h*64, pitch]
    (each head's 64 rows hold v's columns along the sequence, rows padded
    to 16 B); o [B*N, h*64], the attention before the output projection."""
    b, n, d, heads, (x, gamma, wq, wk, wv, wo), bias, ldb = _check_chain(
        x, gamma, wq, wk, wv, wo, qs, ks, bias, torch.bfloat16)
    hd = heads * DIM_HEAD
    dev = x.device
    b16 = dict(dtype=torch.bfloat16, device=dev)
    ws = {"xn": torch.empty((b * n, d), **b16), "q": torch.empty((b * n, hd), **b16),
          "k": torch.empty((b * n, hd), **b16),
          "vt": torch.empty((b * hd, _build.tma_pitch(n)), **b16),
          "o": torch.empty((b * n, hd), **b16)}
    out = torch.empty_like(x)
    err = _build.load().ctc_attn_qrows(
        x.data_ptr(), gamma.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        wo.data_ptr(), qs.data_ptr(), ks.data_ptr(), None if bias is None else bias.data_ptr(),
        *(w.data_ptr() for w in ws.values()), out.data_ptr(), b, n, d, heads, ldb,
        float(scale), int(residual), _build.stream_of(x))
    _build.check(err, "attn_qrows")
    return out, ws


class _QrowsFn(torch.autograd.Function):
    """attn_qrows forward; backward by autograd through the plain version
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual):
        ctx.save_for_backward(x, gamma, wq, wk, wv, wo, qs, ks, bias)
        ctx.scale, ctx.residual = scale, residual
        return attn_qrows(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = attn_qrows_plain(*inputs, ctx.scale, ctx.residual)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t is not None and t.requires_grad else None for t in inputs),
                None, None)


def attn_qrows_grad(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                    wv: torch.Tensor, wo: torch.Tensor, qs: torch.Tensor, ks: torch.Tensor,
                    bias: Optional[torch.Tensor], scale: float = 8.0,
                    residual: bool = False) -> torch.Tensor:
    """attn_qrows's value, differentiable (the recompute backward)."""
    return _QrowsFn.apply(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual)
