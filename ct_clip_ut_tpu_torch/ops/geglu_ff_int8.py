"""W8A8 GEGLU feed-forward block: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_ff_int8.py:geglu_ff_int8. The CUDA chain
is `csrc/geglu_ff_int8.cu`, four launches with both products on the int8
wgmma path of the Hopper core: LN and xn's codes; the value | gate product
writing h in fp32, 64 columns of each a tile; h's row scales and codes;
the W2 product with the residual. Its header says what bounds it on the
H100 and what the design does about it. `geglu_ff_int8` launches it for
CUDA tensors and takes the plain version for CPU tensors. x is bf16 (the
zero-shot serving path) or fp32 (the fp32 attribution forward on a
quantised model): the fp32 form (`ctc_geglu_ff_int8_f32`, counted as
geglu_ff_int8_f32) reads fp32 rows and adds and stores the residual in
fp32; the codes and both products are the bf16 form's.

`geglu_ff_int8_plain` follows `xla_int8_reference` (pallas_ff_int8.py:
100-119) step by step: LN in fp32 with beta (one-pass moments, eps 1e-5,
xn NOT rounded to the compute dtype); xn quantised per row (absmax / 127,
clamped at 1e-8, rounded half to even); value and gate as exact int8 x
int8 -> int32 products, dequantised as row scale x int32 x column scale;
exact-erf GELU x value in fp32 (torch.erf: the A&S polynomial of the JAX
package exists because Mosaic lacks erf); h quantised per row over its
full width; the second product and its dequant; + x in fp32 with
`residual`; cast to x's dtype.

Weights are int8 codes in the nn.Linear layout: wv_q / wg_q [inner, D] and
w2_q [D, inner] with fp32 per-output-row scales sv / sg [inner] and s2 [D]
(`ops/quant.quantize_weight_int8`). `Int8FeedForward` pads inner to
INNER_MULTIPLE with zero codes once when it is built: zero rows give
exact zeros in value and gate, so h is 0 there and its row absmax is
unchanged.

Serving only, as in the JAX package (its custom VJP raises): rounding has a
zero gradient, so `geglu_ff_int8` refuses an input that requires grad
while autograd records.
"""

from __future__ import annotations

import torch

from .. import _build
from . import launches

INNER_MULTIPLE = 16   # TMA's 16-B rows: the padded inner width's multiple
MAX_DIM, MAX_INNER = 2048, 4096   # the widths the chain's row passes hold in registers
_EPS = 1e-8


def row_quant(x32: torch.Tensor, per_tensor: bool = False) -> tuple:
    """fp32 [N, K] -> (int8 codes [N, K], fp32 per-row scale [N, 1]):
    s = max(absmax / 127, 1e-8), codes round(x / s) half to even.
    per_tensor=True takes one scale for the whole tensor (a card check's
    control)."""
    amax = x32.abs().amax() if per_tensor else x32.abs().amax(-1, keepdim=True)
    s = (amax / 127.0).clamp_min(_EPS).expand(x32.shape[0], 1)
    return torch.round(x32 / s).to(torch.int8), s


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, K] @ b [M, K]^T of int8 codes, exact, as int32. On the CPU in
    int32; on the card through fp64 (torch has no int32 product there; the
    sums stay below 2^53, so they are exact)."""
    if a.is_cuda:
        return (a.double() @ b.double().t()).int()
    return a.int() @ b.int().t()


def geglu_ff_int8_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        wv_q: torch.Tensor, wg_q: torch.Tensor, w2_q: torch.Tensor,
                        sv: torch.Tensor, sg: torch.Tensor, s2: torch.Tensor,
                        residual: bool = False, *, faults: tuple = ()) -> torch.Tensor:
    """x [N, D]; gamma / beta [D]; wv_q / wg_q [inner, D] and w2_q [D, inner]
    int8; sv / sg [inner], s2 [D]. Returns [N, D] in x's dtype.

    `faults` builds what a faulty kernel would give, the controls of the
    card's checks: "h_float" feeds h to the second product unquantised,
    "per_tensor" quantises xn and h with one scale each."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mean * mean
    xn = (x32 - mean) * torch.rsqrt(var.clamp_min(0.0) + 1e-5)
    xn = xn * gamma.float() + beta.float()
    per_tensor = "per_tensor" in faults
    xi, rx = row_quant(xn, per_tensor)
    value = int8_dot(xi, wv_q).float() * rx * sv.float()
    gate = int8_dot(xi, wg_q).float() * rx * sg.float()
    h = 0.5 * gate * (1.0 + torch.erf(gate * 0.7071067811865476)) * value
    if "h_float" in faults:
        out = (h.double() @ w2_q.double().t()).float() * s2.float()
    else:
        hi, rh = row_quant(h, per_tensor)
        out = int8_dot(hi, w2_q).float() * rh * s2.float()
    if residual:
        out = out + x32
    return out.to(x.dtype)


def serving_only(x: torch.Tensor) -> None:
    """Raise for an input autograd would differentiate through the int8
    route (the JAX custom VJP's backward raises, pallas_ff_int8.py:121-140)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "geglu_ff_int8 is a serving-only quantized kernel: rounding has a zero gradient, "
            "so its gradient would be silently wrong. Differentiate the bf16 model instead.")


def geglu_ff_int8(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  wv_q: torch.Tensor, wg_q: torch.Tensor, w2_q: torch.Tensor,
                  sv: torch.Tensor, sg: torch.Tensor, s2: torch.Tensor,
                  residual: bool = False) -> torch.Tensor:
    """The geglu_ff_int8 kernel on CUDA tensors (bf16 or fp32 x, the output
    in x's dtype; fp32 gamma, beta and scales; int8 weights with an inner
    width and D that 16 divides), the plain version on CPU tensors. Serving
    only: an input that requires grad while autograd records raises."""
    serving_only(x)
    if not _build.on_cuda(x):
        return geglu_ff_int8_plain(x, gamma, beta, wv_q, wg_q, w2_q, sv, sg, s2, residual)
    out = launch_chain(x, gamma, beta, wv_q, wg_q, w2_q, sv, sg, s2, residual)[0]
    launches.count("geglu_ff_int8_f32" if x.dtype == torch.float32 else "geglu_ff_int8")
    return out


def launch_chain(x, gamma, beta, wv_q, wg_q, w2_q, sv, sg, s2, residual: bool = False) -> tuple:
    """The C entry of x's dtype on CUDA tensors, uncounted: (out, xq, rx,
    hq, rh), the output and the chain's workspaces holding xn's and h's
    int8 codes and row scales. The one place that knows those workspaces
    (the card's checks read the codes through it)."""
    n, d = x.shape
    inner = wv_q.shape[0]
    if d % 16 or inner % INNER_MULTIPLE or d > MAX_DIM or inner > MAX_INNER:
        raise ValueError(f"geglu_ff_int8 takes D <= {MAX_DIM} and an inner width <= {MAX_INNER},"
                         f" both multiples of 16; got D={d}, inner={inner} (Int8FeedForward pads"
                         " inner when it is built)")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"geglu_ff_int8 takes bf16 or fp32 x on the card; got {x.dtype}")
    dev = x.device
    for t, name, dtype, shape in ((x, "x", x.dtype, (n, d)),
                                  (gamma, "gamma", torch.float32, (d,)),
                                  (beta, "beta", torch.float32, (d,)),
                                  (wv_q, "wv_q", torch.int8, (inner, d)),
                                  (wg_q, "wg_q", torch.int8, (inner, d)),
                                  (w2_q, "w2_q", torch.int8, (d, inner)),
                                  (sv, "sv", torch.float32, (inner,)),
                                  (sg, "sg", torch.float32, (inner,)),
                                  (s2, "s2", torch.float32, (d,))):
        _build.require(t, name, dtype, shape, dev)
    x, gamma, beta, wv_q, wg_q, w2_q, sv, sg, s2 = (
        _build.aligned16(t) for t in (x, gamma, beta, wv_q, wg_q, w2_q, sv, sg, s2))
    f32 = dict(dtype=torch.float32, device=dev)
    xq, rx = torch.empty((n, d), dtype=torch.int8, device=dev), torch.empty((n,), **f32)
    hbuf = torch.empty((n, inner), **f32)
    hq, rh = torch.empty((n, inner), dtype=torch.int8, device=dev), torch.empty((n,), **f32)
    out = torch.empty_like(x)
    f32_x = x.dtype == torch.float32
    lib = _build.load()
    err = (lib.ctc_geglu_ff_int8_f32 if f32_x else lib.ctc_geglu_ff_int8)(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wv_q.data_ptr(), wg_q.data_ptr(),
        w2_q.data_ptr(), sv.data_ptr(), sg.data_ptr(), s2.data_ptr(), xq.data_ptr(),
        rx.data_ptr(), hbuf.data_ptr(), hq.data_ptr(), rh.data_ptr(), out.data_ptr(), n, d,
        inner, int(residual), _build.stream_of(x))
    _build.check(err, "geglu_ff_int8_f32" if f32_x else "geglu_ff_int8")
    return out, xq, rx, hq, rh
