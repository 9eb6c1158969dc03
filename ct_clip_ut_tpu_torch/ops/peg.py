"""PEG stencil (depthwise 3x3x3 conv + bias + residual) and its weight
gradient: kernel wrappers and plain versions.

Replaces ct_clip_ut_tpu/ops/pallas_peg.py:peg_fused (`csrc/peg.cu`) and
ct_clip_ut_tpu/ops/pallas_peg_bwd.py:peg_weight_grads (`csrc/peg_wgrad.cu`);
each source's header says what bounds it on the H100 and what the design
does about it. `TransformerConfig.peg_pallas` selects this route
(ops/layers.py:PEG); the default route stays F.conv3d + autograd.

The video x is [b, t, h, w, c] as the token buffer lies in memory (channels
last); taps are [27, c] fp32 in (dt, dh, dw) order (`taps_of` takes them
from the Conv3d weight [c, 1, 3, 3, 3]); the frame padding is given as
`front` zero frames before the first (2 - front after the last): 2 is the
causal forward, 1 the centred one, 0 the causal form's input gradient.
Spatial padding is (1, 1) on both axes.

`peg_plain` follows the kernel, not the conv route: 27 fp32 products from x
cast to fp32, + bias + the centre input, rounded to x's dtype once (the conv
route rounds the conv to x's dtype before the bias,
ct_clip_ut_tpu/ops/layers.py:251-259).

`peg_grad` is the stencil with its backward, `_peg_conv_residual.bwd`
(ct_clip_ut_tpu/ops/layers.py:315-343): dx is the same stencil applied to
the cotangent (rounded to x's dtype) with the taps flipped and the frame
padding mirrored, no bias, the residual supplying the `+ g`; (dw, db) come
from `peg_weight_grads`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from . import launches


def taps_of(weight: torch.Tensor) -> torch.Tensor:
    """Conv3d depthwise weight [c, 1, 3, 3, 3] -> taps [27, c] fp32 in
    (dt, dh, dw) order."""
    c = weight.shape[0]
    return weight.float().reshape(c, 27).t().contiguous()


def front_pad(causal: bool) -> int:
    return 2 if causal else 1


def _shifted(x32: torch.Tensor, front: int):
    """The 27 shifted views of the zero-padded video, in tap order."""
    t, h, w = x32.shape[1:4]
    xp = F.pad(x32, (0, 0, 1, 1, 1, 1, front, 2 - front))
    for dt in range(3):
        for dh in range(3):
            for dw in range(3):
                yield xp[:, dt:dt + t, dh:dh + h, dw:dw + w]


def peg_plain(x: torch.Tensor, taps: torch.Tensor, bias: Optional[torch.Tensor],
              front: int = 2) -> torch.Tensor:
    """x [b, t, h, w, c]; taps [27, c] fp32; bias [c] or None. Returns
    conv(x) + bias + x in x's dtype."""
    x32 = x.float()
    conv = torch.zeros_like(x32)
    for tap, sl in zip(taps.float(), _shifted(x32, front)):
        conv = conv + sl * tap
    if bias is not None:
        conv = conv + bias.float()
    return (conv + x32).to(x.dtype)


def _check_video(x, name):
    if x.dim() != 5:
        raise ValueError(f"{name}: expected a [b, t, h, w, c] video, got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {x.dtype}, the PEG kernels take bf16 or fp32")
    if x.shape[-1] % 8:
        raise ValueError(f"{name}: the PEG kernels read 8 channels at a time; {x.shape[-1]} "
                         "channels are not a multiple of 8")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def peg(x: torch.Tensor, taps: torch.Tensor, bias: Optional[torch.Tensor],
        front: int = 2) -> torch.Tensor:
    """The peg kernel on CUDA tensors (bf16 or fp32 x, contiguous, channels
    a multiple of 8), the plain version on CPU tensors."""
    if front not in (0, 1, 2):
        raise ValueError(f"front padding is 0, 1 or 2 frames, got {front}")
    if not _build.on_cuda(x):
        return peg_plain(x, taps, bias, front)
    _check_video(x, "x")
    b, t, h, w, c = x.shape
    _build.require(taps, "taps", torch.float32, (27, c), x.device)
    if bias is not None:
        _build.require(bias, "bias", torch.float32, (c,), x.device)
    x = _build.aligned16(x)
    out = torch.empty_like(x)
    err = _build.load().ctc_peg(x.data_ptr(), taps.data_ptr(),
                                None if bias is None else bias.data_ptr(), out.data_ptr(),
                                b, t, h, w, c, front, int(x.dtype == torch.float32),
                                _build.stream_of(x))
    _build.check(err, "peg")
    launches.count("peg")
    return out


def peg_weight_grads_plain(x: torch.Tensor, g: torch.Tensor, front: int = 2) -> tuple:
    """(dw [c, 1, 3, 3, 3], db [c]) in fp32: dw[tap] = sum over positions of
    the shifted x times g, db = sum of g, products and sums in fp32 (the
    taps formulation, ct_clip_ut_tpu/ops/layers.py:262-291)."""
    g32 = g.float()
    c = x.shape[-1]
    dw = torch.stack([(sl * g32).sum((0, 1, 2, 3)) for sl in _shifted(x.float(), front)])
    return dw.t().reshape(c, 1, 3, 3, 3), g32.sum((0, 1, 2, 3))


WGRAD_BLOCKS = 264      # position chunks of the weight-grad reduction: two waves of 132 SMs


def peg_weight_grads(x: torch.Tensor, g: torch.Tensor, front: int = 2) -> tuple:
    """The peg_weight_grads kernel on CUDA tensors (x and g of one dtype,
    bf16 or fp32), the plain version on CPU tensors. Returns (dw, db) in
    the Conv3d layout [c, 1, 3, 3, 3] and [c], fp32. The sums run in a fixed
    order: the same bits from run to run."""
    if front not in (0, 1, 2):
        raise ValueError(f"front padding is 0, 1 or 2 frames, got {front}")
    if not _build.on_cuda(x):
        return peg_weight_grads_plain(x, g, front)
    _check_video(x, "x")
    _build.require(g, "g", x.dtype, x.shape, x.device)
    b, t, h, w, c = x.shape
    x, g = _build.aligned16(x), _build.aligned16(g)
    npos = b * t * h * w
    chunks = min(WGRAD_BLOCKS, npos)
    chunk = (npos + chunks - 1) // chunks
    partial = torch.empty((chunks, 28, c), dtype=torch.float32, device=x.device)
    dwb = torch.empty((28, c), dtype=torch.float32, device=x.device)
    err = _build.load().ctc_peg_wgrad(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                                      dwb.data_ptr(), b, t, h, w, c, front, chunks, chunk,
                                      int(x.dtype == torch.float32), _build.stream_of(x))
    _build.check(err, "peg_weight_grads")
    launches.count("peg_weight_grads")
    return dwb[:27].t().reshape(c, 1, 3, 3, 3), dwb[27]


class _PegFn(torch.autograd.Function):
    """The stencil with its backward, on CUDA tensors the kernels and on CPU
    tensors their plain versions."""

    @staticmethod
    def forward(ctx, x, weight, bias, front):
        ctx.save_for_backward(x, weight)
        ctx.front = front
        return peg(x, taps_of(weight), bias.float(), front)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        gv = g.to(x.dtype).contiguous()
        dx = peg(gv, taps_of(weight).flip(0).contiguous(), None, 2 - ctx.front)
        dw, db = peg_weight_grads(x, gv, ctx.front)
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None


def peg_grad(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             causal: bool = True) -> torch.Tensor:
    """peg(x) + x on the video x [b, t, h, w, c] with the Conv3d parameters
    (weight [c, 1, 3, 3, 3], bias [c]), carrying its backward."""
    return _PegFn.apply(x, weight, bias, front_pad(causal))
