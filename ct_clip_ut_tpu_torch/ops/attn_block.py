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
