"""Cosine-attention block for short sequences: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_attn_packed.py:attention_block_packed
(the CT-ViT temporal stack, n = 24). The CUDA chain is
`csrc/attn_packed.cu`; its header says what bounds it on the H100 and what
the design does about it. The TPU kernel's (token, head) packing is a
Mosaic artefact, so the plain version is the block itself with no bias:
the same math and rounding points as `attn_block_plain`. Any number of
sequences works (the TPU's even-batch rule does not exist here).

The backward (pallas_attn_packed._backward_impl) is `attn_packed_bwd`: the
CUDA chain `csrc/attn_packed_bwd.cu` for CUDA tensors, the plain backward
(`attn_block_bwd_plain` without a bias) for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from . import launches
from .attn_block import (DIM_HEAD, attn_block_bwd_plain, attn_block_plain, check_block_args,
                         launch_attn_bwd, workspaces)


def attn_packed_plain(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
                      wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
                      qs: torch.Tensor, ks: torch.Tensor, scale: float = 8.0,
                      residual: bool = False) -> torch.Tensor:
    """x [R, n, D]; weights as `attn_block_plain`; no bias."""
    return attn_block_plain(x, gamma, wq, wk, wv, wo, qs, ks, None, scale, residual)


def attn_packed(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
                wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
                qs: torch.Tensor, ks: torch.Tensor, scale: float = 8.0,
                residual: bool = False) -> torch.Tensor:
    """The attn_packed kernel on CUDA tensors, the plain version on CPU tensors."""
    if not _build.on_cuda(x):
        return attn_packed_plain(x, gamma, wq, wk, wv, wo, qs, ks, scale, residual)
    lib = _build.load()
    r, n, d, heads = check_block_args(x, gamma, wq, wk, wv, wo, qs, ks,
                                      lib.ctc_attn_packed_max_n())
    ws = workspaces(r * n, heads * DIM_HEAD, x.device)
    out = torch.empty_like(x)
    err = lib.ctc_attn_packed(
        x.data_ptr(), gamma.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        wo.data_ptr(), qs.data_ptr(), ks.data_ptr(), *(w.data_ptr() for w in ws),
        out.data_ptr(), r, n, d, heads, float(scale), int(residual), _build.stream_of(x))
    _build.check(err, "attn_packed")
    launches.count("attn_packed")
    return out


def attn_packed_bwd_plain(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
                          wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
                          qs: torch.Tensor, ks: torch.Tensor, g: torch.Tensor,
                          scale: float = 8.0, residual: bool = False, *,
                          faults: tuple = ()) -> tuple:
    """(dx, dgamma, dwq, dwk, dwv, dwo, dqs, dks) of attn_packed_plain
    (`faults` as attn_block_bwd_plain's)."""
    return attn_block_bwd_plain(x, gamma, wq, wk, wv, wo, qs, ks, None, g, scale, residual,
                                faults=faults)[:8]


def attn_packed_bwd(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
                    wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
                    qs: torch.Tensor, ks: torch.Tensor, g: torch.Tensor,
                    scale: float = 8.0, residual: bool = False) -> tuple:
    """The attn_packed backward kernel chain on CUDA tensors, the plain
    backward on CPU tensors."""
    if not _build.on_cuda(x):
        return attn_packed_bwd_plain(x, gamma, wq, wk, wv, wo, qs, ks, g, scale, residual)
    grads = launch_attn_bwd("ctc_attn_packed_bwd", x, gamma, wq, wk, wv, wo, qs, ks, None, g,
                            scale, residual)[:8]
    launches.count("attn_packed_bwd")
    return grads
