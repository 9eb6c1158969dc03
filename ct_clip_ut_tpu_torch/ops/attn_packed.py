"""Cosine-attention block for short sequences: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_attn_packed.py:attention_block_packed
(the CT-ViT temporal stack, n = 24). The CUDA chain is
`csrc/attn_packed.cu`, the spatial block's chain without the bias (LN
pass, q / k / v on the Hopper GEMM core, the split-bf16 core, the output
projection; `attn_block.launch_block` allocates its workspaces, and
`launch_block_f32` those of its fp32 variant, whose products stage each K
slice's four planes once and whose core at n <= 64 takes whole (sequence,
head) items, `csrc/attn_fwd_packed.cuh`); its
header says what bounds it on the H100 and what the design does about it.
The TPU kernel's (token, head) packing is a Mosaic artefact, so the plain
version is the block itself with no bias: the same math and rounding
points as `attn_block_plain`. Any number of sequences works (the TPU's
even-batch rule does not exist here); the sequence length is bounded by
what the core stages (`ctc_attn_packed_max_n`).

The backward (pallas_attn_packed._backward_impl) is `attn_packed_bwd`: the
CUDA chain `csrc/attn_packed_bwd.cu` for bf16 CUDA tensors and
`csrc/attn_packed_bwd_f32.cu` (the spatial block's fp32 chain without the
bias) with every parameter gradient for fp32 ones, the plain backward
(`attn_block_bwd_plain` without a bias) for CPU tensors;
`attn_packed_bwd_f32` is the fp32 chain's dx alone (the gradient
attribution methods'). At n <= 64 the fp32 chain's attention is one fused
pass over whole rows (`csrc/attn_bwd_packed.cuh`: D = rowsum(P dP), no
forward core rerun, nothing kept from the forward); above, the fp32 core
and the spatial block's wgmma passes without a bias.
"""

from __future__ import annotations

import torch

from .. import _build
from . import launches
from .attn_block import (attn_block_bwd_plain, attn_block_plain, launch_attn_bwd,
                         launch_attn_bwd_f32, launch_block, launch_block_f32)


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
    """The attn_packed kernel on CUDA tensors (bf16; fp32 tensors take its
    fp32 variant), the plain version on CPU tensors."""
    if not _build.on_cuda(x):
        return attn_packed_plain(x, gamma, wq, wk, wv, wo, qs, ks, scale, residual)
    if x.dtype == torch.float32:
        out = launch_block_f32("ctc_attn_packed_f32", x, gamma, wq, wk, wv, wo, qs, ks, None,
                               scale, residual)
        launches.count("attn_packed_f32")
        return out
    out = launch_block("ctc_attn_packed", x, gamma, wq, wk, wv, wo, qs, ks, None, scale,
                       residual)
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
                    scale: float = 8.0, residual: bool = False, *,
                    one_pass: bool = False) -> tuple:
    """The attn_packed backward kernel chain on CUDA tensors (bf16, or fp32
    with one_pass as `attn_block_bwd`'s), the plain backward on CPU
    tensors."""
    if not _build.on_cuda(x):
        return attn_packed_bwd_plain(x, gamma, wq, wk, wv, wo, qs, ks, g, scale, residual)
    if x.dtype == torch.float32:
        grads = launch_attn_bwd_f32("ctc_attn_packed_bwd_f32", x, gamma, wq, wk, wv, wo, qs, ks,
                                    None, g, scale, residual, one_pass, params=True)[:8]
        if not one_pass:
            launches.count("attn_packed_bwd_f32_full")
        return grads
    grads = launch_attn_bwd("ctc_attn_packed_bwd", x, gamma, wq, wk, wv, wo, qs, ks, None, g,
                            scale, residual)[:8]
    launches.count("attn_packed_bwd")
    return grads


def attn_packed_bwd_f32(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
                        wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
                        qs: torch.Tensor, ks: torch.Tensor, g: torch.Tensor,
                        scale: float = 8.0, residual: bool = False, *,
                        one_pass: bool = False) -> torch.Tensor:
    """dx of attn_packed_plain at fp32: the fp32 data-gradient chain on
    CUDA tensors (one_pass as `attn_block_bwd_f32`'s), the plain
    backward's dx on CPU tensors."""
    if not _build.on_cuda(x):
        return attn_packed_bwd_plain(x, gamma, wq, wk, wv, wo, qs, ks, g, scale, residual)[0]
    dx = launch_attn_bwd_f32("ctc_attn_packed_bwd_f32", x, gamma, wq, wk, wv, wo, qs, ks, None,
                             g, scale, residual, one_pass)
    if not one_pass:
        launches.count("attn_packed_bwd_f32")
    return dx
