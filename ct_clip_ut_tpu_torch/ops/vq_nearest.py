"""Cosine-codebook nearest neighbour: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_vq.py:vq_nearest_pallas. The CUDA kernel
is `csrc/vq_nearest.cu` (the Hopper GEMM core with an argmax epilogue; for
fp32 operands its variant with the sims as three bf16 products of hi / lo
planes); its header says what bounds it on the H100 and what the design
does about it.
Both return int32 argmax_j <tok_i, cb_j> with fp32 accumulation, the first
maximum winning a tie, and follow torch.argmax on NaN: a NaN sim ranks
above every number, so a diverged row gets its first NaN's index. Operands whose rows TMA cannot read as they are go
as 16-B strided copies (`_build.tma_rows`).
"""

from __future__ import annotations

import torch

from .. import _build
from . import launches


def vq_nearest_plain(tokens: torch.Tensor, codebook: torch.Tensor,
                     chunk: int = 4096) -> torch.Tensor:
    """tokens [M, D], codebook [C, D] -> int32 [M]. The [chunk, C] fp32
    similarity block bounds the transient; torch.argmax returns the first
    maximal index."""
    cb = codebook.float()
    out = [torch.argmax(t.float() @ cb.t(), dim=-1) for t in tokens.split(chunk)]
    if not out:
        return torch.empty((0,), dtype=torch.int32, device=tokens.device)
    return torch.cat(out).to(torch.int32)


def vq_nearest(tokens: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The vq_nearest kernel on CUDA tensors (bf16 [M, D] tokens and [C, D]
    codebook; fp32 ones take the fp32 variant, `vq_nearest_f32`), the plain
    version on CPU tensors."""
    if not _build.on_cuda(tokens):
        return vq_nearest_plain(tokens, codebook)
    if tokens.dtype == torch.float32:
        return vq_nearest_f32(tokens, codebook)
    m, d = tokens.shape
    c = codebook.shape[0]
    if c == 0:
        raise ValueError("vq_nearest needs a codebook of at least one code")
    _build.require(tokens, "tokens", torch.bfloat16, (m, d), tokens.device)
    _build.require(codebook, "codebook", torch.bfloat16, (c, d), tokens.device)
    tok, ldt = _build.tma_rows(tokens)
    cb, ldc = _build.tma_rows(codebook)
    best = torch.empty((m,), dtype=torch.int64, device=tokens.device)   # the argmax keys
    idx = torch.empty((m,), dtype=torch.int32, device=tokens.device)
    err = _build.load().ctc_vq_nearest(tok.data_ptr(), cb.data_ptr(), best.data_ptr(),
                                       idx.data_ptr(), m, c, d, ldt, ldc,
                                       _build.stream_of(tokens))
    _build.check(err, "vq_nearest")
    launches.count("vq_nearest")
    return idx


def vq_nearest_f32(tokens: torch.Tensor, codebook: torch.Tensor, *,
                   one_pass: bool = False) -> torch.Tensor:
    """The fp32 variant of the vq_nearest kernel (`ctc_vq_nearest_f32`: the
    sims as three bf16 products of hi / lo planes, the same argmax
    epilogue) on CUDA tensors: fp32 [M, D] tokens and [C, D] codebook, D a
    multiple of 8. one_pass=True zeroes the lo planes (one bf16 product, the
    control); it does not count as a launch of the path."""
    m, d = tokens.shape
    c = codebook.shape[0]
    dev = tokens.device
    if c == 0:
        raise ValueError("vq_nearest needs a codebook of at least one code")
    _build.require(tokens, "tokens", torch.float32, (m, d), dev)
    _build.require(codebook, "codebook", torch.float32, (c, d), dev)
    if d % 8:
        raise ValueError(f"the fp32 vq_nearest kernel takes a width that 8 divides, got {d}")
    tok, cb = _build.aligned16(tokens), _build.aligned16(codebook)
    b16 = dict(dtype=torch.bfloat16, device=dev)
    tok_s, cb_s = torch.empty((2, m, d), **b16), torch.empty((2, c, d), **b16)
    best = torch.empty((m,), dtype=torch.int64, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    err = _build.load().ctc_vq_nearest_f32(tok.data_ptr(), cb.data_ptr(), tok_s.data_ptr(),
                                           cb_s.data_ptr(), best.data_ptr(), idx.data_ptr(), m,
                                           c, d, int(one_pass), _build.stream_of(tokens))
    _build.check(err, "vq_nearest_f32")
    if not one_pass:
        launches.count("vq_nearest_f32")
    return idx
