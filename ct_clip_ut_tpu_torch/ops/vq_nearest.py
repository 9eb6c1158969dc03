"""Cosine-codebook nearest neighbour: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_vq.py:vq_nearest_pallas. The CUDA kernel
is `csrc/vq_nearest.cu`; its header says what bounds it on the H100 and
what the design does about it. Both return int32 argmax_j <tok_i, cb_j>
with fp32 accumulation, the first maximum winning a tie.
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
    codebook), the plain version on CPU tensors."""
    if not _build.on_cuda(tokens):
        return vq_nearest_plain(tokens, codebook)
    m, d = tokens.shape
    c = codebook.shape[0]
    _build.require(tokens, "tokens", torch.bfloat16, (m, d), tokens.device)
    _build.require(codebook, "codebook", torch.bfloat16, (c, d), tokens.device)
    idx = torch.empty((m,), dtype=torch.int32, device=tokens.device)
    err = _build.load().ctc_vq_nearest(tokens.data_ptr(), codebook.data_ptr(),
                                       idx.data_ptr(), m, c, d, _build.stream_of(tokens))
    _build.check(err, "vq_nearest")
    launches.count("vq_nearest")
    return idx
