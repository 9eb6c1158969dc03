"""The bare cosine-attention core: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_attention.py:cosine_attention_fused.
The CUDA kernel is `csrc/cosine_attention.cu`; its header says what bounds
it on the H100 and what the design does about it. `cosine_attention`
launches it for CUDA tensors and takes the plain version for CPU tensors;
`cosine_attention_grad` adds the TPU kernel's backward, autograd through
the plain version recomputed (the JAX custom VJP recomputes
`_xla_reference`; no backward kernel exists), as ops/attn_qrows.py does.

`cosine_attention_plain` is `_xla_reference` (pallas_attention.py:60-77):
q and k l2-normalised in fp32 (x / max(||x||, 1e-12)), times q_scale *
scale and k_scale, kept fp32; fp32 scores plus the bias [h, n, m] (slice
bh takes head bh % h), an fp32 softmax, p rounded to v's dtype, PV with
fp32 sums, the output in q's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from . import launches

DIM_HEAD = 32   # the head width the CUDA core takes


def cosine_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_scale: torch.Tensor, k_scale: torch.Tensor,
                           bias: Optional[torch.Tensor], heads: int,
                           scale: float = 8.0) -> torch.Tensor:
    """q [BH, n, dh]; k / v [BH, m, dh]; q_scale / k_scale [dh]; bias [heads,
    n, m] or None. Returns [BH, n, dh] in q's dtype."""
    qf, kf = q.float(), k.float()
    qn = qf / torch.linalg.vector_norm(qf, dim=-1, keepdim=True).clamp_min(1e-12)
    kn = kf / torch.linalg.vector_norm(kf, dim=-1, keepdim=True).clamp_min(1e-12)
    qn = qn * (q_scale.float() * scale)
    kn = kn * k_scale.float()
    s = qn @ kn.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float().repeat(q.shape[0] // heads, 1, 1)
    p = torch.softmax(s, dim=-1)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def cosine_attention_max_m() -> int:
    """The most keys the CUDA kernel takes (its staged key hi / lo and value
    planes fill a block's shared memory)."""
    return _build.load().ctc_cosine_attention_max_m()


def cosine_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_scale: torch.Tensor, k_scale: torch.Tensor,
                     bias: Optional[torch.Tensor], heads: int,
                     scale: float = 8.0) -> torch.Tensor:
    """The cosine_attention kernel on CUDA tensors (bf16 q, k, v with heads
    of 32 and at most cosine_attention_max_m() keys; fp32 scales and bias
    [heads, n, m] or None), the plain version on CPU tensors."""
    if not _build.on_cuda(q):
        return cosine_attention_plain(q, k, v, q_scale, k_scale, bias, heads, scale)
    bh, n, dh = q.shape
    m = k.shape[1]
    if dh != DIM_HEAD or bh % heads:
        raise ValueError(f"cosine_attention takes heads of {DIM_HEAD} and a slice count that "
                         f"{heads} heads divide; got q {tuple(q.shape)}")
    lib = _build.load()
    if m > lib.ctc_cosine_attention_max_m():
        raise ValueError(f"{m} keys over the kernel's {lib.ctc_cosine_attention_max_m()}")
    dev = q.device
    for t, name, dtype, shape in ((q, "q", torch.bfloat16, (bh, n, dh)),
                                  (k, "k", torch.bfloat16, (bh, m, dh)),
                                  (v, "v", torch.bfloat16, (bh, m, dh)),
                                  (q_scale, "q_scale", torch.float32, (dh,)),
                                  (k_scale, "k_scale", torch.float32, (dh,))):
        _build.require(t, name, dtype, shape, dev)
    if bias is not None:
        _build.require(bias, "bias", torch.float32, (heads, n, m), dev)
    q, k, v = (_build.aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    # the bf16 hi / lo planes of the scaled unit rows of q, then of k
    work = torch.empty((2 * bh * (n + m) * dh,), dtype=torch.bfloat16, device=dev)
    err = lib.ctc_cosine_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), work.data_ptr(), out.data_ptr(), bh, n, m,
        heads, float(scale), _build.stream_of(q))
    _build.check(err, "cosine_attention")
    launches.count("cosine_attention")
    return out


class _CosineFn(torch.autograd.Function):
    """cosine_attention forward; backward by autograd through the plain
    version recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, q_scale, k_scale, bias, heads, scale):
        ctx.save_for_backward(q, k, v, q_scale, k_scale, bias)
        ctx.heads, ctx.scale = heads, scale
        return cosine_attention(q, k, v, q_scale, k_scale, bias, heads, scale)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = cosine_attention_plain(*inputs, ctx.heads, ctx.scale)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t is not None and t.requires_grad else None for t in inputs),
                None, None)


def cosine_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_scale: torch.Tensor, k_scale: torch.Tensor,
                          bias: Optional[torch.Tensor], heads: int,
                          scale: float = 8.0) -> torch.Tensor:
    """cosine_attention's value, differentiable (the recompute backward)."""
    return _CosineFn.apply(q, k, v, q_scale, k_scale, bias, heads, scale)
