"""Query-row-block cosine attention for long sequences (MaskGit).

Counterpart of ct_clip_ut_tpu/ops/attention_blockwise.py:
blockwise_cosine_attention_qrows. Self-attention with a FULL-row softmax
per stripe of `q_block` query rows, so the [b, heads, n, n] scores never
exist at once. With a dense [heads, n, n] bias, or none, the block is the
attn_qrows kernel on CUDA tensors and its plain version on CPU tensors
(the JAX route at attention_blockwise.py:166-188; the bias rides in the
compute dtype, as in the TPU kernel's kv variant); with `bias_row_fn` (the
table past its memory cap) it is the stripe loop of the JAX package's XLA
scan, each stripe's bias built by the callback. plain=True asks for the
kernel's plain version on any device.

The kv-block variant (`blockwise_cosine_attention`, used only by the
sequence-parallel encoder) is not ported yet (ROADMAP Queue 1 item 11f).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .attention import Attention
from .attn_qrows import attn_qrows_grad, attn_qrows_plain
from .layers import l2norm, layernorm, linear


def blockwise_cosine_attention_qrows(attn: Attention, x: torch.Tensor, *, q_block: int,
                                     attn_bias: Optional[torch.Tensor] = None,
                                     bias_row_fn: Optional[Callable[[int], torch.Tensor]] = None,
                                     deterministic: bool = True, residual: bool = False,
                                     plain: bool = False) -> torch.Tensor:
    """x [b, n, dim] -> [b, n, dim]. `bias_row_fn(row0)` gives the [heads,
    q_block, n] bias stripe of the queries [row0, row0 + q_block); n need
    not divide by q_block (the last stripe is padded; its padded rows are
    dropped)."""
    cfg = attn.cfg
    assert not cfg.causal and cfg.num_null_kv == 0, \
        "qrows path covers the MaskGit self-attention shape"
    assert cfg.dropout == 0.0 or deterministic, \
        "qrows path does not implement dropout (training mode)"
    assert attn_bias is None or bias_row_fn is None, \
        "pass either a dense bias or a bias_row_fn, not both"
    dt = x.dtype
    if bias_row_fn is None:
        wkv = attn.to_kv.weight.to(dt)
        args = (x.contiguous(), attn.norm.gamma.float(), attn.to_q.weight.to(dt),
                wkv[:cfg.inner_dim], wkv[cfg.inner_dim:], attn.to_out.weight.to(dt),
                attn.q_scale.float(), attn.k_scale.float(),
                None if attn_bias is None else attn_bias.to(dt).contiguous(), cfg.scale, residual)
        if plain:
            return attn_qrows_plain(*args, q_block=q_block)
        return attn_qrows_grad(*args)

    b, n, _ = x.shape
    h, dh = cfg.heads, cfg.dim_head
    xn = layernorm(x, attn.norm.gamma)
    q = linear(xn, attn.to_q.weight)
    k, v = linear(x, attn.to_kv.weight).chunk(2, dim=-1)   # k/v from the PRE-norm x

    def split_heads(t):
        return t.reshape(b, n, h, dh).transpose(1, 2)

    q = l2norm(split_heads(q)) * attn.q_scale.to(dt)
    k = l2norm(split_heads(k)) * attn.k_scale.to(dt)
    v = split_heads(v).float()
    pad = (-n) % q_block
    q = F.pad(q, (0, 0, 0, pad))
    kt = k.float().transpose(-1, -2)
    stripes = []
    for r0 in range(0, n + pad, q_block):
        s = (q[:, :, r0:r0 + q_block].float() @ kt) * cfg.scale
        s = s + bias_row_fn(r0).float()[None]
        stripes.append((torch.softmax(s, dim=-1) @ v).to(dt))
    o = torch.cat(stripes, dim=2)[:, :, :n].transpose(1, 2).reshape(b, n, cfg.inner_dim)
    out = linear(o, attn.to_out.weight)
    return out + x if residual else out
