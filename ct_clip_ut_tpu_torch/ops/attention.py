"""QK-normalised (cosine-sim) attention.

Counterpart of ct_clip_ut_tpu/ops/attention.py. `attention` dispatches
self-attention with no mask, no weights requested, not causal and no null
key/values to a block kernel: `attn_block` when a bias is given (the
spatial stack), `attn_packed` otherwise (the temporal stack). On CUDA
tensors those launch their kernels or raise for a shape they do not take;
on CPU tensors they take their plain versions. Every other call runs the
plain path of attention.py:141-226, which also returns the pre-dropout
attention weights. The block path carries its backward: `_BlockFn` (the
custom VJPs of pallas_attn_block / pallas_attn_packed) runs the backward
kernel chains on CUDA tensors and their plain versions on CPU tensors;
with plain=True the plain forward is differentiated by autograd instead.
Attention dropout is not ported (the CT-ViT's rates are 0).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import AttentionConfig
from .attn_block import attn_block, attn_block_bwd, attn_block_plain
from .attn_packed import attn_packed, attn_packed_bwd, attn_packed_plain
from .layers import FrozenBiasLayerNorm, l2norm, layernorm, linear
from .posbias import alibi_bias, causal_mask

NEG_INF = -3.4028234663852886e38  # -finfo(float32).max, as masked_fill


class Attention(nn.Module):
    """Parameters named as the reference module (norm.gamma, to_q, to_kv,
    to_out, q_scale, k_scale, null_kv, context_norm.gamma)."""

    def __init__(self, cfg: AttentionConfig):
        super().__init__()
        self.cfg = cfg
        self.norm = FrozenBiasLayerNorm(cfg.dim)
        self.to_q = nn.Linear(cfg.dim, cfg.inner_dim, bias=False)
        self.to_kv = nn.Linear(cfg.context_dim, 2 * cfg.inner_dim, bias=False)
        self.to_out = nn.Linear(cfg.inner_dim, cfg.dim, bias=False)
        self.q_scale = nn.Parameter(torch.ones(cfg.dim_head))
        self.k_scale = nn.Parameter(torch.ones(cfg.dim_head))
        # exists even when num_null_kv == 0, like the reference
        self.null_kv = nn.Parameter(torch.zeros(cfg.heads, 2 * cfg.num_null_kv, cfg.dim_head))
        if cfg.norm_context:
            self.context_norm = FrozenBiasLayerNorm(cfg.context_dim)


class _BlockFn(torch.autograd.Function):
    """The fused block with its backward: attn_block (with a bias) or
    attn_packed (without), forward and backward, on CUDA tensors the kernels
    and on CPU tensors their plain versions."""

    @staticmethod
    def forward(ctx, x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual):
        ctx.save_for_backward(x, gamma, wq, wk, wv, wo, qs, ks, bias)
        ctx.scale, ctx.residual = scale, residual
        if bias is not None:
            return attn_block(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual)
        return attn_packed(x, gamma, wq, wk, wv, wo, qs, ks, scale, residual)

    @staticmethod
    def backward(ctx, g):
        x, gamma, wq, wk, wv, wo, qs, ks, bias = ctx.saved_tensors
        args = (x, gamma, wq, wk, wv, wo, qs, ks)
        if bias is not None:
            *grads, dbias = attn_block_bwd(*args, bias, g.contiguous(), ctx.scale, ctx.residual)
            dbias = dbias.to(bias.dtype)
        else:
            grads = attn_packed_bwd(*args, g.contiguous(), ctx.scale, ctx.residual)
            dbias = None
        grads = [grads[0]] + [d.to(a.dtype) for d, a in zip(grads[1:], args[1:])]
        return (*grads, dbias, None, None)


class AttentionOutput(NamedTuple):
    out: torch.Tensor                 # [b, n, dim]
    weights: Optional[torch.Tensor]   # [b, heads, i, j] fp32, or None


def attention(attn: Attention, x: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None,
              context: Optional[torch.Tensor] = None,
              attn_bias: Optional[torch.Tensor] = None,
              return_weights: bool = True,
              residual: bool = False,
              plain: bool = False) -> AttentionOutput:
    """Cosine attention of x [b, n, dim]. mask: [b, j] bool (True = attend);
    attn_bias: [heads, i, j]; residual: return block(x) + x. plain=True
    takes the block kernels' plain versions on any device (the reference
    the card compares its kernels with)."""
    cfg = attn.cfg
    if context is not None:
        raise NotImplementedError(
            "cross-attention is not ported yet (ROADMAP, Queue 1 item 10: CTGenerate)")
    if (not return_weights and mask is None and not cfg.causal and cfg.num_null_kv == 0):
        dt = x.dtype
        wkv = attn.to_kv.weight.to(dt)
        args = (x.contiguous(), attn.norm.gamma.float(), attn.to_q.weight.to(dt),
                wkv[:cfg.inner_dim], wkv[cfg.inner_dim:], attn.to_out.weight.to(dt),
                attn.q_scale.float(), attn.k_scale.float())
        bias = None if attn_bias is None else attn_bias.float().contiguous()
        if not plain:
            out = _BlockFn.apply(*args, bias, cfg.scale, residual)
        elif bias is not None:
            out = attn_block_plain(*args, bias, cfg.scale, residual)
        else:
            out = attn_packed_plain(*args, cfg.scale, residual)
        return AttentionOutput(out, None)
    return _attention_plain(attn, x, mask, attn_bias, return_weights, residual)


def _attention_plain(attn: Attention, x, mask, attn_bias, return_weights, residual):
    """attention.py:141-226 (self-attention)."""
    cfg = attn.cfg
    b, h, dh = x.shape[0], cfg.heads, cfg.dim_head
    xn = layernorm(x, attn.norm.gamma)
    q = linear(xn, attn.to_q.weight)
    k, v = linear(x, attn.to_kv.weight).chunk(2, dim=-1)

    def split_heads(t):
        return t.reshape(t.shape[0], t.shape[1], h, dh).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)      # [b, h, n, d]
    if cfg.num_null_kv > 0:
        # interleaved (nk_0, nv_0, nk_1, nv_1, ...) pairs (attention.py:183-191)
        null = attn.null_kv.to(k.dtype).reshape(h, cfg.num_null_kv, 2, dh)
        nk = null[:, :, 0].expand(b, h, cfg.num_null_kv, dh)
        nv = null[:, :, 1].expand(b, h, cfg.num_null_kv, dh)
        k = torch.cat([nk, k], dim=-2)
        v = torch.cat([nv, v], dim=-2)

    q = l2norm(q) * attn.q_scale.to(q.dtype)
    k = l2norm(k) * attn.k_scale.to(k.dtype)
    sim = (q.float() @ k.float().transpose(-1, -2)) * cfg.scale
    i, j = sim.shape[-2:]
    if attn_bias is not None:
        if cfg.num_null_kv > 0:
            attn_bias = F.pad(attn_bias, (cfg.num_null_kv, 0))
        sim = sim + attn_bias.float()
    if mask is not None:
        if cfg.num_null_kv > 0:
            mask = F.pad(mask, (cfg.num_null_kv, 0), value=True)
        sim = torch.where(mask[:, None, None, :], sim, torch.full_like(sim, NEG_INF))
    if cfg.causal:
        sim = sim + alibi_bias(h, i, j, device=sim.device)
        sim = sim.masked_fill(causal_mask(i, j, device=sim.device), NEG_INF)
    weights = torch.softmax(sim, dim=-1)
    out = (weights.to(v.dtype).float() @ v.float()).to(x.dtype)
    out = out.transpose(1, 2).reshape(b, -1, cfg.inner_dim)
    out = linear(out, attn.to_out.weight)
    return AttentionOutput(out + x if residual else out,
                           weights if return_weights else None)
