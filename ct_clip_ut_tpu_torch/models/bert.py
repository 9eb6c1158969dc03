"""BERT text encoder (HF BertModel semantics, post-LN), inference only.

Counterpart of the plain path of ct_clip_ut_tpu/models/bert.py:127-179.
Submodules carry HF's state-dict names (embeddings.word_embeddings,
encoder.layer.N.attention.self.query, ...). No kernel is reached: the
zero-shot prompts are 24 tokens, below the fused layer's n >= 128 gate.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import BertConfig
from ..ops.layers import layernorm, linear


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        eps = cfg.layer_norm_eps
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({"query": nn.Linear(h, h), "key": nn.Linear(h, h),
                                   "value": nn.Linear(h, h)}),
            "output": nn.ModuleDict({"dense": nn.Linear(h, h),
                                     "LayerNorm": nn.LayerNorm(h, eps=eps)})})
        self.intermediate = nn.ModuleDict({"dense": nn.Linear(h, i)})
        self.output = nn.ModuleDict({"dense": nn.Linear(i, h),
                                     "LayerNorm": nn.LayerNorm(h, eps=eps)})


class Bert(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))


def bert_apply(bert: Bert, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None,
               token_type_ids: Optional[torch.Tensor] = None,
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """last_hidden_state [b, n, hidden] (deterministic)."""
    cfg = bert.cfg
    b, n = input_ids.shape
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    e = bert.embeddings
    x = (e.word_embeddings.weight[input_ids] + e.position_embeddings.weight[None, :n]
         + e.token_type_embeddings.weight[token_type_ids])
    eps = cfg.layer_norm_eps
    x = layernorm(x, e.LayerNorm.weight, e.LayerNorm.bias, eps).to(compute_dtype)

    # HF additive mask: 0 where attended, dtype-min where padded
    ext_mask = ((1.0 - attention_mask.float()) * torch.finfo(torch.float32).min)[:, None, None, :]
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    scale = hd ** -0.5

    for layer in bert.encoder.layer:
        sa, ao = layer.attention["self"], layer.attention["output"]
        qkv_w = torch.cat([sa["query"].weight, sa["key"].weight, sa["value"].weight])
        qkv_b = torch.cat([sa["query"].bias, sa["key"].bias, sa["value"].bias])
        qkv = linear(x, qkv_w, qkv_b)
        q, k, v = (t.reshape(b, n, nh, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        sim = (q.float() @ k.float().transpose(-1, -2)) * scale + ext_mask
        attn = torch.softmax(sim, dim=-1).to(compute_dtype)
        ctx = (attn.float() @ v.float()).to(compute_dtype)
        ctx = ctx.transpose(1, 2).reshape(b, n, cfg.hidden_size)
        h = linear(ctx, ao["dense"].weight, ao["dense"].bias)
        x = layernorm(h + x, ao["LayerNorm"].weight, ao["LayerNorm"].bias, eps).to(compute_dtype)
        h = linear(x, layer.intermediate["dense"].weight, layer.intermediate["dense"].bias)
        h = torch.nn.functional.gelu(h.float()).to(compute_dtype)
        out = layer.output
        h = linear(h, out["dense"].weight, out["dense"].bias)
        x = layernorm(h + x, out["LayerNorm"].weight, out["LayerNorm"].bias, eps).to(compute_dtype)
    return x


def bert_cls(bert: Bert, input_ids, attention_mask=None, token_type_ids=None,
             compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CLS-token hidden state [b, hidden]."""
    return bert_apply(bert, input_ids, attention_mask, token_type_ids, compute_dtype)[:, 0]
