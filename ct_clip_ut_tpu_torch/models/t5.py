"""T5-v1_1 encoder (google/t5-v1_1-base shape) and its text conditioner.

Counterpart of ct_clip_ut_tpu/models/t5.py. Modules and parameter names
follow HF T5EncoderModel's state dict (shared, encoder.block.{i}.layer.0
.SelfAttention.{q,k,v,o}, block 0's relative_attention_bias, layer_norm,
layer.1.DenseReluDense.{wi_0,wi_1,wo}, encoder.final_layer_norm). The
semantics kept: RMSNorm (eps 1e-6, no mean, no bias) in fp32; no 1/sqrt(d)
score scaling; block 0's bucketed relative-position bias added in every
layer; the additive key mask at finfo(float32).min; the gated tanh GELU
("gelu_new"); pad positions of the output zeroed. No TPU kernel covers T5,
so it is plain PyTorch in the parameters' dtype (fp32) on any device.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import T5EncoderConfig


class T5LayerNorm(nn.Module):
    """RMSNorm with a learned `weight`."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads)


class _AttentionLayer(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_bias: bool):
        super().__init__()
        self.SelfAttention = _SelfAttention(cfg, has_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class _DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class _Block(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_AttentionLayer(cfg, has_bias), _FFLayer(cfg)])


class _Stack(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.block = nn.ModuleList(_Block(cfg, i == 0) for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int, max_distance: int,
                              device=None) -> torch.Tensor:
    """Bidirectional T5 relative-position buckets [q, k] (t5.py:37-55)."""
    rel = (torch.arange(klen, device=device)[None, :]
           - torch.arange(qlen, device=device)[:, None])
    nb = num_buckets // 2
    buckets = torch.where(rel > 0, nb, 0)
    rel_abs = rel.abs()
    max_exact = nb // 2
    val_large = max_exact + (torch.log(rel_abs.float() / max_exact + 1e-20)
                             / math.log(max_distance / max_exact)
                             * (nb - max_exact)).to(torch.int64)
    val_large = val_large.clamp_max(nb - 1)
    return buckets + torch.where(rel_abs < max_exact, rel_abs, val_large)


def t5_encode(t5: T5Encoder, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """last_hidden_state [b, n, d_model] with pad positions zeroed
    (t5.py:83-128)."""
    cfg = t5.cfg
    b, n = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    x = t5.shared.weight[input_ids.long()]
    ext_mask = ((1.0 - attention_mask.float()) * torch.finfo(torch.float32).min)[:, None, None, :]
    blocks = t5.encoder.block
    buckets = relative_position_buckets(n, n, cfg.relative_attention_num_buckets,
                                        cfg.relative_attention_max_distance, x.device)
    rel = blocks[0].layer[0].SelfAttention.relative_attention_bias.weight
    pos_bias = rel[buckets].permute(2, 0, 1)[None]                  # [1, h, q, k]
    h, dk = cfg.num_heads, cfg.d_kv

    def split(t):
        return t.reshape(b, n, h, dk).transpose(1, 2)

    for blk in blocks:
        att, ff = blk.layer
        sa = att.SelfAttention
        y = att.layer_norm(x)
        q, k, v = split(y @ sa.q.weight.t()), split(y @ sa.k.weight.t()), split(y @ sa.v.weight.t())
        sim = q.float() @ k.float().transpose(-1, -2) + pos_bias + ext_mask   # no 1/sqrt(d)
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        ctx = (attn.float() @ v.float()).to(x.dtype).transpose(1, 2).reshape(b, n, h * dk)
        x = x + ctx @ sa.o.weight.t()
        y = ff.layer_norm(x)
        dr = ff.DenseReluDense
        gated = (F.gelu((y @ dr.wi_0.weight.t()).float(), approximate="tanh").to(y.dtype)
                 * (y @ dr.wi_1.weight.t()))
        x = x + gated @ dr.wo.weight.t()
    x = t5.encoder.final_layer_norm(x)
    return torch.where(attention_mask[..., None].bool(), x, torch.zeros((), dtype=x.dtype,
                                                                         device=x.device))


class T5TextConditioner:
    """The encoder paired with a host-side tokenizer (t5.py:131-175): an
    HF-style callable that takes padding="longest", truncation and
    max_length and returns input_ids / attention_mask, with
    convert_ids_to_tokens (the stand-in `infer.zeroshot.WordTokenizer`
    where no tokenizer files exist)."""

    def __init__(self, t5: T5Encoder, tokenizer):
        self.t5 = t5
        self.cfg = t5.cfg
        self.tokenizer = tokenizer
        self.tokens: List[str] = []
        self.batch_tokens: List[List[str]] = []

    @torch.no_grad()
    def encode(self, texts, max_length: Optional[int] = None):
        """(text_embed [b, L, d_model] fp32, text_mask [b, L] bool) on the
        encoder's device, L the longest report's token count."""
        enc = self.tokenizer([texts] if isinstance(texts, str) else list(texts),
                             return_tensors="np", padding="longest", truncation=True,
                             max_length=max_length or self.cfg.max_length)
        dev = self.t5.shared.weight.device
        ids = torch.as_tensor(np.asarray(enc["input_ids"]), dtype=torch.int64, device=dev)
        mask = torch.as_tensor(np.asarray(enc["attention_mask"]), dtype=torch.int64, device=dev)
        self.batch_tokens = [self.tokenizer.convert_ids_to_tokens(row)
                             for row in np.asarray(enc["input_ids"]).tolist()]
        self.tokens = self.batch_tokens[0]
        return t5_encode(self.t5, ids, mask), mask.bool()

    def get_token_indices(self, keywords, index: int = 0) -> dict:
        """First-match token span per keyword over row `index` of the last
        encode (t5.py:158-175)."""
        def norm(tokens):
            return [t.lstrip("▁").lower() for t in tokens]

        out = {}
        toks = norm(self.batch_tokens[index] if self.batch_tokens else self.tokens)
        for kw in keywords:
            kw_ids = self.tokenizer(kw, add_special_tokens=False)["input_ids"]
            kw_toks = norm(self.tokenizer.convert_ids_to_tokens(kw_ids))
            for i in range(len(toks) - len(kw_toks) + 1):
                if toks[i:i + len(kw_toks)] == kw_toks:
                    out[kw] = list(range(i, i + len(kw_toks)))
                    break
        return out
