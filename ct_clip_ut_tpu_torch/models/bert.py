"""BERT text encoder (HF BertModel semantics, post-LN).

Counterpart of ct_clip_ut_tpu/models/bert.py:60-179. Submodules carry HF's
state-dict names (embeddings.word_embeddings,
encoder.layer.N.attention.self.query, ...). On the card, sequences that
pass the JAX package's gate for its fused layer (bert.py:97-100: n >= 128
and a multiple of 8, hidden a multiple of 128, heads of a width 8 divides)
run each layer through the bert_layer kernels (`fused_layers`): the
zero-shot prompts, padded to 512 tokens, in fp32; the train step's 512-token
reports in bf16 with dropout, forward and backward (`bert_layer_grad`); the
train loop's evaluation in bf16 without. Shorter sequences, and CPU tensors,
take the layer loop written out below (HF semantics, two-pass LayerNorm).

Train mode (deterministic=False) applies the JAX package's dropout sites
(bert.py:78-80, 127-170): the embeddings first, on both routes
(`embed`); then per layer the attention probabilities and both hidden
outputs at the BertConfig rates. The layer loop draws its masks with
torch.bernoulli from the generator; the fused route draws three seeds per
layer from it (`draw_seeds`, a device tensor) and the kernels compute
Philox masks from them. A train-mode call without a generator raises (the
JAX package silently turns dropout off there). One limit: an fp32
train-mode call on the card that meets the gate raises, since the fp32
chain has no dropout and no backward kernel (ROADMAP, Queue 2 item 8b; the
TrainConfig default is bf16).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import _build
from ..config import BertConfig
from ..ops.bert_layer import bert_layer_grad, bert_layer_plain, draw_seeds
from ..ops.layers import dropout, layernorm, linear


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


def fused_layer_gate(cfg: BertConfig, n: int) -> bool:
    """The JAX package's condition for its fused layer (bert.py:97-100)."""
    hd = cfg.hidden_size // cfg.num_heads
    return (cfg.hidden_size % 128 == 0 and n % 8 == 0 and n >= 128 and hd % 8 == 0
            and cfg.num_heads * hd == cfg.hidden_size)


def takes_fused_layers(x: torch.Tensor, cfg: BertConfig, n: int) -> bool:
    """The card runs the bert_layer kernel where the JAX gate holds; the
    CPU takes the layer loop."""
    return x.is_cuda and fused_layer_gate(cfg, n)


def layer_args(layer: BertLayer) -> tuple:
    """A layer's weights in bert_layer's argument order."""
    sa, ao, out = layer.attention["self"], layer.attention["output"], layer.output
    return (torch.cat([sa["query"].weight, sa["key"].weight, sa["value"].weight]),
            torch.cat([sa["query"].bias, sa["key"].bias, sa["value"].bias]),
            ao["dense"].weight, ao["dense"].bias, ao["LayerNorm"].weight, ao["LayerNorm"].bias,
            layer.intermediate["dense"].weight, layer.intermediate["dense"].bias,
            out["dense"].weight, out["dense"].bias, out["LayerNorm"].weight,
            out["LayerNorm"].bias)


def embed(bert: Bert, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
          compute_dtype: torch.dtype, generator: Optional[torch.Generator] = None,
          deterministic: bool = True) -> torch.Tensor:
    """The embedding sum, its LayerNorm, the cast to compute_dtype and, in
    train mode, the embedding dropout (bert.py:73-80 of the JAX package):
    what both routes feed their first layer."""
    e = bert.embeddings
    n = input_ids.shape[1]
    x = (e.word_embeddings.weight[input_ids] + e.position_embeddings.weight[None, :n]
         + e.token_type_embeddings.weight[token_type_ids])
    x = layernorm(x, e.LayerNorm.weight, e.LayerNorm.bias,
                  bert.cfg.layer_norm_eps).to(compute_dtype)
    if not deterministic:
        x = dropout(x, bert.cfg.hidden_dropout, generator)
    return x


def fused_layers(bert: Bert, x: torch.Tensor, mask_row: torch.Tensor, plain: bool = False, *,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = True) -> torch.Tensor:
    """Every layer through bert_layer with its backward (its plain version,
    differentiated by autograd, with plain=True); x [b, n, hidden] after
    `embed`, mask_row [b, n] additive. In train mode each layer draws its
    three dropout seeds from `generator`, the same draws on both routes."""
    cfg = bert.cfg
    train = not deterministic
    if train and generator is None:
        raise ValueError("train-mode BERT (deterministic=False) needs a torch.Generator")
    if train and not plain and x.dtype == torch.float32 and _build.on_cuda(x):
        raise NotImplementedError(
            f"train-mode BERT in fp32 at {x.shape[1]} tokens meets the fused-layer gate "
            "(n >= 128), and the fp32 bert_layer chain has no dropout and no backward kernel "
            "(ROADMAP, Queue 2 item 8b); train in bf16, the TrainConfig default")
    fn = bert_layer_plain if plain else bert_layer_grad
    for layer in bert.encoder.layer:
        seeds = draw_seeds(generator, x.device) if train else None
        x = fn(x.contiguous(), mask_row, *layer_args(layer), cfg.num_heads, cfg.layer_norm_eps,
               p_attn=cfg.attention_dropout, p_hidden=cfg.hidden_dropout, train=train,
               seeds=seeds)
    return x


def bert_apply(bert: Bert, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None,
               token_type_ids: Optional[torch.Tensor] = None,
               compute_dtype: torch.dtype = torch.float32,
               plain: bool = False, *, generator: Optional[torch.Generator] = None,
               deterministic: bool = True) -> torch.Tensor:
    """last_hidden_state [b, n, hidden]. plain=True runs the kernel's plain
    version where the kernel would run. deterministic=False applies dropout
    with masks from `generator`."""
    cfg = bert.cfg
    b, n = input_ids.shape
    train = not deterministic
    if train and generator is None:
        raise ValueError("train-mode BERT (deterministic=False) needs a torch.Generator")
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    eps = cfg.layer_norm_eps
    x = embed(bert, input_ids, token_type_ids, compute_dtype, generator, deterministic)

    # HF additive mask: 0 where attended, dtype-min where padded
    mask_row = (1.0 - attention_mask.float()) * torch.finfo(torch.float32).min
    if takes_fused_layers(x, cfg, n):
        return fused_layers(bert, x, mask_row, plain, generator=generator,
                            deterministic=deterministic)

    ext_mask = mask_row[:, None, None, :]
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
        if train:
            attn = dropout(attn, cfg.attention_dropout, generator)
        ctx = (attn.float() @ v.float()).to(compute_dtype)
        ctx = ctx.transpose(1, 2).reshape(b, n, cfg.hidden_size)
        h = linear(ctx, ao["dense"].weight, ao["dense"].bias)
        if train:
            h = dropout(h, cfg.hidden_dropout, generator)
        x = layernorm(h + x, ao["LayerNorm"].weight, ao["LayerNorm"].bias, eps).to(compute_dtype)
        h = linear(x, layer.intermediate["dense"].weight, layer.intermediate["dense"].bias)
        h = torch.nn.functional.gelu(h.float()).to(compute_dtype)
        out = layer.output
        h = linear(h, out["dense"].weight, out["dense"].bias)
        if train:
            h = dropout(h, cfg.hidden_dropout, generator)
        x = layernorm(h + x, out["LayerNorm"].weight, out["LayerNorm"].bias, eps).to(compute_dtype)
    return x


def bert_cls(bert: Bert, input_ids, attention_mask=None, token_type_ids=None,
             compute_dtype: torch.dtype = torch.float32, plain: bool = False, *,
             generator: Optional[torch.Generator] = None,
             deterministic: bool = True) -> torch.Tensor:
    """CLS-token hidden state [b, hidden]."""
    return bert_apply(bert, input_ids, attention_mask, token_type_ids, compute_dtype, plain,
                      generator=generator, deterministic=deterministic)[:, 0]
