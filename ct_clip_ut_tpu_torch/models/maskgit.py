"""MaskGit transformer over CT-ViT codebook ids with T5 cross-attention.

Counterpart of ct_clip_ut_tpu/models/maskgit.py: token embeddings (with the
MASK row, id num_tokens) plus position embeddings, the gradient shrink
(alpha 0.1), a 3-D continuous position bias over the token grid, a depth-6
transformer of [PEG, self-attention, cross-attention (2 null key/values) to
the T5 report, GEGLU FF] and a logits head; `maskgit_generate` decodes a
grid by the MaskGIT confidence schedule.

From 4096 tokens on, self-attention takes the query-row-block route
(`qrows_route`): the attn_qrows kernel with one grid frame (h*w tokens) per
block, over the dense [heads, n, n] CPB table while heads * n^2 * 4 bytes
stay under 2 GiB (the JAX rule, whatever the dtype), else over row stripes
built per block. The table rides in the compute dtype there (the TPU
kernel's kv variant rounds it so). On the card the stack runs in bf16
(serving) or fp32 (CTGenerate's one-scan route: the fp32 variants of
attn_qrows and geglu_ff); the cross-attention to the report and the PEG
stay plain PyTorch in either, as they are XLA in the JAX package.
plain=True runs every kernel's plain version, in any dtype, on any
device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from .. import _build
from ..config import MaskGitConfig
from ..ops.layers import linear
from ..ops.posbias import (ContinuousPositionBias, continuous_pos_bias,
                           continuous_pos_bias_grouped3, continuous_pos_bias_row_stripe3,
                           cpb_offset_table)
from ..ops.taps import Taps
from ..ops.transformer import Transformer, transformer

BIAS_TABLE_MAX_BYTES = 2 * 1024**3   # maskgit.py:26-30
QROWS_MIN_TOKENS = 4096              # ctgenerate.py:87


class MaskGit(nn.Module):
    def __init__(self, cfg: MaskGitConfig):
        super().__init__()
        self.cfg = cfg
        self.token_emb = nn.Embedding(cfg.num_tokens + 1, cfg.dim)
        self.pos_emb = nn.Embedding(cfg.max_seq_len, cfg.dim)
        self.continuous_pos_bias = ContinuousPositionBias(cfg.dim_head, cfg.heads, num_dims=3)
        self.transformer = Transformer(cfg.transformer())
        self.to_logits = nn.Linear(cfg.dim, cfg.num_tokens)


class MaskGitOutput(NamedTuple):
    output: torch.Tensor        # logits [b, n, num_tokens] or embeddings [b, n, dim]
    self_attn: tuple            # per-layer [b, heads, n, n] (weights="all")
    cross_attn: tuple           # per-layer [b, heads, n, 2 + text_len]


def qrows_route(cfg: MaskGitConfig, video_patch_shape) -> Tuple[Optional[int], bool]:
    """(self_attn_block, dense table) of a forward over this token grid:
    h*w tokens per query block from QROWS_MIN_TOKENS on (else None, the
    dense route), and whether the [heads, n, n] table stays under the cap."""
    t, h, w = (int(d) for d in video_patch_shape)
    n = t * h * w
    block = h * w if n >= QROWS_MIN_TOKENS else None
    return block, cfg.heads * n * n * 4 <= BIAS_TABLE_MAX_BYTES


def self_attn_bias(mg: MaskGit, video_patch_shape, self_attn_block: Optional[int], *,
                   weights: str, video_mask=None, dtype=torch.float32):
    """(attn_bias, bias_fn) of the self-attention CPB (maskgit.py:55-97):
    the [heads, n, n] table on the dense route; on the q-row route the same
    table built in `dtype` under the cap, else a row-stripe builder over the
    offset table."""
    if self_attn_block is None:
        return continuous_pos_bias(mg.continuous_pos_bias, *video_patch_shape), None
    d1, d2, d3 = (int(d) for d in video_patch_shape)
    assert video_mask is None, "blockwise MaskGit has no video mask"
    assert weights in ("last_cross", "none"), \
        "self-attention weights are not observable blockwise"
    assert self_attn_block % (d2 * d3) == 0, (self_attn_block, d2, d3)
    cpb = mg.continuous_pos_bias
    if qrows_route(mg.cfg, video_patch_shape)[1]:
        return continuous_pos_bias_grouped3(cpb, d1, d2, d3, dtype=dtype), None
    table = cpb_offset_table(cpb, (d1, d2, d3))

    def bias_fn(row0):
        return continuous_pos_bias_row_stripe3(cpb, d1, d2, d3, row0 // (d2 * d3),
                                               self_attn_block // (d2 * d3), table=table)

    return None, bias_fn


def _dtype(name) -> Optional[torch.dtype]:
    return None if name is None else (getattr(torch, name) if isinstance(name, str) else name)


def maskgit_apply(mg: MaskGit, ct_codebook_ids: torch.Tensor, context: torch.Tensor,
                  video_patch_shape: Tuple[int, int, int], *,
                  text_mask: Optional[torch.Tensor] = None,
                  video_mask: Optional[torch.Tensor] = None,
                  return_embeds: bool = False, weights: str = "all",
                  self_attn_block: Optional[int] = None, precomputed_bias=None,
                  compute_dtype=None, plain: bool = False) -> MaskGitOutput:
    """ids [b, n], T5 context [b, text_len, dim_context], the (t, h, w) grid
    (maskgit.py:100-169). weights: "all" returns every layer's self and
    cross weights; "last_cross" the last layer's cross-attention (what the
    keyword heatmaps read); "none" nothing (the decode loop).
    compute_dtype (None keeps the parameters' fp32) is the transformer
    stack's dtype; the embeddings stay fp32."""
    cfg = mg.cfg
    b, n = ct_codebook_ids.shape
    x = mg.token_emb.weight[ct_codebook_ids.long()] + mg.pos_emb.weight[:n][None]
    a = cfg.gradient_shrink_alpha
    x = x * a + x.detach() * (1.0 - a)        # value unchanged, gradient scaled by alpha
    dt = _dtype(compute_dtype)
    if dt is not None:
        x, context = x.to(dt), context.to(dt)
    if _build.on_cuda(x) and not plain and x.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"MaskGit in {x.dtype} on the card: the attn_qrows and "
                                  "geglu_ff kernels take bfloat16 or float32")

    if precomputed_bias is not None:
        attn_bias, bias_fn = precomputed_bias
    else:
        attn_bias, bias_fn = self_attn_bias(mg, video_patch_shape, self_attn_block,
                                            weights=weights, video_mask=video_mask)
    if self_attn_block is not None and attn_bias is not None:
        attn_bias = attn_bias.to(x.dtype)      # once for all layers (the kv variant's cast)

    last = f"{cfg.depth - 1}.cross_attn_weights"
    names = {"all": {f"{i}.cross_attn_weights" for i in range(cfg.depth)},
             "last_cross": {last}, "none": set()}[weights]
    taps = Taps(capture=names)
    out, self_w = transformer(
        mg.transformer, x, video_shape=(b, *video_patch_shape), attn_bias=attn_bias,
        context=context, self_attn_mask=video_mask, cross_attn_context_mask=text_mask,
        return_weights=weights == "all", taps=taps, self_attn_block=self_attn_block,
        self_attn_bias_fn=bias_fn, plain=plain)
    cross = tuple(taps.collected[f"{i}.cross_attn_weights"] for i in range(cfg.depth)
                  if f"{i}.cross_attn_weights" in names)
    if not return_embeds:
        out = linear(out, mg.to_logits.weight, mg.to_logits.bias)
    return MaskGitOutput(output=out, self_attn=self_w if weights == "all" else (),
                         cross_attn=cross)


def _cosine_mask_counts(n: int, steps: int) -> list:
    """MaskGIT cosine schedule: positions still masked after each decode
    step, strictly decreasing to 0 at the last step (maskgit.py:172-179)."""
    counts = [int(math.floor(math.cos(math.pi / 2 * (s + 1) / steps) * n)) for s in range(steps)]
    counts[-1] = 0
    return counts


@torch.no_grad()
def maskgit_generate(mg: MaskGit, context: torch.Tensor, video_patch_shape: Tuple[int, int, int],
                     *, text_mask: Optional[torch.Tensor] = None, steps: int = 18,
                     temperature: float = 1.0, generator: torch.Generator,
                     compute_dtype=None) -> torch.Tensor:
    """Iterative parallel decode of a [b, t*h*w] id grid conditioned on T5
    context (maskgit.py:182-257): every position starts at MASK; each step
    samples the masked positions from logits / temperature (annealed to 0)
    by the Gumbel-max rule with noise from `generator` (the draws of
    jax.random.categorical cannot be reproduced), and re-masks exactly the
    cosine schedule's count of least-confident samples, ranked by
    (confidence, index) with a stable argsort of the argsort. The bias is
    built once, outside the loop. Returns int32 ids < num_tokens."""
    cfg = mg.cfg
    b = context.shape[0]
    t, h, w = (int(d) for d in video_patch_shape)
    n = t * h * w
    mask_id = cfg.num_tokens
    counts = _cosine_mask_counts(n, steps)
    anneal = torch.linspace(1.0, 0.0, steps + 1)[1:].tolist()
    blk = qrows_route(cfg, video_patch_shape)[0]
    dt = _dtype(compute_dtype) or mg.token_emb.weight.dtype
    bias = self_attn_bias(mg, video_patch_shape, blk, weights="none",
                          dtype=dt if blk is not None else torch.float32)
    dev = context.device
    ids = torch.full((b, n), mask_id, dtype=torch.int64, device=dev)
    is_masked = torch.ones((b, n), dtype=torch.bool, device=dev)
    for s in range(steps):
        logits = maskgit_apply(mg, ids, context, video_patch_shape, text_mask=text_mask,
                               weights="none", self_attn_block=blk, precomputed_bias=bias,
                               compute_dtype=compute_dtype).output.float()
        temp = max(temperature * anneal[s], 1e-6)
        u = torch.rand(logits.shape, generator=generator, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp(torch.finfo(torch.float32).tiny, 1.0)))
        sampled = (logits / temp + gumbel).argmax(-1)
        conf = torch.softmax(logits, dim=-1).gather(-1, sampled[..., None])[..., 0]
        sampled = torch.where(is_masked, sampled, ids)
        conf = torch.where(is_masked, conf, torch.full_like(conf, math.inf))
        order = torch.argsort(conf, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1)
        is_masked = rank < counts[s]
        ids = torch.where(is_masked, torch.full_like(sampled, mask_id), sampled)
    return ids.to(torch.int32)
