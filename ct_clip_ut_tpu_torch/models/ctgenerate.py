"""CTGenerate: CT-ViT tokenizer -> MaskGit conditioned on T5 report
embeddings, with per-keyword cross-attention extraction.

Counterpart of ct_clip_ut_tpu/models/ctgenerate.py. A [b, 1, 201, 128, 128]
scan becomes a 101 x 8 x 8 grid of codebook ids; MaskGit attends over the
6,464 tokens (the q-row route, one frame of 64 tokens per query block) with
cross-attention to the report; the last layer's cross-attention, its 2 null
columns dropped, gives each keyword's localisation heatmap.

On the card the tokenizer runs in the scan's dtype: a bf16 scan through
the bf16 kernels, an fp32 scan through their fp32 variants (the conv
patch embed, both attention blocks, the FF and the VQ). MaskGit runs in
`compute_dtype`: fp32 (the default of `ctgenerate_apply`, the JAX script's
one-scan route at --batch-size 1) through the fp32 attn_qrows and
geglu_ff, bf16 (the default of `ctgenerate_apply_batched`, serving with
the bias cache) through their bf16 kernels. plain=True runs every
kernel's plain version instead (what the card compares the kernels with).

Over a data-axis mesh (`ctgenerate_apply_batched(mesh=)`, JAX :193-217)
the batch is padded to a multiple of the world by repeating its last
scan, each rank runs its rows, and the outputs are gathered in rank order
and cut back to the batch: every rank holds every row.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import _build
from ..config import CTGenerateConfig
from ..ops.posbias import continuous_pos_bias_grouped3
from ..parallel import collectives
from ..parallel.mesh import check_mesh
from .ctclip import SeededInit
from .ctvit import CTViT, ctvit_apply, token_grid_shape
from .maskgit import MaskGit, _dtype, maskgit_apply, qrows_route
from .t5 import T5Encoder, T5LayerNorm


class CTGenerate(nn.Module):
    def __init__(self, cfg: CTGenerateConfig):
        super().__init__()
        self.cfg = cfg
        self.ctvit = CTViT(cfg.ctvit)
        self.maskgit = MaskGit(cfg.maskgit)
        self.t5 = T5Encoder(cfg.t5)


@torch.no_grad()
def init_ctgenerate(cfg: CTGenerateConfig, seed: int = 0, device="cuda") -> CTGenerate:
    """A CTGenerate in eval mode with weights drawn from `seed` with the JAX
    package's init distributions (SeededInit.modules_; T5: embeddings
    N(0, 1), the relative-position bias N(0, 0.1^2), RMSNorm gains ones).
    On the card unless `device` says otherwise."""
    device = _build.check_device(device)
    with torch.device("meta"):
        model = CTGenerate(cfg)
    model.to_empty(device=device)
    init = SeededInit(seed, device)
    init.modules_(model)
    init.normal_(model.t5.shared.weight, 1.0)
    rel = model.t5.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
    init.normal_(rel, 0.1)
    for m in model.t5.modules():
        if isinstance(m, T5LayerNorm):
            init.fill_(m.weight, 1.0)
    return init.check(model)


class CTGenerateOutput(NamedTuple):
    feature_map: torch.Tensor                 # [b, n, dim] MaskGit embeddings
    kw_attention: Dict[str, torch.Tensor]     # keyword -> [b, heads, n, n_kw_tokens]
    video_patch_shape: Tuple[int, int, int]
    codebook_ids: torch.Tensor                # [b, t, h, w]
    cross_attention: Optional[torch.Tensor] = None   # [b, heads, n, text_len], fp32


def ctgenerate_apply(model: CTGenerate, ct_scan: torch.Tensor, text_embed: torch.Tensor,
                     text_mask: torch.Tensor, keyword_indices: Dict[str, list], *,
                     return_embeds: bool = True, self_attn_bias: Optional[torch.Tensor] = None,
                     compute_dtype="float32", plain: bool = False) -> CTGenerateOutput:
    """Forward (ctgenerate.py:55-117). `text_embed` / `text_mask` come from
    T5TextConditioner.encode, `keyword_indices` from its get_token_indices.
    `self_attn_bias` is a prebuilt [heads, n, n] table (maskgit_bias_table).
    The tokenizer keeps the scan's dtype; compute_dtype is MaskGit's."""
    cfg = model.cfg
    with torch.no_grad():
        ids_grid = ctvit_apply(model.ctvit, ct_scan, freeze_vq=True, plain=plain).codebook_ids
    video_patch_shape = tuple(int(d) for d in ids_grid.shape[1:])
    ids = ids_grid.reshape(ids_grid.shape[0], -1)
    block, _ = qrows_route(cfg.maskgit, video_patch_shape)
    if block is not None:
        # the all-ones video mask of the reference is a no-op, dropped here
        mg = maskgit_apply(model.maskgit, ids, text_embed, video_patch_shape,
                           text_mask=text_mask, return_embeds=return_embeds,
                           weights="last_cross", self_attn_block=block,
                           precomputed_bias=(None if self_attn_bias is None
                                             else (self_attn_bias, None)),
                           compute_dtype=compute_dtype, plain=plain)
    else:
        mg = maskgit_apply(model.maskgit, ids, text_embed, video_patch_shape,
                           text_mask=text_mask, video_mask=torch.ones_like(ids, dtype=torch.bool),
                           return_embeds=return_embeds, weights="last_cross",
                           compute_dtype=compute_dtype, plain=plain)
    # drop the null key/value columns so token indices address text positions
    num_null = cfg.maskgit.transformer().attn_num_null_kv
    cross = mg.cross_attn[-1][..., num_null:]
    kw_attention = {kw: cross[..., torch.as_tensor(idx, device=cross.device)]
                    for kw, idx in keyword_indices.items()}
    return CTGenerateOutput(feature_map=mg.output, kw_attention=kw_attention,
                            video_patch_shape=video_patch_shape, codebook_ids=ids_grid,
                            cross_attention=cross)


@torch.no_grad()
def maskgit_bias_table(model: CTGenerate, video_patch_shape: Tuple[int, int, int],
                       dtype=None) -> torch.Tensor:
    """The [heads, n, n] MaskGit CPB table of this grid, built once per
    checkpoint and grid for serving (ctgenerate.py:136-149), in `dtype`
    (the serving compute dtype; default fp32)."""
    t, h, w = (int(d) for d in video_patch_shape)
    return continuous_pos_bias_grouped3(model.maskgit.continuous_pos_bias, t, h, w,
                                        dtype=_dtype(dtype) or torch.float32)


@torch.no_grad()
def ctgenerate_apply_batched(model: CTGenerate, ct_scans: torch.Tensor,
                             text_embed: torch.Tensor, text_mask: torch.Tensor, mesh=None,
                             bias_cache: Optional[dict] = None, compute_dtype="bfloat16",
                             plain: bool = False) -> CTGenerateOutput:
    """[b] scans with their longest-padded T5 embeddings in one forward
    (ctgenerate.py:152-217), MaskGit in bf16 by default. `bias_cache`, a
    caller-owned dict valid for one set of weights, holds the CPB table per
    (grid, dtype) on the q-row route under the cap, built on first use
    (over a mesh each rank keeps its own). Keyword spans are sliced from
    `cross_attention` per sample. With a data-axis `mesh` (collective:
    every rank passes the same global batch, on the mesh's device) each
    rank runs its rows of the batch padded to a multiple of the world with
    its last scan, and every output is gathered whole (see the module
    doc)."""
    b = ct_scans.shape[0]
    if check_mesh(mesh) is not None:
        if ct_scans.device != mesh.device:
            raise ValueError(f"the scans are on {ct_scans.device}, the mesh on {mesh.device}")
        pad = (-b) % mesh.world
        rows = (b + pad) // mesh.world
        ct_scans, text_embed, text_mask = (
            torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])[mesh.rank * rows:
                                                             (mesh.rank + 1) * rows]
            for x in (ct_scans, text_embed, text_mask))
    self_attn_bias = None
    if bias_cache is not None:
        grid = token_grid_shape(model.cfg.ctvit, ct_scans.shape)
        block, dense = qrows_route(model.cfg.maskgit, grid)
        if block is not None and dense:
            key = (*grid, str(compute_dtype))
            if key not in bias_cache:
                bias_cache[key] = maskgit_bias_table(model, grid, dtype=compute_dtype)
            self_attn_bias = bias_cache[key]
    out = ctgenerate_apply(model, ct_scans, text_embed, text_mask, {}, return_embeds=True,
                           self_attn_bias=self_attn_bias, compute_dtype=compute_dtype,
                           plain=plain)
    if mesh is None:
        return out
    whole = [collectives.gather_rows(t.contiguous(), mesh)[:b]
             for t in (out.feature_map, out.codebook_ids, out.cross_attention)]
    return out._replace(feature_map=whole[0], codebook_ids=whole[1], cross_attention=whole[2])


def keyword_heatmap(cross_attention: torch.Tensor, video_patch_shape: Tuple[int, int, int],
                    target_shape: Tuple[int, int, int]) -> torch.Tensor:
    """[1, heads, n, kw_tokens] -> [D, H, W] min-max normalised heatmap: the
    mean over heads and keyword tokens on the token grid, upsampled
    trilinearly (ctgenerate.py:220-230). F.interpolate with
    align_corners=False uses half-pixel centres and, upsampling, no
    antialiasing: the same as jax.image.resize(..., "trilinear") there."""
    w = cross_attention.float().mean(dim=1).mean(dim=-1)        # [1, n]
    vol = w.reshape(video_patch_shape)
    vol = F.interpolate(vol[None, None], size=tuple(target_shape), mode="trilinear",
                        align_corners=False)[0, 0]
    return (vol - vol.min()) / (vol.max() - vol.min() + 1e-8)
