"""Occlusion sensitivity: batched masked-forward sweep.

Counterpart of ct_clip_ut_tpu/attribution/occlusion.py (reference
visualizations.py:335-424, 1029-1082). A 3-D window (20 x
40 x 40 at stride 10 x 20 x 20 over a 240 x 480 x 480 volume: 23^3 =
12,167 windows) is filled with -1; the drop of the similarity score is the
window's importance; importances accumulate into a count-normalised,
min-max scaled, thresholded heatmap. As in the JAX package:

  * the text latents and the baseline score are computed once; a masked
    forward only needs the image tower, and one forward scores every
    pathology's latent at once (`occlusion_scores_multi`);
  * masked forwards run `chunk` windows as one batch; the JAX package's
    vmap over a chunk becomes a batch axis written out, each window's
    slices gathered at its own offsets and stacked;
  * the token shortcut: the patch embed is per patch (LN over patch_dim ->
    Linear -> LN over dim), so a window changes only the <= (kd, kh, kw)
    block of ViT patches it intersects; the clean volume is embedded once
    and each window re-embeds only that block;
  * the frame-sparse spatial recompute (the default): the spatial stack is
    frame-local except the PEG's causal depthwise conv (frame tau reads
    frames tau-2 .. tau), so a window touching wf token frames dirties at
    most wf + 2 l frames after l layers (2 -> 10 of 24 at flagship depth
    4). The clean per-layer inputs are cached once; per window each layer
    recomputes only its dirty slice, the 2-frame PEG halo read from the
    clean cache. Slices are clamped inside the volume, so they may hold
    clean frames, which recompute to their clean values;
  * the heatmap is assembled on the host, separably: the window sum per
    voxel and the coverage counts factor per axis (cumulative-sum
    differences), never a [D, H, W] count tensor;
  * with a data-axis mesh of more than one rank (parallel/mesh.py) the
    window list is split into contiguous per-rank runs, each rank sweeps
    its run, and the scores are gathered back in window order
    (`occlusion_scores_multi_sharded`; the reference's per-rank chunks and
    SUM reduce). Every rank must hold the same image and latents.

Every entry point runs under no_grad and full_fp32 (the PEG convs in full
fp32), through the matmul patch embed (`capture.parity_cfg`).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import OcclusionConfig
from ..models.ctclip import (CTCLIP, encode_image_latents_from_spatial_out,
                             encode_image_latents_from_tokens, text_latents_of)
from ..ops.attention import attention
from ..ops.layers import layernorm, peg_residual
from ..ops.posbias import continuous_pos_bias
from ..parallel import collectives
from ..parallel.mesh import check_mesh
from .capture import embed_volume, forward_only

# ---------------------------------------------------------------------------
# the token-level shortcut
# ---------------------------------------------------------------------------


def _patch_block_geometry(vol_shape, patch_q, occ_patch, stride=None):
    """Per-axis ViT-patch block size k (the most patches a window can
    intersect) and the token-grid shape. A stride that is a multiple of the
    ViT patch keeps every window origin patch-aligned, and the block
    tightens to ceil(p / q) (2 x 2 x 2 at the flagship geometry); unaligned
    origins can straddle one more patch per axis."""
    grid = tuple(v // q for v, q in zip(vol_shape, patch_q))
    k = []
    for ax, (p, q, g) in enumerate(zip(occ_patch, patch_q, grid)):
        aligned = stride is not None and stride[ax] % q == 0
        k.append(min((p - 1) // q + (1 if aligned else 2), g))
    return grid, tuple(k)


def _occluded_token_block(model: CTCLIP, image: torch.Tensor, origins: np.ndarray,
                          baseline: np.ndarray, patch_q, k, grid, occ_patch, fill):
    """Re-embed, for each window, the ViT-patch block its origin
    intersects: (block tokens [c, kd, kh, kw, dim], block grid origins [c,
    3] on the host). A baseline window is re-filled with the image's own
    content (a no-op), so the baseline runs through the same program."""
    blocks, g0s = [], []
    for origin, base in zip(origins, baseline):
        g0 = [min(max(int(origin[ax]) // patch_q[ax], 0), grid[ax] - k[ax]) for ax in range(3)]
        v0 = [g0[ax] * patch_q[ax] for ax in range(3)]
        block = image[0, :, v0[0]:v0[0] + k[0] * patch_q[0], v0[1]:v0[1] + k[1] * patch_q[1],
                      v0[2]:v0[2] + k[2] * patch_q[2]].clone()
        if not base:
            # the window lies inside the block by construction of g0 and k
            off = [int(origin[ax]) - v0[ax] for ax in range(3)]
            block[:, off[0]:off[0] + occ_patch[0], off[1]:off[1] + occ_patch[1],
                  off[2]:off[2] + occ_patch[2]] = fill
        blocks.append(block)
        g0s.append(g0)
    return embed_volume(model, torch.stack(blocks)), np.asarray(g0s, np.int64)


# ---------------------------------------------------------------------------
# the frame-sparse spatial recompute
# ---------------------------------------------------------------------------


def _spatial_clean_stack(model: CTCLIP, tokens: torch.Tensor, attn_bias: torch.Tensor,
                         plain: bool = False):
    """The clean spatial stack, keeping each layer's input: (layer_inputs,
    spatial_out), layer_inputs[l] the [1, t, h, w, d] input to spatial
    layer l, spatial_out the output grid after norm_out. Each block is PEG
    (the F.conv3d form) -> self-attention -> FF, all residual, as the JAX
    package's `_spatial_block_full` applies it."""
    tf = model.visual_transformer.enc_spatial_transformer
    b, t, h, w, d = tokens.shape
    layer_inputs = []
    x = tokens.reshape(b * t, h * w, d)
    for peg, attn, _, ff in tf.layers:
        layer_inputs.append(x.reshape(b, t, h, w, d))
        x = peg_residual(peg.dsconv.weight, peg.dsconv.bias, x, (b, t, h, w), peg.causal)
        x, _ = attention(attn, x, attn_bias=attn_bias, residual=True, plain=plain)
        x = ff(x, residual=True, plain=plain)
    return layer_inputs, layernorm(x, tf.norm_out.gamma).reshape(b, t, h, w, d)


def _spatial_block_slice(layer, xh: torch.Tensor, attn_bias: torch.Tensor,
                         plain: bool = False) -> torch.Tensor:
    """The same block on frame slices: xh [c, m + 2, h, w, d] holds the m
    output frames' inputs after 2 causal-PEG halo frames; returns the [c,
    m, h, w, d] block output of those m frames. The PEG conv runs VALID
    over frames (the halo replaces the causal pad); attention and FF are
    frame-local."""
    peg, attn, _, ff = layer
    c, mp2, h, w, d = xh.shape
    m = mp2 - 2
    v = xh.permute(0, 4, 1, 2, 3).contiguous()               # [c, d, m + 2, h, w]
    out = F.conv3d(F.pad(v, (1, 1, 1, 1)), peg.dsconv.weight.to(xh.dtype), groups=d)
    out = out.float() + peg.dsconv.bias.float()[:, None, None, None] + v[:, :, 2:].float()
    x = out.to(xh.dtype).permute(0, 2, 3, 4, 1).reshape(c * m, h * w, d)
    x, _ = attention(attn, x, attn_bias=attn_bias, residual=True, plain=plain)
    x = ff(x, residual=True, plain=plain)
    return x.reshape(c, m, h, w, d)


def _frames(x: torch.Tensor, starts: np.ndarray, m: int) -> torch.Tensor:
    """[c, m, ...]: frames starts[i] .. starts[i] + m of x [1, T, ...] for
    each window i, one gather."""
    idx = torch.as_tensor(starts[:, None] + np.arange(m)[None], device=x.device)
    return x[0][idx]


def _splice_frames(dst: torch.Tensor, src: torch.Tensor, starts: np.ndarray) -> torch.Tensor:
    """dst [c, T, ...] with src [c, m, ...] written at frames starts[i] ..
    of window i, in place, one scatter."""
    c, m = src.shape[:2]
    rows = torch.arange(c, device=dst.device)[:, None]
    cols = torch.as_tensor(starts[:, None] + np.arange(m)[None], device=dst.device)
    dst[rows, cols] = src
    return dst


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def window_grid(shape_dhw: Tuple[int, int, int], patch, stride) -> np.ndarray:
    """[N, 3] int32 window origins, d-major like the reference's nested
    comprehension (visualizations.py:340-349)."""
    D, H, W = shape_dhw
    axes = [np.arange(0, n - p + 1, s) for n, p, s in zip((D, H, W), patch, stride)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


def _occlude(image: torch.Tensor, origin, patch, fill: float,
             is_baseline: bool = False) -> torch.Tensor:
    """A copy of the [1, 1, D, H, W] image with the [pd, ph, pw] window at
    `origin` filled with `fill` (is_baseline: left as it is, so the
    baseline runs through the same program as every masked forward)."""
    out = image.clone()
    if not is_baseline:
        d, h, w = (int(o) for o in origin)
        out[:, :, d:d + patch[0], h:h + patch[1], w:w + patch[2]] = fill
    return out


def _sweep_scores(model: CTCLIP, image: torch.Tensor, txt: torch.Tensor, coords,
                  occ: OcclusionConfig, chunk: int, token_shortcut: bool,
                  frame_sparse: bool = False, plain: bool = False) -> torch.Tensor:
    """The masked-forward sweep. `txt` is [K, dim_latent]; returns [N + 1,
    K] scores, the baseline (a no-op window at the first origin) at row 0,
    computed by the same chunked program as every masked forward."""
    vit = model.visual_transformer
    cfg = vit.cfg
    temp = model.temperature.exp()
    txt = txt.float()
    patch_q = (cfg.temporal_patch_size, cfg.patch_size, cfg.patch_size)
    grid, kblk = _patch_block_geometry(tuple(image.shape[-3:]), patch_q, occ.patch_size,
                                       occ.stride)
    coords = np.asarray(coords, np.int64).reshape(-1, 3)

    def token_blocks(origins, flags):
        return _occluded_token_block(model, image, origins, flags, patch_q, kblk, grid,
                                     occ.patch_size, occ.fill_value)

    if token_shortcut and frame_sparse:
        tf = vit.enc_spatial_transformer
        if not tf.cfg.peg_causal:
            raise ValueError("the frame-sparse recompute assumes the causal PEG pad")
        clean_tokens = embed_volume(model, image)               # [1, t, h, w, d]
        attn_bias = continuous_pos_bias(vit.spatial_rel_pos_bias, cfg.patch_height,
                                        cfg.patch_width)
        layer_inputs, clean_sp_out = _spatial_clean_stack(model, clean_tokens, attn_bias, plain)
        _, t, h, w, d = clean_tokens.shape
        # 2 leading zero frames stand in for the causal PEG pad: slice starts stay >= 0
        zeros2 = clean_tokens.new_zeros((1, 2, h, w, d))
        padded_inputs = [torch.cat([zeros2, xi], dim=1) for xi in layer_inputs]
        wf = kblk[0]                       # window frames at the layer-0 input

        def latents_of(origins, flags):
            blk, g0 = token_blocks(origins, flags)
            f0 = g0[:, 0]
            # layer 0's dirty slices: clean frames with the patch block spliced in
            dirty = _frames(layer_inputs[0], f0, wf)
            for i, (gh, gw) in enumerate(g0[:, 1:]):
                dirty[i, :, gh:gh + kblk[1], gw:gw + kblk[2]] = blk[i]
            o_d = f0
            for layer_i, layer in enumerate(tf.layers):
                m = min(wf + 2 * (layer_i + 1), t)
                o = np.clip(f0, 0, t - m)
                # input frames [o - 2, o + m) = padded [o, o + m + 2), the dirty ones spliced
                xh = _splice_frames(_frames(padded_inputs[layer_i], o, m + 2), dirty, o_d - o + 2)
                dirty = _spatial_block_slice(layer, xh, attn_bias, plain)
                o_d = o
            dirty = layernorm(dirty, tf.norm_out.gamma)
            out_grid = _splice_frames(clean_sp_out.expand(len(f0), -1, -1, -1, -1).clone(),
                                      dirty, o_d)
            return encode_image_latents_from_spatial_out(model, out_grid, plain=plain)
    elif token_shortcut:
        clean_tokens = embed_volume(model, image)               # [1, t, h, w, d]
        kd, kh, kw = kblk

        def latents_of(origins, flags):
            blk, g0 = token_blocks(origins, flags)
            tok = clean_tokens.expand(len(g0), -1, -1, -1, -1).clone()
            for i, (a, b, c) in enumerate(g0):
                tok[i, a:a + kd, b:b + kh, c:c + kw] = blk[i]
            return encode_image_latents_from_tokens(model, tok, plain=plain)[0]
    else:
        def latents_of(origins, flags):
            imgs = torch.cat([_occlude(image, o, occ.patch_size, occ.fill_value, bool(f))
                              for o, f in zip(origins, flags)])
            return encode_image_latents_from_tokens(model, embed_volume(model, imgs),
                                                    plain=plain)[0]

    # entry 0 is the baseline (a no-op occlusion at the first window origin)
    coords_all = np.concatenate([coords[:1], coords], axis=0)
    is_base = np.zeros((coords_all.shape[0],), bool)
    is_base[0] = True
    scores = [(latents_of(coords_all[lo:lo + chunk], is_base[lo:lo + chunk]).float() @ txt.t())
              * temp for lo in range(0, coords_all.shape[0], chunk)]
    return torch.cat(scores)


@forward_only
def occlusion_scores_multi(model: CTCLIP, image: torch.Tensor, text_latents: torch.Tensor,
                           coords, *, occ: OcclusionConfig = OcclusionConfig(), chunk: int = 8,
                           token_shortcut: bool = True, frame_sparse: bool = True,
                           plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-pathology sweep: (original scores [K], scores [N, K]) on the
    image's device. A window's image latent does not depend on the text, so
    one masked forward scores every latent of text_latents [K, dim_latent]
    (the reference re-runs the whole sweep per pathology). token_shortcut=
    False runs full masked forwards (the serial-oracle path of the parity
    tests) in chunks of at most 2 volumes, as the JAX package does;
    frame_sparse=False re-runs the whole spatial stack per window (the dense
    shortcut). plain=True runs every kernel's plain version."""
    if not token_shortcut:
        chunk = min(chunk, 2)
    scores = _sweep_scores(model, image, text_latents, coords, occ, chunk, token_shortcut,
                           frame_sparse, plain)
    return scores[0], scores[1:]


def occlusion_scores(model: CTCLIP, image: torch.Tensor, text_latent: torch.Tensor, coords, *,
                     occ: OcclusionConfig = OcclusionConfig(), chunk: int = 8,
                     token_shortcut: bool = True, frame_sparse: bool = True,
                     plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(original score, occluded scores [N]) for one [dim_latent] latent
    (prompt, report or diff embedding): score = <image latent, text latent>
    * exp(temperature), the reference's sim[0, 0] (visualizations.py:375,
    388). The modes as `occlusion_scores_multi`."""
    orig, scores = occlusion_scores_multi(model, image, text_latent[None], coords, occ=occ,
                                          chunk=chunk, token_shortcut=token_shortcut,
                                          frame_sparse=frame_sparse, plain=plain)
    return orig[0], scores[:, 0]


def occlusion_scores_slabbed(model: CTCLIP, image: torch.Tensor, text_latents: torch.Tensor,
                             coords, *, occ: OcclusionConfig = OcclusionConfig(),
                             chunk: int = 8, slab: int = 2048,
                             plain: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """`occlusion_scores_multi` in host-level slabs of `slab` windows, each
    slab's scores copied to the host as it ends: (originals [K], scores [N,
    K]) as float64 numpy arrays. Each slab re-derives the clean caches (about
    one dense forward, against 2048 masked ones); the last slab may be
    shorter (the JAX package pads it with no-op windows to keep one
    compiled shape)."""
    coords = np.asarray(coords).reshape(-1, 3)
    originals, parts = None, []
    for lo in range(0, max(coords.shape[0], 1), slab):
        o, s = occlusion_scores_multi(model, image, text_latents, coords[lo:lo + slab], occ=occ,
                                      chunk=chunk, plain=plain)
        if originals is None:
            originals = o.double().cpu().numpy()
        parts.append(s.double().cpu().numpy())
    return originals, np.concatenate(parts, axis=0)


# ---------------------------------------------------------------------------
# the heatmap, assembled on the host
# ---------------------------------------------------------------------------


def _expand_axis(out: np.ndarray, ax: int, n: int, p: int, s: int) -> np.ndarray:
    """Window -> voxel sum along one axis: `out` has windows on axis `ax`;
    returns it with that axis expanded to `n` voxels, each the sum over the
    windows covering it. Voxel i is covered by windows g with g s <= i < g s
    + p, i.e. g in (floor((i - p) / s), floor(i / s)]; with the cumulative
    sum S along the window axis the range is S[hi] - S[lo]."""
    g = out.shape[ax]
    i = np.arange(n)
    hi = np.clip(i // s, -1, g - 1)                  # the last covering window
    lo = np.clip((i - p) // s, -1, g - 1)            # the last window NOT covering
    s_cum = np.cumsum(out, axis=ax, dtype=out.dtype)
    pad_shape = list(out.shape)
    pad_shape[ax] = 1
    s_pad = np.concatenate([np.zeros(pad_shape, out.dtype), s_cum], axis=ax)   # S[-1] = 0
    return np.take(s_pad, hi + 1, axis=ax) - np.take(s_pad, lo + 1, axis=ax)


def _axis_cover_counts(n: int, g: int, p: int, s: int) -> np.ndarray:
    """[n] fp32: how many windows cover each voxel along one axis, with the
    reference's count == 0 -> 1 guard (visualizations.py:411): an uncovered
    voxel holds 0 importance, and dividing by 1 keeps it. The 3-D count map
    is the outer product of the per-axis counts."""
    c = _expand_axis(np.ones((g,), np.float32), 0, n, p, s)
    c[c == 0] = 1.0
    return c


def _window_sum_to_voxels(values, grid_shape, vol_shape, patch, stride) -> np.ndarray:
    """Scatter-add of per-window values into voxel space (the reference's
    accumulation, visualizations.py:391-392), as three separable
    cumulative-sum expansions in fp32."""
    out = np.asarray(values, np.float32).reshape(grid_shape)
    for ax in range(3):
        out = _expand_axis(out, ax, vol_shape[ax], patch[ax], stride[ax])
    return out


def _divide_axis_counts(heat: np.ndarray, grid_shape, vol_shape, patch, stride) -> None:
    """heat /= count in place, by the per-axis coverage counts (three
    broadcast divides instead of a [D, H, W] count tensor)."""
    for ax in range(3):
        c = _axis_cover_counts(vol_shape[ax], grid_shape[ax], patch[ax], stride[ax])
        shape = [1, 1, 1]
        shape[ax] = vol_shape[ax]
        heat /= c.reshape(shape)


def occlusion_scores_multi_sharded(model: CTCLIP, image: torch.Tensor,
                                   text_latents: torch.Tensor, coords, mesh, *,
                                   occ: OcclusionConfig = OcclusionConfig(), chunk: int = 8,
                                   slab: int = 2048,
                                   plain: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """The window-sharded multi-pathology sweep (occlusion.py:568-616):
    (originals [K], scores [N, K]) as float64 numpy arrays, the same on
    every rank. The window list, padded with no-op (0, 0, 0) windows to a
    multiple of the ranks, is split into contiguous runs; rank r sweeps run
    r in slabs of `slab` windows (`occlusion_scores_slabbed`), and the runs'
    scores are gathered back in window order. The originals are rank 0's
    (its run starts at the first window, as the single-process sweep's
    baseline does)."""
    coords = np.asarray(coords).reshape(-1, 3)
    n = coords.shape[0]
    pad = (-n) % mesh.world
    if pad:
        coords = np.concatenate([coords, np.zeros((pad, 3), coords.dtype)], axis=0)
    per = coords.shape[0] // mesh.world
    originals, scores = occlusion_scores_slabbed(
        model, image, text_latents, coords[mesh.rank * per:(mesh.rank + 1) * per], occ=occ,
        chunk=chunk, slab=slab, plain=plain)
    dev = mesh.device
    scores = collectives.gather_rows(torch.as_tensor(scores, device=dev), mesh)
    originals = collectives.broadcast(torch.as_tensor(originals, device=dev), mesh)
    return originals.cpu().numpy(), scores.cpu().numpy()[:n]


def occlusion_scores_sharded(model: CTCLIP, image: torch.Tensor, text_latent: torch.Tensor,
                             coords, mesh, *, occ: OcclusionConfig = OcclusionConfig(),
                             chunk: int = 8, plain: bool = False) -> Tuple[float, np.ndarray]:
    """(original score, scores [N]) of one [dim_latent] latent over the
    window-sharded sweep (occlusion.py:544-565)."""
    originals, scores = occlusion_scores_multi_sharded(model, image, text_latent[None], coords,
                                                       mesh, occ=occ, chunk=chunk, plain=plain)
    return float(originals[0]), scores[:, 0]


def _sharded(mesh) -> bool:
    """Whether a sweep takes the window-sharded route (occlusion.py:461-463):
    a DataMesh of more than one rank (anything but a DataMesh raises)."""
    return check_mesh(mesh) is not None and mesh.world > 1


def _heatmap(importance: np.ndarray, grid_shape, vol_shape, occ: OcclusionConfig) -> np.ndarray:
    """The count-normalised, min-max scaled, thresholded [D, H, W] map of
    per-window importances (reference visualizations.py:379-424)."""
    heat = _window_sum_to_voxels(importance, grid_shape, vol_shape, occ.patch_size, occ.stride)
    _divide_axis_counts(heat, grid_shape, vol_shape, occ.patch_size, occ.stride)
    heat = (heat - heat.min()) / (heat.max() - heat.min() + 1e-8)
    # the reference then trilinear-resizes to the SAME shape: an identity, skipped
    heat[heat < occ.threshold] = 0.0
    return heat.astype(np.float32)


def occlusion_heatmaps_multi(model: CTCLIP, image: torch.Tensor, text_latents: torch.Tensor, *,
                             occ: OcclusionConfig = OcclusionConfig(), chunk: int = 8,
                             mesh=None, plain: bool = False) -> list:
    """K [D, H, W] numpy heatmaps (before rot90) from ONE window sweep (see
    `occlusion_scores_multi`): importance = relu(original - occluded),
    accumulated over windows, count-normalised, min-max scaled,
    thresholded. With a `mesh` of more than one rank the sweep is
    window-sharded (`occlusion_scores_multi_sharded`) and every rank
    returns the same maps."""
    vol = tuple(int(s) for s in image.shape[-3:])
    coords = window_grid(vol, occ.patch_size, occ.stride)
    grid_shape = tuple((n - p) // s + 1 for n, p, s in zip(vol, occ.patch_size, occ.stride))
    sweep = (functools.partial(occlusion_scores_multi_sharded, mesh=mesh) if _sharded(mesh)
             else occlusion_scores_slabbed)
    originals, scores = sweep(model, image, text_latents, coords, occ=occ, chunk=chunk,
                              plain=plain)
    return [_heatmap(np.maximum(originals[k] - scores[:, k], 0.0), grid_shape, vol, occ)
            for k in range(scores.shape[1])]


def occlusion_heatmap(model: CTCLIP, image: torch.Tensor, text_latent: torch.Tensor, *,
                      occ: OcclusionConfig = OcclusionConfig(), chunk: int = 8, mesh=None,
                      plain: bool = False) -> np.ndarray:
    """The [D, H, W] numpy heatmap of one [dim_latent] latent."""
    return occlusion_heatmaps_multi(model, image, text_latent[None], occ=occ, chunk=chunk,
                                    mesh=mesh, plain=plain)[0]


@forward_only
def report_text_latent(model: CTCLIP, text_tokens, *, plain: bool = False) -> torch.Tensor:
    """The [dim_latent] latent of a tokenised report or prompt."""
    return text_latents_of(model, text_tokens, plain=plain)[0]


@forward_only
def diff_embedding_latent(model: CTCLIP, diff_embed: torch.Tensor) -> torch.Tensor:
    """The [dim_latent] latent of a precomputed 768-d pathology diff
    embedding (the text-embedding bypass, reference ctclip.py:107,
    visualizations.py:1030-1043)."""
    return text_latents_of(model, None, diff_embed[None])[0]
