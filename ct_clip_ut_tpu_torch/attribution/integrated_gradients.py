"""Integrated Gradients over the CT volume.

Counterpart of ct_clip_ut_tpu/attribution/integrated_gradients.py
(reference visualizations.py:851-910). Baseline the all-ones volume, 50
interpolation steps from the baseline to the input, the gradient of the
per-sample similarity score at each step, IG = relu(diff * avg_grads),
shift-max normalised, the top decile kept, contrast-amplified with **0.05,
renormalised. fp32 throughout.

The whole computation runs in PATCH SPACE, as the JAX package's: `patchify`
is a bijective pixel permutation, so the gradient with respect to the
patches is the permutation of the gradient with respect to the image, the
elementwise ops commute with it, and the global statistics (min, max,
quantile) do not see it; the map is un-permuted once on the host
(ctvit.unpatchify_np). The text tower runs once per map, outside the steps
(`_hoist_text_tower`).

Where the JAX package takes a `lax.scan` over chunks of `chunk` alphas,
each a vmapped VJP, the port takes one batch of `chunk` interpolated patch
tensors per step of a Python loop and the gradient of sim[:, 0].sum() with
respect to them: sim[i, 0] depends on sample i alone (LayerNorm per token,
attention per sequence, the VQ frozen), so each sample's gradient is its
own. The last chunk may be ragged (steps need not divide by chunk). The
gradients add into one running fp32 sum. On the card the backward runs the
fp32 data-gradient chains: a map launches attn_block_bwd_f32 and
attn_packed_bwd_f32 4 times a chunk and geglu_ff_bwd_f32 8 times.

Over a data-axis mesh (`integrated_gradients_sharded`, JAX :113-190) the
alphas are split over the ranks: the same linspace, padded with zero
weights to a multiple of world * chunk and cut into each rank's contiguous
share, as JAX's shard_map takes them. Each rank runs its chunks through
the same body (`_ig_chunk_sum`; steps of zero weight are not run: they add
nothing), the per-rank sums are summed over the ranks (a rank whose whole
share is padding adds zeros) and every rank normalises the same average,
so every rank holds the map. It equals one process's map but for the
order of the sum over the chunks.

The quantile is jnp.quantile's default (linear interpolation at position
q (n - 1)) over a sort: torch.quantile refuses more than 2^24 elements,
and the flagship map has 55,296,000. The finished map goes to the host as
a bitmask of its nonzeros plus their values in f16 (`_ig_pack` /
`_ig_densify_np`), 18 MB instead of 221 MB.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from ..config import CTCLIPConfig
from ..models.bert import bert_cls
from ..models.ctclip import CTCLIP
from ..models.ctvit import patchify, unpatchify_np
from ..parallel import collectives
from ..parallel.mesh import check_mesh
from .capture import scored_forward, with_grad


def _hoist_text_tower(model: CTCLIP, text_tokens, text_embeds, plain: bool = False):
    """(text_tokens, text_embeds) with the BERT tower folded into the CLS
    embeddings [b, hidden], fp32, once per map (integrated_gradients.py:79-97):
    the score differentiates with respect to the patches only, and
    `text_embeds` is ctclip_apply's CLS-level bypass."""
    if text_embeds is not None or text_tokens is None:
        return text_tokens, text_embeds
    with torch.no_grad():
        cls = bert_cls(model.text_transformer, text_tokens["input_ids"],
                       text_tokens.get("attention_mask"), text_tokens.get("token_type_ids"),
                       compute_dtype=torch.float32, plain=plain)
    return None, cls


def _ig_setup(model: CTCLIP, text_tokens, image: torch.Tensor, text_embeds, steps: int,
              baseline_value: float, plain: bool) -> tuple:
    """(text_embeds with the text tower hoisted, baseline and diff [1, t, h,
    w, patch_dim] fp32 in patch space, the alphas linspace(0, 1, steps) on
    the image's device)."""
    cfg = model.visual_transformer.cfg
    _, text_embeds = _hoist_text_tower(model, text_tokens, text_embeds, plain)
    patches = patchify(image.float(), cfg.patch_size, cfg.temporal_patch_size)  # [1, t, h, w, p]
    # patchify(const) == const: the all-ones baseline is exact in patch space
    baseline = torch.full_like(patches, baseline_value)
    alphas = torch.from_numpy(np.linspace(0.0, 1.0, steps, dtype=np.float32)).to(image.device)
    return text_embeds, baseline, patches - baseline, alphas


def _ig_chunk_sum(model: CTCLIP, text_embeds, baseline, diff, a: torch.Tensor,
                  plain: bool) -> torch.Tensor:
    """The score's gradient at baseline + a * diff for each alpha of the
    chunk `a`, summed over the chunk: [1, t, h, w, patch_dim]."""
    batch = (baseline + a.reshape(-1, 1, 1, 1, 1) * diff).requires_grad_(True)
    _, out = scored_forward(model, None, batch, text_embeds, prepatchified=True, plain=plain)
    (g,) = torch.autograd.grad(out.sim_matrix[:, 0].sum(), batch)
    return g.sum(dim=0, keepdim=True)


@with_grad
def _ig_avg_grads(model: CTCLIP, text_tokens, image: torch.Tensor, text_embeds=None, *,
                  baseline_value: float = 1.0, steps: int = 50, chunk: int = 5,
                  plain: bool = False) -> tuple:
    """(diff, the score's gradient averaged over the steps), both [1, t, h,
    w, patch_dim] fp32 in patch space on the image's device: the Riemann
    sum the map is made of."""
    text_embeds, baseline, diff, alphas = _ig_setup(model, text_tokens, image, text_embeds,
                                                    steps, baseline_value, plain)
    sum_grads = torch.zeros_like(diff)
    for lo in range(0, steps, chunk):
        sum_grads += _ig_chunk_sum(model, text_embeds, baseline, diff, alphas[lo:lo + chunk],
                                   plain)
    return diff, sum_grads / steps


def rank_alphas(steps: int, chunk: int, world: int, rank: int) -> list:
    """rank's chunks of step indices: the `steps` alphas padded with zero
    weights to a multiple of world * chunk, rank's contiguous share of
    them in chunks of `chunk` (JAX :142-145), each chunk's padding dropped
    (and a chunk of padding alone); a rank may get none."""
    per = -(-steps // (world * chunk)) * chunk
    lo = rank * per
    return [list(range(c, min(c + chunk, steps))) for c in range(lo, lo + per, chunk)
            if c < steps]


@with_grad
def _ig_avg_grads_sharded(model: CTCLIP, text_tokens, image: torch.Tensor, mesh,
                          text_embeds=None, *, baseline_value: float = 1.0, steps: int = 50,
                          chunk: int = 5, plain: bool = False) -> tuple:
    """`_ig_avg_grads` with the steps split over `mesh` (`rank_alphas`):
    this rank's chunk sums, then their sum over the ranks."""
    text_embeds, baseline, diff, alphas = _ig_setup(model, text_tokens, image, text_embeds,
                                                    steps, baseline_value, plain)
    sum_grads = torch.zeros_like(diff)
    for idx in rank_alphas(steps, chunk, mesh.world, mesh.rank):
        sum_grads += _ig_chunk_sum(model, text_embeds, baseline, diff, alphas[idx[0]:idx[-1] + 1],
                                   plain)
    return diff, collectives.psum(sum_grads, mesh) / steps


def _ig_patch_space(model: CTCLIP, text_tokens, image: torch.Tensor, text_embeds=None, *,
                    baseline_value: float = 1.0, steps: int = 50, chunk: int = 5,
                    quantile: float = 0.90, contrast: float = 0.05,
                    plain: bool = False) -> torch.Tensor:
    """The IG saliency in patch space, dense [t, h, w, patch_dim] fp32 on
    the image's device."""
    diff, avg = _ig_avg_grads(model, text_tokens, image, text_embeds,
                              baseline_value=baseline_value, steps=steps, chunk=chunk,
                              plain=plain)
    return _ig_normalize(diff, avg, quantile, contrast)


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """jnp.quantile(x, q) (linear interpolation at position q (n - 1), the
    position in float64) over a sort of every element."""
    flat = torch.sort(x.reshape(-1)).values
    pos = q * (flat.numel() - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, flat.numel() - 1)
    return flat[lo] + (flat[hi] - flat[lo]) * (pos - lo)


def _ig_normalize(diff: torch.Tensor, avg_grads: torch.Tensor, quantile: float,
                  contrast: float) -> torch.Tensor:
    """relu(diff * avg_grads), shift-max normalised (the pre-shift max, as
    the reference writes it, visualizations.py:882), the values under the
    quantile zeroed, ** contrast, renormalised (integrated_gradients.py:101-113)."""
    ig = torch.relu((diff * avg_grads)[0])                 # [t, h, w, patch_dim]
    ig = (ig - ig.min()) / (ig.max() + 1e-8)
    ig = torch.where(ig >= _quantile(ig, quantile), ig, torch.zeros_like(ig))
    ig = ig ** contrast                                    # 0 ** 0.05 == 0
    return ig / (ig.max() + 1e-8)


def _ig_pack(ig: torch.Tensor, k: int):
    """The finished map's transport encoding, with no host synchronisation
    (integrated_gradients.py:195-225): (packed nonzero bitmask uint8
    [ceil(n / 8)], big-endian as np.packbits; the nonzero values in flat
    order as f16 [k]; m, their true count, a device int64). Values past k
    are dropped; the caller falls back to the dense map when m > k."""
    flat = ig.reshape(-1)
    mask = flat > 0
    m = mask.sum()
    # order-preserving compaction: nonzero j goes to slot rank(j), zeros to the drop slot k
    dest = torch.where(mask, torch.cumsum(mask, 0) - 1, torch.full_like(m, k))
    vals = torch.zeros((k + 1,), dtype=torch.float32, device=ig.device)
    vals.scatter_(0, dest.clamp_max(k), flat)
    bits = torch.nn.functional.pad(mask.to(torch.uint8), (0, -mask.numel() % 8)).reshape(-1, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=ig.device)
    packed = (bits * weights).sum(dim=1, dtype=torch.uint8)
    return packed, vals[:k].half(), m


def _ig_densify_np(cfg: CTCLIPConfig, image_shape, packed, vals, m: int,
                   ig_dev: torch.Tensor) -> np.ndarray:
    """The host decode of `_ig_pack`'s output into the [D, H, W] voxel map
    (integrated_gradients.py:228-247)."""
    _, _, D, H, W = image_shape
    vit = cfg.ctvit
    t, h, w = D // vit.temporal_patch_size, H // vit.patch_size, W // vit.patch_size
    patch_dim = vit.temporal_patch_size * vit.patch_size * vit.patch_size
    n = t * h * w * patch_dim
    if m > vals.shape[0]:
        # the survivors outnumber the sized buffer (only off the reference
        # q90 threshold): correctness over transport savings
        dense = ig_dev.float().cpu().numpy().reshape(-1)[:n]
    else:
        pos = np.flatnonzero(np.unpackbits(np.asarray(packed))[:n])
        dense = np.zeros((n,), np.float32)
        dense[pos] = np.asarray(vals, np.float32)[:m]
    return unpatchify_np(dense.reshape(t, h, w, patch_dim), vit.patch_size,
                         vit.temporal_patch_size)


def _ig_transport_k(cfg: CTCLIPConfig, image_shape, quantile: float) -> int:
    """The value buffer's size: the top decile with 2% slack for quantile
    ties (integrated_gradients.py:250-256)."""
    _, _, D, H, W = image_shape
    vit = cfg.ctvit
    n = ((D // vit.temporal_patch_size) * (H // vit.patch_size) * (W // vit.patch_size)
         * vit.temporal_patch_size * vit.patch_size ** 2)
    return min(n, int(n * (1.0 - quantile) * 1.02) + 16)


def _ig_fetch(model: CTCLIP, text_tokens, image: torch.Tensor, text_embeds, kw: dict,
              mesh=None):
    """Start one map (its steps split over `mesh` where given): its device
    work queued, its packed transport copied to the host asynchronously
    (pinned memory where the image is on the card). Returns the pending
    entry `_ig_finish` completes."""
    if mesh is None:
        ig = _ig_patch_space(model, text_tokens, image, text_embeds, **kw)
    else:
        grad_kw = {k: v for k, v in kw.items() if k not in ("quantile", "contrast")}
        diff, avg = _ig_avg_grads_sharded(model, text_tokens, image, mesh, text_embeds,
                                          **grad_kw)
        ig = _ig_normalize(diff, avg, kw["quantile"], kw["contrast"])
    packed, vals, m = _ig_pack(ig, _ig_transport_k(model.cfg, image.shape, kw["quantile"]))
    done = None
    if image.device.type == "cuda":
        packed, vals, m = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                           .copy_(t, non_blocking=True) for t in (packed, vals, m))
        done = torch.cuda.Event()
        done.record()
    return tuple(image.shape), packed, vals, m, ig, done


def _ig_finish(model: CTCLIP, entry) -> np.ndarray:
    shape, packed, vals, m, ig, done = entry
    if done is not None:
        done.synchronize()
    return _ig_densify_np(model.cfg, shape, packed.numpy(), vals.numpy(), int(m), ig)


def integrated_gradients(model: CTCLIP, text_tokens, image: torch.Tensor, *,
                         text_embeds=None, baseline_value: float = 1.0, steps: int = 50,
                         chunk: int = 5, quantile: float = 0.90, contrast: float = 0.05,
                         plain: bool = False) -> np.ndarray:
    """[D, H, W] numpy IG saliency (before rot90) of a batch-1 image [1, 1,
    D, H, W]. plain=True runs every kernel's plain version."""
    kw = dict(baseline_value=baseline_value, steps=steps, chunk=chunk, quantile=quantile,
              contrast=contrast, plain=plain)
    return _ig_finish(model, _ig_fetch(model, text_tokens, image, text_embeds, kw))


def integrated_gradients_pipelined(model: CTCLIP, items: Iterable, *,
                                   text_embeds=None, baseline_value: float = 1.0,
                                   steps: int = 50, chunk: int = 5, quantile: float = 0.90,
                                   contrast: float = 0.05,
                                   plain: bool = False) -> Iterator[np.ndarray]:
    """IG maps for a sequence of (text_tokens, image) items, in order, with
    each map's copy to the host and densify overlapped with the next map's
    device work (as rollout_maps_pipelined): item k + 1 is queued on the card
    before item k is decoded, so a map costs max(device, host) rather than
    their sum."""
    kw = dict(baseline_value=baseline_value, steps=steps, chunk=chunk, quantile=quantile,
              contrast=contrast, plain=plain)
    pending = None
    for text_tokens, image in items:
        entry = _ig_fetch(model, text_tokens, image, text_embeds, kw)
        if pending is not None:
            yield _ig_finish(model, pending)
        pending = entry
    if pending is not None:
        yield _ig_finish(model, pending)


def integrated_gradients_sharded(model: CTCLIP, text_tokens, image: torch.Tensor, mesh, *,
                                 text_embeds=None, baseline_value: float = 1.0, steps: int = 50,
                                 chunk: int = 5, quantile: float = 0.90, contrast: float = 0.05,
                                 plain: bool = False) -> np.ndarray:
    """`integrated_gradients` with the interpolation steps split over the
    data-axis `mesh` (parallel.mesh.DataMesh; see the module doc):
    collective, every rank calls it with the same sample and every rank
    gets the [D, H, W] map. The image must lie on the mesh's device."""
    if check_mesh(mesh) is None:
        raise TypeError("integrated_gradients_sharded needs a parallel.mesh.DataMesh")
    if image.device != mesh.device:
        raise ValueError(f"the image is on {image.device}, the mesh on {mesh.device}")
    kw = dict(baseline_value=baseline_value, steps=steps, chunk=chunk, quantile=quantile,
              contrast=contrast, plain=plain)
    return _ig_finish(model, _ig_fetch(model, text_tokens, image, text_embeds, kw, mesh))
