"""The attribution suite's runner: the dataset loop, the five methods and
their artifacts.

Counterpart of ct_clip_ut_tpu/attribution/suite.py (the reference's
`Visualizations` class). Each method writes its raw `.npy` maps, and with
`render_gifs` its GIFs (utils/visualizations), under an indexed run
directory of the results folder, with the JAX package's file names:

  raw_attention_grids/<k>/<scan>_spatial.npy, _temporal.npy
  attention_rollout/<k>/<scan>_spatial.npy, _temporal.npy
  integrated_gradients/<k>/<scan>.npy
  grad_cam/<k>/<scan>_<map>.npy (spatial, temporal, spatial_ff,
      temporal_ff, combined, vq)
  occlusion/<k>/<scan>_<prompt>_heatmap.npy, or in the text-embeds mode
      <scan>_<patch>_<stride>_<prompt>_heatmaps.npy (a pickled dict)

every map rotated by `rot90_ct`. `visualize(**flags)` runs the methods
that are flagged, in the order given; a dict flag is occlusion's keywords
(occ, use_text_embeds, prompt). Rollout and integrated gradients run
their worklists pipelined (`rollout_maps_pipelined`,
`integrated_gradients_pipelined`). The text-embeds occlusion scores every
positive pathology that has a diff embedding in one window sweep.

On one card every map is computed and written by the one process. With a
data-axis `mesh` of more than one rank (parallel/mesh.py; every rank runs
the suite over the same dataset), occlusion and integrated gradients are
collective: every rank takes rank 0's sample (`_broadcast_sample`, the
reference's visualizations.py:296-318), occlusion sweeps each rank's run
of the windows and integrated gradients each rank's share of the
interpolation steps (`integrated_gradients_sharded`), and rank 0 writes
every sample's map, once. (The JAX suite's per-process mode keeps only the
first process's IG maps, suite.py:173; here none is dropped.) Raw
attention, rollout and Grad-CAM split the samples over the ranks,
interleaved as the zero-shot sampler does (sample i on rank i % world,
read by index where the dataset has one), and each rank writes its own
samples' maps: together they write every map the one-card suite writes,
each sample's in a run directory of its own, numbered in the order the
ranks claim them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch

from ..config import PATHOLOGIES, OcclusionConfig
from ..models.ctclip import CTCLIP
from ..parallel import collectives
from ..parallel.mesh import check_mesh
from ..utils import visualizations as viz
from . import grad_cam as gc
from . import integrated_gradients as ig
from . import occlusion as occ_mod
from . import raw_attention as ra
from . import rollout as ro
from .capture import rot90_ct


@dataclass
class AttributionContext:
    model: CTCLIP
    tokenizer: Any                      # HF-style: the stand-in WordTokenizer
    data: Iterable                      # yields (image, text, labels, name, path)
    diff_embeds: Optional[dict] = None  # pathology -> [dim_text] ndarray
    pathologies: Sequence[str] = PATHOLOGIES
    text_max_length: int = 512
    render_gifs: bool = True
    mesh: Any = None                    # a parallel.mesh.DataMesh (see the module doc)


def _check_mesh(mesh) -> None:
    """A process group of more than one rank needs the mesh that spans it."""
    if check_mesh(mesh) is None and (torch.distributed.is_available()
                                     and torch.distributed.is_initialized()
                                     and torch.distributed.get_world_size() > 1):
        raise ValueError("a multi-process attribution suite needs ctx.mesh "
                         "(parallel.mesh.make_mesh)")


class Visualizations:
    METHODS = ("raw_attention_maps", "attention_rollout", "integrated_gradients", "grad_cam",
               "occlusion")

    def __init__(self, ctx: AttributionContext, results_folder):
        _check_mesh(ctx.mesh)
        self.ctx = ctx
        self.results_folder = Path(results_folder)
        self.device = ctx.model.temperature.device
        self.timings = {}              # method -> seconds of its last visualize() pass
        self.sharded = ctx.mesh is not None and ctx.mesh.world > 1
        self.is_main = ctx.mesh is None or ctx.mesh.is_main
        if ctx.render_gifs:
            viz.require_renderer()

    # -- helpers -------------------------------------------------------------

    def _tokenize(self, text) -> dict:
        enc = self.ctx.tokenizer([text] if isinstance(text, str) else list(text),
                                 return_tensors="np", padding="max_length", truncation=True,
                                 max_length=self.ctx.text_max_length)
        return {k: torch.as_tensor(np.asarray(enc[k]), dtype=torch.int64, device=self.device)
                for k in ("input_ids", "attention_mask", "token_type_ids") if k in enc}

    @staticmethod
    def _image_np(image) -> np.ndarray:
        return rot90_ct(image.float().cpu().numpy().squeeze())

    def _out(self, name: str) -> Path:
        return viz.results_subdirectory(self.results_folder, name)

    def _broadcast_sample(self, sample):
        """Rank 0's (image, text tokens, labels, scan name, path) on every
        rank (suite.py:61-90): tensors broadcast on the mesh's device (each
        rank's sample gives the shapes: the ranks read the same dataset),
        strings through `broadcast_bytes`."""
        mesh = self.ctx.mesh
        image, tokens, labels, scan_name, path = sample
        image = collectives.broadcast(image.contiguous(), mesh)
        tokens = {k: collectives.broadcast(v.contiguous(), mesh) for k, v in sorted(tokens.items())}
        lab = collectives.broadcast(torch.as_tensor(labels, dtype=torch.float32,
                                                    device=self.device).contiguous(), mesh)
        names = [collectives.broadcast_bytes(str(v).encode(), mesh).decode()
                 for v in (scan_name, path)]
        return image, tokens, lab.cpu().numpy(), names[0], names[1]

    # -- the methods -----------------------------------------------------------

    def raw_attention_maps(self, image, text_tokens, labels, scan_name, path):
        sp, tm = ra.raw_attention_maps_np(self.ctx.model, text_tokens, image)
        out = self._out("raw_attention_grids")
        np.save(out / f"{scan_name}_spatial.npy", sp)
        np.save(out / f"{scan_name}_temporal.npy", tm)
        if self.ctx.render_gifs:
            viz.visualize_attention_grid_gif(sp, scan_name, out / f"{scan_name}_spatial_grid.gif")
            viz.visualize_attention_grid_gif(tm, scan_name,
                                             out / f"{scan_name}_temporal_grid.gif")

    def attention_rollout(self, image, text_tokens, labels, scan_name, path):
        sp_map, tm_map = ro.rollout_maps(self.ctx.model, text_tokens, image)
        self._save_rollout_maps(sp_map, tm_map, image, scan_name)

    def _save_rollout_maps(self, sp_map, tm_map, image, scan_name):
        sp_map, tm_map = rot90_ct(sp_map), rot90_ct(tm_map)
        out = self._out("attention_rollout")
        np.save(out / f"{scan_name}_spatial.npy", sp_map)
        np.save(out / f"{scan_name}_temporal.npy", tm_map)
        if self.ctx.render_gifs:
            img = self._image_np(image)
            viz.visualize_overlay(img, sp_map, scan_name, "Attention Rollout (Spatial)",
                                  out / f"{scan_name}_spatial.gif")
            viz.visualize_overlay(img, tm_map, scan_name, "Attention Rollout (Temporal)",
                                  out / f"{scan_name}_temporal.gif")

    def attention_rollout_worklist(self, samples):
        """Rollout over (image, text_tokens, scan_name) items, each pair's
        host expansion and save beside the next item's device work."""
        metas = []

        def items():
            for image, text_tokens, scan_name in samples:
                metas.append((image, scan_name))
                yield text_tokens, image

        for sp_map, tm_map in ro.rollout_maps_pipelined(self.ctx.model, items()):
            image, scan_name = metas.pop(0)
            self._save_rollout_maps(sp_map, tm_map, image, scan_name)

    def integrated_gradients(self, image, text_tokens, labels, scan_name, path,
                             steps: int = 50):
        """One sample's map; over a mesh of more than one rank collective
        (the steps split over the ranks), rank 0 writing it."""
        if self.sharded:
            sal = ig.integrated_gradients_sharded(self.ctx.model, text_tokens, image,
                                                  self.ctx.mesh, steps=steps)
        else:
            sal = ig.integrated_gradients(self.ctx.model, text_tokens, image, steps=steps)
        self._save_ig_map(sal, image, scan_name)
        return sal

    def _save_ig_map(self, sal, image, scan_name):
        if not self.is_main:    # the same map on every rank; rank 0 writes
            return
        sal = rot90_ct(sal)
        out = self._out("integrated_gradients")
        np.save(out / f"{scan_name}.npy", sal)
        if self.ctx.render_gifs:
            viz.visualize_overlay(self._image_np(image), sal, scan_name,
                                  "Integrated Gradients (1)", out / f"{scan_name}.gif")

    def integrated_gradients_worklist(self, samples, steps: int = 50):
        """IG over (image, text_tokens, scan_name) items, each map's copy,
        densify and save beside the next item's device work."""
        metas = []

        def items():
            for image, text_tokens, scan_name in samples:
                metas.append((image, scan_name))
                yield text_tokens, image

        for sal in ig.integrated_gradients_pipelined(self.ctx.model, items(), steps=steps):
            image, scan_name = metas.pop(0)
            self._save_ig_map(sal, image, scan_name)

    def grad_cam(self, image, text_tokens, labels, scan_name, path):
        maps = gc.grad_cam_maps(self.ctx.model, text_tokens, image)
        out = self._out("grad_cam")
        img = self._image_np(image) if self.ctx.render_gifs else None
        for key, vol in maps.items():
            vol = rot90_ct(vol)
            np.save(out / f"{scan_name}_{key}.npy", vol)
            if self.ctx.render_gifs:
                viz.visualize_overlay(img, vol, scan_name, f"Grad-CAM ({key})",
                                      out / f"{scan_name}_{key}.gif",
                                      display_flags={"overlay": True})

    def occlusion(self, image, text_tokens, labels, scan_name, path,
                  occ: OcclusionConfig = OcclusionConfig(), use_text_embeds: bool = False,
                  prompt: str = ""):
        # the indexed run directory is picked by the writing rank alone
        out = self._out("occlusion") if self.is_main else None
        img = self._image_np(image) if self.ctx.render_gifs and self.is_main else None
        model, mesh = self.ctx.model, self.ctx.mesh
        if use_text_embeds:
            if not self.ctx.diff_embeds:
                raise ValueError("use_text_embeds requires ctx.diff_embeds")
            positives = [p for p, v in zip(self.ctx.pathologies, np.asarray(labels).tolist())
                         if v == 1.0 and p in self.ctx.diff_embeds]
            if not positives:
                return {}
            latents = torch.stack([occ_mod.diff_embedding_latent(
                model, torch.as_tensor(np.asarray(self.ctx.diff_embeds[p], np.float32),
                                       device=self.device)) for p in positives])
            heats = occ_mod.occlusion_heatmaps_multi(model, image, latents, occ=occ, mesh=mesh)
            heatmaps = {p: rot90_ct(h) for p, h in zip(positives, heats)}
            if not self.is_main:       # the same maps on every rank; rank 0 writes
                return heatmaps
            np.save(out / f"{scan_name}_{occ.patch_size}_{occ.stride}_{prompt}_heatmaps.npy",
                    heatmaps)
            if self.ctx.render_gifs:
                for pathology, heat in heatmaps.items():
                    viz.visualize_overlay(
                        img, heat, f"{scan_name}_{pathology}", "Occlusion",
                        out / f"{scan_name}_{pathology}_{occ.patch_size}_{occ.stride}"
                              f"_occlusion.gif", display_flags={"overlay": True})
                viz.visualize_pathology_heatmaps(
                    img, heatmaps,
                    out / f"{scan_name}_{occ.patch_size}_{occ.stride}_pathology_heatmaps.gif",
                    pathologies=self.ctx.pathologies)
            return heatmaps
        latent = occ_mod.report_text_latent(model, text_tokens)
        heat = rot90_ct(occ_mod.occlusion_heatmap(model, image, latent, occ=occ, mesh=mesh))
        if not self.is_main:
            return heat
        np.save(out / f"{scan_name}_{prompt}_heatmap.npy", heat)
        if self.ctx.render_gifs:
            viz.visualize_overlay(img, heat, scan_name, "Occlusion", out / f"{scan_name}_{prompt}.gif",
                                  display_flags={"overlay": True})
        return heat

    # -- the dispatcher --------------------------------------------------------

    def _samples(self, share: bool):
        """The dataset's raw samples; with `share` over a mesh of more than
        one rank only this rank's, sample i on rank i % world, taken by
        index where the dataset has one so that no rank loads another
        rank's volumes."""
        data = self.ctx.data
        if not (share and self.sharded):
            yield from data
            return
        world, rank = self.ctx.mesh.world, self.ctx.mesh.rank
        if hasattr(data, "__len__") and hasattr(data, "__getitem__"):
            for i in range(rank, len(data), world):
                yield data[i]
        else:
            for i, sample in enumerate(data):
                if i % world == rank:
                    yield sample

    def prepared(self, share: bool = False):
        """The dataset's samples (this rank's share with `share`, see
        `_samples`) as (image [1, 1, D, H, W] fp32 on the model's device,
        text tokens, labels [18], scan name, path)."""
        for image, text, labels, scan_name, path in self._samples(share):
            image = torch.as_tensor(image).to(self.device, torch.float32)
            if image.ndim == 4:
                image = image[None]
            yield (image, self._tokenize(text if isinstance(text, str) else text[0]),
                   np.asarray(labels).reshape(-1),
                   scan_name if isinstance(scan_name, str) else scan_name[0],
                   path if isinstance(path, str) else path[0])

    def visualize(self, **flags):
        """Each flagged method over the dataset, in the order given (a dict
        flag: occlusion's keywords); an unknown name is reported and
        skipped, as in the JAX suite."""
        for name, enabled in flags.items():
            if not enabled:
                continue
            if name not in self.METHODS:
                print(f"{name} is not a valid visualization argument.")
                continue
            if self.is_main:
                print(f"{name} visualization started.")
            start = time.time()
            # the collective methods take every sample (rank 0's); the others
            # each rank its share of the samples
            collective = name in ("occlusion", "integrated_gradients")
            share = not collective
            if name == "integrated_gradients" and self.sharded:
                for sample in self.prepared(share):
                    self.integrated_gradients(*self._broadcast_sample(sample))
            elif name == "integrated_gradients":
                self.integrated_gradients_worklist(
                    (img, tok, nm) for img, tok, _, nm, _ in self.prepared(share))
            elif name == "attention_rollout":
                self.attention_rollout_worklist(
                    (img, tok, nm) for img, tok, _, nm, _ in self.prepared(share))
            else:
                kwargs = enabled if name == "occlusion" and isinstance(enabled, dict) else {}
                for sample in self.prepared(share):
                    if self.sharded and collective:
                        sample = self._broadcast_sample(sample)
                    getattr(self, name)(*sample, **kwargs)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings[name] = time.time() - start
            if self.is_main:
                print(f"{name} completed in {self.timings[name]:.1f}s")
