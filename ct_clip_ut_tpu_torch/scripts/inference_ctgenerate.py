"""CTGenerate on one GPU or data-parallel: keyword localisation heatmaps, or GenerateCT decoding.

    python -m ct_clip_ut_tpu_torch.scripts.inference_ctgenerate \
        --data-valid /data/valid --valid-reports R.csv --valid-labels L.csv \
        --valid-metadata M.csv [--batch-size 1] [--gifs]
    python -m ct_clip_ut_tpu_torch.scripts.inference_ctgenerate \
        --scans SCANS.npy --reports REPORTS.txt [--labels LABELS.npy]
    python -m ct_clip_ut_tpu_torch.scripts.inference_ctgenerate --generate "PROMPT" ...
    torchrun --nproc-per-node N -m ct_clip_ut_tpu_torch.scripts.inference_ctgenerate \
        ... --batch-size B --multihost [--mesh-data N]

Counterpart of ct_clip_ut_tpu/scripts/inference_ctgenerate.py.
Localisation over --data-valid reads the scans through `InferenceDataset`
(model_type "ctgenerate": [1, 201, 128, 128] fp32 volumes, the reports,
labels and metadata CSVs). At --batch-size 1 each scan takes the one-scan
fp32 route of the JAX script (`localize_scan`: the report T5-encoded, the
scan and MaskGit in fp32 through the fp32 kernels, TF32 off); at
--batch-size > 1 the scans go in batches through `ctgenerate_apply_batched`
(MaskGit in --compute-dtype with the CPB table built once into a cache).
Each scan's positive pathologies whose words occur in its report get a
heatmap [201, 128, 128], saved rotated as ctgenerate_<scan>_<pathology>.npy
and, with --gifs, rendered over the rotated scan as a GIF of the same name
(utils/visualizations; the JAX script always renders). --scans takes [N, 1,
D, H, W] scans from a .npy with one report per line (--labels: [N, 18] 0/1;
without it, every pathology), the same routes by --batch-size (the batched
one on bf16 scans), files named by sample index. --generate decodes one
token grid per prompt with `maskgit_generate` (bf16, generator seeded by
--seed) and saves it as generated_<i>_<slug>_tokens.npy.

Data parallelism: --mesh-data N (the JAX script's flag; the process group's
size) with the runtime flags of `inference_ctclip` (--multihost,
--coordinator-address, --num-processes, --process-id:
`parallel.mesh.make_cli_mesh`, each rank on `cuda:LOCAL_RANK`) splits
each batch's scans over the ranks (`ctgenerate_apply_batched(mesh=)`: a batch padded to the
world with its last scan, every rank's rows gathered); the one-scan route
is taken only without a mesh (JAX :148), so --batch-size 1 over a mesh
runs batches of one scan on the batched route. Every rank reads the same
dataset; rank 0 renders and writes each heatmap, once, and with
--generate alone decodes and writes the grids.

Weights: --checkpoint, a state dict of the port's CTGenerate
(torch.save(model.state_dict()), or the reference's ctgenerate_filtered.pt
converted with its T5 tower by scripts/convert_checkpoint.py; the
reference's file itself raises, `convert.load_ctgenerate`); without it,
random weights from --seed. Reports are tokenised by the stand-in
`WordTokenizer`, whose ids mean nothing to a trained T5 tower: with
--checkpoint the run raises unless --stand-in-tokenizer (the port's own
flag) asks for it. Left for later, raising with its ROADMAP item: the T5
SentencePiece tokenizer (--t5, item 12d).
`main(argv, model_cfg=, preprocess_cfg=)` takes another configuration from
Python (the tests' tiny one); the command line serves CTGenerateConfig().
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .. import _build, convert
from ..attribution.capture import full_fp32, rot90_ct
from ..config import PATHOLOGIES, CTGenerateConfig, PreprocessConfig
from ..data.datasets import InferenceDataset
from ..infer.zeroshot import WordTokenizer
from ..models.ctgenerate import (CTGenerate, ctgenerate_apply, ctgenerate_apply_batched,
                                 init_ctgenerate, keyword_heatmap)
from ..models.ctvit import token_grid_shape
from ..models.maskgit import maskgit_generate
from ..models.t5 import T5TextConditioner
from ..parallel.mesh import make_cli_mesh
from ..utils import visualizations


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scans", default=None, help="[N, 1, D, H, W] scans (.npy)")
    p.add_argument("--reports", default=None, help="one report per line, N lines")
    p.add_argument("--labels", default=None, help="[N, 18] 0/1 pathology labels (.npy)")
    p.add_argument("--data-valid", default=None, help="the valid split's .nii.gz volumes")
    p.add_argument("--valid-reports", default=None)
    p.add_argument("--valid-labels", default=None)
    p.add_argument("--valid-metadata", default=None)
    p.add_argument("--num-valid-samples", type=int, default=1)
    p.add_argument("--num-workers", type=int, default=4,
                   help="accepted as the JAX script does; the loop reads the dataset in order")
    p.add_argument("--generate", nargs="*", metavar="PROMPT", default=None,
                   help="decode one CT token grid per prompt (saved as .npy)")
    p.add_argument("--generate-steps", type=int, default=18, help="MaskGIT decode iterations")
    p.add_argument("--generate-temperature", type=float, default=1.0)
    p.add_argument("--generate-frames", type=int, default=201,
                   help="target scan depth; the grid is (1+(frames-1)/tps, H/ps, W/ps)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--results-folder", default="./results/valid/ctgenerate")
    p.add_argument("--checkpoint", default=None,
                   help="a state dict of the port's CTGenerate; default: random from --seed")
    p.add_argument("--t5", default=None,
                   help="HF T5 tokenizer files (SentencePiece): not ported (item 12d)")
    p.add_argument("--stand-in-tokenizer", action="store_true",
                   help="condition --checkpoint's T5 tower on the stand-in WordTokenizer's ids "
                        "(they mean nothing to trained weights)")
    p.add_argument("--batch-size", type=int, default=1, help="scans per forward")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel mesh axis size: each batch's scans split over the "
                        "processes (default: every process of --multihost)")
    p.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"),
                   help="MaskGit's dtype at --batch-size > 1; the one-scan route runs fp32")
    p.add_argument("--gifs", action="store_true",
                   help="also render each heatmap over its scan as a GIF (matplotlib, pillow)")
    p.add_argument("--multihost", action="store_true",
                   help="join the torch.distributed process group (torchrun's environment, "
                        "or the three flags below)")
    p.add_argument("--coordinator-address", default=None, help="host:port of rank 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p


def load_model(cfg: CTGenerateConfig, checkpoint, seed: int, device) -> CTGenerate:
    """The port's CTGenerate from `checkpoint` (a port state dict), or
    seeded random weights."""
    if checkpoint is None:
        return init_ctgenerate(cfg, seed=seed, device=device)
    return convert.load_ctgenerate(checkpoint, cfg, device=device)


@torch.no_grad()
def localize_scan(model: CTGenerate, t5: T5TextConditioner, scan: torch.Tensor, report: str,
                  positives, plain: bool = False) -> tuple:
    """The JAX script's one-scan route (script :150-161): the report
    T5-encoded, its positives' token spans, `ctgenerate_apply` on the fp32
    scan [1, 1, D, H, W] with MaskGit in fp32, TF32 off throughout (the
    PEG and T5 in full fp32). Returns ({pathology: heatmap [D, H, W] numpy
    in [0, 1]}, the forward's CTGenerateOutput). plain=True runs every
    kernel's plain version (what the card compares the route with)."""
    if scan.dtype != torch.float32:
        raise TypeError(f"the one-scan route takes an fp32 scan, got {scan.dtype}")
    with full_fp32():
        text_embed, text_mask = t5.encode(report)
        out = ctgenerate_apply(model, scan, text_embed, text_mask,
                               t5.get_token_indices(list(positives)), compute_dtype="float32",
                               plain=plain)
        maps = {p: keyword_heatmap(cross, out.video_patch_shape, scan.shape[-3:]).cpu().numpy()
                for p, cross in out.kw_attention.items()}
    return maps, out


@torch.no_grad()
def localize(model: CTGenerate, t5: T5TextConditioner, scans: torch.Tensor, reports, labels=None,
             bias_cache=None, compute_dtype="bfloat16", pathologies=PATHOLOGIES,
             mesh=None) -> list:
    """The batched localisation loop's body (script :163-182): one dict per
    scan of {pathology: heatmap [D, H, W] numpy in [0, 1]} for its positive
    pathologies (all when labels is None) found in its report. With a
    data-axis `mesh` the scans are split over the ranks (collective: every
    rank passes the same batch and gets every scan's maps)."""
    text_embed, text_mask = t5.encode(list(reports))
    out = ctgenerate_apply_batched(model, scans, text_embed, text_mask, mesh=mesh,
                                   bias_cache=bias_cache, compute_dtype=compute_dtype)
    maps = []
    for i in range(scans.shape[0]):
        positives = [p for j, p in enumerate(pathologies) if labels is None or labels[i][j] == 1]
        maps.append({p: keyword_heatmap(out.cross_attention[i:i + 1][..., idx],
                                        out.video_patch_shape, scans.shape[-3:]).cpu().numpy()
                     for p, idx in t5.get_token_indices(positives, index=i).items()})
    return maps


@torch.no_grad()
def generate(model: CTGenerate, t5: T5TextConditioner, prompts, frames: int, steps: int,
             temperature: float, seed: int, compute_dtype="bfloat16") -> np.ndarray:
    """[len(prompts), t, h, w] int32 codebook-id grids."""
    vit = model.cfg.ctvit
    grid = token_grid_shape(vit, (frames, vit.image_size, vit.image_size))
    text_embed, text_mask = t5.encode(list(prompts))
    gen = torch.Generator(device=text_embed.device).manual_seed(seed)
    ids = maskgit_generate(model.maskgit, text_embed, grid, text_mask=text_mask, steps=steps,
                           temperature=temperature, generator=gen, compute_dtype=compute_dtype)
    return ids.cpu().numpy().reshape(len(prompts), *grid)


def positives_of(labels, pathologies=PATHOLOGIES) -> list:
    """The pathologies whose label is 1 (a missing label is not)."""
    return [p for p, v in zip(pathologies, np.asarray(labels, np.float64).tolist()) if v == 1.0]


def main(argv=None, model_cfg: CTGenerateConfig = None,
         preprocess_cfg: PreprocessConfig = None) -> list:
    """Returns the paths of the heatmaps (and GIFs) written; [] for --generate."""
    parser = build_parser()
    args = parser.parse_args(argv)
    dataset_flags = (args.data_valid, args.valid_reports, args.valid_labels, args.valid_metadata)
    if args.generate is None:
        if any(dataset_flags) and not all(dataset_flags):
            parser.error("localization over a dataset needs --data-valid/--valid-reports/"
                         "--valid-labels/--valid-metadata")
        if not any(dataset_flags) and (args.scans is None or args.reports is None):
            parser.error("localisation needs --data-valid and its CSVs, or --scans and "
                         "--reports (or pass --generate PROMPT...)")
    elif not args.generate:
        parser.error("--generate needs at least one prompt")
    if args.t5 is not None:
        raise NotImplementedError("the T5 SentencePiece tokenizer is not ported (ROADMAP "
                                  "Queue 1 item 12d); the stand-in WordTokenizer is used")
    if args.checkpoint is not None and not args.stand_in_tokenizer:
        raise ValueError("--checkpoint's T5 tower reads the ids of T5's SentencePiece tokenizer, "
                         "which is not ported (ROADMAP Queue 1 item 12d): pass "
                         "--stand-in-tokenizer to condition it on the stand-in WordTokenizer's "
                         "ids all the same")
    if args.gifs:
        visualizations.require_renderer()   # before the model loads

    mesh = make_cli_mesh(args)
    device = mesh.device if mesh is not None else _build.check_device(args.device)
    is_main = mesh is None or mesh.is_main
    cfg = model_cfg or CTGenerateConfig()
    model = load_model(cfg, args.checkpoint, args.seed, device)
    t5 = T5TextConditioner(model.t5, WordTokenizer(cfg.t5.vocab_size))
    results = Path(args.results_folder)
    results.mkdir(parents=True, exist_ok=True)
    start = time.time()

    if args.generate is not None and not is_main:
        return []
    if args.generate is not None:
        ids = generate(model, t5, args.generate, args.generate_frames, args.generate_steps,
                       args.generate_temperature, args.seed, args.compute_dtype)
        for i, prompt in enumerate(args.generate):
            slug = "_".join(prompt.lower().split())[:60]
            out = results / f"generated_{i}_{slug}_tokens.npy"
            np.save(out, ids[i])
            print(f"[generate] {out}  grid {ids.shape[1:]}  unique tokens {len(np.unique(ids[i]))}")
        print(f"Generated {len(args.generate)} token grid(s) -> {results}")
        return []

    written = []

    def render(image, heat, scan_name, pathology):
        """The rotated heatmap to its .npy, and with --gifs over the
        rotated scan to its .gif (the JAX script's `render`); over a mesh
        rank 0 alone writes."""
        if not is_main:
            return
        heat = rot90_ct(heat)
        stem = results / f"ctgenerate_{scan_name}_{pathology}"
        np.save(f"{stem}.npy", heat)
        written.append(Path(f"{stem}.npy"))
        if args.gifs:
            visualizations.visualize_overlay(rot90_ct(np.asarray(image).squeeze()), heat,
                                             str(scan_name), "GenerateCT Attention",
                                             f"{stem}.gif")
            written.append(Path(f"{stem}.gif"))

    if args.data_valid is not None:
        ds = InferenceDataset(args.data_valid, args.valid_reports, args.valid_metadata,
                              args.valid_labels, num_samples=args.num_valid_samples,
                              model_type="ctgenerate",
                              preprocess_cfg=preprocess_cfg or PreprocessConfig())
        samples = ((image, text, positives_of(labels), name)
                   for image, text, labels, name, _ in (ds[i] for i in range(len(ds))))
        count = len(ds)
        scan_dtype = torch.float32          # the JAX batched route keeps the scans' fp32
    else:
        scans = np.load(args.scans, mmap_mode="r")
        reports = Path(args.reports).read_text().splitlines()
        labels = None if args.labels is None else np.load(args.labels)
        if len(reports) != len(scans):
            parser.error(f"{len(scans)} scans but {len(reports)} reports")
        samples = ((np.asarray(scans[i], np.float32), reports[i],
                    list(PATHOLOGIES) if labels is None else positives_of(labels[i]), i)
                   for i in range(len(scans)))
        count = len(scans)
        scan_dtype = torch.bfloat16         # the batched serving route's scans
    bsz, cache = max(1, args.batch_size), {}
    if bsz == 1 and mesh is None:
        for image, text, positives, scan_name in samples:
            scan = torch.as_tensor(image, dtype=torch.float32)[None].to(device)
            maps, _ = localize_scan(model, t5, scan, text, positives)
            for pathology, heat in maps.items():
                render(image, heat, scan_name, pathology)
    else:
        samples = list(samples)
        for lo in range(0, count, bsz):
            batch = samples[lo:lo + bsz]
            scans_b = torch.as_tensor(np.stack([s[0] for s in batch])).to(device, scan_dtype)
            onehot = [[1 if p in s[2] else 0 for p in PATHOLOGIES] for s in batch]
            maps = localize(model, t5, scans_b, [s[1] for s in batch], onehot, cache,
                            args.compute_dtype, mesh=mesh)
            for (image, _, _, scan_name), heat in zip(batch, maps):
                for pathology, vol in heat.items():
                    render(image, vol, scan_name, pathology)
    if is_main:
        print(f"CTGENERATE inference completed in {time.time() - start:.1f}s")
    return written


if __name__ == "__main__":
    main()
