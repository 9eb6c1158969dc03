"""CTGenerate on one GPU: keyword localisation heatmaps, or GenerateCT decoding.

    python -m ct_clip_ut_tpu_torch.scripts.inference_ctgenerate \
        --scans SCANS.npy --reports REPORTS.txt [--labels LABELS.npy]
    python -m ct_clip_ut_tpu_torch.scripts.inference_ctgenerate --generate "PROMPT" ...

Counterpart of ct_clip_ut_tpu/scripts/inference_ctgenerate.py.
Localisation: [N, 1, 201, 128, 128] scans (a .npy, cast to bf16: the card
serves bf16 scans) with one report per line, in batches of --batch-size
through `ctgenerate_apply_batched` (bf16 MaskGit, the CPB table built once
into a cache): each sample's positive pathologies (a [N, 18] 0/1 --labels
array; without it, every pathology) whose words occur in its report get a
heatmap [201, 128, 128], saved rotated as the JAX script saves it
(ctgenerate_<sample>_<pathology>.npy). --generate decodes one token grid
per prompt with `maskgit_generate` (bf16, generator seeded by --seed) and
saves it as generated_<i>_<slug>_tokens.npy.

Weights: --checkpoint, a state dict of the port's CTGenerate
(torch.save(model.state_dict())); without it, random weights from --seed.
Reports are tokenised by the stand-in `WordTokenizer`. Left for later, each
raising with its ROADMAP item: the dataset loop (--data-valid and its
companions, Queue 1 item 13), GIF rendering (--gifs), --mesh-data (item
11), and the reference's ctgenerate_filtered.pt or HF T5 tokenizer files
(--t5, item 12). Unlike the JAX script at --batch-size 1, the one-scan
fp32 route is not taken: every batch size serves through the batched bf16
forward.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..config import PATHOLOGIES, CTGenerateConfig
from ..infer.zeroshot import WordTokenizer
from ..models.ctgenerate import (CTGenerate, ctgenerate_apply_batched, init_ctgenerate,
                                 keyword_heatmap)
from ..models.ctvit import token_grid_shape
from ..models.maskgit import maskgit_generate
from ..models.t5 import T5TextConditioner


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scans", default=None, help="[N, 1, D, H, W] scans (.npy)")
    p.add_argument("--reports", default=None, help="one report per line, N lines")
    p.add_argument("--labels", default=None, help="[N, 18] 0/1 pathology labels (.npy)")
    p.add_argument("--data-valid", default=None, help="not ported (ROADMAP Queue 1 item 13)")
    p.add_argument("--valid-reports", default=None)
    p.add_argument("--valid-labels", default=None)
    p.add_argument("--valid-metadata", default=None)
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
    p.add_argument("--t5", default=None, help="HF T5 tokenizer files: not ported (item 12)")
    p.add_argument("--batch-size", type=int, default=1, help="scans per forward")
    p.add_argument("--mesh-data", type=int, default=None, help="not ported (item 11)")
    p.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"),
                   help="MaskGit's dtype (float32 runs on the CPU only)")
    p.add_argument("--gifs", action="store_true", help="GIF overlays: not ported")
    p.add_argument("--device", default="cuda")
    return p


def load_model(cfg: CTGenerateConfig, checkpoint, seed: int, device) -> CTGenerate:
    """The port's CTGenerate from a state dict of its own, or seeded random
    weights."""
    model = init_ctgenerate(cfg, seed=seed, device=device)
    if checkpoint is None:
        return model
    sd = torch.load(checkpoint, map_location=device, weights_only=True)
    if not isinstance(sd, dict) or set(sd) != set(model.state_dict()):
        raise NotImplementedError(
            f"{checkpoint} is not a state dict of the port's CTGenerate; converting the "
            "reference's ctgenerate_filtered.pt waits for that file (ROADMAP Queue 1 item 12)")
    model.load_state_dict(sd, strict=True)
    return model


def rot90_ct(volume: np.ndarray) -> np.ndarray:
    """np.rot90(k=-1, axes=(1, 2)): the CT table down (attribution/capture.py:192)."""
    return np.rot90(volume, k=-1, axes=(1, 2))


@torch.no_grad()
def localize(model: CTGenerate, t5: T5TextConditioner, scans: torch.Tensor, reports, labels=None,
             bias_cache=None, compute_dtype="bfloat16", pathologies=PATHOLOGIES) -> list:
    """The batched localisation loop's body (script :163-182): one dict per
    scan of {pathology: heatmap [D, H, W] numpy in [0, 1]} for its positive
    pathologies (all when labels is None) found in its report."""
    text_embed, text_mask = t5.encode(list(reports))
    out = ctgenerate_apply_batched(model, scans, text_embed, text_mask, bias_cache=bias_cache,
                                   compute_dtype=compute_dtype)
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


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.data_valid or args.valid_reports or args.valid_labels or args.valid_metadata:
        raise NotImplementedError("the dataset loop (InferenceDataset) is not ported yet "
                                  "(ROADMAP Queue 1 item 13); pass --scans and --reports")
    if args.mesh_data is not None:
        raise NotImplementedError("--mesh-data is not ported yet (ROADMAP Queue 1 item 11)")
    if args.t5 is not None:
        raise NotImplementedError("HF T5 tokenizer files are not in the repository (ROADMAP "
                                  "Queue 1 item 12); the stand-in WordTokenizer is used")
    if args.gifs:
        raise NotImplementedError("GIF rendering (utils/visualizations) is not ported yet "
                                  "(ROADMAP Queue 1 item 10)")
    if args.generate is None and (args.scans is None or args.reports is None):
        parser.error("localisation needs --scans and --reports (or pass --generate PROMPT...)")
    if args.generate is not None and not args.generate:
        parser.error("--generate needs at least one prompt")

    device = _build.check_device(args.device)
    cfg = CTGenerateConfig()
    model = load_model(cfg, args.checkpoint, args.seed, device)
    t5 = T5TextConditioner(model.t5, WordTokenizer(cfg.t5.vocab_size))
    results = Path(args.results_folder)
    results.mkdir(parents=True, exist_ok=True)
    start = time.time()

    if args.generate is not None:
        ids = generate(model, t5, args.generate, args.generate_frames, args.generate_steps,
                       args.generate_temperature, args.seed, args.compute_dtype)
        for i, prompt in enumerate(args.generate):
            slug = "_".join(prompt.lower().split())[:60]
            out = results / f"generated_{i}_{slug}_tokens.npy"
            np.save(out, ids[i])
            print(f"[generate] {out}  grid {ids.shape[1:]}  unique tokens {len(np.unique(ids[i]))}")
        print(f"Generated {len(args.generate)} token grid(s) -> {results}")
        return

    scans = np.load(args.scans, mmap_mode="r")
    reports = Path(args.reports).read_text().splitlines()
    labels = None if args.labels is None else np.load(args.labels)
    if len(reports) != len(scans):
        parser.error(f"{len(scans)} scans but {len(reports)} reports")
    bsz, cache = max(1, args.batch_size), {}
    for lo in range(0, len(scans), bsz):
        batch = torch.as_tensor(np.asarray(scans[lo:lo + bsz]), dtype=torch.float32)
        maps = localize(model, t5, batch.to(device, torch.bfloat16), reports[lo:lo + bsz],
                        None if labels is None else labels[lo:lo + bsz], cache,
                        args.compute_dtype)
        for i, heat in enumerate(maps, start=lo):
            for pathology, vol in heat.items():
                np.save(results / f"ctgenerate_{i}_{pathology}.npy", rot90_ct(vol))
    print(f"CTGENERATE inference completed in {time.time() - start:.1f}s")


if __name__ == "__main__":
    main()
