"""Throughput and device-time profile of the CTGenerate path on one GPU.

    python -m ct_clip_ut_tpu_torch.infer.profile_ctgenerate [--table PATH] [--one-scan]

At the default configuration (`CTGenerateConfig()`: [b, 1, 201, 128, 128]
bf16 scans -> a 101 x 8 x 8 grid, T5-v1.1-base, MaskGit 6 x 512; random
weights from seed 0) with stand-in reports (the `WordTokenizer`, REPORT_WORDS
words each), it prints:

- one T5 encoding of 2 reports at REPORT_WORDS words and at the
  configuration's max_length (host clock around a synchronised call, after
  a warm-up), and one build of the bf16 MaskGit CPB table;
- per batch size b in SIZES, over BATCHES batches, host clock, one
  synchronise per loop, as the median, min and max of REPEATS loops:
  scans/s of the script's `localize` (the end-to-end rate: T5 encoding of
  the batch's reports, `ctgenerate_apply_batched` with bf16 MaskGit and the
  bias cache, one [201, 128, 128] heatmap per pathology found in a report,
  copied to the host) and scans/s of `ctgenerate_apply_batched` alone (the
  model layer's rate: reports encoded once, outside the loop; no heatmaps);
  the peak device memory of the forward-only loops and the launch counts of
  one forward;
- one `maskgit_generate` at B = 1 and 18 steps, in seconds, with its
  launch counts;
- one batched forward at b = PROFILE_BATCH under torch.profiler: wall and
  device kernel time, the device's busy share, and the device kernels
  ranked by time (--table writes every row to PATH).

With --one-scan it profiles the JAX script's default route instead, the
script's `localize_scan` (one fp32 scan a forward: T5 of its report, the
fp32 tokenizer and MaskGit, its heatmaps copied to the host; TF32 off):
seconds a scan (host clock, synchronised, median, min and max of REPEATS
scans after a warm-up), its launch counts, and one call under
torch.profiler.

Each line names the card and its power limit (`nvidia-smi`).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from ..config import CTGenerateConfig
from ..models.ctgenerate import ctgenerate_apply_batched, init_ctgenerate, maskgit_bias_table
from ..models.ctvit import token_grid_shape
from ..models.maskgit import maskgit_generate
from ..models.t5 import T5TextConditioner
from ..ops import launches
from ..scripts.inference_ctgenerate import localize, localize_scan
from .profile_zeroshot import card_name, print_profile, profile_call
from .zeroshot import WordTokenizer

SCAN = (1, 201, 128, 128)            # [c, D, H, W] of CTGenerateConfig()'s scans
SIZES, BATCHES, REPEATS, PROFILE_BATCH = (1, 2, 4), 10, 5, 2
GENERATE_STEPS = 18
REPORT_WORDS = 120                   # about a chest CT report's findings section
WORDS = ("the lungs show mild emphysema and atelectasis in the lower lobes a small pleural "
         "effusion on the left no lymphadenopathy heart size is normal with arterial wall "
         "calcification and a lung nodule in the right upper lobe").split()


def reports(b: int, words: int = REPORT_WORDS) -> list:
    """b stand-in reports of `words` words (one token a word), each another."""
    return [" ".join(WORDS[(i * 7 + k) % len(WORDS)] for k in range(words)) for i in range(b)]


def scans_of(b: int, g: torch.Generator) -> torch.Tensor:
    return torch.randn((b, *SCAN), generator=g, device="cuda", dtype=torch.bfloat16)


def timed(fn):
    """(fn(), host-clock seconds) around a synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rates_of(run, b: int, batches: int, repeats: int) -> dict:
    """Median / min / max scans/s of `repeats` loops of `batches` run()s,
    one synchronise per loop."""
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(batches):
            run()
        torch.cuda.synchronize()
        rates.append(b * batches / (time.perf_counter() - t0))
    return dict(median=statistics.median(rates), min=min(rates), max=max(rates))


def throughput(model, t5, scans: torch.Tensor, batches: int, repeats: int, cache: dict) -> dict:
    """localize() and ctgenerate_apply_batched alone over `batches` batches
    of `scans`, `repeats` times each."""
    b = scans.shape[0]
    texts = reports(b)
    heatmaps = sum(len(m) for m in localize(model, t5, scans, texts, bias_cache=cache))
    text_embed, text_mask = t5.encode(texts)
    ctgenerate_apply_batched(model, scans, text_embed, text_mask, bias_cache=cache)  # warm-up
    launches.reset_launch_counts()
    ctgenerate_apply_batched(model, scans, text_embed, text_mask, bias_cache=cache)
    counts = launches.launch_counts()
    end_to_end = rates_of(lambda: localize(model, t5, scans, texts, bias_cache=cache),
                          b, batches, repeats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forward = rates_of(lambda: ctgenerate_apply_batched(model, scans, text_embed, text_mask,
                                                        bias_cache=cache),
                       b, batches, repeats)
    return dict(localize=end_to_end, forward=forward, heatmaps=heatmaps,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                counts={k: v for k, v in counts.items() if v})


def spread(r: dict) -> str:
    return f"median {r['median']:.3f} scans/s (min {r['min']:.3f}, max {r['max']:.3f})"


ONE_SCAN_POSITIVES = ("Emphysema", "Atelectasis", "Pleural effusion", "Lymphadenopathy",
                      "Arterial wall calcification", "Lung nodule")   # all in WORDS


def one_scan(model, t5, g, card: str, table) -> None:
    """The one-scan fp32 route: seconds a scan, launches, one profile."""
    scan = torch.randn((1, *SCAN), generator=g, device="cuda")
    text = reports(1)[0]

    def run():
        return localize_scan(model, t5, scan, text, ONE_SCAN_POSITIVES)[0]

    run()                                                            # warm-up
    launches.reset_launch_counts()
    maps, _ = timed(run)
    counts = {k: v for k, v in launches.launch_counts().items() if v}
    secs = [timed(run)[1] for _ in range(REPEATS)]
    print(f"one-scan fp32: localize_scan over [1, {', '.join(map(str, SCAN))}] with "
          f"{len(maps)} heatmaps: median {statistics.median(secs):.4f} s a scan (min "
          f"{min(secs):.4f}, max {max(secs):.4f}, {REPEATS} scans); launches {counts} [{card}]",
          flush=True)
    print_profile(profile_call(run), "profile one-scan fp32", card, table)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--table", default=None, help="write every kernel's profile row here")
    ap.add_argument("--one-scan", action="store_true",
                    help="profile the one-scan fp32 route (localize_scan) instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_ctgenerate: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    cfg = CTGenerateConfig()
    model = init_ctgenerate(cfg, seed=0, device="cuda")
    t5 = T5TextConditioner(model.t5, WordTokenizer(cfg.t5.vocab_size))
    g = torch.Generator(device="cuda").manual_seed(0)
    grid = token_grid_shape(cfg.ctvit, (1, *SCAN))
    if args.one_scan:
        one_scan(model, t5, g, card, args.table)
        return 0

    for words in (REPORT_WORDS, cfg.t5.max_length):                 # truncated at max_length
        t5.encode(reports(2, words))                                # warm-up
        (emb, _), sec = timed(lambda: t5.encode(reports(2, words)))
        print(f"t5: one encoding of 2 reports x {emb.shape[1]} tokens in {1e3 * sec:.3f} ms "
              f"[{card}]", flush=True)
    maskgit_bias_table(model, grid, dtype="bfloat16")               # warm-up
    table, sec = timed(lambda: maskgit_bias_table(model, grid, dtype="bfloat16"))
    print(f"bias table: {list(table.shape)} bf16 ({table.numel() * 2 / 1e9:.3f} GB) built in "
          f"{1e3 * sec:.3f} ms [{card}]", flush=True)
    cache = {(*grid, "bfloat16"): table}

    for b in SIZES:
        r = throughput(model, t5, scans_of(b, g), BATCHES, REPEATS, cache)
        print(f"throughput B={b}, {BATCHES} batches x {REPEATS}: localize() {spread(r['localize'])}"
              f" with {r['heatmaps']} heatmaps a batch; ctgenerate_apply_batched alone "
              f"{spread(r['forward'])}, peak {r['peak_gb']:.3f} GB; launches per forward "
              f"{r['counts']} [{card}]", flush=True)

    text_embed, text_mask = t5.encode(reports(1))
    torch.cuda.reset_peak_memory_stats()
    launches.reset_launch_counts()
    ids, sec = timed(lambda: maskgit_generate(
        model.maskgit, text_embed, grid, text_mask=text_mask, steps=GENERATE_STEPS,
        generator=torch.Generator(device="cuda").manual_seed(0), compute_dtype="bfloat16"))
    counts = {k: v for k, v in launches.launch_counts().items() if v}
    print(f"generate: maskgit_generate B=1, {GENERATE_STEPS} steps over {grid} in {sec:.3f} s "
          f"(the table built inside), peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, "
          f"{int(ids.unique().numel())} distinct ids; launches {counts} [{card}]", flush=True)

    b = PROFILE_BATCH
    scans = scans_of(b, g)
    text_embed, text_mask = t5.encode(reports(b))
    p = profile_call(lambda: ctgenerate_apply_batched(model, scans, text_embed, text_mask,
                                                      bias_cache=cache))
    print_profile(p, f"profile B={b}", card, args.table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
