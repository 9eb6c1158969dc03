"""Throughput and device-time profile of the zero-shot path on one GPU.

    python -m ct_clip_ut_tpu_torch.infer.profile_zeroshot [--table PATH]

At flagship width and the default configuration (`config.flagship_cfg()`:
the conv patch embed; random weights from seed 0) on [b, 1, 240, 480, 480]
bf16 volumes, with the 36 prompts tokenised padded to 512 tokens (the
stand-in `WordTokenizer`), it prints:

- the time of one `CTClipInference.prompt_latents()` (the prompt encoding,
  12 bert_layer chains; host clock around a synchronised call, after one
  warm-up encoding) and its launch counts;
- per batch size b in SIZES: volumes/s of `CTClipInference.predict` over
  BATCHES batches (host clock around the loop, which ends in one
  device-to-host copy of the probabilities), as the median, min and max of
  REPEATS loops, and the peak device memory of those loops;
- one `zeroshot_probs` call at b = PROFILE_BATCH under torch.profiler: the
  host wall time, the device's summed kernel time, its busy time (the
  union of kernel intervals) and busy share of the wall time, the launch
  counts of the port's kernels, and the device kernels ranked by time.
  --table writes every kernel's row to PATH.

Each line names the card and its power limit (`nvidia-smi`).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from ..config import flagship_cfg
from ..models.ctclip import init_ctclip
from ..ops import launches
from .zeroshot import (CTClipInference, WordTokenizer, encode_prompt_latents, tokenize_prompts,
                       zeroshot_probs)

VOLUME = (1, 240, 480, 480)          # [c, T, H, W] of the flagship's volumes
SIZES, BATCHES, REPEATS, PROFILE_BATCH = (1, 2, 4, 8), 30, 5, 2
PROMPT_LEN = 512                     # the JAX zero-shot's padding (infer/zeroshot.py:49-58)


def card_name() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def throughput(runner: CTClipInference, image: torch.Tensor, batches: int,
               repeats: int) -> dict:
    """predict() over `batches` copies of `image`, `repeats` times."""
    b = image.shape[0]
    runner.data = [(image, None, np.zeros((b, 18)))] * batches
    zeroshot_probs(runner.model, image, runner.prompt_latents())      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        runner.predict()
        rates.append(b * batches / (time.perf_counter() - t0))
    return dict(median=statistics.median(rates), min=min(rates), max=max(rates),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def device_profile(model, image: torch.Tensor, latents: torch.Tensor) -> dict:
    """One zeroshot_probs call under torch.profiler."""
    return profile_call(lambda: zeroshot_probs(model, image, latents))


def profile_call(fn) -> dict:
    """fn() once as a warm-up, then once under torch.profiler with the
    launch counters reset: host wall time, summed device kernel time, busy
    time (the union of kernel intervals) and share, launch counts, and the
    device kernels ranked by time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    launches.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    counts = launches.launch_counts()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    busy, reach = 0.0, -float("inf")
    by_name = defaultdict(lambda: [0.0, 0])
    for start, end, name in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name][0] += end - start
        by_name[name][1] += 1
    total = sum(v[0] for v in by_name.values())
    return dict(wall_ms=wall_us / 1e3, kernel_ms=total / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / wall_us, counts=counts,
                rows=sorted(((v[0] / 1e3, v[1], name) for name, v in by_name.items()),
                            reverse=True))


def print_profile(p: dict, label: str, card: str, table=None, top: int = 20) -> None:
    """The profile's summary line, its top kernels, and every row to `table`."""
    print(f"{label}: wall {p['wall_ms']:.3f} ms, device kernel time {p['kernel_ms']:.3f} ms, "
          f"busy {p['busy_ms']:.3f} ms = {100 * p['busy_share']:.1f}% of the wall; "
          f"launches {p['counts']} [{card}]")
    for ms, n, name in p["rows"][:top]:
        print(f"  {ms:9.3f} ms {100 * ms / p['kernel_ms']:5.1f}% {n:5d}x  {name[:90]}")
    if table:
        with open(table, "w") as f:
            f.write(f"# {label} [{card}]: ms, share of kernel time, calls, kernel\n")
            for ms, n, name in p["rows"]:
                f.write(f"{ms:.4f}\t{100 * ms / p['kernel_ms']:.2f}%\t{n}\t{name}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--table", default=None, help="write every kernel's profile row here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_zeroshot: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    cfg = flagship_cfg()
    model = init_ctclip(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    prompts = tokenize_prompts(WordTokenizer(cfg.bert.vocab_size), max_length=PROMPT_LEN,
                               device="cuda")
    encode_prompt_latents(model, prompts)                           # warm-up
    torch.cuda.synchronize()
    launches.reset_launch_counts()
    runner = CTClipInference(model, prompts, [])
    t0 = time.perf_counter()
    latents = runner.prompt_latents()
    torch.cuda.synchronize()
    print(f"prompt_latents: 36 prompts x {PROMPT_LEN} tokens in "
          f"{1e3 * (time.perf_counter() - t0):.3f} ms; launches {launches.launch_counts()} "
          f"[{card}]", flush=True)

    def volumes(b):
        return torch.randn((b, *VOLUME), generator=g, device="cuda", dtype=torch.bfloat16)

    for b in SIZES:
        r = throughput(runner, volumes(b), BATCHES, REPEATS)
        print(f"throughput B={b}: predict() over {BATCHES} batches x {REPEATS}: "
              f"median {r['median']:.3f} volumes/s (min {r['min']:.3f}, max {r['max']:.3f}), "
              f"peak {r['peak_gb']:.3f} GB [{card}]", flush=True)

    b = PROFILE_BATCH
    print_profile(device_profile(model, volumes(b), latents), f"profile B={b}", card, args.table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
