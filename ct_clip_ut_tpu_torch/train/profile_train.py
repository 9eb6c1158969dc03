"""Throughput and device-time profile of the train step on one GPU.

    python -m ct_clip_ut_tpu_torch.train.profile_train [--table PATH] [--sizes 2,4,8]
                                                       [--text-len 512] [--peg both]

The counterpart of infer/profile_zeroshot.py and of the JAX bench's train
measurement (bench.py:335-381). At flagship width (`config.flagship_cfg()`,
random weights from TrainConfig.seed) with the TrainConfig defaults (bf16
compute, Adam, lr 1.25e-5, clip 0.5, 512-token reports from the stand-in
`WordTokenizer`: BERT trains through the fused bert_layer kernels), on
[b, 1, 240, 480, 480] bf16 volumes, it prints for the PEG on its kernels
(`peg_pallas=True`) and on F.conv3d (`--peg on` or `off` for one of them):

- per batch size b: train volumes/s and ms per step of `make_train_step`
  over LOOPS loops of STEPS steps each (the steps queued back to back, one
  synchronisation at the end of each loop; host clock), as the median, min
  and max of the loops, after WARMUP steps, and the peak device memory;
- one train step at b = PROFILE_BATCH with `peg_pallas=True` (or the one
  route asked for) under torch.profiler: the host wall time, the summed
  device kernel time, the busy time and share, the launch counts of the
  port's kernels, and the device kernels ranked by time (--table writes
  every row to PATH).

`--text-len 120` measures the earlier slice's reports, under the fused BERT
layer's gate (n >= 128), where BERT trains on its layer loop. Each line
names the card and its power limit (`nvidia-smi`).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time

import torch

from ..config import TrainConfig, flagship_cfg, replace
from ..infer.profile_zeroshot import card_name, print_profile, profile_call
from ..infer.zeroshot import WordTokenizer
from .trainer import create_train_state, make_train_step

VOLUME = (1, 240, 480, 480)
TEXT_LEN = 512                       # the TrainConfig default (120: under the fused-layer gate)
SIZES, LOOPS, STEPS, WARMUP, PROFILE_BATCH = (2, 4, 8), 5, 10, 2, 2


def reports(b: int, max_length: int = TEXT_LEN, vocab: int = 30522, device="cuda") -> dict:
    """b stand-in radiology reports, tokenised and padded to max_length."""
    words = ("the lungs are clear without consolidation effusion or nodule heart size is "
             "normal mild emphysema and atelectasis in the lower lobes no lymphadenopathy").split()
    count = 20 if max_length < 128 else 250          # words a report: most of the length is real
    texts = [" ".join(words[(i * 7 + j) % len(words)] for j in range(count + 5 * i)) + "."
             for i in range(b)]
    enc = WordTokenizer(vocab)(texts, max_length=max_length)
    return {k: torch.as_tensor(v, device=device) for k, v in enc.items()}


def measure(cfg, tcfg, sizes, card: str, label: str):
    """The step loop at each batch size; returns (state, step, batch maker)."""
    state = create_train_state(cfg, tcfg, device="cuda")
    step = make_train_step(cfg, tcfg)
    g = torch.Generator(device="cuda").manual_seed(0)

    def batch(b):
        return (torch.randn((b, *VOLUME), generator=g, device="cuda", dtype=torch.bfloat16),
                reports(b, tcfg.text_max_length, vocab=cfg.bert.vocab_size))

    for b in sizes:
        image, text = batch(b)
        for _ in range(WARMUP):
            step(state, image, text)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(LOOPS):
            t0 = time.perf_counter()
            out = [step(state, image, text) for _ in range(STEPS)]
            losses.append(torch.stack(out).float().cpu())
            times.append((time.perf_counter() - t0) / STEPS)
        ms = [1e3 * t for t in times]
        if not torch.isfinite(torch.cat(losses)).all():
            raise RuntimeError(f"non-finite train loss at B={b}")
        print(f"train {label} B={b}: {LOOPS} loops x {STEPS} steps: median "
              f"{b / statistics.median(times):.3f} volumes/s, step {statistics.median(ms):.3f} ms "
              f"(min {min(ms):.3f}, max {max(ms):.3f}), peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, last loss "
              f"{losses[-1][-1].item():.4f} [{card}]", flush=True)
        del image, text
    return state, step, batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--table", default=None, help="write every kernel's profile row here")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="comma-separated batch sizes")
    ap.add_argument("--text-len", type=int, default=TEXT_LEN,
                    help="tokens a report is padded to (TrainConfig.text_max_length)")
    ap.add_argument("--peg", choices=("both", "on", "off"), default="both",
                    help="the PEG on its kernels (peg_pallas=True), on F.conv3d, or both in turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    tcfg = dataclasses.replace(TrainConfig(), text_max_length=args.text_len)
    sizes = [int(s) for s in args.sizes.split(",")]
    routes = {"both": (False, True), "on": (True,), "off": (False,)}[args.peg]
    for fused in routes:                       # the profiled route comes last
        cfg = flagship_cfg()
        cfg = replace(cfg, ctvit=replace(cfg.ctvit, peg_pallas=fused))
        label = f"{args.text_len} tokens, peg_pallas={fused},"
        state, step, batch = measure(cfg, tcfg, sizes, card, label)
        if fused is routes[-1]:
            print(f"train state: {sum(p.numel() for p in state.model.parameters()) / 1e6:.1f} M "
                  f"parameters [{card}]", flush=True)
            image, text = batch(PROFILE_BATCH)
            print_profile(profile_call(lambda: step(state, image, text)),
                          f"profile train step B={PROFILE_BATCH}, {label}", card, args.table,
                          top=30)
        del state, step, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
