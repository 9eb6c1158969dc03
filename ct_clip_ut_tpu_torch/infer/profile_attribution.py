"""Time and memory of the attribution methods on one GPU.

    python -m ct_clip_ut_tpu_torch.infer.profile_attribution [--table PATH]
                                                             [--windows N] [--repeats R]
                                                             [--quantize-ff]

At flagship width (`config.flagship_cfg()`, random weights from seed 0;
the suite embeds patches by matmul, `capture.parity_cfg`) on one [1, 1,
240, 480, 480] fp32 volume with a 512-token stand-in prompt (the
`WordTokenizer`), after one warm-up call of each, it prints:

- `raw_attention_maps`: seconds a map set (host clock around a
  synchronised call; the median, min and max of R calls) and its peak
  device memory;
- `rollout_maps`: seconds a pair, the device part (`rollout_volumes`,
  synchronised) and the host expansion (two `upsample_to_host` calls to
  the scan shape) apart, and the pipelined form's seconds a pair over R
  items (`rollout_maps_pipelined`, the next item's forward queued before
  the host expands the last);
- the occlusion sweep (`occlusion_scores_multi`, frame-sparse, chunk 8,
  two latents) over the first N windows of the 12,167 of the flagship grid:
  ms a window, the projected seconds of the full sweep, and peak memory;
- a one-chunk sweep under torch.profiler (the clean caches, the baseline
  and 7 windows): device kernel time, busy share, launch counts, kernels
  ranked by time (--table writes every row);
- `grad_cam_volumes`: seconds a map set and peak memory (R calls), and
  `grad_cam_maps` with the host expansion of its six maps;
- `integrated_gradients` at its defaults (50 steps in chunks of 5): seconds
  a map and a step over R maps, peak memory, and the pipelined form over R
  items;
- one IG chunk (5 steps: the batched forward and its backward) under
  torch.profiler, as the sweep's (--table writes its rows to PATH.ig).

With --quantize-ff the model's visual FFs are quantised W8A8
(`quantize_ctclip_ff`, the `inference_ctclip --quantize-ff` model): every
FF of the forward methods runs row 15f (`geglu_ff_int8` on fp32 rows).
The forward methods run as above (raw attention, rollout, the occlusion
sweep and its one-chunk profile, which also prints row 15f's launches, its
kernels' ms and their share of the chunk's kernel time); Grad-CAM and
integrated gradients are skipped, and say so: the int8 route has no
gradient (serving only).

Each line names the card and its power limit (`nvidia-smi`). The module
imports the package by absolute name only, so it also runs as a file
against another checkout of the port on PYTHONPATH.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from ct_clip_ut_tpu_torch.attribution import capture, grad_cam, occlusion, raw_attention, rollout
from ct_clip_ut_tpu_torch.attribution import integrated_gradients as ig
from ct_clip_ut_tpu_torch.config import OcclusionConfig, flagship_cfg
from ct_clip_ut_tpu_torch.infer.profile_zeroshot import card_name, print_profile, profile_call
from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer, tokenize_prompts
from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
from ct_clip_ut_tpu_torch.ops.quant import quantize_ctclip_ff

VOLUME = (1, 240, 480, 480)          # [c, T, H, W] of the flagship's volumes
PROMPT_LEN, CHUNK = 512, 8
FULL_SWEEP = 12167                   # windows of the flagship grid (23^3)
INT8_FF = "q8::"                     # in row 15f's kernels' names, as the profiler gives them


def timed(fn, repeats: int) -> dict:
    """fn() `repeats` times after a warm-up: seconds (median, min, max) of
    each synchronised call, and the peak device memory of them."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return dict(median=statistics.median(secs), min=min(secs), max=max(secs),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def line(r: dict, unit: str = "s") -> str:
    return (f"median {r['median']:.4f} {unit} (min {r['min']:.4f}, max {r['max']:.4f}), peak "
            f"{r['peak_gb']:.2f} GB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--table", default=None, help="write every kernel's profile row here")
    ap.add_argument("--windows", type=int, default=160, help="occlusion windows swept")
    ap.add_argument("--repeats", type=int, default=3, help="timed calls of each method")
    ap.add_argument("--quantize-ff", action="store_true",
                    help="the forward methods on the model with its visual FFs quantised W8A8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_attribution: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    cfg = flagship_cfg()
    model = init_ctclip(cfg, seed=0, device="cuda")
    if args.quantize_ff:
        model = quantize_ctclip_ff(model)
        print(f"--quantize-ff: the visual FFs quantised W8A8 (row 15f on fp32 rows) [{card}]",
              flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    image = torch.randn((1, *VOLUME), generator=g, device="cuda")
    prompt = {k: v[:1] for k, v in tokenize_prompts(WordTokenizer(cfg.bert.vocab_size),
                                                    max_length=PROMPT_LEN, device="cuda").items()}
    target = VOLUME[1:]

    r = timed(lambda: raw_attention.raw_attention_maps(model, prompt, image), args.repeats)
    print(f"raw_attention_maps: {line(r)} a map set [{card}]", flush=True)

    r = timed(lambda: rollout.rollout_volumes(model, prompt, image), args.repeats)
    sp, tm = (v.cpu().numpy() for v in rollout.rollout_volumes(model, prompt, image))
    hosts = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for v in (sp, tm):
            capture.upsample_to_host(v, target)
        hosts.append(time.perf_counter() - t0)
    items = [(prompt, image)] * args.repeats
    list(rollout.rollout_maps_pipelined(model, items[:1]))            # warm-up
    t0 = time.perf_counter()
    n = sum(1 for _ in rollout.rollout_maps_pipelined(model, items))
    piped = (time.perf_counter() - t0) / n
    print(f"rollout_maps: device {line(r)}; host expansion of the pair median "
          f"{statistics.median(hosts):.4f} s (min {min(hosts):.4f}, max {max(hosts):.4f}); "
          f"pipelined {piped:.4f} s a pair over {n} items [{card}]", flush=True)

    occ = OcclusionConfig()
    grid = occlusion.window_grid(target, occ.patch_size, occ.stride)
    latents = torch.stack([occlusion.report_text_latent(model, prompt),
                           occlusion.diff_embedding_latent(
                               model, torch.randn((cfg.dim_text,), generator=g, device="cuda"))])

    def sweep(coords):
        return occlusion.occlusion_scores_multi(model, image, latents, coords, occ=occ,
                                                chunk=CHUNK)

    r = timed(lambda: sweep(grid[:args.windows]), 1)
    ms = 1e3 * r["median"] / args.windows
    print(f"occlusion: frame-sparse, chunk {CHUNK}, 2 latents, {args.windows} windows in "
          f"{r['median']:.3f} s: {ms:.3f} ms a window, a full {FULL_SWEEP}-window sweep "
          f"~{FULL_SWEEP * ms / 1e3:.1f} s, peak {r['peak_gb']:.2f} GB (the clean caches "
          f"included) [{card}]", flush=True)
    prof = profile_call(lambda: sweep(grid[:CHUNK - 1]))
    print_profile(prof, f"profile of a one-chunk sweep (the clean caches, the baseline and "
                        f"{CHUNK - 1} windows)", card, args.table)
    if args.quantize_ff:
        ff = [(ms, n, k) for ms, n, k in prof["rows"] if INT8_FF in k]
        ff_ms = sum(ms for ms, _, _ in ff)
        calls = prof["counts"].get("geglu_ff_int8_f32", 0)
        print(f"row 15f in the one-chunk sweep: {calls} calls, {sum(n for _, n, _ in ff)} "
              f"launches, {ff_ms:.3f} ms of kernels ({100 * ff_ms / prof['kernel_ms']:.1f}% of "
              f"the chunk's {prof['kernel_ms']:.3f} ms; busy {100 * prof['busy_share']:.1f}% of "
              f"the wall): "
              + "; ".join(f"{k.split('(')[0][-60:]} x{n} {ms:.3f} ms" for ms, n, k in ff)
              + f" [{card}]", flush=True)
        print("grad_cam, integrated_gradients: skipped with --quantize-ff (the int8 FF is "
              "serving-only: it has no gradient)", flush=True)
        return 0

    r = timed(lambda: grad_cam.grad_cam_volumes(model, prompt, image), args.repeats)
    t0 = time.perf_counter()
    grad_cam.grad_cam_maps(model, prompt, image)
    print(f"grad_cam_volumes: {line(r)} a map set; grad_cam_maps with the host expansion of the "
          f"six maps {time.perf_counter() - t0:.4f} s [{card}]", flush=True)

    r = timed(lambda: ig.integrated_gradients(model, prompt, image), args.repeats)
    items = [(prompt, image)] * args.repeats
    t0 = time.perf_counter()
    n = sum(1 for _ in ig.integrated_gradients_pipelined(model, items))
    piped = (time.perf_counter() - t0) / n
    print(f"integrated_gradients: 50 steps, chunk 5: {line(r)} a map, {r['median'] / 50:.4f} s a "
          f"step; pipelined {piped:.4f} s a map over {n} items [{card}]", flush=True)
    print_profile(profile_call(lambda: ig._ig_avg_grads(model, prompt, image, steps=5, chunk=5)),
                  "profile of one integrated-gradients chunk (5 steps: the batched forward and "
                  "its backward, the text tower once)", card,
                  args.table and f"{args.table}.ig")
    return 0


if __name__ == "__main__":
    sys.exit(main())
