"""Times of the fp32 backward chains of the CT-ViT's blocks on one GPU.

    python -m ct_clip_ut_tpu_torch.infer.profile_backward [--repeats 3]

At flagship width (`config.flagship_cfg()`, random weights from seed 0;
layer 0's spatial block, temporal block and FF, gains drawn as 1 + 0.1 N,
the FF's beta as 0.1 N, the spatial CPB bias at the flagship volume's
token grid) on N(0, 1) inputs and cotangents, TF32 off, it times with
CUDA events (ten calls after two warm-ups, the median of `repeats` such
windows):

- the data-gradient chains at an integrated-gradients chunk's shapes (5
  volumes): `attn_block_bwd_f32` [120, 576, 512] (from the forward's kept
  row statistics where the package has `attn_block(..., keep=True)`, and
  rerunning the forward core), `attn_packed_bwd_f32` [2880, 24, 512],
  `geglu_ff_bwd_f32` [69120, 512];
- the full chains at a B = 2 fp32 train step's shapes, the residual on:
  `attn_block_bwd` [48, 576, 512] (kept statistics where available),
  `attn_packed_bwd` [1152, 24, 512], `geglu_ff_bwd` [27648, 512].

With --stages it times instead, stage by stage, the fp32 BERT layer of a
B = 2 fp32 train step (rows 6F and 12F: x [2, 512, 768], 12 heads of 64, F
= 3072, dropout 0.1 / 0.1, one sequence padded after 300 tokens: 812 real
keys, as chip_smoke.py phase 15 draws them), row 6 (the same layer,
deterministic, over the 36 zero-shot prompts) and the fp32 q-row attention
of CTGenerate's one-scan forward (row 13f: x [1, 6464, 512], 8 heads of
64, an fp32 [8, 6464, 6464] bias table). Each chain's total is CUDA-event
time as above; its stages are the device times of its launches under
torch.profiler over `repeats` calls, grouped by kernel name (`STAGES_12F`,
`STAGES_6F`, `STAGES_13F`: the recompute forward, the LayerNorm backwards,
the dh1, dy, dctx and dx products, the two weight-gradient launches, the
attention passes and the column sums of 12F; the projections, the core and
the output projection of 13F). Where the package's forward can keep its
state for the backward (`bert_layer_fp32(..., keep=True)`), 12F is timed
from the kept state too.

It prints one line a chain and one JSON object of the medians. The module
imports the package by absolute name only, so that it also runs as a file
against another checkout of the port on PYTHONPATH: two versions timed in
turns in one session. Each line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import sys
from collections import defaultdict

import torch

from ct_clip_ut_tpu_torch.config import flagship_cfg
from ct_clip_ut_tpu_torch.infer.profile_zeroshot import card_name
from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
from ct_clip_ut_tpu_torch.ops import attn_block as ab
from ct_clip_ut_tpu_torch.ops import attn_packed as ap
from ct_clip_ut_tpu_torch.ops import geglu_ff as gf
from ct_clip_ut_tpu_torch.ops.posbias import continuous_pos_bias

VOLUME = (1, 240, 480, 480)
IG_CHUNK, BATCH = 5, 2
BERT_TOKENS, BERT_SHORT, BERT_WIDTH = 512, 300, 768     # 812 real keys at B = 2
PROMPTS = 36                                            # the zero-shot prompts, row 6
QROWS_TOKENS, QROWS_WIDTH, QROWS_HEADS = 6464, 512, 8   # MaskGit's token grid, 101 x 8 x 8


def window_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def layer_args(vit, g) -> tuple:
    """(bias, scale, the spatial and temporal blocks' and the FF's fp32 args)."""
    d = vit.cfg.dim

    def gains(n):
        return 1.0 + 0.1 * torch.randn((n,), generator=g, device="cuda")

    def attn(tf):
        a = tf.layers[0][1]
        inner, dh = a.cfg.inner_dim, a.cfg.dim_head
        wkv = a.to_kv.weight.detach().float()
        return [gains(d), a.to_q.weight.detach().float(), wkv[:inner].contiguous(),
                wkv[inner:].contiguous(), a.to_out.weight.detach().float(), gains(dh), gains(dh)]

    with torch.no_grad():
        bias = continuous_pos_bias(vit.spatial_rel_pos_bias, vit.cfg.patch_height,
                                   vit.cfg.patch_width).float().contiguous()
    ff = vit.enc_spatial_transformer.layers[0][3]
    ffw = [gains(d), 0.1 * torch.randn((d,), generator=g, device="cuda"),
           ff[1].weight.detach().float(), ff[4].weight.detach().float()]
    return (bias, vit.enc_spatial_transformer.layers[0][1].cfg.scale,
            attn(vit.enc_spatial_transformer), attn(vit.enc_temporal_transformer), ffw)


# (stage, kernel-name substrings), matched in order. A stage "a | b" takes
# a call's first matching launch as a and every later one as b; a stage
# "a, b" is a before the call's first attention launch and b after it.
STAGES_12F = (
    ("dh1 product", ("GeluBwdSplitEpi",)),
    ("recompute forward", ("attn_kernel", "split_kernel", "ln_split", "SplitEpi<",
                           "HiddenF32Epi")),
    ("LN2 backward | LN1 backward", ("ln_drop_bwd",)),
    ("dy product | dx product", ("F32OutEpi",)),
    ("dctx product", ("SplitOutEpi",)),
    ("attention", ("dq_f32", "dkv_f32")),
    ("weight gradients before the attention, weight gradients after it", ("wgrad",)),
    ("column sums", ("colsum",)),
)
STAGES_6F = (
    ("LN1 | LN2", ("ln_split",)),                  # before split_kernel, its substring
    ("x and weight planes", ("split_kernel",)),
    ("QKV product", ("SplitEpi<false>",)),
    ("attention core", ("attn_kernel",)),
    ("Wo product | W2 product", ("HiddenF32Epi", "F32OutEpi")),
    ("W1 product", ("SplitEpi<true>",)),
)
STAGES_13F = (
    ("output projection", ("F32OutEpi",)),
    ("projections", ("split_kernel", "QkvEpi")),
    ("core", ("core_kernel", "core_f32")),
)


def call_spans(fn) -> list:
    """(start, end, name) of each device launch of one fn() call under
    torch.profiler, in launch order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    return spans


def label_spans(spans, stages) -> list:
    """(stage, ms, name) of each launch of one call (see STAGES_12F)."""
    seen, out, after = defaultdict(int), [], False
    for start, end, name in spans:
        label = next((st for st, keys in stages if any(k in name for k in keys)), "other")
        if label == "attention":
            after = True
        if ", " in label:
            label = label.split(", ")[int(after)]
        if " | " in label:
            parts, k = label.split(" | "), seen[label]
            seen[label] += 1
            label = parts[min(k, len(parts) - 1)]
        out.append((label, (end - start) / 1e3, name))
    return out


def stage_times(fn, stages, repeats: int = 5) -> dict:
    """fn() `repeats` times, each under torch.profiler, after one warm-up:
    each stage's median device ms a call and its launches a call, in the
    order the stages first ran; the names of launches no stage takes."""
    fn()
    torch.cuda.synchronize()
    calls = [label_spans(call_spans(fn), stages) for _ in range(repeats)]
    order = list(dict.fromkeys(label for label, _, _ in calls[0]))
    rows = {}
    for label in order:
        per_call = [sum(ms for lb, ms, _ in c if lb == label) for c in calls]
        rows[label] = dict(ms=statistics.median(per_call),
                           launches=sum(1 for lb, _, _ in calls[0] if lb == label))
    total = [sum(ms for _, ms, _ in c) for c in calls]
    return dict(stages=rows, kernel_ms=statistics.median(total),
                other=sorted({nm[:120] for lb, _, nm in calls[0] if lb == "other"}))


def print_stages(label: str, st: dict, event_ms: float, card: str) -> None:
    print(f"{label}: {event_ms:.3f} ms a call (CUDA events), device kernel time "
          f"{st['kernel_ms']:.3f} ms [{card}]", flush=True)
    for name, r in st["stages"].items():
        print(f"  {r['ms']:8.4f} ms {r['launches']:3d}x  {name}")
    for name in st["other"]:
        print(f"  (other: {name})")


def main(argv=None) -> int:
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap_.add_argument("--repeats", type=int, default=3, help="timing windows of each chain")
    ap_.add_argument("--stages", action="store_true",
                     help="time rows 6F, 12F and 13f stage by stage instead")
    args = ap_.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_backward: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    if args.stages:
        return stages_main(args, card)
    vit = init_ctclip(flagship_cfg(), seed=0, device="cuda").visual_transformer
    g = torch.Generator(device="cuda").manual_seed(18)
    t, h, w = token_grid_shape(vit.cfg, VOLUME)
    hw, d = h * w, vit.cfg.dim
    bias, scale, sp, tm, ffw = layer_args(vit, g)
    kept = "keep" in inspect.signature(ab.attn_block).parameters

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def saved(x, residual):
        return {"saved": ab.attn_block(x, *sp, bias, scale, residual, keep=True)[1]} if kept else {}

    # name -> (x's shape, fn(x, g, kw), kw(x))
    cases = {
        "attn_block_bwd_f32 (7f)": ((IG_CHUNK * t, hw, d),
                                    lambda x, gg, kw: ab.attn_block_bwd_f32(x, *sp, bias, gg, scale,
                                                                            **kw),
                                    lambda x: saved(x, False)),
        "attn_block_bwd_f32 rerunning the core": ((IG_CHUNK * t, hw, d),
                                                  lambda x, gg, kw: ab.attn_block_bwd_f32(
                                                      x, *sp, bias, gg, scale),
                                                  lambda x: {}),
        "attn_packed_bwd_f32 (8f)": ((IG_CHUNK * hw, t, d),
                                     lambda x, gg, kw: ap.attn_packed_bwd_f32(x, *tm, gg, scale),
                                     lambda x: {}),
        "geglu_ff_bwd_f32 (9f)": ((IG_CHUNK * t * hw, d),
                                  lambda x, gg, kw: gf.geglu_ff_bwd_f32(x, *ffw, gg),
                                  lambda x: {}),
        "attn_block_bwd (7F)": ((BATCH * t, hw, d),
                                lambda x, gg, kw: ab.attn_block_bwd(x, *sp, bias, gg, scale, True,
                                                                    **kw),
                                lambda x: saved(x, True)),
        "attn_packed_bwd (8F)": ((BATCH * hw, t, d),
                                 lambda x, gg, kw: ap.attn_packed_bwd(x, *tm, gg, scale, True),
                                 lambda x: {}),
        "geglu_ff_bwd (9F)": ((BATCH * t * hw, d),
                              lambda x, gg, kw: gf.geglu_ff_bwd(x, *ffw, gg, True),
                              lambda x: {}),
    }
    out = {}
    with torch.no_grad():
        for name, (shape, fn, kw_of) in cases.items():
            x, gg = randn(*shape), randn(*shape)
            kw = kw_of(x)
            times = [window_ms(lambda: fn(x, gg, kw)) for _ in range(args.repeats)]
            out[name] = statistics.median(times)
            print(f"{name}: x {list(shape)} fp32, median {out[name]:.3f} ms (windows "
                  f"{', '.join(f'{v:.3f}' for v in times)}; kept statistics: "
                  f"{bool(kw)}) [{card}]", flush=True)
            del x, gg, kw
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def bert_inputs(g) -> tuple:
    """Row 6F / 12F's inputs at a B = 2 fp32 train step's shape: (x, mask_row,
    the twelve weights, dout, seeds), BERT's init scale (N(0, 0.02) matrices),
    the LN gains 1 + 0.1 N and the biases 0.1 N."""
    b, n, d, f = BATCH, BERT_TOKENS, BERT_WIDTH, 4 * BERT_WIDTH

    def randn(*shape, std=1.0):
        return std * torch.randn(shape, generator=g, device="cuda")

    lengths = torch.tensor([n, BERT_SHORT], device="cuda")
    pad = torch.arange(n, device="cuda")[None, :] >= lengths[:, None]
    mask_row = pad.float() * torch.finfo(torch.float32).min
    w = [randn(3 * d, d, std=0.02), randn(3 * d, std=0.1), randn(d, d, std=0.02),
         randn(d, std=0.1), 1.0 + randn(d, std=0.1), randn(d, std=0.1), randn(f, d, std=0.02),
         randn(f, std=0.1), randn(d, f, std=0.02), randn(d, std=0.1), 1.0 + randn(d, std=0.1),
         randn(d, std=0.1)]
    seeds = torch.tensor([20231, 77, 1 << 30], dtype=torch.int32, device="cuda")
    return randn(b, n, d), mask_row, w, randn(b, n, d), seeds


def qrows_inputs(g) -> tuple:
    """Row 13f's inputs at CTGenerate's one-scan shape: x [1, 6464, 512] and
    an fp32 [8, 6464, 6464] bias table, N(0, 1) entries; 8 heads of 64."""
    n, d, hd = QROWS_TOKENS, QROWS_WIDTH, QROWS_HEADS * 64

    def randn(*shape, std=1.0):
        return std * torch.randn(shape, generator=g, device="cuda")

    w = [1.0 + randn(d, std=0.1), randn(hd, d, std=d ** -0.5), randn(hd, d, std=d ** -0.5),
         randn(hd, d, std=d ** -0.5), randn(d, hd, std=hd ** -0.5), 1.0 + randn(64, std=0.1),
         1.0 + randn(64, std=0.1)]
    return randn(1, n, d), w, randn(QROWS_HEADS, n, n)


def stages_main(args, card: str) -> int:
    """--stages: rows 6F, 12F (rerun and, where the package keeps the
    forward's state, kept) and 13f, each a total and its stages."""
    from ct_clip_ut_tpu_torch.ops import attn_qrows as aq
    from ct_clip_ut_tpu_torch.ops import bert_layer as bl

    g = torch.Generator(device="cuda").manual_seed(24)
    x, mask_row, w, dout, seeds = bert_inputs(g)
    heads, eps = BERT_WIDTH // 64, 1e-12
    train = dict(p_attn=0.1, p_hidden=0.1, train=True, seeds=seeds)
    kept = "saved" in inspect.signature(bl.bert_layer_bwd_f32).parameters
    out = {}
    with torch.no_grad():
        def time_rows(label, fn, stages):
            ms = statistics.median(window_ms(fn) for _ in range(args.repeats))
            st = stage_times(fn, stages)
            print_stages(label, st, ms, card)
            out[label] = dict(ms=ms, kernel_ms=st["kernel_ms"],
                              stages={k: v["ms"] for k, v in st["stages"].items()})

        time_rows("6F bert_layer fp32 train [2, 512, 768]",
                  lambda: bl.bert_layer_fp32(x, mask_row, *w, heads, eps, **train), STAGES_6F)
        time_rows("12F bert_layer_bwd_f32 rerunning the forward",
                  lambda: bl.bert_layer_bwd_f32(x, mask_row, *w, dout, heads, eps, **train),
                  STAGES_12F)
        if kept:
            time_rows("6F keeping its state for 12F",
                      lambda: bl.bert_layer_fp32(x, mask_row, *w, heads, eps, **train,
                                                 keep=True), STAGES_6F)
            state = bl.bert_layer_fp32(x, mask_row, *w, heads, eps, **train, keep=True)[1]
            time_rows("12F bert_layer_bwd_f32 from the kept state",
                      lambda: bl.bert_layer_bwd_f32(x, mask_row, *w, dout, heads, eps, **train,
                                                    saved=state), STAGES_12F)
            del state
        xp = torch.randn((PROMPTS, BERT_TOKENS, BERT_WIDTH), generator=g, device="cuda")
        lengths = torch.randint(8, BERT_TOKENS, (PROMPTS,), generator=g, device="cuda")
        mp = ((torch.arange(BERT_TOKENS, device="cuda")[None] >= lengths[:, None]).float()
              * torch.finfo(torch.float32).min)
        time_rows("6 bert_layer fp32 deterministic [36, 512, 768] (the prompts)",
                  lambda: bl.bert_layer_fp32(xp, mp, *w, heads, eps), STAGES_6F)
        del x, mask_row, w, dout, xp
        torch.cuda.empty_cache()
        xq, wq, bias = qrows_inputs(g)
        time_rows("13f attn_qrows fp32 x [1, 6464, 512], bias [8, 6464, 6464]",
                  lambda: aq.attn_qrows(xq, *wq, bias, 8.0, True), STAGES_13F)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
