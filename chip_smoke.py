#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (ct_clip_ut_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its lines before the last:
  1. the device: `nvidia-smi` name and power limit, torch and CUDA versions;
  2. the build of csrc/*.cu, with its seconds;
  3. each of the four kernels against its plain PyTorch version on the card,
     at the flagship shapes predict() gives it for 2 volumes, in bf16, with
     both times; each float check also shows that its band rejects a kernel
     that leaves out a norm gain, LN bias, q/k scale or the position bias;
  4. the zero-shot slice at flagship width (random weights from a seed):
     prompt latents once from 36 random 24-token prompts, then
     CTClipInference.predict over 3 batches of 2 bf16 volumes
     [2, 1, 240, 480, 480]; every kernel's launch count must be > 0, and the
     encoder output and one batch's image latents must agree with the
     plain path.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed phase exits non-zero before it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

# Read on an H100 80GB HBM3 at 700 W: the float kernels' branches within
# 3.3e-3 to 4.2e-3 of their plain versions, the fault controls 0.13 to 0.94.
FLOAT_BAND = 1.5e-2      # max relative error of a float kernel's branch vs its plain version
VQ_AGREE = 0.999         # least share of equal VQ indices
VQ_TIE = 1e-3            # a mismatch must be a near-tie: fp32 sims within this
# The end-to-end bands sit between the same card's readings (encoder 1.2e-2: bf16
# flips from fp32 sums in another order, over 8 layers; latents 8.6e-3: 2.3%
# of VQ indices flip at near-ties) and the controls (1.0 and 0.8), see PERF.md.
ENCODER_BAND = 3e-2      # relative rms of the CT-ViT encoder output vs the plain path
LATENT_BAND = 3e-2       # 1 - cosine of batch 0's image latents vs the plain path
BATCHES, BATCH = 3, 2
VOLUME = (1, 240, 480, 480)

KERNELS = {
    "attn_block": ("ct_clip_ut_tpu_torch/csrc/attn_block.cu",
                   "ct_clip_ut_tpu/ops/pallas_attn_block.py:192"),
    "attn_packed": ("ct_clip_ut_tpu_torch/csrc/attn_packed.cu",
                    "ct_clip_ut_tpu/ops/pallas_attn_packed.py:230"),
    "geglu_ff": ("ct_clip_ut_tpu_torch/csrc/geglu_ff.cu",
                 "ct_clip_ut_tpu/ops/pallas_ff.py:120"),
    "vq_nearest": ("ct_clip_ut_tpu_torch/csrc/vq_nearest.cu",
                   "ct_clip_ut_tpu/ops/pallas_vq.py:56"),
}


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def rel_rms(got, want) -> float:
    """||got - want|| / ||want||."""
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def kernel_phase(torch, model, card: str) -> dict:
    """Each kernel vs its plain version at the shapes predict() gives it at
    B = BATCH; returns the per-kernel record (without launch counts).

    The float kernels are compared on their branch (residual=False), with
    the norm gains, LN bias and q/k scales drawn as 1 + 0.1 N (beta 0.1 N)
    rather than the init's ones and zeros. Each check also reads its
    controls: the kernel's output against the plain version with one of
    those parameters (or the position bias) left out. A control at or under
    the band means the band cannot tell such a faulty kernel from a right
    one, and fails the phase."""
    from ct_clip_ut_tpu_torch.ops.attn_block import attn_block, attn_block_plain
    from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed, attn_packed_plain
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff, geglu_ff_plain
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.layers import l2norm
    from ct_clip_ut_tpu_torch.ops.posbias import continuous_pos_bias
    from ct_clip_ut_tpu_torch.ops.vq_nearest import vq_nearest, vq_nearest_plain

    vit = model.visual_transformer
    cfg = vit.cfg
    g = torch.Generator(device="cuda").manual_seed(7)
    bf = torch.bfloat16
    t, h, w = token_grid_shape(cfg, VOLUME)
    hw, d = h * w, cfg.dim

    def around(base, n):
        return base + 0.1 * torch.randn((n,), generator=g, device="cuda")

    def attn_args(tf):
        a = tf.layers[0][1]
        wkv = a.to_kv.weight.to(bf)
        inner, dh = a.cfg.inner_dim, a.cfg.dim_head
        return [around(1.0, d), a.to_q.weight.to(bf), wkv[:inner].contiguous(),
                wkv[inner:].contiguous(), a.to_out.weight.to(bf), around(1.0, dh),
                around(1.0, dh)]

    bias = continuous_pos_bias(vit.spatial_rel_pos_bias, cfg.patch_height, cfg.patch_width)
    xs = torch.randn((BATCH * t, hw, d), generator=g, device="cuda").to(bf)
    xt = torch.randn((BATCH * hw, t, d), generator=g, device="cuda").to(bf)
    ff = vit.enc_spatial_transformer.layers[0][3]
    xf = torch.randn((BATCH * t * hw, d), generator=g, device="cuda").to(bf)
    scale = vit.enc_spatial_transformer.layers[0][1].cfg.scale

    # name: (kernel, plain, args before `residual`, {control: (arg index, neutral value)})
    attn_faults = {"no gamma": (1, 1.0), "no q_scale": (6, 1.0), "no k_scale": (7, 1.0)}
    cases = {
        "attn_block": (attn_block, attn_block_plain,
                       [xs, *attn_args(vit.enc_spatial_transformer), bias, scale],
                       {**attn_faults, "no bias": (8, 0.0)}),
        "attn_packed": (attn_packed, attn_packed_plain,
                        [xt, *attn_args(vit.enc_temporal_transformer), scale], attn_faults),
        "geglu_ff": (geglu_ff, geglu_ff_plain,
                     [xf, around(1.0, d), 0.1 * torch.randn((d,), generator=g, device="cuda"),
                      ff[1].weight.to(bf), ff[4].weight.to(bf)],
                     {"no gamma": (1, 1.0), "no beta": (2, 0.0)}),
    }
    out = {}
    for name, (kern, plain, args, faults) in cases.items():
        got = kern(*args, residual=False)
        want = plain(*args, residual=False)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        abs_err = (got.float() - want.float()).abs().max().item()
        rel = rel_err(got, want)
        controls = {}
        for fault, (i, value) in faults.items():
            wrong = list(args)
            wrong[i] = torch.full_like(args[i], value)
            controls[fault] = rel_err(got, plain(*wrong, residual=False))
        ms = cuda_ms(torch, lambda: kern(*args, residual=True))
        plain_ms = cuda_ms(torch, lambda: plain(*args, residual=True))
        print(f"kernel {name} x {list(args[0].shape)}: branch max_rel_err {rel:.3e} "
              f"(band {FLOAT_BAND}) max_abs_err {abs_err:.3e} (branch max "
              f"{want.float().abs().max().item():.3e}); controls "
              + ", ".join(f"{k} {v:.3e}" for k, v in controls.items())
              + f"; {ms:.3f} ms vs plain {plain_ms:.3f} ms [{card}]")
        if not rel <= FLOAT_BAND:
            raise AssertionError(f"{name}: max relative error {rel} over {FLOAT_BAND}")
        blind = {k: v for k, v in controls.items() if not v > FLOAT_BAND}
        if blind:
            raise AssertionError(f"{name}: the band {FLOAT_BAND} passes faulty kernels {blind}")
        out[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)

    tok = l2norm(torch.randn((BATCH * t * hw, d), generator=g, device="cuda")).to(bf)
    cb = vit.vq.state().embed.to(bf)
    got, want = vq_nearest(tok, cb).long(), vq_nearest_plain(tok, cb).long()
    torch.cuda.synchronize()
    agree = (got == want).float().mean().item()
    bad = (got != want).nonzero().flatten()
    gap = 0.0
    if bad.numel():
        sims = tok[bad].float() @ cb.float().t()
        gap = (sims.gather(1, got[bad, None]) - sims.gather(1, want[bad, None])).abs().max().item()
    ms = cuda_ms(torch, lambda: vq_nearest(tok, cb))
    plain_ms = cuda_ms(torch, lambda: vq_nearest_plain(tok, cb))
    print(f"kernel vq_nearest {list(tok.shape)} x {list(cb.shape)}: {agree:.6f} of indices "
          f"equal (band {VQ_AGREE}), {bad.numel()} mismatches, largest sim gap {gap:.3e} "
          f"(band {VQ_TIE}); {ms:.3f} ms vs plain {plain_ms:.3f} ms [{card}]")
    if agree < VQ_AGREE or gap > VQ_TIE:
        raise AssertionError(f"vq_nearest: agreement {agree}, tie gap {gap}")
    out["vq_nearest"] = dict(max_abs_err=gap, ms=ms, plain_ms=plain_ms)
    return out


def slice_phase(torch, model, card: str) -> dict:
    """The zero-shot path through CTClipInference.predict; returns launch counts."""
    import numpy as np

    from ct_clip_ut_tpu_torch.infer.zeroshot import CTClipInference, zeroshot_probs
    from ct_clip_ut_tpu_torch.models.ctclip import encode_image_latents
    from ct_clip_ut_tpu_torch.models.ctvit import ctvit_encode, token_grid_shape
    from ct_clip_ut_tpu_torch.ops import launches

    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.bert.vocab_size, (36, 24), generator=g, device="cuda")
    prompts = {"input_ids": ids, "attention_mask": torch.ones_like(ids)}
    rng = np.random.default_rng(1)
    data = [(torch.randn((BATCH, *VOLUME), generator=g, device="cuda", dtype=torch.bfloat16),
             None, rng.integers(0, 2, (BATCH, 18))) for _ in range(BATCHES)]
    runner = CTClipInference(model, prompts, data)
    latents = runner.prompt_latents()
    zeroshot_probs(model, data[0][0], latents)            # warm-up (cuDNN plans, build)
    torch.cuda.synchronize()

    launches.reset_launch_counts()
    t0 = time.perf_counter()
    preds, targets = runner.predict()
    seconds = time.perf_counter() - t0
    counts = launches.launch_counts()
    print(f"slice: CTClipInference.predict {BATCHES} x {BATCH} volumes in {seconds:.3f} s "
          f"(smoke reading, host clock: {BATCHES * BATCH / seconds:.3f} volumes/s) [{card}]; "
          f"launches {json.dumps(counts)}")
    if preds.shape != (BATCHES * BATCH, 18) or not np.isfinite(preds).all():
        raise AssertionError(f"bad predictions: shape {preds.shape}")
    if not ((preds >= 0) & (preds <= 1)).all():
        raise AssertionError("probabilities outside [0, 1]")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # the encoder (spatial + temporal stacks, every float kernel) on one
    # token grid, and batch 0's image latents, kernel path vs plain path.
    # N(0, 1) tokens stand in for the patch embed's LN output. The controls
    # are the distances between the batch's two volumes (the signal).
    vit = model.visual_transformer
    t, h, w = token_grid_shape(vit.cfg, VOLUME)
    tokens = torch.randn((BATCH, t, h, w, vit.cfg.dim), generator=g, device="cuda",
                         dtype=torch.bfloat16)
    with torch.no_grad():
        enc = ctvit_encode(vit, tokens)[0].float()
        enc_plain = ctvit_encode(vit, tokens, plain=True)[0].float()
        enc_fp32 = ctvit_encode(vit, tokens.float(), plain=True)[0]
        lat, out = encode_image_latents(model, data[0][0])
        lat_plain, out_plain = encode_image_latents(model, data[0][0], plain=True)
    lat, lat_plain = lat.float(), lat_plain.float()
    if not torch.isfinite(enc).all() or not torch.isfinite(lat).all():
        raise AssertionError("non-finite encoder output or image latents")
    if lat.shape != (BATCH, cfg.dim_latent):
        raise AssertionError(f"bad image latents: shape {tuple(lat.shape)}")
    enc_err = rel_rms(enc, enc_plain)
    enc_control = rel_rms(enc_plain[1], enc_plain[0])
    cos = torch.nn.functional.cosine_similarity      # in fp32: bf16 latents are not unit
    lat_err = (1.0 - cos(lat, lat_plain, dim=-1)).max().item()
    lat_control = (1.0 - cos(lat_plain[0], lat_plain[1], dim=-1)).item()
    same_ids = (out.codebook_ids == out_plain.codebook_ids).float().mean().item()
    print(f"slice: encoder output vs the plain path: relative rms {enc_err:.3e} (band "
          f"{ENCODER_BAND}), max_rel_err {rel_err(enc, enc_plain):.3e}; control (volume 0 vs 1) "
          f"{enc_control:.3e}; the plain path in bf16 vs in fp32: relative rms "
          f"{rel_rms(enc_plain, enc_fp32):.3e}")
    print(f"slice: batch 0 image latents vs the plain path: 1 - cos {lat_err:.3e} (band "
          f"{LATENT_BAND}), max abs diff {(lat - lat_plain).abs().max().item():.3e}, "
          f"{same_ids:.6f} of VQ indices equal; control (volume 0 vs 1) 1 - cos "
          f"{lat_control:.3e}; probabilities in [{preds.min():.4f}, {preds.max():.4f}]")
    if not enc_err <= ENCODER_BAND < enc_control:
        raise AssertionError(f"encoder output: relative rms {enc_err}, band {ENCODER_BAND}, "
                             f"control {enc_control}")
    if not lat_err <= LATENT_BAND < lat_control:
        raise AssertionError(f"image latents: 1 - cos {lat_err}, band {LATENT_BAND}, "
                             f"control {lat_control}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs the port on a GPU", file=sys.stderr)
        return 2
    try:
        from ct_clip_ut_tpu_torch import _build
        from ct_clip_ut_tpu_torch.config import flagship_cfg
        from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
    except ImportError:
        print("chip_smoke: run from the root of a checkout (ct_clip_ut_tpu_torch not found)",
              file=sys.stderr)
        return 2
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

        t0 = time.perf_counter()
        lib = _build.build()
        _build.load()
        print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

        model = init_ctclip(flagship_cfg(), seed=0, device="cuda")
        record = kernel_phase(torch, model, card)
        counts = slice_phase(torch, model, card)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep, launches=counts[n],
                    **record[n]) for n, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
