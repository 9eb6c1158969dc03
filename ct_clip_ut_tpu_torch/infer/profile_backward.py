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


def main(argv=None) -> int:
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap_.add_argument("--repeats", type=int, default=3, help="timing windows of each chain")
    args = ap_.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_backward: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
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


if __name__ == "__main__":
    sys.exit(main())
