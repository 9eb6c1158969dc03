"""Times of the fp32 forward chains of the CT-ViT's blocks at the shapes
an occlusion sweep launches them, on one GPU.

    python -m ct_clip_ut_tpu_torch.infer.profile_forward [--repeats 3] [--table PATH]

At flagship width (`config.flagship_cfg()`, random weights from seed 0;
layer 0's spatial block, temporal block and FF, gains drawn as 1 + 0.1 N,
the FF's beta as 0.1 N, the spatial CPB bias at the flagship volume's
token grid) on N(0, 1) inputs, TF32 off, the residual on, it times with
CUDA events (ten calls after two warm-ups, the median of `repeats` such
windows) the chains of a frame-sparse sweep's chunk of 8 windows:

- `attn_packed` fp32 (row 2f) over the chunk's temporal stacks, x [4608,
  24, 512]: 4 launches a chunk;
- `geglu_ff` fp32 (row 3f) over the chunk's temporal tokens [110592,
  512], its largest spatial slice [46080, 512] (8 windows x 10 frames x
  576 tokens at layer 3) and a slab's clean stack [13824, 512];
- `attn_block` fp32 (row 1f, the same chain with the bias) over a
  dense-shortcut chunk [192, 576, 512] and one volume [24, 576, 512].

Beside each it times the plain version (one window) and the same
function as a chain of PyTorch fp32 calls (the yardstick), gives the bound
(three bf16 products for each fp32 one at 989 TFLOP/s, or the bytes at
3.35 TB/s, the larger), the kernel's largest error relative to the plain
version's largest value, and one call's launches under torch.profiler
(each launch's ms: the LN pass, the products, the core; every row to
PATH.<case> with --table). It ends with one JSON object of the medians.
The module imports the package by absolute name only, so that it also
runs as a file against another checkout of the port on PYTHONPATH: two
versions timed in turns in one run. Each line names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch
import torch.nn.functional as F

from ct_clip_ut_tpu_torch.config import flagship_cfg
from ct_clip_ut_tpu_torch.infer.profile_backward import layer_args, window_ms
from ct_clip_ut_tpu_torch.infer.profile_zeroshot import card_name, print_profile, profile_call
from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
from ct_clip_ut_tpu_torch.ops import attn_block as ab
from ct_clip_ut_tpu_torch.ops import attn_packed as ap
from ct_clip_ut_tpu_torch.ops import geglu_ff as gf

VOLUME = (1, 240, 480, 480)
CHUNK = 8
BF16_PEAK, HBM_RATE = 989e12, 3.35e12
FULL_SWEEP_CHUNKS = 1521             # 12,167 windows in chunks of 8


def attn_chain(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale):
    """The block as PyTorch fp32 calls: F.layer_norm, F.linear, F.normalize,
    F.scaled_dot_product_attention (the bias as its additive mask), F.linear
    out, + x."""
    r, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh

    def heads_of(t):
        return t.view(r, n, heads, dh).transpose(1, 2)

    xn = F.layer_norm(x, (d,), gamma)
    q, k, v = heads_of(F.linear(xn, wq)), heads_of(F.linear(x, wk)), heads_of(F.linear(x, wv))
    q = F.normalize(q, dim=-1) * (qs * scale)
    k = F.normalize(k, dim=-1) * ks
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)
    return F.linear(o.transpose(1, 2).reshape(r, n, heads * dh), wo) + x


def ff_chain(x, gamma, beta, w_in, w_out):
    """The GEGLU FF as PyTorch fp32 calls: F.layer_norm, F.linear, F.gelu(gate)
    * value, F.linear, + x."""
    value, gate = F.linear(F.layer_norm(x, (x.shape[-1],), gamma, beta), w_in).chunk(2, dim=-1)
    return F.linear(F.gelu(gate) * value, w_out) + x


def main(argv=None) -> int:
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap_.add_argument("--repeats", type=int, default=3, help="timing windows of each chain")
    ap_.add_argument("--table", default=None, help="write each case's profile rows to PATH.<case>")
    args = ap_.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_forward: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    vit = init_ctclip(flagship_cfg(), seed=0, device="cuda").visual_transformer
    g = torch.Generator(device="cuda").manual_seed(23)
    t, h, w = token_grid_shape(vit.cfg, VOLUME)
    hw, d = h * w, vit.cfg.dim
    bias, scale, sp, tm, ffw = layer_args(vit, g)
    hd, inner = sp[1].shape[0], ffw[3].shape[1]

    def attn_flops(r, n):
        return 3 * (2 * r * n * d * hd * 4 + 4 * r * n * n * hd)

    def ff_flops(m):
        return 3 * 6 * m * d * inner

    # name -> (x's shape, kernel, plain, chain, flops, launches a chunk, a sweep)
    cases = {
        "2f": ((CHUNK * hw, t, d), lambda x: ap.attn_packed(x, *tm, scale, True),
               lambda x: ap.attn_packed_plain(x, *tm, scale, True),
               lambda x: attn_chain(x, *tm, None, scale), attn_flops(CHUNK * hw, t), 4,
               4 * FULL_SWEEP_CHUNKS),
        "3f": ((CHUNK * t * hw, d), lambda x: gf.geglu_ff(x, *ffw, True),
               lambda x: gf.geglu_ff_plain(x, *ffw, True), lambda x: ff_chain(x, *ffw),
               ff_flops(CHUNK * t * hw), 4, 4 * FULL_SWEEP_CHUNKS),
        "3f slice": ((CHUNK * 10 * hw, d), lambda x: gf.geglu_ff(x, *ffw, True),
                     lambda x: gf.geglu_ff_plain(x, *ffw, True), lambda x: ff_chain(x, *ffw),
                     ff_flops(CHUNK * 10 * hw), 1, FULL_SWEEP_CHUNKS),
        "3f clean": ((t * hw, d), lambda x: gf.geglu_ff(x, *ffw, True),
                     lambda x: gf.geglu_ff_plain(x, *ffw, True), lambda x: ff_chain(x, *ffw),
                     ff_flops(t * hw), 0, 4 * 6),
        "1f chunk": ((CHUNK * t, hw, d), lambda x: ab.attn_block(x, *sp, bias, scale, True),
                     lambda x: ab.attn_block_plain(x, *sp, bias, scale, True),
                     lambda x: attn_chain(x, *sp, bias, scale), attn_flops(CHUNK * t, hw), 4,
                     4 * FULL_SWEEP_CHUNKS),
        "1f volume": ((t, hw, d), lambda x: ab.attn_block(x, *sp, bias, scale, True),
                      lambda x: ab.attn_block_plain(x, *sp, bias, scale, True),
                      lambda x: attn_chain(x, *sp, bias, scale), attn_flops(t, hw), 0, 0),
    }
    weights = {"2f": tm, "3f": ffw, "1f": sp + [bias]}
    out = {}
    with torch.no_grad():
        for name, (shape, kern, plain, chain, flops, per_chunk, per_sweep) in cases.items():
            x = torch.randn(shape, generator=g, device="cuda")
            got, want = kern(x), plain(x)
            err = ((got - want).abs().max() / want.abs().max()).item()
            again = torch.equal(kern(x), got)
            times = [window_ms(lambda: kern(x)) for _ in range(args.repeats)]
            ms = statistics.median(times)
            plain_ms = window_ms(lambda: plain(x), iters=3, warmup=1)
            chain_ms = statistics.median(window_ms(lambda: chain(x)) for _ in range(args.repeats))
            ins = [x, got] + [a for a in weights[name.split()[0]] if isinstance(a, torch.Tensor)]
            t_ops = flops / BF16_PEAK
            t_bytes = sum(a.numel() * a.element_size() for a in ins) / HBM_RATE
            bound_ms = 1e3 * max(t_ops, t_bytes)
            out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=chain_ms, bound_ms=bound_ms)
            print(f"{name}: x {list(shape)} fp32, median {ms:.3f} ms (windows "
                  f"{', '.join(f'{v:.3f}' for v in times)}), {bound_ms / ms:.1%} of the bound "
                  f"{bound_ms:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}); plain "
                  f"{plain_ms:.3f} ms; the PyTorch fp32 chain {chain_ms:.3f} ms; max_rel_err vs "
                  f"plain {err:.3e}, a second call the same bits: {again}; launches {per_chunk} "
                  f"a chunk, {per_sweep} a sweep [{card}]", flush=True)
            tag = name.replace(" ", "_")
            print_profile(profile_call(lambda: kern(x)), f"  profile of one {name} call", card,
                          args.table and f"{args.table}.{tag}", top=8)
            del x, got, want
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
