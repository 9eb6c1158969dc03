"""Times of the fp32 forward chains of the CT-ViT's blocks at the shapes
an occlusion sweep launches them, on one GPU.

    python -m ct_clip_ut_tpu_torch.infer.profile_forward [--repeats 3] [--table PATH]
                                                         [--cases 2f,3f,15f,...]

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
  dense-shortcut chunk [192, 576, 512] and one volume [24, 576, 512];
- `geglu_ff_int8` (layer 0's FF quantised W8A8, inner 1365 padded to
  1376) on fp32 rows (row 15f) over a quantised chunk's temporal tokens
  [110592, 512], two volumes' [27648, 512] and a volume's [13824, 512],
  and on bf16 rows (row 15, zero-shot's [27648, 512]); its yardstick the
  torch._int_mm chain, its bound int8 operations at 1,979 TOP/s;
- the fp32 patch embed: `patch_embed_res` (row 10f, the fp32 train step's,
  on two [1, 240, 480, 480] volumes, out, conv and the LN1 moments), its
  weight gradient `patch_embed_dkw` from the forward's planes of P (row
  11f, dconv [27648, 512]; the yardstick fp32 conv3d_weight) and
  `patch_embed_fused` (row 5f, CTGenerate's one-scan route: the first
  frame of a [1, 1, 201, 128, 128] scan at a temporal patch of 1, then its
  other 200 frames at 2, random weights from the seed); their yardstick
  patchify by reshape, F.layer_norm, F.linear, F.layer_norm in fp32;
- `vq_nearest` fp32 (row 4f) over a chunk's tokens [110592, 512] (the
  sweep's shape, one launch a chunk) and a volume's [13824, 512] against
  8,192 codes (l2-normed N(0, 1) rows); its yardstick fp32 tokens @
  codes.t() and argmax; its error the share of indices that differ from
  the plain version's;
- the fp32 FF backward with every gradient (row 9F, the fp32 train step's,
  [27648, 512], the residual on): `geglu_ff_bwd` on fp32 tensors; its
  yardstick the PyTorch fp32 chain forward and backward by autograd.

Beside each it times the plain version (one window) and the same
function as a chain of PyTorch fp32 calls (the yardstick), gives the bound
(three bf16 products for each fp32 one at 989 TFLOP/s, or the bytes at
3.35 TB/s, the larger), the kernel's largest error relative to the plain
version's largest value, and one call's launches under torch.profiler
(each launch's ms: the LN pass, the products, the core; every row to
PATH.<case> with --table). `--cases` takes a comma-separated subset of the
case names (spaces as underscores: `15f_volume`). It ends with one JSON
object of the medians.
The module imports the package by absolute name only, so that it also
runs as a file against another checkout of the port on PYTHONPATH: two
versions timed in turns in one run. Each line names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import copy
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
from ct_clip_ut_tpu_torch.ops import geglu_ff_int8 as gi
from ct_clip_ut_tpu_torch.ops import patch_embed as pe
from ct_clip_ut_tpu_torch.ops.patch_embed import fold_patch_embed
from ct_clip_ut_tpu_torch.ops.quant import quantize_ff_params
from ct_clip_ut_tpu_torch.ops.vq_nearest import vq_nearest, vq_nearest_plain

VOLUME = (1, 240, 480, 480)
CTGEN_SCAN = (1, 201, 128, 128)      # [c, T, H, W] of a CTGenerate scan
CHUNK = 8
BF16_PEAK, INT8_PEAK, HBM_RATE = 989e12, 1979e12, 3.35e12
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


def int8_chain(q):
    """The W8A8 FF as PyTorch calls on q's codes (fn(x), x bf16 or fp32):
    F.layer_norm, per-row quantisation, torch._int_mm for both products
    (cuBLASLt), F.gelu(gate) * value, + x."""
    wvg_t = torch.cat([q.wv_q, q.wg_q]).t()
    w2_t = q.w2_q.t()
    pad = q.wv_q.shape[0]

    def fn(x):
        xn = F.layer_norm(x.float(), (x.shape[-1],), q.gamma, q.beta, eps=1e-5)
        xi, rx = gi.row_quant(xn)
        vg = torch._int_mm(xi, wvg_t).float() * rx
        h = F.gelu(vg[:, pad:] * q.sg) * (vg[:, :pad] * q.sv)
        hi, rh = gi.row_quant(h)
        return (torch._int_mm(hi, w2_t).float() * rh * q.s2 + x.float()).to(x.dtype)

    return fn


def patch_chain(emb, p: int, tp: int):
    """The patch embed as PyTorch fp32 calls on `emb`'s unfolded weights
    (fn(image)): patchify by reshape / permute, F.layer_norm, F.linear,
    F.layer_norm."""
    g1, be1, g2, be2 = (t.detach().float() for t in (emb[1].weight, emb[1].bias, emb[3].weight,
                                                     emb[3].bias))
    w, bias = emb[2].weight.detach().float(), emb[2].bias.detach().float()

    def fn(image):
        b, c, T, H, W = image.shape
        t, hp, wp = T // tp, H // p, W // p
        x = image.reshape(b, c, t, tp, hp, p, wp, p).permute(0, 2, 4, 6, 1, 3, 5, 7)
        x = F.layer_norm(x.reshape(b, t, hp, wp, -1), (c * tp * p * p,), g1, be1)
        return F.layer_norm(F.linear(x, w, bias), (w.shape[0],), g2, be2)

    return fn


def perturbed_embed(emb, g):
    """A copy of a patch embed (Identity, LayerNorm, Linear, LayerNorm)
    with both LNs' gains drawn as 1 + 0.1 N and biases as 0.1 N."""
    emb = copy.deepcopy(emb)
    with torch.no_grad():
        for ln in (emb[1], emb[3]):
            ln.weight.copy_(1.0 + 0.1 * torch.randn(ln.weight.shape, generator=g, device="cuda"))
            ln.bias.copy_(0.1 * torch.randn(ln.bias.shape, generator=g, device="cuda"))
    return emb


def tensors(out) -> list:
    """A chain's output tensors as a list."""
    return list(out) if isinstance(out, (tuple, list)) else [out]


def main(argv=None) -> int:
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap_.add_argument("--repeats", type=int, default=3, help="timing windows of each chain")
    ap_.add_argument("--table", default=None, help="write each case's profile rows to PATH.<case>")
    ap_.add_argument("--cases", default=None,
                     help="comma-separated case names to run (default: all)")
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

    # the quantised FF (rows 15f, 15) and the fp32 patch embeds (rows 10f, 11f, 5f)
    q = quantize_ff_params(vit.enc_spatial_transformer.layers[0][3])
    q.gamma.copy_(ffw[0])
    q.beta.copy_(ffw[1])
    qw = [q.gamma, q.beta, q.wv_q, q.wg_q, q.w2_q, q.sv, q.sg, q.s2]
    p, tp = vit.cfg.patch_size, vit.cfg.temporal_patch_size
    emb = perturbed_embed(vit.to_patch_emb, g)
    pw = [*fold_patch_embed(emb, p, tp), emb[3].weight.float(), emb[3].bias.float()]
    ctg = []                                 # CTGenerate's two embeds: patch 16, tp 1 and 2
    torch.manual_seed(23)
    for ctp in (1, 2):
        k = ctp * 16 * 16
        e = torch.nn.Sequential(torch.nn.Identity(), torch.nn.LayerNorm(k),
                                torch.nn.Linear(k, d), torch.nn.LayerNorm(d)).cuda()
        e = perturbed_embed(e, g)
        ctg.append((e, ctp, [*fold_patch_embed(e, 16, ctp), e[3].weight.float(),
                             e[3].bias.float()]))

    def rows(shape, dtype=torch.float32):
        return lambda: torch.randn(shape, generator=g, device="cuda").to(dtype)

    def int8_case(n, dtype=torch.float32):
        return (rows((n, d), dtype), lambda x: gi.geglu_ff_int8(x, *qw, residual=True),
                lambda x: gi.geglu_ff_int8_plain(x, *qw, residual=True), int8_chain(q),
                2 * n * d * inner * 3, INT8_PEAK, qw)

    def ctgen_scan():
        return torch.randn((1, *CTGEN_SCAN), generator=g, device="cuda")

    def ctgen(fn):   # the one-scan route's two calls: the first frame, then the rest
        return lambda scan: [fn(part, *w, 16, ctp) for (_, ctp, w), part in
                             zip(ctg, (scan[:, :, :1].contiguous(), scan[:, :, 1:].contiguous()))]

    def ctgen_chain(scan):
        return [patch_chain(e, 16, ctp)(part) for (e, ctp, _), part in
                zip(ctg, (scan[:, :, :1].contiguous(), scan[:, :, 1:].contiguous()))]

    m10 = 2 * (VOLUME[1] // tp) * (VOLUME[2] // p) * (VOLUME[3] // p)
    dk = {}   # row 11f's operands: the forward's planes of P, dconv and its 5-D form

    def dkw_volume():
        x = torch.randn((2, *VOLUME), generator=g, device="cuda")
        dk["planes"] = pe._res_with_patches(x, *pw, p, tp)[3]
        dk["dconv"] = torch.randn((m10, d), generator=g, device="cuda")
        dk["go"] = dk["dconv"].reshape(2, VOLUME[1] // tp, VOLUME[2] // p, VOLUME[3] // p,
                                       d).permute(0, 4, 1, 2, 3).contiguous()
        return x

    def l2rows(n):
        return lambda: F.normalize(torch.randn((n, d), generator=g, device="cuda"), dim=-1)

    codes = l2rows(vit.cfg.codebook_size)()
    ffg = {}   # row 9F's cotangent

    def ff_bwd_rows():
        ffg["g"] = torch.randn((2 * t * hw, d), generator=g, device="cuda")
        return torch.randn((2 * t * hw, d), generator=g, device="cuda")

    def ff_grad_chain(x):
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(True) for a in (x, *ffw)]
            return torch.autograd.grad(ff_chain(*leaves), leaves, ffg["g"])

    m5 = [(CTGEN_SCAN[1] - 1) // 2 * 64, 64]
    # name -> (input, kernel, plain, chain, operations, their peak, weights, launches a
    # chunk, a sweep)
    cases = {
        "2f": (rows((CHUNK * hw, t, d)), lambda x: ap.attn_packed(x, *tm, scale, True),
               lambda x: ap.attn_packed_plain(x, *tm, scale, True),
               lambda x: attn_chain(x, *tm, None, scale), attn_flops(CHUNK * hw, t), BF16_PEAK,
               tm, 4, 4 * FULL_SWEEP_CHUNKS),
        "3f": (rows((CHUNK * t * hw, d)), lambda x: gf.geglu_ff(x, *ffw, True),
               lambda x: gf.geglu_ff_plain(x, *ffw, True), lambda x: ff_chain(x, *ffw),
               ff_flops(CHUNK * t * hw), BF16_PEAK, ffw, 4, 4 * FULL_SWEEP_CHUNKS),
        "3f slice": (rows((CHUNK * 10 * hw, d)), lambda x: gf.geglu_ff(x, *ffw, True),
                     lambda x: gf.geglu_ff_plain(x, *ffw, True), lambda x: ff_chain(x, *ffw),
                     ff_flops(CHUNK * 10 * hw), BF16_PEAK, ffw, 1, FULL_SWEEP_CHUNKS),
        "3f clean": (rows((t * hw, d)), lambda x: gf.geglu_ff(x, *ffw, True),
                     lambda x: gf.geglu_ff_plain(x, *ffw, True), lambda x: ff_chain(x, *ffw),
                     ff_flops(t * hw), BF16_PEAK, ffw, 0, 4 * 6),
        "1f chunk": (rows((CHUNK * t, hw, d)), lambda x: ab.attn_block(x, *sp, bias, scale, True),
                     lambda x: ab.attn_block_plain(x, *sp, bias, scale, True),
                     lambda x: attn_chain(x, *sp, bias, scale), attn_flops(CHUNK * t, hw),
                     BF16_PEAK, sp + [bias], 4, 4 * FULL_SWEEP_CHUNKS),
        "1f volume": (rows((t, hw, d)), lambda x: ab.attn_block(x, *sp, bias, scale, True),
                      lambda x: ab.attn_block_plain(x, *sp, bias, scale, True),
                      lambda x: attn_chain(x, *sp, bias, scale), attn_flops(t, hw), BF16_PEAK,
                      sp + [bias], 0, 0),
        "15f": (*int8_case(CHUNK * t * hw), 4, 4 * FULL_SWEEP_CHUNKS),
        "15f 2 volumes": (*int8_case(2 * t * hw), 0, 0),
        "15f volume": (*int8_case(t * hw), 0, 0),
        "15 bf16": (*int8_case(2 * t * hw, torch.bfloat16), 0, 0),
        "10f": (rows((2, *VOLUME)), lambda x: pe.patch_embed_res(x, *pw, p, tp),
                lambda x: pe.patch_embed_res_plain(x, *pw, p, tp), patch_chain(emb, p, tp),
                3 * 2 * m10 * tp * p * p * d, BF16_PEAK, pw, 0, 0),
        "11f": (dkw_volume, lambda x: pe.patch_embed_dkw(x, dk["dconv"], p, tp, dk["planes"]),
                lambda x: pe.patch_embed_dkw_plain(x, dk["dconv"], p, tp),
                lambda x: torch.nn.grad.conv3d_weight(x, (d, 1, tp, p, p), dk["go"],
                                                      stride=(tp, p, p)),
                3 * 2 * m10 * tp * p * p * d, BF16_PEAK, [], 0, 0),
        "5f": (ctgen_scan, ctgen(pe.patch_embed_fused), ctgen(pe.patch_embed_plain),
               ctgen_chain, sum(3 * 2 * m * ctp * 256 * d for m, ctp in zip(m5, (2, 1))),
               BF16_PEAK, [w for _, _, ws in ctg for w in ws], 0, 0),
        "4f sweep": (l2rows(CHUNK * t * hw), lambda x: vq_nearest(x, codes),
                     lambda x: vq_nearest_plain(x, codes),
                     lambda x: torch.argmax(x @ codes.t(), dim=-1),
                     3 * 2 * CHUNK * t * hw * codes.shape[0] * d, BF16_PEAK, [codes], 1,
                     FULL_SWEEP_CHUNKS),
        "4f volume": (l2rows(t * hw), lambda x: vq_nearest(x, codes),
                      lambda x: vq_nearest_plain(x, codes),
                      lambda x: torch.argmax(x @ codes.t(), dim=-1),
                      3 * 2 * t * hw * codes.shape[0] * d, BF16_PEAK, [codes], 0, 0),
        "9F": (ff_bwd_rows, lambda x: gf.geglu_ff_bwd(x, *ffw, ffg["g"], True),
               lambda x: gf.geglu_ff_bwd_plain(x, *ffw, ffg["g"], True), ff_grad_chain,
               48 * 2 * t * hw * d * inner, BF16_PEAK, ffw, 0, 0),
    }
    chosen = None if args.cases is None else set(args.cases.split(","))
    out = {}
    with torch.no_grad():
        for name, (make, kern, plain, chain, flops, peak, weights, per_chunk,
                   per_sweep) in cases.items():
            tag = name.replace(" ", "_")
            if chosen is not None and tag not in chosen:
                continue
            x = make()
            got, want = tensors(kern(x)), tensors(plain(x))
            # indices (4f): the share that differ; values: the largest error
            err = max((a != b).float().mean().item() if not b.is_floating_point() else
                      ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                      for a, b in zip(got, want))
            again = all(torch.equal(a, b) for a, b in zip(tensors(kern(x)), got))
            times = [window_ms(lambda: kern(x)) for _ in range(args.repeats)]
            ms = statistics.median(times)
            plain_ms = window_ms(lambda: plain(x), iters=3, warmup=1)
            chain_ms = statistics.median(window_ms(lambda: chain(x)) for _ in range(args.repeats))
            ins = [x, *got] + [a for a in weights if isinstance(a, torch.Tensor)]
            t_ops = flops / peak
            t_bytes = sum(a.numel() * a.element_size() for a in ins) / HBM_RATE
            bound_ms = 1e3 * max(t_ops, t_bytes)
            out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=chain_ms, bound_ms=bound_ms)
            print(f"{name}: x {list(x.shape)} {str(x.dtype)[6:]}, median {ms:.3f} ms (windows "
                  f"{', '.join(f'{v:.3f}' for v in times)}), {bound_ms / ms:.1%} of the bound "
                  f"{bound_ms:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}); plain "
                  f"{plain_ms:.3f} ms; the PyTorch chain {chain_ms:.3f} ms; max_rel_err vs "
                  f"plain {err:.3e}, a second call the same bits: {again}; launches {per_chunk} "
                  f"a chunk, {per_sweep} a sweep [{card}]", flush=True)
            print_profile(profile_call(lambda: kern(x)), f"  profile of one {name} call", card,
                          args.table and f"{args.table}.{tag}", top=8)
            del x, got, want, ins
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
