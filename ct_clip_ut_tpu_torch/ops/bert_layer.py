"""One post-LN BERT encoder layer: kernel wrappers and plain versions.

Replaces ct_clip_ut_tpu/ops/pallas_bert_layer.py: `bert_layer_fused`'s
forward (`_fwd_impl`) and its recompute backward (`_bwd_impl`), the text
tower at n >= 128 tokens. Four CUDA chains, each with a header that says
what bounds it on the H100 and what the design does about it:

- `csrc/bert_layer.cu`: fp32, deterministic (the zero-shot prompts, padded
  to 512 tokens and encoded in fp32) or in train mode with dropout (the
  fp32 train step's 512-token reports), every product as three bf16
  tensor-core products of hi / lo planes (`bert_layer_fp32`);
- `csrc/bert_layer_bwd_f32.cu`: the backward of the fp32 chain, dx and the
  twelve parameter gradients in fp32 the same way (`bert_layer_bwd_f32`);
- `csrc/bert_layer_bf16.cu`: bf16, deterministic (the train loop's
  evaluation) or in train mode with dropout on the attention probabilities
  and both hidden outputs (the train step's 512-token reports): the
  products on the Hopper GEMM core, a two-pass mma.sync attention core;
- `csrc/bert_layer_bwd.cu`: the backward of the bf16 chain: dx and the
  twelve parameter gradients.

Both backwards can recompute the forward and regenerate the dropout masks
from the same seeds, and sum every gradient in a fixed order, so two calls
give the same bits; under autograd the fp32 chain's forward keeps its state
instead (`F32State`), and its backward starts from it with the same bits.
`bert_layer` and `bert_layer_bwd` pick the chain by x's dtype;
`bert_layer_grad` is the layer with its backward (a
torch.autograd.Function, the custom VJP of `bert_layer_fused`).

Dropout. The TPU kernel reseeds its hardware PRNG per (site, sequence,
head). Here every element gets its own Philox4x32-10 bits: the counter is
(the element's position in its [n, n] or [n, D] slab // 4, the site, the
sequence, the head), the key (the site's seed, 0), and the four output words
go to four consecutive positions, so a mask depends on nothing a kernel's
tiling decides and the forward, the backward and `philox_keep` (the same
generator in plain PyTorch, on int64 tensors) produce the same bits. An
element is kept iff its bits >= uint32(min(int(rate * 2^32), 2^32 - 1)) and
kept ones are scaled by 1 / (1 - rate) in fp32 (pallas_bert_layer.py:68-74).
The three seeds of a layer are a device tensor (`draw_seeds`): no host
synchronisation inside a step.

Weights are in the nn.Linear (out, in) layout: wqkv [3D, D] (query, key,
value rows), wo [D, D], w1 [F, D], w2 [D, F]; they may be fp32 (the model's
leaves) or already in x's dtype.

`bert_layer_plain` is `_fwd_body` (:99-151) in plain PyTorch with its
rounding points: qkv summed in fp32 and q, k, v rounded to x's dtype as
operands of the score and context products; softmax in fp32, normalised,
then the keep mask, then rounded; the out-projection, keep mask and
residual in fp32; LayerNorm in the one-pass E[r^2] - E[r]^2 form; the FF
reads y rounded, the second residual adds y in fp32; exact-erf GELU.
`bert_layer_bwd_plain` is `_kernel_bwd` (:168-302) the same way.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from . import launches

DIM_HEAD = 64       # the head width the CUDA attention cores take
MAX_TOKENS = 672    # the bf16 chains' token cap (ROADMAP); rows pad to a multiple of KEY_CHUNK
KEY_CHUNK = 64      # the bf16 attention passes' key (and query) chunk
SITES = ("attention", "post-attention", "post-FF")

_M0, _M1, _W0, _W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def philox4x32(c0, c1, c2, c3, k0, k1) -> tuple:
    """Philox4x32-10 on int64 tensors holding uint32 values (torch has no
    uint32 arithmetic): four counter words, two key words -> four words.
    The 32 x 32 -> 64-bit products wrap in int64; their low and high halves
    are still the unsigned product's."""
    for _ in range(10):
        p0, p1 = c0 * _M0, c2 * _M1
        c0, c1, c2, c3 = (((p1 >> 32) & _U32) ^ c1 ^ k0, p1 & _U32,
                          ((p0 >> 32) & _U32) ^ c3 ^ k1, p0 & _U32)
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def philox_keep(seeds: torch.Tensor, site: int, b: int, heads: int, inner: int,
                rate: float) -> torch.Tensor:
    """The keep factors (0 or 1 / (1 - rate), fp32) of dropout site `site`
    as [b, heads, inner]: position i of slab (sequence, head) takes word
    i % 4 of Philox(counter (i // 4, site, sequence, head), key (seed, 0)).
    `seeds` is the layer's [3] integer tensor; inner a multiple of 4."""
    if inner % 4:
        raise ValueError(f"a dropout slab holds a multiple of 4 elements, got {inner}")
    dev = seeds.device
    i64 = dict(dtype=torch.int64, device=dev)
    c0 = torch.arange(inner // 4, **i64)[None, None, :]
    c1 = torch.full((1, 1, 1), site, **i64)
    c2 = torch.arange(b, **i64)[:, None, None]
    c3 = torch.arange(heads, **i64)[None, :, None]
    k0 = seeds[site].to(torch.int64).reshape(1, 1, 1) & _U32
    k1 = torch.zeros((1, 1, 1), **i64)
    shape = (b, heads, inner // 4)
    words = philox4x32(*(t.expand(shape) for t in (c0, c1, c2, c3)), k0, k1)
    bits = torch.stack(words, dim=-1).reshape(b, heads, inner)
    return (bits >= dropout_threshold(rate)).float() * (1.0 / (1.0 - rate))


def draw_seeds(generator: torch.Generator, device) -> torch.Tensor:
    """One layer's three dropout seeds, int32 in [0, 2^31 - 1) on `device`,
    drawn from the caller's generator (models/bert.py:104-107 of the JAX
    package draws them from its key)."""
    return torch.randint(0, 2 ** 31 - 1, (3,), generator=generator, device=device,
                         dtype=torch.int32)


def _ln(r: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    """(y, xhat, rstd) of the one-pass LayerNorm (pallas_bert_layer._ln_fwd)."""
    mean = r.mean(-1, keepdim=True)
    var = (r * r).mean(-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var.clamp_min(0.0) + eps)
    xhat = (r - mean) * rstd
    return xhat * gamma + beta, xhat, rstd


def _ln_bwd(dout, xhat, rstd, gamma):
    dxhat = dout * gamma
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * rstd, (dout * xhat).sum((0, 1)), dout.sum((0, 1))


def _check_types(x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bert_layer takes fp32 or bf16 activations, got {x.dtype}")


def _masks(x, heads, p_attn, p_hidden, train, seeds):
    """(keep_attn [b, heads, n, n], keep1, keep2 [b, n, d]); None where the
    site drops nothing."""
    b, n, d = x.shape
    drop_a, drop_h = train and p_attn > 0.0, train and p_hidden > 0.0
    if (drop_a or drop_h) and seeds is None:
        raise ValueError("train-mode dropout needs the layer's seeds (draw_seeds)")
    ka = philox_keep(seeds, 0, b, heads, n * n, p_attn).reshape(b, heads, n, n) if drop_a else None
    k1 = philox_keep(seeds, 1, b, 1, n * d, p_hidden).reshape(b, n, d) if drop_h else None
    k2 = philox_keep(seeds, 2, b, 1, n * d, p_hidden).reshape(b, n, d) if drop_h else None
    return ka, k1, k2


def _forward_parts(x, mask_row, w, heads, eps, masks):
    """The layer's forward in fp32 tensors with x's dtype as the rounding
    type; returns the output (fp32, before the last rounding) and what the
    backward reads."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = w
    dt = x.dtype
    b, n, d = x.shape
    dh = d // heads
    ka, k1, k2 = masks

    def rnd(t):
        return t.to(dt).float()

    def split(t):
        return t.reshape(b, n, heads, dh).transpose(1, 2)

    x32 = x.float()
    qkv = x32 @ rnd(wqkv).t() + bqkv.float()
    q, k, v = (split(rnd(t)) for t in qkv.split(d, dim=-1))
    s = (q @ k.transpose(-1, -2)) * (1.0 / dh ** 0.5) + mask_row.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    p_used = p if ka is None else p * ka
    ctx = rnd((rnd(p_used) @ v).transpose(1, 2).reshape(b, n, d))
    o1 = ctx @ rnd(wo).t() + bo.float()
    if k1 is not None:
        o1 = o1 * k1
    y, xhat1, rstd1 = _ln(o1 + x32, g1.float(), be1.float(), eps)
    h1 = rnd(y) @ rnd(w1).t() + b1.float()
    cdf = 0.5 * (1.0 + torch.erf(h1 * 0.7071067811865476))
    g = rnd(h1 * cdf)
    o2 = g @ rnd(w2).t() + b2.float()
    if k2 is not None:
        o2 = o2 * k2
    r2 = o2 + y
    out, xhat2, rstd2 = _ln(r2, g2.float(), be2.float(), eps)
    return out, dict(q=q, k=k, v=v, p=p, p_used=p_used, ctx=ctx, y=y, xhat1=xhat1,
                     rstd1=rstd1, h1=h1, cdf=cdf, g=g, r2=r2, xhat2=xhat2, rstd2=rstd2)


def bert_layer_plain(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
                     heads: int, eps: float, *, p_attn: float = 0.0, p_hidden: float = 0.0,
                     train: bool = False, seeds: Optional[torch.Tensor] = None,
                     parts: Optional[dict] = None) -> torch.Tensor:
    """x [B, n, D] fp32 or bf16; mask_row [B, n] additive fp32 (0 or
    dtype-min). Returns [B, n, D] in x's dtype. Dropout acts only with
    train=True (then `seeds` is required where a rate is > 0). A `parts`
    dict receives intermediates that the output's rounding hides: LN1's
    fp32 output y and the fp32 sum before LN2 r2 [B, n, D], and the FF's
    rounded activations g [B, n, F]."""
    _check_types(x)
    w = (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
    masks = _masks(x, heads, p_attn, p_hidden, train, seeds)
    out, f = _forward_parts(x, mask_row, w, heads, eps, masks)
    if parts is not None:
        parts.update(y=f["y"], g=f["g"], r2=f["r2"])
    return out.to(x.dtype)


def bert_layer_bwd_plain(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
                         dout, heads: int, eps: float, *, p_attn: float = 0.0,
                         p_hidden: float = 0.0, train: bool = False,
                         seeds: Optional[torch.Tensor] = None, faults: tuple = ()) -> tuple:
    """Gradients of bert_layer_plain's output against cotangent dout
    [B, n, D]: (dx in x's dtype; dwqkv, dbqkv, dwo, dbo, dg1, dbe1, dw1, db1,
    dw2, db2, dg2, dbe2 in fp32), `_kernel_bwd` with its rounding points.
    `faults` builds a faulty kernel's gradients, the card checks' controls:
    "no_attn_keep" leaves the attention keep mask out of dp, "no_hidden_keep"
    leaves the post-FF keep mask out of do2, "p_used_in_ds" takes the dropped
    probabilities for the pre-dropout ones in ds."""
    _check_types(x)
    w = (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
    dt = x.dtype
    b, n, d = x.shape
    dh = d // heads
    scale = 1.0 / dh ** 0.5
    ka, k1, k2 = masks = _masks(x, heads, p_attn, p_hidden, train, seeds)
    _, f = _forward_parts(x, mask_row, w, heads, eps, masks)

    def rnd(t):
        return t.to(dt).float()

    def rows(t):
        return t.reshape(b * n, -1)

    def merge(t):
        return t.transpose(1, 2).reshape(b, n, d)

    x32 = x.float()
    dr2, dg2, dbe2 = _ln_bwd(dout.float(), f["xhat2"], f["rstd2"], g2.float())
    do2 = dr2 if k2 is None or "no_hidden_keep" in faults else dr2 * k2
    dw2 = rows(rnd(do2)).t() @ rows(f["g"])
    db2 = do2.sum((0, 1))
    dh1 = (rnd(do2) @ rnd(w2)) * (f["cdf"] + f["h1"] * 0.3989422804014327
                                  * torch.exp(-0.5 * f["h1"] * f["h1"]))
    dw1 = rows(rnd(dh1)).t() @ rows(rnd(f["y"]))
    db1 = dh1.sum((0, 1))
    dy = dr2 + rnd(dh1) @ rnd(w1)
    dr1, dg1, dbe1 = _ln_bwd(dy, f["xhat1"], f["rstd1"], g1.float())
    do1 = dr1 if k1 is None else dr1 * k1
    dwo = rows(rnd(do1)).t() @ rows(f["ctx"])
    dbo = do1.sum((0, 1))
    dctx = rnd(rnd(do1) @ rnd(wo)).reshape(b, n, heads, dh).transpose(1, 2)

    p = f["p"]
    dp = dctx @ f["v"].transpose(-1, -2)
    dv = rnd(f["p_used"]).transpose(-1, -2) @ dctx
    if ka is not None and "no_attn_keep" not in faults:
        dp = dp * ka
    pd = f["p_used"] if "p_used_in_ds" in faults else p
    ds = rnd(pd * (dp - (dp * pd).sum(-1, keepdim=True)) * scale)
    dq, dk = ds @ f["k"], ds.transpose(-1, -2) @ f["q"]
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    dx = dr1 + rnd(dqkv) @ rnd(wqkv)
    dwqkv = rows(rnd(dqkv)).t() @ rows(x32)
    dbqkv = dqkv.sum((0, 1))
    return (dx.to(dt), dwqkv, dbqkv, dwo, dbo, dg1, dbe1, dw1, db1, dw2, db2, dg2, dbe2)


def _thresholds(p_attn, p_hidden, train, seeds):
    """(thresh_attn, thresh_hidden, scale_attn, scale_hidden) for the kernels:
    a threshold of 0 switches its site off."""
    ta = dropout_threshold(p_attn) if train and p_attn > 0.0 else 0
    th = dropout_threshold(p_hidden) if train and p_hidden > 0.0 else 0
    if (ta or th) and seeds is None:
        raise ValueError("train-mode dropout needs the layer's seeds (draw_seeds)")
    return ta, th, 1.0 / (1.0 - p_attn) if ta else 1.0, 1.0 / (1.0 - p_hidden) if th else 1.0


_MATRICES = (0, 2, 6, 8)    # wqkv, wo, w1, w2 among the twelve weights
_ALIGN = 256                # bytes: every workspace block starts on this boundary


def _layout(sizes) -> tuple:
    """(byte offsets, total bytes) of consecutive blocks of the given byte
    sizes, each starting on an _ALIGN boundary."""
    offs, total = [], 0
    for size in sizes:
        offs.append(total)
        total += -(-size // _ALIGN) * _ALIGN
    return offs, total


def _bf16_args(x, mask_row, w, seeds, heads):
    """The bf16 chains' inputs, checked: (x padded to [b, npad, d], the mask
    padded to [b, npad], seeds, the twelve weights with the vectors in fp32,
    npad), npad = n rounded up to KEY_CHUNK. The four matrices stay bf16
    where all four are, else go as fp32 and the chain's first launch rounds
    them (one cast kernel in place of four torch casts)."""
    b, n, d = x.shape
    dev = x.device
    f = w[6].shape[0]
    if d != heads * DIM_HEAD or f % 8:
        raise ValueError(f"the bert_layer kernel takes heads of {DIM_HEAD} and an FF width "
                         f"that 8 divides; got D={d}, heads={heads}, F={f}")
    if n % 4:
        raise ValueError(f"the bert_layer kernel takes a token count that 4 divides, got {n}")
    npad = -(-n // KEY_CHUNK) * KEY_CHUNK
    if n > MAX_TOKENS:
        raise ValueError(f"the bf16 bert_layer kernel takes at most {MAX_TOKENS} tokens, "
                         f"got {n}")
    _build.require(x, "x", torch.bfloat16, (b, n, d), dev)
    _build.require(mask_row, "mask_row", torch.float32, (b, n), dev)
    shapes = ((3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,), (f, d), (f,), (d, f), (d,), (d,),
              (d,))
    for i, (t, shape) in enumerate(zip(w, shapes)):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"bert_layer weight {i}: {tuple(t.shape)} on {t.device}, expected "
                             f"{shape} on {dev}")
    keep_bf16 = all(w[i].dtype == torch.bfloat16 for i in _MATRICES)
    weights = [_build.aligned16(t.contiguous() if keep_bf16 else t.float().contiguous())
               if i in _MATRICES else t.float().contiguous() for i, t in enumerate(w)]
    if npad != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, npad - n))
        mask_row = torch.nn.functional.pad(mask_row, (0, npad - n))
    if seeds is None:
        seeds = torch.zeros((3,), dtype=torch.int32, device=dev)
    _build.require(seeds, "seeds", torch.int32, (3,), dev)
    return _build.aligned16(x), _build.aligned16(mask_row), seeds, weights, npad


def _bf16_work(b, npad, d, f, heads, backward: bool, weights_f32: bool) -> list:
    """The byte sizes of the forward chain's workspaces, in the C entry's
    order: the bf16 copies of the four matrices [3d d + d d + 2 f d] (empty
    unless they come in fp32), qkv [m, 3d] bf16, ctx [m, d] bf16, r1 [m, d] fp32, stats1 [m, 2]
    fp32, yf [m, d] fp32, yb [m, d] bf16, h1 [m, f] fp32, g [m, f] bf16, r2
    [m, d] fp32, stats2 [m, 2] fp32 (m = b npad); for the backward also each
    attention row's (max, 1 / sum, D, -) [b, heads, npad, 4] fp32 and the
    attention keep mask's bits [b, heads, npad, npad / 32] u32."""
    m = b * npad
    sizes = [2 * (4 * d * d + 2 * f * d) if weights_f32 else 0, 6 * m * d, 2 * m * d, 4 * m * d, 8 * m, 4 * m * d, 2 * m * d, 4 * m * f, 2 * m * f,
             4 * m * d, 8 * m]
    if backward:
        sizes += [16 * b * heads * npad, b * heads * npad * npad // 8]
    return sizes


FP32_ONE_PASS, FP32_NO_SKIP, FP32_KEPT = 1, 2, 4     # the fp32 chains' flags
_WEIGHT_NAMES = ("wqkv", "bqkv", "wo", "bo", "g1", "be1", "w1", "b1", "w2", "b2", "g2", "be2")


def _f32_args(x, mask_row, w, heads: int) -> list:
    """The fp32 chains' inputs, checked (fp32, contiguous, 16-B aligned: the
    kernels read float4): [x, mask_row, the twelve weights]."""
    b, n, d = x.shape
    f = w[6].shape[0]
    if d != heads * DIM_HEAD or f % 8:
        raise ValueError(f"the bert_layer kernel takes heads of {DIM_HEAD} and an FF width "
                         f"that 8 divides; got D={d}, heads={heads}, F={f}")
    shapes = ((3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,), (f, d), (f,), (d, f), (d,), (d,),
              (d,))
    args = ((x, "x", (b, n, d)), (mask_row, "mask_row", (b, n)),
            *zip(w, _WEIGHT_NAMES, shapes))
    for t, name, shape in args:
        _build.require(t, name, torch.float32, shape, x.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads float4, the data must be 16-B aligned")
    return [t for t, _, _ in args]


def _f32_seeds(seeds, dropout: bool, n: int, dev):
    """The seeds' pointer for the fp32 chains (None without dropout, which
    reads none), checked; dropout's slabs need n % 4 == 0."""
    if not dropout:
        return None
    if n % 4:
        raise ValueError(f"fp32 dropout takes a token count that 4 divides, got {n}")
    _build.require(seeds, "seeds", torch.int32, (3,), dev)
    return seeds.data_ptr()


def _f32_work(b: int, n: int, d: int, f: int, heads: int, backward: bool) -> list:
    """The byte sizes of the fp32 chains' workspaces, in the C entries'
    order: bf16 hi / lo planes of x, wqkv, wo, w1, w2, qkv, ctx, y, g; fp32
    r (r1 in the backward), y; for the backward also fp32 h1 and r2, rowstat
    [b, heads, n] float4, the attention keep bits [b, heads, n, n / 32
    rounded up to a whole 64-key chunk's two words] u32 (the first
    _F32_STATE blocks: the state a train forward keeps for the backward),
    fp32 dr2, the planes of do2 and dh1, fp32 dr1, the planes of do1, dctx
    and dqkv, and the partial rows of both LayerNorms [ceil(m / 8), 3d], of
    db1 [ceil(m / 16), f] and of dbqkv [b ceil(n / 16), 3d] (m = b n)."""
    m = b * n
    sizes = [4 * m * d, 12 * d * d, 4 * d * d, 4 * f * d, 4 * d * f, 12 * m * d, 4 * m * d,
             4 * m * d, 4 * m * f, 4 * m * d, 4 * m * d]
    if backward:
        words = -(-n // KEY_CHUNK) * 2
        ln_parts = 4 * -(-m // 8) * 3 * d
        sizes += [4 * m * f, 4 * m * d, 16 * b * heads * n, 4 * b * heads * n * words,
                  4 * m * d, 4 * m * d, 4 * m * f, 4 * m * d, 4 * m * d, 4 * m * d, 12 * m * d,
                  ln_parts, ln_parts, 4 * -(-m // 16) * f, 4 * b * -(-n // 16) * 3 * d]
    return sizes


_F32_STATE = 15     # the fp32 backward's first workspaces: the forward's kept state


class F32State:
    """What an fp32 train-mode forward keeps for its backward
    (`bert_layer_fp32(..., keep=True)`): one device buffer holding the
    backward's first _F32_STATE workspaces (every plane, fp32 r1, y, h1 and
    r2, each attention row's (max, 1 / sum), the keep bits; ~80 MB a layer
    at [2, 512, 768], F = 3072), and the call's sizes and flags, which the
    backward checks."""

    def __init__(self, buf: torch.Tensor, offs: list, key: tuple):
        self.buf, self.offs, self.key = buf, offs, key

    def pointers(self) -> list:
        return [self.buf.data_ptr() + o for o in self.offs]


def bert_layer_fp32(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
                    heads: int, eps: float, *, p_attn: float = 0.0, p_hidden: float = 0.0,
                    train: bool = False, seeds: Optional[torch.Tensor] = None,
                    one_pass: bool = False, skip_masked: bool = True, keep: bool = False):
    """The fp32 chain (csrc/bert_layer.cu) on CUDA tensors: every product as
    three bf16 products of hi / lo planes on the tensor cores;
    deterministic, or with train=True dropout at the bf16 chain's Philox
    masks (the same bits as `philox_keep`). A train-mode call counts
    `bert_layer_f32_train`, a deterministic one `bert_layer`.
    `one_pass=True` zeroes every lo plane (one bf16 product each: the
    control a run holds outside the fp32 band); `skip_masked=False` walks
    the key chunks that the mask removes entirely, which add exactly 0 (a
    run holds the two outputs bit for bit). `keep=True` returns (out,
    F32State): the state `bert_layer_bwd_f32(..., saved=)` starts from
    instead of rerunning this chain. CPU tensors raise: their route is
    `bert_layer`'s plain version."""
    if not _build.on_cuda(x):
        raise ValueError("bert_layer_fp32 runs the CUDA chain; bert_layer takes the plain "
                         "version for CPU tensors")
    w = (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
    ta, th, sa, sh = _thresholds(p_attn, p_hidden, train, seeds)
    b, n, d = x.shape
    f = w1.shape[0]
    ins = _f32_args(x, mask_row, w, heads)
    seeds_ptr = _f32_seeds(seeds, bool(ta or th), n, x.device)
    flags = (FP32_ONE_PASS if one_pass else 0) | (0 if skip_masked else FP32_NO_SKIP)
    if keep:
        if not skip_masked:
            raise ValueError("a kept state comes from the chain the backward reruns, which "
                             "skips the masked key chunks")
        offs, total = _layout(_f32_work(b, n, d, f, heads, backward=True)[:_F32_STATE])
        state = F32State(torch.empty((total,), dtype=torch.uint8, device=x.device), offs,
                         (b, n, d, f, heads, flags, ta, th))
        ptrs = state.pointers()
    else:
        offs, total = _layout(_f32_work(b, n, d, f, heads, backward=False))
        buf = torch.empty((total,), dtype=torch.uint8, device=x.device)
        ptrs = [buf.data_ptr() + o for o in offs] + [None] * (_F32_STATE - len(offs))
    out = torch.empty_like(x)
    err = _build.load().ctc_bert_layer(
        ins[0].data_ptr(), ins[1].data_ptr(), seeds_ptr, *(t.data_ptr() for t in ins[2:]),
        *ptrs, out.data_ptr(), b, n, d, f, heads, flags, float(eps), 1.0 / DIM_HEAD ** 0.5, ta,
        th, sa, sh, _build.stream_of(x))
    _build.check(err, "bert_layer")
    launches.count("bert_layer_f32_train" if train else "bert_layer")
    return (out, state) if keep else out


def bert_layer_bwd_f32(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2, dout,
                       heads: int, eps: float, *, p_attn: float = 0.0, p_hidden: float = 0.0,
                       train: bool = False, seeds: Optional[torch.Tensor] = None,
                       one_pass: bool = False, saved: Optional[F32State] = None) -> tuple:
    """The fp32 backward chain (csrc/bert_layer_bwd_f32.cu) on CUDA tensors:
    from the forward's kept state (`saved`, from `bert_layer_fp32(...,
    keep=True)` on the same inputs) or, with none, the forward rerun first;
    then (dx, dwqkv, dbqkv, dwo, dbo, dg1, dbe1, dw1, db1, dw2, db2, dg2,
    dbe2), all fp32, every product three bf16 products of hi / lo planes and
    every sum in a fixed order: the two routes give the same bits.
    `one_pass=True` zeroes every lo plane (the control). CPU tensors raise:
    their route is `bert_layer_bwd`'s plain version."""
    if not _build.on_cuda(x):
        raise ValueError("bert_layer_bwd_f32 runs the CUDA chain; bert_layer_bwd takes the "
                         "plain version for CPU tensors")
    w = (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
    ta, th, sa, sh = _thresholds(p_attn, p_hidden, train, seeds)
    b, n, d = x.shape
    f = w1.shape[0]
    dev = x.device
    if n % 4 or d % 128:
        raise ValueError(f"the fp32 bert_layer backward takes a token count that 4 divides and "
                         f"a width that 128 divides; got n={n}, D={d}")
    ins = _f32_args(x, mask_row, w, heads)
    seeds_ptr = _f32_seeds(seeds, bool(ta or th), n, dev)
    _build.require(dout, "dout", torch.float32, (b, n, d), dev)
    dout = _build.aligned16(dout)
    flags = FP32_ONE_PASS if one_pass else 0
    sizes = _f32_work(b, n, d, f, heads, backward=True)
    if saved is not None:
        if saved.key != (b, n, d, f, heads, flags, ta, th):
            raise ValueError(f"the kept state is of another call: {saved.key}, this backward's "
                             f"{(b, n, d, f, heads, flags, ta, th)}")
        offs, total = _layout(sizes[_F32_STATE:])
        buf = torch.empty((total,), dtype=torch.uint8, device=dev)
        ptrs = saved.pointers() + [buf.data_ptr() + o for o in offs]
        flags |= FP32_KEPT
    else:
        offs, total = _layout(sizes)
        buf = torch.empty((total,), dtype=torch.uint8, device=dev)
        ptrs = [buf.data_ptr() + o for o in offs]
    dx = torch.empty_like(x)
    grads = [torch.empty(t.shape, dtype=torch.float32, device=dev) for t in w]
    err = _build.load().ctc_bert_layer_bwd_f32(
        ins[0].data_ptr(), ins[1].data_ptr(), seeds_ptr, *(t.data_ptr() for t in ins[2:]),
        dout.data_ptr(), *ptrs, dx.data_ptr(), *(t.data_ptr() for t in grads), b, n, d, f, heads,
        flags, float(eps), 1.0 / DIM_HEAD ** 0.5, ta, th, sa, sh, _build.stream_of(x))
    _build.check(err, "bert_layer_bwd_f32")
    launches.count("bert_layer_bwd_f32")
    return (dx, *grads)


def bert_layer(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
               heads: int, eps: float, *, p_attn: float = 0.0, p_hidden: float = 0.0,
               train: bool = False, seeds: Optional[torch.Tensor] = None,
               parts: Optional[dict] = None) -> torch.Tensor:
    """The bert_layer kernel chains on CUDA tensors (contiguous, heads of
    64): fp32 x takes the fp32 chain (all arguments fp32), bf16 x the bf16
    chain, each with dropout when train=True. CPU tensors take the plain
    version. A `parts` dict receives the bf16 chain's y, g and r2
    workspaces, as bert_layer_plain's does."""
    _check_types(x)
    w = (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
    if not _build.on_cuda(x):
        return bert_layer_plain(x, mask_row, *w, heads, eps, p_attn=p_attn, p_hidden=p_hidden,
                                train=train, seeds=seeds, parts=parts)
    if x.dtype == torch.float32:
        return bert_layer_fp32(x, mask_row, *w, heads, eps, p_attn=p_attn, p_hidden=p_hidden,
                               train=train, seeds=seeds)
    ta, th, sa, sh = _thresholds(p_attn, p_hidden, train, seeds)
    b, n, d = x.shape
    xp, mask_p, seeds, weights, npad = _bf16_args(x, mask_row, w, seeds, heads)
    f = weights[6].shape[0]
    w_f32 = weights[0].dtype == torch.float32
    sizes = _bf16_work(b, npad, d, f, heads, backward=False, weights_f32=w_f32)
    offs, total = _layout(sizes)
    buf = torch.empty((total,), dtype=torch.uint8, device=x.device)
    out = torch.empty((b, npad, d), dtype=torch.bfloat16, device=x.device)
    base = buf.data_ptr()
    err = _build.load().ctc_bert_layer_bf16(
        xp.data_ptr(), mask_p.data_ptr(), seeds.data_ptr(), *(t.data_ptr() for t in weights),
        *(base + o for o in offs), out.data_ptr(), int(w_f32), b, n,
        npad, d, f, heads, float(eps), 1.0 / DIM_HEAD ** 0.5, ta, th, sa, sh, _build.stream_of(x))
    _build.check(err, "bert_layer_bf16")
    launches.count("bert_layer_bf16")
    if parts is not None:
        for k, i, cols in (("y", 5, d), ("g", 8, f), ("r2", 9, d)):
            dt = torch.bfloat16 if k == "g" else torch.float32
            block = buf[offs[i]:offs[i] + sizes[i]].view(dt)
            parts[k] = block.reshape(b, npad, cols)[:, :n]
    return out if npad == n else out[:, :n].contiguous()


def bert_layer_bwd(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2, dout,
                   heads: int, eps: float, *, p_attn: float = 0.0, p_hidden: float = 0.0,
                   train: bool = False, seeds: Optional[torch.Tensor] = None,
                   saved: Optional[F32State] = None) -> tuple:
    """The bert_layer backward kernel chains on CUDA tensors (fp32 x and
    dout: `bert_layer_bwd_f32`, from the forward's kept state where `saved`
    holds it; bf16: the bf16 chain), the plain backward on CPU tensors:
    (dx, dwqkv, dbqkv, dwo, dbo, dg1, dbe1, dw1, db1, dw2, db2, dg2, dbe2),
    dx in x's dtype, the rest fp32."""
    _check_types(x)
    w = (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
    if not _build.on_cuda(x):
        return bert_layer_bwd_plain(x, mask_row, *w, dout, heads, eps, p_attn=p_attn,
                                    p_hidden=p_hidden, train=train, seeds=seeds)
    if x.dtype == torch.float32:
        return bert_layer_bwd_f32(x, mask_row, *w, dout, heads, eps, p_attn=p_attn,
                                  p_hidden=p_hidden, train=train, seeds=seeds, saved=saved)
    ta, th, sa, sh = _thresholds(p_attn, p_hidden, train, seeds)
    b, n, d = x.shape
    dev = x.device
    _build.require(dout, "dout", torch.bfloat16, (b, n, d), dev)
    xp, mask_p, seeds, weights, npad = _bf16_args(x, mask_row, w, seeds, heads)
    if npad != n:
        dout = torch.nn.functional.pad(dout, (0, 0, 0, npad - n))
    dout = _build.aligned16(dout)
    f = weights[6].shape[0]
    m = b * npad
    # the forward's workspaces, then out_ws, dr2 (then dy), dr1, do2, do1, dctx,
    # dh1, dqkv and the partial column sums of dqkv and dh1 (per 16 rows) and
    # of both LayerNorms (per 8)
    w_f32 = weights[0].dtype == torch.float32
    sizes = _bf16_work(b, npad, d, f, heads, backward=True, weights_f32=w_f32) + [
        2 * m * d, 4 * m * d, 4 * m * d, 2 * m * d, 2 * m * d, 2 * m * d, 2 * m * f,
        6 * m * d, 12 * (m // 16) * d, 4 * (m // 16) * f, 24 * -(-m // 8) * d]
    offs, total = _layout(sizes)
    buf = torch.empty((total,), dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, npad, d), dtype=torch.bfloat16, device=dev)
    grads = [torch.empty(s, **f32) for s in ((3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,),
                                             (f, d), (f,), (d, f), (d,), (d,), (d,))]
    err = _build.load().ctc_bert_layer_bwd(
        xp.data_ptr(), mask_p.data_ptr(), seeds.data_ptr(), *(t.data_ptr() for t in weights),
        dout.data_ptr(), *(base + o for o in offs), dx.data_ptr(),
        *(t.data_ptr() for t in grads), int(w_f32), b, n, npad, d, f,
        heads, float(eps), 1.0 / DIM_HEAD ** 0.5, ta, th, sa, sh, _build.stream_of(x))
    _build.check(err, "bert_layer_bwd")
    launches.count("bert_layer_bwd")
    return (dx if npad == n else dx[:, :n].contiguous(), *grads)


def keep_mask(seeds: torch.Tensor, site: int, b: int, heads: int, inner: int,
              rate: float) -> torch.Tensor:
    """The keep factors the kernels compute for one dropout site, as
    `philox_keep` lays them out: the CUDA generator on a CUDA `seeds`, the
    plain one on the CPU. A run holds the two against each other bit for
    bit."""
    if not _build.on_cuda(seeds):
        return philox_keep(seeds, site, b, heads, inner, rate)
    _build.require(seeds, "seeds", torch.int32, (3,), seeds.device)
    if inner % 4:
        raise ValueError(f"a dropout slab holds a multiple of 4 elements, got {inner}")
    out = torch.empty((b, heads, inner), dtype=torch.float32, device=seeds.device)
    err = _build.load().ctc_bert_keep_mask(seeds.data_ptr(), site, b, heads, inner,
                                           dropout_threshold(rate), 1.0 / (1.0 - rate),
                                           out.data_ptr(), _build.stream_of(seeds))
    _build.check(err, "bert_keep_mask")
    return out


class _BertLayerFn(torch.autograd.Function):
    """The layer with its backward: bert_layer and bert_layer_bwd, on CUDA
    tensors the kernel chains and on CPU tensors their plain versions. It
    saves its inputs (the weight matrices in x's dtype); where the backward
    will run (`keep`) an fp32 layer on the card also keeps the forward
    chain's state (`F32State`), and its backward starts from it. Elsewhere
    the backward recomputes the forward and regenerates the masks from the
    seeds, as the TPU kernel does."""

    @staticmethod
    def forward(ctx, x, mask_row, seeds, heads, eps, p_attn, p_hidden, train, keep, *w):
        dt = x.dtype
        cast = tuple(t.detach().to(dt) if t.dim() == 2 else t.detach() for t in w)
        ctx.save_for_backward(x, mask_row, seeds, *cast)
        ctx.cfg = (heads, eps, p_attn, p_hidden, train)
        ctx.dtypes = tuple(t.dtype for t in w)
        ctx.state = None
        kw = dict(p_attn=p_attn, p_hidden=p_hidden, train=train, seeds=seeds)
        if keep and dt == torch.float32 and _build.on_cuda(x):
            out, ctx.state = bert_layer_fp32(x, mask_row, *cast, heads, eps, **kw, keep=True)
            return out
        return bert_layer(x, mask_row, *cast, heads, eps, **kw)

    @staticmethod
    def backward(ctx, dout):
        x, mask_row, seeds, *w = ctx.saved_tensors
        heads, eps, p_attn, p_hidden, train = ctx.cfg
        dx, *grads = bert_layer_bwd(x, mask_row, *w, dout.contiguous(), heads, eps,
                                    p_attn=p_attn, p_hidden=p_hidden, train=train, seeds=seeds,
                                    saved=ctx.state)
        ctx.state = None
        return (dx, None, None, None, None, None, None, None, None,
                *(g.to(dt) for g, dt in zip(grads, ctx.dtypes)))


def bert_layer_grad(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
                    heads: int, eps: float, *, p_attn: float = 0.0, p_hidden: float = 0.0,
                    train: bool = False, seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bert_layer with its backward (the custom VJP of
    pallas_bert_layer.bert_layer_fused): dx in x's dtype and the twelve
    parameter gradients in the parameters' dtypes. Under autograd with an
    input that wants its gradient, an fp32 layer on the card keeps its
    forward's state for the backward."""
    w = (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in (x, *w))
    return _BertLayerFn.apply(x, mask_row, seeds, heads, eps, p_attn, p_hidden, train, keep, *w)
