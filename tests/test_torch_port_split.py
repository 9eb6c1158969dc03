"""What the CPU can check of the fp32 BERT layer's split-bf16 chain
(csrc/bert_layer.cu) and of the GEGLU FF backward's weight-gradient tiles
(csrc/geglu_ff_bwd.cu on csrc/wgrad_sm90.cuh).

The kernels run only on the card (tests/test_torch_port_cuda.py holds them
against their plain versions there). Here each one's arithmetic is
emulated in torch, at its rounding points and in its order of work:

- the fp32 layer with every product made of three bf16 products (hi =
  bf16(a), lo = bf16(a - hi); a_hi b_hi + a_lo b_hi + a_hi b_lo in fp32),
  P.V included, the attention an online softmax over 64-key chunks that
  skips the chunks the mask removes entirely, LayerNorm in one-pass
  moments: within 1e-4 (the card's fp32 band) of the JAX package's XLA
  twin `bert_layer_xla` and of `bert_layer_plain`, where the one-pass
  control (every lo plane zero) and a one-pass P.V alone do not; and the
  skipped chunks' sums are the same bits as the unskipped core's;
- the FF backward's chain, its weight gradients summed per 128 x 128 tile
  of `FFWgradPlan` over 64-token slices in order: every gradient within the
  card's bf16 band 1.5e-2 of `geglu_ff_bwd_plain` and of the VJP of the JAX
  `pallas_ff._xla_reference`; the same bits whatever order the tiles run
  in; a tile left unwritten or a token slice left out (the controls) miss
  the band.

Inputs are made from a seed with numpy.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.ops.pallas_bert_layer import bert_layer_xla
from ct_clip_ut_tpu.ops.pallas_ff import _xla_reference
from ct_clip_ut_tpu_torch.ops.bert_layer import bert_layer_plain
from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff_bwd_plain

from test_torch_port_cuda import (BERT_KEYS, _bert_inputs, _ff_inputs, _torch_bert_args,
                                  _torch_ff_args)

BERT_BAND = 1e-4      # the card's max relative error band of the fp32 layer
FLOAT_BAND = 1.5e-2   # the card's band of the bf16 kernels' gradients
KC = 64               # keys a chunk of the attention core
MASKED, REAL = -1e30, -1e20
TILE, SLICE = 128, 64  # the weight-gradient tile and its token slice


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- the split-bf16 fp32 layer -------------------------------------------------

def _split(t, one_pass=False):
    """The hi / lo planes the kernel writes, as fp32 tensors."""
    hi = t.to(torch.bfloat16).float()
    lo = torch.zeros_like(t) if one_pass else (t - hi).to(torch.bfloat16).float()
    return hi, lo


def _product(a, b):
    """a . b^T of planes a [.., m, k] and b [.., n, k]: the three passes of
    SplitPlan (A_hi B_hi, A_lo B_hi, A_hi B_lo) into one fp32 sum."""
    (ah, al), (bh, bl) = a, b

    def t(x):
        return x.transpose(-1, -2)

    return ah @ t(bh) + al @ t(bh) + ah @ t(bl)


def _ln(r, gamma, beta, eps):
    mean = r.mean(-1, keepdim=True)
    var = (r * r).mean(-1, keepdim=True) - mean * mean
    return (r - mean) * torch.rsqrt(var.clamp_min(0.0) + eps) * gamma + beta


def _attention(qkv, mask, b, n, d, heads, one_pass, skip, pv_one_pass=False):
    """attn_kernel: per (sequence, head), 64-key chunks with an online
    softmax in fp32; a chunk whose keys are all below MASKED is skipped
    when the sequence has a key above REAL. Returns ctx [b n, d]."""
    dh = d // heads
    scale = 1.0 / math.sqrt(dh)
    planes = [p.reshape(b, n, 3, heads, dh) for p in qkv]
    ctx = torch.empty((b, n, heads, dh))
    for s in range(b):
        mrow = mask[s]
        any_real = skip and bool((mrow > REAL).any())
        for h in range(heads):
            q = [p[s, :, 0, h] for p in planes]
            k = [p[s, :, 1, h] for p in planes]
            v = [p[s, :, 2, h] for p in planes]
            m = torch.full((n,), -math.inf)
            l, o = torch.zeros(n), torch.zeros((n, dh))
            for c0 in range(0, n, KC):
                keys = slice(c0, min(n, c0 + KC))
                if any_real and bool((mrow[keys] < MASKED).all()):
                    continue
                sc = _product(q, [t[keys] for t in k]) * scale + mrow[keys]
                mx = torch.maximum(m, sc.max(-1).values)
                alpha = torch.exp(m - mx)
                m = mx
                p = torch.exp(sc - m[:, None])
                l = l * alpha + p.sum(-1)
                pp = _split(p, one_pass or pv_one_pass)
                vv = [t[keys].t() for t in v]
                if pv_one_pass:
                    vv[1] = torch.zeros_like(vv[1])
                o = o * alpha[:, None] + _product(pp, vv)
            ctx[s, :, h] = o / l[:, None]
    return ctx.reshape(b * n, d)


def emulated_bert_layer(x, mask, w, heads, eps, *, one_pass=False, skip=True,
                        pv_one_pass=False):
    """csrc/bert_layer.cu's chain in torch: split, four SplitPlan products
    with their epilogues, attn_kernel, the two LayerNorm passes."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = w
    b, n, d = x.shape

    def sp(t):
        return _split(t, one_pass)

    x2 = x.reshape(b * n, d)
    qkv = sp(_product(sp(x2), sp(wqkv)) + bqkv)
    ctx = sp(_attention(qkv, mask, b, n, d, heads, one_pass, skip, pv_one_pass))
    y = _ln((_product(ctx, sp(wo)) + bo) + x2, g1, be1, eps)
    h1 = _product(sp(y), sp(w1)) + b1
    h = sp(0.5 * h1 * (1.0 + torch.erf(h1 * 0.7071067811865476)))
    r2 = (_product(h, sp(w2)) + b2) + y
    return _ln(r2, g2, be2, eps).reshape(b, n, d)


def _bert_case(seed, lengths, n=80):
    """3 sequences of n tokens, 2 heads of 64 (the kernel's head width),
    FF 256; `lengths` real keys a row."""
    a = _bert_inputs(np.random.default_rng(seed), len(lengths), n, 128, 256, lengths)
    x, mask, *w = _torch_bert_args(a)
    return a, x, mask, w


@pytest.mark.parametrize("lengths", [[80, 9, 1], [80, 70, 64]])
def test_split_bf16_layer_matches_jax_twin(lengths):
    """Three bf16 products for every product hold the fp32 layer to 1e-4;
    one bf16 product each (the one-pass control, as the card's ONE_PASS
    build) and a one-pass P.V alone read outside."""
    a, x, mask, w = _bert_case(41, lengths)
    twin = np.asarray(bert_layer_xla(*(jnp.asarray(a[k]) for k in BERT_KEYS), 2, 1e-12))
    plain = bert_layer_plain(x, mask, *w, 2, 1e-12)
    got = emulated_bert_layer(x, mask, w, 2, 1e-12)
    assert _rel(got, twin) <= BERT_BAND, _rel(got, twin)
    assert _rel(got, plain) <= BERT_BAND, _rel(got, plain)
    one_pass = emulated_bert_layer(x, mask, w, 2, 1e-12, one_pass=True)
    pv_one_pass = emulated_bert_layer(x, mask, w, 2, 1e-12, pv_one_pass=True)
    assert _rel(one_pass, twin) > BERT_BAND, _rel(one_pass, twin)
    assert _rel(pv_one_pass, twin) > BERT_BAND, _rel(pv_one_pass, twin)


def test_skipped_key_chunks_are_the_same_bits():
    """Chunks whose keys the mask removes add exactly 0 where the sequence
    has a real key: skipping them changes no bit. Rows: right-padded after
    9 keys (chunk 2 skipped), padded at the front (chunk 1 skipped), and
    all keys masked (nothing skipped: a uniform softmax, as the plain
    version's)."""
    a, x, mask, w = _bert_case(42, [130, 9, 130], n=130)
    mask[2, :64] = torch.finfo(torch.float32).min
    mask[0] = torch.finfo(torch.float32).min
    skipped = emulated_bert_layer(x, mask, w, 2, 1e-12)
    walked = emulated_bert_layer(x, mask, w, 2, 1e-12, skip=False)
    assert torch.equal(skipped, walked)
    assert _rel(skipped, bert_layer_plain(x, mask, *w, 2, 1e-12)) <= BERT_BAND


# ---- the FF backward's weight-gradient tiles ------------------------------------

def ff_wgrad_tiles(d: int, inner: int) -> list:
    """ffb::FFWgradPlan::tile for every block: (A operand, B operand, A's
    first column, B's first column, output, first output row, rows). A / B:
    0 g, 1 h, 2 dvalue, 3 dgate, 4 xn; output 0 dW2 [D, inner], 1 dW_in [2
    inner, D]."""
    d_tiles, inner_tiles = -(-d // TILE), -(-inner // TILE)
    tiles = []
    for t in range(3 * d_tiles * inner_tiles):
        if t < d_tiles * inner_tiles:
            i0, j0 = (t // inner_tiles) * TILE, (t % inner_tiles) * TILE
            tiles.append((0, 1, i0, j0, 0, i0, min(TILE, d - i0)))
        else:
            u = t - d_tiles * inner_tiles
            it, j0 = u // d_tiles, (u % d_tiles) * TILE
            gate = int(it >= inner_tiles)
            i0 = (it - inner_tiles if gate else it) * TILE
            tiles.append((2 + gate, 4, i0, j0, 1, gate * inner + i0, min(TILE, inner - i0)))
    return tiles


def emulated_wgrad(ops, outs, tiles, *, order=None, drop_slice=None, unwritten=None):
    """wgrad_kernel: each tile sums A[m, i0:i0+128]^T B[m, j0:j0+128] over
    the 64-token slices in order (columns past an operand read as zeros, as
    TMA fills them) and stores its rows; tiles run in `order`."""
    tokens = ops[0].shape[0]

    def cols(t, c0):
        block = torch.zeros((t.shape[0], TILE))
        part = t[:, c0:c0 + TILE]
        block[:, :part.shape[1]] = part
        return block

    for idx in (order if order is not None else range(len(tiles))):
        if idx == unwritten:
            continue
        a, b, i0, j0, o, orow0, nrows = tiles[idx]
        acc = torch.zeros((TILE, TILE))
        for k0 in range(0, tokens, SLICE):
            if k0 == drop_slice:
                continue
            acc += cols(ops[a][k0:k0 + SLICE], i0).t() @ cols(ops[b][k0:k0 + SLICE], j0)
        out = outs[o]
        ncols = min(TILE, out.shape[1] - j0)
        out[orow0:orow0 + nrows, j0:j0 + ncols] = acc[:nrows, :ncols]
    return outs


def emulated_ff_bwd(x, gamma, beta, w_in, w_out, g, residual, **wgrad):
    """csrc/geglu_ff_bwd.cu's chain at its rounding points: xn, h, dvalue,
    dgate bf16; dh, dxn, the LayerNorm backward fp32; the weight gradients
    through emulated_wgrad."""
    bf = torch.bfloat16
    inner, d = w_out.shape[1], x.shape[1]
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0) + 1e-5)
    xhat = (x32 - mean) * rstd
    xn = (xhat * gamma + beta).to(bf).float()
    gb, w = g.float(), w_in.float()
    dh = gb @ w_out.float()                       # fp32, in gate_bwd_kernel's registers
    value, gate = xn @ w[:inner].t(), xn @ w[inner:].t()
    cdf = 0.5 * (1.0 + torch.erf(gate * 0.7071067811865476))
    gel = gate * cdf
    gprime = cdf + gate * 0.3989422804014327 * torch.exp(-0.5 * gate * gate)
    h = (gel * value).to(bf).float()
    dvalue, dgate = (dh * gel).to(bf).float(), (dh * value * gprime).to(bf).float()
    dxn = dvalue @ w[:inner] + dgate @ w[inner:]
    dxhat = dxn * gamma
    dx = (dxhat - dxhat.mean(-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * rstd
    if residual:
        dx = dx + gb
    dw_out, dw_in = torch.full((d, inner), math.nan), torch.full((2 * inner, d), math.nan)
    emulated_wgrad([gb, h, dvalue, dgate, xn], [dw_out, dw_in], ff_wgrad_tiles(d, inner),
                   **wgrad)
    return dx.to(bf), (dxn * xhat).sum(0), dxn.sum(0), dw_in, dw_out


def _ff_case(n=200, dim=256):
    """bf16 x and weights at a ragged inner width (682) and token count."""
    rng = np.random.default_rng(43)
    a = _ff_inputs(rng, n=n, dim=dim)
    g = rng.standard_normal((n, dim)).astype(np.float32)
    args = list(_torch_ff_args(a))
    for i in (0, 3, 4):
        args[i] = args[i].bfloat16()
    return a, args, torch.from_numpy(g).bfloat16()


def _jax_grads(a, g, residual):
    """The VJP of pallas_ff._xla_reference on the bf16 inputs, in the port's
    layouts (w_in [2 inner, D], w_out [D, inner])."""
    bf = jnp.bfloat16
    args = [jnp.asarray(a["x"]).astype(bf), jnp.asarray(a["gamma"]), jnp.asarray(a["beta"]),
            jnp.asarray(a["wv"]).astype(bf), jnp.asarray(a["wg"]).astype(bf),
            jnp.asarray(a["w2"]).astype(bf)]
    _, vjp = jax.vjp(lambda *p: _xla_reference(*p, residual), *args)
    dx, dgamma, dbeta, dwv, dwg, dw2 = (np.asarray(t, np.float32)
                                        for t in vjp(jnp.asarray(g.float().numpy()).astype(bf)))
    return [dx, dgamma, dbeta, np.concatenate([dwv.T, dwg.T]), dw2.T]


NAMES = ("dx", "dgamma", "dbeta", "dw_in", "dw_out")


@pytest.mark.parametrize("residual", [False, True])
def test_ff_backward_tiles_match_plain_and_jax(residual):
    a, args, g = _ff_case()
    got = emulated_ff_bwd(*args, g, residual)
    plain = geglu_ff_bwd_plain(*args, g, residual)
    jax_grads = _jax_grads(a, g, residual)
    for name, x, p, j in zip(NAMES, got, plain, jax_grads):
        assert torch.isfinite(x).all(), name
        assert _rel(x.float(), p.float()) <= FLOAT_BAND, (name, _rel(x.float(), p.float()))
        assert _rel(x.float(), j) <= FLOAT_BAND, (name, _rel(x.float(), j))


def test_ff_wgrad_tiles_same_bits_in_any_order_and_controls():
    """Each tile's sum is its own, in one order: the tiles run in reverse
    give the same bits. A tile left unwritten (here NaN, as the kernel's
    output is never zeroed) or one token slice left out miss the band."""
    _, args, g = _ff_case()
    d, inner = args[0].shape[1], args[4].shape[1]
    tiles = ff_wgrad_tiles(d, inner)
    assert len(tiles) == 3 * 2 * 6          # D = 256: 2 tiles; inner = 682: 6
    assert {t[4] for t in tiles} == {0, 1}
    fwd = emulated_ff_bwd(*args, g, False)
    rev = emulated_ff_bwd(*args, g, False, order=range(len(tiles) - 1, -1, -1))
    for x, y in zip(fwd[3:], rev[3:]):
        assert torch.equal(x, y)
    plain = geglu_ff_bwd_plain(*args, g, False)
    for fault in (dict(unwritten=len(tiles) - 1), dict(unwritten=0), dict(drop_slice=SLICE)):
        bad = emulated_ff_bwd(*args, g, False, **fault)
        errs = [_rel(torch.nan_to_num(x, nan=0.0), p) for x, p in zip(bad[3:], plain[3:])]
        assert max(errs) > FLOAT_BAND, (fault, errs)


def test_bert_layer_fp32_refuses_cpu_tensors(monkeypatch):
    """The kernel chain's entry (with its controls) takes CUDA tensors only:
    on CPU tensors it raises before it builds anything; bert_layer is the
    route that takes the plain version there."""
    from ct_clip_ut_tpu_torch import _build
    from ct_clip_ut_tpu_torch.ops.bert_layer import bert_layer, bert_layer_fp32

    def no_build():
        raise AssertionError("the CUDA library was loaded")

    monkeypatch.setattr(_build, "load", no_build)
    _, x, mask, w = _bert_case(44, [80, 9, 1])
    with pytest.raises(ValueError, match="CUDA chain"):
        bert_layer_fp32(x, mask, *w, 2, 1e-12, one_pass=True)
    assert torch.equal(bert_layer(x, mask, *w, 2, 1e-12), bert_layer_plain(x, mask, *w, 2, 1e-12))
