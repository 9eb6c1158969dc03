"""What the CPU can check of the fp32 train step's kernel chains: the full
fp32 backwards of the blocks and the FF (`ctc_attn_block_bwd_f32` /
`ctc_attn_packed_bwd_f32` with every parameter gradient, rows 7F and 8F;
`ctc_geglu_ff_bwd_f32` with dgamma, dbeta, dW_in, dW2, row 9F), the fp32
residual-saving patch embed (`ctc_patch_embed_res_f32`, row 10f) and its
weight gradient (`ctc_patch_embed_dkw_f32`, row 11f).

The chains run only on the card (chip_smoke.py phase 14 and the card tests
`-k "fp32_full or fp32_patch_embed_res"` hold them against their plain
versions there). Here each is emulated in torch plane by plane, as
tests/test_torch_port_f32_bwd_hopper.py does for the dx chains: every fp32
product three bf16 products of hi / lo planes, the planes written where the
kernels write them, and the weight gradients as the split wgrad plans take
them, A^T B over the tokens from the planes the dx chain already wrote (dq,
xn; dk | dv, x; g, o; g, h; dvalue | dgate, xn; P, dconv). The LN gains',
the scales' and the bias's gradients are fp32 sums of fp32 values (dS from
the split scores). The emulations are held against jax.vjp with respect to
every parameter of the JAX package's XLA twins (`_xla_reference_block`,
`packed_attention_xla`, `pallas_ff._xla_reference`), the patch embed's
against its Pallas kernels in interpret mode (`_forward_res_impl`,
`_dkw_impl`), and all against the port's plain versions, at fp32, within
2e-5 of each output's largest entry; the one-pass control (every lo plane
zero, 3e-3 to 1e-2) misses each band. Two exceptions, each with its own
band: the scale gradients dq_scale and dk_scale, sums over every token and
head of u . dq^ whose 32 entries are small beside their terms, read up to
2.9e-5 here (SCALE_GRAD_BAND); and dx, which is the data-gradient chain's
(the card reads the same bits) and is held against the plain backward
here, against jax.vjp in tests/test_torch_port_f32_bwd_hopper.py. Last, the
split wgrad plans' tiles (mirrored from csrc/) cover every output element
once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.ops.pallas_attn_block import _xla_reference_block
from ct_clip_ut_tpu.ops.pallas_attn_packed import packed_attention_xla
from ct_clip_ut_tpu.ops.pallas_ff import _xla_reference
from ct_clip_ut_tpu.ops.pallas_patch_embed import _dkw_impl, _forward_res_impl
from ct_clip_ut_tpu_torch.ops import attn_block, geglu_ff, patch_embed
from ct_clip_ut_tpu_torch.ops.patch_embed import EPS, _kernel_weight, _patches

from test_torch_port_cuda import (_attn_inputs, _ff_inputs, _patch_args, _patch_inputs,
                                  _torch_attn_args, _torch_ff_args)
from test_torch_port_f32_bwd_hopper import _ln_bwd, _row_term, _t
from test_torch_port_f32_hopper import _ln_planes, _product, _split
from test_torch_port_kernels import _jax_fold

BAND = 2e-5              # max |got - want| / max |want| of each gradient
SCALE_GRAD_BAND = 5e-5   # of dq_scale and dk_scale (see the docstring)
SCALE = 8.0


def _band(name: str) -> float:
    return SCALE_GRAD_BAND if name in ("qs", "ks") else BAND


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _wgrad(a, b):
    """A^T B over the token rows of planes a [M, i] and b [M, j]: the split
    wgrad plan's three passes (A_hi B_hi, A_lo B_hi, A_hi B_lo)."""
    return _product(_t(a), _t(b))


def _ln_gain_grads(x, dxn):
    """ln_bwd_f32_kernel<true> + colsum: (sum of dxn xhat, sum of dxn) over
    the rows, xhat from the one-pass moments."""
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    xhat = (x - mean) * torch.rsqrt(var + 1e-5)
    return (dxn * xhat).sum(0), dxn.sum(0)


def emulated_block_bwd_f32_full(x, gamma, wq, wk, wv, wo, qs, ks, bias, g, scale,
                                residual=False, one_pass=False):
    """tc::block_backward_f32 with its parameter gradients: the dx chain of
    emulated_block_bwd_f32 (test_torch_port_f32_bwd_hopper.py) with D =
    rowsum(P dP) / rowsum(P) from the same split dP (`_row_term`, the walk),
    then dgamma from the LN backward's partial sums, dq_scale / dk_scale
    from the passes' u . dq^ / u . dk^ sums, dbias = sum over sequences of
    the fp32 dS, and dWq = dq^T xn, dWk | dWv = [dk | dv]^T x, dWo = g^T o
    on the planes (BlockWgradSplitPlan). Returns the gradients of
    attn_block_bwd_plain."""
    r, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    hd = heads * dh
    m = r * n
    x2, g2 = x.reshape(m, d), g.reshape(m, d)
    sp = (lambda t: _split(t, one_pass))
    wqs, wks, wvs, wos = sp(wq), sp(wk), sp(wv), sp(wo)

    def heads_of(t):   # [m, h*dh] -> [r, h, n, dh]
        return t.reshape(r, n, heads, dh).transpose(1, 2)

    def merged(t):     # [r, h, n, dh] -> [m, h*dh]
        return t.transpose(1, 2).reshape(m, hd)

    xn, xs, gs = _ln_planes(x2, gamma, None, one_pass), sp(x2), sp(g2)
    q, k = heads_of(_product(xn, wqs)), heads_of(_product(xs, wks))
    v = sp(heads_of(_product(xs, wvs)))
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    kn = torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12)
    uq, uk = q / qn, k / kn
    qsc = qs * scale
    qh, kh = sp(uq * qsc), sp(uk * ks)
    do = sp(heads_of(_product(gs, _t(wos))))
    s = _product(qh, kh)
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    o = _product(sp(p), _t(v))
    dp = _product(do, v)
    ds = p * (dp - _row_term(p, dp))
    dqh = _product(sp(ds), _t(kh))
    dkh = _product(sp(ds.transpose(-1, -2)), _t(qh))
    dv = _product(sp(p.transpose(-1, -2)), _t(do))
    duq, duk = dqh * qsc, dkh * ks
    dq = merged((duq - uq * (uq * duq).sum(-1, keepdim=True)) / qn)
    dk = merged((duk - uk * (uk * duk).sum(-1, keepdim=True)) / kn)
    dqs_, dkvs = sp(dq), sp(torch.cat([dk, merged(dv)], dim=-1))
    dxn = _product(dqs_, _t(wqs))
    dxd = _product(dkvs, _t(sp(torch.cat([wk, wv]))))
    dx = _ln_bwd(x2, gamma, dxn, dxd)
    dx = (dx + g2 if residual else dx).reshape(r, n, d)
    dgamma = _ln_gain_grads(x2, dxn)[0]
    dwqkv = torch.cat([_wgrad(dqs_, xn), _wgrad(dkvs, xs)])
    dwo = _wgrad(gs, sp(merged(o)))
    dqsc = (uq * dqh).sum((0, 1, 2)) * scale
    dksc = (uk * dkh).sum((0, 1, 2))
    dbias = ds.sum(0) if bias is not None else None
    return (dx, dgamma, dwqkv[:hd], dwqkv[hd:2 * hd], dwqkv[2 * hd:], dwo, dqsc, dksc, dbias)


def emulated_geglu_ff_bwd_f32_full(x, gamma, beta, w_in, w_out, g, residual=False,
                                   one_pass=False):
    """ctc_geglu_ff_bwd_f32 with its parameter gradients: the dx chain,
    h = gelu(gate) value written as planes by the recompute's epilogue,
    dgamma | dbeta from the LN backward's partial sums, dW2 = g^T h and
    [dWv; dWg] = [dvalue | dgate]^T xn on the planes (FFWgradSplitPlan)."""
    inner = w_out.shape[1]
    w = _split(w_in, one_pass)
    xn = _ln_planes(x, gamma, beta, one_pass)
    vg = _product(xn, w)
    value, gate = vg[:, :inner], vg[:, inner:]
    gs = _split(g, one_pass)
    dh = _product(gs, _t(_split(w_out, one_pass)))
    cdf = 0.5 * (1.0 + torch.erf(gate * 0.7071067811865476))
    gprime = cdf + gate * 0.3989422804014327 * torch.exp(-0.5 * gate * gate)
    dvg = _split(torch.cat([dh * gate * cdf, dh * value * gprime], dim=-1), one_pass)
    dxn = _product(dvg, _t(w))
    dx = _ln_bwd(x, gamma, dxn, g if residual else None)
    dgamma, dbeta = _ln_gain_grads(x, dxn)
    dw_out = _wgrad(gs, _split(gate * cdf * value, one_pass))
    dw_in = torch.cat([_wgrad([t[:, :inner] for t in dvg], xn),
                       _wgrad([t[:, inner:] for t in dvg], xn)])
    return dx, dgamma, dbeta, dw_in, dw_out


def _jax_vjp(fn, primals, g):
    """Every primal's cotangent of <fn(*primals), g> by jax.vjp, jitted."""
    return [np.asarray(t) for t in jax.jit(lambda p, g: jax.vjp(fn, *p)[1](g))(primals, g)]


@pytest.mark.parametrize("r,n,with_bias,residual", [(3, 40, True, False), (2, 64, True, True),
                                                    (4, 24, False, False), (6, 7, False, True)])
def test_block_bwd_f32_full_chain_matches_the_jax_vjp(r, n, with_bias, residual):
    rng = np.random.default_rng(n + r + 300)
    a = _attn_inputs(rng, r, n, 64, 4, 32, with_bias)
    g = rng.standard_normal((r, n, 64)).astype(np.float32)
    args = _torch_attn_args(a)
    bias = torch.from_numpy(a["bias"]) if with_bias else None
    tg = torch.from_numpy(g)
    if with_bias:
        got = emulated_block_bwd_f32_full(*args, bias, tg, SCALE, residual)
        control = emulated_block_bwd_f32_full(*args, bias, tg, SCALE, residual, one_pass=True)
    else:
        # the temporal chain at n <= 64: the fused pass, its weight
        # gradients chunked over the tokens
        from test_torch_port_packed_bwd_hopper import emulated_packed_bwd_f32

        got = emulated_packed_bwd_f32(*args, tg, SCALE, residual, params=True)
        control = emulated_packed_bwd_f32(*args, tg, SCALE, residual, one_pass=True, params=True)
    names = ("x", "gamma", "wq", "wk", "wv", "wo", "qs", "ks") + (("bias",) if with_bias else ())
    primals = [jnp.asarray(a[k]) for k in names]
    if with_bias:
        twin = _jax_vjp(lambda *p: _xla_reference_block(*p, SCALE, residual), primals,
                        jnp.asarray(g))
    else:
        twin = _jax_vjp(lambda *p: packed_attention_xla(*p, SCALE, residual), primals,
                        jnp.asarray(g))
    twin[2:6] = [t.T for t in twin[2:6]]          # the JAX layouts [D, h*dh] / [h*dh, D]
    plain = attn_block.attn_block_bwd_plain(*args, bias, tg, SCALE, residual)
    for want in (twin, plain):
        for name, gt, ct, wt in zip(names, got, control, want):
            if name != "x" or want is plain:
                assert _rel_err(gt, wt) <= _band(name), name
            assert _rel_err(ct, wt) > _band(name), name


@pytest.mark.parametrize("n,dim,residual", [(20, 64, False), (77, 64, True), (33, 128, False)])
def test_geglu_ff_bwd_f32_full_chain_matches_the_jax_vjp(n, dim, residual):
    rng = np.random.default_rng(n + 400)
    a = _ff_inputs(rng, n, dim)
    g = rng.standard_normal((n, dim)).astype(np.float32)
    args = _torch_ff_args(a)
    tg = torch.from_numpy(g)
    got = emulated_geglu_ff_bwd_f32_full(*args, tg, residual)
    control = emulated_geglu_ff_bwd_f32_full(*args, tg, residual, one_pass=True)
    primals = [jnp.asarray(a[k]) for k in ("x", "gamma", "beta", "wv", "wg", "w2")]
    dx, dgamma, dbeta, dwv, dwg, dw2 = _jax_vjp(
        lambda *p: _xla_reference(*p, residual), primals, jnp.asarray(g))
    twin = (dx, dgamma, dbeta, np.concatenate([dwv.T, dwg.T]), dw2.T)
    plain = geglu_ff.geglu_ff_bwd_plain(*args, tg, residual)
    for want in (twin, plain):
        for name, gt, ct, wt in zip(("dx", "dgamma", "dbeta", "dw_in", "dw_out"), got, control,
                                    want):
            if name != "dx" or want is plain:
                assert _rel_err(gt, wt) <= BAND, name
            assert _rel_err(ct, wt) > BAND, name


def emulated_patch_embed_res_f32(image, kw, s1, b1, g2, b2, patch, t_patch, one_pass=False):
    """ctc_patch_embed_res_f32: patchify_f32_kernel (P's planes, LN1 moments
    one-pass in fp32), SplitPlan P . Kw^T with PatchF32Epi storing conv and
    h, pe_ln_f32_kernel (LN2, two-pass). Returns (out, conv, stats, P's
    planes)."""
    b, _, T, H, W = image.shape
    p = _patches(image, patch, t_patch)
    mean = p.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((p * p).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0) + EPS)
    planes = _split(p, one_pass)
    conv = _product(planes, _split(_kernel_weight(kw, torch.float32), one_pass))
    h = (conv - mean * s1) * rstd + b1
    mu = h.mean(-1, keepdim=True)
    out = (h - mu) * torch.rsqrt(((h - mu) ** 2).mean(-1, keepdim=True) + EPS) * g2 + b2
    out = out.reshape(b, T // t_patch, H // patch, W // patch, -1)
    return out, conv, torch.cat([mean, rstd], dim=-1), planes


def emulated_patch_embed_dkw_f32(planes, dconv, patch, one_pass=False):
    """ctc_patch_embed_dkw_f32: dconv split by a row pass, PatchWgradSplitPlan
    P^T dconv over the forward's planes, row k = (cin, wv) stored at (wv,
    cin) by DkwStoreEpi."""
    dk = _wgrad(planes, _split(dconv, one_pass))
    return dk.reshape(-1, patch, dk.shape[-1]).transpose(0, 1)


@pytest.mark.parametrize("shape,patch,t_patch,dim", [((2, 1, 6, 16, 16), 4, 2, 128),
                                                     ((1, 1, 4, 32, 48), 16, 2, 64)])
def test_patch_embed_res_and_dkw_f32_match_the_pallas_kernels(shape, patch, t_patch, dim):
    b, _, T, H, W = shape
    a = _patch_inputs(np.random.default_rng(500 + patch), b, T, H, W, patch, t_patch, dim)
    args = _patch_args(a, patch, t_patch)
    jargs = (jnp.asarray(a["image"]), *_jax_fold(a, patch, t_patch), jnp.asarray(a["g2"]),
             jnp.asarray(a["b2"]))
    out, conv, mean2, var2 = _forward_res_impl(*jargs, patch=patch, t_patch=t_patch,
                                               interpret=True)
    kernel = (np.asarray(out), np.asarray(conv).reshape(-1, dim),
              np.stack([np.asarray(mean2).reshape(-1),
                        1.0 / np.sqrt(np.asarray(var2).reshape(-1) + 1e-5)], -1))
    plain = patch_embed.patch_embed_res_plain(*args, patch, t_patch)
    *got, planes = emulated_patch_embed_res_f32(*args, patch, t_patch)
    one = emulated_patch_embed_res_f32(*args, patch, t_patch, one_pass=True)
    for want in (kernel, plain):
        for name, gt, wt in zip(("out", "conv", "stats"), got, want):
            assert _rel_err(gt, wt) <= BAND, name
        assert _rel_err(one[1], want[1]) > BAND

    m = conv.shape[0] * conv.shape[1] * conv.shape[2] * conv.shape[3]
    dconv = np.random.default_rng(600).standard_normal((m, dim)).astype(np.float32)
    jd = _dkw_impl(jnp.asarray(a["image"]),
                   jnp.asarray(dconv).reshape(b, T // t_patch, H // patch, W // patch, dim),
                   patch=patch, t_patch=t_patch, interpret=True)
    td = torch.from_numpy(dconv)
    got = emulated_patch_embed_dkw_f32(planes, td, patch)
    control = emulated_patch_embed_dkw_f32(one[3], td, patch, one_pass=True)
    for want in (np.asarray(jd), patch_embed.patch_embed_dkw_plain(args[0], td, patch, t_patch)):
        assert got.shape == want.shape == (patch, t_patch * patch, dim)
        assert _rel_err(got, want) <= BAND
        assert _rel_err(control, want) > BAND


# ---- the split wgrad plans' tiles (csrc/attn_bwd_f32.cuh, geglu_ff_bwd_f32.cu,
# patch_embed_dkw.cu), mirrored ---------------------------------------------------

BM = BN = 128


def block_wgrad_tiles(hd, d):
    """BlockWgradSplitPlan: (map a, map b, i0, j0, out, orow0, nrows) per tile."""
    d_tiles, h_tiles = -(-d // BN), hd // BN
    q, tiles = h_tiles * d_tiles, []
    for t in range(4 * q):
        if t < 3 * q:
            is_q = t < q
            u = t if is_q else t - q
            i0, j0 = (u // d_tiles) * BM, (u % d_tiles) * BN
            tiles.append((0 if is_q else 4, 2 if is_q else 6, i0, j0, 0, i0 if is_q else hd + i0,
                          min(BM, (hd if is_q else 2 * hd) - i0)))
        else:
            u = t - 3 * q
            i0, j0 = (u // h_tiles) * BM, (u % h_tiles) * BN
            tiles.append((8, 10, i0, j0, 1, i0, min(BM, d - i0)))
    return tiles


def ff_wgrad_tiles(d, inner, ldh):
    """FFWgradSplitPlan's tiles."""
    d_tiles, inner_tiles = -(-d // BN), -(-inner // BN)
    tiles = []
    for t in range(3 * d_tiles * inner_tiles):
        if t < d_tiles * inner_tiles:
            i0, j0 = (t // inner_tiles) * BM, (t % inner_tiles) * BN
            tiles.append((0, 2, i0, j0, 0, i0, min(BM, d - i0)))
        else:
            u = t - d_tiles * inner_tiles
            it, j0 = u // d_tiles, (u % d_tiles) * BN
            gate = it >= inner_tiles
            i0 = (it - inner_tiles if gate else it) * BM
            tiles.append((4, 6, gate * ldh + i0, j0, 1, gate * inner + i0, min(BM, inner - i0)))
    return tiles


def _written(tiles, shapes):
    """How often the tiles write each element of the outputs (columns < the
    output's, as WgradStoreEpi masks them)."""
    seen = [np.zeros(s, np.int64) for s in shapes]
    for _, _, _, j0, out, orow0, nrows in tiles:
        if nrows > 0:
            seen[out][orow0:orow0 + nrows, j0:j0 + BN] += 1
    return seen


@pytest.mark.parametrize("hd,d", [(256, 512), (128, 64), (384, 200)])
def test_block_wgrad_split_plan_writes_every_gradient_once(hd, d):
    tiles = block_wgrad_tiles(hd, d)
    assert all(a % 2 == 0 and b % 2 == 0 for a, b, *_ in tiles)   # hi maps; lo at a + 1, b + 1
    for seen in _written(tiles, [(3 * hd, d), (d, hd)]):
        assert (seen == 1).all()
    # the rows a tile reads are the columns of its A operand: dq, dk | dv, g
    for a, _, i0, _, out, orow0, _ in tiles:
        assert orow0 == (i0 if a in (0, 8) else hd + i0)


@pytest.mark.parametrize("d,inner", [(512, 1365), (64, 42), (128, 340)])
def test_ff_wgrad_split_plan_keeps_the_padding_out(d, inner):
    ldh = -(-inner // 8) * 8
    tiles = ff_wgrad_tiles(d, inner, ldh)
    assert len(tiles) == 3 * -(-d // BN) * -(-inner // BN)
    for seen in _written(tiles, [(d, inner), (2 * inner, d)]):
        assert (seen == 1).all()
    # a gate tile reads dvalue | dgate's columns ldh + i0 ..., stores rows inner + i0 ...
    for a, _, i0, _, out, orow0, nrows in tiles:
        if out == 1 and orow0 >= inner:
            assert i0 - ldh == orow0 - inner and i0 + nrows <= ldh + inner
