"""The port's CTGenerate slice against the JAX package, on the CPU.

The JAX suite's small configurations (tests/test_ctgenerate.py:17-196): a
T5 of 2 layers x 32 (vocabulary 2048 here, so the stand-in WordTokenizer's
ids fit), a MaskGit of dim 16 in 4 heads of 4, and SMALL_GEN's CT-ViT (9 x
32 x 32 scans -> a 5 x 4 x 4 grid). Inputs come from numpy seeds; the
weights are the JAX init carried across by from_jax_ctgenerate_params.
Bands: fp32 1e-5 (sums in another order); bf16, the JAX suite's own bands
between its bf16 and fp32 routes: the CTGenerate cross-attention 3e-2
(test_ctgenerate.py:259-261), MaskGit's at SMALL_MG (:127-134), since the
port's kernels round where the TPU kernels do and the JAX CPU route rounds
where XLA does. JAX's random
bits cannot be matched (F4), so maskgit_generate is held to its
invariants and to its own generator.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_ut_tpu.config import CTGenerateConfig, CTViTConfig, MaskGitConfig, T5EncoderConfig
from ct_clip_ut_tpu.models import ctgenerate as jcg
from ct_clip_ut_tpu.models import ctvit as jctvit
from ct_clip_ut_tpu.models import maskgit as jmg
from ct_clip_ut_tpu.models import t5 as jt5
from ct_clip_ut_tpu.ops import attention as jattn
from ct_clip_ut_tpu.ops import taps as jtaps
from ct_clip_ut_tpu_torch import config as pconfig
from ct_clip_ut_tpu_torch import convert
from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
from ct_clip_ut_tpu_torch.models import ctgenerate as tcg
from ct_clip_ut_tpu_torch.models import ctvit as tctvit
from ct_clip_ut_tpu_torch.models import maskgit as tmg
from ct_clip_ut_tpu_torch.models import t5 as tt5
from ct_clip_ut_tpu_torch.ops import attention as tattn
from ct_clip_ut_tpu_torch.ops import taps as ttaps

KEY = jax.random.PRNGKey(0)
SMALL_T5 = T5EncoderConfig(vocab_size=2048, d_model=32, d_kv=8, num_heads=4, d_ff=64,
                           num_layers=2)
SMALL_MG = MaskGitConfig(dim=16, num_tokens=32, max_seq_len=128, heads=4, dim_head=4, depth=2,
                         dim_context=32)
SMALL_VIT = CTViTConfig(dim=16, codebook_size=32, image_size=32, patch_size=8,
                        temporal_patch_size=2, spatial_depth=1, temporal_depth=1, dim_head=4,
                        heads=4, model_type="ctgenerate")
SMALL_GEN = CTGenerateConfig(
    ctvit=SMALL_VIT,
    maskgit=MaskGitConfig(dim=16, num_tokens=32, max_seq_len=2048, heads=4, dim_head=4, depth=1,
                          dim_context=32),
    t5=SMALL_T5)
MG_GEN = CTGenerateConfig(ctvit=SMALL_VIT, maskgit=SMALL_MG, t5=SMALL_T5)
GRID = (2, 4, 4)
SCAN = (9, 32, 32)


def port_config(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw = {k: port_config(v) if dataclasses.is_dataclass(v) else v for k, v in kw.items()}
    return getattr(pconfig, type(jcfg).__name__)(**kw)


def jit(fn, cfg=None, **static):
    """fn with its config (the second argument) and static keywords bound,
    jitted: eager JAX on the CPU compiles op by op, ten times slower here."""
    if cfg is None:
        return jax.jit(functools.partial(fn, **static))
    return jax.jit(lambda first, *args, **kw: fn(first, cfg, *args, **static, **kw))


@functools.cache
def _union_params():
    union = dataclasses.replace(MG_GEN, maskgit=dataclasses.replace(SMALL_MG, max_seq_len=2048))
    return jit(jcg.init_ctgenerate, union)(KEY)


@functools.cache
def models(which: str):
    """(JAX params, the port's CTGenerate with the same weights) of SMALL_GEN
    ("gen") or MG_GEN ("mg", MaskGit 2 layers deep), from one JAX init of
    the union (2 layers, 2048 positions) cut to each; built once, never
    mutated for good."""
    params = _union_params()
    mg = params["maskgit"]
    if which == "gen":
        cfg = SMALL_GEN
        mg = {**mg, "transformer": {**mg["transformer"], "layers": mg["transformer"]["layers"][:1]}}
    else:
        cfg = MG_GEN
        mg = {**mg, "pos_emb": mg["pos_emb"][:SMALL_MG.max_seq_len]}
    params = {**params, "maskgit": mg}
    return params, convert.from_jax_ctgenerate_params(jax.tree.map(np.asarray, params),
                                                      port_config(cfg), device="cpu")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _bf16_close(got, want, cross, wcross):
    """The JAX suite's bands for MaskGit at SMALL_MG between its bf16 and
    fp32 routes (test_ctgenerate.py:127-134): logits or embeddings atol
    2e-1, a sanity bound; the cross-attention, what the heatmaps read, max
    1.5e-1 and mean 1e-2 (here against the JAX bf16 route: 0.068 / 1.6e-3
    dense, 0.106 / 1.8e-3 blockwise; JAX's own bf16 against its fp32 reads
    0.081 / 1.6e-3 and 0.113 / 1.6e-3)."""
    assert got.dtype == torch.bfloat16
    _close(got, want, atol=2e-1)
    dc = np.abs(np.asarray(cross.detach()) - np.asarray(wcross))
    assert dc.max() < 1.5e-1 and dc.mean() < 1e-2, (dc.max(), dc.mean())


def _rel_err(got, want):
    got = np.asarray(got.detach().float())
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _text(b=2, length=7, seed=2):
    emb = _rand((b, length, 32), seed)
    mask = np.ones((b, length), bool)
    mask[-1, length - 3:] = False
    return emb * mask[..., None], mask


def test_convert_carries_every_ctgenerate_weight():
    params, model = models("gen")
    jleaves = sum(int(np.asarray(x).size) for x in jax.tree.leaves(params))
    frozen = sum(m.beta.numel() for m in model.modules()
                 if isinstance(m, tattn.FrozenBiasLayerNorm))
    assert sum(t.numel() for t in model.state_dict().values()) == jleaves + frozen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_with_null_kv_mask_and_weights(dtype):
    params, model = models("mg")
    cfg = SMALL_MG.transformer().cross_attn()
    jp = params["maskgit"]["transformer"]["layers"][0]["cross_attn"]
    mod = model.maskgit.transformer.layers[0][2]
    x = _rand((2, 32, 16), 1)
    ctx, mask = _text()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want, wweights = jit(jattn.attention, cfg=cfg, return_weights=True, residual=True)(
        jp, jnp.asarray(x, jdt), context=jnp.asarray(ctx, jdt), mask=jnp.asarray(mask))
    got, gweights = tattn.attention(mod, torch.from_numpy(x).to(tdt),
                                    context=torch.from_numpy(ctx).to(tdt),
                                    mask=torch.from_numpy(mask), return_weights=True,
                                    residual=True)
    assert gweights.shape == (2, 4, 32, 7 + 2) and gweights.dtype == torch.float32
    if dtype == "float32":
        _close(got, want)
        _close(gweights, wweights)
    else:
        assert got.dtype == torch.bfloat16
        assert _rel_err(got, want) <= 1.5e-2
        _close(gweights, wweights, atol=1e-2)
    # the null key/values take weight; the masked text keys take none
    assert gweights[1, ..., -3:].abs().max() == 0 and gweights[..., :2].sum() > 0


@pytest.mark.parametrize("capture", [True, ("0.cross_attn_weights",), False])
def test_taps_capture_and_inject_match_jax(capture):
    """Taps: tap() adds the injected tensor of its name (cast to the
    activation's dtype) and records what it returns when the name is
    captured, as the JAX Taps does."""
    names = ("0.cross_attn_weights", "1.cross_attn_weights")
    a, z = _rand((2, 3), 7), _rand((2, 3), 8)
    jt = jtaps.Taps(capture=capture, inject={names[0]: jnp.asarray(z)})
    tt = ttaps.Taps(capture=capture, inject={names[0]: torch.from_numpy(z).double()})
    for name in names:
        got = tt.tap(name, torch.from_numpy(a))
        assert got.dtype == torch.float32
        _close(got, jt.tap(name, jnp.asarray(a)))
    assert set(tt.collected) == set(jt.collected)
    for name, want in jt.collected.items():
        _close(tt.collected[name], want)


def test_relative_position_buckets():
    for q, k, nb, md in ((9, 9, 32, 128), (40, 40, 32, 16), (5, 11, 8, 4)):
        want = jit(jt5.relative_position_buckets, qlen=q, klen=k, num_buckets=nb,
                   max_distance=md)()
        np.testing.assert_array_equal(tt5.relative_position_buckets(q, k, nb, md).numpy(),
                                      np.asarray(want))


def test_t5_encode_matches_jax():
    params, model = models("mg")
    rng = np.random.default_rng(3)
    ids = rng.integers(0, SMALL_T5.vocab_size, (2, 11))
    mask = np.ones((2, 11), np.int64)
    mask[1, 7:] = 0
    want = jit(jt5.t5_encode, cfg=SMALL_T5)(params["t5"], jnp.asarray(ids), jnp.asarray(mask))
    got = tt5.t5_encode(model.t5, torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got, want)
    assert got[1, 7:].abs().max() == 0


def test_t5_conditioner_with_the_stand_in_tokenizer():
    """encode() pads to the longest report; get_token_indices resolves
    keyword spans per row through convert_ids_to_tokens, as the JAX
    conditioner does with the same tokenizer."""
    params, model = models("mg")
    texts = ["There is emphysema in both lungs.", "Small left pleural effusion, no nodule."]
    keywords = ["Emphysema", "Pleural effusion", "Lung nodule"]
    jcond = jt5.T5TextConditioner(params["t5"], SMALL_T5, WordTokenizer(SMALL_T5.vocab_size))
    tcond = tt5.T5TextConditioner(model.t5, WordTokenizer(SMALL_T5.vocab_size))
    wemb, wmask = jcond.encode(texts)
    gemb, gmask = tcond.encode(texts)
    assert gmask.shape == (2, 10) and gmask.sum(1).tolist() == [9, 10]
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    _close(gemb, wemb)
    for i in range(2):
        assert tcond.get_token_indices(keywords, index=i) == jcond.get_token_indices(keywords,
                                                                                    index=i)
    assert tcond.get_token_indices(keywords, index=0) == {"Emphysema": [3]}
    assert tcond.get_token_indices(keywords, index=1) == {"Pleural effusion": [3, 4]}


def _maskgit_inputs(b=1):
    ids = np.random.default_rng(4).integers(0, SMALL_MG.num_tokens, (b, 32))
    ctx, mask = _text(b=b, seed=5)
    return ids, ctx, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maskgit_dense_route_matches_jax(dtype):
    """weights="all": logits and every layer's self and cross weights."""
    params, model = models("mg")
    ids, ctx, mask = _maskgit_inputs(2)
    cd = None if dtype == "float32" else dtype
    want = jit(jmg.maskgit_apply, cfg=SMALL_MG, video_patch_shape=GRID, compute_dtype=cd)(
        params["maskgit"], jnp.asarray(ids), jnp.asarray(ctx), text_mask=jnp.asarray(mask),
        video_mask=jnp.ones(ids.shape, bool))
    got = tmg.maskgit_apply(model.maskgit, torch.from_numpy(ids), torch.from_numpy(ctx), GRID,
                            text_mask=torch.from_numpy(mask),
                            video_mask=torch.ones(ids.shape, dtype=torch.bool), compute_dtype=cd)
    assert got.output.shape == (2, 32, SMALL_MG.num_tokens)
    assert len(got.cross_attn) == 2 and got.cross_attn[-1].shape == (2, 4, 32, 7 + 2)
    if dtype == "float32":
        _close(got.output, want.output)
        for g, w in zip(got.self_attn + got.cross_attn, want.self_attn + want.cross_attn):
            _close(g, w)
    else:
        for g, w in zip(got.cross_attn, want.cross_attn):
            _bf16_close(got.output, want.output, g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maskgit_blockwise_route_matches_jax(dtype):
    """self_attn_block = one 4 x 4 frame: the port's attn_qrows (plain on
    the CPU) against the JAX q-row scan; a prebuilt table changes nothing."""
    params, model = models("mg")
    ids, ctx, mask = _maskgit_inputs(2)
    cd = None if dtype == "float32" else dtype
    kw = dict(weights="last_cross", self_attn_block=16, return_embeds=True, compute_dtype=cd)
    want = jit(jmg.maskgit_apply, cfg=SMALL_MG, video_patch_shape=GRID, **kw)(
        params["maskgit"], jnp.asarray(ids), jnp.asarray(ctx), text_mask=jnp.asarray(mask))
    args = (model.maskgit, torch.from_numpy(ids), torch.from_numpy(ctx), GRID)
    got = tmg.maskgit_apply(*args, text_mask=torch.from_numpy(mask), **kw)
    assert len(got.cross_attn) == 1 and got.self_attn == ()
    if dtype == "float32":
        _close(got.output, want.output)
        _close(got.cross_attn[-1], want.cross_attn[-1])
    else:
        _bf16_close(got.output, want.output, got.cross_attn[-1], want.cross_attn[-1])
    table = tcg.maskgit_bias_table(model, GRID)
    again = tmg.maskgit_apply(*args, text_mask=torch.from_numpy(mask),
                              precomputed_bias=(table, None), **kw)
    torch.testing.assert_close(again.output, got.output, rtol=0, atol=0)


def test_maskgit_row_stripes_past_the_cap_match_the_table(monkeypatch):
    """Past BIAS_TABLE_MAX_BYTES the q-row route builds its bias per stripe;
    the result is the dense table's."""
    params, model = models("mg")
    ids, ctx, mask = _maskgit_inputs(2)
    kw = dict(text_mask=torch.from_numpy(mask), weights="none", self_attn_block=16)
    args = (model.maskgit, torch.from_numpy(ids), torch.from_numpy(ctx), GRID)
    dense = tmg.maskgit_apply(*args, **kw).output
    monkeypatch.setattr(tmg, "BIAS_TABLE_MAX_BYTES", 0)
    assert tmg.self_attn_bias(model.maskgit, GRID, 16, weights="none")[0] is None
    _close(tmg.maskgit_apply(*args, **kw).output, dense.detach().numpy())


def test_maskgit_gradient_shrink():
    """The gradient through the token embeddings is scaled by alpha, the
    value unchanged (maskgit.py:123-126). The objective weighs the output
    with fixed noise: a plain sum of norm_out's output is 0 by construction."""
    _, model = models("mg")
    ids = torch.from_numpy(np.random.default_rng(15).integers(0, 32, (1, 32)))
    ctx = torch.from_numpy(_rand((1, 3, 32), 16))
    weight = torch.from_numpy(_rand((1, 32, 16), 17))
    mg = model.maskgit

    def grad(alpha):
        mg.cfg = dataclasses.replace(mg.cfg, gradient_shrink_alpha=alpha)
        mg.token_emb.weight.grad = None
        out = tmg.maskgit_apply(mg, ids, ctx, GRID, return_embeds=True).output
        (out * weight).sum().backward()
        return out.detach(), mg.token_emb.weight.grad.clone()

    try:
        (out_a, g_a), (out_1, g_1) = grad(0.1), grad(1.0)
    finally:
        mg.cfg = port_config(SMALL_MG)
        mg.token_emb.weight.grad = None
    _close(out_a, out_1.numpy())
    ratio = g_a.abs().sum() / g_1.abs().sum()
    assert 0.099 < ratio < 0.101, ratio


def test_cosine_mask_counts_and_generate():
    for n, steps in ((32, 4), (6464, 18), (80, 7)):
        assert tmg._cosine_mask_counts(n, steps) == jmg._cosine_mask_counts(n, steps)
    _, model = models("mg")
    ctx, mask = _text(seed=6)
    kw = dict(text_mask=torch.from_numpy(mask), steps=4)

    def run(seed):
        return tmg.maskgit_generate(model.maskgit, torch.from_numpy(ctx), GRID,
                                    generator=torch.Generator().manual_seed(seed), **kw)

    ids = run(3)
    assert ids.shape == (2, 32) and ids.dtype == torch.int32
    assert ids.min() >= 0 and ids.max() < SMALL_MG.num_tokens    # no MASK left
    torch.testing.assert_close(run(3), ids, rtol=0, atol=0)
    assert (run(9) != ids).any()


@pytest.mark.parametrize("conv", [True, False])
def test_first_frame_embed_and_ctvit(conv):
    """The ctgenerate CT-ViT: the first frame embedded at temporal patch 1,
    the other 8 at 2, concatenated along t, both patch embeds."""
    params, model = models("gen")
    jcfg = dataclasses.replace(SMALL_VIT, patch_embed_conv=conv)
    model.ctvit.cfg = port_config(jcfg)
    try:
        scan = _rand((2, 1, *SCAN), 7)
        want = jit(jctvit.ctvit_apply, cfg=jcfg)(params["ctvit"], jnp.asarray(scan))
        with torch.no_grad():
            got = tctvit.ctvit_apply(model.ctvit, torch.from_numpy(scan))
    finally:
        model.ctvit.cfg = port_config(SMALL_VIT)
    assert got.codebook_ids.shape == (2, 5, 4, 4)
    np.testing.assert_array_equal(got.codebook_ids.numpy(), np.asarray(want.codebook_ids))
    _close(got.tokens, want.tokens)
    assert tctvit.token_grid_shape(model.ctvit.cfg, scan.shape) == (5, 4, 4)


def test_ctgenerate_apply_matches_jax():
    params, model = models("gen")
    scan = _rand((1, 1, *SCAN), 8)
    ctx, mask = _text(b=1, length=6, seed=9)
    kw_idx = {"emphysema": [2, 3]}
    want = jit(jcg.ctgenerate_apply, cfg=SMALL_GEN, keyword_indices=kw_idx)(
        params, jnp.asarray(scan), jnp.asarray(ctx), jnp.asarray(mask))
    got = tcg.ctgenerate_apply(model, torch.from_numpy(scan), torch.from_numpy(ctx),
                               torch.from_numpy(mask), kw_idx)
    assert got.video_patch_shape == want.video_patch_shape == (5, 4, 4)
    np.testing.assert_array_equal(got.codebook_ids.numpy(), np.asarray(want.codebook_ids))
    _close(got.feature_map, want.feature_map)
    _close(got.cross_attention, want.cross_attention)
    _close(got.kw_attention["emphysema"], want.kw_attention["emphysema"])
    heat = tcg.keyword_heatmap(got.kw_attention["emphysema"], got.video_patch_shape, SCAN)
    wheat = jit(jcg.keyword_heatmap, video_patch_shape=want.video_patch_shape,
                target_shape=SCAN)(want.kw_attention["emphysema"])
    assert heat.shape == SCAN and 0.0 <= heat.min() and heat.max() <= 1.0 + 1e-6
    _close(heat, wheat)


@pytest.mark.parametrize("shape", [(5, 4, 4), (101, 8, 8)])
def test_keyword_heatmap_is_jax_trilinear_resize(shape):
    """F.interpolate(trilinear, align_corners=False) upsampling equals
    jax.image.resize(..., "trilinear") (half-pixel centres, no antialias)."""
    n = int(np.prod(shape))
    cross = np.abs(_rand((1, 2, n, 3), 10))
    target = (9, 32, 32) if shape[0] == 5 else (201, 128, 128)
    got = tcg.keyword_heatmap(torch.from_numpy(cross), shape, target)
    want = jit(jcg.keyword_heatmap, video_patch_shape=shape, target_shape=target)(
        jnp.asarray(cross))
    _close(got, want)


def test_ctgenerate_batched_matches_jax():
    """fp32 against the JAX batched forward at 1e-5 with equal ids; the
    bf16 serving default within 3e-2 of the JAX fp32 route, as the JAX
    suite holds its own bf16 route (test_ctgenerate.py:253-261)."""
    params, model = models("gen")
    scans = _rand((2, 1, *SCAN), 11)
    ctx, mask = _text(b=2, length=6, seed=12)
    want = jcg.ctgenerate_apply_batched(params, SMALL_GEN, jnp.asarray(scans), jnp.asarray(ctx),
                                        jnp.asarray(mask), compute_dtype="float32")
    args = (model, torch.from_numpy(scans), torch.from_numpy(ctx), torch.from_numpy(mask))
    got = tcg.ctgenerate_apply_batched(*args, compute_dtype="float32")
    np.testing.assert_array_equal(got.codebook_ids.numpy(), np.asarray(want.codebook_ids))
    _close(got.feature_map, want.feature_map)
    _close(got.cross_attention, want.cross_attention)
    bf = tcg.ctgenerate_apply_batched(*args, bias_cache={})
    np.testing.assert_array_equal(bf.codebook_ids.numpy(), np.asarray(want.codebook_ids))
    _close(bf.cross_attention, want.cross_attention, atol=3e-2, rtol=3e-2)
    with pytest.raises(TypeError, match="DataMesh"):
        tcg.ctgenerate_apply_batched(*args, mesh=object())


def test_bias_cache_on_the_qrows_route(monkeypatch):
    """With the q-row route forced at this small grid, the batched forward
    builds the table once into the cache, reuses it, and equals the dense
    route (fp32: the same function)."""
    _, model = models("gen")
    scans = torch.from_numpy(_rand((2, 1, *SCAN), 13))
    ctx, mask = (torch.from_numpy(a) for a in _text(b=2, length=6, seed=14))
    dense = tcg.ctgenerate_apply_batched(model, scans, ctx, mask, compute_dtype="float32")
    monkeypatch.setattr(tmg, "QROWS_MIN_TOKENS", 64)
    assert tmg.qrows_route(model.cfg.maskgit, (5, 4, 4)) == (16, True)
    cache = {}
    got = tcg.ctgenerate_apply_batched(model, scans, ctx, mask, bias_cache=cache,
                                       compute_dtype="float32")
    assert list(cache) == [(5, 4, 4, "float32")]
    table = cache[(5, 4, 4, "float32")]
    tcg.ctgenerate_apply_batched(model, scans, ctx, mask, bias_cache=cache,
                                 compute_dtype="float32")
    assert cache[(5, 4, 4, "float32")] is table
    _close(got.feature_map, dense.feature_map)
    _close(got.cross_attention, dense.cross_attention)


def test_flagship_grid_route():
    """At CTGenerateConfig()'s 201 x 128 x 128 scans the grid is 101 x 8 x 8
    = 6,464 tokens: the q-row route with one 64-token frame per block, and
    the dense table (8 x 6464^2 x 4 B = 1.34 GB) under the 2 GiB cap.
    Decided from the shapes alone; no table is built."""
    cfg = pconfig.CTGenerateConfig()
    grid = tctvit.token_grid_shape(cfg.ctvit, (2, 1, 201, 128, 128))
    assert grid == (101, 8, 8)
    assert tmg.qrows_route(cfg.maskgit, grid) == (64, True)
    assert tmg.qrows_route(cfg.maskgit, (201, 8, 8)) == (64, False)   # past the cap
    assert tmg.qrows_route(cfg.maskgit, (5, 4, 4)) == (None, True)     # the dense route


def test_inference_script_localize_and_generate():
    """The script's batched localisation body and its decode, at the small
    configuration on the CPU (fp32 MaskGit: the CPU's parity route)."""
    from ct_clip_ut_tpu_torch.scripts import inference_ctgenerate as script
    _, model = models("gen")
    t5 = tt5.T5TextConditioner(model.t5, WordTokenizer(SMALL_T5.vocab_size))
    scans = torch.from_numpy(_rand((2, 1, *SCAN), 18))
    reports = ["Emphysema and a lung nodule.", "Cardiomegaly, small pleural effusion."]
    labels = np.zeros((2, 18))
    labels[0, [7, 9]] = 1                 # Emphysema, Lung nodule
    labels[1, [2, 3]] = 1                 # Cardiomegaly, Pericardial effusion (not in the report)
    maps = script.localize(model, t5, scans, reports, labels, {}, "float32")
    assert [sorted(m) for m in maps] == [["Emphysema", "Lung nodule"], ["Cardiomegaly"]]
    text_embed, text_mask = t5.encode(reports)
    out = tcg.ctgenerate_apply_batched(model, scans, text_embed, text_mask,
                                       compute_dtype="float32")
    idx = t5.get_token_indices(["Lung nodule"], index=0)["Lung nodule"]
    want = tcg.keyword_heatmap(out.cross_attention[:1][..., idx], (5, 4, 4), SCAN)
    np.testing.assert_array_equal(maps[0]["Lung nodule"], want.numpy())
    assert all(v.shape == SCAN and 0.0 <= v.min() and v.max() <= 1.0 + 1e-6
               for m in maps for v in m.values())
    ids = script.generate(model, t5, ["Emphysema.", "Normal chest."], SCAN[0], 3, 1.0, 0,
                          "float32")
    assert ids.shape == (2, 5, 4, 4) and ids.min() >= 0 and ids.max() < SMALL_MG.num_tokens


@pytest.mark.parametrize("argv", [["--generate", "p", "--t5", "google/t5-v1_1-base"],
                                  ["--scans", "s.npy", "--reports", "r.txt", "--gifs",
                                   "--t5", "google/t5-v1_1-base"]])
def test_inference_script_raises_for_what_is_not_ported(argv):
    from ct_clip_ut_tpu_torch.scripts import inference_ctgenerate as script
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        script.main(argv)


@pytest.mark.parametrize("argv", [["--data-valid", "d", "--valid-reports", "r",
                                   "--valid-labels", "l", "--valid-metadata", "m"],
                                  ["--generate", "p"]])
def test_inference_script_mesh_data_needs_its_processes(argv):
    """--mesh-data N in one process raises naming torchrun before the model
    loads; the parser has the JAX script's mesh flag alone (no --mesh-model)."""
    from ct_clip_ut_tpu_torch.scripts import inference_ctgenerate as script
    with pytest.raises(ValueError, match="--mesh-data 2 needs 2 processes.*torchrun"):
        script.main(argv + ["--mesh-data", "2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        script.build_parser().parse_args(argv + ["--mesh-model", "2"])
