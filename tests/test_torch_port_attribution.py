"""The port's forward attribution methods (raw attention, rollout,
occlusion) against the JAX package's, on the CPU.

SMALL_CLIP of tests/test_attribution.py (CT-ViT dim 16, 2 + 2 layers of 4
heads of 4, 32 codes, a [1, 1, 20, 32, 32] volume, 8-token prompts); the
JAX weights carried into the port by convert.from_jax_params; images, ids
and embeddings from numpy seeds; the JAX functions jitted. Bands: the
rollout matrix 1e-5; maps 1e-3 (the saliency band; they hold at 2e-5);
latents and occlusion scores 1e-5; the upsamples 1e-5 against
jax.image.resize.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu import config as jconfig
from ct_clip_ut_tpu.attribution import occlusion as jocc
from ct_clip_ut_tpu.attribution import raw_attention as jraw
from ct_clip_ut_tpu.attribution import rollout as jroll
from ct_clip_ut_tpu.attribution import capture as jcap
from ct_clip_ut_tpu.models import ctclip as jclip
from ct_clip_ut_tpu.models import ctvit as jvit
from ct_clip_ut_tpu_torch import config as pconfig
from ct_clip_ut_tpu_torch import convert
from ct_clip_ut_tpu_torch.attribution import capture, occlusion, raw_attention, rollout
from ct_clip_ut_tpu_torch.models import ctclip as tclip

from test_torch_port_modules import port_config

SMALL_BERT = jconfig.BertConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
                                intermediate_size=64, max_position_embeddings=16)
SMALL_VIT = jconfig.CTViTConfig(dim=16, codebook_size=32, image_size=32, patch_size=8,
                                temporal_patch_size=10, spatial_depth=2, temporal_depth=2,
                                dim_head=4, heads=4)
SMALL_CLIP = jconfig.CTCLIPConfig(dim_text=32, dim_image=4 * 4 * 16, dim_latent=8,
                                  ctvit=SMALL_VIT, bert=SMALL_BERT)
MAP_BAND = 1e-3
LATENT_BAND = 1e-5


@functools.cache
def models():
    """(JAX params, the port's CTCLIP with the same weights)."""
    params = jclip.init_ctclip(jax.random.PRNGKey(0), SMALL_CLIP)
    return params, convert.from_jax_params(jax.tree.map(np.asarray, params),
                                           port_config(SMALL_CLIP), device="cpu")


def volume(depth: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((1, 1, depth, 32, 32)).astype(np.float32)


def prompts(seed: int = 0):
    ids = np.random.RandomState(seed).randint(0, 64, (1, 8))
    mask = np.ones_like(ids)
    return ({"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)},
            {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask)})


def occ_pair(**kw):
    return jconfig.OcclusionConfig(**kw), pconfig.OcclusionConfig(**kw)


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# rollout and raw attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fusion,discard,residual", [("mean", 0.0, True), ("max", 0.0, True),
                                                     ("mean", 0.9, True), ("max", 0.9, False),
                                                     ("mean", 0.0, False)])
def test_rollout_matrix_matches_jax(fusion, discard, residual):
    """Both head fusions, discard_ratio (k = int(36 * 0.1) = 3 per row) and
    the residual; the batched call equals the slices one by one."""
    layers = np.abs(np.random.default_rng(3).random((5, 3, 4, 6, 6))).astype(np.float32)
    got = rollout.rollout_matrix(torch.from_numpy(layers), fusion, discard, residual).numpy()
    for i in range(layers.shape[0]):
        want = jroll.rollout_matrix(jnp.asarray(layers[i]), head_fusion=fusion,
                                    discard_ratio=discard, use_residual=residual)
        close(got[i], want, 1e-5)
    with pytest.raises(ValueError, match="head_fusion"):
        rollout.rollout_matrix(torch.from_numpy(layers), "min")


def test_rollout_volumes_and_maps_match_jax():
    params, model = models()
    jt, tt = prompts()
    img = volume(20, 1)
    sp, tm = rollout.rollout_volumes(model, tt, torch.from_numpy(img))
    jsp, jtm = jroll.rollout_volumes(params, SMALL_CLIP, jt, jnp.asarray(img))
    assert sp.shape == (2 * 2, 4, 4) and tm.shape == (2, 4, 4)
    close(sp, jsp, 2e-5)
    close(tm, jtm, 2e-5)
    maps = rollout.rollout_maps(model, tt, torch.from_numpy(img))
    jmaps = jroll.rollout_maps(params, SMALL_CLIP, jt, jnp.asarray(img))
    for got, want in zip(maps, jmaps):
        assert got.shape == (20, 32, 32)
        close(got, want, MAP_BAND)
    img2 = volume(20, 2)
    items = [(tt, torch.from_numpy(img)), (tt, torch.from_numpy(img2))]
    piped = list(rollout.rollout_maps_pipelined(model, items))
    assert len(piped) == 2
    for (got_sp, got_tm), (_, im) in zip(piped, items):
        want_sp, want_tm = rollout.rollout_maps(model, tt, im)
        np.testing.assert_array_equal(got_sp, want_sp)
        np.testing.assert_array_equal(got_tm, want_tm)


def test_raw_attention_maps_match_jax():
    params, model = models()
    jt, tt = prompts()
    img = volume(20, 1)
    sp, tm = raw_attention.raw_attention_maps(model, tt, torch.from_numpy(img))
    jsp, jtm = jraw.raw_attention_maps(params, SMALL_CLIP, jt, jnp.asarray(img))
    assert sp.shape == (2, 4, 2, 4, 4) and tm.shape == (2, 4, 2, 4, 4)
    close(sp, jsp, 2e-5)
    close(tm, jtm, 2e-5)
    nsp, ntm = raw_attention.raw_attention_maps_np(model, tt, torch.from_numpy(img))
    jnsp, jntm = jraw.raw_attention_maps_np(params, SMALL_CLIP, jt, jnp.asarray(img))
    assert nsp.shape == jnsp.shape and ntm.shape == jntm.shape
    close(nsp, jnsp, MAP_BAND)
    close(ntm, jntm, MAP_BAND)


def test_score_and_weights_match_jax():
    params, model = models()
    jt, tt = prompts()
    img = volume(20, 1)
    score, spatial, temporal = capture.score_and_weights(model, tt, torch.from_numpy(img))
    jscore, jspatial, jtemporal = jcap.score_and_weights(params, SMALL_CLIP, jt,
                                                         jnp.asarray(img))
    close(score, jscore, LATENT_BAND)
    for got, want in zip(spatial + temporal, jspatial + jtemporal):
        close(got, want, 2e-5)


# ---------------------------------------------------------------------------
# the entry points the methods call
# ---------------------------------------------------------------------------

def test_latents_from_tokens_and_spatial_out_match_jax():
    params, model = models()
    img = volume(20, 4)
    pcfg = jcap.parity_cfg(SMALL_CLIP)
    vp = params["visual_transformer"]
    tokens = jvit._patch_embed(vp["to_patch_emb"], jvit.patchify(jnp.asarray(img), 8, 10))
    want, _ = jclip.encode_image_latents_from_tokens(params, pcfg, tokens)
    got, out = tclip.encode_image_latents_from_tokens(model, torch.from_numpy(np.array(tokens)))
    close(got.detach(), want, LATENT_BAND)
    assert out.tokens.shape == (1, 2, 4, 4, 16)
    sp_out = np.random.default_rng(5).standard_normal((2, 2, 4, 4, 16)).astype(np.float32)
    want = jclip.encode_image_latents_from_spatial_out(params, pcfg, jnp.asarray(sp_out))
    got = tclip.encode_image_latents_from_spatial_out(model, torch.from_numpy(sp_out))
    assert got.shape == (2, 8)
    close(got.detach(), want, LATENT_BAND)


def test_text_embeds_bypass_and_diff_latent_match_jax():
    params, model = models()
    embeds = np.random.default_rng(7).standard_normal((2, 32)).astype(np.float32)
    img = volume(20, 1)
    want = jclip.ctclip_apply(params, jcap.parity_cfg(SMALL_CLIP), None, jnp.asarray(img),
                              text_embeds=jnp.asarray(embeds))
    pmodel_cfg = port_config(jcap.parity_cfg(SMALL_CLIP))
    pmodel = convert.from_jax_params(jax.tree.map(np.asarray, params), pmodel_cfg, device="cpu")
    with torch.no_grad():
        got = tclip.ctclip_apply(pmodel, None, torch.from_numpy(img),
                                 text_embeds=torch.from_numpy(embeds))
    close(got.text_latents, want.text_latents, LATENT_BAND)
    close(got.sim_matrix, want.sim_matrix, LATENT_BAND)
    lat = occlusion.diff_embedding_latent(model, torch.from_numpy(embeds[0]))
    close(lat, jocc.diff_embedding_latent(params, SMALL_CLIP, jnp.asarray(embeds[0])), 1e-6)
    score, _ = capture.similarity_score(model, None, torch.from_numpy(img),
                                        torch.from_numpy(embeds[:1]))
    jscore, _ = jcap.similarity_score(params, SMALL_CLIP, None, jnp.asarray(img),
                                      text_embeds=jnp.asarray(embeds[:1]))
    close(score, jscore, LATENT_BAND)


# ---------------------------------------------------------------------------
# occlusion
# ---------------------------------------------------------------------------

# (depth, window, stride): the suite's geometry, 6 token frames (slices
# clamped at both volume edges), an unaligned temporal stride
GEOMETRIES = {"20 frames": (20, (10, 16, 16), (5, 8, 8)),
              "60 frames": (60, (10, 16, 16), (10, 8, 8)),
              "unaligned": (50, (10, 16, 16), (5, 16, 16))}
MODES = {"frame-sparse": (True, True), "dense shortcut": (True, False),
         "full forward": (False, False)}


@pytest.mark.parametrize("geometry,mode", [(g, m) for g in GEOMETRIES for m in MODES
                                           if m != "full forward" or g == "20 frames"])
def test_occlusion_scores_match_jax(geometry, mode):
    params, model = models()
    jt, tt = prompts()
    depth, patch, stride = GEOMETRIES[geometry]
    token_shortcut, frame_sparse = MODES[mode]
    img = volume(depth, 9)
    jo, po = occ_pair(patch_size=patch, stride=stride, threshold=0.0)
    coords = jocc.window_grid(img.shape[-3:], patch, stride)
    pcoords = occlusion.window_grid(img.shape[-3:], patch, stride)
    np.testing.assert_array_equal(pcoords, np.asarray(coords))
    jl = jocc.report_text_latent(params, SMALL_CLIP, jt)
    tl = occlusion.report_text_latent(model, tt)
    close(tl, jl, LATENT_BAND)
    want_o, want = jocc.occlusion_scores(params, SMALL_CLIP, jnp.asarray(img), jl, coords,
                                         occ=jo, chunk=4, token_shortcut=token_shortcut,
                                         frame_sparse=frame_sparse)
    got_o, got = occlusion.occlusion_scores(model, torch.from_numpy(img), tl, pcoords, occ=po,
                                            chunk=4, token_shortcut=token_shortcut,
                                            frame_sparse=frame_sparse)
    assert got.shape == (coords.shape[0],)
    close(got_o, want_o, LATENT_BAND)
    close(got, want, LATENT_BAND)


def test_occlusion_heatmap_matches_jax():
    params, model = models()
    jt, tt = prompts()
    img = volume(20, 1)
    jo, po = occ_pair(patch_size=(10, 16, 16), stride=(5, 8, 8), threshold=0.0)
    want = jocc.occlusion_heatmap(params, SMALL_CLIP, jnp.asarray(img),
                                  jocc.report_text_latent(params, SMALL_CLIP, jt), occ=jo,
                                  chunk=4)
    got = occlusion.occlusion_heatmap(model, torch.from_numpy(img),
                                      occlusion.report_text_latent(model, tt), occ=po, chunk=4)
    assert got.shape == (20, 32, 32) and got.dtype == np.float32
    close(got, want, LATENT_BAND)
    # the window-sharded sweep (tests/test_torch_port_parallel.py) takes a
    # DataMesh; one rank is the single-process sweep
    from ct_clip_ut_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(TypeError, match="DataMesh"):
        occlusion.occlusion_heatmap(model, torch.from_numpy(img),
                                    occlusion.report_text_latent(model, tt), occ=po,
                                    mesh=object())
    one = occlusion.occlusion_heatmap(model, torch.from_numpy(img),
                                      occlusion.report_text_latent(model, tt), occ=po, chunk=4,
                                      mesh=make_mesh(device="cpu"))
    np.testing.assert_array_equal(one, got)


def test_occlusion_heatmaps_multi_match_singles_and_jax():
    params, model = models()
    jt, tt = prompts()
    img = volume(20, 1)
    jo, po = occ_pair(patch_size=(10, 16, 16), stride=(10, 16, 16))
    embed = np.random.default_rng(3).standard_normal((32,)).astype(np.float32)
    tl = torch.stack([occlusion.report_text_latent(model, tt),
                      occlusion.diff_embedding_latent(model, torch.from_numpy(embed))])
    jl = jnp.stack([jocc.report_text_latent(params, SMALL_CLIP, jt),
                    jocc.diff_embedding_latent(params, SMALL_CLIP, jnp.asarray(embed))])
    multi = occlusion.occlusion_heatmaps_multi(model, torch.from_numpy(img), tl, occ=po, chunk=4)
    jmulti = jocc.occlusion_heatmaps_multi(params, SMALL_CLIP, jnp.asarray(img), jl, occ=jo,
                                           chunk=4)
    for k in range(2):
        single = occlusion.occlusion_heatmap(model, torch.from_numpy(img), tl[k], occ=po,
                                             chunk=4)
        close(multi[k], single, 1e-6)
        close(multi[k], jmulti[k], LATENT_BAND)


def test_occlusion_slabbed_ragged_tail_matches_one_sweep_and_jax():
    params, model = models()
    jt, tt = prompts()
    img = volume(20, 1)
    jo, po = occ_pair(patch_size=(10, 16, 16), stride=(5, 8, 8), threshold=0.0)
    coords = occlusion.window_grid(img.shape[-3:], po.patch_size, po.stride)
    assert coords.shape[0] > 13 and coords.shape[0] % 13
    tl = occlusion.report_text_latent(model, tt)[None]
    o_ref, s_ref = occlusion.occlusion_scores_multi(model, torch.from_numpy(img), tl, coords,
                                                    occ=po, chunk=4)
    o_slab, s_slab = occlusion.occlusion_scores_slabbed(model, torch.from_numpy(img), tl,
                                                        coords, occ=po, chunk=4, slab=13)
    assert s_slab.dtype == np.float64 and s_slab.shape == (coords.shape[0], 1)
    close(o_slab, o_ref, 1e-6)
    close(s_slab, s_ref, 1e-6)
    jl = jocc.report_text_latent(params, SMALL_CLIP, jt)[None]
    jo_slab, js_slab = jocc.occlusion_scores_slabbed(params, SMALL_CLIP, jnp.asarray(img), jl,
                                                     jnp.asarray(coords), occ=jo, chunk=4,
                                                     slab=13)
    close(o_slab, jo_slab, LATENT_BAND)
    close(s_slab, js_slab, LATENT_BAND)


@pytest.mark.parametrize("vol,patch,stride", [((240, 480, 480), (20, 40, 40), (10, 20, 20)),
                                              ((50, 32, 32), (10, 16, 16), (5, 16, 16)),
                                              ((20, 32, 32), (10, 16, 16), (3, 7, 5))])
def test_occlusion_geometry_and_host_assembly_match_jax(vol, patch, stride):
    """window_grid, the patch-block geometry, and the separable host
    assembly of a heatmap from random window scores."""
    np.testing.assert_array_equal(occlusion.window_grid(vol, patch, stride),
                                  np.asarray(jocc.window_grid(vol, patch, stride)))
    for q in ((10, 20, 20), (10, 8, 8)):
        assert occlusion._patch_block_geometry(vol, q, patch, stride) == \
            jocc._patch_block_geometry(vol, q, patch, stride)
    grid = tuple((n - p) // s + 1 for n, p, s in zip(vol, patch, stride))
    if np.prod(grid) > 20000 or np.prod(vol) > 1e6:
        vol, grid = (60, 64, 64), tuple((n - p) // s + 1 for n, p, s in
                                        zip((60, 64, 64), patch, stride))
    values = np.random.default_rng(2).random(int(np.prod(grid))).astype(np.float32)
    got = occlusion._window_sum_to_voxels(values, grid, vol, patch, stride)
    want = jocc._window_sum_to_voxels(values, grid, vol, patch, stride)
    close(got, want, 1e-5)
    occlusion._divide_axis_counts(got, grid, vol, patch, stride)
    jocc._divide_axis_counts(want, grid, vol, patch, stride)
    close(got, want, 1e-6)


def test_occlusion_config_mirrors_jax():
    assert dataclasses.asdict(pconfig.OcclusionConfig()) == \
        dataclasses.asdict(jconfig.OcclusionConfig())


# ---------------------------------------------------------------------------
# post-processing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,target", [((4, 4, 4), (20, 32, 32)), ((2, 3, 5), (7, 9, 16)),
                                        ((24, 24, 24), (240, 96, 48))])
def test_upsample_matches_jax_resize(src, target):
    v = np.random.default_rng(11).standard_normal(src).astype(np.float32)
    want = np.asarray(jcap.upsample_to(jnp.asarray(v), target))
    close(capture.upsample_to(torch.from_numpy(v), target), want, 1e-5)
    close(capture.upsample_to_host(v, target), want, 1e-5)
    close(capture._lin_matrix(src[0], target[0]), jcap._lin_matrix(src[0], target[0]), 0)


def test_normalisations_and_rot90_match_jax():
    v = np.random.default_rng(12).standard_normal((3, 4, 5, 6)).astype(np.float32)
    close(capture.minmax(torch.from_numpy(v)), jcap.minmax(jnp.asarray(v)), 1e-6)
    close(capture.shiftmax(torch.from_numpy(v)), jcap.shiftmax(jnp.asarray(v)), 1e-6)
    batched = capture.shiftmax(torch.from_numpy(v), batched=True)
    for i in range(3):
        close(batched[i], jcap.shiftmax(jnp.asarray(v[i])), 1e-6)
    np.testing.assert_array_equal(capture.rot90_ct(v[0]), jcap.rot90_ct(v[0]))
    assert capture.parity_cfg(port_config(SMALL_CLIP)).ctvit.patch_embed_conv is False


def test_entry_points_run_in_full_fp32_and_restore_the_flags():
    """The attribution entry points turn TF32 off for their convs and
    matmuls (cuDNN's default runs fp32 convs in TF32) and restore the
    caller's flags."""
    seen = []
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    @capture.forward_only
    def probe():
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                     torch.is_grad_enabled()))

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        probe()
        assert seen == [(False, False, False)]
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
