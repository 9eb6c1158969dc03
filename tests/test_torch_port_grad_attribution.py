"""The port's gradient attribution methods (Grad-CAM, integrated gradients)
and what they stand on (the tap contract, the prepatchified entry,
`unpatchify_np`, the IG transport) against the JAX package's, on the CPU.

SMALL_CLIP of tests/test_attribution.py (CT-ViT dim 16, 2 + 2 layers of 4
heads of 4, 32 codes, a [1, 1, 20, 32, 32] volume, 8-token prompts), the
JAX weights carried into the port by convert.from_jax_params, inputs from
numpy seeds, the JAX functions jitted. Bands: scores 1e-5; captures 1e-5
(attention weights 2e-5) and gradients 1e-4 of their largest value; maps
1e-3 (the saliency band).
Integrated gradients is judged as a threshold demands: the map before the
0.90 quantile within the band; the final map within it on every element
that did not cross the threshold, and each crossing within 1e-5 (of the
map's maximum) of the threshold, where rounding puts it on either side.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.attribution import capture as jcap
from ct_clip_ut_tpu.attribution import grad_cam as jgc
from ct_clip_ut_tpu.attribution import integrated_gradients as jig
from ct_clip_ut_tpu.models import ctvit as jvit
from ct_clip_ut_tpu.ops.taps import Taps as JTaps
from ct_clip_ut_tpu_torch.attribution import capture, grad_cam
from ct_clip_ut_tpu_torch.attribution import integrated_gradients as ig
from ct_clip_ut_tpu_torch.models import ctclip as tclip
from ct_clip_ut_tpu_torch.models import ctvit as tvit
from ct_clip_ut_tpu_torch.ops.taps import Taps

from test_torch_port_attribution import MAP_BAND, SMALL_CLIP, close, models, prompts, volume

SCORE_BAND = 1e-5
WEIGHTS_BAND = 2e-5  # attention weights, as tests/test_torch_port_attribution.py holds them
GRAD_BAND = 1e-4     # of the gradient's largest value
CROSS_BAND = 1e-5    # a threshold crossing's distance from the threshold, of the map's max
GRAD_CAM_TAPS = sorted({f"{s}.{i}.{p}" for s in ("spatial", "temporal") for i in (0, 1)
                        for p in ("attn_out", "ff_out")} | {"vq.features"})
ALL_TAPS = GRAD_CAM_TAPS + ["spatial.0.attn_weights", "temporal.1.attn_weights", "vq.input"]


def inputs(seed=1):
    jt, tt = prompts()
    img = volume(20, seed)
    return jt, tt, img


@functools.partial(jax.jit, static_argnames=("names", "prepatchified"))
def jax_captures(params, tokens, image, names=(), inject=None, prepatchified=False):
    """The JAX scored forward with its taps, jitted: (score, captures)."""
    taps = JTaps(capture=set(names), inject=inject)
    score, _ = jcap.similarity_score(params, SMALL_CLIP, tokens, image, taps=taps,
                                     prepatchified=prepatchified)
    return score, taps.collected


@functools.partial(jax.jit, static_argnames=("names",))
def jax_captures_and_grads(params, tokens, image, names):
    return jcap.score_captures_and_grads(params, SMALL_CLIP, tokens, image, list(names))


def rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the tap contract and the patch-space entry
# ---------------------------------------------------------------------------

def test_tap_shapes_match_jax():
    params, _ = models()
    jt, _, img = inputs()
    want = jcap.tap_shapes(params, SMALL_CLIP, jt, jnp.asarray(img), ALL_TAPS)
    got = capture.tap_shapes(models()[1].cfg, img.shape, ALL_TAPS)
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    for bad in ("spatial.2.attn_out", "temporal.0.cross_attn_out", "vq.codes"):
        with pytest.raises(KeyError):
            capture.tap_shapes(models()[1].cfg, img.shape, [bad])


def test_tapped_forward_equals_the_fused_one():
    """Capturing every block output (each block then unfused: its kernel
    without the residual, the residual added after the tap) leaves the
    score and latents within 1e-6 of the untapped forward; the captures
    equal the JAX package's."""
    params, model = models()
    jt, tt, img = inputs()
    score, out = capture.similarity_score(model, tt, torch.from_numpy(img))
    taps = Taps(capture=set(ALL_TAPS))
    tscore, tout = capture.similarity_score(model, tt, torch.from_numpy(img), taps=taps)
    close(tscore, score, 1e-6)
    close(tout.image_latents, out.image_latents, 1e-6)
    assert set(taps.collected) == set(ALL_TAPS)
    _, jcollected = jax_captures(params, jt, jnp.asarray(img), tuple(ALL_TAPS))
    for k in ALL_TAPS:
        band = WEIGHTS_BAND if k.endswith("attn_weights") else SCORE_BAND
        assert rel_to_max(taps.collected[k], jcollected[k]) <= band, k


def test_a_nonzero_injection_moves_the_score_as_jax_does():
    params, model = models()
    jt, tt, img = inputs()
    shapes = capture.tap_shapes(model.cfg, img.shape, GRAD_CAM_TAPS)
    rng = np.random.default_rng(5)
    inject = {k: (0.05 * rng.standard_normal(shapes[k])).astype(np.float32)
              for k in ("spatial.1.ff_out", "temporal.0.attn_out", "vq.features")}
    score, _ = capture.similarity_score(model, tt, torch.from_numpy(img))
    moved, _ = capture.similarity_score(
        model, tt, torch.from_numpy(img),
        taps=Taps(inject={k: torch.from_numpy(v) for k, v in inject.items()}))
    want, _ = jax_captures(params, jt, jnp.asarray(img), (),
                           {k: jnp.asarray(v) for k, v in inject.items()})
    close(moved, want, SCORE_BAND)
    assert abs(float(moved) - float(score)) > 100 * SCORE_BAND


def test_the_prepatchified_entry_matches():
    """A [1, t, h, w, patch_dim] patch tensor through ctclip_apply equals the
    volume through the matmul embed and the JAX prepatchified entry, 1e-5;
    the ctgenerate model type refuses it."""
    params, model = models()
    jt, tt, img = inputs()
    vit = model.cfg.ctvit
    patches = tvit.patchify(torch.from_numpy(img), vit.patch_size, vit.temporal_patch_size)
    with torch.no_grad():
        got = tclip.ctclip_apply(model, tt, patches, prepatchified=True)
    score, _ = capture.similarity_score(model, tt, torch.from_numpy(img))
    close(got.sim_matrix[0, 0], score, SCORE_BAND)
    jscore, _ = jax_captures(params, jt, jnp.asarray(patches.numpy()), prepatchified=True)
    close(got.sim_matrix[0, 0], jscore, SCORE_BAND)
    gen = dataclasses.replace(vit, model_type="ctgenerate")
    with pytest.raises(AssertionError, match="prepatchified"):
        tvit.ctvit_apply(tvit.CTViT(gen), patches, prepatchified=True)


@pytest.mark.parametrize("channels,t_patch", [(1, 10), (2, 4)])
def test_unpatchify_np_inverts_patchify(channels, t_patch):
    img = np.random.default_rng(3).standard_normal((1, channels, 20, 32, 32)).astype(np.float32)
    patches = tvit.patchify(torch.from_numpy(img), 8, t_patch)[0].numpy()
    got = tvit.unpatchify_np(patches, 8, t_patch, channels)
    want = img[0, 0] if channels == 1 else img[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jvit.unpatchify_np(patches, 8, t_patch, channels))


# ---------------------------------------------------------------------------
# score_captures_and_grads and Grad-CAM
# ---------------------------------------------------------------------------

def test_score_captures_and_grads_match_jax():
    params, model = models()
    jt, tt, img = inputs()
    tf32 = torch.backends.cudnn.allow_tf32
    flags = [p.requires_grad for p in model.parameters()]
    score, feats, grads = capture.score_captures_and_grads(model, tt, torch.from_numpy(img),
                                                           ALL_TAPS)
    assert [p.requires_grad for p in model.parameters()] == flags    # frozen, then restored
    assert torch.backends.cudnn.allow_tf32 == tf32
    jscore, jfeats, jgrads = jax_captures_and_grads(params, jt, jnp.asarray(img),
                                                    tuple(ALL_TAPS))
    close(score, jscore, SCORE_BAND)
    assert set(feats) == set(grads) == set(ALL_TAPS)
    for k in ALL_TAPS:
        assert feats[k].dtype == grads[k].dtype == torch.float32
        band = WEIGHTS_BAND if k.endswith("attn_weights") else SCORE_BAND
        assert rel_to_max(feats[k], jfeats[k]) <= band, k
        if k.endswith("attn_weights"):     # nothing downstream reads them: zero, as JAX's
            assert not grads[k].any() and not np.asarray(jgrads[k]).any()
        else:
            assert rel_to_max(grads[k], jgrads[k]) <= GRAD_BAND, k


@pytest.mark.parametrize("pairing", ["reference", "aligned"])
def test_grad_cam_volumes_and_maps_match_jax(pairing):
    params, model = models()
    jt, tt, img = inputs()
    got = grad_cam.grad_cam_volumes(model, tt, torch.from_numpy(img), pairing=pairing)
    want = jgc.grad_cam_volumes(params, SMALL_CLIP, jt, jnp.asarray(img), pairing=pairing)
    assert set(got) == set(want) == {"spatial", "temporal", "spatial_ff", "temporal_ff",
                                     "combined", "vq"}
    for k in got:
        assert got[k].shape == (2, 4, 4)
        close(got[k], want[k], MAP_BAND)
    maps = grad_cam.grad_cam_maps(model, tt, torch.from_numpy(img), pairing=pairing)
    jmaps = jgc.grad_cam_maps(params, SMALL_CLIP, jt, jnp.asarray(img), pairing=pairing)
    for k in maps:
        assert maps[k].shape == (20, 32, 32)
        close(maps[k], jmaps[k], MAP_BAND)
    if pairing == "aligned":
        ref = grad_cam.grad_cam_volumes(model, tt, torch.from_numpy(img))
        assert not torch.allclose(ref["spatial"], got["spatial"], atol=MAP_BAND)
    with pytest.raises(ValueError, match="pairing"):
        grad_cam.grad_cam_volumes(model, tt, torch.from_numpy(img), pairing="forward")


# ---------------------------------------------------------------------------
# integrated gradients
# ---------------------------------------------------------------------------

def ig_pair(img, jt, tt, **kw):
    """(port, JAX) patch-space maps of _ig_patch_space."""
    params, model = models()
    got = ig._ig_patch_space(model, tt, torch.from_numpy(img), **kw).numpy()
    want = np.asarray(jig._ig_patch_space(params, SMALL_CLIP, jt, jnp.asarray(img), None,
                                          1.0, kw["steps"], kw["chunk"], kw["quantile"],
                                          kw["contrast"]))
    return got, want


def test_integrated_gradients_match_jax():
    """Steps 6 in chunks of 4 (a ragged last chunk of 2). Before the
    threshold (quantile 0, contrast 1: relu(diff avg_grads) normalised)
    within the band; after it, every element that kept its side of the
    threshold within the band and each crossing a tie; the public entry
    (transport and unpatchify included) against JAX's the same way."""
    jt, tt, img = inputs()
    pre, jpre = ig_pair(img, jt, tt, steps=6, chunk=4, quantile=0.0, contrast=1.0)
    close(pre, jpre, MAP_BAND)
    got, want = ig_pair(img, jt, tt, steps=6, chunk=4, quantile=0.90, contrast=0.05)
    threshold = np.quantile(pre, 0.90)
    crossed = (got > 0) != (want > 0)
    close(got[~crossed], want[~crossed], MAP_BAND)
    assert crossed.mean() < 1e-3
    assert np.all(np.abs(pre[crossed] - threshold) <= CROSS_BAND)
    assert (got > 0).mean() == pytest.approx(0.10, abs=0.01)

    params, model = models()
    vol = ig.integrated_gradients(model, tt, torch.from_numpy(img), steps=6, chunk=4)
    jvol = jig.integrated_gradients(params, SMALL_CLIP, jt, jnp.asarray(img), steps=6, chunk=4)
    assert vol.shape == (20, 32, 32)
    vcross = (vol > 0) != (jvol > 0)
    assert vcross.sum() == crossed.sum()
    close(vol[~vcross], jvol[~vcross], MAP_BAND)


def test_the_batched_chunk_equals_a_loop_over_alphas():
    """The gradient of sim[:, 0].sum() over a batch of interpolated patch
    tensors is each one's own gradient of its score (1e-6 of their max)."""
    _, model = models()
    _, tt, img = inputs()
    vit = model.cfg.ctvit
    patches = tvit.patchify(torch.from_numpy(img), vit.patch_size, vit.temporal_patch_size)
    alphas = torch.tensor([0.0, 0.3, 0.7, 1.0]).reshape(-1, 1, 1, 1, 1)
    _, cls = ig._hoist_text_tower(model, tt, None)
    with torch.enable_grad(), capture.frozen(model):
        batch = (1.0 + alphas * (patches - 1.0)).requires_grad_(True)
        _, out = capture.scored_forward(model, None, batch, cls, prepatchified=True)
        (got,) = torch.autograd.grad(out.sim_matrix[:, 0].sum(), batch)
        for i in range(batch.shape[0]):
            one = batch[i:i + 1].detach().requires_grad_(True)
            s, _ = capture.scored_forward(model, None, one, cls, prepatchified=True)
            (want,) = torch.autograd.grad(s, one)
            assert rel_to_max(got[i:i + 1], want) <= 1e-6


def test_the_quantile_matches_numpy_past_2_24_elements():
    """torch.quantile refuses more than 2^24 elements (the flagship map has
    55,296,000); the sort-based quantile equals np.quantile's linear
    interpolation there and at small sizes."""
    x = torch.from_numpy(np.random.default_rng(7).random(2 ** 24 + 1001, dtype=np.float32))
    np.testing.assert_allclose(ig._quantile(x, 0.9), np.quantile(x.numpy(), 0.9), rtol=1e-6)
    small = torch.tensor([3.0, 1.0, 2.0, 10.0])
    for q in (0.0, 0.9, 1.0):
        np.testing.assert_allclose(ig._quantile(small, q), np.quantile(small.numpy(), q),
                                   rtol=1e-6)


def test_ig_pack_roundtrip_and_overflow_fallback():
    """_ig_pack's bitmask is np.packbits of the nonzeros, its values their
    f16 roundings in flat order; _ig_densify_np rebuilds the map (f16
    values), and with the survivors over the buffer falls back to the
    dense map; both against the JAX package's decode."""
    t, h, w, pd = 2, 4, 4, 10 * 8 * 8
    rng = np.random.RandomState(0)
    dense = rng.rand(t, h, w, pd).astype(np.float32)
    dense[dense < 0.9] = 0.0
    shape = (1, 1, t * 10, h * 8, w * 8)
    cfg = models()[1].cfg
    k = int(dense.size * 0.15)
    packed, vals, m = ig._ig_pack(torch.from_numpy(dense), k)
    np.testing.assert_array_equal(packed.numpy(), np.packbits(dense.reshape(-1) > 0))
    assert int(m) == int((dense > 0).sum()) <= k
    got = ig._ig_densify_np(cfg, shape, packed.numpy(), vals.numpy(), int(m),
                            torch.from_numpy(dense))
    want = tvit.unpatchify_np(dense.astype(np.float16).astype(np.float32), 8, 10)
    np.testing.assert_array_equal(got, want)
    jpacked, jvals, jm = jig._ig_pack(jnp.asarray(dense), k)
    np.testing.assert_array_equal(got, jig._ig_densify_np(SMALL_CLIP, shape, jpacked, jvals, jm,
                                                          jnp.asarray(dense)))
    small = int(m) - 3
    packed, vals, m = ig._ig_pack(torch.from_numpy(dense), small)
    assert int(m) > small
    got = ig._ig_densify_np(cfg, shape, packed.numpy(), vals.numpy(), int(m),
                            torch.from_numpy(dense))
    np.testing.assert_array_equal(got, tvit.unpatchify_np(dense, 8, 10))
    assert ig._ig_transport_k(cfg, shape, 0.9) == jig._ig_transport_k(SMALL_CLIP, shape, 0.9)


def test_ig_pipelined_equals_serial_calls_and_sharded_raises():
    _, model = models()
    _, tt, img = inputs()
    imgs = [torch.from_numpy(img), torch.from_numpy(img * 0.5 + 0.1)]
    want = [ig.integrated_gradients(model, tt, im, steps=4, chunk=2) for im in imgs]
    got = list(ig.integrated_gradients_pipelined(model, [(tt, im) for im in imgs], steps=4,
                                                 chunk=2))
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    from ct_clip_ut_tpu_torch.parallel.mesh import DataMesh
    with pytest.raises(TypeError, match="DataMesh"):
        ig.integrated_gradients_sharded(model, tt, imgs[0], mesh=None)
    with pytest.raises(ValueError, match="the mesh on meta"):
        ig.integrated_gradients_sharded(model, tt, imgs[0], DataMesh(1, 0, torch.device("meta")))
