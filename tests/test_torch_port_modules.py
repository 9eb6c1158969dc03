"""The port's slice modules against their JAX twins, on the CPU, at fp32
with atol 1e-5 and shared weights (JAX init -> convert.from_jax_params).

Small geometry of tests/test_torch_reference_parity.py: [2, 1, 20, 32, 32]
volumes -> 2 frames x 4 x 4 patches, dim 16, 4 heads of 4, 2 + 2 layers,
32 codes, with the plain patch embed (patch_embed_conv=False); the conv
embed (the default, patch_embed_conv=True) on the same weights. The BERT
layers that the card sends through bert_layer: 128 tokens, hidden 128 in
2 heads of 64.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_ut_tpu import config as jconfig
from ct_clip_ut_tpu.config import AttentionConfig, BertConfig, CTCLIPConfig, CTViTConfig
from ct_clip_ut_tpu.models import bert as jbert
from ct_clip_ut_tpu.models import ctvit as jctvit
from ct_clip_ut_tpu.models.ctclip import init_ctclip as jax_init_ctclip
from ct_clip_ut_tpu.ops import attention as jattn
from ct_clip_ut_tpu.ops import layers as jlayers
from ct_clip_ut_tpu.ops import posbias as jposbias
from ct_clip_ut_tpu.ops import transformer as jtransformer
from ct_clip_ut_tpu.ops import vq as jvq
from ct_clip_ut_tpu_torch import config as pconfig
from ct_clip_ut_tpu_torch import convert
from ct_clip_ut_tpu_torch.models import bert as tbert
from ct_clip_ut_tpu_torch.models import ctvit as tctvit
from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
from ct_clip_ut_tpu_torch.ops import attention as tattn
from ct_clip_ut_tpu_torch.ops import layers as tlayers
from ct_clip_ut_tpu_torch.ops import posbias as tposbias
from ct_clip_ut_tpu_torch.ops import vq as tvq
from ct_clip_ut_tpu_torch.ops.transformer import Transformer, transformer

ATOL = 1e-5
T_PATCH, PATCH, IMG, DEPTH = 10, 8, 32, 20
GT, GH, GW = 2, 4, 4
DIM, HEADS, DIM_HEAD = 16, 4, 4

SMALL_BERT = BertConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
                        intermediate_size=64, max_position_embeddings=16)
SMALL_VIT = CTViTConfig(dim=DIM, codebook_size=32, image_size=IMG, patch_size=PATCH,
                        temporal_patch_size=T_PATCH, spatial_depth=2, temporal_depth=2,
                        dim_head=DIM_HEAD, heads=HEADS, patch_embed_conv=False)
SMALL_CLIP = CTCLIPConfig(dim_text=32, dim_image=GH * GW * DIM, dim_latent=8,
                          ctvit=SMALL_VIT, bert=SMALL_BERT)


def port_config(jcfg):
    """The port's config class of the same name holding the same fields."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw = {k: port_config(v) if dataclasses.is_dataclass(v) else v for k, v in kw.items()}
    return getattr(pconfig, type(jcfg).__name__)(**kw)


PORT_CLIP = port_config(SMALL_CLIP)
PORT_VIT = PORT_CLIP.ctvit


@functools.cache
def jax_and_port_models():
    """(JAX params, the port's CTCLIP holding the same weights), built once
    per process; no test mutates either."""
    params = jax_init_ctclip(jax.random.PRNGKey(0), SMALL_CLIP)
    return params, convert.from_jax_params(jax.tree.map(np.asarray, params), PORT_CLIP,
                                           device="cpu")


@pytest.fixture
def shared():
    return jax_and_port_models()


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["AttentionConfig", "TransformerConfig", "CTViTConfig",
                                  "BertConfig", "CTCLIPConfig", "TrainConfig", "T5EncoderConfig",
                                  "MaskGitConfig", "CTGenerateConfig", "MeshConfig"])
def test_config_mirrors_the_jax_dataclasses(name):
    j, p = getattr(jconfig, name)(), getattr(pconfig, name)()
    assert [f.name for f in dataclasses.fields(p)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    derived = {"AttentionConfig": ["inner_dim", "context_dim"],
               "TransformerConfig": ["ff_inner_dim", "self_attn", "cross_attn"],
               "CTViTConfig": ["patch_height", "patch_width", "patch_dim", "first_frame_patch_dim",
                               "spatial_transformer", "temporal_transformer"],
               "MaskGitConfig": ["transformer"]}.get(name, [])
    for attr in derived:
        pv, jv = getattr(p, attr), getattr(j, attr)
        pv, jv = (pv(), jv()) if callable(pv) else (pv, jv)
        assert (dataclasses.asdict(pv) if dataclasses.is_dataclass(pv) else pv) == \
            (dataclasses.asdict(jv) if dataclasses.is_dataclass(jv) else jv)
    assert pconfig.PATHOLOGIES == jconfig.PATHOLOGIES


def test_flagship_cfg_is_the_bench_flagship_with_the_plain_patch_embed():
    """The flagship is bench.py's at the JAX default, the conv patch embed;
    the plain embed is one `replace` away."""
    want = CTCLIPConfig(dim_text=768, dim_image=294912, dim_latent=512,
                        ctvit=CTViTConfig(dim=512, codebook_size=8192, image_size=480,
                                          patch_size=20, temporal_patch_size=10,
                                          spatial_depth=4, temporal_depth=4, dim_head=32,
                                          heads=8),
                        bert=BertConfig())
    got = pconfig.flagship_cfg()
    assert got.ctvit.patch_embed_conv and want.ctvit.patch_embed_conv
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    plain = pconfig.replace(got.ctvit, patch_embed_conv=False)
    assert dataclasses.asdict(plain) == dataclasses.asdict(
        dataclasses.replace(want.ctvit, patch_embed_conv=False))


def test_convert_carries_every_weight(shared):
    params, model = shared
    jleaves = sum(int(np.asarray(x).size) for x in jax.tree.leaves(params))
    frozen_betas = sum(m.beta.numel() for m in model.modules()
                       if isinstance(m, tlayers.FrozenBiasLayerNorm))
    ported = sum(t.numel() for t in model.state_dict().values())
    assert ported == jleaves + frozen_betas


def test_linear(shared):
    params, model = shared
    x = _rand((3, 5, 32))
    want = jlayers.linear(params["text_transformer"]["layers"][0]["ffn_in"], jnp.asarray(x))
    lin = model.text_transformer.encoder.layer[0].intermediate["dense"]
    _close(tlayers.linear(torch.from_numpy(x), lin.weight, lin.bias), want)


@pytest.mark.parametrize("bias", [True, False])
def test_layernorm_fp32_two_pass(bias):
    x = _rand((4, 7, 24)) * 3 + 1
    g, b = _rand(24, 1), _rand(24, 2)
    p = {"gamma": jnp.asarray(g), **({"beta": jnp.asarray(b)} if bias else {})}
    got = tlayers.layernorm(torch.from_numpy(x), torch.from_numpy(g),
                            torch.from_numpy(b) if bias else None)
    _close(got, jlayers.layernorm(p, jnp.asarray(x)))


def test_layernorm_bf16_moments_path():
    """bf16 in, bf16 out, fp32 E[x^2] - E[x]^2 moments on both sides: equal
    up to one bf16 rounding step of the output."""
    x = (_rand((6, 64)) * 2 + 0.5).astype(jnp.bfloat16)
    g, b = _rand(64, 1), _rand(64, 2)
    want = np.asarray(jlayers.layernorm({"gamma": jnp.asarray(g), "beta": jnp.asarray(b)},
                                        jnp.asarray(x)), np.float32)
    got = tlayers.layernorm(torch.from_numpy(np.asarray(x, np.float32)).bfloat16(),
                            torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2norm(dtype):
    x = _rand((5, 9, 32))
    want = np.asarray(jlayers.l2norm(jnp.asarray(x).astype(dtype)), np.float32)
    got = tlayers.l2norm(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    tol = dict(atol=ATOL) if dtype == "float32" else dict(rtol=2 ** -7, atol=ATOL)
    np.testing.assert_allclose(got, want, **tol)


def test_feedforward(shared):
    params, model = shared
    ff_p = params["visual_transformer"]["spatial"]["layers"][0]["ff"]
    ff = model.visual_transformer.enc_spatial_transformer.layers[0][3]
    x = _rand((2, 16, DIM))
    for residual in (False, True):
        want = jlayers.feedforward(ff_p, jnp.asarray(x), use_pallas=False, residual=residual)
        _close(tlayers.feedforward(ff, torch.from_numpy(x), residual=residual), want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("temporal", [False, True])
def test_peg_residual(shared, causal, temporal):
    """Spatial [(b t), (h w), d] and temporal [(b h w), t, d] token layouts;
    both reinterpret the buffer as (b, t, h, w, d) without a permute."""
    params, model = shared
    peg_p = params["visual_transformer"]["spatial"]["layers"][1]["peg"]
    conv = model.visual_transformer.enc_spatial_transformer.layers[1][0].dsconv
    b, t, h, w = 2, 3, 4, 5
    x = _rand((b * h * w, t, DIM) if temporal else (b * t, h * w, DIM))
    want = jlayers.peg_residual(peg_p, jnp.asarray(x), (b, t, h, w), causal=causal)
    got = tlayers.peg_residual(conv.weight, conv.bias, torch.from_numpy(x), (b, t, h, w), causal)
    _close(got, want)


def test_continuous_pos_bias(shared):
    params, model = shared
    want = jposbias.continuous_pos_bias(params["visual_transformer"]["spatial_rel_pos_bias"],
                                        GH, GW)
    got = tposbias.continuous_pos_bias(model.visual_transformer.spatial_rel_pos_bias, GH, GW)
    assert got.shape == (HEADS, GH * GW, GH * GW)
    _close(got, want)
    _close(tposbias.continuous_pos_bias(model.visual_transformer.spatial_rel_pos_bias, 3, 5),
           jposbias.continuous_pos_bias(params["visual_transformer"]["spatial_rel_pos_bias"], 3, 5))


def test_alibi_and_causal_mask():
    _close(tposbias.alibi_bias(6, 5, 7), jposbias.alibi_bias(6, 5, 7))
    np.testing.assert_array_equal(tposbias.causal_mask(5, 7).numpy(),
                                  np.asarray(jposbias.causal_mask(5, 7)))


def _attention_pair(cfg: AttentionConfig, seed=0):
    p = jattn.init_attention(jax.random.PRNGKey(seed), cfg)
    sd = {}
    convert._attention(sd, "a", jax.tree.map(np.asarray, p))
    mod = tattn.Attention(port_config(cfg))
    mod.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return p, mod


@pytest.mark.parametrize("with_bias", [True, False])
def test_attention_with_weights(with_bias):
    cfg = AttentionConfig(dim=DIM, dim_head=DIM_HEAD, heads=HEADS)
    p, mod = _attention_pair(cfg)
    x = _rand((3, 16, DIM))
    bias = _rand((HEADS, 16, 16), 1) if with_bias else None
    want = jattn.attention(p, cfg, jnp.asarray(x), attn_bias=None if bias is None
                           else jnp.asarray(bias), return_weights=True, use_pallas=False)
    got = tattn.attention(mod, torch.from_numpy(x), attn_bias=None if bias is None
                          else torch.from_numpy(bias), return_weights=True)
    _close(got.out, want.out)
    _close(got.weights, want.weights)


def test_attention_mask_null_kv_causal():
    cfg = AttentionConfig(dim=DIM, dim_head=DIM_HEAD, heads=HEADS, num_null_kv=2, causal=True)
    p, mod = _attention_pair(cfg, seed=3)
    x = _rand((2, 9, DIM))
    mask = np.random.default_rng(4).random((2, 9)) > 0.3
    want = jattn.attention(p, cfg, jnp.asarray(x), mask=jnp.asarray(mask), return_weights=True,
                           use_pallas=False, residual=True)
    got = tattn.attention(mod, torch.from_numpy(x), mask=torch.from_numpy(mask),
                          return_weights=True, residual=True)
    _close(got.out, want.out)
    _close(got.weights, want.weights)


@pytest.mark.parametrize("with_bias", [True, False])
def test_attention_block_dispatch(with_bias):
    """No weights requested: the port routes to attn_block (bias) or
    attn_packed (no bias), whose plain versions run on the CPU."""
    cfg = AttentionConfig(dim=DIM, dim_head=DIM_HEAD, heads=HEADS)
    p, mod = _attention_pair(cfg, seed=5)
    x = _rand((5, 12, DIM))
    bias = _rand((HEADS, 12, 12), 6) if with_bias else None
    want = jattn.attention(p, cfg, jnp.asarray(x), attn_bias=None if bias is None
                           else jnp.asarray(bias), return_weights=False, use_pallas=False,
                           residual=True)
    got = tattn.attention(mod, torch.from_numpy(x), attn_bias=None if bias is None
                          else torch.from_numpy(bias), return_weights=False, residual=True)
    assert got.weights is None
    _close(got.out, want.out)


@pytest.mark.parametrize("return_weights", [False, True])
def test_transformer_stack(shared, return_weights):
    params, model = shared
    cfg = SMALL_VIT.spatial_transformer()
    bias = jposbias.continuous_pos_bias(params["visual_transformer"]["spatial_rel_pos_bias"],
                                        GH, GW)
    x = _rand((2 * GT, GH * GW, DIM))
    want, aux = jtransformer.transformer(params["visual_transformer"]["spatial"], cfg,
                                         jnp.asarray(x), video_shape=(2, GT, GH, GW),
                                         attn_bias=bias, return_weights=return_weights)
    got, weights = transformer(model.visual_transformer.enc_spatial_transformer,
                               torch.from_numpy(x), video_shape=(2, GT, GH, GW),
                               attn_bias=torch.tensor(np.asarray(bias)),
                               return_weights=return_weights)
    _close(got, want)
    if return_weights:
        for g, w in zip(weights, aux.self_attn):
            _close(g, w)
    else:
        assert weights is None


def test_vq(shared):
    params, model = shared
    x = _rand((2, 20, DIM))
    jstate = params["visual_transformer"]["vq"]
    want_out, want_idx, _ = jvq.vq_apply(jstate, jnp.asarray(x), freeze=True)
    out, idx, state = tvq.vq_apply(model.visual_transformer.vq.state(), torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    _close(out, want_out)
    _close(state.embed, jstate.embed)
    # training: the EMA-updated codebook (ported with the train step)
    _, _, jnew = jvq.vq_apply(jstate, jnp.asarray(x), freeze=False)
    _, _, new = tvq.vq_apply(state, torch.from_numpy(x), freeze=False)
    for got, want in zip(new, jnew):
        _close(got, want)


def test_bert(shared):
    params, model = shared
    rng = np.random.default_rng(7)
    ids = rng.integers(0, SMALL_BERT.vocab_size, (3, 10))
    mask = np.ones((3, 10), np.int64)
    mask[1, 6:] = 0
    tt = (np.arange(10)[None] >= 5).astype(np.int64).repeat(3, 0)
    want = jbert.bert_apply(params["text_transformer"], SMALL_BERT, jnp.asarray(ids),
                            jnp.asarray(mask), jnp.asarray(tt))
    got = tbert.bert_apply(model.text_transformer, torch.from_numpy(ids), torch.from_numpy(mask),
                           torch.from_numpy(tt))
    _close(got, want)
    _close(tbert.bert_cls(model.text_transformer, torch.from_numpy(ids)),
           jbert.bert_cls(params["text_transformer"], SMALL_BERT, jnp.asarray(ids)))


def test_patchify_and_token_grid():
    img = _rand((2, 1, DEPTH, IMG, IMG))
    _close(tctvit.patchify(torch.from_numpy(img), PATCH, T_PATCH),
           jctvit.patchify(jnp.asarray(img), PATCH, T_PATCH))
    assert tctvit.token_grid_shape(PORT_VIT, img.shape) == (GT, GH, GW)
    assert tctvit.token_grid_shape(PORT_VIT, img.shape) == jctvit.token_grid_shape(
        SMALL_VIT, img.shape)


@pytest.mark.parametrize("return_weights", [False, True])
def test_ctvit(shared, return_weights):
    params, model = shared
    img = _rand((2, 1, DEPTH, IMG, IMG), 8)
    want = jctvit.ctvit_apply(params["visual_transformer"], SMALL_VIT, jnp.asarray(img),
                              return_weights=return_weights)
    with torch.no_grad():
        got = tctvit.ctvit_apply(model.visual_transformer, torch.from_numpy(img),
                                 return_weights=return_weights)
    np.testing.assert_array_equal(got.codebook_ids.numpy(), np.asarray(want.codebook_ids))
    _close(got.tokens, want.tokens)
    if return_weights:
        # the last temporal maps sit behind seven fp32 layers whose sums run
        # in another order in XLA and torch: 1.3e-5 measured, 2e-5 asserted
        for g, w in zip(got.spatial_attn + got.temporal_attn,
                        want.spatial_attn + want.temporal_attn):
            _close(g, w, atol=2e-5)


def test_features_outside_the_slice_raise():
    vit = init_ctclip(dataclasses.replace(
        PORT_CLIP, ctvit=dataclasses.replace(PORT_VIT, patch_embed_conv=True)),
        device="cpu").visual_transformer
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Transformer(dataclasses.replace(PORT_VIT.spatial_transformer(), moe_experts=2))
    # an fp16 image bound for the card's bf16 / fp32 kernels (ctvit_apply's entry check)
    with pytest.raises(NotImplementedError, match="bfloat16 or float32"):
        tctvit.check_image_dtype(torch.float16, "cuda", plain=False)
    tctvit.check_image_dtype(torch.bfloat16, "cuda", plain=False)
    tctvit.check_image_dtype(torch.float32, "cuda", plain=False)
    tctvit.check_image_dtype(torch.float32, "cuda", plain=True)
    tctvit.check_image_dtype(torch.float32, "cpu", plain=False)


def test_init_ctclip_is_seeded_with_the_jax_distributions():
    a, b = init_ctclip(PORT_CLIP, seed=0, device="cpu"), init_ctclip(PORT_CLIP, seed=0,
                                                                     device="cpu")
    c = init_ctclip(PORT_CLIP, seed=1, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = "visual_transformer.enc_spatial_transformer.layers.0.1.to_q.weight"
    assert not torch.equal(sa[w], sc[w])
    assert sa[w].abs().max() <= (3.0 / DIM) ** 0.5                      # U(+-sqrt(3/fan_in))
    peg = sa["visual_transformer.enc_spatial_transformer.layers.0.0.dsconv.weight"]
    assert peg.shape == (DIM, 1, 3, 3, 3) and peg.abs().max() <= (3.0 / 27) ** 0.5
    embed = sa["visual_transformer.vq._codebook.embed"]
    torch.testing.assert_close(embed.norm(dim=-1), torch.ones(SMALL_VIT.codebook_size))
    assert torch.equal(sa["visual_transformer.vq._codebook.embed_avg"], embed)
    assert float(sa["temperature"]) == SMALL_CLIP.temperature_init
    assert not a.training


SMALL_VIT_CONV = dataclasses.replace(SMALL_VIT, patch_embed_conv=True)


@functools.cache
def conv_model():
    """The shared JAX weights in a port model with the conv patch embed."""
    params, _ = jax_and_port_models()
    cfg = port_config(dataclasses.replace(SMALL_CLIP, ctvit=SMALL_VIT_CONV))
    return convert.from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")


@pytest.mark.parametrize("seed", [8, 9])
def test_ctvit_conv_patch_embed(shared, seed):
    """patch_embed_conv=True: the folded embed (the kernel's plain version on
    the CPU) and the whole CT-ViT against the JAX package's conv path."""
    params, _ = shared
    vit = conv_model().visual_transformer
    img = _rand((2, 1, DEPTH, IMG, IMG), seed)
    jp = params["visual_transformer"]["to_patch_emb"]
    want_tok = jctvit._patch_embed_conv(jp, jnp.asarray(img), PATCH, T_PATCH)
    want = jctvit.ctvit_apply(params["visual_transformer"], SMALL_VIT_CONV, jnp.asarray(img))
    with torch.no_grad():
        tok = tctvit._patch_embed_conv(vit, torch.from_numpy(img))
        got = tctvit.ctvit_apply(vit, torch.from_numpy(img))
        plain = tctvit.ctvit_apply(vit, torch.from_numpy(img), plain=True)
    _close(tok, want_tok)
    np.testing.assert_array_equal(got.codebook_ids.numpy(), np.asarray(want.codebook_ids))
    _close(got.tokens, want.tokens)
    assert torch.equal(got.tokens, plain.tokens)


def test_conv_and_plain_patch_embeds_agree(shared):
    """The two embeds are one function: the conv form against the plain
    patchify -> LN -> Linear -> LN on the same weights."""
    _, model = shared
    img = torch.from_numpy(_rand((2, 1, DEPTH, IMG, IMG), 10))
    with torch.no_grad():
        conv = tctvit._patch_embed_conv(conv_model().visual_transformer, img)
        emb = model.visual_transformer.to_patch_emb
        plain = tctvit._patch_embed(emb, emb[0](img))
    _close(conv, plain.numpy())


GATE_BERT = BertConfig(vocab_size=64, hidden_size=128, num_layers=2, num_heads=2,
                       intermediate_size=256, max_position_embeddings=136)


@functools.cache
def gate_bert_pair():
    params = jbert.init_bert(jax.random.PRNGKey(3), GATE_BERT)
    sd = {}
    convert._bert(sd, "b", jax.tree.map(np.asarray, params))
    mod = tbert.Bert(port_config(GATE_BERT))
    mod.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return params, mod.eval()


@pytest.mark.parametrize("n", [128, 136])
def test_bert_fused_layers_match_jax_bert_apply(n):
    """At n >= 128 the card sends every layer through bert_layer; on the
    CPU the same chain (fused_layers, the plain version) and bert_apply's
    written-out loop both match the JAX bert_apply, with padded rows."""
    params, mod = gate_bert_pair()
    rng = np.random.default_rng(n)
    ids = rng.integers(0, GATE_BERT.vocab_size, (3, n))
    mask = np.ones((3, n), np.int64)
    mask[0, 9:] = 0
    mask[2, 100:] = 0
    want = jbert.bert_apply(params, GATE_BERT, jnp.asarray(ids), jnp.asarray(mask))
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        loop = tbert.bert_apply(mod, ids_t, mask_t)
        e = mod.embeddings
        x = (e.word_embeddings.weight[ids_t] + e.position_embeddings.weight[None, :n]
             + e.token_type_embeddings.weight[torch.zeros_like(ids_t)])
        x = tlayers.layernorm(x, e.LayerNorm.weight, e.LayerNorm.bias, GATE_BERT.layer_norm_eps)
        mask_row = (1.0 - mask_t.float()) * torch.finfo(torch.float32).min
        fused = tbert.fused_layers(mod, x, mask_row)
    _close(loop, want)
    _close(fused, want)


@pytest.mark.parametrize("n,hidden,heads", [(128, 128, 2), (512, 768, 12), (136, 128, 2),
                                            (120, 128, 2), (130, 128, 2), (128, 96, 2),
                                            (128, 128, 3)])
def test_fused_layer_gate_is_the_jax_gate(n, hidden, heads):
    """bert.py:97-100 of the JAX package, without its TPU clause."""
    cfg = pconfig.BertConfig(hidden_size=hidden, num_heads=heads)
    hd = hidden // heads
    want = hidden % 128 == 0 and n % 8 == 0 and n >= 128 and hd % 8 == 0 and heads * hd == hidden
    assert tbert.fused_layer_gate(cfg, n) == want


def test_entry_points_default_to_the_card():
    """Without device=..., the model and the prompt tokens go to the card;
    on a machine without one that raises rather than building on the CPU."""
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer, tokenize_prompts
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the refusal without one")
    params, _ = jax_and_port_models()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_ctclip(PORT_CLIP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_jax_params(jax.tree.map(np.asarray, params), PORT_CLIP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tokenize_prompts(WordTokenizer())
