"""The reference-checkpoint converter (convert.py `ctclip_from`,
`load_ctclip`, `reference_ctgenerate_state`, `load_ctgenerate`;
scripts/convert_checkpoint.py) and the WordPiece tokenizer
(data/tokenizer.py), on the CPU.

The converter is held, on synthetic state dicts in the reference's key
layout built as tests/test_converter_naming.py builds them (HF BERT under
text_transformer.*, the CT-ViT's Sequential / ModuleList indices, the
custom LayerNorm's gamma and beta buffers, vq._codebook's EMA buffers with
the num_codebooks axis), to the JAX converter followed by
`convert.from_jax_params`, bit for bit, through every quirk: the trainer's
{"model": ...} wrapper and DDP's module. prefix, the codebook under
`codebook.` and without its leading axis, embed_avg and cluster_size left
out, an attention without context_norm, HF BERT's position_ids and pooler.
A key the port has no place for and a key the checkpoint lacks each raise
naming it. CTGenerate with an HF T5EncoderModel state dict against the JAX
converter's tree; without one, the conversion raises naming the missing
file, and the CLI's loader refuses the reference's file and loads the
converted one, the CLI only with --stand-in-tokenizer (T5's own tokenizer
is not ported). Each CTCLIP loader reads the three files (the
reference's, a port state dict, the port's train state) into the same
model.

The tokenizer against `transformers.BertTokenizer(vocab_file,
do_lower_case=True)` on a synthetic vocabulary: ids, attention masks and
token type ids of texts with accents, punctuation, CJK, control
characters, unknown and over-long words, padded to 512 and to the longest.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.config import T5EncoderConfig as JT5
from ct_clip_ut_tpu.train import checkpoint as ckpt
from ct_clip_ut_tpu_torch import convert
from ct_clip_ut_tpu_torch.config import TrainConfig
from ct_clip_ut_tpu_torch.data.tokenizer import BertWordPiece
from ct_clip_ut_tpu_torch.models.ctclip import contrastive_loss, ctclip_apply
from ct_clip_ut_tpu_torch.scripts import convert_checkpoint, inference_ctclip, inference_ctgenerate
from ct_clip_ut_tpu_torch.train import checkpoint as tckpt
from ct_clip_ut_tpu_torch.train import trainer as ttrainer

import test_converter_naming as naming
from test_torch_port_modules import port_config

CLIP = port_config(naming.CLIP)
T5 = JT5(vocab_size=40, d_model=naming.MG.dim_context, d_kv=4, num_heads=2, d_ff=32,
         num_layers=2)


def reference_ctclip_sd():
    sd = {}
    sd.update(naming.bert_sd("text_transformer.", naming.BERT))
    sd.update(naming.ctvit_sd("visual_transformer.", naming.VIT))
    sd["to_text_latent.weight"] = naming.t(naming.CLIP.dim_latent, naming.CLIP.dim_text)
    sd["to_visual_latent.weight"] = naming.t(naming.CLIP.dim_latent, naming.CLIP.dim_image)
    sd["temperature"] = torch.tensor(1.0)
    return sd


def _jax_model(sd, cfg=naming.CLIP):
    return convert.from_jax_params(jax.tree.map(np.asarray, ckpt.convert_ctclip(sd, cfg)),
                                   port_config(cfg), device="cpu")


def _variant(name):
    """(the reference-layout checkpoint of variant `name`, the state dict the
    JAX converter reads for it)."""
    sd = reference_ctclip_sd()
    vq = "visual_transformer.vq._codebook."
    if name == "wrapped, module. prefix":
        return {"model": {f"module.{k}": v for k, v in sd.items()}, "optim": {}}, sd
    if name == "codebook. without its leading axis":
        out = {k.replace("vq._codebook.", "vq.codebook."): v for k, v in sd.items()}
        for k in ("embed", "embed_avg"):
            out[f"visual_transformer.vq.codebook.{k}"] = sd[vq + k][0]
        return out, out
    if name == "no embed_avg, no cluster_size":
        out = {k: v for k, v in sd.items() if not k.endswith(("embed_avg", "cluster_size"))}
        return out, out
    if name == "no context_norm":
        return {k: v for k, v in sd.items() if ".context_norm." not in k}, sd
    if name == "HF BERT's position_ids and pooler":
        extra = {"text_transformer.embeddings.position_ids": torch.arange(24)[None],
                 "text_transformer.pooler.dense.weight": naming.t(32, 32),
                 "text_transformer.pooler.dense.bias": naming.t(32)}
        return {**sd, **extra}, sd
    return sd, sd


@pytest.mark.parametrize("name", ["plain", "wrapped, module. prefix",
                                  "codebook. without its leading axis",
                                  "no embed_avg, no cluster_size", "no context_norm",
                                  "HF BERT's position_ids and pooler"])
def test_reference_ctclip_converts_as_the_jax_converter(name):
    blob, jax_sd = _variant(name)
    got = convert.ctclip_from(blob, CLIP, device="cpu")
    want = _jax_model(jax_sd).state_dict()
    assert set(got.state_dict()) == set(want)
    for k, v in got.state_dict().items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    if name == "plain":
        rng = np.random.default_rng(0)
        image = torch.from_numpy(rng.standard_normal((2, 1, 20, 32, 32)).astype(np.float32))
        ids = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 7]])
        out = ctclip_apply(got, {"input_ids": ids, "attention_mask": (ids > 0).long()}, image)
        assert torch.isfinite(out.sim_matrix).all()
        assert torch.isfinite(contrastive_loss(out.sim_matrix))


@pytest.mark.parametrize("fault", ["unknown", "missing"])
def test_reference_ctclip_refuses_an_unknown_or_a_missing_key(fault):
    sd = reference_ctclip_sd()
    key = "visual_transformer.enc_spatial_transformer.layers.1.1.to_q.weight"
    if fault == "unknown":
        sd["visual_transformer.extra_head.weight"] = torch.zeros(2)
        key = "visual_transformer.extra_head.weight"
    else:
        del sd[key]
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        convert.ctclip_from(sd, CLIP, device="cpu")


def t5_sd(cfg=T5):
    """An HF T5EncoderModel state dict (with its tied embed_tokens copy)."""
    t = naming.t
    sd = {"shared.weight": t(cfg.vocab_size, cfg.d_model),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              t(cfg.relative_attention_num_buckets, cfg.num_heads),
          "encoder.final_layer_norm.weight": t(cfg.d_model)}
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]
    inner = cfg.d_kv * cfg.num_heads
    for i in range(cfg.num_layers):
        bp = f"encoder.block.{i}.layer"
        sd[f"{bp}.0.layer_norm.weight"] = t(cfg.d_model, seed=i)
        for n in "qkv":
            sd[f"{bp}.0.SelfAttention.{n}.weight"] = t(inner, cfg.d_model, seed=i + 1)
        sd[f"{bp}.0.SelfAttention.o.weight"] = t(cfg.d_model, inner, seed=i)
        sd[f"{bp}.1.layer_norm.weight"] = t(cfg.d_model, seed=i + 2)
        for n in ("wi_0", "wi_1"):
            sd[f"{bp}.1.DenseReluDense.{n}.weight"] = t(cfg.d_ff, cfg.d_model, seed=i + 3)
        sd[f"{bp}.1.DenseReluDense.wo.weight"] = t(cfg.d_model, cfg.d_ff, seed=i + 4)
    return sd


def reference_ctgenerate_sd():
    sd = {}
    sd.update(naming.ctvit_sd("ctvit.", naming.GEN_VIT))
    pd1 = naming.GEN_VIT.first_frame_patch_dim
    sd["ctvit.to_patch_emb_first_frame.1.weight"] = torch.ones(pd1)
    sd["ctvit.to_patch_emb_first_frame.1.bias"] = torch.zeros(pd1)
    sd["ctvit.to_patch_emb_first_frame.2.weight"] = naming.t(naming.GEN_VIT.dim, pd1)
    sd["ctvit.to_patch_emb_first_frame.2.bias"] = naming.t(naming.GEN_VIT.dim)
    sd["ctvit.to_patch_emb_first_frame.3.weight"] = torch.ones(naming.GEN_VIT.dim)
    sd["ctvit.to_patch_emb_first_frame.3.bias"] = torch.zeros(naming.GEN_VIT.dim)
    sd.update(naming.maskgit_sd("maskgit.", naming.MG))
    return sd


def test_reference_ctgenerate_converts_with_its_t5_tower(tmp_path):
    jcfg = dataclasses.replace(naming.GEN, t5=T5)
    cfg = port_config(jcfg)
    sd, t5 = reference_ctgenerate_sd(), t5_sd()
    tree = jax.tree.map(np.asarray, ckpt.convert_ctgenerate({"model": sd}, jcfg, t5_sd=t5))
    want = convert.from_jax_ctgenerate_params(tree, cfg, device="cpu").state_dict()
    got = convert.reference_ctgenerate_state({"model": sd}, cfg, t5)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the conversion script with the T5 file and without it; the CLI's loader
    torch.save({"model": sd}, tmp_path / "ctgenerate_filtered.pt")
    torch.save(t5, tmp_path / "t5.pt")
    base = ["--kind", "ctgenerate", "--in", str(tmp_path / "ctgenerate_filtered.pt"), "--out",
            str(tmp_path / "port.pt")]
    with pytest.raises(FileNotFoundError, match="T5"):
        convert_checkpoint.main(base, model_cfg=cfg)
    with pytest.raises(FileNotFoundError, match="nowhere.pt"):
        convert_checkpoint.main(base + ["--t5", str(tmp_path / "nowhere.pt")], model_cfg=cfg)
    convert_checkpoint.main(base + ["--t5", str(tmp_path / "t5.pt")], model_cfg=cfg)
    back = inference_ctgenerate.load_model(cfg, tmp_path / "port.pt", 0, "cpu")
    assert all(torch.equal(v, want[k]) for k, v in back.state_dict().items())
    with pytest.raises(ValueError, match="--t5 T5_STATE_DICT.pt"):
        inference_ctgenerate.load_model(cfg, tmp_path / "ctgenerate_filtered.pt", 0, "cpu")
    with pytest.raises(ValueError, match="12d"):
        inference_ctgenerate.main(["--generate", "p", "--checkpoint", str(tmp_path / "port.pt"),
                                   "--device", "cpu"], model_cfg=cfg)


def test_every_ctclip_loader_reads_the_three_checkpoint_forms(tmp_path):
    """The reference's checkpoint, the conversion script's port state dict
    and the port's train-state checkpoint give the same model through the
    inference CLI's loader (also embedding_arithmetic's) and the train
    CLI's (convert.ctclip_from)."""
    blob, _ = _variant("wrapped, module. prefix")
    torch.save(blob, tmp_path / "ctclip_v2.pt")
    convert_checkpoint.main(["--kind", "ctclip", "--in", str(tmp_path / "ctclip_v2.pt"),
                             "--out", str(tmp_path / "port.pt")], model_cfg=CLIP)
    want = _jax_model(reference_ctclip_sd()).state_dict()
    state = ttrainer.create_train_state(
        CLIP, TrainConfig(), params=convert.load_ctclip(tmp_path / "port.pt", CLIP, device="cpu"),
        device="cpu")
    tckpt.save_checkpoint(tmp_path / "last_checkpoint.pt", state)
    for name in ("ctclip_v2.pt", "port.pt", "last_checkpoint.pt"):
        for model in (inference_ctclip.load_model(CLIP, tmp_path / name, 0, "cpu"),
                      convert.ctclip_from(convert.read_checkpoint(tmp_path / name), CLIP,
                                          device="cpu")):
            for k, v in model.state_dict().items():
                assert torch.equal(v, want[k]), (name, k)


TEXTS = ["There is a nodule in the right upper lobe.",
         "Pleural effusions; cardiomegaly (3mm)!",
         "Café naïve X-ray 中文字 \t\n odd\x00chars​",
         "a" * 101 + " clear",
         "Emphysemaing zzz qwerty",
         "",
         "No acute finding. " * 40]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *".,;:()-/%'\"!?",
         *("the lung lungs are clear no acute finding there is a nodule in right upper lobe "
           "emphysema cafe naive x 3 中 文").split(),
         "##s", "##ing", "##ed", "pleur", "##al", "eff", "##usion", "card", "##io", "##mega",
         "##ly", "##ray", "##mm", "od", "##d"]


@pytest.mark.parametrize("padding,max_length", [("max_length", 512), ("longest", 24)])
def test_wordpiece_tokenizer_matches_bert_tokenizer(tmp_path, padding, max_length):
    transformers = pytest.importorskip("transformers")
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    hf = transformers.BertTokenizer(vocab_file=str(tmp_path / "vocab.txt"), do_lower_case=True)
    ours = BertWordPiece.from_dir(tmp_path)
    want = hf(TEXTS, padding=padding, truncation=True, max_length=max_length,
              return_tensors="np")
    got = ours(TEXTS, padding=padding, truncation=True, max_length=max_length,
               return_tensors="np")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert [ours.tokenize(t) for t in TEXTS] == [hf.tokenize(t) for t in TEXTS]
    ids = got["input_ids"][1]
    assert ours.convert_ids_to_tokens(ids) == hf.convert_ids_to_tokens(ids)
    assert ours("there is", add_special_tokens=False) == dict(hf("there is",
                                                               add_special_tokens=False))
