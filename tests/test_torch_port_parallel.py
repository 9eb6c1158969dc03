"""Data parallelism over torch.distributed (ct_clip_ut_tpu_torch/parallel/,
the trainer's, zero-shot's, occlusion's and the CLI's mesh paths) on two
gloo ranks on the CPU.

One spawn of two ranks (`_rank_main`, module level and free of JAX so the
spawned processes import no JAX) runs everything and saves what it gets;
the tests hold it against the same calls in this one process:

  * CTClipTrainer over the two ranks against one process (one run
    directory, rank 0's files, losses and parameters, each rank's
    generator through its checkpoint);
  * the data-parallel fp32 train step (local batch 1 a rank, dropout 0)
    and its GradCache form (local batch 2 in microbatches of 1) against
    one process's GradCache and single-pass steps:
    loss, every gradient entering the optimizer, the parameters after the
    update and the VQ codebook, the same bits on both ranks and within
    1e-5 of each tensor's largest entry (parameters: or of 1) of the
    single-process step at B = 2 from the same state; the bits of the same
    loss with each row's latents from a forward of its own in one process;
    against JAX (jax.value_and_grad of the JAX step's loss at B = 2) the
    loss within 1e-5 and the gradients within JAX_GRAD_BAND; controls: the
    all-gather's backward slicing without the cross-rank sum (the
    gradients then come out halved), and the VQ statistics left unsummed
    (the codebook takes half the batch);
  * sharded zero-shot over 5 volumes on 2 ranks (the last shard wraps to
    the first volume): predictions in the dataset's order and metrics equal
    the single-process run's, rank 0 alone writing metrics.txt; the JAX
    package's gather, which keeps the duplicate, gives 6 rows;
    `zeroshot_probs_sharded` of a 3-volume global batch (one padded row);
  * the window-sharded occlusion sweep over 27 windows (padded to 28) and
    its heatmaps;
  * `inference_ctclip --multihost --visualize integrated_gradients` over 2
    processes: one metrics.txt and one set of IG maps, equal to the
    one-process run's;
  * the attribution suite over 4 samples in a second group whose
    collectives time out after SUITE_TIMEOUT, raw attention slowed to
    SUITE_SLEEP a sample (4 of them outlast the timeout): each rank takes
    its interleaved share of raw attention and rollout and writes its maps,
    occlusion and integrated gradients are collective with rank 0 writing
    every sample's map once, and the files equal the one-process suite's;
  * FSDP (leaves of FSDP_MIN elements and up sharded, 38 of the tiny
    model's 94): two AdamW steps and a GradCache step against the
    data-parallel ones, the same bits (losses, each piece its slice of the
    averaged gradient, parameters, moments, codebook), what each rank holds
    between steps, the gathered parameters the same bits on both ranks;
    the collective sharded save, reloaded in one process (2 -> 1), and a
    one-process directory loaded onto the ranks (1 -> 2), the same bits;
  * `integrated_gradients_sharded` at JAX's (steps, chunk) cases (rank 1
    holding padding alone at (2, 2)) against one process's
    `integrated_gradients` and JAX's;
  * `ctgenerate_apply_batched(mesh=)` over 3 scans (padded to 4) against one
    process and JAX, and `inference_ctgenerate --mesh-data 2` against one
    process's files.
"""

import dataclasses
import datetime
import socket
import time

import numpy as np
import pytest
import torch

from ct_clip_ut_tpu import config as jconfig    # dataclasses only: no JAX
from ct_clip_ut_tpu_torch import config as pconfig
from ct_clip_ut_tpu_torch.attribution import integrated_gradients as tig
from ct_clip_ut_tpu_torch.attribution import occlusion as tocc
from ct_clip_ut_tpu_torch.attribution import suite as tsuite
from ct_clip_ut_tpu_torch.data.loader import DataLoader, ShardedSampler
from ct_clip_ut_tpu_torch.infer import zeroshot as tz
from ct_clip_ut_tpu_torch.models import ctgenerate as tcg
from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
from ct_clip_ut_tpu_torch.parallel import collectives, sharding
from ct_clip_ut_tpu_torch.parallel.mesh import (DataMesh, initialize_runtime, local_batch_size,
                                                make_mesh, shutdown_runtime)
from ct_clip_ut_tpu_torch.train import checkpoint as tckpt
from ct_clip_ut_tpu_torch.train import trainer as ttrainer

WORLD = 2
BAND = 1e-5
# The port's step against JAX's, gradient by gradient: the port's plain
# kernels take one-pass LayerNorm moments where the JAX XLA path takes
# two-pass ones (tests/test_torch_port_train.py), which moves gradients by
# up to 9.5e-5 of a tensor's largest entry (measured on this CPU); the
# data-parallel step adds nothing to that (it is within BAND of the
# single-process step).
JAX_GRAD_BAND = 2e-4
# Two biases whose true gradient is 0 (a key bias and the CPB's last bias
# only shift softmax rows): their gradients are rounding noise, held to
# BAND of the model's largest gradient entry, and Adam turns that noise
# into updates of up to lr (tests/test_torch_port_train.py).
SHIFT_INVARIANT = ("text_transformer.encoder.layer.0.attention.self.key.bias",
                   "visual_transformer.spatial_rel_pos_bias.net.2.bias")
TEXT_LEN = 12
DEPTH, IMG = 20, 32


def port_config(jcfg):
    """The port's config class of the same name holding the same fields."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw = {k: port_config(v) if dataclasses.is_dataclass(v) else v for k, v in kw.items()}
    return getattr(pconfig, type(jcfg).__name__)(**kw)


# tests/test_torch_port_train.py's TRAIN_CLIP: the conv patch embed, dropout 0
J_VIT = jconfig.CTViTConfig(dim=16, codebook_size=32, image_size=IMG, patch_size=8,
                            temporal_patch_size=10, spatial_depth=2, temporal_depth=2,
                            dim_head=4, heads=4, patch_embed_conv=True)
J_CLIP = jconfig.CTCLIPConfig(
    dim_text=32, dim_image=4 * 4 * 16, dim_latent=8, ctvit=J_VIT,
    bert=jconfig.BertConfig(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=4,
                            intermediate_size=64, max_position_embeddings=16,
                            hidden_dropout=0.0, attention_dropout=0.0))
P_CLIP = port_config(J_CLIP)
ATT_CLIP = dataclasses.replace(P_CLIP, ctvit=dataclasses.replace(P_CLIP.ctvit,
                                                                 patch_embed_conv=False))
J_TRAIN = jconfig.TrainConfig(lr=1e-3, compute_dtype="float32", text_max_length=TEXT_LEN)
P_TRAIN = port_config(J_TRAIN)
# GradCache over the ranks: a global batch of 4, 2 a rank in microbatches of 1
GC_TRAIN, GC_BATCH = dataclasses.replace(P_TRAIN, grad_accum=2), 4
OCC = pconfig.OcclusionConfig(patch_size=(10, 16, 16), stride=(5, 8, 8))
# the suite's group: a collective waiting longer than SUITE_TIMEOUT fails;
# raw attention over SUITE_SAMPLES samples at SUITE_SLEEP each outlasts it
# on one rank, and half of them do not
SUITE_SAMPLES, SUITE_SLEEP, SUITE_TIMEOUT = 4, 2.0, 5.0
SUITE_METHODS = {"raw_attention_maps": True, "attention_rollout": True,
                 "integrated_gradients": True, "occlusion": {"occ": OCC, "prompt": "p"}}
# FSDP: leaves of this many elements and up sharded (38 of the tiny model's 94)
FSDP_MIN = 100
# AdamW with the clip active (the tiny model's gradient norm is ~1e-1)
ADAMW_TRAIN = dataclasses.replace(P_TRAIN, wd=0.1, max_grad_norm=1e-3)
FSDP_TRAIN = dataclasses.replace(ADAMW_TRAIN, fsdp=True, sharded_checkpoints=True)
# JAX's cases of tests/test_attribution.py:147-162 at the two ranks: (2, 2)
# leaves rank 1 padding alone
IG_CASES = ((16, 2), (6, 2), (2, 2))
# the CTGenerate slice's small configuration (tests/test_torch_port_ctgenerate.py)
J_GEN = jconfig.CTGenerateConfig(
    ctvit=jconfig.CTViTConfig(dim=16, codebook_size=32, image_size=32, patch_size=8,
                              temporal_patch_size=2, spatial_depth=1, temporal_depth=1,
                              dim_head=4, heads=4, model_type="ctgenerate"),
    maskgit=jconfig.MaskGitConfig(dim=16, num_tokens=32, max_seq_len=2048, heads=4, dim_head=4,
                                  depth=1, dim_context=32),
    t5=jconfig.T5EncoderConfig(vocab_size=2048, d_model=32, d_kv=8, num_heads=4, d_ff=64,
                               num_layers=2))
P_GEN = port_config(J_GEN)
GEN_SCANS = 3
GEN_REPORTS = ["Emphysema and a lung nodule.", "Cardiomegaly, small pleural effusion.",
               "Consolidation with atelectasis."]


def _batch(seed=41, b=2):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 1, DEPTH, IMG, IMG)).astype(np.float32)
    ids = rng.integers(5, 64, (b, TEXT_LEN))
    mask = np.ones_like(ids)
    mask[0, 7:] = 0
    ids[0, 7:] = 0
    return images, {"input_ids": ids, "attention_mask": mask,
                    "token_type_ids": np.zeros_like(ids)}


def _zs_samples(n=5):
    rng = np.random.default_rng(51)
    labels = np.eye(n, 18, dtype=np.float32)
    labels[:, 17] = [0, 1, 0, 1, 1][:n]
    return [(rng.standard_normal((1, DEPTH, IMG, IMG)).astype(np.float32), "report", labels[i],
             f"scan_{i}", f"/data/scan_{i}") for i in range(n)]


def _prompts():
    return tz.tokenize_prompts(tz.WordTokenizer(2048), max_length=16, device="cpu")


def _step(model, mesh=None, train_cfg=P_TRAIN, b=2):
    """One train step of `model` on a batch of b (train_cfg's: single-pass
    or GradCache): (loss, gradients entering the optimizer, state after the
    step). With a mesh, on this rank's rows of the global batch."""
    images, text = _batch(b=b)
    state = ttrainer.create_train_state(P_CLIP, train_cfg, params=model, device="cpu",
                                        mesh=mesh)
    grads = []
    step_opt = state.optimizer.step

    def recording_step(*args):
        grads.extend(g.detach().clone() for g in state.optimizer.grads())
        return step_opt(*args)

    state.optimizer.step = recording_step
    step = ttrainer.make_train_step(P_CLIP, train_cfg, mesh=mesh)
    images, text = torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in text.items()}
    if mesh is not None:
        images, text = sharding.shard_host_batch(images, mesh), sharding.shard_host_batch(text,
                                                                                          mesh)
    loss = step(state, images, text)
    return loss, grads, state


def _ig_inputs():
    """A [1, 1, DEPTH, IMG, IMG] volume and a one-row report's tokens."""
    images, text = _batch(seed=71, b=1)
    return images, {k: text[k] for k in ("input_ids", "attention_mask")}


def _gen_inputs():
    """GEN_SCANS [1, 9, 32, 32] scans and longest-padded report embeddings
    [GEN_SCANS, 6, 32] with their mask (the last row's end padded)."""
    rng = np.random.default_rng(81)
    scans = rng.standard_normal((GEN_SCANS, 1, 9, 32, 32)).astype(np.float32)
    mask = np.ones((GEN_SCANS, 6), bool)
    mask[-1, 3:] = False
    return scans, rng.standard_normal((GEN_SCANS, 6, 32)).astype(np.float32) * mask[..., None], \
        mask


def _gen_argv(folder, scans_path, reports_path):
    return ["--scans", str(scans_path), "--reports", str(reports_path), "--batch-size", "2",
            "--compute-dtype", "float32", "--results-folder", str(folder), "--device", "cpu"]


def _run_steps(model, mesh, cfg, b=2, steps=2, save=None):
    """`steps` steps of `cfg`'s train step from `model` (batches of b, this
    rank's rows with a mesh; a batch of its own each step): the losses, the
    first step's gradients entering the optimizer (an FSDP leaf's piece),
    the parameters after the steps (gathered whole under FSDP) and, under
    FSDP, what the rank holds between steps; with `save`, the state saved
    collectively into that directory."""
    state = ttrainer.create_train_state(P_CLIP, cfg, params=model, device="cpu", mesh=mesh)
    grads, opt_step = [], state.optimizer.step

    def recording_step(*args):
        if not grads:
            grads.extend(g.detach().clone() for g in state.optimizer.grads())
        return opt_step(*args)

    state.optimizer.step = recording_step
    step = ttrainer.make_train_step(P_CLIP, cfg, mesh=mesh)
    losses = []
    for i in range(steps):
        images, text = _batch(seed=41 + i, b=b)
        images, text = torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in text.items()}
        if mesh is not None:
            images, text = sharding.shard_host_batch(images, mesh), sharding.shard_host_batch(
                text, mesh)
        losses.append(step(state, images, text).item())
    out = {"losses": losses, "grads": grads, "mu": [m.clone() for m in state.optimizer.mu],
           "nu": [v.clone() for v in state.optimizer.nu], "generator": state.generator.get_state()}
    layout = state.fsdp
    if layout is not None:
        out["spans"] = layout.spans
        out["rest"] = [(p.numel(), p.grad is None, None if q is None else q.numel())
                       for p, q in zip(layout.params, layout.pieces)]
        sharding.gather_params(layout)
    out["params"] = [p.detach().clone() for p in state.model.parameters()]
    if layout is not None:
        sharding.release_params(layout)
    out["buffers"] = {k: v.clone() for k, v in state.model.named_buffers()}
    if save is not None:
        gens = collectives.gather_rows(state.generator.get_state()[None], mesh)
        tckpt.save_checkpoint_sharded(save, state, mesh, rank_generators=gens)
    return out


def _held(state):
    """What a state holds after a load: each leaf the optimizer updates (a
    piece under FSDP), the moments, step, count and generator."""
    return {"leaves": [t.detach().clone() for t in state.optimizer.params],
            "mu": [m.clone() for m in state.optimizer.mu],
            "nu": [v.clone() for v in state.optimizer.nu], "step": state.step,
            "count": state.optimizer.count, "generator": state.generator.get_state(),
            "spans": None if state.fsdp is None else state.fsdp.spans}


def _snapshot(loss, grads, state):
    return {"loss": loss.item(), "grads": grads,
            "params": [p.detach().clone() for p in state.model.parameters()],
            "buffers": {k: v.clone() for k, v in state.model.named_buffers()}}


def _train_samples(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((1, DEPTH, IMG, IMG)).astype(np.float32),
             f"report {i} with effusion and a nodule") for i in range(n)]


def _train(model, folder, mesh=None):
    """CTClipTrainer over 2 steps (global batch 2: each rank's loader shard
    of 1 with a mesh) and a 1-step validation, then a checkpoint saved and
    loaded back into a second trainer: what each rank holds and wrote."""
    cfg = pconfig.TrainConfig(lr=1e-3, num_epochs=1, compute_dtype="float32",
                              text_max_length=TEXT_LEN, seed=5)
    b = 2 // (mesh.world if mesh is not None else 1)

    def loader(n, seed):
        return DataLoader(_train_samples(n, seed), batch_size=b, num_workers=1,
                          sampler=ShardedSampler(n, shuffle=False))

    def trainer(params):
        return ttrainer.CTClipTrainer(P_CLIP, cfg, tz.WordTokenizer(2048), loader(4, 61),
                                      loader(2, 62), results_folder=str(folder), params=params,
                                      device="cpu", mesh=mesh)

    tr = trainer(model)
    state = tr.train()
    tr.save_model("last.pt")
    back = trainer(init_ctclip(P_CLIP, seed=3, device="cpu"))
    back.load_model(tr.results_folder / "last.pt")
    return {"folder": str(tr.results_folder), "losses": tr.train_losses,
            "valid": tr.valid_losses, "step": state.step,
            "params": [p.detach().clone() for p in state.model.parameters()],
            "generator": state.generator.get_state(), "loaded": back.state.generator.get_state(),
            "loaded_equal": all(torch.equal(a, b) for a, b in zip(
                back.state.model.parameters(), state.model.parameters())),
            "files": sorted(p.name for p in tr.results_folder.iterdir())}


def _rank_main(rank, port, suite_port, tmp, init_path, cli_args):
    """One rank: every data-parallel path, results saved to tmp/rank<r>.pt."""
    torch.set_num_threads(1)
    initialize_runtime(f"localhost:{port}", WORLD, rank, device="cpu")
    mesh = make_mesh(pconfig.MeshConfig(data=WORLD), device="cpu")
    out = {"rank": mesh.rank, "world": mesh.world}

    def train_model():
        model = init_ctclip(P_CLIP, seed=rank + 10, device="cpu")   # rank 0's is broadcast
        if rank == 0:
            model.load_state_dict(torch.load(init_path))
        return model.requires_grad_(True)

    out["step"] = _snapshot(*_step(train_model(), mesh))
    out["gradcache"] = _snapshot(*_step(train_model(), mesh, GC_TRAIN, GC_BATCH))

    # FSDP against data parallelism; the sharded checkpoints both ways
    keep_min = sharding._FSDP_MIN_SIZE
    sharding._FSDP_MIN_SIZE = FSDP_MIN
    out["dp_adamw"] = _run_steps(train_model(), mesh, ADAMW_TRAIN)
    out["fsdp_adamw"] = _run_steps(train_model(), mesh, FSDP_TRAIN, save=tmp / "fsdp.dcp")
    out["fsdp_gc"] = _run_steps(train_model(), mesh, dataclasses.replace(GC_TRAIN, fsdp=True),
                                b=GC_BATCH, steps=1)
    state = ttrainer.create_train_state(P_CLIP, FSDP_TRAIN, params=train_model(), device="cpu",
                                        mesh=mesh)
    out["one_to_two"] = _held(tckpt.load_checkpoint_sharded(tmp / "one.dcp", state, mesh))
    sharding._FSDP_MIN_SIZE = keep_min

    # the mesh-sharded integrated gradients, every rank on the same weights
    ig_model = init_ctclip(P_CLIP, seed=0, device="cpu")
    ig_model.load_state_dict(torch.load(init_path))
    image, tokens = (torch.from_numpy(a) if isinstance(a, np.ndarray) else
                     {k: torch.from_numpy(v) for k, v in a.items()} for a in _ig_inputs())
    out["ig"] = {case: tig.integrated_gradients_sharded(ig_model, tokens, image, mesh,
                                                        steps=case[0], chunk=case[1])
                 for case in IG_CASES}
    out["ig_avg"] = tig._ig_avg_grads_sharded(ig_model, tokens, image, mesh, steps=16,
                                              chunk=2)[1]

    # CTGenerate over the ranks, and its CLI
    gen = tcg.init_ctgenerate(P_GEN, seed=0, device="cpu")
    gen.load_state_dict(torch.load(tmp / "gen.pt"))
    scans, ctx, mask = (torch.from_numpy(a) for a in _gen_inputs())
    got = tcg.ctgenerate_apply_batched(gen, scans, ctx, mask, mesh=mesh, compute_dtype="float32")
    out["ctgen"] = (got.feature_map, got.cross_attention, got.codebook_ids)
    from ct_clip_ut_tpu_torch.scripts import inference_ctgenerate as gen_cli
    out["ctgen_cli"] = gen_cli.main(
        _gen_argv(tmp / "gen_cli", tmp / "scans.npy", tmp / "reports.txt")
        + ["--mesh-data", str(WORLD), "--multihost", "--coordinator-address",
           f"localhost:{port}", "--num-processes", str(WORLD), "--process-id", str(rank)],
        model_cfg=P_GEN)
    out["trainer"] = _train(train_model(), tmp / "train", mesh)
    # controls: the gather's backward without the cross-rank sum; the VQ
    # statistics left unsummed
    keep = collectives._AllGather.__dict__["backward"]
    collectives._AllGather.backward = staticmethod(
        lambda ctx, g: (g[ctx.mesh.rank:ctx.mesh.rank + 1], None))
    out["slice_control"] = _snapshot(*_step(train_model(), mesh))
    collectives._AllGather.backward = keep
    from ct_clip_ut_tpu_torch.ops import vq as tvq
    keep_psum = tvq.psum
    tvq.psum = lambda x, axis: x
    out["vq_control"] = _snapshot(*_step(train_model(), mesh))
    tvq.psum = keep_psum

    # sharded zero-shot over 5 volumes: 3 a rank, the last wrapped
    zs = init_ctclip(P_CLIP, seed=7, device="cpu")
    dl = DataLoader(_zs_samples(), batch_size=2,
                    sampler=ShardedSampler(5, shuffle=False, drop_last=False), num_workers=1,
                    drop_last=False)
    inf = tz.CTClipInference(zs, _prompts(), dl, results_folder=str(tmp / f"zs{rank}"),
                             compute_dtype=torch.float32, mesh=mesh)
    metrics, preds, targets = inf.zeroshot()
    out["zs"] = {"metrics": metrics, "preds": preds, "targets": targets,
                 "local": inf.predict()[0], "wrote": (tmp / f"zs{rank}" / "metrics.txt").exists()}
    glob = np.stack([s[0] for s in _zs_samples(3)])
    out["zs_sharded"] = tz.zeroshot_probs_sharded(
        zs, glob, inf.prompt_latents(), mesh, compute_dtype=torch.float32).numpy()

    # the window-sharded occlusion sweep
    att = init_ctclip(ATT_CLIP, seed=9, device="cpu")
    image = torch.from_numpy(_zs_samples(1)[0][0][None])
    lat = torch.nn.functional.normalize(torch.randn(2, 8, generator=torch.Generator()
                                                    .manual_seed(3)), dim=-1)
    coords = tocc.window_grid((DEPTH, IMG, IMG), OCC.patch_size, OCC.stride)
    out["occ"] = tocc.occlusion_scores_multi_sharded(att, image, lat, coords, mesh, occ=OCC,
                                                     chunk=4)
    out["occ_heat"] = tocc.occlusion_heatmaps_multi(att, image, lat, occ=OCC, chunk=4,
                                                    mesh=mesh)

    # the CLI under the same group (initialize_runtime keeps it)
    if cli_args is not None:
        from ct_clip_ut_tpu_torch.scripts import inference_ctclip as cli
        argv, model_cfg, pre_cfg = cli_args
        out["cli"] = cli.main(argv + ["--multihost", "--coordinator-address",
                                      f"localhost:{port}", "--num-processes", str(WORLD),
                                      "--process-id", str(rank)],
                              model_cfg=model_cfg, preprocess_cfg=pre_cfg)[1]

    # the suite in a group with a short timeout, raw attention slowed
    shutdown_runtime()
    from ct_clip_ut_tpu_torch.parallel import mesh as mesh_mod
    mesh_mod.TIMEOUT = datetime.timedelta(seconds=SUITE_TIMEOUT)
    initialize_runtime(f"localhost:{suite_port}", WORLD, rank, device="cpu")
    ran, raw = [], tsuite.Visualizations.raw_attention_maps

    def slow_raw(self, image, tokens, labels, scan_name, path):
        time.sleep(SUITE_SLEEP)
        ran.append(scan_name)
        return raw(self, image, tokens, labels, scan_name, path)

    tsuite.Visualizations.raw_attention_maps = slow_raw
    ctx = tsuite.AttributionContext(model=att, tokenizer=tz.WordTokenizer(2048),
                                    data=_zs_samples(SUITE_SAMPLES), text_max_length=16,
                                    render_gifs=False, mesh=make_mesh(device="cpu"))
    tsuite.Visualizations(ctx, tmp / "suite").visualize(**SUITE_METHODS)
    out["suite_ran"] = ran
    torch.save(out, tmp / f"rank{rank}.pt")
    shutdown_runtime()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_loss_and_grads(params):
    """jax.value_and_grad of the JAX step's loss (train/trainer.py:94-101)
    on the B = 2 batch, the gradients carried into the port's layout."""
    import jax
    import jax.numpy as jnp

    from ct_clip_ut_tpu.models.ctclip import contrastive_loss, ctclip_apply
    from ct_clip_ut_tpu_torch import convert

    images, text = _batch()

    def loss_fn(p):
        out = ctclip_apply(p, J_CLIP, {k: jnp.asarray(v) for k, v in text.items()},
                           jnp.asarray(images), freeze_vq=False, rng=jax.random.PRNGKey(0),
                           deterministic=False)
        return contrastive_loss(out.sim_matrix)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads = convert.from_jax_params(jax.tree.map(np.asarray, grads), P_CLIP, device="cpu")
    return float(loss), [(n, w.detach()) for n, w in grads.named_parameters()]


# the JAX references the `ranks` fixture computes while the ranks run
_JAX = {}


def _one_process_checkpoint(init_path, path):
    """One FSDP AdamW step of one process (each sharded leaf's one piece
    the whole leaf) from init_path's weights, saved as the sharded
    directory `path`; returns what the state holds (`_held`)."""
    keep = sharding._FSDP_MIN_SIZE
    sharding._FSDP_MIN_SIZE = FSDP_MIN
    try:
        model = init_ctclip(P_CLIP, seed=0, device="cpu")
        model.load_state_dict(torch.load(init_path))
        state = ttrainer.create_train_state(P_CLIP, FSDP_TRAIN, params=model.requires_grad_(True),
                                            device="cpu")
        images, text = _batch()
        ttrainer.make_train_step(P_CLIP, FSDP_TRAIN)(
            state, torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in text.items()})
        tckpt.save_checkpoint_sharded(path, state)
        return _held(state)
    finally:
        sharding._FSDP_MIN_SIZE = keep


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, fake_volumes):
    """Spawn the two ranks once, from JAX-initialised weights, and take
    JAX's loss and gradients while they run; ([rank 0's, rank 1's]
    results, the folder, JAX's (loss, [(name, gradient)]))."""
    import jax
    import jax.numpy as jnp

    from ct_clip_ut_tpu.models.ctclip import init_ctclip as jax_init_ctclip
    from ct_clip_ut_tpu_torch import convert

    from ct_clip_ut_tpu.attribution import integrated_gradients as jig
    from ct_clip_ut_tpu.models import ctgenerate as jcg

    tmp = tmp_path_factory.mktemp("dp")
    params = jax.jit(lambda key: jax_init_ctclip(key, J_CLIP))(jax.random.PRNGKey(3))
    model = convert.from_jax_params(jax.tree.map(np.asarray, params), P_CLIP, device="cpu")
    torch.save(model.state_dict(), tmp / "init.pt")
    gen_params = jax.jit(lambda key: jcg.init_ctgenerate(key, J_GEN))(jax.random.PRNGKey(4))
    torch.save(convert.from_jax_ctgenerate_params(jax.tree.map(np.asarray, gen_params), P_GEN,
                                                  device="cpu").state_dict(), tmp / "gen.pt")
    np.save(tmp / "scans.npy", _gen_inputs()[0])
    (tmp / "reports.txt").write_text("\n".join(GEN_REPORTS) + "\n")
    _one_process_checkpoint(tmp / "init.pt", tmp / "one.dcp")
    argv, cfgs = fake_volumes
    cli_args = (argv + ["--results-folder", str(tmp / "cli")], *cfgs)
    procs = torch.multiprocessing.start_processes(
        _rank_main, args=(_free_port(), _free_port(), tmp, tmp / "init.pt", cli_args),
        nprocs=WORLD,
        join=False, start_method="spawn")
    want = _jax_loss_and_grads(params)
    image, tokens = _ig_inputs()
    tokens = {k: jnp.asarray(v) for k, v in tokens.items()}
    _JAX["ig"] = {case: jig.integrated_gradients(params, J_CLIP, tokens, jnp.asarray(image),
                                                 steps=case[0], chunk=case[1])
                  for case in IG_CASES}
    scans, ctx, mask = _gen_inputs()
    _JAX["ctgen"] = jcg.ctgenerate_apply_batched(gen_params, J_GEN, jnp.asarray(scans),
                                                 jnp.asarray(ctx), jnp.asarray(mask),
                                                 compute_dtype="float32")
    while not procs.join():
        pass
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], tmp, want


@pytest.fixture(scope="module")
def fake_volumes(tmp_path_factory):
    """Three tiny NIfTI volumes with their CSVs (the chain of
    tests/test_torch_port_data.py) and the CLI's zero-shot argv."""
    import pandas as pd

    from ct_clip_ut_tpu_torch.data import nifti

    d = tmp_path_factory.mktemp("vols")
    names = [f"valid_{i}_a_1.nii.gz" for i in range(3)]
    (d / "v").mkdir()
    rng = np.random.default_rng(5)
    for name in names:
        nifti.write_nii(d / "v" / name, rng.integers(0, 2000, (40, 40, 12)).astype(np.float32))
    pd.DataFrame({"VolumeName": names, "Findings_EN": ["a", "b", "c"],
                  "Impressions_EN": ["x", "y", "z"]}).to_csv(d / "r.csv", index=False)
    pd.DataFrame({"VolumeName": names, "RescaleSlope": [1] * 3,
                  "RescaleIntercept": [-1024] * 3, "XYSpacing": ["[0.6, 0.6]"] * 3,
                  "ZSpacing": [2.0] * 3}).to_csv(d / "m.csv", index=False)
    labels = pd.DataFrame(np.eye(3, 18) + np.eye(3, 18, 5), columns=[f"p{i}" for i in range(18)])
    labels.insert(0, "VolumeName", names)
    labels.to_csv(d / "l.csv", index=False)
    argv = ["--data-valid", str(d / "v"), "--valid-reports", str(d / "r.csv"),
            "--valid-labels", str(d / "l.csv"), "--valid-metadata", str(d / "m.csv"),
            "--zero-shot", "--visualize", "integrated_gradients", "--no-gifs",
            "--num-workers", "1", "--device", "cpu"]
    pre = pconfig.PreprocessConfig(target_shape_hwd=(IMG, IMG, DEPTH))
    # the CLI pads its prompts to 512 tokens
    cli_clip = dataclasses.replace(P_CLIP, bert=dataclasses.replace(P_CLIP.bert,
                                                                    max_position_embeddings=512))
    return argv, (cli_clip, pre)


def _within(got, want, band=BAND, name="", scale=None):
    """|got - want| <= band x (want's largest entry, or `scale`)."""
    if not want.numel():
        return
    scale = float(want.abs().max()) if scale is None else scale
    err = float((got - want).abs().max())
    assert err <= band * scale, (name, err, scale)


def _grads_within(names, got, want, band):
    """Every gradient within `band` of its largest entry, the
    SHIFT_INVARIANT ones within BAND of the model's largest entry."""
    top = max(float(w.abs().max()) for w in want if w.numel())
    for n, g, w in zip(names, got, want):
        _within(g, w, band, n, scale=top if n in SHIFT_INVARIANT else None)


# ---- the mesh and the collectives -------------------------------------------------

def test_mesh_of_one_process_and_its_refusals():
    mesh = make_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.is_main) == (1, 0, True)
    assert local_batch_size(4, DataMesh(2, 0, torch.device("cpu"))) == 2
    with pytest.raises(ValueError, match="divisible"):
        local_batch_size(3, DataMesh(2, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(pconfig.MeshConfig(data=2), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 11c"):
        make_mesh(pconfig.MeshConfig(model=2), device="cpu")
    assert initialize_runtime(num_processes=1) is False
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_runtime(num_processes=2)
    # one rank without a group: every collective is the identity
    x = torch.randn(3, 4, requires_grad=True)
    y = collectives.all_gather(x, mesh)
    (y * 2).sum().backward()
    assert torch.equal(y, x) and torch.equal(x.grad, torch.full_like(x, 2.0))
    assert torch.equal(collectives.pmean(x, mesh), x.detach())
    assert collectives.broadcast_bytes(b"run/3", mesh) == b"run/3"
    two = DataMesh(2, 1, torch.device("cpu"))
    rows = torch.arange(8.0).reshape(4, 2)
    assert torch.equal(sharding.local_rows(rows, two), rows[2:])
    assert torch.equal(sharding.shard_host_batch(rows.numpy(), two), rows[2:])
    with pytest.raises(RuntimeError, match="process group"):
        collectives.psum(x, DataMesh(2, 0, torch.device("cpu")))
    sim = torch.arange(16.0).reshape(4, 4)
    assert torch.equal(collectives.shard_diag(sim, DataMesh(2, 1, torch.device("cpu")), 2),
                       torch.tensor([10.0, 15.0]))


def test_mesh_without_a_card_raises(monkeypatch, fake_volumes):
    """F9: make_mesh() and make_mesh(device="cuda") raise on a machine
    without a card, as the entry points do, where they once gave a CPU mesh;
    device="cpu" still gives one. inference_ctclip --mesh-data 1 on its
    default device raises before any model is built."""
    from ct_clip_ut_tpu_torch.scripts import inference_ctclip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(**kw)
    assert make_mesh(device="cpu").device == torch.device("cpu")

    def built(*args, **kwargs):
        raise AssertionError("a model was built")

    monkeypatch.setattr(inference_ctclip, "load_model", built)
    argv, cfgs = fake_volumes
    argv = argv[:argv.index("--device")] + ["--mesh-data", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference_ctclip.main(argv, *cfgs)


def test_nccl_rank_without_a_card_of_its_own_raises(monkeypatch):
    """initialize_runtime puts LOCAL_RANK on its card and refuses a rank
    past the last card, before any group forms."""
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(ValueError, match="no card of its own"):
        initialize_runtime(f"localhost:{_free_port()}", 2, 1, backend="nccl")
    assert not torch.distributed.is_initialized()


# ---- the train step ------------------------------------------------------------

def test_data_parallel_step_is_the_same_on_both_ranks(ranks):
    (r0, r1), _, _ = ranks
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, WORLD)
    s0, s1 = r0["step"], r1["step"]
    assert s0["loss"] == s1["loss"]
    for key in ("grads", "params"):
        for a, b in zip(s0[key], s1[key]):
            assert torch.equal(a, b), key
    for k in s0["buffers"]:
        assert torch.equal(s0["buffers"][k], s1["buffers"][k]), k


def _single(init_path):
    model = init_ctclip(P_CLIP, seed=0, device="cpu")
    model.load_state_dict(torch.load(init_path))
    return _snapshot(*_step(model.requires_grad_(True)))


def test_data_parallel_step_matches_the_single_process_step(ranks):
    (r0, _), tmp, _ = ranks
    want, got = _single(tmp / "init.pt"), r0["step"]
    assert abs(got["loss"] - want["loss"]) <= BAND * abs(want["loss"])
    names = [n for n, _ in init_ctclip(P_CLIP, device="cpu").named_parameters()]
    _grads_within(names, got["grads"], want["grads"], BAND)
    # parameters after the update: within BAND of their largest entry or of
    # 1, whichever is larger (a zero-initialised bias moves by lr)
    for n, g, w in zip(names, got["params"], want["params"]):
        if w.numel():
            _within(g, w, 2 * P_TRAIN.lr if n in SHIFT_INVARIANT else BAND, n,
                    scale=max(float(w.abs().max()), 1.0))
    for k, w in want["buffers"].items():
        _within(got["buffers"][k], w, name=k)
    # the controls: halved gradients; a codebook from half the batch
    temp = names.index("temperature")
    bad = [n for i, (n, g, w) in enumerate(zip(names, r0["slice_control"]["grads"],
                                               want["grads"]))
           if i != temp and n not in SHIFT_INVARIANT and w.numel()
           and float((g - w).abs().max()) > BAND * float(w.abs().max())]
    assert len(bad) > len(names) // 2, bad
    cb = "visual_transformer.vq._codebook.embed_avg"
    assert float((r0["vq_control"]["buffers"][cb] - want["buffers"][cb]).abs().max()) > \
        100 * BAND * float(want["buffers"][cb].abs().max())


def test_data_parallel_step_is_the_one_process_split_bit_for_bit(ranks):
    """Rank r backpropagates 2 x the cotangent of its row (the gather's
    summed backward) and the gradients are summed and halved over the
    ranks: both exact, so the step's gradients are the bits of the same
    loss with each row's latents from a forward of its own in one process."""
    from ct_clip_ut_tpu_torch.models.ctclip import contrastive_loss, ctclip_apply

    (r0, _), tmp, _ = ranks
    model = init_ctclip(P_CLIP, seed=0, device="cpu")
    model.load_state_dict(torch.load(tmp / "init.pt"))
    model.requires_grad_(True)
    images, text = _batch()
    latents = []
    for i in range(WORLD):
        out = ctclip_apply(model, {k: torch.from_numpy(v[i:i + 1]) for k, v in text.items()},
                           torch.from_numpy(images[i:i + 1]), freeze_vq=False,
                           generator=torch.Generator().manual_seed(0), deterministic=False)
        latents.append((out.image_latents, out.text_latents))
    img, txt = (torch.cat(t) for t in zip(*latents))
    loss = contrastive_loss((img.float() @ txt.float().t()) * model.temperature.exp())
    loss.backward()
    assert loss.item() == r0["step"]["loss"]
    for (n, p), g in zip(model.named_parameters(), r0["step"]["grads"]):
        want = p.grad if p.grad is not None else torch.zeros_like(p)
        assert torch.equal(g, want), n


def test_data_parallel_gradcache_matches_one_process(ranks):
    """GradCache over the two ranks (pass 1's latents gathered into the
    global [4, 4] similarity matrix, each rank's pass 2 on its own
    microbatches, the statistics and gradients reduced over the ranks)
    against one process's GradCache step over the same 4 rows in
    microbatches of 1, and its single-pass step: the same bits on both
    ranks, the loss, gradients, parameters and codebook within BAND."""
    (r0, r1), tmp, _ = ranks
    assert r0["gradcache"]["loss"] == r1["gradcache"]["loss"]
    for a, b in zip(r0["gradcache"]["params"], r1["gradcache"]["params"]):
        assert torch.equal(a, b)
    names = [n for n, _ in init_ctclip(P_CLIP, device="cpu").named_parameters()]
    for cfg in (dataclasses.replace(P_TRAIN, grad_accum=GC_BATCH), P_TRAIN):
        model = init_ctclip(P_CLIP, seed=0, device="cpu")
        model.load_state_dict(torch.load(tmp / "init.pt"))
        want, got = _snapshot(*_step(model.requires_grad_(True), None, cfg, GC_BATCH)), \
            r0["gradcache"]
        assert abs(got["loss"] - want["loss"]) <= BAND * abs(want["loss"])
        _grads_within(names, got["grads"], want["grads"], BAND)
        for n, g, w in zip(names, got["params"], want["params"]):
            if w.numel():
                _within(g, w, 2 * P_TRAIN.lr if n in SHIFT_INVARIANT else BAND, n,
                        scale=max(float(w.abs().max()), 1.0))
        for k, w in want["buffers"].items():
            _within(got["buffers"][k], w, name=k)


def test_data_parallel_step_matches_jax(ranks):
    """The step's loss and gradients against jax.value_and_grad of the JAX
    step's loss on the same B = 2 batch and parameters."""
    (r0, _), _, (loss, grads) = ranks
    assert abs(r0["step"]["loss"] - loss) <= BAND * abs(loss)
    names, want = zip(*grads)
    _grads_within(names, r0["step"]["grads"], want, JAX_GRAD_BAND)


def test_trainer_over_two_ranks_matches_one_process(ranks, tmp_path):
    """CTClipTrainer(mesh=) over 2 steps: one run directory (rank 0's,
    broadcast) with one set of files (the training curves rank 0's too), losses and parameters within BAND of
    the single-process trainer at global batch 2, every rank's generator
    its own (seeded from (seed, rank)) and reloaded from the checkpoint."""
    (r0, r1), tmp, _ = ranks
    model = init_ctclip(P_CLIP, seed=0, device="cpu")
    model.load_state_dict(torch.load(tmp / "init.pt"))
    want = _train(model.requires_grad_(True), tmp_path)
    t0, t1 = r0["trainer"], r1["trainer"]
    assert t0["folder"] == t1["folder"] and t0["step"] == t1["step"] == want["step"] == 2
    assert t0["files"] == want["files"] == ["architecture.json", "best_checkpoint.pt",
                                            "best_checkpoint.pt.pos.json", "last.pt",
                                            "last.pt.pos.json", "training_progress.png"]
    for a, b in ((t0["losses"]["epochs"], want["losses"]["epochs"]), (t0["valid"], want["valid"]),
                 (t1["valid"], want["valid"])):
        np.testing.assert_allclose(a, b, rtol=BAND, atol=0)
    names = [n for n, _ in init_ctclip(P_CLIP, device="cpu").named_parameters()]
    for n, a, b, w in zip(names, t0["params"], t1["params"], want["params"]):
        assert torch.equal(a, b), n
        if w.numel():
            _within(a, w, 2 * 2 * P_TRAIN.lr if n in SHIFT_INVARIANT else BAND, n,
                    scale=max(float(w.abs().max()), 1.0))
    assert not torch.equal(t0["generator"], t1["generator"])
    for t in (t0, t1):
        assert torch.equal(t["loaded"], t["generator"]) and t["loaded_equal"]


# ---- zero-shot -----------------------------------------------------------------

def test_sharded_zero_shot_matches_one_process(ranks, tmp_path):
    (r0, r1), _, _ = ranks
    zs = init_ctclip(P_CLIP, seed=7, device="cpu")
    dl = DataLoader(_zs_samples(), batch_size=2, num_workers=1, drop_last=False,
                    sampler=ShardedSampler(5, shuffle=False, drop_last=False))
    inf = tz.CTClipInference(zs, _prompts(), dl, results_folder=str(tmp_path),
                             compute_dtype=torch.float32)
    metrics, preds, targets = inf.zeroshot()
    for r in (r0, r1):
        assert r["zs"]["preds"].shape == (5, 18)
        np.testing.assert_allclose(r["zs"]["preds"], preds, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(r["zs"]["targets"], targets)
        assert r["zs"]["metrics"].keys() == metrics.keys()
        for k, v in metrics.items():
            np.testing.assert_allclose(np.asarray(r["zs"]["metrics"][k], np.float64),
                                       np.asarray(v, np.float64), atol=1e-6, err_msg=k)
    assert r0["zs"]["wrote"] and not r1["zs"]["wrote"]
    # the JAX package's gather keeps rank 1's wrapped copy of volume 0
    kept = np.concatenate([r0["zs"]["local"], r1["zs"]["local"]])
    assert kept.shape == (6, 18)
    np.testing.assert_allclose(r1["zs"]["local"][-1], preds[0], atol=1e-6)
    probs = tz.zeroshot_probs(zs, torch.from_numpy(np.stack([s[0] for s in _zs_samples(3)])),
                              inf.prompt_latents(), torch.float32).numpy()
    for r in (r0, r1):
        np.testing.assert_allclose(r["zs_sharded"], probs, atol=1e-6, rtol=0)


def test_gather_predictions_puts_rows_back_in_sampler_order():
    """The interleaved sampler's shards of 5 samples over 2 ranks (rank 1's
    last row the wrapped sample 0), the order gather_predictions undoes (the
    sharded zero-shot test holds the gather); a one-rank mesh returns its
    input."""
    order = [ShardedSampler(5, 2, r, shuffle=False, drop_last=False).indices() for r in (0, 1)]
    assert order == [[0, 2, 4], [1, 3, 0]]
    one = DataMesh(1, 0, torch.device("cpu"))
    a = np.ones((3, 2))
    assert tz.gather_predictions(a, a, one)[0] is a


# ---- occlusion -------------------------------------------------------------------

def test_sharded_occlusion_matches_one_process(ranks):
    (r0, r1), _, _ = ranks
    att = init_ctclip(ATT_CLIP, seed=9, device="cpu")
    image = torch.from_numpy(_zs_samples(1)[0][0][None])
    lat = torch.nn.functional.normalize(torch.randn(2, 8, generator=torch.Generator()
                                                    .manual_seed(3)), dim=-1)
    coords = tocc.window_grid((DEPTH, IMG, IMG), OCC.patch_size, OCC.stride)
    assert coords.shape[0] == 27
    orig, scores = tocc.occlusion_scores_slabbed(att, image, lat, coords, occ=OCC, chunk=4)
    heat = tocc.occlusion_heatmaps_multi(att, image, lat, occ=OCC, chunk=4)
    for r in (r0, r1):
        got_orig, got = r["occ"]
        assert got.shape == (27, 2)
        np.testing.assert_allclose(got_orig, orig, atol=BAND, rtol=0)
        np.testing.assert_allclose(got, scores, atol=BAND, rtol=0)
        for g, w in zip(r["occ_heat"], heat):
            np.testing.assert_allclose(g, w, atol=BAND, rtol=0)


def _suite_maps(root):
    """{(method, file name): map} of a suite's results folder, and the run
    directories each method made."""
    maps = {(p.parent.parent.name, p.name): np.load(p) for p in root.rglob("*.npy")}
    dirs = {m.name: len([d for d in m.iterdir() if d.is_dir()]) for m in root.iterdir()
            if m.is_dir()}
    return maps, dirs


def test_suite_splits_its_one_rank_methods_over_the_ranks(ranks, tmp_path):
    """Raw attention and rollout: sample i on rank i % 2, so neither rank
    waits out the other's whole pass (which outlasts the group's timeout);
    integrated gradients collective, rank 0 writing every sample's map once
    (none dropped, as the JAX suite's per-process mode drops those of
    ranks > 0); every map equal to the one-process suite's."""
    (r0, r1), tmp, _ = ranks
    assert r0["suite_ran"] == ["scan_0", "scan_2"]
    assert r1["suite_ran"] == ["scan_1", "scan_3"]
    assert SUITE_SAMPLES * SUITE_SLEEP > SUITE_TIMEOUT
    att = init_ctclip(ATT_CLIP, seed=9, device="cpu")
    ctx = tsuite.AttributionContext(model=att, tokenizer=tz.WordTokenizer(2048),
                                    data=_zs_samples(SUITE_SAMPLES), text_max_length=16,
                                    render_gifs=False)
    tsuite.Visualizations(ctx, tmp_path).visualize(**SUITE_METHODS)
    got, got_dirs = _suite_maps(tmp / "suite")
    want, want_dirs = _suite_maps(tmp_path)
    assert sorted(got) == sorted(want)
    assert len(want) == 6 * SUITE_SAMPLES
    assert got_dirs == want_dirs == {"raw_attention_grids": SUITE_SAMPLES,
                                     "attention_rollout": SUITE_SAMPLES,
                                     "integrated_gradients": SUITE_SAMPLES,
                                     "occlusion": SUITE_SAMPLES}
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=BAND, rtol=0, err_msg=str(key))


# ---- the CLI --------------------------------------------------------------------

def test_cli_multihost_matches_one_process(ranks, fake_volumes, tmp_path):
    """inference_ctclip --multihost --zero-shot --visualize
    integrated_gradients over 2 processes: one metrics.txt equal to the
    one-process run's, and every volume's IG map written once (the steps
    split over the ranks), each the one-process map's within BAND."""
    from ct_clip_ut_tpu_torch.scripts import inference_ctclip as cli

    (r0, r1), tmp, _ = ranks
    argv, (cfg, pre) = fake_volumes
    metrics, preds, _ = cli.main(argv + ["--results-folder", str(tmp_path)], model_cfg=cfg,
                                 preprocess_cfg=pre)
    for r in (r0, r1):
        np.testing.assert_allclose(r["cli"], preds, atol=1e-6, rtol=0)
    assert (tmp / "cli" / "metrics.txt").read_text() == (tmp_path / "metrics.txt").read_text()
    assert "mean_roc_auc" in metrics
    got, _ = _suite_maps(tmp / "cli")
    want, _ = _suite_maps(tmp_path)
    assert sorted(got) == sorted(want) and len(want) == 3
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=BAND, rtol=0, err_msg=str(key))


# ---- FSDP and the sharded checkpoints ----------------------------------------------

def _names():
    return [n for n, _ in init_ctclip(P_CLIP, device="cpu").named_parameters()]


def _piece(full, span):
    return full.reshape(-1) if span is None else full.reshape(-1)[span[0]:span[1]]


def test_fsdp_step_matches_the_data_parallel_step(ranks):
    """Two AdamW steps (wd > 0) of FSDP against data parallelism on the same
    batches: both losses, each gradient piece (the bits of the averaged
    gradient's slice; the replicated leaves whole), the parameters, moments
    and codebook after two steps the same bits, and on both ranks; between
    steps each rank holds only its pieces; through the data-parallel
    step's bits, JAX's loss and gradients."""
    (r0, r1), _, (jloss, jgrads) = ranks
    names = _names()
    for r in (r0, r1):
        dp, fs = r["dp_adamw"], r["fsdp_adamw"]
        assert fs["losses"] == dp["losses"]
        for n, span, g, w in zip(names, fs["spans"], fs["grads"], dp["grads"]):
            assert torch.equal(g.reshape(-1), _piece(w, span)), n
        for n, span, g, w, m, dm, v, dv in zip(names, fs["spans"], fs["params"], dp["params"],
                                               fs["mu"], dp["mu"], fs["nu"], dp["nu"]):
            assert torch.equal(g, w), n
            assert torch.equal(m.reshape(-1), _piece(dm, span)), n
            assert torch.equal(v.reshape(-1), _piece(dv, span)), n
        for k, w in dp["buffers"].items():
            assert torch.equal(fs["buffers"][k], w), k
        for n, span, (numel, no_grad, piece), p, m, v in zip(
                names, fs["spans"], fs["rest"], fs["params"], fs["mu"], fs["nu"]):
            held = p.numel() if span is None else span[1] - span[0]
            assert (numel, no_grad or span is None) == (0 if span else p.numel(), True), n
            assert piece == (None if span is None else held) and m.numel() == v.numel() == held
    sharded = [s is not None for s in r0["fsdp_adamw"]["spans"]]
    assert sharded == [p.numel() >= FSDP_MIN for p in r0["dp_adamw"]["params"]]
    assert sum(sharded) == 38
    for n, s0, s1, full in zip(names, r0["fsdp_adamw"]["spans"], r1["fsdp_adamw"]["spans"],
                               r0["fsdp_adamw"]["params"]):
        assert s0 is None or (s0[0], s1[1], s0[1]) == (0, full.numel(), s1[0]), n
    for a, b in zip(r0["fsdp_adamw"]["params"], r1["fsdp_adamw"]["params"]):
        assert torch.equal(a, b)
    assert abs(r0["fsdp_adamw"]["losses"][0] - jloss) <= BAND * abs(jloss)
    whole = [torch.cat([g0.reshape(-1), g1.reshape(-1)]).view_as(w) if s is not None else g0
             for s, g0, g1, w in zip(r0["fsdp_adamw"]["spans"], r0["fsdp_adamw"]["grads"],
                                     r1["fsdp_adamw"]["grads"], r0["dp_adamw"]["grads"])]
    _grads_within(names, whole, [w for _, w in jgrads], JAX_GRAD_BAND)


def test_fsdp_gradcache_matches_the_data_parallel_gradcache(ranks):
    """The FSDP GradCache step (gathered once for both passes, reduced once
    after pass 2) against the data-parallel GradCache step: the loss, each
    piece (its slice of the averaged gradient), the parameters and the
    codebook the same bits."""
    (r0, r1), _, _ = ranks
    names = _names()
    for r in (r0, r1):
        dp, fs = r["gradcache"], r["fsdp_gc"]
        assert fs["losses"][0] == dp["loss"]
        for n, span, g, w in zip(names, fs["spans"], fs["grads"], dp["grads"]):
            assert torch.equal(g.reshape(-1), _piece(w, span)), n
        for n, g, w in zip(names, fs["params"], dp["params"]):
            assert torch.equal(g, w), n
        for k, w in dp["buffers"].items():
            assert torch.equal(fs["buffers"][k], w), k


def _fresh_state(cfg):
    model = init_ctclip(P_CLIP, seed=5, device="cpu").requires_grad_(True)
    return ttrainer.create_train_state(P_CLIP, cfg, params=model, device="cpu")


def test_sharded_checkpoint_reloads_on_one_process(ranks):
    """The directory both ranks wrote after two FSDP steps, loaded into one
    process (2 -> 1): as FSDP over one rank and as a replicated state, every
    parameter and moment the ranks' bits, the step, count and rank 0's
    generator."""
    (r0, r1), tmp, _ = ranks
    fs0, fs1 = r0["fsdp_adamw"], r1["fsdp_adamw"]
    assert sorted(p.name for p in tmp.iterdir() if "dcp" in p.name) == ["fsdp.dcp", "one.dcp"]
    keep = sharding._FSDP_MIN_SIZE
    sharding._FSDP_MIN_SIZE = FSDP_MIN
    try:
        for cfg in (FSDP_TRAIN, ADAMW_TRAIN):
            held = _held(tckpt.load_checkpoint_sharded(tmp / "fsdp.dcp", _fresh_state(cfg)))
            assert (held["step"], held["count"]) == (2, 2)
            assert torch.equal(held["generator"], fs0["generator"])
            for i, (span, full) in enumerate(zip(fs0["spans"], fs0["params"])):
                assert torch.equal(held["leaves"][i].reshape(-1), full.reshape(-1)), i
                for key in ("mu", "nu"):
                    want = fs0[key][i] if span is None else torch.cat([fs0[key][i], fs1[key][i]])
                    assert torch.equal(held[key][i].reshape(-1), want.reshape(-1)), (key, i)
    finally:
        sharding._FSDP_MIN_SIZE = keep


def test_sharded_checkpoint_loads_onto_the_ranks(ranks):
    """A one-process directory loaded by both FSDP ranks (1 -> 2): each
    piece and moment piece the bits of its slice of the saved leaf; rank 0
    takes the saved generator, rank 1 (past the saved world) keeps its own,
    seeded from (seed, 1)."""
    (r0, r1), tmp, _ = ranks
    saved = _held(tckpt.load_checkpoint_sharded(tmp / "one.dcp", _fresh_state(ADAMW_TRAIN)))
    assert (saved["step"], saved["count"]) == (1, 1)
    for r in (r0, r1):
        got = r["one_to_two"]
        assert (got["step"], got["count"]) == (1, 1)
        for i, span in enumerate(got["spans"]):
            for key in ("leaves", "mu", "nu"):
                assert torch.equal(got[key][i].reshape(-1), _piece(saved[key][i], span)), (key, i)
    assert torch.equal(r0["one_to_two"]["generator"], saved["generator"])
    own = torch.Generator().manual_seed(FSDP_TRAIN.seed + (1 << 32)).get_state()
    assert torch.equal(r1["one_to_two"]["generator"], own)


# ---- integrated gradients over the mesh ---------------------------------------------

def _held_outside_crossings(got, want, band):
    """Every element on the same side of the quantile threshold within
    `band` of the map's largest entry; the crossings (an element within
    rounding of the threshold kept by one map and zeroed by the other)
    under 1e-3 of the map."""
    crossed = (got > 0) != (want > 0)
    assert crossed.mean() < 1e-3
    np.testing.assert_allclose(got[~crossed], want[~crossed], atol=band * np.abs(want).max())


def test_sharded_integrated_gradients_match_one_process_and_jax(ranks):
    """At JAX's (steps, chunk) cases, (2, 2) leaving rank 1 padding alone:
    both ranks the same map; against one process's integrated_gradients the
    average gradient within BAND of its largest entry and the map within
    BAND outside the threshold crossings; against JAX's the map within the
    port's IG band (MAP_BAND of tests/test_torch_port_attribution.py)
    likewise."""
    (r0, r1), tmp, _ = ranks
    model = init_ctclip(P_CLIP, seed=0, device="cpu")
    model.load_state_dict(torch.load(tmp / "init.pt"))
    image, tokens = _ig_inputs()
    image, tokens = torch.from_numpy(image), {k: torch.from_numpy(v) for k, v in tokens.items()}
    assert tig.rank_alphas(2, 2, WORLD, 1) == []
    _, avg = tig._ig_avg_grads(model, tokens, image, steps=16, chunk=2)
    _within(r0["ig_avg"], avg)
    for case in IG_CASES:
        np.testing.assert_array_equal(r0["ig"][case], r1["ig"][case])
        want = tig.integrated_gradients(model, tokens, image, steps=case[0], chunk=case[1])
        _held_outside_crossings(r0["ig"][case], want, BAND)
        _held_outside_crossings(r0["ig"][case], _JAX["ig"][case], 1e-3)


# ---- CTGenerate over the mesh ---------------------------------------------------------

def test_ctgenerate_over_the_ranks_matches_one_process_and_jax(ranks):
    """ctgenerate_apply_batched(mesh=) over 3 scans on 2 ranks (padded to 4
    with the last scan): every rank every row, the codebook ids those of one
    process and of JAX, the feature map and cross-attention within 1e-5."""
    (r0, r1), tmp, _ = ranks
    for a, b in zip(r0["ctgen"], r1["ctgen"]):
        assert torch.equal(a, b)
    gen = tcg.init_ctgenerate(P_GEN, seed=0, device="cpu")
    gen.load_state_dict(torch.load(tmp / "gen.pt"))
    scans, ctx, mask = (torch.from_numpy(a) for a in _gen_inputs())
    one = tcg.ctgenerate_apply_batched(gen, scans, ctx, mask, compute_dtype="float32")
    jax_out = _JAX["ctgen"]
    feature, cross, ids = r0["ctgen"]
    assert feature.shape[0] == cross.shape[0] == ids.shape[0] == GEN_SCANS
    for want in (one, jax_out):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want.codebook_ids))
        np.testing.assert_allclose(feature.numpy(), np.asarray(want.feature_map), atol=1e-5)
        np.testing.assert_allclose(cross.numpy(), np.asarray(want.cross_attention), atol=1e-5)


def test_inference_ctgenerate_mesh_data_writes_one_process_files(ranks, tmp_path):
    """inference_ctgenerate --mesh-data 2 over 3 scans in batches of 2:
    rank 0 writes every heatmap the one-process run writes, once, each
    within 1e-5; rank 1 writes none. --mesh-data 2 in one process raises."""
    from ct_clip_ut_tpu_torch.scripts import inference_ctgenerate as gen_cli

    (r0, r1), tmp, _ = ranks
    want = gen_cli.main(_gen_argv(tmp_path, tmp / "scans.npy", tmp / "reports.txt"),
                        model_cfg=P_GEN)
    assert want and r1["ctgen_cli"] == []
    assert sorted(p.name for p in r0["ctgen_cli"]) == sorted(p.name for p in want)
    assert sorted(p.name for p in (tmp / "gen_cli").iterdir()) == sorted(p.name for p in want)
    for p in want:
        np.testing.assert_allclose(np.load(tmp / "gen_cli" / p.name), np.load(p), atol=1e-5)
    with pytest.raises(ValueError, match="needs 2 processes"):
        gen_cli.main(_gen_argv(tmp_path, tmp / "scans.npy", tmp / "reports.txt")
                     + ["--mesh-data", "2"], model_cfg=P_GEN)
