"""Training: the single-card train and eval steps and the host-side driver.

Counterpart of ct_clip_ut_tpu/train/trainer.py. One `train_step` call does
what the JAX package's jitted step does (trainer.py:86-113): the forward
with the VQ codebook unfrozen and text dropout drawn from the state's
generator, the symmetric InfoNCE loss, the backward (the kernels' autograd
Functions on the card), the global-norm clip and the Adam update
(train/optimizer.py), and the VQ EMA write-back (not a gradient step). It
returns the loss as a device tensor, without a host sync. The model's
parameters stay fp32; the forward runs in `compute_dtype`: bf16 (the
default), or float32, where the CT-ViT runs its fp32 kernels forward and
backward (every parameter gradient three bf16 products of hi / lo planes)
and BERT, at reports of 128 tokens or more (the default 512), its fp32
bert_layer chains with dropout, forward and backward, or, under 128
tokens, its plain layers as in the JAX package.

`CTClipTrainer` is the driver of trainer.py:267-672: tokenising on the
host, the epoch loop with the loss fetched one step late, the step-0
bootstrap evaluation, `save_every_steps` checkpoints with the position
sidecar (`<name>.pos.json`) that step-level resume reads, and the dated /
indexed results folder.

Data parallelism (`mesh`, a parallel.mesh.DataMesh; trainer.py:86-113,
284-384 under GSPMD): each rank steps on its own local batch, the latents
of every rank are gathered with a gradient into the global sim matrix
(ctclip_apply(gather_axis=mesh)), the VQ's EMA statistics are summed over
the ranks, and the gradients are averaged over the ranks before the clip
and Adam, so the clip sees the global norm and every rank takes the same
update. Rank 0's parameters and moments are broadcast at the start; each
rank's dropout generator is seeded from (seed, rank); rank 0 picks the run
directory and broadcasts it, and alone writes checkpoints and prints.

FSDP (`train_cfg.fsdp`; JAX shards the same state through GSPMD): after
rank 0's broadcast each rank keeps its flat piece of every parameter of
at least parallel.sharding._FSDP_MIN_SIZE elements and of its moments
(`sharding.shard_state`); a step gathers the parameters whole, runs the
forward and backward, gives each piece the mean of its gradient slice
(data parallelism's all-reduce: the pieces are the bits of the averaged
gradient's slices, and the clip's norm is its norm), updates the pieces
and frees the gathered storage: the data-parallel step, bit for bit.
Without a mesh FSDP runs over one rank, each piece the whole leaf.
Sharded checkpoints (`train_cfg.sharded_checkpoints`,
trainer.py:403-407) are directories every rank writes its pieces into
(`checkpoint.save_checkpoint_sharded`), named `<name>.dcp`; FSDP over more
than one process needs them, as in JAX (trainer.py:295-304): a single
file would need one rank to hold the whole state.

GradCache (`grad_accum` k > 1, trainer.py:116-251): the full batch's
InfoNCE objective at the activations of B / k volumes
(`make_train_step_gradcache`). The profiler window (`profile_steps`):
steps [2, 2 + profile_steps) of epoch 1 under torch.profiler, its trace
written to `profile_dir`. After each evaluation the training curves go to
training_progress.png (best effort: skipped with a message without
matplotlib).

Not ported yet, and raising with their ROADMAP item: the MoE CT-ViT, a
model mesh axis.
"""

from __future__ import annotations

import itertools
import json
import time
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from .. import _build
from ..config import CTCLIPConfig, TrainConfig
from ..models.ctclip import (CTCLIP, contrastive_loss, ctclip_apply, encode_image_latents,
                             init_ctclip, text_latents_of)
from ..ops.taps import Taps
from ..ops.vq import VQState, vq_batch_stats, vq_ema_update, vq_stats_input
from ..parallel import collectives, sharding
from ..parallel.mesh import DataMesh, check_mesh
from ..parallel.sharding import FsdpLayout, shard_loader
from ..utils import metrics
from . import checkpoint as ckpt
from .optimizer import Optimizer, get_optimizer


@dataclass
class TrainState:
    model: CTCLIP
    optimizer: Optimizer
    step: int
    generator: torch.Generator
    fsdp: Optional[FsdpLayout] = None    # the FSDP layout (train_cfg.fsdp), else None


def check_supported(model_cfg: CTCLIPConfig, train_cfg: TrainConfig) -> None:
    """Raise for what the port does not run yet, naming its ROADMAP item."""
    if train_cfg.grad_accum < 1:
        raise ValueError(f"grad_accum must be a positive microbatch count, got "
                         f"{train_cfg.grad_accum}")
    if model_cfg.ctvit.moe_experts > 0:
        raise NotImplementedError("the MoE CT-ViT is not ported yet (ROADMAP, Queue 1 item "
                                  "11h: moe)")


def create_train_state(model_cfg: CTCLIPConfig, train_cfg: TrainConfig,
                       params: Optional[CTCLIP] = None, device="cuda",
                       mesh: Optional[DataMesh] = None) -> TrainState:
    """A TrainState on `device`: `params` (a CTCLIP, e.g. from
    convert.from_jax_params) or a model drawn from train_cfg.seed, the
    optimizer over its parameters, step 0, and the dropout generator
    seeded from train_cfg.seed. With a `mesh` the state lands on the
    mesh's device, rank 0's parameters and moments are broadcast to every
    rank, and the generator is seeded from (seed, rank). train_cfg.fsdp
    then shards the parameters and moments over the mesh (over one rank
    without one): `state.fsdp` is the layout."""
    check_supported(model_cfg, train_cfg)
    check_mesh(mesh)
    device = _build.check_device(mesh.device if mesh is not None else device)
    model = params if params is not None else init_ctclip(model_cfg, seed=train_cfg.seed,
                                                          device=device)
    model = model.to(device)
    opt = get_optimizer(list(model.parameters()), lr=train_cfg.lr, wd=train_cfg.wd,
                        betas=tuple(train_cfg.betas), eps=train_cfg.eps,
                        max_grad_norm=train_cfg.max_grad_norm,
                        warmup_steps=train_cfg.warmup_steps, decay_steps=train_cfg.decay_steps,
                        end_lr_frac=train_cfg.end_lr_frac, mu_dtype=train_cfg.adam_mu_dtype)
    # rank 0 keeps the single-process stream, rank r draws from seed + r 2^32
    rank = mesh.rank if mesh is not None else 0
    gen = torch.Generator(device=device).manual_seed(train_cfg.seed + (rank << 32))
    if mesh is not None:
        sharding.broadcast_state(model, opt, mesh)
    layout = None
    if train_cfg.fsdp:
        layout = sharding.shard_state(model, opt, mesh if mesh is not None
                                      else DataMesh(1, 0, device))
    return TrainState(model=model, optimizer=opt, step=0, generator=gen, fsdp=layout)


@torch.no_grad()
def write_back_vq(model: CTCLIP, vq_state: VQState) -> None:
    """The EMA codebook into the model's buffers (trainer.py:78-83)."""
    cb = model.visual_transformer.vq._codebook
    cb.embed.copy_(vq_state.embed)
    cb.embed_avg.copy_(vq_state.embed_avg)
    cb.cluster_size.copy_(vq_state.cluster_size)


def _gather(state: TrainState) -> None:
    """Under FSDP, every sharded parameter whole for the step."""
    if state.fsdp is not None:
        sharding.gather_params(state.fsdp)


def _reduce(state: TrainState, mesh: Optional[DataMesh]):
    """The gradients onto what the optimizer holds: the pieces' means under
    FSDP (returns the whole leaves' norms for the clip), the ranks' means
    in data parallelism, left as they are alone (both return None)."""
    if state.fsdp is not None:
        if (state.fsdp.mesh.world != 1 if mesh is None else mesh != state.fsdp.mesh):
            raise ValueError(f"the step's mesh {mesh} is not the one the state is sharded over, "
                             f"{state.fsdp.mesh}")
        return sharding.reduce_grads(state.fsdp)
    if mesh is not None:
        sharding.allreduce_grads(state.optimizer.params, mesh)
    return None


def _release(state: TrainState) -> None:
    """Under FSDP, the gathered storage freed: the pieces alone stay."""
    if state.fsdp is not None:
        sharding.release_params(state.fsdp)


def make_train_step(model_cfg: CTCLIPConfig, train_cfg: TrainConfig,
                    plain: bool = False, mesh: Optional[DataMesh] = None) -> Callable:
    """train_step(state, image, text_tokens) -> loss (a device scalar);
    updates `state` in place. plain=True runs every kernel's plain forward
    and lets autograd differentiate it (the reference the card holds its
    backward kernels against). With a `mesh`, `image` and `text_tokens`
    are this rank's local batch, the loss is the global batch's (the same
    on every rank), and the gradients are averaged over the ranks before
    the optimizer (see the module doc); under FSDP (state.fsdp) the
    parameters are gathered for the step and the gradients reduced onto
    the pieces. grad_accum > 1 gives make_train_step_gradcache's step."""
    check_supported(model_cfg, train_cfg)
    check_mesh(mesh)
    if train_cfg.grad_accum > 1:
        return make_train_step_gradcache(model_cfg, train_cfg, plain=plain, mesh=mesh)
    dtype = getattr(torch, train_cfg.compute_dtype)

    def train_step(state: TrainState, image: torch.Tensor, text_tokens: dict) -> torch.Tensor:
        _gather(state)
        state.optimizer.zero_grad()
        out = ctclip_apply(state.model, text_tokens, image.to(dtype), freeze_vq=False,
                           generator=state.generator, deterministic=False, plain=plain,
                           gather_axis=mesh)
        loss = contrastive_loss(out.sim_matrix)
        loss.backward()
        state.optimizer.step(_reduce(state, mesh))
        write_back_vq(state.model, out.vq_state)
        _release(state)
        state.step += 1
        return loss.detach()

    return train_step


def make_train_step_gradcache(model_cfg: CTCLIPConfig, train_cfg: TrainConfig,
                              plain: bool = False, mesh: Optional[DataMesh] = None,
                              record: Optional[dict] = None) -> Callable:
    """train_step(state, image, text_tokens) -> loss: the single-pass
    step's loss, update and VQ EMA at the activations of one microbatch of
    B / k volumes (k = train_cfg.grad_accum; GradCache, Gao et al. 2021;
    trainer.py:116-251). Accumulating per-microbatch losses would contrast
    each volume against its own microbatch only; the InfoNCE objective
    couples the whole batch through its [B, B] similarity matrix. So:

    pass 1  each microbatch's latents without a graph (torch.no_grad: the
            fp32 BERT layer keeps no state for a backward), the codebook
            frozen at the step's own, and its VQ statistics (`vq_stats_input`
            of the vq.input tap, `vq_batch_stats`), summed over the
            microbatches in order;
    head    the loss, its cotangents on the latents and the temperature's
            gradient from the [B, B] similarity matrix;
    pass 2  each microbatch again under autograd, its latents' backward
            with their cotangents, the gradients accumulated in order;

    then one clip-and-Adam step and one EMA update from the summed
    statistics. Dropout (F4): the generator's state before each
    microbatch's pass 1 is restored for its pass 2, so the text tower draws
    the same masks and `draw_seeds` the BERT kernels' same Philox seeds, and
    pass 2's latents are pass 1's, bit for bit; the generator then stands
    where pass 1 left it. The masks are drawn per microbatch, so they are
    not the single-pass step's.

    With a data-axis `mesh`, `image` is this rank's local batch: pass 1's
    latents are gathered into the global similarity matrix, the statistics
    summed over the ranks, each rank's pass 2 runs its own microbatches
    with its rows' cotangents (times the world size, as the single-pass
    step's all_gather backward gives them), and the gradients are averaged
    over the ranks. Under FSDP the parameters are gathered once for both
    passes and the gradients reduced once, after pass 2. `record`, where
    given, receives each microbatch's
    latents of both passes: record["pass1"], record["pass2"], lists of
    (image latents, text latents)."""
    check_supported(model_cfg, train_cfg)
    check_mesh(mesh)
    k = train_cfg.grad_accum
    dtype = getattr(torch, train_cfg.compute_dtype)
    vcfg = model_cfg.ctvit

    def latents(model, image, tokens, generator, taps):
        # the order of ctclip_apply: the text tower draws its masks first
        txt = text_latents_of(model, tokens, None, image.dtype, plain, generator=generator,
                              deterministic=False)
        img, vit_out = encode_image_latents(model, image, freeze_vq=True, taps=taps,
                                            deterministic=False, plain=plain)
        return img, txt, vit_out

    def train_step(state: TrainState, image: torch.Tensor, text_tokens: dict) -> torch.Tensor:
        b = image.shape[0]
        if b % k:
            raise ValueError(f"batch {b} is not a multiple of grad_accum {k}")
        m = b // k
        image = image.to(dtype)
        model, gen = state.model, state.generator
        _gather(state)
        parts = [(image[i * m:(i + 1) * m], {key: v[i * m:(i + 1) * m]
                                             for key, v in text_tokens.items()})
                 for i in range(k)]
        vq0 = model.visual_transformer.vq.state()
        dim, size = vq0.embed.shape[1], vq0.embed.shape[0]
        starts, imgs, txts, counts, embed_sum = [], [], [], 0.0, 0.0
        with torch.no_grad():
            for img_i, tok_i in parts:
                starts.append(gen.get_state())
                taps = Taps(capture=("vq.input",))
                img, txt, vit_out = latents(model, img_i, tok_i, gen, taps)
                c, e = vq_batch_stats(vit_out.codebook_ids,
                                      vq_stats_input(taps.collected["vq.input"], dim), size)
                counts, embed_sum = counts + c, embed_sum + e
                imgs.append(img)
                txts.append(txt)
        end = gen.get_state()
        img_all, txt_all = torch.cat(imgs), torch.cat(txts)
        if mesh is not None:
            counts, embed_sum = collectives.psum(counts, mesh), collectives.psum(embed_sum, mesh)
            d = img_all.shape[-1]
            both = collectives.gather_rows(
                torch.cat([img_all, txt_all.to(img_all.dtype)], -1), mesh)
            img_all, txt_all = both[:, :d], both[:, d:].to(txt_all.dtype)

        temp = model.temperature
        img_h = img_all.float().requires_grad_()
        txt_h = txt_all.float().requires_grad_()
        with torch.enable_grad():
            loss = contrastive_loss((img_h @ txt_h.t()) * temp.exp())
            g_temp, g_img, g_txt = torch.autograd.grad(loss, [temp, img_h, txt_h])
        if mesh is not None:
            rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
            g_img, g_txt = g_img[rows] * mesh.world, g_txt[rows] * mesh.world

        state.optimizer.zero_grad()
        replayed = []
        for i, (img_i, tok_i) in enumerate(parts):
            gen.set_state(starts[i])
            img, txt, _ = latents(model, img_i, tok_i, gen, Taps())
            torch.autograd.backward([img.float(), txt.float()],
                                    [g_img[i * m:(i + 1) * m], g_txt[i * m:(i + 1) * m]])
            replayed.append((img.detach(), txt.detach()))
        gen.set_state(end)
        if record is not None:
            record.update(pass1=list(zip(imgs, txts)), pass2=replayed)
        temp.grad = g_temp
        state.optimizer.step(_reduce(state, mesh))
        write_back_vq(model, vq_ema_update(vq0, counts, embed_sum, decay=vcfg.vq_decay,
                                           eps=vcfg.vq_eps))
        _release(state)
        state.step += 1
        return loss.detach()

    return train_step


def make_eval_step(model_cfg: CTCLIPConfig, train_cfg: TrainConfig,
                   mesh: Optional[DataMesh] = None) -> Callable:
    """eval_step(model, image, text_tokens) -> loss (a device scalar), the
    codebook frozen and no dropout (trainer.py:254-264). With a `mesh` the
    latents are gathered over the ranks: the loss is the global batch's.
    Under FSDP the caller gathers the parameters first (CTClipTrainer.evaluate)."""
    dtype = getattr(torch, train_cfg.compute_dtype)

    @torch.no_grad()
    def eval_step(model: CTCLIP, image: torch.Tensor, text_tokens: dict) -> torch.Tensor:
        out = ctclip_apply(model, text_tokens, image.to(dtype), freeze_vq=True,
                           gather_axis=mesh)
        return contrastive_loss(out.sim_matrix)

    return eval_step


class CTClipTrainer:
    """Host-side training driver (reference CTClipTrainer.py:33-304).

    `train_data` / `valid_data` are iterables (re-iterable per epoch)
    yielding (images [B, 1, D, H, W], texts) batches, numpy or tensors;
    `tokenizer` is an HF-style callable (max_length = text_max_length).
    On the card unless `device` says otherwise.

    With a `mesh` (parallel.mesh.make_mesh) every rank builds the trainer
    with the same arguments; the state goes to the mesh's device. A loader
    whose `sampler` is a one-shard `ShardedSampler` is given this rank's
    shard (num_shards = world, shard_index = rank); any other iterable must
    already yield this rank's batches, the same number on every rank.

    FSDP over more than one process needs `sharded_checkpoints` (JAX
    trainer.py:295-304); with them `save_model` is collective (every rank
    calls it and writes its pieces) and the checkpoints are directories
    named `<name>.dcp` where the single files are `<name>.pt`."""

    def __init__(self, model_cfg: CTCLIPConfig, train_cfg: TrainConfig, tokenizer,
                 train_data: Iterable, valid_data: Iterable, results_folder: str = "./results",
                 params: Optional[CTCLIP] = None, mesh: Optional[DataMesh] = None,
                 device="cuda"):
        check_mesh(mesh)
        if train_cfg.fsdp and not train_cfg.sharded_checkpoints and mesh is not None \
                and mesh.world > 1:
            # a single-file save gathers the whole state onto one rank, which
            # no rank holds: refuse up front rather than at the first save
            raise ValueError("fsdp=True over more than one process needs "
                             "sharded_checkpoints=True (--sharded-checkpoints): a single-file "
                             "checkpoint cannot gather parameters that no single process holds")
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.tokenizer = tokenizer
        self.train_data = train_data
        self.valid_data = valid_data
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.device = _build.check_device(mesh.device if mesh is not None else device)
        if mesh is not None:
            for data in (train_data, valid_data):
                shard_loader(data, mesh)
        self.state = create_train_state(model_cfg, train_cfg, params=params, device=self.device,
                                        mesh=mesh)
        self.train_step = make_train_step(model_cfg, train_cfg, mesh=mesh)
        self.eval_step = make_eval_step(model_cfg, train_cfg, mesh=mesh)

        # dated + indexed results dir (reference CTClipTrainer.py:122-131);
        # rank 0 picks it and broadcasts it (trainer.py:314-331): ranks
        # counting on a shared file system would race
        run_rel = ""
        if self.is_main:
            base = Path(results_folder) / datetime.now().strftime("%d-%m-%Y")
            base.mkdir(parents=True, exist_ok=True)
            idx = len([d for d in base.iterdir() if d.is_dir()]) + 1
            run_rel = f"{base.name}/{idx}"
        if mesh is not None:
            run_rel = collectives.broadcast_bytes(run_rel.encode(), mesh).decode()
        self.results_folder = Path(results_folder) / run_rel
        self.results_folder.mkdir(parents=True, exist_ok=True)

        self.train_losses = {"steps": [], "epochs": []}
        self.valid_losses = []
        self.best_score = float("inf")
        # data-stream position for step-level resume, persisted beside every
        # checkpoint (trainer.py:344-350)
        self._pos = {"epoch": 0, "step_in_epoch": 0, "steps_per_epoch": None}
        self._resume_pos = None
        self._profiler = None

    def maybe_print(self, *args, **kwargs) -> None:
        if self.is_main:
            print(*args, **kwargs)

    def _start_trace(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()

    def _stop_trace(self) -> None:
        """The profiler window's trace to profile_dir/trace.json (chrome
        trace format: chrome://tracing, Perfetto, TensorBoard)."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out = Path(self.cfg.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        self._profiler.export_chrome_trace(str(out / "trace.json"))
        self._profiler = None
        self.maybe_print(f"profiler trace -> {out / 'trace.json'}")

    # -- plumbing -----------------------------------------------------------

    def tokenize(self, texts) -> dict:
        enc = self.tokenizer(list(texts), return_tensors="np", padding="max_length",
                             truncation=True, max_length=self.cfg.text_max_length)
        keys = [k for k in ("input_ids", "attention_mask", "token_type_ids") if k in enc]
        return {k: torch.as_tensor(np.asarray(enc[k]), dtype=torch.int64, device=self.device)
                for k in keys}

    def _put_batch(self, images, texts):
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        return images, self.tokenize(texts)

    def checkpoint_name(self, stem: str) -> str:
        """The file (`<stem>.pt`) or, with sharded checkpoints, directory
        (`<stem>.dcp`) a checkpoint is saved as (JAX: .msgpack, .orbax)."""
        return stem + (".dcp" if self.cfg.sharded_checkpoints else ".pt")

    def save_model(self, name: str) -> None:
        """Rank 0 writes the state every rank holds, with every rank's
        dropout generator state (gathered on all ranks first); with sharded
        checkpoints every rank writes its pieces into the directory `name`
        (collective: every rank calls this)."""
        rank_generators = None
        if self.mesh is not None:
            gen = self.state.generator.get_state().to(self.device)
            rank_generators = collectives.gather_rows(gen[None], self.mesh).cpu()
        if self.cfg.sharded_checkpoints:
            ckpt.save_checkpoint_sharded(self.results_folder / name, self.state, self.mesh,
                                         rank_generators=rank_generators)
        elif self.is_main:
            ckpt.save_checkpoint(self.results_folder / name, self.state,
                                 rank_generators=rank_generators)
        if not self.is_main:
            return
        (self.results_folder / "architecture.json").write_text(
            json.dumps({"model_cfg": repr(self.model_cfg), "train_cfg": repr(self.cfg)},
                       indent=2))
        # the position sidecar, stamped with the checkpoint's step
        # (trainer.py:416-428): atomic, and detectably stale after a crash
        # between the two renames
        pos_path = self.results_folder / (name + ".pos.json")
        tmp = pos_path.with_name(pos_path.name + ".tmp")
        tmp.write_text(json.dumps({**self._pos, "global_step": int(self.state.step)}))
        tmp.replace(pos_path)

    def load_model(self, path, blob=None) -> None:
        """Every rank reads the checkpoint (or takes `blob`, the file's
        contents already read); a directory is a sharded checkpoint, read
        collectively, each rank its own slices (of any world's save). The
        position sidecar is rank 0's view, broadcast (trainer.py:430-453),
        so every rank resumes at the same batch."""
        pos_path = Path(str(path) + ".pos.json")
        pos = json.loads(pos_path.read_text()) if self.is_main and pos_path.exists() else None
        if self.mesh is not None:
            raw = collectives.broadcast_bytes(json.dumps(pos).encode(), self.mesh)
            pos = json.loads(raw.decode())
        if blob is None and ckpt.sharded_dir(path) is not None:
            ckpt.load_checkpoint_sharded(path, self.state, self.mesh)
        else:
            ckpt.load_checkpoint(path, self.state,
                                 rank=self.mesh.rank if self.mesh is not None else None,
                                 blob=blob)
        step = int(self.state.step)
        if pos is not None and pos.get("global_step") is not None \
                and int(pos["global_step"]) != step:
            # stale sidecar: re-derive the position from the step counter
            spe = pos.get("steps_per_epoch")
            if spe:
                pos = {"epoch": step // int(spe) + 1, "step_in_epoch": step % int(spe),
                       "steps_per_epoch": int(spe)}
                self.maybe_print(f"resume sidecar was stale (crash window); position "
                                 f"re-derived from step {step}")
            else:
                pos = None
        self._resume_pos = pos

    # -- loops --------------------------------------------------------------

    def evaluate(self, epoch: int) -> float:
        total, n = 0.0, 0
        _gather(self.state)
        for images, texts, *_ in self.valid_data:
            images, tokens = self._put_batch(images, texts)
            total += float(self.eval_step(self.state.model, images, tokens))
            n += 1
        _release(self.state)
        avg = total / max(n, 1)
        self.valid_losses.append(avg)
        self.maybe_print(f"Epoch {epoch} - Validation Loss: {avg:.4f}")
        if epoch == 0 or (avg < self.best_score and self.cfg.save_best_model):
            self.best_score = min(avg, self.best_score)
            self.save_model(self.checkpoint_name("best_checkpoint"))
        if self.is_main:
            try:
                metrics.plot_training_progress(self.train_losses, self.valid_losses,
                                               self.results_folder)
            except Exception as e:   # best effort, as in the JAX trainer (:513-517)
                print(f"plot skipped: {e}")
        return avg

    def _start(self, steps_per_epoch):
        """(first epoch, batches to skip in it) after a resume (trainer.py:540-569)."""
        resumed_step = int(self.state.step)
        start_epoch, skip = 1, 0
        if resumed_step and self._resume_pos:
            pos = self._resume_pos
            start_epoch = max(int(pos.get("epoch") or 1), 1)
            skip = int(pos.get("step_in_epoch") or 0)
            saved_spe = pos.get("steps_per_epoch")
            if saved_spe and steps_per_epoch and saved_spe != steps_per_epoch:
                self.maybe_print(f"steps_per_epoch changed ({saved_spe} -> {steps_per_epoch});"
                                 " falling back to epoch-level resume")
                skip = 0
            spe = steps_per_epoch or saved_spe
            if spe and skip >= spe:
                start_epoch, skip = start_epoch + 1, 0
            if start_epoch <= self.cfg.num_epochs:
                self.maybe_print(f"Resuming at step {resumed_step}: epoch {start_epoch}"
                                 + (f", batch {skip + 1}" if skip else ""))
        elif resumed_step and steps_per_epoch:
            done = min(resumed_step // steps_per_epoch, self.cfg.num_epochs)
            start_epoch = done + 1
            if done:
                self.maybe_print(f"Resuming at step {resumed_step}: skipping {done} completed "
                                 "epoch(s)")
        return start_epoch, skip

    def train(self) -> TrainState:
        self.maybe_print("Training started")
        start = time.time()
        try:
            steps_per_epoch = len(self.train_data)
            save_at = max(1, steps_per_epoch // self.cfg.num_save_split)
        except TypeError:   # unsized iterable: log every step
            steps_per_epoch, save_at = None, 1
        resumed_step = int(self.state.step)
        start_epoch, resume_skip = self._start(steps_per_epoch)
        for epoch in range(start_epoch, self.cfg.num_epochs + 1):
            skip = resume_skip if epoch == start_epoch else 0
            epoch_start = time.time()
            sampler = getattr(self.train_data, "sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            total_loss, steps = 0.0, 0
            if skip and self._resume_pos:
                total_loss = float(self._resume_pos.get("loss_sum") or 0.0)
                steps = int(self._resume_pos.get("loss_steps") or 0)
            pending = None   # (step, device loss), fetched one step late

            def log_step(step, loss):
                nonlocal total_loss, steps
                loss = float(loss)
                total_loss += loss
                steps += 1
                if step % save_at == 0:
                    self.train_losses["steps"].append(loss)
                self.maybe_print(f"Epoch {epoch} | Step {step} | Loss: {loss:.6f}")
                return loss

            if not skip:
                data_iter = self.train_data
            elif hasattr(self.train_data, "iter_from"):
                data_iter = self.train_data.iter_from(skip)
            else:
                data_iter = itertools.islice(iter(self.train_data), skip, None)
            for step, (images, texts, *_) in enumerate(data_iter, start=skip + 1):
                self._pos = {"epoch": epoch, "step_in_epoch": step,
                             "steps_per_epoch": steps_per_epoch}
                # the profiler window: steps [2, 2 + profile_steps) of epoch 1
                if self.cfg.profile_steps > 0 and epoch == 1 and self.is_main:
                    if step == 2:
                        self._start_trace()
                    elif step == 2 + self.cfg.profile_steps:
                        self._stop_trace()
                images, tokens = self._put_batch(images, texts)
                loss = self.train_step(self.state, images, tokens)
                if epoch == 1 and step == 1 and resumed_step == 0:
                    l0 = log_step(1, loss)
                    self.train_losses["epochs"].append(l0)
                    if 1 % save_at != 0:
                        self.train_losses["steps"].append(l0)
                    self.evaluate(0)   # step-0 bootstrap eval (reference :278-281)
                    continue
                # the previous step's loss is read after this step is queued
                if pending is not None:
                    log_step(*pending)
                pending = (step, loss)
                if self.cfg.save_every_steps and self.state.step % self.cfg.save_every_steps == 0:
                    log_step(*pending)
                    pending = None
                    self._pos = {**self._pos, "loss_sum": total_loss, "loss_steps": steps}
                    self.save_model(self.checkpoint_name("last_checkpoint"))
            if pending is not None:
                log_step(*pending)
            self._stop_trace()   # an epoch shorter than the window
            self._pos = {"epoch": epoch + 1, "step_in_epoch": 0,
                         "steps_per_epoch": steps_per_epoch}
            avg = total_loss / max(steps, 1)
            self.train_losses["epochs"].append(avg)
            self.maybe_print(f"Epoch {epoch} done. Avg loss {avg:.6f} "
                             f"({time.time() - epoch_start:.1f}s)")
            self.evaluate(epoch)
        self.maybe_print(f"Training completed in {time.time() - start:.1f}s")
        return self.state
