"""Checkpoints of the train state: a single file, or a sharded directory.

Counterpart of ct_clip_ut_tpu/train/checkpoint.py. The single file holds
the model's state dict (parameters and buffers, the VQ codebook
included), the optimizer's moments and update count, the global step and
the dropout generator's state, so a resumed run continues bit for bit.
Writes are atomic (a temporary file beside the target, then os.replace):
a crash mid-write leaves the previous checkpoint intact. A data-parallel
run's file also holds every rank's generator state. The reference's
checkpoints go through convert.py (`load_ctclip` reads this module's files
too). An FSDP state (parallel/sharding.py) is written whole only at a
world of 1; it loads from a file at any world, each rank keeping its
pieces.

The sharded checkpoint (`save_checkpoint_sharded`, the orbax path of JAX
:63-104) is a directory written collectively through
torch.distributed.checkpoint (DCP): every rank calls it and writes its own
pieces, so no rank ever holds the whole state. Each parameter and Adam
moment is saved flat, 1-D: an FSDP piece as a Shard(0) DTensor view of
its flat leaf, a replicated leaf as a plain tensor (DCP writes one copy).
Beside them: the buffers, the step, the optimizer's count and every rank's
generator state ([world, n]). The directory is written as a sibling
`<name>.tmp` and renamed into place once every rank has written; a
directory cannot replace another in one rename, so the previous one is
first moved to `<name>.old`, and a crash between the two renames leaves
only that: `sharded_dir` (and so the load) then reads `<name>.old`. It loads
into another layout or world size with the same bits (DCP reads each
rank's slices): an FSDP run over 2 ranks into one process, a one-process
checkpoint onto 2 FSDP ranks, either into a replicated state. A rank past
the saved world keeps its own generator, seeded from (seed, rank).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel import collectives
from ..parallel.mesh import DataMesh


def _full_states(state) -> tuple:
    """(the model's state dict, the optimizer's) with every parameter and
    moment in its full shape: an FSDP state's pieces are whole only at a
    world of 1 (FsdpLayout.whole raises over more ranks)."""
    model_sd, opt_sd = state.model.state_dict(), state.optimizer.state_dict()
    layout = getattr(state, "fsdp", None)
    if layout is None:
        return model_sd, opt_sd
    names = [n for n, _ in state.model.named_parameters()]
    for i, (n, s) in enumerate(zip(names, layout.spans)):
        if s is not None:
            model_sd[n] = layout.whole(i, layout.pieces[i])
    opt_sd = {**opt_sd, **{k: [m if s is None else layout.whole(i, m)
                               for i, (m, s) in enumerate(zip(opt_sd[k], layout.spans))]
                           for k in ("mu", "nu")}}
    return model_sd, opt_sd


def save_checkpoint(path, state, rank_generators=None) -> None:
    """Write `state` (a trainer.TrainState) to `path` atomically; a
    data-parallel run adds every rank's dropout generator state
    (`rank_generators` [world, n] uint8)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    model_sd, opt_sd = _full_states(state)
    blob = {"model": model_sd, "optimizer": opt_sd,
            "step": int(state.step), "generator": state.generator.get_state()}
    if rank_generators is not None:
        blob["rank_generators"] = rank_generators
    torch.save(blob, tmp)
    os.replace(tmp, path)


@torch.no_grad()
def load_checkpoint(path, state, rank=None, blob=None):
    """Load `path` (or `blob`, its contents already read) into `state` in
    place (its tensors keep their devices); returns it. A data-parallel
    `rank` takes its own generator state where the file holds every
    rank's; an FSDP rank keeps its pieces of the file's whole leaves."""
    if blob is None:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    layout = getattr(state, "fsdp", None)
    model_sd, opt_sd = blob["model"], blob["optimizer"]
    if layout is not None:
        names = [n for n, _ in state.model.named_parameters()]
        sharded = {n: i for i, (n, s) in enumerate(zip(names, layout.spans)) if s is not None}
        for n, i in sharded.items():
            layout.pieces[i].copy_(layout.piece_of(i, model_sd[n]))
        model_sd = {k: v for k, v in model_sd.items() if k not in sharded}
        opt_sd = {**opt_sd, **{k: [m if s is None else layout.piece_of(i, m)
                                   for i, (m, s) in enumerate(zip(opt_sd[k], layout.spans))]
                               for k in ("mu", "nu")}}
        missing, unexpected = state.model.load_state_dict(model_sd, strict=False)
        if unexpected or set(missing) != set(sharded):
            raise RuntimeError(f"checkpoint {path}: missing {sorted(set(missing) - set(sharded))}"
                               f", unexpected {unexpected}")
    else:
        state.model.load_state_dict(model_sd, strict=True)
    state.optimizer.load_state_dict(opt_sd)
    state.step = int(blob["step"])
    gens = blob.get("rank_generators")
    # a row of its own (clone): set_state reads a view's storage from its start
    state.generator.set_state(gens[rank].clone() if rank is not None and gens is not None
                              else blob["generator"])
    return state


# ---- sharded (a directory, written by every rank) ---------------------------------

def _flat_entries(state, mesh) -> dict:
    """DCP's state dict of `state` on this rank: key -> (the tensor this
    rank holds, flat for a parameter or moment; the leaf's numel, or None
    for a buffer)."""
    layout = getattr(state, "fsdp", None)
    opt = state.optimizer
    out = {}
    params = list(state.model.named_parameters())
    for i, (n, p) in enumerate(params):
        span = None if layout is None else layout.spans[i]
        held = [p if span is None else layout.pieces[i], opt.mu[i], opt.nu[i]]
        numel = p.numel() if span is None else layout.numel(i)
        for key, t in zip((f"model.{n}", f"mu.{n}", f"nu.{n}"), held):
            out[key] = (t.reshape(-1), numel, span)
    for n, b in state.model.named_buffers():
        out[f"buffer.{n}"] = (b, None, None)
    return out


def _dcp_tensor(t: torch.Tensor, numel, span, mesh, device_mesh):
    """A piece as a Shard(0) DTensor view of its flat leaf (over more than
    one rank), anything else as a plain tensor (replicated: DCP writes one
    copy); on the host under gloo, on the card under NCCL."""
    dev = "cpu" if device_mesh is None or device_mesh.device_type == "cpu" else t.device
    t = t.detach().to(dev)
    if span is None or mesh.world == 1:
        return t
    from torch.distributed.tensor import DTensor, Shard
    return DTensor.from_local(t, device_mesh, [Shard(0)], shape=(numel,), stride=(1,),
                              run_check=False)


def _device_mesh(mesh):
    """The 1-D DeviceMesh of the process group for DCP's DTensors (None
    without one, or over one rank): the host's under gloo, the card's
    under NCCL."""
    if mesh.world == 1 or not _group_up():
        return None
    from torch.distributed.device_mesh import DeviceMesh
    kind = "cpu" if dist.get_backend() == "gloo" else mesh.device.type
    return DeviceMesh(kind, list(range(mesh.world)))


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def _barrier(mesh) -> None:
    """Every rank here before any goes on (an all_reduce: the collectives'
    rule)."""
    collectives.psum(torch.zeros(1, device=mesh.device), mesh)


def _mesh_of(state, mesh):
    """`mesh`, or one rank without a process group on the state's device."""
    return mesh if mesh is not None else DataMesh(1, 0, state.model.temperature.device)


def sharded_dir(path) -> Optional[Path]:
    """The directory a sharded checkpoint at `path` is read from: `path`
    itself, or `<path>.old` where a save was cut between its two renames
    (the previous checkpoint, whole); None where `path` is a file or
    neither exists."""
    path = Path(path).absolute()
    if path.exists():
        return path if path.is_dir() else None
    old = path.with_name(path.name + ".old")
    return old if old.is_dir() else None


def save_checkpoint_sharded(path, state, mesh=None, rank_generators=None) -> None:
    """Write `state` as the directory `path`, collectively: every rank of
    `mesh` calls this and writes its pieces (a replicated leaf once). The
    write goes to `<path>.tmp`, renamed into place by rank 0 once every
    rank has written; a previous directory is replaced in two renames
    (kept as `<path>.old` between them, which `sharded_dir` reads if the
    second never happens). `rank_generators` [world, n]
    uint8 is every rank's dropout generator state (the same on every
    rank); without it, this process's own."""
    import torch.distributed.checkpoint as dcp

    mesh = _mesh_of(state, mesh)
    path = Path(path).absolute()
    tmp, old = path.with_name(path.name + ".tmp"), path.with_name(path.name + ".old")
    if mesh.is_main:
        path.parent.mkdir(parents=True, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
    _barrier(mesh)
    device_mesh = _device_mesh(mesh)
    gens = (state.generator.get_state()[None] if rank_generators is None
            else rank_generators).cpu()
    sd = {key: _dcp_tensor(t, numel, span, mesh, device_mesh)
          for key, (t, numel, span) in _flat_entries(state, mesh).items()}
    sd.update(step=int(state.step), count=int(state.optimizer.count), rank_generators=gens)
    dcp.save(sd, checkpoint_id=str(tmp), no_dist=not _group_up())
    _barrier(mesh)
    if mesh.is_main:
        if path.exists():
            shutil.rmtree(old, ignore_errors=True)  # a cut save's, older than `path`
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    _barrier(mesh)


@torch.no_grad()
def load_checkpoint_sharded(path, state, mesh=None):
    """Load the directory `path` (save_checkpoint_sharded's, of any world
    and layout) into `state` in place, collectively: each rank reads only
    the slices it holds; `<path>.old` where a save was cut between its
    renames (`sharded_dir`). Returns `state`."""
    import torch.distributed.checkpoint as dcp

    mesh = _mesh_of(state, mesh)
    found = sharded_dir(path)
    if found is None:
        raise FileNotFoundError(f"no sharded checkpoint directory at {path} (nor {path}.old)")
    path = found
    device_mesh = _device_mesh(mesh)
    entries = _flat_entries(state, mesh)
    sd = {key: _dcp_tensor(torch.empty_like(t), numel, span, mesh, device_mesh)
          for key, (t, numel, span) in entries.items()}
    saved = dcp.FileSystemReader(str(path)).read_metadata().state_dict_metadata
    sd.update(step=0, count=0, rank_generators=torch.zeros(
        tuple(saved["rank_generators"].size), dtype=torch.uint8))
    dcp.load(sd, checkpoint_id=str(path), no_dist=not _group_up())
    for key, (t, _, _) in entries.items():
        got = sd[key]
        t.copy_((got.to_local() if hasattr(got, "to_local") else got).reshape(t.shape))
    state.step = int(sd["step"])
    state.optimizer.count = int(sd["count"])
    gens = sd["rank_generators"]
    if mesh.rank < gens.shape[0]:
        state.generator.set_state(gens[mesh.rank].clone())
    return state
