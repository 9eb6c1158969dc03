"""Process-group bring-up and the data-axis mesh.

Counterpart of ct_clip_ut_tpu/parallel/mesh.py. The JAX package wires its
hosts with `jax.distributed.initialize` and lays its devices out as a
("data", "model") `Mesh`; here one process drives one card (or one CPU
rank), `torch.distributed` joins the processes, and a `DataMesh` is the
handle the trainer, zero-shot scoring and the occlusion sweep take: the
world size along the data axis, this process's rank and its device (the
collectives run over the default process group). The tensor-parallel
model axis is not ported: a model axis above 1 raises with its ROADMAP
item.

`initialize_runtime` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or takes an explicit address, rank
and world size. The backend is NCCL for ranks on CUDA devices and gloo for
ranks on the CPU unless the caller names one (two ranks sharing one card
need gloo: NCCL refuses two ranks on one device); nothing here swaps a
backend for another on its own.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from .. import _build
from ..config import MeshConfig

TIMEOUT = timedelta(minutes=30)


def check_model_axis(model: int) -> None:
    """Raise for a tensor-parallel axis above 1 (not ported)."""
    if model != 1:
        raise NotImplementedError(
            f"a model (tensor-parallel) mesh axis of {model}: only the data axis is ported "
            "(ROADMAP Queue 1 item 11c: the tensor-parallel model axis)")


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_runtime(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, *, device="cuda",
                       backend: Optional[str] = None) -> bool:
    """Join the process group; returns whether one is up afterwards.

    With every argument None the group comes from torchrun's environment
    (init_method env://); without WORLD_SIZE there, or with
    num_processes == 1 and no address, this is a no-op, as in the JAX
    package. An explicit `coordinator_address` ("host:port" or a tcp://
    URL) needs num_processes and process_id, and forms the group even for
    one process (a one-rank group runs every collective of the data path).
    `device` picks the default backend; `backend` overrides it. Under NCCL
    the card `cuda:LOCAL_RANK` (the rank without torchrun) is made current
    first, and a rank without a card of its own raises: this is the one
    place that puts ranks on cards (make_mesh takes the current card). A
    group already up is left as it is."""
    if dist.is_initialized():
        return True
    if num_processes == 1 and coordinator_address is None:
        return False
    if coordinator_address is None and num_processes is None and process_id is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        init_method, world, rank = "env://", None, None
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("an explicit process group needs coordinator_address, "
                             "num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    backend = backend or default_backend(device)
    if backend == "nccl":
        card = int(os.environ.get("LOCAL_RANK", rank or 0))
        if card >= torch.cuda.device_count():
            raise ValueError(f"rank {card} on this host has no card of its own "
                             f"({torch.cuda.device_count()} visible): NCCL takes one rank "
                             "a card")
        torch.cuda.set_device(card)
    kw = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group(backend=backend, init_method=init_method, timeout=TIMEOUT, **kw)
    return True


def shutdown_runtime() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclass(frozen=True)
class DataMesh:
    """The data axis: `world` ranks (the default process group), this
    process `rank` and this rank's `device`."""
    world: int
    rank: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        """Rank 0: the reference's main process, which writes checkpoints,
        logs and maps."""
        return self.rank == 0


def check_mesh(mesh) -> Optional[DataMesh]:
    """`mesh` itself, None or a DataMesh; anything else raises."""
    if mesh is not None and not isinstance(mesh, DataMesh):
        raise TypeError(f"mesh must be a parallel.mesh.DataMesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh


def make_mesh(cfg: Optional[MeshConfig] = None, device=None) -> DataMesh:
    """The data-axis mesh over the process group (one rank, this process,
    without one). cfg.data, where set, must equal the group's size; a model
    axis above 1 raises. `device` defaults to the current card (the one
    initialize_runtime made current: `cuda:LOCAL_RANK` under NCCL), as does
    "cuda" without an index; on a machine without a card both raise, as the
    entry points do. Only device="cpu" gives a CPU mesh."""
    if cfg is not None:
        check_model_axis(cfg.model)
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    if cfg is not None and cfg.data != world:
        raise ValueError(f"mesh data={cfg.data} needs {cfg.data} processes, have {world}")
    dev = _build.check_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return DataMesh(world=world, rank=rank, device=dev)


def make_cli_mesh(args) -> Optional[DataMesh]:
    """The data-axis mesh of the entry points' --multihost / --num-processes
    / --coordinator-address / --process-id / --mesh-data (and --mesh-model,
    where a parser has it), or None for a one-process run without mesh
    flags (scripts/train_ctclip.py:99-110 in the JAX package). The process
    group comes up first; its ranks lie on `cuda:LOCAL_RANK` (the CPU with
    --device cpu)."""
    check_model_axis(getattr(args, "mesh_model", 1))
    explicit = args.coordinator_address is not None or args.process_id is not None
    if args.multihost or (args.num_processes or 0) > 1 or explicit:
        initialize_runtime(args.coordinator_address, args.num_processes, args.process_id,
                           device=args.device)
    elif args.mesh_data is None:
        return None
    mesh = make_mesh(None, device=args.device)
    if args.mesh_data is not None and args.mesh_data != mesh.world:
        raise ValueError(f"--mesh-data {args.mesh_data} needs {args.mesh_data} processes, "
                         f"have {mesh.world} (start them with torchrun --nproc-per-node)")
    return mesh


def local_batch_size(global_batch: int, mesh: DataMesh) -> int:
    """The rows each rank takes of a global batch (which the data axis must divide)."""
    if global_batch % mesh.world:
        raise ValueError(f"global batch {global_batch} not divisible by data={mesh.world}")
    return global_batch // mesh.world
