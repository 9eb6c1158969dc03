"""The data axis's placement rules: replicated or fully sharded state,
row-sharded batches, averaged gradients.

Counterpart of the data-axis half of ct_clip_ut_tpu/parallel/sharding.py.
Under GSPMD the JAX package states placements and XLA inserts the
collectives. Here, in data parallelism, each rank holds a full replica of
the parameters and the optimizer state (`broadcast_state` makes them rank
0's at the start), its own rows of each global batch (`shard_host_batch`,
`local_rows`), and averages its gradients with the other ranks' before
the clip and the update (`allreduce_grads`), so every rank takes the same
step and holds the same bits after it.

FSDP (ZeRO-3 at rest: parameters, gradients and Adam's moments sharded,
JAX sharding.py:59-103 and config.py:340-345) is written by hand on the
collectives' all_reduce (`collectives.gather_flat`; `allreduce_grads` as
the reduce-scatter), because the port reads its weights straight off the
modules (no forward hook would fire):
`shard_state` cuts each parameter of at least `_FSDP_MIN_SIZE` elements
into flat pieces, `torch.chunk(flat, world)`'s (a piece may be empty), and
frees its storage; smaller leaves stay replicated. A step then runs
`gather_params` (every sharded parameter whole again) -> forward and
backward -> `reduce_grads` (each piece the mean of its gradient slice,
the replicated leaves averaged, every leaf's norm for the clip) -> the
optimizer on the pieces -> `release_params`, so that between steps a rank
holds only its pieces, and every step is the data-parallel step's bits.
The parameters are gathered whole for the step, not layer by layer: the
memory at rest falls by the world, the step's peak does not.

Where JAX puts the data axis on a leaf's largest free dim when the world
divides it, the flat chunks need no divisibility: the sharded set is JAX's
but for the leaves tests/test_torch_port_fsdp.py lists. The VQ codebook is
buffers in the port, not parameters: it stays replicated, its EMA summed
over the ranks as in data parallelism. At a world of 1 a sharded leaf's
one piece is the whole leaf (JAX leaves it in place), so the same hooks
run on one rank. The tensor-parallel rules are not ported (ROADMAP Queue
1 item 11c).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import collectives
from .collectives import _live, broadcast

# gradient buckets of at most this many bytes, filled in parameter order
BUCKET_BYTES = 32 * 2 ** 20
# Leaves smaller than this stay replicated under FSDP (JAX sharding.py:59-61):
# a module global, not a default argument, so that tests can lower it
_FSDP_MIN_SIZE = 2 ** 15


@torch.no_grad()
def broadcast_state(model: torch.nn.Module, optimizer, mesh) -> None:
    """Rank 0's parameters, buffers (the VQ codebook) and optimizer moments
    on every rank, in place, in their registration order."""
    tensors = [*model.parameters(), *model.buffers()]
    if optimizer is not None:
        tensors += [*optimizer.mu, *optimizer.nu]
    for t in tensors:
        broadcast(t.data, mesh)


def shard_host_batch(batch, mesh, device=None):
    """This rank's rows of a global host batch (rank r takes rows [r b, (r +
    1) b) of world * b), on `device` (the mesh's by default): a tensor, a
    numpy array, or a dict of them (tokenised text)."""
    device = mesh.device if device is None else device
    if isinstance(batch, dict):
        return {k: shard_host_batch(v, mesh, device) for k, v in batch.items()}
    b = batch.shape[0] // mesh.world
    if b * mesh.world != batch.shape[0]:
        raise ValueError(f"global batch {batch.shape[0]} not divisible by data={mesh.world}")
    rows = batch[mesh.rank * b:(mesh.rank + 1) * b]
    return torch.as_tensor(np.asarray(rows) if isinstance(rows, np.ndarray) else rows,
                           device=device)


def local_rows(x, mesh):
    """This rank's rows of a global [world * b, ...] array gathered in rank
    order (the inverse of `collectives.gather_rows`)."""
    b = x.shape[0] // mesh.world
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def _buckets(grads: Sequence[torch.Tensor], numels: Optional[Sequence[int]] = None
             ) -> Iterable[list]:
    """Consecutive runs of gradients of one dtype and device, each at most
    BUCKET_BYTES (a larger gradient is a bucket of its own). `numels`, where
    given, sizes each entry instead of its own numel (a piece of a leaf is
    bucketed as its whole leaf)."""
    bucket, size = [], 0
    for i, g in enumerate(grads):
        nbytes = (g.numel() if numels is None else numels[i]) * g.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or g.dtype != bucket[0].dtype
                       or g.device != bucket[0].device):
            yield bucket
            bucket, size = [], 0
        bucket.append(g)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def allreduce_grads(params: Sequence[torch.nn.Parameter], mesh) -> None:
    """Every parameter's .grad replaced by its mean over the ranks (a None
    gradient counts as zeros, as the optimizer reads it), bucket by bucket
    in parameter order: the same order, and so the same bits, on every
    rank."""
    params = list(params)
    for p in params:
        p.grad = torch.zeros_like(p) if p.grad is None else p.grad.contiguous()
    if not _live(mesh):
        return
    for bucket in _buckets([p.grad for p in params]):
        flat = torch.cat([g.reshape(-1) for g in bucket]) if len(bucket) > 1 \
            else bucket[0].reshape(-1)
        torch.distributed.all_reduce(flat)
        flat.div_(mesh.world)
        if len(bucket) > 1:
            off = 0
            for g in bucket:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()


def shard_loader(data, mesh) -> None:
    """Give a loader whose `sampler` is a one-shard ShardedSampler
    (data/loader.py) this rank's shard: num_shards = world, shard_index =
    rank (the DistributedSampler of the reference). A sampler already
    sharded must match the mesh; any other iterable is left as it is."""
    sampler = getattr(data, "sampler", None)
    if sampler is None or not hasattr(sampler, "num_shards") or mesh.world == 1:
        return
    if sampler.num_shards == 1:
        sampler.num_shards, sampler.shard_index = mesh.world, mesh.rank
    elif (sampler.num_shards, sampler.shard_index) != (mesh.world, mesh.rank):
        raise ValueError(f"the loader's sampler takes shard {sampler.shard_index} of "
                         f"{sampler.num_shards}; this rank is {mesh.rank} of {mesh.world}")


# ---- FSDP ------------------------------------------------------------------------

def chunk_span(numel: int, world: int, rank: int) -> Tuple[int, int]:
    """(lo, hi): rank's piece of a flat leaf of `numel` elements as
    torch.chunk(flat, world) cuts it (and DTensor's Shard(0)): pieces of
    ceil(numel / world), the last ones shorter or empty."""
    size = -(-numel // world)
    lo = min(rank * size, numel)
    return lo, min(lo + size, numel)


def fsdp_sharded(shape) -> bool:
    """Whether FSDP shards a leaf of this shape: at least _FSDP_MIN_SIZE
    elements."""
    return int(np.prod(tuple(shape), dtype=np.int64)) >= _FSDP_MIN_SIZE


def check_fsdp_mesh(mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Raise where FSDP cannot run as asked: a process group whose backend
    is not gloo or NCCL, NCCL over a mesh off the card, or a tensor on
    another device than the mesh's. Nothing falls back to data parallelism."""
    if dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"FSDP runs over gloo or NCCL, not {backend}")
        if backend == "nccl" and mesh.device.type != "cuda":
            raise ValueError(f"FSDP over NCCL needs a mesh on the card, got {mesh.device}")
    for t in tensors:
        if t.device != mesh.device:
            raise ValueError(f"FSDP over a mesh on {mesh.device} got a tensor on {t.device}")


@dataclass
class FsdpLayout:
    """Which of `params` (the model's, in order) are sharded over `mesh`,
    and this rank's piece of each: spans[i] (lo, hi) of the flat leaf, or
    None for a replicated leaf; pieces[i] the 1-D piece (None likewise),
    the tensor the optimizer updates; shapes[i] the leaf's full shape."""
    mesh: object
    params: List[torch.nn.Parameter]
    spans: List[Optional[Tuple[int, int]]]
    shapes: List[torch.Size]
    pieces: List[Optional[torch.Tensor]] = field(default_factory=list)

    @property
    def leaves(self) -> list:
        """What the optimizer holds: each sharded leaf's piece, each
        replicated leaf's parameter."""
        return [p if s is None else q for p, s, q in zip(self.params, self.spans, self.pieces)]

    @property
    def sharded(self) -> List[bool]:
        return [s is not None for s in self.spans]

    def numel(self, i: int) -> int:
        return int(np.prod(tuple(self.shapes[i]), dtype=np.int64))

    def piece_of(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of leaf i's full tensor (a copy)."""
        lo, hi = self.spans[i]
        return full.reshape(-1)[lo:hi].clone()

    def whole(self, i: int, piece: torch.Tensor) -> torch.Tensor:
        """Leaf i in its full shape from this rank's piece: only where the
        piece is the whole leaf (a world of 1); over more ranks raises
        (the sharded checkpoint saves the pieces)."""
        if self.mesh.world != 1:
            raise ValueError(f"leaf {i} is sharded over {self.mesh.world} ranks: no rank holds "
                             "it whole (sharded checkpoints save the pieces)")
        return piece.reshape(self.shapes[i])


def layout_of(params: Sequence[torch.nn.Parameter], mesh) -> FsdpLayout:
    """The FSDP layout of `params` over `mesh` (no tensor moved yet)."""
    params = list(params)
    shapes = [p.shape for p in params]
    spans = [chunk_span(p.numel(), mesh.world, mesh.rank) if fsdp_sharded(p.shape) else None
             for p in params]
    return FsdpLayout(mesh=mesh, params=params, spans=spans, shapes=shapes)


@torch.no_grad()
def shard_state(model: torch.nn.Module, optimizer, mesh) -> FsdpLayout:
    """Shard `model`'s parameters and `optimizer`'s moments over `mesh`
    in place (after `broadcast_state`: every rank holds rank 0's state):
    each rank keeps its piece of each sharded leaf and frees the rest; the
    optimizer is carried onto the pieces (`Optimizer.shard`). Returns the
    layout the step hooks take."""
    params = list(model.parameters())
    check_fsdp_mesh(mesh, params)
    layout = layout_of(params, mesh)
    layout.pieces = [None if s is None else layout.piece_of(i, p)
                     for i, (p, s) in enumerate(zip(params, layout.spans))]
    if optimizer is not None:
        optimizer.shard(layout)
    release_params(layout)
    return layout


@torch.no_grad()
def gather_params(layout: FsdpLayout) -> None:
    """Every sharded parameter whole again, from every rank's pieces, in
    parameter-order buckets of at most BUCKET_BYTES (`gather_flat`): each
    element the bits of the rank that holds it."""
    idx = [i for i, s in enumerate(layout.spans) if s is not None]
    at = 0
    for bucket in _buckets([layout.pieces[i] for i in idx], [layout.numel(i) for i in idx]):
        ids = idx[at:at + len(bucket)]
        at += len(bucket)
        offs = np.cumsum([0] + [layout.numel(i) for i in ids]).tolist()
        spans = [(off + layout.spans[i][0], off + layout.spans[i][1])
                 for off, i in zip(offs, ids)]
        flat = collectives.gather_flat(bucket, spans, offs[-1], layout.mesh, bucket[0])
        for off, i in zip(offs, ids):
            p = layout.params[i]
            full = flat[off:off + layout.numel(i)]
            # a storage of its own (from its start) unless the bucket is this leaf alone
            p.data = full.view(layout.shapes[i]) if len(ids) == 1 else \
                full.reshape(layout.shapes[i]).clone()


@torch.no_grad()
def release_params(layout: FsdpLayout) -> None:
    """Free every sharded parameter's full storage and gradient: between
    steps a rank holds its pieces alone."""
    for p, s in zip(layout.params, layout.spans):
        if s is not None:
            p.data = p.data.new_empty((0,))
            p.grad = None


@torch.no_grad()
def reduce_grads(layout: FsdpLayout) -> list:
    """Each sharded leaf's piece given the mean over the ranks of its
    gradient slice (.grad of the piece; the full gradient freed), each
    replicated leaf's .grad its mean; returns every leaf's gradient norm
    (device scalars, parameter order) for the optimizer's clip. The mean
    is data parallelism's (`allreduce_grads`: the same buckets, the same
    bits) and the norms are taken over the whole leaves as its clip takes
    them, so the FSDP step is the data-parallel step bit for bit; each
    rank then keeps its pieces. (Pieces' squared norms summed over the
    ranks would move the clip factor by a last bit, which Adam turns into
    lr-sized flips where a first moment cancels.)"""
    allreduce_grads(layout.params, layout.mesh)
    norms = torch._foreach_norm([p.grad for p in layout.params])
    for i, (p, s) in enumerate(zip(layout.params, layout.spans)):
        if s is not None:
            layout.pieces[i].grad = layout.piece_of(i, p.grad)
            p.grad = None
    return norms
