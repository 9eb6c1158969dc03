"""Collectives over the data axis.

Counterpart of ct_clip_ut_tpu/parallel/collectives.py, over a
`DataMesh` (parallel/mesh.py) instead of a shard_map axis name. They
replace the reference's raw torch.distributed call sites: its
GatherWithGrad (reference ctclip.py:10-41) is `all_gather`, the SUM reduce
of occlusion heatmaps is `psum`, gather_for_metrics is `gather_rows`.

Every collective here is an `all_reduce` or a `broadcast`, the two that
every backend takes on CUDA tensors (gloo takes no CUDA all_gather), so
the same code runs two ranks sharing one card over gloo, ranks on their
own cards over NCCL, and CPU ranks over gloo. An all-gather is an
all_reduce of a zero-filled [world * b, ...] buffer holding this rank's
rows: x + 0 = x, so the gathered rows are each rank's bits (a -0.0 comes
back +0.0). A mesh of one rank without a process group makes each of them
the identity.

FSDP's collectives take the same route: its gather (`gather_flat`) is the
all_reduce of a zero-filled flat buffer holding this rank's pieces, its
reduce-scatter the data-parallel all_reduce of the whole gradient
(sharding.allreduce_grads), divided by the world, of which each rank
keeps its pieces (sharding.reduce_grads). Both move world x the bytes of
a true all-gather or reduce-scatter (every rank sends and receives the
whole buffer); NCCL's own `all_gather_into_tensor` /
`reduce_scatter_tensor` would move 1 / world of it, and wait for a
measurement across cards (ROADMAP "Across cards"): the card's machine
has one.

The gradient convention of `all_gather` is the reference's: its backward
sums the cotangent over the ranks and hands each rank its own rows of the
sum. Every rank computes the same loss from the same gathered matrix, so
rank r receives world x d loss / d (its rows); the trainer then averages
the parameter gradients over the ranks (parallel/sharding.allreduce_grads),
which gives exactly the global-batch gradient, the temperature's (the same
on every rank) included. Summing the gradients instead would give world
times it, and a backward that only slices would give it over world.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the bytes `broadcast_bytes` carries at most
BYTES_WIDTH = 1024


def _live(mesh) -> bool:
    """Whether collectives run: a process group is up (a mesh of one rank
    without one makes every collective the identity)."""
    if dist.is_available() and dist.is_initialized():
        return True
    if mesh.world != 1:
        raise RuntimeError(f"a mesh of {mesh.world} ranks needs a process group "
                           "(parallel.mesh.initialize_runtime)")
    return False


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of x over the ranks (a new tensor; x is left as it is)."""
    out = x.detach().clone().contiguous()
    if _live(mesh):
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def pmean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of x over the ranks: the sum, divided by the world size."""
    return psum(x, mesh) / mesh.world


def axis_index(mesh) -> int:
    """This rank's index along the data axis."""
    return mesh.rank


def broadcast(x: torch.Tensor, mesh) -> torch.Tensor:
    """x as rank 0 holds it, on every rank, in place."""
    if _live(mesh):
        dist.broadcast(x, src=0)
    return x


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """[world * b, ...]: every rank's [b, ...] rows in rank order (b the
    same on every rank), without a gradient."""
    b = x.shape[0]
    out = x.new_zeros((mesh.world * b, *x.shape[1:]))
    out[mesh.rank * b:(mesh.rank + 1) * b] = x.detach()
    if _live(mesh):
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def gather_flat(pieces, spans, numel: int, mesh, like: torch.Tensor) -> torch.Tensor:
    """[numel]: a flat buffer (like's dtype and device) of which every rank
    holds the pieces at its own `spans` ((lo, hi) each, with `pieces` in
    the same order), whole on every rank. The spans of the ranks tile the
    buffer; each element is its holder's bits (a -0.0 comes back +0.0)."""
    out = like.new_zeros((numel,))
    for piece, (lo, hi) in zip(pieces, spans):
        out[lo:hi] = piece.reshape(-1)
    if _live(mesh):
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        b = grad.shape[0] // mesh.world
        g = psum(grad, mesh)
        return g[mesh.rank * b:(mesh.rank + 1) * b], None


def all_gather(x: torch.Tensor, mesh, axis: int = 0) -> torch.Tensor:
    """Tiled all-gather along `axis` (jax.lax.all_gather(tiled=True)) that
    carries a gradient: its backward sums the cotangent over the ranks and
    returns this rank's slice (see the module doc for why)."""
    moved = x.movedim(axis, 0).contiguous()
    return _AllGather.apply(moved, mesh).movedim(0, axis)


def shard_diag(sim: torch.Tensor, mesh, local_batch: int = 1) -> torch.Tensor:
    """This rank's entries of the global sim matrix's diagonal (the
    reference's sim[rank, rank], CTClipInference.py:173-174)."""
    i = mesh.rank * local_batch
    return torch.diagonal(sim[i:i + local_batch, i:i + local_batch])


def broadcast_bytes(raw: bytes, mesh) -> bytes:
    """Rank 0's bytes on every rank, through a fixed [BYTES_WIDTH] uint8
    buffer on the mesh's device (a run directory, a resume sidecar, a scan
    name). Longer input raises rather than being cut."""
    if len(raw) > BYTES_WIDTH:
        raise ValueError(f"{len(raw)} bytes do not fit the {BYTES_WIDTH}-byte broadcast buffer")
    buf = torch.zeros(BYTES_WIDTH + 4, dtype=torch.uint8, device=mesh.device)
    if mesh.rank == 0:
        buf[:4] = torch.tensor(list(len(raw).to_bytes(4, "little")), dtype=torch.uint8)
        if raw:
            buf[4:4 + len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    broadcast(buf, mesh)
    host = bytes(buf.cpu().tolist())
    n = int.from_bytes(host[:4], "little")
    return host[4:4 + n]
