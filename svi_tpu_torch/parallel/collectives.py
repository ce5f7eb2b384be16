"""The port's cross-rank operations: the counterparts of the JAX package's
`jax.lax.all_gather(tiled=True)`, `ppermute`, `psum` and `axis_index`, over
the process groups of a `mesh.Mesh`, with the transposes JAX's autodiff
gives where a path is trained. Everything in the port that crosses ranks
goes through this module.

  * `gather_seq`: a tiled all-gather whose consumers differ per rank (the
    sequence-parallel k and v; the tokens of the per-frame audio attention).
    Its backward is the transpose of the gather, a reduce-scatter (sum) of
    the gradient slices;
  * `gather_replicated`: a tiled all-gather whose result every rank then
    uses alike (a sharded output assembled for a replicated loss). Every
    rank holds the same gradient of it, so the backward keeps the rank's own
    slice and sums nothing;
  * `psum`: an all-reduce (sum) on forward paths only (tensor parallelism is
    inference, as in the JAX package); its backward raises;
  * `ppermute_next`: the ring's send to the next rank and receive from the
    previous one, forward only;
  * `all_reduce_`, `broadcast_`, `all_gather_tensors`, `all_gather_object`,
    `barrier`: the trainer's and the drivers' collectives, outside autograd.

Transport: on a gloo group CUDA tensors travel through pinned host memory
(gloo's collectives here take host tensors), chosen from the group's
backend, never by catching an error; NCCL takes them as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import MeshAxis


def _staged(t: torch.Tensor, axis: MeshAxis) -> bool:
    return axis.backend == "gloo" and t.is_cuda


def _to_wire(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    t = t.contiguous()
    if _staged(t, axis):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return t


def _from_wire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.device) if t.device != like.device else t


def _all_gather(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    wire = _to_wire(x, axis)
    parts = [torch.empty_like(wire) for _ in range(axis.size)]
    dist.all_gather(parts, wire, group=axis.group)
    return _from_wire(torch.cat(parts, dim=dim), x)


def _reduce_scatter(g: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """Sum of g over the axis's ranks, this rank's slice of it along dim."""
    shard = g.shape[dim] // axis.size
    if axis.backend == "nccl":
        src = g.movedim(dim, 0).contiguous()
        out = torch.empty((shard,) + src.shape[1:], dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, src, group=axis.group)
        return out.movedim(0, dim)
    total = all_reduce_(g.clone(), axis)  # gloo has no reduce-scatter
    return total.narrow(dim, axis.index * shard, shard).contiguous()


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), ctx.axis, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.shard = axis, dim, x.shape[dim]
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.shard, ctx.shard), None, None


def gather_seq(x: torch.Tensor, axis: MeshAxis, dim: int = 1) -> torch.Tensor:
    """`jax.lax.all_gather(x, axis, axis=dim, tiled=True)`, differentiable:
    the backward reduce-scatters (sums) the gradient."""
    return _GatherSeq.apply(x, axis, dim)


def gather_replicated(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """The tiled all-gather of a sharded result that every rank then uses in
    the same way (shard_map's out spec feeding a replicated computation): the
    backward keeps this rank's slice of the (equal) gradients."""
    return _GatherReplicated.apply(x, axis, dim)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("psum is on inference paths only (tensor parallelism is not "
                           "trained): it has no backward")


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """`jax.lax.psum(x, axis)` on a forward path; a backward through it raises."""
    return _Psum.apply(x, axis)


def ppermute_next(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """`jax.lax.ppermute` with perm j -> j + 1 (mod n): this rank's x goes to
    the next rank on the axis, the previous rank's comes back. Forward only."""
    if axis.size == 1:
        return x
    nxt = axis.ranks[(axis.index + 1) % axis.size]
    prv = axis.ranks[(axis.index - 1) % axis.size]
    wire = _to_wire(x, axis)
    recv = torch.empty_like(wire)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, wire, nxt, axis.group),
                                   dist.P2POp(dist.irecv, recv, prv, axis.group)])
    for r in reqs:
        r.wait()
    return _from_wire(recv, x)


def axis_index(axis: MeshAxis) -> int:
    """`jax.lax.axis_index`: this rank's coordinate on the axis."""
    return axis.index


def all_reduce_(t: torch.Tensor, axis: MeshAxis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of t over the axis (outside autograd); returns t."""
    wire = _to_wire(t, axis)
    dist.all_reduce(wire, op=op, group=axis.group)
    if wire is not t:
        t.copy_(wire)
    return t


def broadcast_(t: torch.Tensor, src_index: int, axis: MeshAxis) -> torch.Tensor:
    """In-place broadcast of t from the rank at src_index on the axis."""
    wire = _to_wire(t, axis)
    dist.broadcast(wire, src=axis.ranks[src_index], group=axis.group)
    if wire is not t:
        t.copy_(wire)
    return t


def all_gather_tensors(x: torch.Tensor, axis: MeshAxis, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather outside autograd (every rank's x, concatenated in
    axis order along dim)."""
    return _all_gather(x, axis, dim)


def all_gather_object(obj, axis: MeshAxis) -> list:
    """Every rank's picklable obj, in axis order."""
    out = [None] * axis.size
    dist.all_gather_object(out, obj, group=axis.group)
    return out


def barrier(axis: MeshAxis) -> None:
    """Every rank of the axis waits for the others."""
    dist.barrier(group=axis.group)

