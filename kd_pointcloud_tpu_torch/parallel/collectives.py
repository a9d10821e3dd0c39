"""The collectives behind the global-batch steps.

JAX's sharded step keeps single-device semantics over the global batch:
XLA's SPMD partitioner computes the same function. A step that averages
per-rank gradients of per-rank losses does not, wherever a term is not a
mean over rows (the hint losses sum over the batch, attentive imitation
multiplies two batch means, the padded loss divides by the global weight
sum) and in BatchNorm's statistics. So the steps evaluate the loss once, on
every rank, on the global view of what it reads (GatheredView: the rows of
every rank, gathered with autograd), take BatchNorm's moments over the
global rows (moments), and average the gradients over the ranks
(sync_grads).

Gradient scale: every rank computes the same global loss L, and each
collective's backward sums its cotangents over the ranks, so the backward
on each rank yields its share of the gradient of n * L; sync_grads divides
the sum over ranks by n, which leaves the gradient of L.

Every collective is a SUM all-reduce, which both NCCL and gloo take on
CUDA tensors (gloo has no all-gather or all-to-all for them): a gather
places each rank's rows in its slot of a zero tensor and sums, which is
exact (x + 0 == x). On a mesh of size 1 the gathers and moments are the
local ones, so a size-1 step computes what the single-device step does, bit
for bit; sync_grads still all-reduces over a group of one, which leaves the
gradients as they are.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Iterable

import torch
import torch.distributed as dist

from .mesh import Mesh


def _sum_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t (contiguous), summed over the ranks in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def _copy(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _sum_(mesh, _copy(t))

    @staticmethod
    def backward(ctx, g):
        return _sum_(ctx.mesh, _copy(g)), None


def _gathered(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of t: each rank's in its slot of a zero tensor,
    summed over the ranks."""
    full = t.new_zeros((mesh.size * t.shape[0],) + tuple(t.shape[1:]))
    full[mesh.rank * t.shape[0]:(mesh.rank + 1) * t.shape[0]] = t
    return _sum_(mesh, full)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh, ctx.rows = mesh, t.shape[0]
        return _gathered(mesh, t)

    @staticmethod
    def backward(ctx, g):
        r, b = ctx.mesh.rank, ctx.rows
        return _sum_(ctx.mesh, _copy(g))[r * b:(r + 1) * b], None


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the ranks; its backward sums the cotangents over
    the ranks."""
    if mesh.size == 1:
        return t
    return _AllReduceSum.apply(t, mesh)


def gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of t (leading axis), in rank order, on every rank;
    differentiable for floating tensors (the cotangent of this rank's
    slot, summed over the ranks)."""
    if mesh.size == 1:
        return t
    if t.is_floating_point() and torch.is_grad_enabled() and \
            t.requires_grad:
        return _GatherRows.apply(t, mesh)
    return _gathered(mesh, t.detach())


def gather_tree(mesh: Mesh, tree):
    """gather_rows over the tensors of nested dicts, lists and tuples;
    other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return gather_rows(mesh, tree)
    if isinstance(tree, Mapping):
        return {k: gather_tree(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(mesh, v) for v in tree)
    return tree


class GatheredView(Mapping):
    """A read-only view of a dict of this rank's rows (a model's outputs, a
    batch) whose entries are gathered over the mesh on first read: a loss
    evaluated on it is the loss of the global batch, and only what it reads
    is moved. Every rank must read the same keys in the same order, as a
    loss evaluated identically on every rank does."""

    def __init__(self, mesh: Mesh, local: Mapping):
        self._mesh, self._local, self._got = mesh, local, {}

    def __getitem__(self, key):
        if key not in self._got:
            self._got[key] = gather_tree(self._mesh, self._local[key])
        return self._got[key]

    def __iter__(self):
        return iter(self._local)

    def __len__(self):
        return len(self._local)


def global_view(mesh, local):
    """local itself off a mesh or on a mesh of one, else its GatheredView."""
    if mesh is None or mesh.size == 1:
        return local
    return GatheredView(mesh, local)


def moments(mesh: Mesh, flat: torch.Tensor):
    """(biased variance, mean) over the rows of flat (R, C) on every rank:
    the sum and the count, then the centred sum of squares (the two-pass
    variance, which does not cancel as E[x^2] - E[x]^2 can), each summed
    over the ranks with autograd."""
    count = flat.new_full((1,), flat.shape[0])
    tot = all_reduce_sum(mesh, torch.cat([flat.sum(0), count]))
    mean = tot[:-1] / tot[-1]
    var = all_reduce_sum(mesh, ((flat - mean) ** 2).sum(0)) / tot[-1]
    return var, mean


def sync_grads(mesh: Mesh, params: Iterable[torch.nn.Parameter]) -> None:
    """Average .grad over the ranks in place, one all-reduce a dtype over
    the flattened gradients (parameters without a gradient, the same on
    every rank, are left out)."""
    if mesh is None or mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for dtype in sorted({g.dtype for g in grads}, key=str):
        part = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in part])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        flat.div_(mesh.size)
        torch._foreach_copy_(part, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in part]), part)])
