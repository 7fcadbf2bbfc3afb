"""Explicit collectives over the mesh — the port of ``sat_tpu.parallel.collectives``,
plus the differentiable reductions the parallel steps are built from.

The JAX package writes its collectives once and lets GSPMD (or
``shard_map``'s transpose rules) derive their backward.  Here each
forward reduction names its backward, because the right one depends on
what consumes the result:

* :func:`reduce_from` — SUM forward, identity backward: the result feeds
  only replicated work (the context-parallel context sum, the
  vocab-parallel embedding lookup, a partial loss term).  Every rank
  then holds the same upstream gradient already;
* :func:`copy_to` — identity forward, SUM backward: a replicated tensor
  entering sharded work (the attention's ``h`` half under context
  parallelism, the decode input under vocab parallelism, a replicated
  parameter used on a shard).  Each rank's gradient is a partial;
* :func:`all_reduce_sum` — SUM both ways: a reduction whose result feeds
  sharded work again (the context-parallel softmax denominator, the
  global batch-norm moments);
* :func:`all_reduce_max` — MAX with no gradient (the softmax shift).

Every function takes the axis' process group and is the identity when
it is None (an axis of size 1).

JAX's ``make_global_batch`` has no counterpart here: in torch no global
tensor exists.  Each rank holds its own rows of the global batch, and
the steps reduce over the data group where the JAX program reduces over
the global array.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

SUM = dist.ReduceOp.SUM
MAX = dist.ReduceOp.MAX
MIN = dist.ReduceOp.MIN

# Wall time this process has spent blocked inside collectives (ns).  Every
# collective here blocks the host until the slowest rank arrives, so a
# mesh's ranks all show the straggler's step time; the train loop takes
# this out of each step to get the rank's own time, which the fleet
# plane's straggler verdict reads (the JAX package's host step time leaves
# the wait out by itself: its dispatch is asynchronous).
_BLOCKED_NS = [0]


def blocked_ns() -> int:
    """Nanoseconds spent in :func:`blocking` sections so far."""
    return _BLOCKED_NS[0]


@contextlib.contextmanager
def blocking():
    """Count the enclosed collective's wall time into :func:`blocked_ns`."""
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        _BLOCKED_NS[0] += time.perf_counter_ns() - t0


def all_reduce_(x: torch.Tensor, group, op=SUM) -> torch.Tensor:
    """In-place ``all_reduce`` of ``x`` over ``group`` (no autograd);
    returns ``x``.  The identity when ``group`` is None."""
    if group is not None:
        with blocking():
            dist.all_reduce(x, op=op, group=group)
    return x


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """SUM over ``group``; the gradient passes through unchanged."""
    return x if group is None else _ReduceFrom.apply(x.contiguous(), group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """SUM over ``group`` in the forward and in the backward."""
    return x if group is None else _AllReduceSum.apply(x.contiguous(), group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """MAX over ``group``, detached."""
    x = x.detach()
    return x if group is None else all_reduce_(x.contiguous().clone(), group, MAX)


def agree_any(flag: torch.Tensor, group) -> torch.Tensor:
    """A boolean tensor that is True on every rank of ``group`` where it
    is True on any: the ranks of a search take one stop decision, whatever
    the last bit of their replicated floats."""
    if group is None:
        return flag
    return all_reduce_(flag.to(torch.int32), group, MAX).bool()


def zero_padded_gather(x: torch.Tensor, dim: int, index: int, size: int, group) -> torch.Tensor:
    """The full tensor whose block ``index`` of ``size`` equal blocks along
    ``dim`` is this rank's ``x``: a zero-padded full-width SUM over
    ``group`` (adding zeros is exact, and the device collectives stay
    all_reduce only)."""
    if group is None:
        return x
    shape = list(x.shape)
    width = shape[dim]
    shape[dim] = width * size
    full = x.new_zeros(shape)
    full.narrow(dim, index * width, width).copy_(x)
    return all_reduce_(full, group)


def cross_replica_mean(value: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The mean over ``axis`` of each rank's ``value`` (one value per
    replica), on every rank."""
    size = mesh.size(axis)
    return all_reduce_(value.detach().clone(), mesh.group(axis)) / size


def all_gather_batch(x: torch.Tensor, mesh) -> np.ndarray:
    """The full batch on the host from each data rank's rows (equal row
    counts), in data-index order."""
    full = zero_padded_gather(x.detach(), 0, mesh.index("data"), mesh.size("data"), mesh.group("data"))
    return full.cpu().numpy()


def gather_objects(obj: Any, mesh) -> List[Any]:
    """Every rank's ``obj`` (picklable host values), in rank order, over
    the CPU gloo group."""
    if mesh.host_group is None:
        return [obj]
    out: List[Optional[Any]] = [None] * mesh.world
    with blocking():
        dist.all_gather_object(out, obj, group=mesh.host_group)
    return out


def flat_all_reduce_(tensors: List[torch.Tensor], group) -> None:
    """SUM every tensor of ``tensors`` over ``group`` in place, in one
    collective: the tensors are packed into one buffer per dtype (the
    gradient bucket), reduced and unpacked."""
    if group is None or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_tensors])
        all_reduce_(flat, group)
        offset = 0
        for t in group_tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
