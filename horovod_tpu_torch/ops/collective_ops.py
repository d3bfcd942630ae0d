"""Eager collectives on PyTorch tensors over ``torch.distributed``.

Port of ``horovod_tpu/ops/collective_ops.py``: the reduce ops (:92),
``allreduce`` with pre- and post-scale (:519), ``grouped_allreduce``
(:584), ``allgather`` (:658), ``broadcast`` (:700) and ``barrier`` (:937).

Convention: one tensor per rank, as in the reference Horovod. Rank r
passes its own tensor and gets its own result, which equals row r of the
JAX package's stacked-rank result (leading axis = rank) on the same data.
Every op returns a new tensor; the input is left as it was.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from .. import basics
from ..process_sets import global_process_set

# -- Reduce ops (parity: horovod.torch.mpi_ops Average/Sum/Min/Max) ---------

Average = "average"
Sum = "sum"
Min = "min"
Max = "max"
Product = "product"

_VALID_OPS = (Average, Sum, Min, Max, Product)
# Average reduces as a sum and divides by the set size afterwards (gloo has
# no AVG), which is how the JAX package's pmean computes it too.
_TORCH_OPS = {
    Average: dist.ReduceOp.SUM,
    Sum: dist.ReduceOp.SUM,
    Min: dist.ReduceOp.MIN,
    Max: dist.ReduceOp.MAX,
    Product: dist.ReduceOp.PRODUCT,
}


def _resolve_op(op, average):
    # `average=` is the reference's deprecated bool form; keep it working.
    if op is None:
        if average is None:
            return Average
        return Average if average else Sum
    if average is not None:
        raise ValueError("specify either op= or average=, not both")
    if op not in _VALID_OPS:
        raise ValueError(
            f"unknown reduce op {op!r}; expected one of {_VALID_OPS}")
    return op


def _resolve_process_set(process_set):
    basics._state.require_init()
    if process_set is None or process_set is global_process_set:
        return global_process_set
    raise ValueError(
        "only the global process set is ported so far; got "
        f"{process_set!r}")


def _check_device(tensor: torch.Tensor) -> None:
    world = basics._state.device
    if tensor.device.type != world.type:
        raise ValueError(
            f"the world runs on {world.type} "
            f"({'nccl' if world.type == 'cuda' else 'gloo'}); got a tensor "
            f"on {tensor.device}")


def _scale_(t: torch.Tensor, factor: float) -> None:
    # The factor is rounded to the tensor's dtype first, as the JAX package
    # multiplies by jnp.asarray(factor, x.dtype).
    if factor != 1.0:
        t.mul_(torch.tensor(factor, dtype=t.dtype, device=t.device))


def start_allreduce(t: torch.Tensor, op: str,
                    prescale_factor: float) -> dist.Work:
    """Prescale ``t`` and launch its in-place allreduce over the world
    asynchronously."""
    _scale_(t, prescale_factor)
    return dist.all_reduce(t, op=_TORCH_OPS[op], async_op=True)


def finish_allreduce(t: torch.Tensor, work: dist.Work, op: str,
                     postscale_factor: float, process_set) -> torch.Tensor:
    """Wait for ``work``, then apply the Average divisor and postscale."""
    work.wait()
    if op == Average:
        if t.is_floating_point():
            t.div_(process_set.size())
        else:
            t.div_(process_set.size(), rounding_mode="trunc")
    _scale_(t, postscale_factor)
    return t


def allreduce(tensor, average: bool | None = None, op: str | None = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set=None, name: str | None = None) -> torch.Tensor:
    """Reduce ``tensor`` across the process set; every rank gets the result.

    Parity: ``hvd.allreduce``. ``name`` exists for signature parity: NCCL
    and gloo match collectives by issue order, not by name.
    """
    del name
    op = _resolve_op(op, average)
    ps = _resolve_process_set(process_set)
    _check_device(tensor)
    t = tensor.detach().clone()
    work = start_allreduce(t, op, prescale_factor)
    return finish_allreduce(t, work, op, postscale_factor, ps)


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      average: bool | None = None, op: str | None = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set=None) -> list[torch.Tensor]:
    """Allreduce a list of tensors as one fused operation: same-dtype
    buckets up to the fusion threshold, one collective per bucket."""
    from .fusion import fused_allreduce

    op = _resolve_op(op, average)
    ps = _resolve_process_set(process_set)
    for t in tensors:
        _check_device(t)
    return fused_allreduce(list(tensors), op,
                           prescale_factor=prescale_factor,
                           postscale_factor=postscale_factor,
                           process_set=ps)


# The dtypes a rank can name to the others in allgather's shape exchange, in
# one order on every rank.
_DTYPES = tuple(sorted({v for v in vars(torch).values()
                        if isinstance(v, torch.dtype)}, key=str))
# Trailing dims listed in that exchange; beyond them, their product and the
# rank of the tensor still have to agree.
_HEAD_DIMS = 16


def _shape_head(t: torch.Tensor) -> torch.Tensor:
    """``[dtype, ndim, dim 0, trailing numel, trailing dims..., -1...]``."""
    trailing = list(t.shape[1:_HEAD_DIMS + 1])
    head = [_DTYPES.index(t.dtype), t.dim(), t.shape[0], t.shape[1:].numel(),
            *trailing, *[-1] * (_HEAD_DIMS - len(trailing))]
    return torch.tensor(head, dtype=torch.int64, device=t.device)


def _describe(head) -> str:
    dims = ", ".join(str(d) for d in [head[2], *head[4:]] if d >= 0)
    more = ", ..." if head[1] > _HEAD_DIMS + 1 else ""
    return f"[{dims}{more}] {_DTYPES[head[0]]}"


def allgather(tensor, process_set=None,
              name: str | None = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0 on every rank.

    Ranks may send different dim-0 sizes, 0 included (the reference's
    ``allgather_v``); the trailing dims and the dtype must agree. One small
    ``all_gather`` of every rank's shape and dtype comes first: if they
    disagree, every rank raises ``ValueError`` naming the shapes. Equal
    sizes then take one ``all_gather``; ragged ones are padded to the
    largest dim 0, gathered, and compacted.
    """
    del name
    ps = _resolve_process_set(process_set)
    _check_device(tensor)
    if tensor.dim() == 0:
        raise ValueError("allgather needs a tensor with at least one dim")
    t = tensor.detach().contiguous()
    head = _shape_head(t)
    heads = [torch.empty_like(head) for _ in range(ps.size())]
    dist.all_gather(heads, head)
    heads = [h.tolist() for h in heads]
    for r, h in enumerate(heads):
        if h[:2] + h[3:] != heads[0][:2] + heads[0][3:]:
            raise ValueError(
                "allgather needs the same trailing dims and dtype on every "
                f"rank; rank 0 sends {_describe(heads[0])}, rank {r} sends "
                f"{_describe(h)}")
    sizes = [h[2] for h in heads]
    if len(set(sizes)) == 1:
        if sizes[0] == 0:
            return t.clone()
        parts = [torch.empty_like(t) for _ in sizes]
        dist.all_gather(parts, t)
        return torch.cat(parts, dim=0)
    buf = t.new_zeros((max(sizes), *t.shape[1:]))
    buf[:t.shape[0]] = t
    parts = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(parts, buf)
    return torch.cat([p[:n] for p, n in zip(parts, sizes)], dim=0)


def broadcast(tensor, root_rank: int, process_set=None,
              name: str | None = None) -> torch.Tensor:
    """Every rank gets rank ``root_rank``'s tensor (a global rank)."""
    del name
    ps = _resolve_process_set(process_set)
    if root_rank not in ps.ranks:
        raise ValueError(
            f"root_rank {root_rank} (a global rank) is not a member of "
            f"process set {ps.ranks}")
    _check_device(tensor)
    t = tensor.detach().clone()
    dist.broadcast(t, src=root_rank)
    return t


def barrier(process_set=None) -> None:
    """Block until every rank in the set reaches the barrier."""
    _resolve_process_set(process_set)
    dist.barrier()
