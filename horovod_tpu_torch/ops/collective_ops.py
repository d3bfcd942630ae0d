"""Eager collectives on PyTorch tensors over ``torch.distributed``.

Port of ``horovod_tpu/ops/collective_ops.py``: the reduce ops (:92),
``allreduce`` with pre- and post-scale (:519) and Adasum (:166-188,
``ops/adasum.py``), ``grouped_allreduce``
(:584), ``allgather`` (:658), ``broadcast`` (:700), ``alltoall`` (:736),
``reducescatter`` (:848), ``grouped_reducescatter`` (:906),
``grouped_allgather`` (:914) and ``barrier`` (:937); and the torch-idiom
async API of ``horovod_tpu/torch/__init__.py`` (``allreduce_async_`` :168
to ``poll`` :456).

Convention: one tensor per rank, as in the reference Horovod. Rank r
passes its own tensor and gets its own result, which equals row r of the
JAX package's stacked-rank result (leading axis = rank) on the same data.
Every op returns a new tensor and leaves its input as it was, except the
in-place async forms (``allreduce_async_``, ``broadcast_async_``).

Every op takes ``process_set=``: the set's group runs it, and only its
members may call it. Each op is built once as a launch (the collectives
started with ``async_op=True``) and a finish (wait, then scale or
compact); the synchronous op finishes at once, the ``*_async`` form
returns a handle that :func:`synchronize` finishes and :func:`poll`
tests. Ops whose sizes must be agreed first (ragged ``allgather``,
``alltoall`` with ``splits``) exchange them at launch, blocking.

In an elastic world (``HOROVOD_ELASTIC=1``) every op and every wait
(:func:`wait`) first raises ``HorovodInternalError`` if a coordinated
abort is armed, as the reference's blocking sites do
(``horovod_tpu/runtime/__init__.py:427``), and a collective that fails
(gloo's ``RuntimeError``, NCCL's ``DistBackendError``, a ``Work`` whose
wait errors) raises ``HorovodInternalError``: what ``@hvd.elastic.run``
recovers from. On the CPU a wait polls the work and the abort flag, as
gloo's wait blocks the host; on the card a wait only orders the stream,
and an abort ends a collective stuck on a dead peer by aborting the
communicator (``basics._abort_groups``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import time
from typing import Any, Callable, NamedTuple, Sequence

import torch
import torch.distributed as dist

from .. import abort, basics
from ..exceptions import HorovodInternalError, HorovodTpuError
from ..process_sets import global_process_set
from ..utils import env
from .adasum import adasum_reduce

# -- Reduce ops (parity: horovod.torch.mpi_ops Average/Sum/Adasum/Min/Max) --

Average = "average"
Sum = "sum"
Min = "min"
Max = "max"
Product = "product"
Adasum = "adasum"

_VALID_OPS = (Average, Sum, Min, Max, Product, Adasum)
# Average reduces as a sum and divides by the set size afterwards (gloo has
# no AVG), which is how the JAX package's pmean computes it too.
_TORCH_OPS = {
    Average: dist.ReduceOp.SUM,
    Sum: dist.ReduceOp.SUM,
    Min: dist.ReduceOp.MIN,
    Max: dist.ReduceOp.MAX,
    Product: dist.ReduceOp.PRODUCT,
}
# Adasum is a gather and a local pairwise tree, with no async or grouped
# form (the reference torch surface's messages,
# horovod_tpu/torch/__init__.py:179-183 and :337-341).
_ADASUM_NO_ASYNC = (
    "op=Adasum has no async form on the host plane (it is a "
    "gather + local pairwise tree); use the synchronous "
    "hvd.allreduce or DistributedOptimizer(op=hvd.Adasum)")
_ADASUM_NO_GROUPED = (
    "op=Adasum has no grouped/async form on the host plane; "
    "use hvd.allreduce per tensor or "
    "DistributedOptimizer(op=hvd.Adasum)")
# As the reference's reducescatter (collective_ops.py:213), the port's takes
# no Adasum.
_ADASUM_NO_RS = (
    "reducescatter supports Sum/Average/Min/Max/Product, got 'adasum' "
    "(Adasum combines whole tensors; use allreduce)")

# torch 2.13 names the reduce-scatter of one tensor reduce_scatter_single and
# deprecates reduce_scatter_tensor; older releases have only the latter.
_reduce_scatter = (dist.reduce_scatter_single
                   if hasattr(dist, "reduce_scatter_single")
                   else dist.reduce_scatter_tensor)
# The same for the allgather of one tensor into a flat output.
_all_gather = (dist.all_gather_single if hasattr(dist, "all_gather_single")
               else dist.all_gather_into_tensor)


# -- Elastic worlds: aborts and failed collectives -------------------------

# How long a CPU wait sleeps between polls of the work and the abort flag.
_POLL_S = 0.001


@contextlib.contextmanager
def elastic_errors():
    """In an elastic world, turn a failed collective (``RuntimeError``,
    which NCCL's ``DistBackendError`` is) into ``HorovodInternalError``;
    elsewhere, let it through."""
    try:
        yield
    except HorovodTpuError:
        raise
    except RuntimeError as e:
        if not basics.elastic():
            raise
        # A collective that failed because the abort hook aborted its
        # communicator reports the abort.
        abort.raise_if_aborted()
        raise HorovodInternalError(f"collective failed: {e}") from e


def guarded(fn):
    """Decorate a blocking entry point: in an elastic world an armed abort
    raises ``HorovodInternalError`` before it runs, and a failed
    collective inside it raises ``HorovodInternalError``."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not basics.elastic():
            return fn(*args, **kwargs)
        abort.raise_if_aborted()
        with elastic_errors():
            return fn(*args, **kwargs)

    return call


def wait(work) -> None:
    """Wait for ``work``, a launched collective. In an elastic world an
    armed abort raises first, and on the CPU the wait polls the work and
    the abort flag, so that a survivor blocked on a hung peer unblocks
    when the abort is posted."""
    if not basics.elastic():
        work.wait()
        return
    abort.raise_if_aborted()
    with elastic_errors():
        if basics._state.device is not None and \
                basics._state.device.type == "cpu":
            while not work.is_completed():
                abort.raise_if_aborted()
                time.sleep(_POLL_S)
        work.wait()


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


def _non_adasum_op(op, average, message):
    op = _resolve_op(op, average)
    if op == Adasum:
        raise ValueError(message)
    return op


def _resolve_process_set(process_set):
    """The set an op runs on: a registered set this rank is a member of."""
    st = basics._state.require_init()
    ps = global_process_set if process_set is None else process_set
    if ps.process_set_id < 0:
        raise ValueError(
            f"process set {ps.ranks} is not registered (removed, or "
            "add_process_set was never called)")
    if ps.process_set_id != 0 and st.rank not in ps.ranks:
        raise ValueError(
            f"this rank ({st.rank}) is not a member of process set "
            f"{ps.process_set_id} (ranks {ps.ranks}); only members call its "
            "collectives")
    return ps


def _check_device(tensor: torch.Tensor) -> None:
    world = basics._state.device
    if tensor.device.type != world.type:
        raise ValueError(
            f"the world runs on {world.type} "
            f"({'nccl' if world.type == 'cuda' else 'gloo'}); got a tensor "
            f"on {tensor.device}")


def _scale_(t: torch.Tensor, factor: float) -> None:
    """Multiply ``t`` by ``factor`` in place, keeping its dtype.

    A float tensor is multiplied by the factor rounded to its dtype, as the
    JAX package multiplies by ``jnp.asarray(factor, x.dtype)``. An integer
    tensor is scaled in float64 and rounded to nearest, half away from zero,
    as the reference's per-process runtime does (``llround(x * factor)``,
    ``horovod_tpu/runtime/cpp/transport.cc:147 ScaleBuffer``); not
    ``torch.round``, which rounds half to even.
    """
    if factor == 1.0:
        return
    if t.is_floating_point() or t.is_complex():
        t.mul_(torch.tensor(factor, dtype=t.dtype, device=t.device))
        return
    y = t.double().mul_(factor)
    sign = y.sign()
    t.copy_(y.abs_().add_(0.5).floor_().mul_(sign))


def _divide_(t: torch.Tensor, n: int) -> None:
    """Average's divisor: a float tensor divides by ``n``; an integer one is
    scaled by ``1 / n`` as :func:`_scale_` scales, as the reference's
    runtime applies Average (``runtime.cc:272``)."""
    if t.is_floating_point():
        t.div_(n)
    else:
        _scale_(t, 1.0 / n)


def _average_and_postscale_(t: torch.Tensor, op: str, postscale_factor: float,
                            n: int) -> None:
    """A reducescatter's finish: a float tensor takes one multiply by
    ``postscale / n`` for Average (the reference's reducescatter), an
    integer one Average's ``1 / n`` and then the postscale, rounded apart
    (``ScaleBuffer`` twice)."""
    if op == Average and not t.is_floating_point():
        _divide_(t, n)
        _scale_(t, postscale_factor)
    else:
        _scale_(t, postscale_factor / n if op == Average else postscale_factor)


def start_allreduce(t: torch.Tensor, op: str, prescale_factor: float,
                    group=None) -> dist.Work:
    """Prescale ``t`` and launch its in-place allreduce over ``group`` (a
    process set's; None: the world) asynchronously."""
    _scale_(t, prescale_factor)
    return dist.all_reduce(t, op=_TORCH_OPS[op], group=group, async_op=True)


def finish_allreduce(t: torch.Tensor, work: dist.Work, op: str,
                     postscale_factor: float, process_set) -> torch.Tensor:
    """Wait for ``work``, then apply the Average divisor and postscale."""
    wait(work)
    if op == Average:
        _divide_(t, process_set.size())
    _scale_(t, postscale_factor)
    return t


class _Launched(NamedTuple):
    """An op in flight: its collectives, and the call that waits for them
    and returns the op's result."""

    works: list
    finish: Callable[[], Any]


def _combined(parts: Sequence[_Launched]) -> _Launched:
    """A group of ops as one: its result is the list of their results."""
    return _Launched([w for p in parts for w in p.works],
                     lambda: [p.finish() for p in parts])


# -- Launches ---------------------------------------------------------------


def _adasum_allreduce(tensor, prescale_factor, postscale_factor,
                      ps) -> torch.Tensor:
    """Adasum of ``tensor`` over the set (``ops/adasum.py``), pre- and
    post-scaled as the reference scales it (collective_ops.py:166-188). A
    one-member set gives the identity without the wire, unless
    ``HOROVOD_FORCE_WIRE_MACHINERY=1`` asks for the gather and the tree."""
    _check_device(tensor)
    t = tensor.detach().clone()
    _scale_(t, prescale_factor)
    if ps.size() > 1 or env.get_str(env.FORCE_WIRE_MACHINERY) == "1":
        t = adasum_reduce(t, ps)
    _scale_(t, postscale_factor)
    return t


def _launch_allreduce(tensor, op, prescale_factor, postscale_factor, ps,
                      in_place=False) -> _Launched:
    _check_device(tensor)
    if in_place:
        if not tensor.is_contiguous():
            raise ValueError("an in-place allreduce needs a contiguous "
                             "tensor")
        t = tensor.detach()
    else:
        t = tensor.detach().clone()
    work = start_allreduce(t, op, prescale_factor, ps.group)

    def finish():
        finish_allreduce(t, work, op, postscale_factor, ps)
        return tensor if in_place else t

    return _Launched([work], finish)


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


def _launch_allgather(tensor, ps) -> _Launched:
    _check_device(tensor)
    if tensor.dim() == 0:
        raise ValueError("allgather needs a tensor with at least one dim")
    t = tensor.detach().contiguous()
    head = _shape_head(t)
    heads = [torch.empty_like(head) for _ in range(ps.size())]
    dist.all_gather(heads, head, group=ps.group)
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
            return _Launched([], t.clone)
        parts = [torch.empty_like(t) for _ in sizes]
        work = dist.all_gather(parts, t, group=ps.group, async_op=True)
        return _Launched([work], lambda: (wait(work),
                                          torch.cat(parts, dim=0))[1])
    buf = t.new_zeros((max(sizes), *t.shape[1:]))
    buf[:t.shape[0]] = t
    parts = [torch.empty_like(buf) for _ in sizes]
    work = dist.all_gather(parts, buf, group=ps.group, async_op=True)
    return _Launched([work], lambda: (wait(work), torch.cat(
        [p[:n] for p, n in zip(parts, sizes)], dim=0))[1])


def _launch_broadcast(tensor, root_rank, ps, in_place=False) -> _Launched:
    if root_rank not in ps.ranks:
        raise ValueError(
            f"root_rank {root_rank} (a global rank) is not a member of "
            f"process set {ps.ranks}")
    _check_device(tensor)
    t = tensor.detach() if in_place else tensor.detach().clone()
    work = dist.broadcast(t, src=root_rank, group=ps.group, async_op=True)
    return _Launched([work], lambda: (wait(work),
                                      tensor if in_place else t)[1])


def _row_splits(splits, ps, d0) -> list[int]:
    """This rank's send splits: ``splits`` is its own ``(n,)`` vector, or
    an ``(n, n)`` table whose row r is set rank r's."""
    n = ps.size()
    sp = torch.as_tensor(splits).to("cpu", torch.int64)
    if sp.shape == (n, n):
        sp = sp[ps.rank()]
    if sp.shape != (n,):
        raise ValueError(
            f"splits must be shape ({n},) or ({n}, {n}); got "
            f"{tuple(sp.shape)}")
    row = sp.tolist()
    if min(row) < 0 or sum(row) != d0:
        raise ValueError(
            f"each rank's splits must be >= 0 and sum to its dim-0 size "
            f"{d0}; got {row}")
    return row


def _launch_alltoall(tensor, splits, ps) -> _Launched:
    _check_device(tensor)
    if tensor.dim() == 0:
        raise ValueError("alltoall needs a tensor with at least one dim")
    t = tensor.detach().contiguous()
    n, d0 = ps.size(), t.shape[0]
    if splits is None:
        if d0 % n:
            raise ValueError(
                f"alltoall needs dim 0 ({d0}) divisible by the set size "
                f"{n}; pass splits= for uneven chunks")
        out = torch.empty_like(t)
        work = dist.all_to_all_single(out, t, group=ps.group, async_op=True)
        return _Launched([work], lambda: (wait(work), out)[1])
    sent = _row_splits(splits, ps, d0)
    # The split-table exchange: row j is what set rank j sends to each.
    mine = torch.tensor(sent, dtype=torch.int64, device=t.device)
    table = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(table, mine, group=ps.group)
    received = torch.stack(table)[:, ps.rank()].cpu()
    out = t.new_empty((int(received.sum()), *t.shape[1:]))
    work = dist.all_to_all_single(out, t, output_split_sizes=received.tolist(),
                                  input_split_sizes=sent, group=ps.group,
                                  async_op=True)
    return _Launched([work], lambda: (wait(work), (out, received))[1])


def _launch_reducescatter(tensor, op, prescale_factor, postscale_factor,
                          ps) -> _Launched:
    _check_device(tensor)
    n = ps.size()
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise ValueError(
            f"reducescatter needs dim 0 divisible by the set size {n}; got "
            f"shape {tuple(tensor.shape)}")
    rows = tensor.shape[0] // n
    if basics._state.device.type == "cuda":
        t = tensor.detach()
        t = t.clone() if prescale_factor != 1.0 else t.contiguous()
        _scale_(t, prescale_factor)
        out = t.new_empty((rows, *t.shape[1:]))
        work = _reduce_scatter(out, t, op=_TORCH_OPS[op], group=ps.group,
                               async_op=True)
    else:
        # gloo's reduce-scatter Work never reports completion (is_completed
        # stays False, even after wait), so poll() could not see it end:
        # reduce the whole tensor and keep this rank's slice, the same
        # values.
        t = tensor.detach().clone()
        work = start_allreduce(t, op, prescale_factor, ps.group)
        out = t[ps.rank() * rows:(ps.rank() + 1) * rows]

    def finish():
        wait(work)
        _average_and_postscale_(out, op, postscale_factor, n)
        return out

    return _Launched([work], finish)


def _launch_grouped_allreduce(tensors, op, prescale_factor,
                              postscale_factor, ps) -> _Launched:
    from .fusion import start_fused_allreduce

    for t in tensors:
        _check_device(t)
    return _Launched(*start_fused_allreduce(
        list(tensors), op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=ps))


# -- Synchronous ops --------------------------------------------------------


@guarded
def allreduce(tensor, average: bool | None = None, op: str | None = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set=None, name: str | None = None) -> torch.Tensor:
    """Reduce ``tensor`` across the process set; every rank gets the result.

    Parity: ``hvd.allreduce``. ``op=Adasum`` gathers every member's
    tensor and combines them by the pairwise tree (``ops/adasum.py``).
    ``name`` exists for signature parity: NCCL and gloo match collectives
    by issue order, not by name.
    """
    del name
    op = _resolve_op(op, average)
    ps = _resolve_process_set(process_set)
    if op == Adasum:
        return _adasum_allreduce(tensor, prescale_factor, postscale_factor,
                                 ps)
    return _launch_allreduce(tensor, op, prescale_factor, postscale_factor,
                             ps).finish()


@guarded
def allreduce_(tensor, average: bool | None = None, op: str | None = None,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               process_set=None, name: str | None = None) -> torch.Tensor:
    """In-place :func:`allreduce`: ``tensor`` (contiguous) holds the result
    and is returned."""
    del name
    op = _resolve_op(op, average)
    ps = _resolve_process_set(process_set)
    if op == Adasum:
        tensor.data.copy_(_adasum_allreduce(tensor, prescale_factor,
                                            postscale_factor, ps))
        return tensor
    return _launch_allreduce(tensor, op, prescale_factor, postscale_factor,
                             ps, in_place=True).finish()


@guarded
def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      average: bool | None = None, op: str | None = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set=None) -> list[torch.Tensor]:
    """Allreduce a list of tensors as one fused operation: same-dtype
    buckets up to the fusion threshold, one collective per bucket."""
    return _launch_grouped_allreduce(
        tensors, _non_adasum_op(op, average, _ADASUM_NO_GROUPED),
        prescale_factor, postscale_factor,
        _resolve_process_set(process_set)).finish()


@guarded
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
    return _launch_allgather(tensor,
                             _resolve_process_set(process_set)).finish()


@guarded
def grouped_allgather(tensors: Sequence[torch.Tensor], process_set=None,
                      name: str | None = None) -> list[torch.Tensor]:
    """:func:`allgather` of each tensor (the ragged dim-0 contract holds
    for each), all launched before the first is waited on."""
    del name
    ps = _resolve_process_set(process_set)
    return _combined([_launch_allgather(t, ps) for t in tensors]).finish()


@guarded
def broadcast(tensor, root_rank: int, process_set=None,
              name: str | None = None) -> torch.Tensor:
    """Every rank gets rank ``root_rank``'s tensor (a global rank, which
    must belong to the set)."""
    del name
    return _launch_broadcast(tensor, root_rank,
                             _resolve_process_set(process_set)).finish()


@guarded
def alltoall(tensor, splits=None, process_set=None, name: str | None = None):
    """Scatter chunks of ``tensor``'s dim 0 to the set's ranks and gather
    the chunks they send, in set-rank order.

    Without ``splits`` the chunks are equal (dim 0 divisible by the set
    size) and the result is a tensor. With ``splits`` (this rank's ``(n,)``
    send sizes, summing to its dim 0, or an ``(n, n)`` table whose row r is
    set rank r's) the result is the reference's pair ``(output,
    received_splits)``, ``received_splits[j]`` the rows set rank j sent
    here (int64, on the CPU): the split tables are exchanged first, then
    one ``all_to_all_single`` with split sizes runs.
    """
    del name
    return _launch_alltoall(tensor, splits,
                            _resolve_process_set(process_set)).finish()


@guarded
def reducescatter(tensor, op: str | None = None,
                  prescale_factor: float = 1.0, postscale_factor: float = 1.0,
                  process_set=None, name: str | None = None) -> torch.Tensor:
    """Reduce across the set and scatter: set rank r keeps slice r of dim 0
    (dim 0 divisible by the set size, else ``ValueError``).

    Parity: ``hvd.reducescatter``; ``op`` defaults to Average. The
    reference takes Sum and Average; Min, Max and Product reduce as
    :func:`allreduce` does and keep slice r of its result. Adasum raises,
    as the reference's does.
    """
    del name
    return _launch_reducescatter(
        tensor, _non_adasum_op(op, None, _ADASUM_NO_RS), prescale_factor,
        postscale_factor, _resolve_process_set(process_set)).finish()


@guarded
def grouped_reducescatter(tensors: Sequence[torch.Tensor],
                          op: str | None = None, prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          process_set=None) -> list[torch.Tensor]:
    """:func:`reducescatter` of each tensor, all launched before the first
    is waited on."""
    op = _non_adasum_op(op, None, _ADASUM_NO_RS)
    ps = _resolve_process_set(process_set)
    return _combined([
        _launch_reducescatter(t, op, prescale_factor, postscale_factor, ps)
        for t in tensors]).finish()


@guarded
def barrier(process_set=None) -> None:
    """Block until every rank in the set reaches the barrier."""
    dist.barrier(group=_resolve_process_set(process_set).group)


# -- The async API (horovod_tpu/torch/__init__.py) ---------------------------

_handles: dict[int, _Launched] = {}
_handle_ids = itertools.count(1)


def _submit(launched: _Launched) -> int:
    h = next(_handle_ids)
    _handles[h] = launched
    return h


@guarded
def allreduce_async_(tensor, average: bool | None = None,
                     name: str | None = None, op: str | None = None,
                     process_set=None, prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0) -> int:
    """In-place async allreduce; :func:`synchronize` returns ``tensor``,
    which then holds the result."""
    del name
    return _submit(_launch_allreduce(
        tensor, _non_adasum_op(op, average, _ADASUM_NO_ASYNC),
        prescale_factor, postscale_factor, _resolve_process_set(process_set),
        in_place=True))


@guarded
def allreduce_async(tensor, average: bool | None = None,
                    name: str | None = None, op: str | None = None,
                    process_set=None, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> int:
    """Out-of-place async allreduce; :func:`synchronize` returns a new
    tensor."""
    del name
    return _submit(_launch_allreduce(
        tensor, _non_adasum_op(op, average, _ADASUM_NO_ASYNC),
        prescale_factor, postscale_factor, _resolve_process_set(process_set)))


@guarded
def allgather_async(tensor, name: str | None = None,
                    process_set=None) -> int:
    """Async ragged :func:`allgather` (the shape exchange runs at once)."""
    del name
    return _submit(_launch_allgather(tensor,
                                     _resolve_process_set(process_set)))


@guarded
def broadcast_async(tensor, root_rank: int, name: str | None = None,
                    process_set=None) -> int:
    """Out-of-place async broadcast from global rank ``root_rank``."""
    del name
    return _submit(_launch_broadcast(tensor, root_rank,
                                     _resolve_process_set(process_set)))


@guarded
def broadcast_async_(tensor, root_rank: int, name: str | None = None,
                     process_set=None) -> int:
    """In-place async broadcast from global rank ``root_rank``."""
    del name
    return _submit(_launch_broadcast(tensor, root_rank,
                                     _resolve_process_set(process_set),
                                     in_place=True))


@guarded
def alltoall_async(tensor, splits=None, name: str | None = None,
                   process_set=None) -> int:
    """Async :func:`alltoall` (with ``splits`` the split tables are
    exchanged at once); :func:`synchronize` returns what it returns."""
    del name
    return _submit(_launch_alltoall(tensor, splits,
                                    _resolve_process_set(process_set)))


@guarded
def reducescatter_async(tensor, name: str | None = None,
                        op: str | None = None, process_set=None) -> int:
    """Async :func:`reducescatter` (default Average)."""
    del name
    return _submit(_launch_reducescatter(
        tensor, _non_adasum_op(op, None, _ADASUM_NO_RS), 1.0, 1.0,
        _resolve_process_set(process_set)))


@guarded
def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            name: str | None = None, op: str | None = None,
                            process_set=None, prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0) -> int:
    """Async :func:`grouped_allreduce`: one handle for the group;
    :func:`synchronize` returns the list of results."""
    del name
    return _submit(_launch_grouped_allreduce(
        tensors, _non_adasum_op(op, None, _ADASUM_NO_GROUPED),
        prescale_factor, postscale_factor, _resolve_process_set(process_set)))


@guarded
def grouped_allgather_async(tensors: Sequence[torch.Tensor],
                            name: str | None = None,
                            process_set=None) -> int:
    """Async :func:`grouped_allgather`: one handle, a list of results."""
    del name
    ps = _resolve_process_set(process_set)
    return _submit(_combined([_launch_allgather(t, ps) for t in tensors]))


@guarded
def grouped_reducescatter_async(tensors: Sequence[torch.Tensor],
                                name: str | None = None,
                                op: str | None = None,
                                process_set=None) -> int:
    """Async :func:`grouped_reducescatter` (default Average): one handle,
    a list of results."""
    del name
    op = _non_adasum_op(op, None, _ADASUM_NO_RS)
    ps = _resolve_process_set(process_set)
    return _submit(_combined([_launch_reducescatter(t, op, 1.0, 1.0, ps)
                              for t in tensors]))


@guarded
def synchronize(handle: int):
    """Wait for an async op and return its result: the input for the
    in-place forms, a new tensor, a list for the grouped forms, the pair
    for ``alltoall`` with ``splits``. An unknown (or already synchronized)
    handle raises ``ValueError``."""
    launched = _handles.pop(handle, None)
    if launched is None:
        raise ValueError(f"unknown handle {handle}")
    return launched.finish()


def poll(handle: int) -> bool:
    """Whether an async op's collectives have completed (its result is then
    ready for :func:`synchronize`)."""
    launched = _handles.get(handle)
    if launched is None:
        raise ValueError(f"unknown handle {handle}")
    return all(w.is_completed() for w in launched.works)
