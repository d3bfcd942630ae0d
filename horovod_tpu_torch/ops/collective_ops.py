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

Observability (``horovod_tpu/ops/collective_ops.py:402-497``): every entry
point counts a dispatch by kind (:func:`cache_stats`,
``hvd_collective_dispatch_total``, ``hvd_collective_payload_bytes``: the
set's total payload, the JAX package's stacked-rank bytes), marks a
timeline cycle, records a ``collective`` span (a ``record_function``
range too) and holds a stall ticket until the collective has finished.
On the CPU gloo's wait blocks, so the host clock from launch to finish is
the latency and the ticket closes at finish. On the card NCCL's wait only
orders the current stream after the collective, so the latency
(``hvd_collective_latency_seconds``, ``hvd_alltoall_latency_seconds``) is
the device time between CUDA events recorded before the launch and after
the wait, and the ticket closes when the second event has completed: the
stall inspector reaps it (``stall.StallInspector.end_when``). The same
latency is one sample of the alpha-beta model
(``comms_model.observe(kind, "flat", link_class, bytes, seconds)``, as
``horovod_tpu/ops/collective_ops.py:484-495`` feeds it), taken when the
latency is, so a sample adds no synchronization; the set's link class
comes from the world's topology (``topology.py``), the algorithm is the
schedule the op ran. :func:`run_comms_microprobe` sweeps payload sizes to
seed the model.

With ``HOROVOD_COMMS_PLANNER`` set, an allreduce, reducescatter (Sum or
Average), equal-size allgather or equal-chunk alltoall on the global set
runs the schedule ``ops/comms_planner.py`` plans for its payload (the
reference's ``collective_ops.py:369-416``); unset, every op launches what
it launched before the planner. No
collective synchronizes the device; inside a sampled or watched training
step (``tracing.StepTracer.syncing``) a finish waits for the current
stream, so the step's span covers the collective.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import Any, Callable, NamedTuple, Sequence

import torch
import torch.distributed as dist

from .. import abort, basics, comms_model, metrics, tracing
from . import comms_planner
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


# -- Observability ----------------------------------------------------------

# Per-kind eager-dispatch counts, read by cache_stats().
_dispatch_counts: "collections.Counter[str]" = collections.Counter()


def cache_stats(reset: bool = False) -> dict:
    """Eager-dispatch counters, in the JAX package's layout::

        {"executable_cache": {"hits", "misses", "size", "capacity",
                              "bytes"},
         "eager_dispatch": {kind: count, ...}}

    The port launches NCCL and gloo collectives directly and compiles no
    executable per collective, so it has no executable cache: that entry
    holds zeros, kept so that a reader of the JAX package's
    ``profiler.summary()`` finds the same keys. ``reset=True`` zeroes the
    dispatch counts after reading them."""
    stats = {
        "executable_cache": {"hits": 0, "misses": 0, "size": 0,
                             "capacity": 0, "bytes": 0},
        "eager_dispatch": dict(_dispatch_counts),
    }
    if reset:
        _dispatch_counts.clear()
    return stats


def _link_class(ps) -> str:
    """The worst link the set's ranks span (``topology.Topology``'s
    ``set_link_class``: ``intra_host`` or ``inter_host``): the span's and
    the comms model's ``link_class``."""
    return basics._state.topology.set_link_class(ps.ranks)


def _observe_latency(kind: str, seconds: float, nbytes: int = 0,
                     link_class: str | None = None,
                     algorithm: str = "flat") -> None:
    """The latency histograms, and (``link_class`` given) one alpha-beta
    sample of the collective: ``nbytes`` over the set's worst link took
    ``seconds`` under ``algorithm``, the schedule it ran
    (``comms_model.observe``)."""
    metrics.COLLECTIVE_LATENCY.observe(seconds, kind=kind)
    if kind == "alltoall":
        metrics.ALLTOALL_LATENCY.observe(seconds, algorithm=algorithm)
    if link_class is not None:
        try:
            comms_model.observe(kind, algorithm, link_class, nbytes,
                                seconds)
        except Exception:  # noqa: BLE001 — the model is advisory
            pass


class _Dispatch:
    """One eager collective's instruments, from its launch to its finish:
    the dispatch counts, the stall ticket, the tracer span and the
    latency (see the module docstring)."""

    def __init__(self, kind: str, tensors: Sequence[torch.Tensor], ps,
                 sample: bool = True, timed: bool = True):
        from ..stall import get_inspector
        from ..timeline import mark_cycle

        self.kind = kind
        n = ps.size()
        nbytes = n * sum(t.numel() * t.element_size() for t in tensors)
        shape = tuple(tensors[0].shape) if len(tensors) == 1 else \
            tuple(tuple(t.shape) for t in tensors)
        mark_cycle()
        _dispatch_counts[kind] += 1
        metrics.COLLECTIVE_DISPATCH.inc(kind=kind)
        metrics.COLLECTIVE_BYTES.observe(nbytes, kind=kind)
        self.args = {
            "shape": list(shape),
            "dtype": str(tensors[0].dtype) if tensors else "",
            "bytes": nbytes,
            "op": kind,
            "algorithm": "flat",
            "link_class": _link_class(ps),
        }
        # Whether the latency is an alpha-beta sample, and whether this
        # dispatch takes it at all (a negotiated collective's latency is
        # its data plane's, which the executor takes).
        self._link = self.args["link_class"] if sample else None
        self._timed = timed
        self._inspector = get_inspector()
        self._ticket = self._inspector.begin(f"{kind}[{shape}]")
        self._tracer = tracing.get_tracer()
        self._span = self._tracer.begin_span(kind, "collective")
        self._cuda = basics._state.device.type == "cuda"
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()

    def ran(self, algorithm: str) -> None:
        """The launch ran the comms planner's ``algorithm``: the span's
        label and the model's fit key."""
        self.args["algorithm"] = algorithm

    def fail(self) -> None:
        """The launch or the finish raised: close the ticket and span."""
        self._inspector.end(self._ticket)
        self._tracer.end_span(self._span, self.args)

    def finished(self) -> None:
        """The finish returned: take the latency and close the ticket, at
        once on the CPU, when the device has finished on the card."""
        nbytes, link = self.args["bytes"], self._link
        algorithm = self.args["algorithm"]
        if not self._cuda:
            if self._timed:
                _observe_latency(self.kind, time.perf_counter() - self._t0,
                                 nbytes, link, algorithm)
            self._inspector.end(self._ticket)
        else:
            if self._tracer.syncing():
                basics.sync_stream()
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            start, kind = self._start, self.kind
            self._inspector.end_when(
                self._ticket, end.query,
                (lambda: _observe_latency(kind,
                                          start.elapsed_time(end) / 1e3,
                                          nbytes, link, algorithm))
                if self._timed else None)
        self._tracer.end_span(self._span, self.args)


def _run(kind, tensors, ps, compute, sample: bool = True):
    """A synchronous op: ``compute()`` (its result, or its launch, a
    :class:`_Launched`, which is then finished) inside its dispatch's
    instruments and a ``kind`` activity; ``sample=False`` keeps its
    latency out of the comms model."""
    from ..timeline import activity

    d = _Dispatch(kind, tensors, ps, sample)
    with activity(kind, "collective", d.args):
        try:
            out = compute()
            if isinstance(out, _Launched):
                d.ran(out.algorithm)
                out = out.finish()
        except BaseException:
            d.fail()
            raise
        d.finished()
    return out


def _reap_collectives() -> None:
    from ..stall import get_inspector

    get_inspector().reap()


# A snapshot sees the latencies of collectives the card has finished.
metrics.add_collector(_reap_collectives)


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
                    group=None, plan=None, process_set=None) -> dist.Work:
    """Prescale ``t`` and launch its in-place allreduce over ``group`` (a
    process set's; None: the world) asynchronously; with a comms-planner
    ``plan`` (a Sum or Average on ``process_set``), its schedule's sum
    instead (``comms_planner.start_allreduce_sum_``)."""
    _scale_(t, prescale_factor)
    if plan is not None:
        return comms_planner.start_allreduce_sum_(plan, t, process_set)
    return dist.all_reduce(t, op=_TORCH_OPS[op], group=group, async_op=True)


def _plan(op_name: str, t: torch.Tensor, ps, reduce_op: str | None = None):
    """The comms planner's plan for an eager collective of ``t`` on
    ``ps``, priced at the set's payload (the JAX package's stacked bytes),
    or None for the flat path (``comms_planner.dispatch_plan``)."""
    return comms_planner.dispatch_plan(
        op_name, ps.size() * t.numel() * t.element_size(), ps, reduce_op)


def finish_allreduce(t: torch.Tensor, work: dist.Work, op: str,
                     postscale_factor: float, process_set) -> torch.Tensor:
    """Wait for ``work``, then apply the Average divisor and postscale."""
    wait(work)
    if op == Average:
        _divide_(t, process_set.size())
    _scale_(t, postscale_factor)
    return t


class _Launched(NamedTuple):
    """An op in flight: its collectives, the call that waits for them and
    returns the op's result, and the comms planner's algorithm it ran."""

    works: list
    finish: Callable[[], Any]
    algorithm: str = "flat"


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
    plan = _plan("allreduce", t, ps, op)
    if plan is not None and not t.is_contiguous():
        t = t.contiguous()
    work = start_allreduce(t, op, prescale_factor, ps.group, plan, ps)

    def finish():
        finish_allreduce(t, work, op, postscale_factor, ps)
        return tensor if in_place else t

    return _Launched([work], finish,
                     "flat" if plan is None else plan.algorithm)


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
        # Equal sizes on every rank (the shapes were just exchanged): the
        # payload, and so the plan, is the same everywhere.
        plan = _plan("allgather", t, ps)
        if plan is not None:
            full = comms_planner.apply_allgather_row(plan, t.reshape(-1), ps)
            return _Launched([], lambda: full.view(
                ps.size() * t.shape[0], *t.shape[1:]), plan.algorithm)
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
        plan = _plan("alltoall", t, ps)
        if plan is not None:
            out = comms_planner.apply_alltoall(plan, t, ps)
            return _Launched([], lambda: out, plan.algorithm)
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


def _check_reducescatter(tensor, n) -> None:
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise ValueError(
            f"reducescatter needs dim 0 divisible by the set size {n}; got "
            f"shape {tuple(tensor.shape)}")


def _launch_reducescatter(tensor, op, prescale_factor, postscale_factor,
                          ps) -> _Launched:
    _check_device(tensor)
    n = ps.size()
    _check_reducescatter(tensor, n)
    rows = tensor.shape[0] // n
    plan = _plan("reducescatter", tensor, ps, op)
    if plan is not None:
        t = tensor.detach().clone().contiguous()
        _scale_(t, prescale_factor)
        out = comms_planner.apply_reducescatter_sum(
            plan, t.view(-1), ps).view(rows, *t.shape[1:])

        def finish_planned():
            _average_and_postscale_(out, op, postscale_factor, n)
            return out

        return _Launched([], finish_planned, plan.algorithm)
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


# -- The negotiated plane --------------------------------------------------
#
# In a world of more than one rank every eager collective below (sync,
# async, grouped, barrier) is a named request to the negotiated runtime
# (``runtime.NativeWorld``, ``basics.negotiated_world()``): the reference's
# per-process idiom (``horovod_tpu/ops/collective_ops.py:232-260``). Ranks
# may then enqueue named tensors in different orders. A set maps to the
# controller's id it got when it was added (``process_sets``). At one rank
# the call stays direct, as the reference's does. The optimizer's bucket
# flushes, its sharded and fsdp halves, ``make_train_step``'s loss and the
# microprobe's timed launches stay direct: they call the launches above, or
# run under :func:`direct`.

_direct_local = threading.local()


@contextlib.contextmanager
def direct():
    """Run this thread's eager collectives on the direct plane (the
    default group, in call order) even in a negotiated world: the
    training step's own collectives, as the reference's compiled step is
    not negotiated either."""
    prev = getattr(_direct_local, "on", False)
    _direct_local.on = True
    try:
        yield
    finally:
        _direct_local.on = prev


def _negotiated():
    """The negotiated world the eager collectives go through, or None (one
    rank, or inside :func:`direct`)."""
    if getattr(_direct_local, "on", False):
        return None
    return basics._state.negotiated


def _set_id(ps) -> int:
    """The controller's id of a registered set (0: the global set)."""
    return 0 if ps.process_set_id == 0 else ps.native_id


class _NativeWork:
    """A negotiated handle as a ``Work``: :func:`poll` asks the world."""

    def __init__(self, world, handle: int):
        self._world, self._handle = world, handle

    def is_completed(self) -> bool:
        return self._world.poll(self._handle)


def _native(world, handles, finish) -> _Launched:
    return _Launched([_NativeWork(world, h) for h in handles], finish)


def _neg_allreduce(world, tensor, op, prescale_factor, postscale_factor, ps,
                   name, in_place=False) -> _Launched:
    _check_device(tensor)
    enqueue = world.allreduce_async_ if in_place else world.allreduce_async
    h = enqueue(tensor.detach(), name, op, prescale_factor, postscale_factor,
                _set_id(ps))
    if in_place:
        return _native(world, [h], lambda: (world.synchronize(h), tensor)[1])
    return _native(world, [h], lambda: world.synchronize(h))


def _neg_grouped_allreduce(world, tensors, op, prescale_factor,
                           postscale_factor, ps, name) -> _Launched:
    from .fusion import note_leaf_layout

    for t in tensors:
        _check_device(t)
    # A grouped allreduce is a bucket plan (the controller fuses it).
    note_leaf_layout([(t.numel(), t.dtype) for t in tensors])
    hs = world.grouped_allreduce_async(
        [t.detach() for t in tensors], name, op, _set_id(ps),
        prescale_factor, postscale_factor)
    return _native(world, hs, lambda: [world.synchronize(h) for h in hs])


def _neg_heads(world, ts, ps, base) -> list[list[list[int]]]:
    """Every member's shape head of each tensor (:func:`_shape_head`), by
    one negotiated grouped allgather, checked as :func:`_launch_allgather`
    checks them."""
    n = ps.size()
    sid = _set_id(ps)
    hs = world.grouped_allgather_async([_shape_head(t) for t in ts],
                                       name=f"{base}.sz", process_set_id=sid)
    out = []
    for h in hs:
        heads = world.synchronize(h).view(n, -1).tolist()
        for r, hd in enumerate(heads):
            if hd[:2] + hd[3:] != heads[0][:2] + heads[0][3:]:
                raise ValueError(
                    "allgather needs the same trailing dims and dtype on "
                    f"every rank; rank 0 sends {_describe(heads[0])}, rank "
                    f"{r} sends {_describe(hd)}")
        out.append(heads)
    return out


def _neg_allgather(world, tensors, ps, name, grouped=False) -> _Launched:
    """The ragged allgather of each tensor: the heads' exchange (blocking),
    then one negotiated grouped allgather of the tensors padded to the
    largest dim 0, then each compacted (the reference's
    ``grouped_allgather_v``)."""
    from ..runtime import compact_ranks, pad_rows

    ts = []
    for t in tensors:
        _check_device(t)
        if t.dim() == 0:
            raise ValueError("allgather needs a tensor with at least one dim")
        ts.append(t.detach().contiguous())
    sid = _set_id(ps)
    base = name or world.reserve_name("gagv" if grouped else "agv", sid)
    sizes = [[hd[2] for hd in heads]
             for heads in _neg_heads(world, ts, ps, base)]
    padded = [pad_rows(t, max(1, max(sz))) for t, sz in zip(ts, sizes)]
    hs = world.grouped_allgather_async(padded, name=f"{base}.data",
                                       process_set_id=sid)
    n = ps.size()

    def finish():
        out = []
        for h, t, sz in zip(hs, padded, sizes):
            g = world.synchronize(h)
            out.append(compact_ranks(g.view((n,) + tuple(t.shape)), sz))
        return out if grouped else out[0]

    return _native(world, hs, finish)


def _neg_broadcast(world, tensor, root_rank, ps, name,
                   in_place=False) -> _Launched:
    if root_rank not in ps.ranks:
        raise ValueError(
            f"root_rank {root_rank} (a global rank) is not a member of "
            f"process set {ps.ranks}")
    _check_device(tensor)
    h = world.broadcast_async(tensor.detach(), root_rank, name, _set_id(ps),
                              in_place=in_place)
    if in_place:
        return _native(world, [h], lambda: (world.synchronize(h), tensor)[1])
    return _native(world, [h], lambda: world.synchronize(h))


def _neg_alltoall(world, tensor, splits, ps, name) -> _Launched:
    """Equal chunks: one negotiated alltoall. With ``splits``: the split
    tables' negotiated allgather (blocking), the chunks padded to the
    largest, one negotiated alltoall, compacted (the reference's
    ``alltoall_v``)."""
    from ..runtime import compact_chunks, pad_chunks

    _check_device(tensor)
    if tensor.dim() == 0:
        raise ValueError("alltoall needs a tensor with at least one dim")
    t = tensor.detach().contiguous()
    n, d0, sid = ps.size(), t.shape[0], _set_id(ps)
    if splits is None:
        if d0 % n:
            raise ValueError(
                f"alltoall needs dim 0 ({d0}) divisible by the set size "
                f"{n}; pass splits= for uneven chunks")
        h = world.alltoall_async(t, name, sid)
        return _native(world, [h], lambda: world.synchronize(h))
    sent = _row_splits(splits, ps, d0)
    base = name or world.reserve_name("atv", sid)
    table = world.allgather(torch.tensor(sent, dtype=torch.int64,
                                         device=t.device),
                            name=f"{base}.sp", process_set_id=sid)
    table = table.view(n, n).cpu()
    received = table[:, ps.rank()].clone()
    max_c = max(1, int(table.max()))
    h = world.alltoall_async(pad_chunks(t, sent, max_c), f"{base}.data", sid)
    return _native(world, [h], lambda: (compact_chunks(
        world.synchronize(h), received.tolist(), max_c), received))


def _neg_reducescatter(world, tensors, op, prescale_factor,
                       postscale_factor, ps, name,
                       grouped=False) -> _Launched:
    for t in tensors:
        _check_device(t)
        _check_reducescatter(t, ps.size())
    ts = [t.detach() for t in tensors]
    if grouped:
        hs = world.grouped_reducescatter_async(
            ts, name, op, _set_id(ps), prescale_factor, postscale_factor)
        return _native(world, hs,
                       lambda: [world.synchronize(h) for h in hs])
    h = world.reducescatter_async(ts[0], name, op, _set_id(ps),
                                  prescale_factor, postscale_factor)
    return _native(world, [h], lambda: world.synchronize(h))


# -- Synchronous ops --------------------------------------------------------


def _instrumented(kind: str, tensors: Sequence[torch.Tensor], ps,
                  launch: Callable[[], _Launched],
                  timed: bool = True) -> _Launched:
    """Launch an op inside its dispatch's instruments and a ``kind``
    activity (the launch only: the op's span and ticket stay open until
    its finish) and return it, its finish closing them. ``timed=False``
    (a negotiated op) leaves the latency to the plane that performs it."""
    from ..timeline import activity

    d = _Dispatch(kind, tensors, ps, timed=timed)
    with activity(kind, "collective", d.args):
        try:
            launched = launch()
            d.ran(launched.algorithm)
        except BaseException:
            d.fail()
            raise

    def finish():
        try:
            out = launched.finish()
        except BaseException:
            d.fail()
            raise
        d.finished()
        return out

    return _Launched(launched.works, finish)


def _call(kind, tensors, ps, negotiated, launch):
    """A synchronous op: ``negotiated(world)`` through the negotiated
    world when there is one, else ``launch()`` (a :class:`_Launched`)
    directly, finished at once."""
    world = _negotiated()
    if world is not None:
        return _instrumented(kind, tensors, ps, lambda: negotiated(world),
                             timed=False).finish()
    return _run(kind, tensors, ps, launch)


@guarded
def allreduce(tensor, average: bool | None = None, op: str | None = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set=None, name: str | None = None) -> torch.Tensor:
    """Reduce ``tensor`` across the process set; every rank gets the result.

    Parity: ``hvd.allreduce``. ``op=Adasum`` gathers every member's
    tensor and combines them by the pairwise tree (``ops/adasum.py``).
    ``name`` names the request in a negotiated world (ranks may then
    enqueue named tensors in any order); unnamed ops match in call order.
    """
    op = _resolve_op(op, average)
    ps = _resolve_process_set(process_set)
    if op == Adasum:
        return _run("allreduce", [tensor], ps, lambda: _adasum_allreduce(
            tensor, prescale_factor, postscale_factor, ps))
    return _call("allreduce", [tensor], ps,
                 lambda w: _neg_allreduce(w, tensor, op, prescale_factor,
                                          postscale_factor, ps, name),
                 lambda: _launch_allreduce(tensor, op, prescale_factor,
                                           postscale_factor, ps))


@guarded
def allreduce_(tensor, average: bool | None = None, op: str | None = None,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               process_set=None, name: str | None = None) -> torch.Tensor:
    """In-place :func:`allreduce`: ``tensor`` (contiguous) holds the result
    and is returned."""
    op = _resolve_op(op, average)
    ps = _resolve_process_set(process_set)
    if op == Adasum:
        def compute():
            tensor.data.copy_(_adasum_allreduce(tensor, prescale_factor,
                                                postscale_factor, ps))
            return tensor

        return _run("allreduce", [tensor], ps, compute)
    return _call("allreduce", [tensor], ps,
                 lambda w: _neg_allreduce(w, tensor, op, prescale_factor,
                                          postscale_factor, ps, name,
                                          in_place=True),
                 lambda: _launch_allreduce(tensor, op, prescale_factor,
                                           postscale_factor, ps,
                                           in_place=True))


@guarded
def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      average: bool | None = None, op: str | None = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set=None) -> list[torch.Tensor]:
    """Allreduce a list of tensors as one fused operation: same-dtype
    buckets up to the fusion threshold, one collective per bucket (in a
    negotiated world, one atomic group that the controller fuses)."""
    op = _non_adasum_op(op, average, _ADASUM_NO_GROUPED)
    ps = _resolve_process_set(process_set)
    return _call("allreduce", list(tensors), ps,
                 lambda w: _neg_grouped_allreduce(
                     w, list(tensors), op, prescale_factor,
                     postscale_factor, ps, None),
                 lambda: _launch_grouped_allreduce(
                     tensors, op, prescale_factor, postscale_factor, ps))


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
    ps = _resolve_process_set(process_set)
    return _call("allgather", [tensor], ps,
                 lambda w: _neg_allgather(w, [tensor], ps, name),
                 lambda: _launch_allgather(tensor, ps))


@guarded
def grouped_allgather(tensors: Sequence[torch.Tensor], process_set=None,
                      name: str | None = None) -> list[torch.Tensor]:
    """:func:`allgather` of each tensor (the ragged dim-0 contract holds
    for each), all launched before the first is waited on."""
    ps = _resolve_process_set(process_set)
    return _call("allgather", list(tensors), ps,
                 lambda w: _neg_allgather(w, list(tensors), ps, name,
                                          grouped=True),
                 lambda: _combined([_launch_allgather(t, ps)
                                    for t in tensors]))


@guarded
def broadcast(tensor, root_rank: int, process_set=None,
              name: str | None = None) -> torch.Tensor:
    """Every rank gets rank ``root_rank``'s tensor (a global rank, which
    must belong to the set)."""
    ps = _resolve_process_set(process_set)
    return _call("broadcast", [tensor], ps,
                 lambda w: _neg_broadcast(w, tensor, root_rank, ps, name),
                 lambda: _launch_broadcast(tensor, root_rank, ps))


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
    one ``all_to_all_single`` with split sizes runs (in a negotiated
    world, the chunks padded to the largest, as the reference's
    ``alltoall_v``).
    """
    ps = _resolve_process_set(process_set)
    return _call("alltoall", [tensor], ps,
                 lambda w: _neg_alltoall(w, tensor, splits, ps, name),
                 lambda: _launch_alltoall(tensor, splits, ps))


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
    op = _non_adasum_op(op, None, _ADASUM_NO_RS)
    ps = _resolve_process_set(process_set)
    return _call("reducescatter", [tensor], ps,
                 lambda w: _neg_reducescatter(
                     w, [tensor], op, prescale_factor, postscale_factor, ps,
                     name),
                 lambda: _launch_reducescatter(
                     tensor, op, prescale_factor, postscale_factor, ps))


@guarded
def grouped_reducescatter(tensors: Sequence[torch.Tensor],
                          op: str | None = None, prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          process_set=None) -> list[torch.Tensor]:
    """:func:`reducescatter` of each tensor, all launched before the first
    is waited on."""
    op = _non_adasum_op(op, None, _ADASUM_NO_RS)
    ps = _resolve_process_set(process_set)
    return _call("reducescatter", list(tensors), ps,
                 lambda w: _neg_reducescatter(
                     w, list(tensors), op, prescale_factor,
                     postscale_factor, ps, None, grouped=True),
                 lambda: _combined([
                     _launch_reducescatter(t, op, prescale_factor,
                                           postscale_factor, ps)
                     for t in tensors]))


@guarded
def barrier(process_set=None) -> None:
    """Block until every rank in the set reaches the barrier."""
    ps = _resolve_process_set(process_set)

    def negotiated(world):
        h = world.barrier_async(_set_id(ps))
        return _native(world, [h], lambda: (world.synchronize(h), None)[1])

    def launch():
        dist.barrier(group=ps.group)
        return _Launched([], lambda: None)

    _call("barrier", [], ps, negotiated, launch)


# -- The async API (horovod_tpu/torch/__init__.py) ---------------------------

_handles: dict[int, _Launched] = {}
_handle_ids = itertools.count(1)


def _submit(kind: str, tensors: Sequence[torch.Tensor], ps, negotiated,
            launch: Callable[[], _Launched]) -> int:
    """Launch an async op (through the negotiated world when there is one,
    else directly) inside its dispatch's instruments and return its
    handle; :func:`synchronize` finishes it."""
    world = _negotiated()
    if world is not None:
        launched = _instrumented(kind, tensors, ps,
                                 lambda: negotiated(world), timed=False)
    else:
        launched = _instrumented(kind, tensors, ps, launch)
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
    op = _non_adasum_op(op, average, _ADASUM_NO_ASYNC)
    ps = _resolve_process_set(process_set)
    return _submit("allreduce", [tensor], ps,
                   lambda w: _neg_allreduce(w, tensor, op, prescale_factor,
                                            postscale_factor, ps, name,
                                            in_place=True),
                   lambda: _launch_allreduce(
                       tensor, op, prescale_factor, postscale_factor, ps,
                       in_place=True))


@guarded
def allreduce_async(tensor, average: bool | None = None,
                    name: str | None = None, op: str | None = None,
                    process_set=None, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> int:
    """Out-of-place async allreduce; :func:`synchronize` returns a new
    tensor."""
    op = _non_adasum_op(op, average, _ADASUM_NO_ASYNC)
    ps = _resolve_process_set(process_set)
    return _submit("allreduce", [tensor], ps,
                   lambda w: _neg_allreduce(w, tensor, op, prescale_factor,
                                            postscale_factor, ps, name),
                   lambda: _launch_allreduce(
                       tensor, op, prescale_factor, postscale_factor, ps))


@guarded
def allgather_async(tensor, name: str | None = None,
                    process_set=None) -> int:
    """Async ragged :func:`allgather` (the shape exchange runs at once)."""
    ps = _resolve_process_set(process_set)
    return _submit("allgather", [tensor], ps,
                   lambda w: _neg_allgather(w, [tensor], ps, name),
                   lambda: _launch_allgather(tensor, ps))


@guarded
def broadcast_async(tensor, root_rank: int, name: str | None = None,
                    process_set=None) -> int:
    """Out-of-place async broadcast from global rank ``root_rank``."""
    ps = _resolve_process_set(process_set)
    return _submit("broadcast", [tensor], ps,
                   lambda w: _neg_broadcast(w, tensor, root_rank, ps, name),
                   lambda: _launch_broadcast(tensor, root_rank, ps))


@guarded
def broadcast_async_(tensor, root_rank: int, name: str | None = None,
                     process_set=None) -> int:
    """In-place async broadcast from global rank ``root_rank``."""
    ps = _resolve_process_set(process_set)
    return _submit("broadcast", [tensor], ps,
                   lambda w: _neg_broadcast(w, tensor, root_rank, ps, name,
                                            in_place=True),
                   lambda: _launch_broadcast(tensor, root_rank, ps,
                                             in_place=True))


@guarded
def alltoall_async(tensor, splits=None, name: str | None = None,
                   process_set=None) -> int:
    """Async :func:`alltoall` (with ``splits`` the split tables are
    exchanged at once); :func:`synchronize` returns what it returns."""
    ps = _resolve_process_set(process_set)
    return _submit("alltoall", [tensor], ps,
                   lambda w: _neg_alltoall(w, tensor, splits, ps, name),
                   lambda: _launch_alltoall(tensor, splits, ps))


@guarded
def reducescatter_async(tensor, name: str | None = None,
                        op: str | None = None, process_set=None) -> int:
    """Async :func:`reducescatter` (default Average)."""
    op = _non_adasum_op(op, None, _ADASUM_NO_RS)
    ps = _resolve_process_set(process_set)
    return _submit("reducescatter", [tensor], ps,
                   lambda w: _neg_reducescatter(w, [tensor], op, 1.0, 1.0,
                                                ps, name),
                   lambda: _launch_reducescatter(tensor, op, 1.0, 1.0, ps))


@guarded
def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            name: str | None = None, op: str | None = None,
                            process_set=None, prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0) -> int:
    """Async :func:`grouped_allreduce`: one handle for the group;
    :func:`synchronize` returns the list of results."""
    op = _non_adasum_op(op, None, _ADASUM_NO_GROUPED)
    ps = _resolve_process_set(process_set)
    return _submit("allreduce", list(tensors), ps,
                   lambda w: _neg_grouped_allreduce(
                       w, list(tensors), op, prescale_factor,
                       postscale_factor, ps, name),
                   lambda: _launch_grouped_allreduce(
                       tensors, op, prescale_factor, postscale_factor, ps))


@guarded
def grouped_allgather_async(tensors: Sequence[torch.Tensor],
                            name: str | None = None,
                            process_set=None) -> int:
    """Async :func:`grouped_allgather`: one handle, a list of results."""
    ps = _resolve_process_set(process_set)
    return _submit("allgather", list(tensors), ps,
                   lambda w: _neg_allgather(w, list(tensors), ps, name,
                                            grouped=True),
                   lambda: _combined([_launch_allgather(t, ps)
                                      for t in tensors]))


@guarded
def grouped_reducescatter_async(tensors: Sequence[torch.Tensor],
                                name: str | None = None,
                                op: str | None = None,
                                process_set=None) -> int:
    """Async :func:`grouped_reducescatter` (default Average): one handle,
    a list of results."""
    op = _non_adasum_op(op, None, _ADASUM_NO_RS)
    ps = _resolve_process_set(process_set)
    return _submit("reducescatter", list(tensors), ps,
                   lambda w: _neg_reducescatter(w, list(tensors), op, 1.0,
                                                1.0, ps, name, grouped=True),
                   lambda: _combined([
                       _launch_reducescatter(t, op, 1.0, 1.0, ps)
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


# -- The comms model's microprobe --------------------------------------------


# Cycles of the spin (``torch.cuda._sleep``) queued on the card ahead of
# each size's timed microprobe calls: about 10 ms at an H100's clock,
# longer than the eager path's host dispatch of those calls, so their CUDA
# events bracket the device's work on a busy stream and not the host's
# launches on an idle one.
PROBE_HOLD_CYCLES = 20_000_000
# Times a size's timed calls run again when the spin ahead of them ended
# early (``utils.spin.Spin.short``), before the probe raises.
PROBE_SPIN_RETRIES = 2
# Each hold of this process that ended early: (op, algorithm, bytes, ms).
probe_short_spins: list[tuple[str, str, int, float]] = []


def _probe_size(op_name, launch, x, ps, repeats, algorithm, link):
    """One payload size of the microprobe: a warm-up call, then
    ``repeats`` timed calls; their seconds. On the card the timed calls
    queue behind a :class:`~horovod_tpu_torch.utils.spin.Spin` of
    ``PROBE_HOLD_CYCLES`` and a second warm-up call, and their samples
    reach the comms model only once the spin is seen to have held the
    stream on every member; a short spin on any member runs the size
    again on all, at most ``PROBE_SPIN_RETRIES`` times, then raises."""
    n = ps.size()

    def run(sample=True):
        return _run(op_name, [x], ps, lambda: launch(x), sample)

    run(sample=False)
    basics.sync_stream()
    if basics._state.device.type != "cuda":
        seconds = []
        for _ in range(max(1, int(repeats))):
            t0 = time.perf_counter()
            run()
            seconds.append(time.perf_counter() - t0)
        return seconds
    from ..utils.spin import Spin

    nbytes = n * x.numel() * x.element_size()
    for _ in range(PROBE_SPIN_RETRIES + 1):
        hold = Spin(PROBE_HOLD_CYCLES)
        run(sample=False)
        events = []
        for _ in range(max(1, int(repeats))):
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
            run(sample=False)
            events[-1][1].record()
        basics.sync_stream()
        # Every member runs the size again if any member's spin was short.
        short = torch.tensor([float(hold.short())], device=x.device)
        if n > 1:
            dist.all_reduce(short, op=dist.ReduceOp.MAX, group=ps.group)
        if not short.item():
            seconds = [a.elapsed_time(b) / 1e3 for a, b in events]
            for sec in seconds:
                try:
                    comms_model.observe(op_name, algorithm, link, nbytes,
                                        sec)
                except Exception:  # noqa: BLE001 — the model is advisory
                    pass
            return seconds
        probe_short_spins.append((op_name, algorithm, nbytes, hold.ms()))
    raise RuntimeError(
        f"run_comms_microprobe: the spin ahead of the timed {op_name} "
        f"({algorithm}, {nbytes} bytes) ended early "
        f"{PROBE_SPIN_RETRIES + 1} times ({probe_short_spins[-1][3]:.3f} "
        f"ms of at least {hold.least_ms():.3f}): its calls would have been "
        "timed from the host's dispatch")


def run_comms_microprobe(process_set=None, sizes=None,
                         repeats: int = 3) -> dict:
    """Seed the comms model (``comms_model.py``) with a sweep of payload
    sizes over a process set: at each size a warm-up call and then
    ``repeats`` timed calls of ``allreduce``, ``reducescatter``,
    ``allgather`` and ``alltoall`` (Sum, float32), each call's latency a
    sample of the model under the set's link class. The warm-up calls
    feed none: a communicator's first collective of a kind sets it up,
    and a process's first dispatch sets up its instruments. On the card
    the timed calls of a size are queued back to back behind a spin of
    ``PROBE_HOLD_CYCLES`` and a second warm-up call, which lines the
    ranks' streams up: each call's events then hold its device time, not
    the host's dispatch nor the ranks' skew (see :func:`_probe_size`).
    Collective: every member calls it at the same point.

    With the comms planner on (``HOROVOD_COMMS_PLANNER``) and the global
    set of two or more ranks, the sweep runs once per algorithm eligible
    for each op, under ``comms_planner.forced``, so that each schedule
    seeds its own ``(op, algorithm, link_class)`` fit; planner off, one
    flat pass. Returns ``{op: {nbytes: [seconds, ...]}}`` of the flat
    pass only: each timed call's device time on the card, its host time
    on the CPU, under the bytes as dispatched (the set's total payload,
    ``hvd_collective_payload_bytes``'s).

    Port of ``horovod_tpu/ops/collective_ops.py:966``."""
    ps = _resolve_process_set(process_set)
    n = ps.size()
    sizes = [int(s) for s in (sizes or comms_model.DEFAULT_PROBE_SIZES)]
    device = basics._state.device
    link = _link_class(ps)
    planner_live = (comms_planner.enabled() and n > 1
                    and ps.process_set_id == 0)
    islands = comms_planner._islands_for(n) if planner_live else None
    out: dict[str, dict] = {}
    for op_name, launch in (
        ("allreduce", lambda a: _launch_allreduce(a, Sum, 1.0, 1.0, ps)),
        ("reducescatter",
         lambda a: _launch_reducescatter(a, Sum, 1.0, 1.0, ps)),
        ("allgather", lambda a: _launch_allgather(a, ps)),
        ("alltoall", lambda a: _launch_alltoall(a, None, ps)),
    ):
        algorithms = (comms_planner.eligible_algorithms(op_name, n, islands)
                      if planner_live else ("flat",))
        per_op: dict[int, list] = {}
        for algorithm in algorithms:
            ctx = (comms_planner.forced(algorithm) if planner_live
                   else contextlib.nullcontext())
            with ctx:
                for nbytes in sizes:
                    # Rows of a multiple of n float32 elements, so that
                    # reducescatter's and alltoall's dim 0 divides by the
                    # set size.
                    elems = max(n, (nbytes // 4 // n) * n)
                    x = torch.ones(elems, dtype=torch.float32,
                                   device=device)
                    seconds = _probe_size(op_name, launch, x, ps, repeats,
                                          algorithm, link)
                    if algorithm == "flat":
                        per_op.setdefault(n * elems * 4, []).extend(seconds)
        out[op_name] = per_op
    # The card's latencies land when the inspector reaps their end events.
    _reap_collectives()
    comms_model.get_model().note_probe()
    return out
