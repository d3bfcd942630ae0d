"""Synchronous data-parallel training step.

Port of ``horovod_tpu/parallel/data_parallel.py:make_train_step`` (:382),
dispatching on the ``DistributedOptimizer``'s sync mode as :382-460 does.
Each rank holds its own shard of the batch. In allreduce and sharded mode
it holds a replica of the model, and the optimizer averages gradients (and,
sharded, gathers the updated parameters). In fsdp mode (:606-690) it holds
only its shards of the parameters: each call runs the model on segments
gathered just in time as its forward reads them
(``param_sharding.FsdpForward``), and the optimizer updates the shards in
place.

``make_elastic_train_step`` (:1205) is the allreduce step for elastic
worlds: it keeps working after the world re-forms at another size, and a
posted abort or a failed collective surfaces from it as
``HorovodInternalError``. The sharded and fsdp modes train elastically
with ``make_train_step`` and ``hvd.elastic.PeerShardedState``.

With ``HOROVOD_AUTOTUNE=1`` the step is wrapped in the warmup tuner
(``autotune.maybe_autotune_step``, :486-536): its first calls sample the
fusion threshold (and, with ``HOROVOD_COMMS_PLANNER=auto``, the planner's
algorithm axis) and pin the fastest; the step carries the optimizer's
``rebucket``, the port's counterpart of the JAX step's re-trace.

Both return a :class:`_StallWatchedStep` (:22-180), the step traced and
stall-watched (outside the tuner; watch and sampling defer while a window
samples, and every call raises after a mid-warmup abort, :88-103): every
call opens a step record in the tracer's ring, with
the phases ``forward_backward`` here and ``collective`` and
``optimizer_update`` in the ``DistributedOptimizer``'s step. Every
``HOROVOD_STALL_CHECK_STEPS``-th call (default 50) runs under a stall
ticket (``stall.watch``) and every ``HOROVOD_TRACE_SAMPLE``-th call is
shipped to the rendezvous server; those calls are synced: each phase ends
after the work it queued on the current CUDA stream has run
(``tracing.phase``), so the phase spans time the card and a synced step
feeds step-time attribution (``attribution.note_step``). The other calls
add no synchronization: their spans time the launch. An out-of-memory
error (``torch.cuda.OutOfMemoryError``, ``memory.is_oom_error``) out of a
call dumps the memory observatory's flight record and is raised again
unchanged (:150-180); the ``memory.pressure`` fault point injects one.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .. import faults, memory, tracing
from ..attribution import (CAT_COLLECTIVE, CAT_PHASE, SPAN_COLLECTIVE,
                           SPAN_FORWARD_BACKWARD, SPAN_OPTIMIZER_UPDATE)
from ..ops.collective_ops import Average, allreduce, direct
from ..utils import env


# Worlds formed by this process (``basics.on_init``): a step counts its
# calls from its first call in each world.
_worlds = [0]


def _count_world() -> None:
    _worlds[0] += 1


class _StallWatchedStep:
    """A training step, traced and stall-watched (see the module
    docstring). The JAX package's wrapper drains the pipeline with
    ``jax.block_until_ready`` on watched and sampled calls; this one waits
    for the current CUDA stream at the end of each phase
    (``tracing.phase``) and of the step; in a multi-rank world a watched
    call's ``stall.watch`` also announces ``stallwatch/<prefix>.<call>``
    on the negotiated runtime, so rank 0's controller names a rank that
    does not reach it. The calls count from the step's first call in the
    current world, so that a rank that joined it (a replacement, a
    promoted spare) names its watched calls as its peers do."""

    def __init__(self, fn, name_prefix: str):
        from .. import basics

        self._fn = fn
        self._prefix = name_prefix
        self._every = env.get_int("HOROVOD_STALL_CHECK_STEPS", 50)
        self._calls = 0
        self._trace_calls = 0
        if _count_world not in basics._init_hooks:
            basics.on_init(_count_world)
        self._world = _worlds[0]

    @staticmethod
    def _tuning_live() -> bool:
        """Whether an autotune warmup is sampling in this process (its
        own step or another's): a watched or sampled call's syncs would
        bias its windows, so both defer."""
        from ..autotune import _active_tuner

        return bool(_active_tuner and _active_tuner[0]._hvd_tuning)

    def __call__(self, *args, **kwargs):
        from .. import basics
        from ..autotune import _poison_error, warmup_aborted
        from ..stall import watch
        from ..timeline import activity, mark_cycle

        if warmup_aborted():
            # A mid-warmup autotune abort poisons every factory step of
            # the process: its peers may have pinned another decision.
            raise _poison_error()
        mark_cycle("step")
        if self._world != _worlds[0]:
            self._world = _worlds[0]
            self._calls = self._trace_calls = 0
        tuning = self._tuning_live()
        watch_due = False
        if self._every > 0 and not tuning:
            self._calls += 1
            watch_due = self._calls % self._every == 0
        # Sampling counts this wrapper's calls, so that two interleaved
        # steps (train and eval) cannot alias one out of sampling.
        self._trace_calls += 1
        sample = tracing.sample_every()
        sample_due = (not tuning and sample > 0
                      and self._trace_calls % sample == 0)
        try:
            if faults.fire(faults.MEMORY_PRESSURE):
                # drop: a synthetic out-of-memory error at the step
                # boundary, caught and dumped just below as a real one is.
                raise torch.cuda.OutOfMemoryError(
                    "out of memory: injected memory pressure (fault point "
                    "memory.pressure)")
            with activity(self._prefix, "step"), \
                    tracing.get_tracer().step_scope(self._prefix) as rec:
                rec.sync = watch_due or sample_due
                if watch_due:
                    with watch(name=f"{self._prefix}.{self._calls}"):
                        out = self._fn(*args, **kwargs)
                        basics.sync_stream()
                else:
                    out = self._fn(*args, **kwargs)
                    if sample_due:
                        basics.sync_stream()
                rec.synced = rec.sync
                rec.ship = sample_due
        except Exception as exc:
            # The step boundary is the memory observatory's forensics
            # consumer: an out-of-memory error dumps the memory flight
            # record (the largest resident leaves, the model's drift) and
            # goes on up untouched; recovering is the elastic loop's.
            if memory.is_oom_error(exc):
                memory.dump_oom_record(exc, step=self._prefix)
            raise
        return out

    @property
    def _hvd_unwatched(self):
        """The bare step: ``autotune.tune_step_fusion`` times it, so that
        a watched call's syncs cannot bias a candidate."""
        return self._fn

    def __getattr__(self, item):
        if item == "_fn":  # lookup before __init__ must not recurse
            raise AttributeError(item)
        return getattr(self._fn, item)


def _planner_autotune_candidates():
    """The comms planner's algorithm axis for the warmup tuner (non-None
    only with ``HOROVOD_COMMS_PLANNER=auto`` and more than one algorithm
    eligible in this world: ``comms_planner.autotune_candidates``)."""
    from ..ops.comms_planner import autotune_candidates

    return autotune_candidates()


def _fsdp_loss(model, loss_fn, optimizer, num_segments=None):
    """``loss(batch)`` on just-in-time gathers of the fsdp optimizer's
    shards (``param_sharding.FsdpForward``, ``num_segments`` segments)."""
    from .param_sharding import FsdpForward

    forward = FsdpForward(model, optimizer, num_segments)

    def loss(batch):
        with forward.gathering():
            return loss_fn(model, batch)

    return loss


class DeferredParams:
    """Handle over the sharded step's updated-parameter allgather, left in
    flight by ``make_train_step(..., deferred_param_gather=True)``
    (reference :234). The gather's collectives are launched when the step
    returns and run while the host does other work between steps; the
    next call of the step, the model's forward (a pre-hook) and whatever
    else reads the parameters (``broadcast_parameters``, the checkpoint
    functions, the elastic states' commits:
    ``optimizer.wait_deferred_gathers``) finish it first.
    :attr:`params` finishes it and returns the parameters;
    :meth:`block_until_ready` also waits for the card."""

    def __init__(self, optimizer):
        self._opt = optimizer

    @property
    def params(self) -> list[torch.Tensor]:
        self._opt.settle()
        return list(self._opt._params)

    def block_until_ready(self) -> list[torch.Tensor]:
        from .. import basics

        params = self.params
        basics.sync_stream()
        return params


def _guarded_run(run):
    """``run`` as a step: in an elastic world (the sharded and fsdp modes
    under PeerShardedState) an armed abort raises before the step, a
    failed collective inside it (in the backward's launches too) raises
    HorovodInternalError, and the step counts on the worker's
    heartbeat."""

    def step(batch):
        from .. import basics

        if not basics.elastic():
            return run(batch)
        from .. import abort
        from ..ops.collective_ops import elastic_errors
        from ..runner.elastic.worker import record_step

        abort.raise_if_aborted()
        with elastic_errors():
            loss = run(batch)
        record_step()
        return loss

    return step


def _averaged(loss, loss_is_averaged, process_set):
    """The step's returned loss: detached, and averaged over the process
    set (the step's own collective: direct, never negotiated)."""
    loss = loss.detach()
    if loss_is_averaged:
        with direct():
            loss = allreduce(loss, op=Average, process_set=process_set)
    return loss


def make_train_step(model: torch.nn.Module,
                    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
                    optimizer, loss_is_averaged: bool = True,
                    deferred_param_gather: bool = False):
    """Build ``step(batch) -> loss``.

    ``loss_fn(model, batch)`` returns this rank's scalar mean loss. Each
    call runs one forward and backward pass; with a
    ``DistributedOptimizer(backward_passes_per_step=k)`` the update (and
    ``zero_grad``) happens on every k-th call, as the JAX step leaves the
    parameters unchanged between accumulation boundaries. The returned loss
    is the one computed before the update, averaged across the ranks of
    the optimizer's process set when ``loss_is_averaged``. With an fsdp
    ``DistributedOptimizer`` (built over ``model.parameters()``) the model
    runs on parameters gathered from the optimizer's shards, a segment at a
    time (``param_sharding.FsdpForward``). In an elastic world an armed
    abort or a failed collective raises ``HorovodInternalError`` from the
    step, as from :func:`make_elastic_train_step`'s.

    ``deferred_param_gather`` (sharded mode only, reference :408-414): the
    step returns with the updated-parameter allgather in flight, and
    ``step.deferred_params`` (a :class:`DeferredParams`) finishes it; the
    model's next forward and the next call finish it first. The int8 wire
    salts that gather with the update count before the update's increment,
    as the gather in the step does. Such a step is not wrapped in the
    warmup tuner (reference :601-603).
    """
    from ..exceptions import SyncModeIneligibleError
    from ..optimizer import sync_mode_of

    mode = sync_mode_of(optimizer)
    if deferred_param_gather and mode == "fsdp":
        raise SyncModeIneligibleError(
            "deferred_param_gather does not apply to sync_mode='fsdp': "
            "fsdp has NO trailing parameter allgather to defer — the "
            "shard-local update writes back to the resident shard, and "
            "the next forward's per-segment gathers are the only "
            "re-materialization")
    if deferred_param_gather and mode != "sharded":
        raise ValueError(
            "deferred_param_gather requires a DistributedOptimizer built "
            "with sync_mode='sharded' (there is no parameter allgather to "
            "defer in allreduce mode)")
    return _make_train_step(model, loss_fn, optimizer, loss_is_averaged,
                            deferred=deferred_param_gather)


def _make_train_step(model, loss_fn, optimizer, loss_is_averaged,
                     deferred=False, num_segments=None,
                     name_prefix="train_step"):
    """:func:`make_train_step`'s step; ``num_segments`` sets fsdp's segment
    count (None: ``fusion.fsdp_segments()``), ``name_prefix`` the stall
    watch's and the tracer's name."""
    from ..optimizer import _FsdpOptimizer

    k = getattr(optimizer, "backward_passes_per_step", 1)
    process_set = getattr(optimizer, "_ps", None)
    if isinstance(optimizer, _FsdpOptimizer):
        compute = _fsdp_loss(model, loss_fn, optimizer, num_segments)
    else:
        def compute(batch):
            return loss_fn(model, batch)
    if deferred:
        optimizer._defer_gather = True
        # The forward reads the parameters: the gather in flight ends first.
        model.register_forward_pre_hook(lambda *_: optimizer.settle())
    calls = 0

    def run(batch):
        nonlocal calls
        if deferred:
            optimizer.settle()
        with tracing.phase(SPAN_FORWARD_BACKWARD, CAT_PHASE):
            loss = compute(batch)
            loss.backward()
        calls += 1
        if calls % k == 0:
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        return _averaged(loss, loss_is_averaged, process_set)

    step = _guarded_run(run)
    if deferred:
        step.deferred_params = DeferredParams(optimizer)
        # No warmup tuner: the step leaves its gather in flight, and the
        # tuner's windows end in a read of the step's output alone.
        return _StallWatchedStep(step, name_prefix)
    # The warmup tuner's re-trace: re-bucket the optimizer from the pins.
    rebucket = getattr(optimizer, "rebucket", None)
    if rebucket is not None:
        step.rebucket = rebucket
    # Stall watch outside the autotuner (HOROVOD_AUTOTUNE=1), which owns
    # the re-bucketing; the watch defers while a window samples.
    from ..autotune import maybe_autotune_step

    return _StallWatchedStep(
        maybe_autotune_step(
            step, algorithm_candidates=_planner_autotune_candidates()),
        name_prefix)


class _Overlap:
    """One backward's segment reductions (reference ``_segment_sync``,
    :829). The model runs on proxies of the leaves: each a new leaf tensor
    over its leaf's storage (the identity forward). A proxy's
    post-accumulate hook counts its gradient in; once a segment's proxies
    all hold theirs, the segment's reduction is launched on the wire.

    The reference's boundary is a custom-vjp node. Here a
    ``torch.autograd.Function`` would be created before the forward and
    run last: the engine runs the ready node created latest first, so it
    would launch every segment after the whole backward. Autograd runs a
    leaf's accumulator as soon as its gradient is complete, so the proxies'
    hooks launch each segment where its gradients finish.

    Segments launch in one fixed order, last segment first, so that every
    rank issues the same collectives in the same order whatever order its
    backward completes them in: a segment complete before the segment
    above it has launched waits for it. When the backward ends (a callback
    queued on autograd's engine) every segment not launched yet launches,
    on zeros where a proxy got no gradient, as the reference's cotangents
    are zeros. A launch and a finish only queue the collective and its
    wait: nothing here waits for the card, so the backward's later kernels
    run while a segment reduces."""

    def __init__(self, spec, leaves, segments, salt, write_grads):
        self.spec, self.leaves, self.segments = spec, leaves, segments
        self.salt, self.write_grads = salt, write_grads
        self.seg_of = {i: si for si, idx in enumerate(segments)
                       for i in idx}
        self.waiting = [len(idx) for idx in segments]
        self.finishers: list = [None] * len(segments)
        self.next = len(segments) - 1
        self.buckets = 0
        self.queued = False
        self.proxies: list[torch.Tensor] = []
        self.hooks: list = []

    def proxy(self) -> list[torch.Tensor]:
        """The leaves' proxies, hooked."""
        for i, leaf in enumerate(self.leaves):
            q = leaf.detach().requires_grad_(True)
            self.hooks.append(q.register_post_accumulate_grad_hook(
                lambda _, i=i: self._ready(i)))
            self.proxies.append(q)
        return self.proxies

    def _ready(self, i: int) -> None:
        si = self.seg_of[i]
        if si > self.next:
            raise RuntimeError(
                "overlap_gradient_sync: a gradient reached a segment that "
                "was already reduced; wrap the parameters once per "
                "backward pass")
        self.waiting[si] -= 1
        if not self.queued:
            self.queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._backward_end)
        while self.next >= 0 and self.waiting[self.next] == 0:
            self._launch(self.next)

    def _launch(self, si: int) -> None:
        from ..optimizer import reduce_segment
        from ..profiler import annotate_collective

        grads = []
        for i in self.segments[si]:
            q = self.proxies[i]
            grads.append(q.grad if q.grad is not None
                         else torch.zeros_like(q))
            q.grad = None
        with annotate_collective(f"overlap.segment{si}"):
            self.finishers[si], n = reduce_segment(self.spec, grads,
                                                   self.salt)
        self.buckets += n
        self.next -= 1

    def flush(self) -> None:
        """Launch every segment not launched yet, in order, and unhook the
        proxies: a hook holds this object, which holds the proxies, and
        the garbage collector does not see through a tensor's hooks."""
        while self.next >= 0:
            self._launch(self.next)
        for h in self.hooks:
            h.remove()
        self.hooks, self.proxies = [], []

    def finish(self, si: int) -> list[torch.Tensor]:
        """Segment ``si``'s reduced gradients (sharded: this rank's
        shards); its wire buffers are let go."""
        from ..profiler import annotate_collective

        finish, self.finishers[si] = self.finishers[si], None
        with annotate_collective(f"overlap.segment{si}.finish"):
            return finish()

    def _backward_end(self) -> None:
        self.flush()
        if not self.write_grads:
            return
        sharded = self.spec.sync_mode == "sharded"
        ps = self.spec.process_set
        for si in reversed(range(len(self.segments))):
            for i, g in zip(self.segments[si], self.finish(si)):
                leaf = self.leaves[i]
                if sharded:
                    # The reference's zero background with the shard at
                    # its owner's offset (optimizer._embed_shards).
                    full = g.new_zeros(ps.size() * g.numel())
                    r = ps.rank()
                    full[r * g.numel():(r + 1) * g.numel()] = g
                    g = full[:leaf.numel()].view(leaf.shape)
                with torch.no_grad():
                    if leaf.grad is None:
                        leaf.grad = g.clone()
                    else:
                        leaf.grad.copy_(g)


def _unique_leaves(leaves):
    """``(unique, where)``: the leaves once each (a tied tensor appears
    once), and each input's index among them."""
    unique, index, where = [], {}, []
    for t in leaves:
        if id(t) not in index:
            index[id(t)] = len(unique)
            unique.append(t)
        where.append(index[id(t)])
    return unique, where


def overlap_gradient_sync(params, spec, num_segments: int | None = None,
                          salt=None):
    """Wrap parameters so that their gradients are reduced segment by
    segment inside the backward pass: the overlap scheduler's primitive
    (reference :926).

    ``params`` is a dict or a list of parameter tensors; the result has the
    same structure. Its leaves (a tied tensor counted once) are split into
    ``num_segments`` contiguous byte-balanced segments
    (``fusion.segment_leaves``; default ``fusion.overlap_segments()``: the
    autotune pin or ``HOROVOD_OVERLAP_SEGMENTS``). The result holds a proxy
    of each leaf (a new leaf tensor over its storage: the identity
    forward); once the backward has formed the gradients of a segment's
    proxies, the segment's reduction is launched on ``spec``'s wire
    (``optimizer.reduce_segment``, salted by ``salt`` on the int8 wire),
    last segment first, while the rest of the backward runs. No gradient
    reaches the leaves through autograd, so a ``DistributedOptimizer``'s
    own hooks on them never fire. When ``backward()`` returns, each leaf's
    ``.grad`` holds
    its reduced gradient (sharded: this rank's shard at its offset on a
    zero background, as the reference's boundary leaves it). Use it inside
    the differentiated function, once per backward::

        spec = hvd.reduce_spec_of(dist_optimizer)
        synced = hvd.overlap_gradient_sync(dict(model.named_parameters()),
                                           spec)
        loss = loss_fn(torch.func.functional_call(model, synced, (x,)), y)
        loss.backward()      # .grad reduced
        spec.inner.step()    # the bare update

    Every rank must reach ``backward()`` through the result (a rank whose
    loss reads no leaf launches nothing). The whole leaf layout is noted on
    the observatories first, as the reference notes it.
    """
    from ..ops.fusion import note_leaf_layout, overlap_segments, segment_leaves

    names = list(params) if isinstance(params, dict) else None
    given = list(params.values()) if names is not None else list(params)
    leaves, where = _unique_leaves(given)
    layout = [(t.numel(), t.dtype) for t in leaves]
    note_leaf_layout(layout)
    k = num_segments if num_segments is not None else overlap_segments()
    overlap = _Overlap(spec, leaves, segment_leaves(layout, k), salt,
                       write_grads=True)
    proxies = overlap.proxy()
    out = [proxies[j] for j in where]
    return dict(zip(names, out)) if names is not None else out


class _LossOf(torch.nn.Module):
    """``loss_fn(model, batch)`` as a module, so that
    ``torch.func.functional_call`` can run it on other tensors in place of
    the model's parameters (their names prefixed ``model.``)."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


def make_overlapped_train_step(model: torch.nn.Module,
                               loss_fn: Callable[[torch.nn.Module, Any],
                                                 torch.Tensor],
                               optimizer, num_segments: int | None = None,
                               loss_is_averaged: bool = True):
    """Build ``step(batch) -> loss`` whose gradient reductions overlap the
    backward pass: Horovod's headline optimization (reference :996).

    ``optimizer`` must be a ``DistributedOptimizer``: its wire
    (:class:`~horovod_tpu_torch.optimizer.ReduceSpec`) is issued per
    segment. In allreduce and sharded mode the model runs on its
    parameters through :func:`overlap_gradient_sync`'s proxies
    (``torch.func.functional_call``), so the last segment's reduction
    (reduce-scatter, sharded) launches while the earlier layers still
    differentiate; then the segments are finished and updated one at a
    time, last first, with the wrapped optimizer applied to the reduced
    gradients (sharded: to this rank's shards, each segment's updated
    parameters gathered after its update), so segment i's update is queued
    while segment i-1 still reduces. The step applies the bare update, as
    the reference's does: ``HOROVOD_NONFINITE_ACTION`` is not read. fsdp
    mode is :func:`make_train_step`'s fsdp step with ``num_segments``
    honored (its gather boundaries already reduce-scatter inside the
    backward).

    ``num_segments`` fixes the segment count; None follows
    ``fusion.overlap_segments()``, and under ``HOROVOD_AUTOTUNE=1`` the
    warmup tuner sweeps the joint (threshold, segments) grid
    (``autotune.DEFAULT_SEGMENT_CANDIDATES``): the step's ``rebucket``
    re-derives the segments from the pin at a step boundary. An explicit
    count tunes the threshold only. Refused, with the reference's words:
    a bare optimizer, and ``backward_passes_per_step > 1``.
    """
    from ..optimizer import reduce_spec_of

    spec = reduce_spec_of(optimizer)
    if spec is None:
        raise ValueError(
            "make_overlapped_train_step requires a DistributedOptimizer-"
            "wrapped optimizer (its ReduceSpec tells the scheduler which "
            "wire to issue per segment); got a bare optimizer")
    if spec.backward_passes_per_step != 1:
        raise ValueError(
            "the overlap scheduler does not compose with "
            "backward_passes_per_step > 1: accumulation defers the "
            "reduction to every k-th microstep, so most steps have no "
            "communication to overlap — use make_train_step")
    if spec.sync_mode == "fsdp":
        return _make_train_step(model, loss_fn, optimizer, loss_is_averaged,
                                num_segments=num_segments,
                                name_prefix="overlapped_train_step")
    from ..ops.fusion import overlap_segments, segment_leaves
    from ..optimizer import _is_int8

    leaves = optimizer._params
    names_of: dict[int, str] = {}
    for name, p in model.named_parameters():
        names_of.setdefault(id(p), name)
    missing = [i for i, p in enumerate(leaves) if id(p) not in names_of]
    if missing:
        raise ValueError(
            "make_overlapped_train_step: the DistributedOptimizer holds "
            "parameters that are not the model's: build it over "
            "model.parameters()")
    names = [f"model.{names_of[id(p)]}" for p in leaves]
    layout = [(p.numel(), p.dtype) for p in leaves]
    wrapped = _LossOf(model, loss_fn)
    int8 = _is_int8(spec.compression)
    plan = {"segments": segment_leaves(
        layout, num_segments if num_segments is not None
        else overlap_segments())}

    def run(batch):
        segments = plan["segments"]
        optimizer.zero_grad(set_to_none=True)
        overlap = _Overlap(reduce_spec_of(optimizer), leaves, segments,
                           optimizer._updates if int8 else None,
                           write_grads=False)
        with tracing.phase(SPAN_FORWARD_BACKWARD, CAT_PHASE):
            loss = torch.func.functional_call(
                wrapped, dict(zip(names, overlap.proxy())), (batch,))
            loss.backward()
            # Segments that no gradient reached (none on this rank).
            overlap.flush()
        for si in reversed(range(len(segments))):
            with tracing.phase(SPAN_COLLECTIVE, CAT_COLLECTIVE):
                grads = overlap.finish(si)
            with tracing.phase(SPAN_OPTIMIZER_UPDATE, CAT_PHASE):
                optimizer._apply_segment(segments[si], grads)
        optimizer._end_segments(overlap.buckets)
        return _averaged(loss, loss_is_averaged, spec.process_set)

    step = _guarded_run(run)
    step.segments = lambda: [list(s) for s in plan["segments"]]

    def rebucket():
        # The warmup tuner's re-trace: the optimizer's buckets, and the
        # segments from the pinned count (an explicit count stays).
        optimizer.rebucket()
        if num_segments is None:
            plan["segments"] = segment_leaves(layout, overlap_segments())

    step.rebucket = rebucket
    from ..autotune import DEFAULT_SEGMENT_CANDIDATES, maybe_autotune_step

    return _StallWatchedStep(
        maybe_autotune_step(
            step,
            segment_candidates=(None if num_segments is not None
                                else DEFAULT_SEGMENT_CANDIDATES),
            algorithm_candidates=_planner_autotune_candidates()),
        "overlapped_train_step")


def make_elastic_train_step(model: torch.nn.Module,
                            loss_fn: Callable[[torch.nn.Module, Any],
                                              torch.Tensor],
                            optimizer, loss_is_averaged: bool = True):
    """Build ``step(batch) -> loss`` for an elastic world
    (``@hvd.elastic.run``).

    The allreduce step of :func:`make_train_step`: gradients and the loss
    average over the ranks in the world at each call, so the step keeps
    working after the world re-forms at another size. An armed
    coordinated abort raises ``HorovodInternalError`` before the step
    runs, and a collective that fails inside it (the optimizer's, the
    loss average's) raises ``HorovodInternalError``; each call counts as a step on the worker's
    heartbeat. The sharded and fsdp modes are refused, as the reference
    refuses them (:1238-1250): their step is ``make_train_step``'s, under
    ``hvd.elastic.PeerShardedState``, whose peer rung re-assembles the
    per-rank shards of a re-formed world.
    """
    from ..exceptions import SyncModeIneligibleError
    from ..optimizer import sync_mode_of

    mode = sync_mode_of(optimizer)
    if mode == "sharded":
        raise SyncModeIneligibleError(
            "make_elastic_train_step does not support sync_mode='sharded' "
            "(its cross-process leg reduces on the host plane, outside the "
            "compiled shard domain); build the step with make_train_step "
            "and let hvd.elastic.PeerShardedState(model=..., optimizer=...) "
            "re-shard the optimizer state across world changes")
    if mode == "fsdp":
        raise SyncModeIneligibleError(
            "make_elastic_train_step does not support sync_mode='fsdp' "
            "(its cross-process leg reduces on the host plane, outside "
            "the compiled shard domain where the per-segment parameter "
            "gathers live); build the compiled step with make_train_step "
            "and let hvd.elastic.PeerShardedState re-shard the resident "
            "parameter and optimizer shards across world changes")
    return make_train_step(model, loss_fn, optimizer, loss_is_averaged)
