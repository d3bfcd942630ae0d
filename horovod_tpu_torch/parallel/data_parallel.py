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
from ..attribution import CAT_PHASE, SPAN_FORWARD_BACKWARD
from ..ops.collective_ops import Average, allreduce
from ..utils import env


class _StallWatchedStep:
    """A training step, traced and stall-watched (see the module
    docstring). The JAX package's wrapper drains the pipeline with
    ``jax.block_until_ready`` on watched and sampled calls; this one waits
    for the current CUDA stream at the end of each phase
    (``tracing.phase``) and of the step. The cross-rank stallwatch
    announcement is not ported yet: a watched call holds the local ticket
    only."""

    def __init__(self, fn, name_prefix: str):
        self._fn = fn
        self._prefix = name_prefix
        self._every = env.get_int("HOROVOD_STALL_CHECK_STEPS", 50)
        self._calls = 0
        self._trace_calls = 0

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


def _fsdp_loss(model, loss_fn, optimizer):
    """``loss(batch)`` on just-in-time gathers of the fsdp optimizer's
    shards (``param_sharding.FsdpForward``)."""
    from .param_sharding import FsdpForward

    forward = FsdpForward(model, optimizer)

    def loss(batch):
        with forward.gathering():
            return loss_fn(model, batch)

    return loss


def make_train_step(model: torch.nn.Module,
                    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
                    optimizer, loss_is_averaged: bool = True):
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
    """
    from ..optimizer import _FsdpOptimizer

    k = getattr(optimizer, "backward_passes_per_step", 1)
    process_set = getattr(optimizer, "_ps", None)
    if isinstance(optimizer, _FsdpOptimizer):
        compute = _fsdp_loss(model, loss_fn, optimizer)
    else:
        def compute(batch):
            return loss_fn(model, batch)
    calls = 0

    def step(batch):
        from .. import basics

        if not basics.elastic():
            return run(batch)
        # An elastic world (the sharded and fsdp modes under
        # PeerShardedState): an armed abort raises before the step, a
        # failed collective inside it (in the backward's reduce-scatters
        # too) raises HorovodInternalError, and the step counts on the
        # worker's heartbeat.
        from .. import abort
        from ..ops.collective_ops import elastic_errors
        from ..runner.elastic.worker import record_step

        abort.raise_if_aborted()
        with elastic_errors():
            loss = run(batch)
        record_step()
        return loss

    def run(batch):
        nonlocal calls
        with tracing.phase(SPAN_FORWARD_BACKWARD, CAT_PHASE):
            loss = compute(batch)
            loss.backward()
        calls += 1
        if calls % k == 0:
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        loss = loss.detach()
        if loss_is_averaged:
            loss = allreduce(loss, op=Average, process_set=process_set)
        return loss

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
        "train_step")


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
