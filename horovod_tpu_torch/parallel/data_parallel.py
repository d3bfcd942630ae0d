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
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..ops.collective_ops import Average, allreduce


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

    return step


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
