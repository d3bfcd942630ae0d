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
``HorovodInternalError``.
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
    time (``param_sharding.FsdpForward``).
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
    heartbeat. The sharded and fsdp modes are refused: their state is
    per-rank shards, which a re-formed world cannot re-assemble without
    the peer replica plane.
    """
    from .. import abort
    from ..exceptions import SyncModeIneligibleError
    from ..optimizer import sync_mode_of
    from ..runner.elastic.worker import record_step

    mode = sync_mode_of(optimizer)
    if mode == "sharded":
        raise SyncModeIneligibleError(
            "make_elastic_train_step does not support sync_mode='sharded' "
            "(its cross-process leg reduces on the host plane, outside the "
            "compiled shard domain); build the compiled step with "
            "make_train_step and let hvd.elastic.TpuState(...,"
            "sharded_optimizer=...) re-shard state across world changes")
    if mode == "fsdp":
        raise SyncModeIneligibleError(
            "make_elastic_train_step does not support sync_mode='fsdp' "
            "(its cross-process leg reduces on the host plane, outside "
            "the compiled shard domain where the per-segment parameter "
            "gathers live); build the compiled step with make_train_step "
            "and let hvd.elastic.PeerShardedState re-shard the resident "
            "parameter and optimizer shards across world changes")
    step = make_train_step(model, loss_fn, optimizer, loss_is_averaged)

    def elastic_step(batch):
        abort.raise_if_aborted()
        loss = step(batch)
        record_step()
        return loss

    return elastic_step
