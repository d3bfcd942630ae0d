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
