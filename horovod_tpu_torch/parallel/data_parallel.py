"""Synchronous data-parallel training step.

Port of ``horovod_tpu/parallel/data_parallel.py:make_train_step`` (:382)
in allreduce mode (:461). Each rank holds its own shard of the batch and a
replica of the model; the ``DistributedOptimizer`` averages gradients.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..ops.collective_ops import Average, allreduce


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
    the optimizer's process set when ``loss_is_averaged``.
    """
    k = getattr(optimizer, "backward_passes_per_step", 1)
    process_set = getattr(optimizer, "_ps", None)
    calls = 0

    def step(batch):
        nonlocal calls
        loss = loss_fn(model, batch)
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
