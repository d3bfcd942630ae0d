"""Elastic training: ``hvd.elastic.run``, ``TorchState``, ``ElasticSampler``.

Port of ``horovod_tpu/elastic/`` and ``horovod_tpu/torch/elastic.py``
(``TorchState`` :30, ``ElasticSampler`` :80), the reference's
``horovod/torch/elastic/``: the ``@hvd.elastic.run`` retry loop
(``runner.py``) over a state that commits, restores and syncs
(``state.py``). Launch the script with ``hvdrun-torch
--host-discovery-script``::

    state = hvd.elastic.TorchState(model=model, optimizer=opt, epoch=0)

    @hvd.elastic.run
    def train(state):
        while state.epoch < epochs:
            ...
            state.epoch += 1
            state.commit()

    train(state)
"""

from __future__ import annotations

import copy
from typing import Any, Iterator

import numpy as np
import torch

from .. import abort
from ..basics import rank, size
from ..functions import (broadcast_object, broadcast_optimizer_state,
                         broadcast_parameters)
from .runner import run  # noqa: F401
from .state import ExtrasState, ObjectState, State  # noqa: F401

SHARDED_STATE_NOT_PORTED = (
    "TorchState does not take a sync_mode={mode!r} optimizer: its commits "
    "would hold only this rank's shards, and a dead rank's shards need the "
    "peer replica rung, which is not ported yet; use sync_mode='allreduce'")


class TorchState(ExtrasState):
    """Elastic state for a torch model + optimizer + user objects.

    ``TorchState(model=model, optimizer=opt, epoch=0, batch=0)``: the
    model's tensors commit as host copies, the optimizer's state as a deep
    copy; EVERY plain attribute (incl. ones assigned after construction)
    is tracked; ``sync()`` broadcasts everything from rank 0. ``restore()``
    also drops the ``DistributedOptimizer``'s buckets and in-flight work
    and the parameters' gradients, which belong to the failed step.
    """

    def __init__(self, model=None, optimizer=None, **extras: Any):
        from ..optimizer import sync_mode_of

        mode = sync_mode_of(optimizer) if optimizer is not None else None
        if mode in ("sharded", "fsdp"):
            raise ValueError(SHARDED_STATE_NOT_PORTED.format(mode=mode))
        super().__init__(**extras)
        self.model = model
        self.optimizer = optimizer
        self._saved_model = None
        self._saved_opt = None
        self.commit()

    def commit(self) -> None:
        saved_model = saved_opt = None
        if self.model is not None:
            saved_model = {
                k: v.detach().cpu().clone()
                for k, v in self.model.state_dict().items()
            }
        if self.optimizer is not None:
            saved_opt = copy.deepcopy(self.optimizer.state_dict())
        # A step that an abort cut short never becomes the rollback point
        # (state.py).
        abort.raise_if_aborted()
        self._saved_model, self._saved_opt = saved_model, saved_opt
        self.commit_extras()
        self.check_host_updates()

    def restore(self) -> None:
        if self.model is not None and self._saved_model is not None:
            self.model.load_state_dict(self._saved_model)
        if self.optimizer is not None and self._saved_opt is not None:
            # A copy: load_state_dict keeps tensors already of the
            # parameters' dtype and device, and the steps after a restore
            # would change the commit in place (the reference's
            # TorchState.restore restores them on a second restore).
            self.optimizer.load_state_dict(copy.deepcopy(self._saved_opt))
        if hasattr(self.optimizer, "_reset"):
            self.optimizer._reset()  # drop dead-world in-flight state
        if self.optimizer is not None:
            # The failed step's gradients, which the next backward would
            # add to.
            self.optimizer.zero_grad(set_to_none=True)
        self.restore_extras()

    def sync(self) -> None:
        if size() <= 1:
            return
        if self.model is not None:
            broadcast_parameters(self.model.state_dict(), root_rank=0)
        if self.optimizer is not None:
            broadcast_optimizer_state(self.optimizer, root_rank=0)
        self.sync_extras(
            lambda o: broadcast_object(o, root_rank=0,
                                       name="torch_state_extras"))
        self.commit()


class ElasticSampler(torch.utils.data.Sampler):
    """Shards a dataset by the CURRENT world and records progress.

    Parity: ``hvd.elastic.ElasticSampler``: on a world change
    (``set_epoch``/reset callback) the shard is recomputed for the new
    rank/size, and ``record_batch`` tracks processed indices so a restored
    epoch resumes where it left off instead of replaying data.
    """

    def __init__(self, dataset, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: set[int] = set()
        self.reset()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.processed_indices.clear()
        self.reset()

    def reset(self) -> None:
        """Recompute this rank's shard for the current world size."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        remaining = [i for i in order.tolist()
                     if i not in self.processed_indices]
        n_ranks = max(1, size())
        # Pad by wrapping so every rank gets the SAME batch count: an
        # uneven split would leave one rank issuing a collective nobody
        # else joins.
        total = ((len(remaining) + n_ranks - 1) // n_ranks) * n_ranks
        if remaining:
            padded = remaining + remaining[: total - len(remaining)]
        else:
            padded = []
        self.indices = padded[rank()::n_ranks]

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        """Mark a processed batch (call after each step, before commit)."""
        start = batch_idx * batch_size
        chunk = self.indices[start:start + batch_size]
        self.processed_indices.update(chunk)

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices)

    def __len__(self) -> int:
        return len(self.indices)

