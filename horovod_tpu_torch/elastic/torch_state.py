"""The elastic states of torch models: ``TorchState``, ``PeerShardedState``,
``ElasticSampler``.

Port of ``horovod_tpu/torch/elastic.py`` (``TorchState`` :30,
``ElasticSampler`` :80) and ``PeerShardedState``
(``horovod_tpu/elastic/state.py:540-848``), reached as
``hvd.elastic.TorchState`` etc. (the package resolves them here at first
use, see ``elastic/__init__.py``).
"""

from __future__ import annotations

import copy
import pickle
import time
from typing import Any, Iterator

import numpy as np
import torch

from .. import abort, faults, integrity
from ..basics import rank, size
from ..checkpoint import _host_copy
from ..functions import (broadcast_object, broadcast_optimizer_state,
                         broadcast_parameters)
from .state import ExtrasState, note_memory

SHARDED_STATE_REFUSED = (
    "TorchState does not take a sync_mode={mode!r} optimizer: its commits "
    "would hold only this rank's shards, and a dead rank's shards come back "
    "only through the peer replica rung; use "
    "hvd.elastic.PeerShardedState(model=..., optimizer=...) for the sharded "
    "and fsdp modes, or sync_mode='allreduce' with TorchState")


class TorchState(ExtrasState):
    """Elastic state for a torch model + optimizer + user objects.

    ``TorchState(model=model, optimizer=opt, epoch=0, batch=0)``: the
    model's tensors commit as host copies, the optimizer's state as a deep
    copy; EVERY plain attribute (incl. ones assigned after construction)
    is tracked; ``sync()`` broadcasts everything from rank 0. ``restore()``
    also drops the ``DistributedOptimizer``'s buckets and in-flight work
    and the parameters' gradients, which belong to the failed step. Built,
    it notes the model's parameters and the optimizer's state on the
    memory observatory (``state.note_memory``).
    """

    def __init__(self, model=None, optimizer=None, **extras: Any):
        from ..optimizer import sync_mode_of

        mode = sync_mode_of(optimizer) if optimizer is not None else None
        if mode in ("sharded", "fsdp"):
            raise ValueError(SHARDED_STATE_REFUSED.format(mode=mode))
        super().__init__(**extras)
        self.model = model
        self.optimizer = optimizer
        self._saved_model = None
        self._saved_opt = None
        # The world-aligned commit counter the integrity plane gates its
        # fingerprints on (realigned at sync()).
        self._commit_count = 0
        note_memory(model, optimizer)
        self.commit()

    def commit(self) -> None:
        from ..optimizer import wait_deferred_gathers

        wait_deferred_gathers()
        self._integrity_precommit()
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
        # The grad.corrupt injector writes a corrupted copy of the saved
        # state, never the live one; the fingerprint sees what was saved.
        saved = integrity.maybe_corrupt_snapshot(
            {"params": saved_model, "opt_state": saved_opt})
        self._saved_model, self._saved_opt = (saved["params"],
                                              saved["opt_state"])
        self._commit_count += 1
        integrity.maybe_fingerprint(self._saved_model, self._saved_opt,
                                    self._commit_count)
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
        if integrity.enabled():
            # Rank 0's commit counter for everyone, so every rank of the
            # new world fingerprints the same commits (only the voting
            # plane reads it: unarmed, sync() broadcasts what it did).
            self._commit_count = int(broadcast_object(
                self._commit_count, root_rank=0,
                name="torch_state_commit_count"))
        self.commit()


def _broadcast_full(full, src: int):
    """``src``'s full state (host tensors) on every rank: its structure and
    small values as one object, each tensor of one or more dimensions
    through the world's backend on the device, one at a time, back on the
    host."""
    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from .. import basics

    if basics.size() == 1:
        return full
    mine = basics.rank() == src
    leaves, spec = pytree.tree_flatten(full) if mine else ([], None)
    big = {i: (x.shape, x.dtype) for i, x in enumerate(leaves)
           if torch.is_tensor(x) and x.dim() > 0}
    spec, out, big = broadcast_object(
        (spec, [None if i in big else x for i, x in enumerate(leaves)], big),
        root_rank=src)
    dev = basics.device()
    for i, (shape, dtype) in big.items():
        buf = (leaves[i].to(dev) if mine
               else torch.empty(shape, dtype=dtype, device=dev))
        dist.broadcast(buf, src=src)
        out[i] = leaves[i] if mine else buf.cpu()
    return pytree.tree_unflatten(out, spec)


class PeerShardedState(ExtrasState):
    """Elastic state for a ``sync_mode="sharded"`` or ``"fsdp"``
    ``DistributedOptimizer`` with shard-local commits, replicated to the
    peers: the state under the ladder's ``peer`` rung
    (``horovod_tpu/elastic/state.py:540``).

    ``commit()`` takes a host copy of this rank's rows of the optimizer
    state (fsdp: and of its parameter shards; sharded: rank 0 adds the
    model's state dict, whose parameters every rank holds in full) and
    publishes it through a ``peercheck.PeerReplicator``. After a failure,
    ``restore()`` marks the state pending and ``sync()`` refuses it: the
    other ranks' rows are gone with this rank's own commit unable to
    re-form the world. The ``peer`` rung (:meth:`_restore_from_peers`)
    assembles the last complete replica set, rebuilds the full parameters
    and optimizer state (``checkpoint.assemble_full_params``,
    ``unshard_opt_state``), and the next ``sync()`` broadcasts rank 0's
    full state and re-shards it for the current world
    (``reshard_opt_state``, ``load_sharded_state``; fsdp: the parameter
    shards) on each rank's device. The durable rung feeds
    :meth:`install_full`. ``replicator`` defaults to one over the rendezvous
    server of the launcher's env and the optimizer's process set.
    """

    def __init__(self, model=None, optimizer=None, replicator=None,
                 **extras: Any):
        from .. import peercheck
        from ..optimizer import sync_mode_of

        if optimizer is None or sync_mode_of(optimizer) == "allreduce":
            raise ValueError(
                "PeerShardedState requires a sync_mode='sharded' or 'fsdp' "
                "DistributedOptimizer: shard ownership is what gets "
                "replicated (use TorchState for sync_mode='allreduce')")
        super().__init__(**extras)
        self.model = model
        self.optimizer = optimizer
        self._fsdp = sync_mode_of(optimizer) == "fsdp"
        ps = optimizer._ps
        if replicator is None:
            replicator = peercheck.PeerReplicator(
                rank_fn=ps.rank, world_size_fn=ps.size)
        self._replicator = replicator
        self._peer_dirty = False
        self._full: dict | None = None
        self._commit_seq = 0
        self.register_peer_restore(self._restore_from_peers)
        self.commit()

    # -- world facts ---------------------------------------------------------

    def _layout_world(self) -> int:
        """The world size the optimizer's shards were cut for."""
        opt = self.optimizer
        return opt.meta.world_size if self._fsdp else opt._n

    def _sharded_names(self) -> set:
        """The model's state-dict names of the optimizer's parameters."""
        ids = {id(p) for p in self.optimizer._params}
        return {name for name, p in self.model.named_parameters()
                if id(p) in ids} if self.model is not None else set()

    def peer_restore_pending(self) -> bool:
        return self._peer_dirty and self.peer_restore_armed()

    def needs_world_sync(self) -> bool:
        return (self._peer_dirty or self._full is not None
                or self._layout_world() != self.optimizer._ps.size())

    # -- shard-local commit and replication ----------------------------------

    def commit(self) -> None:
        opt = self.optimizer
        settle = getattr(opt, "settle", None)
        if settle is not None:  # a deferred parameter gather in flight
            settle()
        self._integrity_precommit()
        r = opt._ps.rank()
        row = _host_copy(opt._opt.state_dict())
        row["salt_counter"] = opt._updates
        param_row = param_meta = model_state = params = None
        if self._fsdp:
            param_row = [t.detach().to("cpu", copy=True)
                         for t in opt.shards]
            param_meta = opt.meta
            if r == 0 and self.model is not None:
                sharded = self._sharded_names()
                model_state = {k: v.detach().to("cpu", copy=True)
                               for k, v in self.model.state_dict().items()
                               if k not in sharded}
        elif self.model is not None and (
                r == 0 or integrity.enabled()
                or faults.armed(faults.GRAD_CORRUPT)):
            # The replicated parameters (the sharded mode's vote), read in
            # place: the injector replaces a leaf, never writes one.
            params = dict(self.model.state_dict())
        extras = copy.deepcopy(self._extras)
        # A step that an abort cut short never becomes the rollback point
        # (state.py), nor a replica.
        abort.raise_if_aborted()
        saved = integrity.maybe_corrupt_snapshot(
            {"params": params, "param_row": param_row, "row": row})
        params, param_row, row = (saved["params"], saved["param_row"],
                                  saved["row"])
        if r == 0 and params is not None:
            model_state = _host_copy(params)
        self._commit_seq += 1
        integrity.maybe_fingerprint(
            params, None, self._commit_seq,
            sync_mode="fsdp" if self._fsdp else "sharded",
            shard=(row, param_row) if param_row is not None else row)
        payload = pickle.dumps({
            "row": row,
            "layout": "row",
            "extras": extras,
            # The model's replicated state rides one record of the set
            # (rank 0's); under fsdp every record carries its own
            # parameter shards, and rank 0's the model's other state.
            "params": model_state,
            "param_row": param_row,
            "param_layout": "row" if self._fsdp else "full",
            "param_meta": param_meta,
        }, protocol=pickle.HIGHEST_PROTOCOL)
        self._replicator.replicate(payload, step=self._commit_seq,
                                   has_params=(r == 0))
        self.commit_extras()
        self.check_host_updates()

    def restore(self) -> None:
        """Roll the extras back and mark the state pending: the commit
        held this rank's shards only, and the rest must come from the peer
        rung (or the durable one) before the next ``sync()``."""
        self.restore_extras()
        if hasattr(self.optimizer, "_reset"):
            self.optimizer._reset()  # drop dead-world in-flight state
        self.optimizer.zero_grad(set_to_none=True)
        self._full = None
        self._peer_dirty = True

    def sync(self) -> None:
        """Refused, on every rank, while a rank is pending and none holds a
        full state (a pending rank, such as a promoted spare whose own
        restore marked it so, takes the holder's state instead of
        assembling one of its own). Otherwise: align the commit counter
        (the
        newest step of an earlier generation on the replica plane, then
        rank 0's value), and bring every rank to rank 0's state for the
        current world: a full state that rank 0 holds (from the peer or
        the durable rung), else, when a rank's shards were cut for another
        world, the last complete replica set that rank 0 assembles;
        broadcast, re-sharded and installed on each rank's device. When
        every rank's shards fit the world, only the extras (and, sharded,
        the parameters) are broadcast. Then commit."""
        from ..exceptions import HorovodInternalError
        from ..functions import allgather_object
        from ..ops.collective_ops import elastic_errors

        ps = self.optimizer._ps
        with elastic_errors():
            # Pending ranks refuse together with the rest of the world: a
            # member with nothing pending (a promoted spare) would
            # otherwise wait in this gather for peers that left it.
            stale = self._layout_world() != ps.size()
            views = allgather_object(
                (self._peer_dirty, self._full is not None, stale))
        pending = [i for i, (dirty, _, _) in enumerate(views) if dirty]
        src = next((i for i, (_, held, _) in enumerate(views) if held), None)
        if pending and src is None:
            raise HorovodInternalError(
                f"shard-local commits of ranks {pending} hold only their "
                "own optimizer shards; the departed ranks' shards must be "
                "re-materialized from the peer replica pool (recovery "
                "rung 'peer') or the durable checkpoint")
        with elastic_errors():
            seq = max(self._commit_seq, self._replicator.latest_step(
                before_generation=self._replicator.generation()))
            if src is None and any(st for _, _, st in views):
                src, err = 0, None
                if ps.rank() == 0:
                    try:
                        self._restore_from_peers()
                    except Exception as e:  # noqa: BLE001 — all ranks raise
                        err = str(e)
                err = broadcast_object(err, root_rank=0)
                if err is not None:
                    raise HorovodInternalError(
                        f"no state to re-shard for the new world: {err}")
            if src is not None:
                self._install(_broadcast_full(
                    self._full if ps.rank() == src else None, src))
            elif not self._fsdp and self.model is not None:
                broadcast_parameters(self.model.state_dict(), root_rank=0)
            seq, extras, updates = broadcast_object(
                (seq, self._extras, self.optimizer._updates), root_rank=0)
        self._commit_seq = int(seq)
        self._extras = extras
        self.optimizer._updates = int(updates)
        self.commit()

    def _install(self, full: dict) -> None:
        """Re-shard a full state (host tensors) for this rank of the
        current world and install it on the rank's device."""
        from ..optimizer import load_sharded_state, reshard_opt_state

        opt = self.optimizer
        with torch.no_grad():
            if self.model is not None and full["params"] is not None:
                self.model.load_state_dict(full["params"],
                                           strict=not self._fsdp)
            if self._fsdp:
                opt._reform(full["flat"])
            else:
                opt._reform()
        load_sharded_state(opt, reshard_opt_state(opt, full["opt"],
                                                  opt._ps.size()))
        for k, v in full["extras"].items():
            if k in self._extras:
                setattr(self, k, v)
        self._full = None
        self._peer_dirty = False

    def install_full(self, params, opt_state, **extras) -> None:
        """The durable rung's entry point: a full state from
        ``checkpoint.load_state_and_broadcast``'s layout (``params``, the
        model's state dict with every parameter in full; ``opt_state``,
        the monolithic optimizer state of ``unshard_opt_state``), which the
        next ``sync()`` re-shards for the current world. Clears the
        pending mark."""
        flat = None
        if self._fsdp:
            names = dict(self.model.named_parameters())
            by_id = {id(p): k for k, p in names.items()}
            flat = [params[by_id[id(p)]].detach().cpu()
                    for p in self.optimizer._params]
            sharded = set(by_id.values())
            params = {k: v for k, v in params.items() if k not in sharded}
        self._full = {"params": _host_copy(dict(params)), "flat": flat,
                      "opt": _host_copy(opt_state),
                      "extras": {k: v for k, v in extras.items()
                                 if k in self._extras}}
        for k, v in self._full["extras"].items():
            setattr(self, k, v)
        self._peer_dirty = False

    # -- the peer rung -------------------------------------------------------

    def _restore_from_peers(self) -> None:
        """Assemble the last commit's complete replica set and rebuild the
        full parameters and optimizer state from it, on the host, for the
        next ``sync()`` to install. ``ReplicaUnavailableError`` on a gap,
        which the ladder turns into the durable rung."""
        from .. import checkpoint, metrics, peercheck
        from ..optimizer import unshard_opt_state

        t0 = time.perf_counter()
        records = self._replicator.assemble()
        payloads = [pickle.loads(rec.payload) for rec in records]
        try:
            params, _ = checkpoint.assemble_full_params(payloads)
        except ValueError as e:
            raise peercheck.ReplicaUnavailableError(str(e)) from e
        bad = [rec.rank for rec, p in zip(records, payloads)
               if p.get("layout") != "row"]
        if bad:
            raise peercheck.ReplicaUnavailableError(
                f"records of ranks {bad} are not shard rows")
        rows = [p["row"] for p in payloads]
        stacked = {
            "state": {i: {k: (torch.stack([r["state"][i][k] for r in rows])
                              if torch.is_tensor(v) else v)
                          for k, v in st.items()}
                      for i, st in rows[0]["state"].items()},
            "param_groups": rows[0]["param_groups"],
            "salt_counter": rows[0].get("salt_counter", 0),
        }
        model_state = next((p["params"] for p in payloads
                            if p.get("params") is not None), None)
        self._full = {
            "params": model_state,
            "flat": params if self._fsdp else None,
            "opt": unshard_opt_state(self.optimizer, stacked),
            "extras": payloads[0].get("extras", {}),
        }
        for k, v in self._full["extras"].items():
            if k in self._extras:
                setattr(self, k, v)
        self._peer_dirty = False
        rec = records[0]
        metrics.CHECKPOINT_SECONDS.observe(
            time.perf_counter() - t0, kind="restore", rung="peer")
        metrics.event(
            "peer_restore", generation=rec.generation, step=rec.step,
            world_size=rec.world_size,
            bytes=sum(len(r.payload) for r in records))


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

