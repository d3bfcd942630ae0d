"""Elastic state: commit/restore/sync over worlds that lose and gain
workers.

Port of ``horovod_tpu/elastic/state.py``'s framework-agnostic state
machine (``State`` with its peer-rung API :73-100 and ``needs_world_sync``,
``ObjectState`` :38-170, ``ExtrasState`` :850-893), itself the
reference's ``horovod/common/elastic.py``. The contract:

- ``commit()``: snapshot training state in host memory (cheap, frequent):
  the rollback point when a peer dies mid-step.
- ``restore()``: roll back to the last commit (after HorovodInternalError).
- ``sync()``: make all workers agree on rank 0's state (after a
  re-rendezvous or a host change).
- reset callbacks: user hooks run after the world re-forms.

The JAX package's ``TpuState`` holds jax pytrees and has no counterpart;
``TorchState`` and, for the sharded and fsdp modes, ``PeerShardedState``
(``elastic/__init__.py``) take its role.

The port's own step in every ``commit()``: after the snapshot is taken and
before it replaces the last one, an armed coordinated abort raises
``HorovodInternalError``. On the card an aborted NCCL communicator ends
its collectives with whatever their buffers held, so a step that an abort
cut short may have run on garbage; its snapshot must never become the
rollback point. (The snapshot's device-to-host copies wait for the step's
collectives, and the abort flag is set before the communicator is
aborted, so a flag still clear after the copies means they ended
normally.)
"""

from __future__ import annotations

import copy
from typing import Any, Callable

from .. import abort
from ..exceptions import RemovedFromWorldError
from ..functions import broadcast_object


class State:
    """Base elastic state with reset-callback plumbing."""

    def __init__(self, **kwargs):
        self._reset_callbacks: list[Callable[[], None]] = []
        self._durable_restore_fn: Callable[[], None] | None = None
        self._peer_restore_fn: Callable[[], None] | None = None
        self._kwargs = kwargs

    def register_reset_callbacks(self, callbacks) -> None:
        self._reset_callbacks.extend(callbacks)

    def register_durable_restore(self, fn: Callable[[], None]) -> None:
        """Arm the recovery ladder's durable rung: ``fn`` reloads this
        state's fields from the durable checkpoint layer
        (``horovod_tpu_torch.checkpoint.Checkpointer``). The elastic loop
        calls it only after both the in-memory restore AND the
        re-rendezvous + sync rungs failed consecutively::

            ckpt = Checkpointer("/ckpt", max_to_keep=3)
            def reload():
                saved = ckpt.restore()
                model.load_state_dict(saved["model"])
            state.register_durable_restore(reload)
        """
        self._durable_restore_fn = fn

    def restore_durable(self) -> bool:
        """Run the registered durable restore; False when none is armed
        (the ladder then falls back to the in-memory commit)."""
        if self._durable_restore_fn is None:
            return False
        self._durable_restore_fn()
        return True

    def register_peer_restore(self, fn: Callable[[], None]) -> None:
        """Arm the ladder's ``peer`` rung (between the re-rendezvous and
        the durable restore): ``fn`` rebuilds this state from the peer
        replica plane (``horovod_tpu_torch.peercheck``), reading no
        storage. ``fn`` raising (a gap, a bad checksum) makes the ladder
        fall through to the durable rung. ``PeerShardedState`` arms it."""
        self._peer_restore_fn = fn

    def restore_peer(self) -> bool:
        """Run the registered peer restore; False when none is armed (the
        ladder then goes on to the durable rung)."""
        if self._peer_restore_fn is None:
            return False
        self._peer_restore_fn()
        return True

    def peer_restore_armed(self) -> bool:
        return self._peer_restore_fn is not None

    def peer_restore_pending(self) -> bool:
        """True when this state knows that its own snapshot cannot re-form
        the world (a shard-local commit after a failure): the ladder then
        goes straight to the peer rung."""
        return False

    def needs_world_sync(self) -> bool:
        """True when this state's layout does not fit the current world,
        so the loop must ``sync()`` even after a host update that skips
        it (``HostsUpdatedInterrupt.skip_sync``)."""
        return False

    def on_reset(self) -> None:
        for cb in self._reset_callbacks:
            cb()

    def check_host_updates(self) -> None:
        """Surface pending driver notifications as HostsUpdatedInterrupt.

        Called from commit() (the safe point to interrupt: a consistent
        state was just snapshotted). The SIGTERM drain surfaces HERE too,
        as ``RemovedFromWorldError``, so the elastic loop exits cleanly
        with EXIT_REMOVED instead of dying mid-step.
        """
        from ..runner.elastic.worker import record_commit
        from .runner import drain_requested, notification_manager

        record_commit()  # heartbeat piggyback: commits count as progress
        if drain_requested():
            raise RemovedFromWorldError(
                "SIGTERM drain: state committed; leaving the world cleanly"
            )
        notification_manager.check_host_updates()

    def commit(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError


class ObjectState(State):
    """Elastic state backed by picklable attributes (reference parity:
    ``horovod/common/elastic.py — ObjectState``). Attributes passed as
    kwargs become state; commit snapshots them, sync broadcasts rank 0's."""

    def __init__(self, **kwargs):
        super().__init__()
        self._saved: dict[str, Any] = {}
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._known = list(kwargs.keys())
        self.commit()

    def commit(self) -> None:
        saved = {k: getattr(self, k) for k in self._known}
        abort.raise_if_aborted()
        self._saved = saved
        self.check_host_updates()

    def restore(self) -> None:
        for k, v in self._saved.items():
            setattr(self, k, v)

    def sync(self) -> None:
        synced = broadcast_object({k: getattr(self, k) for k in self._known})
        for k, v in synced.items():
            setattr(self, k, v)
        self.commit()


class ExtrasState(State):
    """Shared user-object tracking for the framework State flavors.

    EVERY public attribute assigned on the state — in __init__ kwargs or
    at any later point (``state.epoch = 0`` after construction) — is
    tracked: snapshotted by ``commit()``, rolled back by ``restore()``,
    broadcast by ``sync()``. Underscore names and the framework handles
    (``model``/``optimizer``) are the only exceptions.
    """

    _SPECIAL = ("model", "optimizer")

    def __init__(self, **extras):
        super().__init__()
        self._extras = dict(extras)
        self._saved_extras = {}

    def __getattr__(self, item):
        extras = self.__dict__.get("_extras", {})
        if item in extras:
            return extras[item]
        raise AttributeError(item)

    def __setattr__(self, key, value):
        if key.startswith("_") or key in self._SPECIAL \
                or "_extras" not in self.__dict__:
            super().__setattr__(key, value)
        else:
            self._extras[key] = value

    def commit_extras(self) -> None:
        self._saved_extras = copy.deepcopy(self._extras)

    def restore_extras(self) -> None:
        self._extras = copy.deepcopy(self._saved_extras)

    def sync_extras(self, broadcast_object_fn) -> None:
        self._extras = broadcast_object_fn(self._extras)
