"""Rank-0 checkpoints with broadcast on resume, and integrity checks.

Port of ``horovod_tpu/checkpoint.py``: the checksum footer
(``_with_footer`` and ``payload_digest``, :42-53, the same magic and
sha256), ``atomic_install`` (:55), ``atomic_read`` (:100), ``_read_verified``
(:200, as ``_verified`` over the bytes ``atomic_read`` yields),
``_save_with_retries`` (:226),
``rotate_slots`` (:132), ``assemble_full_params`` (:154),
``save_on_rank_0`` (:355), ``save_state_on_rank_0`` (:386),
``load_state_and_broadcast`` (:423) and ``load_and_broadcast`` (:485),
and ``Checkpointer`` (:251), the durable layer of elastic recovery.

The reference idiom: rank 0 writes (``torch.save``) and every
rank loads rank 0's copy by broadcast. A file is ``payload || sha256 ||
magic``; a payload whose digest does not match raises
``CheckpointCorruptError`` and the load falls back to the previous file,
which every write keeps at ``<path>.prev``. The train-state checkpoint's
layout does not depend on the sync mode: a sharded or fsdp job gathers its
optimizer state (and, fsdp, its parameters) on save, and the load re-shards
for the current world and mode, so a checkpoint resumes across modes and
world sizes.

The module imports torch only inside the functions that need it: the
driver's rendezvous server and control-plane store
(``runner/http/kv_server.py``, ``runner/elastic/driver_state.py``) use its
digest, file and slot helpers, and the launcher imports no torch.
"""

from __future__ import annotations

import hashlib
import io
import os
import re
import threading
from typing import Any, MutableMapping

from . import faults
from .exceptions import CheckpointCorruptError
from .utils import env
from .utils.logging import get_logger
from .utils.retry import call_with_retries

_CKPT_MAGIC = b"HVDCKSM1"
_FOOTER_LEN = 32 + len(_CKPT_MAGIC)


def _with_footer(payload: bytes) -> bytes:
    return payload + hashlib.sha256(payload).digest() + _CKPT_MAGIC


def payload_digest(payload: bytes) -> str:
    """The integrity checksum (hex sha256) of a checkpoint payload."""
    return hashlib.sha256(payload).hexdigest()


def atomic_install(path: str, data: bytes) -> None:
    """Install ``data`` at ``path``, keeping the previous file at
    ``<path>.prev``, with no moment at which neither exists: write
    ``<path>.tmp``, hard-link the current file to ``.prev`` (copy where
    links fail), then rename the new file over ``path``."""
    tmp = f"{path}.tmp"
    prev = f"{path}.prev"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        if os.path.exists(path):
            try:
                os.unlink(prev)
            except FileNotFoundError:
                pass
            try:
                os.link(path, prev)
            except OSError:
                with open(path, "rb") as src, open(prev, "wb") as dst:
                    dst.write(src.read())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_read(path: str):
    """Yield ``(bytes, "current")`` of ``path`` and then ``(bytes,
    "prev")`` of ``<path>.prev``, skipping a missing one; the caller stops
    at the first that verifies."""
    for p, which in ((path, "current"), (f"{path}.prev", "prev")):
        try:
            with open(p, "rb") as f:
                yield f.read(), which
        except OSError:
            continue


def rotate_slots(store: MutableMapping, key: str, value,
                 prev_suffix: str = ".prev", depth: int = 1) -> None:
    """The mapping flavor of :func:`atomic_install`: install ``value`` at
    ``key``, keeping the previous value at ``<key><prev_suffix>`` (and, for
    ``depth`` > 1, older ones at ``<key><prev_suffix*2>``, ...). The caller
    holds whatever lock guards ``store``; the assignments run oldest first,
    so the current slot is never empty. The peer replica pool
    (``peercheck.ReplicaPool``) and the rendezvous server's ``peerstate``
    scope both rotate through it."""
    for i in range(max(1, depth), 0, -1):
        src = key + prev_suffix * (i - 1)
        if src in store:
            store[key + prev_suffix * i] = store[src]
    store[key] = value


def assemble_full_params(payloads: list) -> tuple:
    """The full parameters of a complete replica set's decoded payloads
    (``elastic.PeerShardedState``'s commit records, in rank order):
    ``(params, template)``. An fsdp set (``param_layout == "row"``)
    stacks every record's parameter shard row into a
    ``parallel.param_sharding.ShardedParams`` and gathers it with
    ``unshard_params`` (host math): ``params`` is then the list of full
    tensors and ``template`` the ``ShardedParams``. Otherwise the one
    record that carries ``params`` (rank 0's) gives both. ``ValueError``
    on a gap: a record without its row, no shard metadata, no
    parameters."""
    if any(p.get("param_layout") == "row" for p in payloads):
        from .parallel.param_sharding import stack_param_rows, unshard_params

        bad = [i for i, p in enumerate(payloads)
               if p.get("param_layout") != "row"
               or p.get("param_row") is None]
        if bad:
            raise ValueError(
                f"records at positions {bad} carry no param shard row")
        meta = next((p["param_meta"] for p in payloads
                     if p.get("param_meta") is not None), None)
        if meta is None:
            raise ValueError("no record carries the fsdp shard metadata")
        sp = stack_param_rows([p["param_row"] for p in payloads], meta)
        return unshard_params(sp), sp
    params = next((p["params"] for p in payloads
                   if p.get("params") is not None), None)
    if params is None:
        raise ValueError(
            "no record in the replica set carries the parameters")
    return params, params


def _dumps(obj: Any) -> bytes:
    import torch

    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(payload: bytes) -> Any:
    import torch

    return torch.load(io.BytesIO(payload), map_location="cpu",
                      weights_only=False)


def _verified(blob: bytes, what: str) -> Any:
    """The object in a checkpoint file's bytes, its checksum footer
    verified; ``CheckpointCorruptError`` when the digest does not match. A
    file without the footer loads as it is."""
    if len(blob) >= _FOOTER_LEN and blob.endswith(_CKPT_MAGIC):
        payload = blob[:-_FOOTER_LEN]
        digest = blob[-_FOOTER_LEN:-len(_CKPT_MAGIC)]
        if hashlib.sha256(payload).digest() != digest:
            raise CheckpointCorruptError(
                f"checkpoint {what} failed its integrity check (checksum "
                "footer does not match payload)")
        return _loads(payload)
    return _loads(blob)


def _save_with_retries(attempt, what: str) -> None:
    """Run one write attempt under the bounded retry policy:
    ``HOROVOD_CHECKPOINT_RETRIES`` attempts (default 3), backoff from
    ``HOROVOD_CHECKPOINT_RETRY_BACKOFF`` seconds (default 0.5). Every
    attempt passes through the ``checkpoint.save`` injection point."""

    def one_attempt():
        if faults.fire(faults.CHECKPOINT_SAVE):
            raise faults.InjectedFault(f"checkpoint save dropped: {what}")
        return attempt()

    call_with_retries(
        one_attempt,
        attempts=max(1, env.get_int(env.CHECKPOINT_RETRIES, 3)),
        base_delay=env.get_float(env.CHECKPOINT_RETRY_BACKOFF, 0.5),
        on_retry=lambda n, e: get_logger().warning(
            "checkpoint save of %s failed (attempt %d: %s); retrying",
            what, n, e))


def _to_cpu(obj):
    import torch

    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _host_copy(obj):
    """``obj`` with every tensor copied to the CPU, so that training can
    go on changing the originals while a save is in flight."""
    import torch

    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


class Checkpointer:
    """Step-numbered durable checkpoints in a directory (the JAX package's
    Orbax-backed ``Checkpointer``): the durable rung of the elastic
    recovery ladder, and what a relaunched generation resumes from.

    ``save(step, state)`` copies the state's tensors to the CPU at once
    and writes ``step_<N>.pt`` (checksum footer, ``atomic_install``) on
    rank 0 (every rank of a one-process or uninitialized world), on a
    background thread when ``async_save`` (one write in flight: the next
    save waits for it), keeping the newest ``max_to_keep`` steps (None or
    0: all). Every
    rank restores from the directory, a shared file system's or its own.
    """

    _NAME = re.compile(r"step_(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._async = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def _writes(self) -> bool:
        from . import basics

        return not basics.is_initialized() or basics.rank() == 0

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Save ``state`` (tensors, dicts, lists, picklable values) as
        step ``step``. Async by default: returns once the tensors are
        copied to the CPU; a write error surfaces from the next ``save``
        or :meth:`wait_until_finished`."""
        if not self._writes():
            return
        self.wait_until_finished()
        data = _host_copy(state)

        def write():
            blob = _with_footer(_dumps(data))
            path = self._path(step)
            _save_with_retries(lambda: atomic_install(path, blob), what=path)
            keep = self._max_to_keep
            for old in (self.all_steps()[:-keep] if keep else []):
                for p in (self._path(old), f"{self._path(old)}.prev"):
                    try:
                        os.unlink(p)
                    except FileNotFoundError:
                        pass

        if not self._async:
            write()
        else:
            def run():
                try:
                    write()
                except BaseException as e:  # noqa: BLE001 — re-raised later
                    self._error = e

            self._thread = threading.Thread(target=run, daemon=True,
                                            name="hvd-checkpoint")
            self._thread.start()
        if wait:
            self.wait_until_finished()

    def restore(self, step: int | None = None) -> Any:
        """The state saved at ``step``, or at the newest retained step.
        A newest step that is corrupt or unreadable falls back to the
        older retained steps, with an error logged; an explicit ``step``
        is restored exactly or raises. Every attempt passes through the
        ``checkpoint.restore`` injection point."""
        self.wait_until_finished()
        if step is not None:
            candidates = [step]
        else:
            candidates = sorted(self.all_steps(), reverse=True)
            if not candidates:
                raise FileNotFoundError(f"no checkpoints in {self._dir}")
        log = get_logger()
        last_err: Exception | None = None
        for i, s in enumerate(candidates):
            try:
                if faults.fire(faults.CHECKPOINT_RESTORE):
                    raise faults.InjectedFault(
                        f"checkpoint restore dropped: step {s}")
                with open(self._path(s), "rb") as f:
                    return _verified(f.read(), self._path(s))
            except Exception as e:  # noqa: BLE001 — try the older steps
                last_err = e
                if i + 1 < len(candidates):
                    log.error(
                        "checkpoint step %d failed to restore (%s); falling "
                        "back to previous retained step %d",
                        s, e, candidates[i + 1])
        assert last_err is not None
        raise last_err

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(
            self._NAME.match, os.listdir(self._dir)) if m)

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def save_on_rank_0(path: str, obj: Any) -> None:
    """Rank 0 writes ``obj`` (tensors moved to the CPU) with the checksum
    footer, atomically, keeping the previous file at ``<path>.prev`` and
    retrying transient write errors; other ranks return."""
    from . import basics

    if basics.rank() != 0:
        return
    data = _with_footer(_dumps(_to_cpu(obj)))
    _save_with_retries(lambda: atomic_install(path, data), what=path)


def load_and_broadcast(path: str, root_rank: int = 0) -> Any:
    """``root_rank`` loads and every rank receives the object. A corrupt
    or unreadable file falls back to ``<path>.prev`` with an error logged;
    with neither readable every rank gets None."""
    from . import basics
    from .functions import broadcast_object

    obj = None
    if basics.rank() == root_rank:
        log = get_logger()
        for blob, which in atomic_read(path):
            try:
                obj = _verified(blob, f"{path} ({which})")
            except Exception as e:  # noqa: BLE001 - corrupt is not fatal
                log.error("checkpoint %s (%s) is corrupt or unreadable (%s)",
                          path, which, e)
                continue
            if which == "prev":
                log.warning("resumed from the previous checkpoint %s.prev: "
                            "one save of progress was lost", path)
            break
        else:
            if os.path.exists(path) or os.path.exists(f"{path}.prev"):
                log.error("no readable checkpoint at %s; resuming without "
                          "one", path)
    return broadcast_object(obj, root_rank=root_rank)


def _param_names(model, optimizer) -> list[str]:
    names_of = {id(p): name for name, p in model.named_parameters()}
    return [names_of[id(p)] for p in optimizer._params]


def save_state_on_rank_0(path: str, optimizer, model,
                         **extras: Any) -> None:
    """Rank-0 train-state checkpoint (``params``: the model's state dict;
    ``opt_state``: the wrapped optimizer's state dict over the full
    parameters; and ``extras``) whose layout does not depend on the sync
    mode: sharded and fsdp optimizers gather their state (and fsdp its
    parameters) to rank 0 alone, one tensor at a time, and rank 0 joins
    the shards. Collective in those modes: every rank calls it."""
    from . import basics
    from .optimizer import (_gather_rows, gather_sharded_state, sync_mode_of,
                            unshard_opt_state)
    from .parallel.param_sharding import ShardedParams, unshard_params

    mode = sync_mode_of(optimizer)
    if mode == "allreduce":
        opt_state = dict(optimizer.state_dict())
        opt_state["salt_counter"] = optimizer._updates
    else:
        stacked = gather_sharded_state(optimizer)
        opt_state = (None if stacked is None
                     else unshard_opt_state(optimizer, stacked))
    full = None
    if mode == "fsdp":
        rows = _gather_rows(optimizer.shards, optimizer._ps)
        if optimizer._ps.rank() == 0:
            full = unshard_params(ShardedParams(rows, optimizer.meta))
    if basics.rank() != 0:
        return
    params = dict(model.state_dict())
    if full is not None:
        params.update(zip(_param_names(model, optimizer), full))
    save_on_rank_0(path, {"params": params, "opt_state": opt_state,
                          **extras})


def load_state_and_broadcast(path: str, optimizer, model,
                             root_rank: int = 0) -> Any | None:
    """Resume from :func:`save_state_on_rank_0`'s file into ``model`` and
    ``optimizer``, whatever mode and world size wrote it: rank 0 loads,
    every rank receives, and a sharded or fsdp optimizer takes its row of
    the state re-sharded for the current world (fsdp: its parameter shards
    too). Returns the loaded dict, or None when no checkpoint is
    readable."""
    import torch

    from .optimizer import load_sharded_state, reshard_opt_state, sync_mode_of

    obj = load_and_broadcast(path, root_rank)
    if obj is None:
        return None
    mode = sync_mode_of(optimizer)
    params = obj["params"]
    opt_state = dict(obj["opt_state"])
    with torch.no_grad():
        if mode == "fsdp":
            names = _param_names(model, optimizer)
            n, r = optimizer._ps.size(), optimizer._ps.rank()
            for name, shard, s in zip(names, optimizer.shards,
                                      optimizer.meta.shard_sizes):
                flat = params[name].reshape(-1).to(shard.device, shard.dtype)
                shard.copy_(torch.nn.functional.pad(
                    flat, (0, n * s - flat.numel()))[r * s:(r + 1) * s])
            model.load_state_dict({k: v for k, v in params.items()
                                   if k not in set(names)}, strict=False)
        else:
            model.load_state_dict(params)
    if mode == "allreduce":
        optimizer._updates = int(opt_state.pop("salt_counter", 0))
        optimizer.load_state_dict(opt_state)
    else:
        load_sharded_state(optimizer, reshard_opt_state(
            optimizer, opt_state, optimizer._ps.size()))
    return obj
