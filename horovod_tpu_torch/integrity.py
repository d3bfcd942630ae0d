"""The silent-data-corruption defence plane: cross-rank integrity voting,
the non-finite tripwire's accounting, and the storage-free rewind on a
loss spike.

A copy of ``horovod_tpu/integrity.py`` for the PyTorch port, with the same
knobs, record format, verdicts, journal events and metric families. The
liveness, abort, ladder and peer-replica planes survive a process that
dies; nothing there guards the data: a host computing wrong answers, a
flipped bit, or a non-finite gradient burst reaches every rank's
parameters through the allreduce, and then the very commits the ladder
restores from. The guard rests on one invariant of synchronous data
parallelism: the replicated state after a sync is bitwise identical on
every rank, so any difference is evidence.

Three mechanisms, each inert until its knob is set:

1. **Cross-rank integrity voting** (``HOROVOD_INTEGRITY_INTERVAL=N``):
   every N-th elastic commit each rank fingerprints its committed state
   (:func:`make_record`): a sha256 of the replicated part (parameters and
   optimizer state under ``allreduce``, parameters under ``sharded``,
   nothing under ``fsdp``), per-bucket finite counts and L2 norms, and a
   digest of the rank-local shard. The record rides the heartbeat; the
   rendezvous server serves the set at ``GET /integrity`` and the driver
   votes each complete (generation, step) group (:func:`vote`): with three
   or more voters the minority digest is named, with two the tie is broken
   by non-finite summaries or by L2 drift against each rank's own previous
   record (``HOROVOD_INTEGRITY_TIEBREAK``). A named host is journaled
   (``integrity_divergence``), counted
   (``hvd_integrity_divergence_total``), its replica PUTs are fenced on the
   server, and under ``HOROVOD_INTEGRITY_ACTION=drain`` (the default) the
   driver drains it and a warm spare joins at the next generation.
2. **Non-finite tripwire** (``HOROVOD_NONFINITE_ACTION=warn|skip|abort``):
   the optimizer checks the reduced gradients and reports each checked
   step here (:func:`note_nonfinite`), which counts
   (``hvd_nonfinite_steps_total``), journals ``nonfinite_step`` and, under
   ``abort``, posts the coordinated abort (``abort.post``) so every
   blocking site of every rank raises into the elastic ladder.
3. **Rewind on a loss spike** (``HOROVOD_LOSS_SPIKE_SIGMA=S``): an EWMA
   mean and variance of the training loss (:func:`observe_loss`); a loss
   more than S sigma above the trend, or a non-finite one, posts the abort
   and raises ``LossSpikeError``, which the elastic loop turns into a
   rewind to the last commit that reads no storage. The loop skips the
   poison batch through :func:`consume_skip_ahead`;
   ``HOROVOD_REWIND_MAX`` consecutive rewinds without a landed commit
   hand the spike to the ordinary ladder.

The port's own part is the leaf walk: a leaf may be a torch tensor on any
device and of any dtype (bfloat16 included), a numpy array, a Python
scalar, or a container (dicts such as a ``state_dict`` by sorted key,
lists and tuples in order). A tensor is read through its bytes, its
header written as numpy's (``float32:(3, 4);``), so a tree of float32
tensors digests as the same tree of float32 numpy arrays does, and a
bfloat16 tensor as an ``ml_dtypes`` bfloat16 array. Host leaves are
summarized by the JAX package's numpy sums, so a tree of numpy arrays or
of host tensors gives its digest and summaries exactly; a tensor on the
card is summarized on the card in float64 (the finite count exact, the
L2 within float64 rounding of the host's sum: ``tests/test_torch_cuda.py``
holds it to 1e-12 relative).

Standard library only at import (numpy and torch are imported inside the
functions that need them): the driver's rendezvous server votes with this
module and imports no torch.
"""

from __future__ import annotations

import hashlib
import math
import os
import threading
import time
from typing import Any, Mapping

from . import faults
from . import metrics as _metrics
from .utils.env import get_float, get_int
from .utils.logging import get_logger

#: Record format version (records carry it for forward evolution).
RECORD_VERSION = 1

#: Summary buckets per fingerprint: contiguous leaf runs, so a corrupt
#: leaf localizes to a bucket without per-leaf record bloat.
SUMMARY_BUCKETS = 8

#: Elements per chunk of the float64 summaries (bounds the transients of a
#: multi-GB state to a few MB on the host, a few MB on the card).
SUMMARY_CHUNK = 1 << 20


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------


def check_interval() -> int:
    """``HOROVOD_INTEGRITY_INTERVAL``: fingerprint every N-th commit;
    0 or unset disables the whole voting plane (bit for bit inert)."""
    return get_int("HOROVOD_INTEGRITY_INTERVAL", 0)


def enabled() -> bool:
    return check_interval() > 0


def integrity_action() -> str:
    """``HOROVOD_INTEGRITY_ACTION``: what the driver does with a named
    divergent host: ``drain`` (default: quarantine and drain) or ``warn``
    (journal, count and fence only; the policy's strike channel can still
    drain it)."""
    action = os.environ.get("HOROVOD_INTEGRITY_ACTION", "drain").strip()
    return action if action in ("warn", "drain") else "drain"


def confirmations() -> int:
    """Consecutive divergent votes naming the same host before the driver
    acts (``HOROVOD_INTEGRITY_CONFIRMATIONS``, default 1: one bad
    fingerprint is already a bitwise proof)."""
    return max(1, get_int("HOROVOD_INTEGRITY_CONFIRMATIONS", 1))


def tiebreak_ratio() -> float:
    """Two-voter tie-break: the outlier's summary drift must exceed the
    peer's by this factor, or the vote stays ambiguous."""
    return get_float("HOROVOD_INTEGRITY_TIEBREAK", 4.0)


def loss_spike_sigma() -> float | None:
    """``HOROVOD_LOSS_SPIKE_SIGMA``: sigmas above the EWMA loss trend at
    which :func:`observe_loss` trips a rewind; unset or invalid disables."""
    raw = os.environ.get("HOROVOD_LOSS_SPIKE_SIGMA", "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def rewind_max() -> int:
    """Consecutive spike rewinds without a landed commit before the storm
    breaker hands a spike to the ordinary ladder (0 disables the cap)."""
    return get_int("HOROVOD_REWIND_MAX", 3)


# Integrity records match replica records and the server's fences by
# (generation, step): both planes take the generation from one place.
from .peercheck import _env_generation  # noqa: E402


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------


def _iter_leaves(tree):
    """Deterministic leaf walk: mappings by sorted key (``str``), lists
    and tuples in order. Yields the leaves."""
    if isinstance(tree, Mapping):
        for k in sorted(tree, key=str):
            yield from _iter_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _iter_leaves(item)
    else:
        yield tree


def _is_tensor(leaf) -> bool:
    """A torch tensor, told without importing torch (the server side of
    this module never holds one)."""
    return type(leaf).__module__.startswith("torch") and hasattr(
        leaf, "untyped_storage")


class _TensorLeaf:
    """A torch tensor as the fingerprint reads it: numpy's header
    (``dtype`` prints as numpy's name, ``shape`` is a tuple) and its
    bytes."""

    __slots__ = ("tensor", "dtype", "shape", "size")

    def __init__(self, tensor):
        self.tensor = tensor.detach()
        # numpy's name of the dtype (``float32``, ``bfloat16``).
        self.dtype = str(tensor.dtype).replace("torch.", "")
        self.shape = tuple(int(d) for d in tensor.shape)
        self.size = int(tensor.numel())

    def host_bytes(self):
        """The tensor's bytes as a host uint8 array (a device tensor's in
        one device-to-host copy)."""
        import torch

        flat = self.tensor.reshape(-1).contiguous()
        if flat.dtype == torch.bool:
            flat = flat.to(torch.uint8)
        return flat.view(torch.uint8).cpu().numpy()

    def is_numeric(self) -> bool:
        return self.tensor.is_floating_point() or not (
            self.tensor.is_complex() or self.dtype == "bool")

    def stats(self) -> tuple[int, float]:
        """(finite elements, sum of squares of the finite ones) in
        float64, chunk by chunk: a host tensor through the numpy sums
        (bfloat16 widened to float32 first, exactly), a device tensor on
        its device."""
        import torch

        if self.tensor.device.type == "cpu":
            t = self.tensor
            if t.dtype == torch.bfloat16:
                t = t.float()
            return _array_stats(t.numpy())
        flat = self.tensor.reshape(-1)
        finite, sq = 0, 0.0
        for lo in range(0, flat.numel(), SUMMARY_CHUNK):
            cf = flat[lo:lo + SUMMARY_CHUNK].to(torch.float64)
            m = torch.isfinite(cf)
            nfin = int(m.sum())
            finite += nfin
            if nfin != cf.numel():
                cf = torch.where(m, cf, torch.zeros((), dtype=cf.dtype,
                                                    device=cf.device))
            sq += float(torch.dot(cf, cf))
        return finite, sq


def _is_float_dtype(dtype) -> bool:
    """Floating to the defence plane: numpy floats plus the custom
    ``bfloat16`` and ``float8_*`` dtypes (``ml_dtypes``), which fail
    ``np.issubdtype(.., floating)``."""
    import numpy as np

    if np.issubdtype(dtype, np.floating):
        return True
    return getattr(dtype, "name", "").startswith(("bfloat16", "float8"))


def _is_numeric_dtype(dtype) -> bool:
    import numpy as np

    if _is_float_dtype(dtype):
        return True
    if np.issubdtype(dtype, np.integer):
        return True
    return getattr(dtype, "name", "") in ("int4", "uint4")


def _leaf_arrays(tree):
    """The tree's leaves, order-stable: torch tensors as
    :class:`_TensorLeaf`, everything else as a numpy array (an opaque
    object as its type's name)."""
    import numpy as np

    out = []
    for leaf in _iter_leaves(tree):
        if leaf is None:
            continue
        if _is_tensor(leaf):
            out.append(_TensorLeaf(leaf))
            continue
        try:
            arr = np.asarray(leaf)
            opaque = bool(arr.dtype.hasobject)
        except Exception:  # noqa: BLE001 — unconvertible leaf
            opaque = True
        if opaque:
            # An opaque leaf's bytes would be an in-process pointer,
            # different on every rank: digest its type's name only, so
            # identical states keep identical digests.
            tag = f"{type(leaf).__module__}.{type(leaf).__qualname__}"
            out.append(np.frombuffer(tag.encode(), dtype=np.uint8))
            continue
        out.append(arr)
    return out


# ---------------------------------------------------------------------------
# Fingerprints (worker side)
# ---------------------------------------------------------------------------


def digest_tree(tree, leaves=None) -> str:
    """Hex sha256 of the tree's deterministic byte view (a shape and dtype
    header before each leaf's bytes guards against reshuffles). Identical
    trees, which the synchronous contract guarantees for the replicated
    state, give identical digests on every rank. ``leaves`` (a
    ``_leaf_arrays`` result) lets ``make_record`` share one walk between
    the digest and the summaries."""
    import numpy as np

    h = hashlib.sha256()
    for arr in (leaves if leaves is not None else _leaf_arrays(tree)):
        h.update(f"{arr.dtype!s}:{arr.shape!r};".encode())
        if isinstance(arr, _TensorLeaf):
            h.update(arr.host_bytes())
        else:
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _array_stats(a) -> tuple[int, float]:
    """The JAX package's host summary of one numpy leaf: float64 chunks,
    finite count and ``np.dot`` of the finite values."""
    import numpy as np

    finite, sq = 0, 0.0
    flat = a.reshape(-1)
    for lo in range(0, flat.size, SUMMARY_CHUNK):
        # Corrupted payloads legitimately carry signaling-NaN bit
        # patterns; the cast must summarize them, not warn.
        with np.errstate(invalid="ignore", over="ignore"):
            cf = flat[lo:lo + SUMMARY_CHUNK].astype(np.float64, copy=False)
            m = np.isfinite(cf)
            nfin = int(m.sum())
            finite += nfin
            if nfin != cf.size:
                cf = np.where(m, cf, 0.0)
            sq += float(np.dot(cf, cf))
    return finite, sq


def summarize_tree(tree, buckets: int = SUMMARY_BUCKETS,
                   leaves=None) -> list[dict]:
    """Per-bucket summaries: contiguous leaf runs with their element
    count, finite count and L2 norm. Finite counts catch non-finite bursts
    outright; the L2 is the two-voter tie-break's drift signal."""
    arrays = [a for a in (leaves if leaves is not None
                          else _leaf_arrays(tree))
              if (a.is_numeric() if isinstance(a, _TensorLeaf)
                  else _is_numeric_dtype(a.dtype))]
    if not arrays:
        return []
    k = max(1, min(int(buckets), len(arrays)))
    out = []
    per = -(-len(arrays) // k)
    for i in range(0, len(arrays), per):
        run = arrays[i:i + per]
        n = int(sum(a.size for a in run))
        finite = 0
        sq = 0.0
        for a in run:
            f, s = a.stats() if isinstance(a, _TensorLeaf) else _array_stats(a)
            finite += f
            sq += s
        out.append({"n": n, "finite": finite, "l2": float(math.sqrt(sq))})
    return out


def _worker() -> str:
    return (os.environ.get("HOROVOD_ELASTIC_WORKER")
            or os.environ.get("HOROVOD_HOSTNAME", "localhost"))


class _IntegrityState:
    """Per-process integrity bookkeeping (thread-safe)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.commit_count = 0
        self.fingerprints = 0
        self.latest: dict | None = None
        self.prev_summary: dict | None = None
        self.nonfinite_detections = 0
        self.nonfinite_burst: set[int] = set()
        self.rewinds = 0
        self.skip_ahead = 0
        self.last_seconds: float | None = None


_state = _IntegrityState()


def make_record(params, opt_state, step: int, sync_mode: str = "allreduce",
                shard=None, rank: int | None = None,
                host: str | None = None,
                generation: int | None = None) -> dict:
    """One rank's integrity fingerprint of a committed state.

    ``sync_mode`` decides what the cross-rank ``digest`` covers: the
    parameters and the optimizer state under ``allreduce`` (fully
    replicated), the parameters under ``sharded`` (the optimizer's rows
    differ per rank by design), nothing under ``fsdp`` (the parameters
    live sharded; ``shard_digest`` is the check there). ``shard`` is the
    rank-local part covered by ``shard_digest``. ``host`` defaults to the
    elastic worker's name (``<host>:<slot>``, the port's key of
    heartbeats and traces), else the host name."""
    if sync_mode == "allreduce":
        voted = summarized = (params, opt_state)
    elif sync_mode == "sharded":
        voted = params
        summarized = params
    else:  # fsdp: nothing replicated to vote on
        voted = None
        summarized = (params, shard)
    # One walk for both the digest and the summaries when they cover the
    # same tree: the walk reads every leaf, a real cost on a multi-GB state.
    voted_leaves = _leaf_arrays(voted) if voted is not None else None
    summary_leaves = (voted_leaves if summarized is voted
                      else _leaf_arrays(summarized))
    return {
        "v": RECORD_VERSION,
        "rank": int(rank if rank is not None
                    else int(os.environ.get("HOROVOD_RANK", "0") or 0)),
        "host": str(host if host is not None else _worker()),
        "generation": int(generation if generation is not None
                          else _env_generation()),
        "step": int(step),
        "sync_mode": str(sync_mode),
        "digest": (digest_tree(voted, leaves=voted_leaves)
                   if voted is not None else None),
        "shard_digest": (digest_tree(shard) if shard is not None else None),
        "summaries": summarize_tree(summarized, leaves=summary_leaves),
        "t": time.time(),
    }


def maybe_fingerprint(params, opt_state, step: int,
                      sync_mode: str = "allreduce",
                      shard=None) -> dict | None:
    """The commit hook: every ``HOROVOD_INTEGRITY_INTERVAL``-th commit of
    the caller's (world-aligned) counter ``step``, fingerprint the
    committed state and stage the record for the next heartbeat. Unarmed
    this is one int compare. Never raises: the defence plane must not
    take down the training it defends."""
    interval = check_interval()
    if interval <= 0:
        return None
    try:
        with _state.lock:
            _state.commit_count += 1
            prev = _state.prev_summary
        # The caller's counter, not this process's call count: a vote
        # needs one record per rank at the SAME (generation, step), and a
        # replacement's fresh process count would shift its fingerprints
        # off the survivors' for good. The state keeps ``step`` aligned
        # across worlds (its sync).
        if int(step) % interval != 0:
            return None
        t0 = time.perf_counter()
        record = make_record(params, opt_state, step, sync_mode=sync_mode,
                             shard=shard)
        # The previous interval's digest and L2 ride along: the two-voter
        # tie-break compares each rank's drift with its own trend.
        record["prev"] = prev
        with _state.lock:
            _state.latest = record
            _state.prev_summary = {
                "digest": record["digest"],
                "step": record["step"],
                # A vote that back-dates the quarantine from this prev
                # condemns the right generation's replica records even
                # across a world re-form.
                "generation": record["generation"],
                # The fsdp stuck-shard check: a shard that did not move
                # across an interval while every peer's did.
                "shard_digest": record["shard_digest"],
                "l2": [b["l2"] for b in record["summaries"]],
                "finite": [b["finite"] for b in record["summaries"]],
            }
            _state.fingerprints += 1
            _state.last_seconds = time.perf_counter() - t0
        _metrics.INTEGRITY_CHECKS.inc()
        return record
    except Exception as e:  # noqa: BLE001 — defence must not break training
        get_logger().warning("integrity: fingerprint failed: %s", e)
        return None


def heartbeat_payload() -> dict | None:
    """The latest staged record, for the worker's heartbeat (None when
    the plane is unarmed or nothing is staged yet)."""
    if not enabled():
        return None
    with _state.lock:
        return _state.latest


def _is_float_array(leaf) -> bool:
    """A float tensor or numpy array with any elements: the state the
    injector corrupts (a Python scalar, such as a param group's ``lr``, is
    a setting, not state)."""
    import numpy as np

    if _is_tensor(leaf):
        return leaf.is_floating_point() and leaf.numel() > 0
    return (isinstance(leaf, np.ndarray) and not leaf.dtype.hasobject
            and _is_float_dtype(leaf.dtype) and leaf.size > 0)


def _first_float_leaf(tree):
    """The first float array leaf of ``tree`` in the walk's order, or
    None."""
    for leaf in _iter_leaves(tree):
        if _is_float_array(leaf):
            return leaf
    return None


def _leaf_bytes(leaf) -> bytes:
    import numpy as np

    if _is_tensor(leaf):
        return _TensorLeaf(leaf).host_bytes().tobytes()
    return np.ascontiguousarray(leaf).tobytes()


def _from_bytes(like, data: bytes):
    """A new leaf of ``like``'s dtype, shape (and device) from ``data``:
    never a view of ``like``, so nothing writes through to it."""
    import numpy as np

    if _is_tensor(like):
        import torch

        new = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        return new.view(like.dtype).reshape(like.shape).to(like.device)
    return np.frombuffer(data, dtype=like.dtype).reshape(like.shape).copy()


def maybe_corrupt_snapshot(saved: dict) -> dict:
    """The ``grad.corrupt`` injector's call site: with the fault armed,
    flip seeded bits in the first float array leaf of each entry of the
    committed snapshot (``params``, ``param_row``, ``row``,
    ``opt_state``): host memory corrupting a replica copy, which only the
    cross-rank vote can see (the digests stay self-consistent). The
    containers along the path are rebuilt and the leaf replaced by a new
    one, so the live state and the caller's containers are never written.
    One fault hit per commit; unarmed this is one dict lookup. Returns
    ``saved`` with the entries replaced."""
    if not faults.armed(faults.GRAD_CORRUPT):
        return saved
    targets = []
    for key in ("params", "param_row", "row", "opt_state"):
        tree = saved.get(key)
        if tree is None:
            continue
        leaf = _first_float_leaf(tree)
        if leaf is not None:
            targets.append((key, leaf, _leaf_bytes(leaf)))
    if not targets:
        faults.fire(faults.GRAD_CORRUPT)  # count the hit anyway
        return saved
    blob = b"".join(b for _, _, b in targets)
    mutated = faults.corrupt_payload(faults.GRAD_CORRUPT, blob)
    if mutated == blob:
        return saved
    offset = 0
    for key, leaf, data in targets:
        new = _from_bytes(leaf, mutated[offset:offset + len(data)])
        offset += len(data)
        saved[key] = _replace_first_float_leaf(saved[key], new)
    get_logger().error(
        "integrity: grad.corrupt injected — committed snapshot mutated "
        "(%d bytes across %d entries)", len(blob), len(targets))
    return saved


def _replace_first_float_leaf(tree, new):
    """``tree`` with its first float array leaf (in the walk's order)
    replaced by ``new``: the containers along the way are new ones
    (mappings keep their key order, named tuples their type)."""
    done = False

    def walk(node):
        nonlocal done
        if done:
            return node
        if isinstance(node, Mapping):
            out = {}
            for k in sorted(node, key=str):
                out[k] = walk(node[k])
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            items = [walk(x) for x in node]
            if isinstance(node, tuple):
                try:
                    return type(node)(*items)  # NamedTuple
                except TypeError:
                    return tuple(items)
            return items
        if _is_float_array(node):
            done = True
            return new
        return node

    return walk(tree)


# ---------------------------------------------------------------------------
# Voting (driver and rendezvous-server side; standard library)
# ---------------------------------------------------------------------------


def vote(records: Mapping[Any, Mapping]) -> dict:
    """Majority-vote one complete (generation, step) group of records.

    Returns ``{"divergent", "outlier_rank", "outlier_host", "ambiguous",
    "method", "digests", "voters"}``. With three or more comparable
    digests the minority is named outright; with exactly two, asymmetric
    evidence breaks the tie: non-finite summaries first, then the
    per-bucket L2 drift against each rank's own previous record
    (:func:`tiebreak_ratio`). With no comparable digests (fsdp) the only
    signals are non-finite summaries and the stuck shard (``shard_digest``
    unchanged against the rank's own previous record while every peer's
    moved). No majority or an unbreakable tie: ``divergent`` with
    ``ambiguous=True``."""
    comparable = {r: rec for r, rec in records.items()
                  if rec.get("digest")}
    out = {
        "divergent": False,
        "ambiguous": False,
        "outlier_rank": None,
        "outlier_host": None,
        "method": None,
        "voters": len(records),
        "digests": {str(r): rec.get("digest")
                    for r, rec in records.items()},
    }
    # Non-finite summaries condemn on their own, digest or not.
    bad_finite = [
        (r, rec) for r, rec in records.items()
        if any(b.get("finite", b.get("n", 0)) < b.get("n", 0)
               for b in rec.get("summaries") or ())
    ]
    if bad_finite and len(bad_finite) < len(records):
        r, rec = bad_finite[0]
        out.update(divergent=True, method="nonfinite",
                   outlier_rank=rec.get("rank", r),
                   outlier_host=rec.get("host"))
        if len(bad_finite) > 1:
            out.update(ambiguous=True, outlier_rank=None,
                       outlier_host=None)
        return out
    if len(comparable) < 2:
        # No replicated digest (fsdp, or a lone rank): a training step
        # always changes a rank's shard, so a shard digest equal to the
        # rank's own previous one while every peer's moved is stuck.
        stuck, moved = [], 0
        for r, rec in records.items():
            sd = rec.get("shard_digest")
            prev = rec.get("prev")
            psd = (prev.get("shard_digest")
                   if isinstance(prev, Mapping) else None)
            if not sd or not psd:
                return out  # incomplete evidence: no verdict
            if sd == psd:
                stuck.append((r, rec))
            else:
                moved += 1
        if len(stuck) == 1 and moved >= 1:
            r, rec = stuck[0]
            out.update(divergent=True, method="stuck_shard",
                       outlier_rank=rec.get("rank", r),
                       outlier_host=rec.get("host"))
        return out
    digests: dict[str, list] = {}
    for r, rec in comparable.items():
        digests.setdefault(rec["digest"], []).append((r, rec))
    if len(digests) == 1:
        return out  # bitwise agreement: the steady state
    out["divergent"] = True
    counts = sorted(((len(v), d) for d, v in digests.items()),
                    reverse=True)
    if len(comparable) >= 3 and counts[0][0] > counts[1][0]:
        minority = [rv for d, group in digests.items()
                    if d != counts[0][1] for rv in group]
        if len(minority) == 1:
            r, rec = minority[0]
            out.update(method="majority",
                       outlier_rank=rec.get("rank", r),
                       outlier_host=rec.get("host"))
            return out
    if len(comparable) == 2:
        # Two voters: break the tie by drift against each rank's own
        # previous record, and only when both previous records agreed
        # bitwise (else the corruption predates this group and the
        # drift would name the healthy rank).
        prev_digests = {
            (rec.get("prev") or {}).get("digest")
            if isinstance(rec.get("prev"), Mapping) else None
            for _r, rec in comparable.items()}
        if len(prev_digests) != 1 or None in prev_digests:
            out["ambiguous"] = True
            return out
        drifts = []
        for r, rec in comparable.items():
            d = _summary_drift(rec)
            if d is None:
                drifts = []
                break
            drifts.append((d, r, rec))
        if drifts:
            drifts.sort(reverse=True)
            worst, best = drifts[0][0], drifts[-1][0]
            if worst > max(best, 1e-12) * tiebreak_ratio():
                _, r, rec = drifts[0]
                out.update(method="drift",
                           outlier_rank=rec.get("rank", r),
                           outlier_host=rec.get("host"))
                return out
    out["ambiguous"] = True
    return out


def _summary_drift(record: Mapping) -> float | None:
    """Relative per-bucket L2 drift of a record against its own inlined
    previous summary; None when no previous record rides along."""
    prev = record.get("prev")
    if not isinstance(prev, Mapping):
        return None
    prev_l2 = prev.get("l2")
    cur = [b.get("l2", 0.0) for b in record.get("summaries") or ()]
    if not isinstance(prev_l2, (list, tuple)) or len(prev_l2) != len(cur):
        return None
    drift = 0.0
    for now, was in zip(cur, prev_l2):
        try:
            drift += abs(float(now) - float(was)) / (abs(float(was)) + 1e-9)
        except (TypeError, ValueError):
            return None
    return drift


def vote_latest(records_by_rank: Mapping[Any, Mapping],
                world_size: int) -> tuple[tuple[int, int], dict] | None:
    """Vote the newest COMPLETE (generation, step) group: one record per
    rank 0..world_size-1 at the same key. Incomplete groups are skipped (a
    vote over a partial world could name a rank whose record has not
    arrived yet). Returns ((generation, step), vote) or None."""
    groups: dict[tuple[int, int], dict] = {}
    for key, rec in records_by_rank.items():
        if not isinstance(rec, Mapping):
            continue
        try:
            group = (int(rec.get("generation", 0)), int(rec["step"]))
            rank = int(rec.get("rank", key))
        except (KeyError, TypeError, ValueError):
            continue
        groups.setdefault(group, {})[rank] = rec
    for group in sorted(groups, reverse=True):
        members = groups[group]
        if len(members) >= int(world_size) and set(
                range(int(world_size))) <= set(members):
            return group, vote({r: members[r]
                                for r in range(int(world_size))})
    return None


# ---------------------------------------------------------------------------
# Non-finite tripwire (host side)
# ---------------------------------------------------------------------------


def note_nonfinite(action: str, ok, idx) -> None:
    """The tripwire's report of one checked step (``ok``: the reduced
    gradients were finite) from shard ``idx`` of this process (0 for the
    port's one rank per process). A step counts once: a repeated index
    starts a new step's burst, and only the first call of a burst counts.
    A detection is counted (``hvd_nonfinite_steps_total{action}``) and
    journaled (``nonfinite_step``); ``abort`` also posts the coordinated
    abort (``abort.post``: the KV record reaches every rank within one
    abort-poll interval, and the local flag is armed at once), so every
    blocking site raises into the elastic ladder. Never raises."""
    try:
        idx = int(idx)
        with _state.lock:
            if idx in _state.nonfinite_burst:
                _state.nonfinite_burst = {idx}     # a new step's burst
            else:
                _state.nonfinite_burst.add(idx)
            first_of_burst = len(_state.nonfinite_burst) == 1
            if first_of_burst and not bool(ok):
                _state.nonfinite_detections += 1
                n = _state.nonfinite_detections
        if not first_of_burst or bool(ok):
            return
        _metrics.NONFINITE_STEPS.inc(action=action)
        _metrics.event("nonfinite_step", action=action, detections=n)
        get_logger().warning(
            "integrity: non-finite reduced gradients detected "
            "(action=%s, detection #%d)", action, n)
        if action == "abort":
            from . import abort

            abort.post(
                "non-finite gradients (HOROVOD_NONFINITE_ACTION=abort)")
    except Exception:  # noqa: BLE001 — the tripwire must not take down
        pass           # the step it is guarding


# ---------------------------------------------------------------------------
# Rewind on a loss spike
# ---------------------------------------------------------------------------


class LossSpikeDetector:
    """EWMA mean and variance spike detector over the training loss.

    ``observe`` folds one sample; it returns True when the sample sits more
    than ``sigma`` standard deviations above the EWMA trend after
    ``warmup`` samples, or is non-finite (which trips at once once
    anything was observed). A spike is not folded into the trend (the
    rewind discards it)."""

    def __init__(self, sigma: float, alpha: float | None = None,
                 warmup: int | None = None):
        self.sigma = float(sigma)
        self.alpha = (get_float("HOROVOD_LOSS_SPIKE_ALPHA", 0.1)
                      if alpha is None else float(alpha))
        self.warmup = (get_int("HOROVOD_LOSS_SPIKE_WARMUP", 8)
                       if warmup is None else int(warmup))
        self.mean = 0.0
        self.var = 0.0
        self.samples = 0

    def observe(self, loss: float) -> bool:
        loss = float(loss)
        if not math.isfinite(loss):
            # Counted as observed, not folded: a stream non-finite from
            # its first sample trips on the second.
            tripped = self.samples >= 1
            self.samples += 1
            return tripped
        if self.samples >= self.warmup:
            dev = loss - self.mean
            if dev > self.sigma * math.sqrt(max(self.var, 0.0)) + 1e-12:
                return True
        delta = loss - self.mean
        self.mean += self.alpha * delta
        self.var = (1.0 - self.alpha) * (
            self.var + self.alpha * delta * delta)
        self.samples += 1
        return False


_detector: LossSpikeDetector | None = None
_detector_lock = threading.Lock()


def _get_detector() -> LossSpikeDetector | None:
    global _detector
    sigma = loss_spike_sigma()
    if sigma is None:
        return None
    with _detector_lock:
        if _detector is None or _detector.sigma != sigma:
            _detector = LossSpikeDetector(sigma)
        return _detector


def observe_loss(loss) -> None:
    """Feed one rank-identical loss sample (a float or a one-element
    tensor: read on the host) to the spike detector.

    Unarmed (``HOROVOD_LOSS_SPIKE_SIGMA`` unset) this is one env read. On a
    spike: stages one skip-ahead batch, posts the coordinated abort (every
    rank leaves its collectives and rewinds together), and raises
    ``LossSpikeError``, which the elastic loop turns into a rewind to the
    last commit."""
    det = _get_detector()
    if det is None:
        return
    if not det.observe(float(loss)):
        return
    from . import abort
    from .exceptions import LossSpikeError

    with _state.lock:
        _state.skip_ahead += 1
    msg = (f"loss spike: {float(loss):.6g} is more than "
           f"{det.sigma:g} sigma above the EWMA trend "
           f"(mean {det.mean:.6g}, std "
           f"{math.sqrt(max(det.var, 0.0)):.6g})")
    get_logger().error("integrity: %s — rewinding to the last commit", msg)
    try:
        abort.post(f"loss-spike rewind: {msg}")
    except Exception:  # noqa: BLE001 — the local rewind still happens
        pass
    raise LossSpikeError(msg)


def consume_skip_ahead() -> int:
    """Batches the training loop should skip after a rewind (the poison
    batch must not replay): the staged count, zeroed."""
    with _state.lock:
        n = _state.skip_ahead
        _state.skip_ahead = 0
    return n


def record_rewind(reason: str, generation: int | None = None,
                  consecutive: int = 1, detail: str = "") -> None:
    """Count (``hvd_rewinds_total{reason}``) and journal (``rewind``) one
    storage-free rewind; the elastic loop calls it."""
    with _state.lock:
        _state.rewinds += 1
    _metrics.REWINDS.inc(reason=reason)
    _metrics.event("rewind", generation=generation, reason=reason,
                   consecutive=consecutive, detail=detail[:300])


# ---------------------------------------------------------------------------
# Observability
# ---------------------------------------------------------------------------


def flight_summary() -> dict | None:
    """The plane's state for a flight record: the latest staged
    fingerprint's group and digests, and the tripwire and rewind counts.
    None when the plane never engaged."""
    try:
        with _state.lock:
            latest = _state.latest
            nonfinite = _state.nonfinite_detections
            rewinds = _state.rewinds
        if latest is None and not nonfinite and not rewinds:
            return None
        out: dict = {"nonfinite_detections": nonfinite,
                     "rewinds": rewinds}
        if latest is not None:
            out["latest"] = {
                "generation": latest.get("generation"),
                "step": latest.get("step"),
                "digest": latest.get("digest"),
                "shard_digest": latest.get("shard_digest"),
                "sync_mode": latest.get("sync_mode"),
            }
        return out
    except Exception:  # noqa: BLE001 — postmortems are best-effort
        return None


def summary() -> dict:
    """This process's integrity ledger, for ``profiler.summary()``."""
    with _state.lock:
        return {
            "armed": enabled(),
            "interval": check_interval(),
            # checks: fingerprints computed (hvd_integrity_checks_total);
            # commits: every commit seen, most of which the gate passes.
            "checks": _state.fingerprints,
            "commits": _state.commit_count,
            "latest_digest": (_state.latest or {}).get("digest"),
            "nonfinite_detections": _state.nonfinite_detections,
            "rewinds": _state.rewinds,
            "skip_ahead_pending": _state.skip_ahead,
        }


def last_fingerprint_seconds() -> float | None:
    """Seconds the latest fingerprint took (host clock), or None."""
    with _state.lock:
        return _state.last_seconds


def reset_for_testing() -> None:
    global _detector
    with _state.lock:
        _state.commit_count = 0
        _state.fingerprints = 0
        _state.latest = None
        _state.prev_summary = None
        _state.nonfinite_detections = 0
        _state.nonfinite_burst = set()
        _state.rewinds = 0
        _state.skip_ahead = 0
        _state.last_seconds = None
    with _detector_lock:
        _detector = None
