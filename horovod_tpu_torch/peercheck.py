"""Peer-redundant in-memory checkpoints: the replication plane under the
recovery ladder's ``peer`` rung.

Port of ``horovod_tpu/peercheck.py``. Under ``sync_mode="sharded"`` or
``"fsdp"`` each rank owns about 1/n of the optimizer state (fsdp: of the
parameters too), and ownership follows from the world size alone, so K
peers holding a copy of each rank's shards let the survivors of a lost
rank rebuild the whole state without reading storage:

1. **Wire format** (:func:`encode_record` / :func:`decode_record`, the
   reference's :156-232): one self-verifying record per rank per commit, a
   JSON header line (rank, step, generation, world size, payload sha256)
   and then the payload bytes. The header is byte for byte the
   reference's, so each package decodes the other's records; the payload
   is the port's own (pickled host tensors, never CUDA tensors). A torn,
   truncated or flipped record fails verification.
2. **Replica pool** (:class:`ReplicaPool`): the in-memory store a rank
   holds replicas in, the last good record of each rank and a ``.prev``
   slot, rotated through ``checkpoint.rotate_slots``. A record is verified
   before it is installed, so a bad one leaves the pool as it was.
3. **Replicator** (:class:`PeerReplicator`): on each commit, puts the
   rank's record to the generation-fenced ``PUT /peerstate/<rank>`` route
   of the rendezvous server and pulls its K ring predecessors' records
   (``HOROVOD_PEERCHECK_REPLICAS``) into its pool.
4. **Assembly** (:func:`assemble_records`): the newest complete set, one
   verified record per rank of one ``(generation, step)``, of a generation
   no later than the current one. A gap raises
   :class:`ReplicaUnavailableError`, which the ladder turns into a fall
   through to the durable rung.

The elastic side (``PeerShardedState``) is in ``elastic/__init__.py``, the
rung in ``elastic/runner.py``. The module imports the standard library
only: the rendezvous server verifies records with it in the driver, which
imports no torch.

With the integrity plane armed (``HOROVOD_INTEGRITY_INTERVAL``), the
replicator reads the server's quarantine map (``GET /integrity``) at
assembly and :func:`assemble_records` drops every record of a condemned
rank inside its condemned range, and each slot keeps two ``.prev``
generations (the vote lags the condemned commit by up to one commit).

Not ported yet: the 2-D mesh coordinates of a record (none until
``parallel/mesh.py`` is ported).

Each publication observes ``hvd_peer_replication_bytes`` / ``_seconds``
and ``hvd_checkpoint_seconds{kind="save", rung="peer"}`` and journals
``peer_replicate``; the pool sets ``hvd_peer_pool_replicas``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Mapping

from . import faults
from .utils.env import get_float, get_int
from .utils.logging import get_logger

#: KV scope replica records go to (``PUT /peerstate/<rank>``).
PEERSTATE_SCOPE = "peerstate"

#: Suffix of the retained previous slot (in the pool and on the server).
PREV_SUFFIX = ".prev"

_MAGIC = "HVDPEER1"


def replica_count() -> int:
    """K: how many ring neighbours hold each rank's record."""
    return max(1, get_int("HOROVOD_PEERCHECK_REPLICAS", 1))


def max_record_bytes() -> int:
    """The server's bound on one record's wire size
    (``HOROVOD_PEERCHECK_MAX_BYTES``, default 256 MiB)."""
    return get_int("HOROVOD_PEERCHECK_MAX_BYTES", 256 << 20)


def retention_depth() -> int:
    """How many ``.prev`` generations a slot rotation keeps, in the pool
    and on the server: ``HOROVOD_PEER_RETAIN``, by default 1, and 2 with
    the integrity plane armed: its vote lags the condemned commit by up to
    one commit (heartbeat cadence and driver tick), so the condemned
    commit and the one a racing rank lands meanwhile may both be
    quarantined, and assembly still needs a clean complete group under
    them."""
    from . import integrity

    return get_int("HOROVOD_PEER_RETAIN", 2 if integrity.enabled() else 1)


class ReplicaCorruptError(ValueError):
    """A replica record failed decoding or checksum verification."""


class ReplicaUnavailableError(RuntimeError):
    """No complete, verified replica set of this lineage: the peer rung
    falls through to the durable rung."""


class ReplicaRecord:
    """One rank's shard snapshot at one commit, and where it came from."""

    __slots__ = ("rank", "step", "generation", "world_size", "has_params",
                 "mesh_coords", "payload")

    def __init__(self, rank: int, step: int, generation: int,
                 world_size: int, payload: bytes, has_params: bool = False,
                 mesh_coords=None):
        self.rank = int(rank)
        self.step = int(step)
        self.generation = int(generation)
        self.world_size = int(world_size)
        self.has_params = bool(has_params)
        self.mesh_coords = (None if mesh_coords is None
                            else tuple(int(v) for v in mesh_coords))
        self.payload = payload

    def group(self) -> tuple[int, int]:
        """The commit identity that records are matched across ranks by."""
        return (self.generation, self.step)

    def summary(self) -> dict:
        out = {"rank": self.rank, "step": self.step,
               "generation": self.generation,
               "world_size": self.world_size,
               "bytes": len(self.payload)}
        if self.mesh_coords is not None:
            out["mesh_coords"] = list(self.mesh_coords)
        return out


def encode_record(record: ReplicaRecord) -> bytes:
    """Wire form: one JSON header line (keys sorted, as the reference
    writes it), then the raw payload. The header carries the payload's
    sha256 (``checkpoint.payload_digest``)."""
    from .checkpoint import payload_digest

    header = json.dumps({
        "magic": _MAGIC,
        "rank": record.rank,
        "step": record.step,
        "generation": record.generation,
        "world_size": record.world_size,
        "has_params": record.has_params,
        **({"mesh_coords": list(record.mesh_coords)}
           if record.mesh_coords is not None else {}),
        "sha256": payload_digest(record.payload),
        "bytes": len(record.payload),
    }, sort_keys=True).encode()
    return header + b"\n" + record.payload


def decode_record(blob: bytes, verify: bool = True) -> ReplicaRecord:
    """Parse a wire record and, by default, verify its checksum; raises
    :class:`ReplicaCorruptError` on a torn header, a short payload or a
    digest mismatch."""
    from .checkpoint import payload_digest

    nl = blob.find(b"\n")
    if nl < 0:
        raise ReplicaCorruptError("replica record has no header line")
    try:
        header = json.loads(blob[:nl])
    except (ValueError, UnicodeDecodeError) as e:
        raise ReplicaCorruptError(f"replica header unparseable: {e}") from e
    if not isinstance(header, dict) or header.get("magic") != _MAGIC:
        raise ReplicaCorruptError("replica header has no magic")
    payload = blob[nl + 1:]
    try:
        declared = int(header["bytes"])
        record = ReplicaRecord(
            rank=header["rank"], step=header["step"],
            generation=header["generation"],
            world_size=header["world_size"], payload=payload,
            has_params=header.get("has_params", False),
            mesh_coords=header.get("mesh_coords"),
        )
    except (KeyError, TypeError, ValueError) as e:
        raise ReplicaCorruptError(f"replica header incomplete: {e}") from e
    if len(payload) != declared:
        raise ReplicaCorruptError(
            f"replica payload truncated: {len(payload)} of {declared} bytes")
    if verify:
        if faults.fire(faults.PEER_VERIFY):
            raise ReplicaCorruptError(
                "replica checksum mismatch (injected corruption)")
        if payload_digest(payload) != header["sha256"]:
            raise ReplicaCorruptError(
                f"replica payload for rank {record.rank} failed its "
                "checksum (torn/corrupted write)")
    return record


def verify_wire(blob: bytes) -> str | None:
    """The server's install-time gate: None when ``blob`` is a complete,
    verified record, else why it is not. Never raises."""
    try:
        decode_record(blob, verify=True)
        return None
    except ReplicaCorruptError as e:
        return str(e)
    except Exception as e:  # noqa: BLE001 — any failure is a rejection
        return f"replica record unreadable: {e}"


class ReplicaPool:
    """The last good record of each rank and a ``.prev`` slot, in memory,
    rotated through ``checkpoint.rotate_slots``. A record is verified
    before the rotation, so a corrupt one leaves both slots as they
    were."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: dict[str, ReplicaRecord] = {}
        # The memory observatory polls the pool's bytes live
        # (hvd_hbm_bytes{kind="peer_pool"}): replicas arrive from peers
        # outside any noting call site.
        from . import memory

        memory.get_observatory().register_supplier("peer_pool", self.nbytes)

    def nbytes(self) -> int:
        """Payload bytes held in the pool (all slots)."""
        with self._lock:
            return sum(len(r.payload) for r in self._slots.values())

    def install(self, blob_or_record) -> ReplicaRecord:
        """Verify and rotate one record in; :class:`ReplicaCorruptError`
        (pool untouched) on a bad one."""
        from .checkpoint import rotate_slots

        if isinstance(blob_or_record, ReplicaRecord):
            record = blob_or_record
        else:
            record = decode_record(blob_or_record, verify=True)
        with self._lock:
            existing = self._slots.get(str(record.rank))
            if existing is not None and existing.group() == record.group():
                # The same commit offered again (a neighbour pull after the
                # rank's own install): keep the slot, keep .prev.
                return existing
            rotate_slots(self._slots, str(record.rank), record,
                         prev_suffix=PREV_SUFFIX, depth=retention_depth())
            count = len(self._slots)
        from . import metrics

        metrics.PEER_POOL_REPLICAS.set(count)
        return record

    def records(self) -> list[ReplicaRecord]:
        with self._lock:
            return list(self._slots.values())

    def get(self, rank: int, prev: bool = False) -> ReplicaRecord | None:
        key = f"{rank}{PREV_SUFFIX}" if prev else str(rank)
        with self._lock:
            return self._slots.get(key)

    def clear(self) -> None:
        with self._lock:
            self._slots.clear()

    def summary(self) -> dict:
        """What the pool holds: each slot's summary and the count."""
        with self._lock:
            slots = dict(self._slots)
        return {
            "replicas": {k: r.summary() for k, r in sorted(slots.items())},
            "count": len(slots),
        }


def _env_generation() -> int:
    """The generation records are stamped with: the elastic worker's
    joined generation when it has a context, else the launcher's env."""
    from .runner.elastic import worker as elastic_worker

    ctx = elastic_worker._context
    if ctx is not None:
        return ctx.joined_version
    try:
        return int(os.environ.get("HOROVOD_WORLD_VERSION", "0") or 0)
    except ValueError:
        return 0


class PeerReplicator:
    """One rank's replication agent: publish its own record at each
    commit, hold its K ring predecessors' records, assemble a complete
    set on recovery.

    ``client`` is anything with ``KVClient``'s ``put``/``get``/``keys``;
    by default a dedicated client is built from the launcher's env, with
    ``HOROVOD_PEERCHECK_TIMEOUT`` seconds (default 5) and one attempt (the
    put runs inside the commit and must not take the KV client's retry
    budget), stamped with the generation. ``rank`` (or ``rank_fn``),
    ``world_size_fn`` and ``generation_fn`` default to the launcher's env
    and the elastic worker's joined generation.
    """

    def __init__(self, client=None, k: int | None = None,
                 rank: int | None = None,
                 world_size_fn: Callable[[], int] | None = None,
                 generation_fn: Callable[[], int] | None = None,
                 rank_fn: Callable[[], int] | None = None):
        self._client = client
        self._k = k
        self._rank = rank
        self._rank_fn = rank_fn
        self._world_size_fn = world_size_fn
        self._generation_fn = generation_fn or _env_generation
        self.pool = ReplicaPool()
        self._log = get_logger()
        global _active
        _active = self

    @property
    def rank(self) -> int:
        if self._rank is not None:
            return self._rank
        if self._rank_fn is not None:
            return int(self._rank_fn())
        return int(os.environ.get("HOROVOD_RANK", "0") or 0)

    def world_size(self) -> int:
        if self._world_size_fn is not None:
            return int(self._world_size_fn())
        return int(os.environ.get("HOROVOD_NUM_PROCESSES", "1") or 1)

    @property
    def k(self) -> int:
        return self._k if self._k is not None else replica_count()

    def generation(self) -> int:
        return int(self._generation_fn())

    def repoint(self) -> None:
        """Drop the cached client, so that the next replicate or fetch
        builds one from the env again: the worker calls it when it
        follows a restarted driver to its new endpoint, and the next
        commit puts this rank's record to the successor's server."""
        self._client = None

    def client(self):
        if self._client is None:
            addr = os.environ.get("HOROVOD_RENDEZVOUS_ADDR", "")
            port = os.environ.get("HOROVOD_RENDEZVOUS_PORT", "")
            if not addr or not port:
                return None
            from .runner.http.kv_server import KVClient

            self._client = KVClient(
                addr, int(port),
                timeout=get_float("HOROVOD_PEERCHECK_TIMEOUT", 5.0),
                retries=1, generation_fn=self._generation_fn)
        return self._client

    # -- publish (the commit hook) -------------------------------------------

    def replicate(self, payload: bytes, step: int,
                  has_params: bool = False) -> bool:
        """Publish this rank's record of one commit and refresh the pool
        with the K ring predecessors' records. A failure is logged and
        never raised: it leaves the peer rung without this commit, and
        recovery falls through to durable. True when the record landed on
        the server."""
        record = ReplicaRecord(
            rank=self.rank, step=step, generation=self.generation(),
            world_size=self.world_size(), payload=payload,
            has_params=has_params)
        blob = encode_record(record)
        # peer.corrupt flips bits of the encoded blob (its digest already
        # in the header): a flip on the wire, which the server must refuse
        # (422). The local pool installs the record as it was encoded.
        blob = faults.corrupt_payload(faults.PEER_CORRUPT, blob)
        shipped = False
        t0 = time.perf_counter()
        try:
            if faults.fire(faults.PEER_REPLICATE):
                raise faults.InjectedFault(
                    f"peer replication dropped: rank {record.rank} "
                    f"step {step}")
            client = self.client()
            if client is not None:
                client.put(PEERSTATE_SCOPE, str(record.rank), blob)
                shipped = True
            self.pool.install(record)
            self._pull_neighbors(client)
        except Exception as e:  # noqa: BLE001 — replication is best-effort
            self._log.warning(
                "peercheck: replication of step %d failed (%s); the peer "
                "recovery rung degrades to durable until the next commit",
                step, e)
        from . import metrics

        dt = time.perf_counter() - t0
        metrics.PEER_REPLICATION_BYTES.observe(len(blob))
        metrics.PEER_REPLICATION_SECONDS.observe(dt)
        metrics.CHECKPOINT_SECONDS.observe(dt, kind="save", rung="peer")
        metrics.event(
            "peer_replicate", generation=record.generation,
            rank=record.rank, step=step, bytes=len(blob),
            world_size=record.world_size, shipped=shipped)
        return shipped

    def _pull_neighbors(self, client) -> None:
        """Hold the K ring predecessors' records: rank r's record lives on
        ranks r+1 .. r+K mod n, so any one lost host leaves K holders."""
        if client is None:
            return
        n = self.world_size()
        if n <= 1:
            return
        me = self.rank
        for i in range(1, min(self.k, n - 1) + 1):
            neighbor = (me - i) % n
            try:
                blob = client.get(PEERSTATE_SCOPE, str(neighbor))
                if blob is not None:
                    self.pool.install(blob)
            except Exception as e:  # noqa: BLE001 — best-effort
                self._log.debug(
                    "peercheck: neighbor %d pull failed: %s", neighbor, e)

    # -- assemble (the recovery side) ----------------------------------------

    def fetch_all(self) -> list[ReplicaRecord]:
        """Every verified record this rank can see: its pool and the
        server's ``peerstate`` scope (current and ``.prev`` slots)."""
        records: list[ReplicaRecord] = list(self.pool.records())
        client = self.client()
        if client is not None:
            try:
                keys = client.keys(PEERSTATE_SCOPE)
            except Exception as e:  # noqa: BLE001
                self._log.warning(
                    "peercheck: cannot list the peerstate scope (%s)", e)
                keys = []
            for key in keys:
                try:
                    blob = client.get(PEERSTATE_SCOPE, key)
                    if blob is not None:
                        records.append(decode_record(blob, verify=True))
                except ReplicaCorruptError as e:
                    self._log.error(
                        "peercheck: replica %r failed verification: %s",
                        key, e)
                except Exception as e:  # noqa: BLE001
                    self._log.debug(
                        "peercheck: replica %r fetch failed: %s", key, e)
        return records

    def latest_step(self, before_generation: int) -> int:
        """The highest commit step any earlier generation recorded: the
        baseline every rank of a new world aligns its commit counter to.
        Earlier generations only, which the server's fence has frozen, so
        every rank reads the same maximum; 0 when none qualifies."""
        steps = [r.step for r in self.fetch_all()
                 if r.generation < before_generation]
        return max(steps, default=0)

    def quarantined(self) -> Mapping[str, Mapping]:
        """The server's integrity quarantine map (rank to
        ``{generation, step, from_generation, from_step, host}``), read at
        assembly so a condemned rank's records leave this rank's local
        pool too. Empty when the voting plane is unarmed (no request at
        all), no server is reachable, or nothing is quarantined; an
        unreachable server assembles unfiltered, as before the plane."""
        from . import integrity

        if not integrity.enabled():
            return {}
        client = self.client()
        if client is None:
            return {}
        try:
            quarantine = client.integrity_view().get("quarantined")
            return quarantine if isinstance(quarantine, Mapping) else {}
        except Exception as e:  # noqa: BLE001 — the filter is best-effort
            self._log.warning(
                "peercheck: cannot read the integrity quarantine (%s); "
                "assembling unfiltered", e)
            return {}

    def assemble(self, current_generation: int | None = None
                 ) -> list[ReplicaRecord]:
        """The newest complete, verified replica set of this lineage, in
        rank order; :class:`ReplicaUnavailableError` otherwise."""
        if current_generation is None:
            current_generation = self.generation()
        return assemble_records(self.fetch_all(), current_generation,
                                quarantine=self.quarantined(),
                                log=self._log)


def assemble_records(records, current_generation: int,
                     quarantine: Mapping | None = None,
                     log=None) -> list[ReplicaRecord]:
    """The newest ``(generation, step)`` group with one record per rank of
    one agreed world size, its generation no later than
    ``current_generation``, and no member inside a quarantine entry's
    condemned range (a group that a condemned in-world rank touches is
    refused whole, never completed from ``.prev`` slots). Raises
    :class:`ReplicaUnavailableError` naming every rejected group."""
    quarantine = quarantine or {}
    groups: dict[tuple[int, int], dict[int, ReplicaRecord]] = {}
    dropped: dict[tuple[int, int], set[int]] = {}
    for record in records:
        if record.generation > current_generation:
            continue  # a later generation: not this lineage
        entry = quarantine.get(str(record.rank))
        if entry is not None and _condemned(record, entry):
            if log is not None:
                log.error(
                    "peercheck: dropping replica of rank %d at (gen %d, "
                    "step %d) — integrity-quarantined since (gen %s, "
                    "step %s)", record.rank, record.generation,
                    record.step, entry.get("generation"),
                    entry.get("step"))
            dropped.setdefault(record.group(), set()).add(record.rank)
            continue
        slot = groups.setdefault(record.group(), {})
        held = slot.get(record.rank)
        if held is None or len(record.payload) >= len(held.payload):
            slot[record.rank] = record
    if not groups and not dropped:
        raise ReplicaUnavailableError(
            "no replica records visible (pool empty, peerstate scope "
            "empty or unreachable)")
    reasons: list[str] = []
    for group_key in sorted(set(groups) | set(dropped), reverse=True):
        generation, step = group_key
        members = groups.get(group_key, {})
        sizes = {r.world_size for r in members.values()}
        if len(sizes) > 1:
            reasons.append(
                f"(gen {generation}, step {step}): inconsistent world "
                f"sizes {sorted(sizes)}")
            continue
        world = sizes.pop() if sizes else 0
        condemned_here = sorted(
            r for r in dropped.get(group_key, ())
            if world == 0 or r < world)
        if condemned_here:
            reasons.append(
                f"(gen {generation}, step {step}): ranks "
                f"{condemned_here} integrity-quarantined (condemned "
                "range covers this commit)")
            continue
        missing = sorted(set(range(world)) - set(members))
        if missing:
            reasons.append(
                f"(gen {generation}, step {step}): missing ranks "
                f"{missing} of {world}")
            continue
        return [members[r] for r in range(world)]
    raise ReplicaUnavailableError(
        "no complete replica set: " + "; ".join(reasons))


def _condemned(record: ReplicaRecord, entry: Mapping) -> bool:
    """True when ``record`` lies in a quarantine entry's condemned range:
    from ``from_generation``/``from_step`` (else the entry's own
    ``generation``/``step``) through the entry's generation. A later
    generation's record is another owner of the rank id and passes. An
    unreadable entry condemns (fails closed)."""
    try:
        fence_gen = int(entry.get("generation", -1))
        start_gen = int(entry.get("from_generation", fence_gen))
        start_step = int(entry.get("from_step", entry.get("step", 0)))
    except (TypeError, ValueError):
        return True
    return (record.generation <= fence_gen
            and (record.generation, record.step)
            >= (start_gen, start_step))


_active: PeerReplicator | None = None


def active_replicator() -> PeerReplicator | None:
    """The process's most recently built replicator."""
    return _active


def pool_summary() -> dict | None:
    """The replica pool's state for flight-record dumps, or None when no
    replicator exists in this process."""
    rep = active_replicator()
    return None if rep is None else rep.pool.summary()


def reset_for_testing() -> None:
    global _active
    _active = None
