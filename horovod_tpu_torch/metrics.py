"""Cluster-wide metrics plane: counters, gauges, histograms, goodput, and
the lifecycle journal.

A copy of ``horovod_tpu/metrics.py`` for the PyTorch port (the port
imports nothing of the JAX package), with every family of the JAX module
(:595-909) under the same name, help and labels, so that a scrape of the
port's rendezvous server renders what the JAX package's renders. Three
consumers:

1. **In-process instruments** (stdlib-only, lock-cheap): fixed-bucket
   histograms, counters and gauges on the hot paths: eager collective
   dispatch (``ops/collective_ops.py``), gradient flushes
   (``optimizer.py``), stall tickets, coordinated aborts, control-plane
   retries. :func:`snapshot` dumps them as JSON-able dicts.
2. **The cluster scrape**: every elastic worker sends its snapshot on the
   heartbeat it already sends (``runner/elastic/worker.py``), and the
   rendezvous server renders all of them, with its own driver-side
   gauges, as one Prometheus ``GET /metrics`` (``runner/http/kv_server.py``).
3. **The lifecycle journal** (``HOROVOD_EVENT_LOG=/path``): JSONL records
   of elastic lifecycle events, each stamped with the world generation and
   the wall and monotonic clocks (``HOROVOD_EVENT_LOG_MAX_BYTES`` rotates
   it to ``<path>.prev``).

The comms and memory observatories (``comms_model.py``, ``memory.py``)
feed the ``hvd_link_*``, ``hvd_collective_efficiency_ratio``,
``hvd_comms_residual_seconds`` and ``hvd_hbm_*`` families; their zero
cells carry the port's link classes, ``intra_host`` and ``inter_host``
(``topology.py``), where the JAX module's carry ``ici`` and ``dcn``.
Families whose feeders come with later modules (the policy, integrity and
planner planes, MoE, serving) are defined and not fed. Where the port's
sensors differ: the gradient-flush families count one observation per
update (the port has no trace), and on the card an eager collective's
latency is its device time from CUDA events (``ops/collective_ops.py``).

Everything is per-process; the scrape aggregates by per-rank labels.
Counters only go up (until :func:`reset_for_testing`), gauges hold the
last value, histograms use fixed buckets per signal so snapshots merge.

No third-party imports: the rendezvous server, which runs on the driver
where torch is never imported, renders its scrape through this module.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import sys
import threading
import time
from typing import Any, Iterable, Mapping, Sequence

from .attribution import PHASE_WALL, STEP_PHASES

# ---------------------------------------------------------------------------
# Bucket ladders (fixed per signal class, so per-rank snapshots merge).
# ---------------------------------------------------------------------------

#: Eager-dispatch wall time: sub-ms cache hits through wedged-minutes tails.
LATENCY_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: Payload sizes: scalars through multi-GB fused buckets.
BYTE_BUCKETS = (
    256, 1024, 4096, 16384, 65536, 262144,
    1 << 20, 4 << 20, 16 << 20, 64 << 20, 256 << 20, 1 << 30,
)

#: XLA compiles and autotune windows: 10ms fast paths to minutes.
COMPILE_BUCKETS_S = (
    0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

#: Small cardinalities (buckets per flush, segments).
COUNT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------


class _ValueCell:
    """One labeled counter/gauge time series. The lock is per-cell and
    held only across the read-modify-write (CPython ``+=`` on an
    attribute is not atomic), so hot-path contention is nil."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def get(self) -> float:
        with self._lock:
            return self.value


class _HistogramCell:
    """One labeled histogram series: fixed-bound bucket counts + sum."""

    __slots__ = ("_lock", "_bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float]):
        self._lock = threading.Lock()
        self._bounds = bounds
        self.counts = [0] * len(bounds)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self._bounds, value)
        with self._lock:
            if idx < len(self.counts):
                self.counts[idx] += 1
            self.sum += value
            self.count += 1


class Family:
    """A named instrument with a fixed label schema; cells are created on
    first use per label-value combination.

    ``kind`` is one of ``counter`` / ``gauge`` / ``histogram``. The
    convenience mutators (:meth:`inc`, :meth:`set`, :meth:`observe`) take
    the labels as keyword arguments: ``FAM.inc(kind="allreduce")``.
    """

    def __init__(self, name: str, kind: str, help_text: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] | None = None):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        if kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"unknown instrument kind {kind!r}")
        if kind == "histogram" and not buckets:
            raise ValueError(f"histogram {name} needs buckets")
        self.name = name
        self.kind = kind
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(float(b) for b in (buckets or ()))
        self._lock = threading.Lock()
        self._cells: dict[tuple[str, ...], Any] = {}

    def labels(self, **labelvalues: Any):
        """The cell for one label-value combination (created at zero on
        first use, so scrape output includes it from then on)."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = (_HistogramCell(self.buckets)
                        if self.kind == "histogram" else _ValueCell())
                self._cells[key] = cell
            return cell

    def inc(self, amount: float = 1.0, **labelvalues: Any) -> None:
        self.labels(**labelvalues).inc(amount)

    def set(self, value: float, **labelvalues: Any) -> None:
        self.labels(**labelvalues).set(value)

    def observe(self, value: float, **labelvalues: Any) -> None:
        self.labels(**labelvalues).observe(value)

    # -- snapshot -----------------------------------------------------------

    def dump(self) -> dict:
        """JSON-able snapshot of this family (the piggyback wire format)."""
        with self._lock:
            items = list(self._cells.items())
        samples = []
        for key, cell in items:
            labels = dict(zip(self.labelnames, key))
            if self.kind == "histogram":
                with cell._lock:
                    samples.append({
                        "labels": labels,
                        "counts": list(cell.counts),
                        "sum": cell.sum,
                        "count": cell.count,
                    })
            else:
                samples.append({"labels": labels, "value": cell.get()})
        out = {
            "name": self.name,
            "kind": self.kind,
            "help": self.help,
            "samples": samples,
        }
        if self.kind == "histogram":
            out["buckets"] = list(self.buckets)
        return out

    def _reset(self) -> None:
        with self._lock:
            self._cells.clear()


class Registry:
    """Process-wide instrument registry. ``counter``/``gauge``/
    ``histogram`` are get-or-create (idempotent; re-registration with a
    different schema raises), so modules can declare instruments at import
    without ordering constraints."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}

    def _get_or_create(self, name, kind, help_text, labelnames, buckets):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} already registered as {fam.kind}"
                        f"{fam.labelnames}, cannot re-register as {kind}"
                        f"{tuple(labelnames)}")
                return fam
            fam = Family(name, kind, help_text, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name, help_text, labelnames=()):
        return self._get_or_create(name, "counter", help_text, labelnames,
                                   None)

    def gauge(self, name, help_text, labelnames=()):
        return self._get_or_create(name, "gauge", help_text, labelnames,
                                   None)

    def histogram(self, name, help_text, labelnames=(), buckets=()):
        return self._get_or_create(name, "histogram", help_text, labelnames,
                                   buckets)

    def snapshot(self) -> list[dict]:
        """Every family's dump, in registration order — the compact form
        workers piggyback on heartbeats and ``bench.py`` writes to
        ``HOROVOD_METRICS_SNAPSHOT``."""
        with self._lock:
            fams = list(self._families.values())
        return [f.dump() for f in fams]

    def render(self, extra_labels: Mapping[str, str] | None = None) -> str:
        """This process's families as Prometheus text."""
        return render_families([(dict(extra_labels or {}), self.snapshot())])

    def reset(self) -> None:
        with self._lock:
            fams = list(self._families.values())
        for f in fams:
            f._reset()


_registry = Registry()


def registry() -> Registry:
    return _registry


def counter(name, help_text, labelnames=()):
    return _registry.counter(name, help_text, labelnames)


def gauge(name, help_text, labelnames=()):
    return _registry.gauge(name, help_text, labelnames)


def histogram(name, help_text, labelnames=(), buckets=()):
    return _registry.histogram(name, help_text, labelnames, buckets)


# Calls that bring instruments up to date before a snapshot: an eager
# collective on the card records its latency when its CUDA events complete,
# which a snapshot must not miss (``ops/collective_ops.py``).
_collectors: list = []


def add_collector(fn) -> None:
    """Run ``fn()`` before every :func:`snapshot` and :func:`render`."""
    if fn not in _collectors:
        _collectors.append(fn)


def _collect() -> None:
    for fn in list(_collectors):
        fn()


def snapshot() -> list[dict]:
    _collect()
    return _registry.snapshot()


def render(extra_labels: Mapping[str, str] | None = None) -> str:
    _collect()
    return _registry.render(extra_labels)


def reset_for_testing() -> None:
    """Zero every instrument (and the goodput accumulators) without a
    process restart — tests and bench warmup phases call this so counters
    do not leak across phases. Instrument *definitions* survive; only the
    cells are dropped (and goodput's zero-cells re-created)."""
    _registry.reset()
    goodput().reset()
    _materialize_checkpoint_cells()


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _fmt(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _labelstr(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_families(
    groups: Iterable[tuple[Mapping[str, str], Sequence[dict]]],
) -> str:
    """Render snapshot-format families from several sources into one
    Prometheus text body.

    ``groups`` is ``[(extra_labels, families), ...]`` — the KV server
    passes one group per worker snapshot (extra labels = rank/host) plus
    one for its own driver-side gauges. Families sharing a name across
    groups emit one ``# HELP``/``# TYPE`` header (first occurrence wins)
    with every group's samples beneath it, which is exactly the
    Prometheus grouping contract.
    """
    order: list[str] = []
    merged: dict[str, dict] = {}
    for extra_labels, families in groups:
        extra = {str(k): str(v) for k, v in dict(extra_labels or {}).items()}
        for fam in families:
            name = fam["name"]
            slot = merged.get(name)
            if slot is None:
                slot = {"meta": fam, "entries": []}
                merged[name] = slot
                order.append(name)
            slot["entries"].append((extra, fam))
    lines: list[str] = []
    for name in order:
        meta = merged[name]["meta"]
        kind = meta.get("kind", "untyped")
        lines.append(f"# HELP {name} {_escape_help(meta.get('help', ''))}")
        lines.append(f"# TYPE {name} {kind}")
        for extra, fam in merged[name]["entries"]:
            for sample in fam.get("samples", ()):
                labels = {**sample.get("labels", {}), **extra}
                if kind == "histogram":
                    bounds = fam.get("buckets", ())
                    cum = 0
                    for bound, c in zip(bounds, sample["counts"]):
                        cum += c
                        blabels = {**labels, "le": _fmt(bound)}
                        lines.append(
                            f"{name}_bucket{_labelstr(blabels)} {cum}")
                    blabels = {**labels, "le": "+Inf"}
                    lines.append(
                        f"{name}_bucket{_labelstr(blabels)} "
                        f"{sample['count']}")
                    lines.append(
                        f"{name}_sum{_labelstr(labels)} "
                        f"{_fmt(sample['sum'])}")
                    lines.append(
                        f"{name}_count{_labelstr(labels)} "
                        f"{sample['count']}")
                else:
                    lines.append(
                        f"{name}{_labelstr(labels)} "
                        f"{_fmt(sample['value'])}")
    return "\n".join(lines) + "\n"


def make_family(name: str, kind: str, help_text: str,
                samples: Sequence[tuple[Mapping[str, str], float]]) -> dict:
    """Build a snapshot-format counter/gauge family from literal values —
    how the KV server exposes driver-side state (generation, heartbeat
    ages) that lives outside any registry."""
    return {
        "name": name,
        "kind": kind,
        "help": help_text,
        "samples": [{"labels": dict(l), "value": float(v)}
                    for l, v in samples],
    }


# -- strict scrape validation -----------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{(.*)\})?"                         # optional label block
    r" (-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)|[+-]Inf|NaN)"
    r"(?: ([0-9]+))?$"                       # optional timestamp
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_VALID_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def _unescape_label(v: str) -> str:
    # Single left-to-right scan — sequential global replaces misparse a
    # literal backslash followed by 'n' (r"\\n" must yield "\n"-as-two-
    # chars, not a newline).
    out: list[str] = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_labels(block: str, lineno: int) -> dict[str, str]:
    labels: dict[str, str] = {}
    pos = 0
    while pos < len(block):
        m = _LABEL_PAIR_RE.match(block, pos)
        if m is None:
            raise ValueError(
                f"line {lineno}: malformed label block at {block[pos:]!r}")
        name, val = m.group(1), m.group(2)
        if name in labels:
            raise ValueError(f"line {lineno}: duplicate label {name!r}")
        labels[name] = _unescape_label(val)
        pos = m.end()
        if pos < len(block):
            if block[pos] != ",":
                raise ValueError(
                    f"line {lineno}: expected ',' between labels, got "
                    f"{block[pos]!r}")
            pos += 1
    return labels


def validate_prometheus_text(text: str) -> dict[str, dict]:
    """Strictly validate a Prometheus text-format scrape body.

    Checks, per line: names/labels/values lex cleanly; ``# TYPE`` appears
    at most once per metric, before its samples, with a known type; every
    sample of a ``histogram``-typed metric is a ``_bucket``/``_sum``/
    ``_count`` series with cumulative, non-decreasing bucket counts and a
    ``+Inf`` bucket equal to ``_count``; no duplicate (name, labels)
    series. Raises ``ValueError`` naming the first offending line; returns
    ``{metric_name: {"type": ..., "samples": [(labels, value)]}}`` for
    assertions on top.
    """
    metrics: dict[str, dict] = {}
    seen_series: set[tuple[str, tuple]] = set()
    histograms: dict[str, dict] = {}

    def base_of(name: str) -> str | None:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                base = name[: -len(suffix)]
                if base in metrics and metrics[base]["type"] == "histogram":
                    return base
        return None

    for lineno, line in enumerate(text.split("\n"), start=1):
        if line == "":
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) != 4:
                    raise ValueError(f"line {lineno}: malformed TYPE line")
                _, _, name, mtype = parts
                if not _METRIC_NAME_RE.match(name):
                    raise ValueError(
                        f"line {lineno}: bad metric name {name!r}")
                if mtype not in _VALID_TYPES:
                    raise ValueError(
                        f"line {lineno}: unknown type {mtype!r}")
                if name in metrics:
                    raise ValueError(
                        f"line {lineno}: duplicate TYPE for {name}")
                metrics[name] = {"type": mtype, "samples": []}
                if mtype == "histogram":
                    histograms[name] = {}
            elif len(parts) >= 2 and parts[1] == "HELP":
                if len(parts) < 3 or not _METRIC_NAME_RE.match(parts[2]):
                    raise ValueError(f"line {lineno}: malformed HELP line")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample {line!r}")
        name, labelblock, rawval = m.group(1), m.group(2), m.group(3)
        labels = _parse_labels(labelblock, lineno) if labelblock else {}
        value = float(rawval.replace("Inf", "inf"))
        series_key = (name, tuple(sorted(labels.items())))
        if series_key in seen_series:
            raise ValueError(
                f"line {lineno}: duplicate series {name}{labels}")
        seen_series.add(series_key)
        base = base_of(name)
        if base is not None:
            hist = histograms[base]
            key = tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le"))
            entry = hist.setdefault(
                key, {"buckets": [], "sum": None, "count": None})
            if name.endswith("_bucket"):
                if "le" not in labels:
                    raise ValueError(
                        f"line {lineno}: histogram bucket without le label")
                entry["buckets"].append(
                    (float(labels["le"].replace("Inf", "inf")), value))
            elif name.endswith("_sum"):
                entry["sum"] = value
            else:
                entry["count"] = value
            metrics[base]["samples"].append((labels, value))
            continue
        if name in metrics and metrics[name]["type"] == "histogram":
            raise ValueError(
                f"line {lineno}: bare sample for histogram {name}")
        if name not in metrics:
            metrics[name] = {"type": "untyped", "samples": []}
        metrics[name]["samples"].append((labels, value))
    # Histogram closure checks.
    for base, series in histograms.items():
        for key, entry in series.items():
            buckets = sorted(entry["buckets"], key=lambda bv: bv[0])
            if not buckets or buckets[-1][0] != float("inf"):
                raise ValueError(
                    f"histogram {base}{dict(key)}: missing +Inf bucket")
            prev = 0.0
            for bound, cum in buckets:
                if cum < prev:
                    raise ValueError(
                        f"histogram {base}{dict(key)}: bucket counts "
                        f"not cumulative at le={bound}")
                prev = cum
            if entry["count"] is None or entry["sum"] is None:
                raise ValueError(
                    f"histogram {base}{dict(key)}: missing _sum/_count")
            if buckets[-1][1] != entry["count"]:
                raise ValueError(
                    f"histogram {base}{dict(key)}: +Inf bucket "
                    f"({buckets[-1][1]}) != _count ({entry['count']})")
    return metrics


# ---------------------------------------------------------------------------
# Core instrument set (the names docs/observability.md tabulates)
# ---------------------------------------------------------------------------

COLLECTIVE_DISPATCH = counter(
    "hvd_collective_dispatch_total",
    "Eager collective dispatches by op kind.", ("kind",))
COLLECTIVE_LATENCY = histogram(
    "hvd_collective_latency_seconds",
    "Wall time of eager collective dispatch (device_put + execute + "
    "block), by op kind.", ("kind",), LATENCY_BUCKETS_S)
COLLECTIVE_BYTES = histogram(
    "hvd_collective_payload_bytes",
    "Stacked-rank payload bytes per eager collective dispatch.",
    ("kind",), BYTE_BUCKETS)
COLLECTIVE_COMPILE = histogram(
    "hvd_collective_compile_seconds",
    "XLA build time paid on executable-cache misses, by op kind.",
    ("kind",), COMPILE_BUCKETS_S)
CACHE_EVENTS = counter(
    "hvd_executable_cache_events_total",
    "Executable-cache outcomes at eager dispatch (hit/miss).",
    ("outcome",))
GRAD_SYNC_FLUSHES = counter(
    "hvd_grad_sync_flushes_total",
    "Traced gradient-sync flushes (one per TRACE, not per step).",
    ("sync_mode",))
GRAD_SYNC_BYTES = histogram(
    "hvd_grad_sync_bytes",
    "Wire bytes per traced gradient flush (post-compression view).",
    ("sync_mode",), BYTE_BUCKETS)
GRAD_SYNC_BUCKETS = histogram(
    "hvd_grad_sync_buckets",
    "Fusion buckets per traced gradient flush.",
    ("sync_mode",), COUNT_BUCKETS)
OVERLAP_SEGMENTS = gauge(
    "hvd_overlap_segments",
    "Segments in the last overlap-scheduler leaf map.")
AUTOTUNE_TRIALS = counter(
    "hvd_autotune_trials_total",
    "Autotune sampling windows completed, by tunable axes.", ("tunable",))
AUTOTUNE_TRIAL_SECONDS = histogram(
    "hvd_autotune_trial_seconds",
    "Per-step time measured by each autotune sampling window.",
    (), COMPILE_BUCKETS_S)
STALL_TICKETS = counter(
    "hvd_stall_tickets_total",
    "Stall-inspector tickets opened (watched dispatches/steps).")
STALL_OUTSTANDING = gauge(
    "hvd_stall_outstanding",
    "Stall-inspector tickets currently outstanding.")
STALL_WARNINGS = counter(
    "hvd_stall_warnings_total",
    "Stalled operations reported past the warning threshold.")
ABORT_POSTS = counter(
    "hvd_abort_posts_total",
    "Coordinated-abort records posted by this process.")
ABORT_CONSUMES = counter(
    "hvd_abort_consumed_total",
    "Armed coordinated aborts consumed by elastic recovery.")
RETRIES = counter(
    "hvd_retries_total",
    "Control-plane retry attempts (KV requests, checkpoint writes).")
RECOVERIES = counter(
    "hvd_recoveries_total",
    "Elastic recovery attempts, by escalation-ladder rung.", ("rung",))
TRACE_SHIPS = counter(
    "hvd_trace_ships_total",
    "Sampled step-trace payloads shipped to the rendezvous KV.")
FLIGHT_DUMPS = counter(
    "hvd_flight_dumps_total",
    "Flight-recorder postmortems dumped to the lifecycle journal, by "
    "trigger.", ("reason",))
CLOCK_OFFSET = gauge(
    "hvd_clock_offset_seconds",
    "Estimated offset of this rank's wall clock vs the rendezvous "
    "server (server minus local), from heartbeat round trips.")
CLOCK_ERROR = gauge(
    "hvd_clock_offset_error_seconds",
    "Error bound (half best RTT) on the clock-offset estimate.")
CHECKPOINT_SECONDS = histogram(
    "hvd_checkpoint_seconds",
    "Checkpoint save/restore wall time, by kind (save|restore) and "
    "recovery rung (durable|peer).", ("kind", "rung"), COMPILE_BUCKETS_S)
PEER_REPLICATION_BYTES = histogram(
    "hvd_peer_replication_bytes",
    "Wire bytes per peer-replica publication (the rank's owned shard "
    "snapshot shipped on each elastic commit).", (), BYTE_BUCKETS)
PEER_REPLICATION_SECONDS = histogram(
    "hvd_peer_replication_seconds",
    "Wall time per peer-replica publication (encode + fenced KV PUT + "
    "neighbor pulls).", (), LATENCY_BUCKETS_S)
PEER_POOL_REPLICAS = gauge(
    "hvd_peer_pool_replicas",
    "Replica records currently held in this rank's in-memory peer pool.")
PARAM_GATHER_BYTES = histogram(
    "hvd_param_gather_bytes",
    "Wire bytes per traced fsdp parameter-gather program segment "
    "(post-compression view; one observation per TRACE, not per step), "
    "by mesh axis: 'batch' is the bucketed data-axis leg (the flat 1-D "
    "wire records here too), 'model' the intra-layer ICI leg of the 2-D "
    "mesh.", ("axis",), BYTE_BUCKETS)
PARAM_GATHER_SECONDS = histogram(
    "hvd_param_gather_seconds",
    "Wall time of a standalone fsdp parameter-gather program (the bench "
    "probe that prices the gather the step must hide under compute).",
    (), LATENCY_BUCKETS_S)
RESIDENT_BYTES = gauge(
    "hvd_resident_state_bytes",
    "Per-rank resident bytes of sharded training state at rest, by kind "
    "(params|opt_state) and sync_mode.", ("kind", "sync_mode"))
HBM_BYTES = gauge(
    "hvd_hbm_bytes",
    "Per-rank resident device-memory bytes by kind (params|opt_state|"
    "grads|peer_pool|executables|serving|other) — the memory "
    "observatory's live accounting (horovod_tpu/memory.py): exact "
    "nbytes noted by the call sites that materialize each kind, plus "
    "polled suppliers (replica pool, executable cache).", ("kind",))
HBM_WATERMARK = gauge(
    "hvd_hbm_watermark_bytes",
    "Peak resident bytes observed at span exits of each step phase "
    "(step|forward_backward|collective|optimizer_update|other) — the "
    "memory observatory's per-phase high-water marks, folded in by the "
    "tracing plane.", ("phase",))
HBM_HEADROOM = gauge(
    "hvd_hbm_headroom_ratio",
    "1 - resident_total/capacity, clamped to [0,1]. Capacity comes from "
    "HOROVOD_HBM_BYTES_PER_DEVICE or the backend's memory_stats "
    "bytes_limit; 0 = no capacity source known (never a guess).")
HBM_RESIDUAL = gauge(
    "hvd_hbm_model_residual_bytes",
    "Predicted minus measured resident bytes over the model kinds "
    "(params+opt_state) — the footprint model's drift alarm "
    "(memory.predict_footprint vs the live accounting).")
FSDP_PREFETCH_OVERLAP = gauge(
    "hvd_fsdp_prefetch_overlap_ratio",
    "Fraction of the fsdp parameter-gather time hidden under compute "
    "(gather time hidden / total gather time), derived from the bench "
    "phase probes and tracing spans.")
MESH_AXIS_SIZE = gauge(
    "hvd_mesh_axis_size",
    "Axis sizes of the 2-D (batch, model) training mesh the step "
    "factories compiled against (0 = flat 1-D wire, no mesh axis in "
    "play — the HOROVOD_MESH_SHAPE-unset default).", ("axis",))
# Self-healing policy plane (driver-side; the rendezvous server mirrors
# these into the /metrics scrape so they exist even before a decision —
# see runner/http/kv_server.py).
POLICY_DECISIONS = counter(
    "hvd_policy_decisions_total",
    "Self-healing policy actions taken by the elastic driver "
    "(drain|promote|preempt).", ("action",))
POLICY_SPARES = gauge(
    "hvd_policy_spare_hosts",
    "Warm spare hosts currently launched, heartbeating, and held out of "
    "the world by the elastic driver.")
POLICY_STRAGGLER_EWMA = gauge(
    "hvd_policy_straggler_ewma_seconds",
    "EWMA (over HOROVOD_STRAGGLER_WINDOW) of each host's straggler "
    "score — the sustained-evidence signal the drain decision "
    "thresholds on.", ("host",))
# Communication observatory (horovod_tpu/comms_model.py): the fitted
# α–β link cost model exported as a live roofline. Bandwidth = 1/β per
# (link class, op, algorithm); latency = α per link class; efficiency =
# EWMA of (α–β-predicted / achieved) per dispatch; residual = EWMA of
# seconds the achieved latency exceeds the prediction — the
# link-degradation signal elastic/policy.py consumes as a second
# straggler-evidence channel.
LINK_BANDWIDTH = gauge(
    "hvd_link_bandwidth_bytes_per_second",
    "Fitted link bandwidth (1/beta of the online alpha-beta cost "
    "model), by link class, collective op, and algorithm.",
    ("link_class", "op", "algorithm"))
LINK_LATENCY = gauge(
    "hvd_link_latency_seconds",
    "Fitted per-collective launch latency (alpha of the online "
    "alpha-beta cost model), by link class and collective op.",
    ("link_class", "op"))
COLLECTIVE_EFFICIENCY = gauge(
    "hvd_collective_efficiency_ratio",
    "EWMA of achieved vs alpha-beta-predicted collective latency "
    "(predicted/observed; 1.0 = on the model's roofline, <1 = "
    "underperforming it).")
COMMS_RESIDUAL = gauge(
    "hvd_comms_residual_seconds",
    "EWMA of seconds each observed collective ran SLOWER than the "
    "fitted alpha-beta prediction — a link going bad shows up here "
    "before it shows up as cross-rank skew.")
# Control-plane fault tolerance (driver crash-restart takeover; the
# rendezvous server mirrors the epoch and driver-lost counts into the
# /metrics scrape so operators see control-plane flaps before the
# 3-consecutive-203 cap blacklists a healthy host).
DRIVER_EPOCH = gauge(
    "hvd_driver_epoch",
    "Monotonic driver epoch: bumped on every driver (re)start; the "
    "split-brain fence workers and the KV server follow.")
DRIVER_LOST = counter(
    "hvd_driver_lost_total",
    "Workers reaped with EXIT_DRIVER_LOST (rendezvous KV unreachable "
    "past the deadline), by host — the control-plane flap signal.",
    ("host",))
DRIVER_TAKEOVERS = counter(
    "hvd_driver_takeovers_total",
    "Driver restarts that resumed a prior control-plane snapshot "
    "(crash-restart takeovers).")
# Silent-data-corruption defense plane (horovod_tpu/integrity.py):
# cross-rank fingerprint voting, non-finite tripwires, and storage-free
# rewind-on-spike. The divergence counter is driver-side (the voter);
# the rendezvous server additionally mirrors a zero-materialized total
# into the scrape so the instrument exists before any corruption.
INTEGRITY_CHECKS = counter(
    "hvd_integrity_checks_total",
    "State fingerprints computed by this rank for the cross-rank "
    "integrity voting plane (every HOROVOD_INTEGRITY_INTERVAL commits).")
INTEGRITY_DIVERGENCE = counter(
    "hvd_integrity_divergence_total",
    "Cross-rank integrity votes that named this host's replica state "
    "divergent (silent data corruption evidence).", ("host",))
NONFINITE_STEPS = counter(
    "hvd_nonfinite_steps_total",
    "Steps whose reduced gradients carried NaN/Inf, by the configured "
    "tripwire action (HOROVOD_NONFINITE_ACTION).", ("action",))
REWINDS = counter(
    "hvd_rewinds_total",
    "Storage-free rewinds to the last commit, by trigger reason "
    "(loss_spike).", ("reason",))
# Step-time attribution plane (horovod_tpu/attribution.py): per-step
# wall-time decomposition, exposed-communication accounting, MFU, and
# the regression sentinel. Updated on every SYNCED step by
# attribution.note_step (the tracer's step-end hook).
STEP_PHASE_SECONDS = gauge(
    "hvd_step_phase_seconds",
    "Last synced step's wall time by attribution phase "
    "(compute|exposed_comm|straggler_wait|overhead); the four phases "
    "sum to the step wall time.", ("phase",))
EXPOSED_COMM = gauge(
    "hvd_exposed_comm_seconds",
    "Collective wall time of the last synced step NOT hidden under "
    "concurrent compute spans (straggler wait included) — what the "
    "overlap scheduler and fsdp prefetch failed to hide.")
OVERLAP_HIDDEN = gauge(
    "hvd_overlap_hidden_ratio",
    "Fraction of the last synced step's collective wall time hidden "
    "under concurrent compute spans (measured by interval arithmetic, "
    "vs the bench-derived hvd_fsdp_prefetch_overlap_ratio probe).")
MFU_RATIO = gauge(
    "hvd_mfu_ratio",
    "Model FLOPs utilization of the last synced step: "
    "hvd.set_model_flops_per_step / (step wall x per-process peak "
    "FLOPs); 0 until the model declares its FLOPs.")
STEP_REGRESSION_SCORE = gauge(
    "hvd_step_regression_score",
    "Regression-sentinel drift score per attribution phase (positive "
    "excess over the EWMA baseline in deviations; alarm at "
    "HOROVOD_STEP_REGRESSION_SIGMA).", ("phase",))
# Comms planner (ops/comms_planner.py): per-bucket collective algorithm
# selection. Plans count decisions entering the plan cache; replans
# count elastic generation fences that invalidated it; dispatch counts
# planned collective emissions by (op, algorithm) — traced emissions
# count once per TRACE (the hvd_grad_sync_* contract), eager ones per
# dispatch.
PLANNER_PLANS = counter(
    "hvd_planner_plans_total",
    "Comms-planner bucket schedule decisions computed (cache misses of "
    "the per-generation plan table).")
PLANNER_REPLANS = counter(
    "hvd_planner_replans_total",
    "Comms-planner plan-table invalidations at elastic generation "
    "fences (every cached plan re-derives in the new world).")
PLANNER_DISPATCH = counter(
    "hvd_planner_dispatch_total",
    "Planned collective emissions by op and chosen algorithm (traced "
    "emissions count once per trace; eager ones per dispatch).",
    ("op", "algorithm"))

# Expert-parallel MoE wire (parallel/moe.py): per-step routing health +
# the alltoall dispatch/combine latency the planner's fits train on.
MOE_DISPATCH_BYTES = histogram(
    "hvd_moe_dispatch_bytes",
    "Per-rank dispatch-alltoall payload bytes per traced expert-parallel "
    "MoE layer (wire view: post-compression).", (), BYTE_BUCKETS)
MOE_TOKENS_DROPPED = counter(
    "hvd_moe_tokens_dropped_total",
    "Tokens dropped by capacity-factor routing (took the passthrough "
    "residual instead of their expert).")
MOE_EXPERT_LOAD = gauge(
    "hvd_moe_expert_load",
    "Tokens routed to each expert in the last observed MoE step (this "
    "rank's routing view) — the imbalance the skew attribution chases.",
    ("expert",))
ALLTOALL_LATENCY = histogram(
    "hvd_alltoall_latency_seconds",
    "Wall time of alltoall exchanges (eager dispatches and MoE "
    "dispatch/combine probes), by executed algorithm.",
    ("algorithm",), LATENCY_BUCKETS_S)
# Training-to-serving bridge (horovod_tpu/serving.py): the read-only
# serving tier's hot-swap/staleness instruments. Age is the bounded-
# staleness SLO signal (seconds since the served model's install);
# rejected publishes carry the reason the fence/verifier gave.
SERVE_MODEL_AGE = gauge(
    "hvd_serve_model_age_seconds",
    "Seconds since the currently served model was installed (the "
    "bounded-staleness SLO signal; crosses HOROVOD_SERVE_MAX_STALENESS "
    "-> serve_degraded journaled, last-good keeps serving).")
SERVE_SWAPS = counter(
    "hvd_serve_swaps_total",
    "Model hot-swaps installed by the serving tier's RCU pointer flip.")
SERVE_REJECTED = counter(
    "hvd_serve_rejected_publishes_total",
    "Model publications/installs the serving bridge rejected, by reason "
    "(fenced|corrupt|rollback|storm|dwell).", ("reason",))
SERVE_REQUESTS = counter(
    "hvd_serve_requests_total",
    "Inference requests answered by the serving tier (every request "
    "served from exactly one complete model snapshot).")
SERVE_SWAP_SECONDS = histogram(
    "hvd_serve_swap_seconds",
    "Wall time of one serving hot-swap (assemble + verify + RCU "
    "pointer flip; the request path never blocks on it).",
    (), LATENCY_BUCKETS_S)

# Materialize the zero cells (the goodput pattern): a job that never
# checkpointed or replicated still reports the series at 0, so the scrape
# gate can assert the instruments exist and dashboards can tell "never
# needed" from "not measuring".
def _materialize_checkpoint_cells() -> None:
    for kind in ("save", "restore"):
        for rung in ("durable", "peer"):
            CHECKPOINT_SECONDS.labels(kind=kind, rung=rung)
    PEER_REPLICATION_BYTES.labels()
    PEER_REPLICATION_SECONDS.labels()
    PEER_POOL_REPLICAS.labels()
    for axis in ("batch", "model"):
        PARAM_GATHER_BYTES.labels(axis=axis)
        MESH_AXIS_SIZE.labels(axis=axis)
    PARAM_GATHER_SECONDS.labels()
    FSDP_PREFETCH_OVERLAP.labels()
    for mode in ("sharded", "fsdp"):
        RESIDENT_BYTES.labels(kind="opt_state", sync_mode=mode)
    RESIDENT_BYTES.labels(kind="params", sync_mode="fsdp")
    DRIVER_EPOCH.labels()
    DRIVER_TAKEOVERS.labels()
    # Comms-observatory zero cells: a job that never fitted a model
    # still reports the roofline series at 0, so the premerge scrape
    # gate can assert the instruments exist and dashboards can tell
    # "no model yet" from "not measuring".
    for lc in ("intra_host", "inter_host"):  # the port's link classes
        LINK_LATENCY.labels(link_class=lc, op="allreduce")
        LINK_BANDWIDTH.labels(link_class=lc, op="allreduce",
                              algorithm="flat")
    COLLECTIVE_EFFICIENCY.labels()
    COMMS_RESIDUAL.labels()
    # Comms-planner zero cells: a run that never planned (knob unset)
    # still reports the series at 0 — the premerge scrape gate asserts
    # they exist, and dashboards can tell "planner off" from "not
    # measuring".
    PLANNER_PLANS.labels()
    PLANNER_REPLANS.labels()
    for op in ("allreduce", "reducescatter", "allgather", "alltoall"):
        for algo in ("flat", "rhd", "two_level"):
            PLANNER_DISPATCH.labels(op=op, algorithm=algo)
    # Expert-parallel MoE zero cells: a job that never ran an MoE layer
    # (or never dropped a token) still reports the series at 0 — the
    # premerge scrape gate asserts the instruments exist.
    MOE_DISPATCH_BYTES.labels()
    MOE_TOKENS_DROPPED.labels()
    MOE_EXPERT_LOAD.labels(expert="0")
    for algo in ("flat", "two_level"):
        ALLTOALL_LATENCY.labels(algorithm=algo)
    # Serving-bridge zero cells: a job that never published (knob unset)
    # or a serving tier that never swapped still reports the series at 0
    # — the premerge scrape gate asserts the instruments exist, and
    # dashboards can tell "no swaps yet" from "not measuring".
    SERVE_MODEL_AGE.labels()
    SERVE_SWAPS.labels()
    SERVE_REQUESTS.labels()
    SERVE_SWAP_SECONDS.labels()
    for reason in ("fenced", "corrupt", "rollback", "storm", "dwell"):
        SERVE_REJECTED.labels(reason=reason)
    # Integrity defense plane zero cells: a job that never corrupted,
    # never tripped, and never rewound still reports the series at 0 —
    # the premerge scrape gate asserts they exist, and dashboards can
    # tell "clean run" from "not measuring".
    INTEGRITY_CHECKS.labels()
    for action in ("warn", "skip", "abort"):
        NONFINITE_STEPS.labels(action=action)
    REWINDS.labels(reason="loss_spike")
    # Attribution-plane zero cells: a job that never synced a step (or
    # never declared its FLOPs) still reports the series at 0, so the
    # premerge scrape gate can assert the instruments exist and
    # dashboards can tell "no regression" from "not measuring".
    for phase in STEP_PHASES:
        STEP_PHASE_SECONDS.labels(phase=phase)
    for phase in STEP_PHASES + (PHASE_WALL,):
        STEP_REGRESSION_SCORE.labels(phase=phase)
    EXPOSED_COMM.labels()
    OVERLAP_HIDDEN.labels()
    MFU_RATIO.labels()
    # Memory-observatory zero cells: a job that never measured (or has
    # no capacity source) still reports the series at 0, so the
    # premerge scrape gate can assert the instruments exist and
    # dashboards can tell "nothing resident yet" from "not measuring".
    for kind in ("params", "opt_state", "grads", "peer_pool",
                 "executables", "serving", "other"):
        HBM_BYTES.labels(kind=kind)
    for phase in ("step", "forward_backward", "collective",
                  "optimizer_update", "other"):
        HBM_WATERMARK.labels(phase=phase)
    HBM_HEADROOM.labels()
    HBM_RESIDUAL.labels()


_materialize_checkpoint_cells()


def checkpoint_summary() -> dict:
    """Process-local checkpoint/replication ledger for
    ``profiler.summary()``: save/restore counts + total seconds per rung,
    plus the peer-replication byte/latency totals."""
    out: dict = {"rungs": {}, "replication": {}}
    for sample in CHECKPOINT_SECONDS.dump()["samples"]:
        labels = sample["labels"]
        rung = out["rungs"].setdefault(labels["rung"], {})
        rung[labels["kind"]] = {
            "count": sample["count"],
            "total_s": round(sample["sum"], 4),
        }
    by = PEER_REPLICATION_BYTES.dump()["samples"]
    sec = PEER_REPLICATION_SECONDS.dump()["samples"]
    out["replication"] = {
        "count": by[0]["count"] if by else 0,
        "bytes_total": round(by[0]["sum"]) if by else 0,
        "seconds_total": round(sec[0]["sum"], 4) if sec else 0.0,
        "pool_replicas": PEER_POOL_REPLICAS.labels().get(),
    }
    return out


def fsdp_summary() -> dict:
    """Process-local parameter-sharding ledger for
    ``profiler.summary()``: per-rank resident bytes by kind/mode, the
    traced param-gather byte/latency totals, and the bench-derived
    prefetch-overlap ratio (gather time hidden under compute / total
    gather time; 0 until a bench probe has priced the gather)."""
    resident: dict = {}
    for sample in RESIDENT_BYTES.dump()["samples"]:
        labels = sample["labels"]
        resident.setdefault(labels["sync_mode"], {})[labels["kind"]] = (
            sample["value"])
    gb = PARAM_GATHER_BYTES.dump()["samples"]
    gs = PARAM_GATHER_SECONDS.dump()["samples"]
    by_axis = {s["labels"].get("axis", ""): s for s in gb}
    return {
        "resident_bytes": resident,
        "param_gather": {
            "traces": sum(s["count"] for s in gb),
            "bytes_total": round(sum(s["sum"] for s in gb)),
            "bytes_by_axis": {a: round(s["sum"])
                              for a, s in sorted(by_axis.items())},
            "probe_seconds_total": round(gs[0]["sum"], 4) if gs else 0.0,
        },
        "prefetch_overlap_ratio": FSDP_PREFETCH_OVERLAP.labels().get(),
    }


# ---------------------------------------------------------------------------
# Goodput accounting
# ---------------------------------------------------------------------------


class GoodputTracker:
    """Productive vs. lost wall time for the elastic run loop.

    ``@hvd.elastic.run`` clocks each phase of every attempt: time inside
    the user's training function is **productive**; world formation +
    ``state.sync()`` is lost to ``rendezvous``; ``restore()`` /
    ``restore_durable()`` to ``restore``; the inter-attempt exponential
    backoff sleep to ``backoff``; and the doomed tail of a FAILED
    attempt (one ending in ``HorovodInternalError`` — its work rolls
    back and replays) — everything after its last landed commit, or the
    whole attempt when no commit landed — to ``failed_attempt``, so the
    SLO controller optimizes an honest signal. Attempts that return (or
    end in a host-update/drain interrupt at a consistent point) book
    fully productive: their tail is retained work, not a replay.

    Mirrored live into the ``hvd_goodput_*`` registry counters so the
    cluster scrape carries every rank's goodput; :meth:`summary` is the
    process-local view ``profiler.summary()`` and ``bench.py`` emit.
    """

    CAUSES = ("rendezvous", "restore", "backoff", "failed_attempt")

    def __init__(self):
        self._lock = threading.Lock()
        self._productive = 0.0
        self._lost: dict[str, float] = {}
        self._productive_counter = counter(
            "hvd_goodput_productive_seconds_total",
            "Wall seconds inside the elastic training function.")
        self._lost_counter = counter(
            "hvd_goodput_lost_seconds_total",
            "Wall seconds lost to elastic overhead, by cause.", ("cause",))
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._productive = 0.0
            self._lost = {c: 0.0 for c in self.CAUSES}
        # Materialize the zero cells so scrapes always carry the goodput
        # series (a job that never lost a second still reports 0, which
        # is the claim worth making).
        self._productive_counter.labels()
        for c in self.CAUSES:
            self._lost_counter.labels(cause=c)

    def add_productive(self, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            self._productive += seconds
        self._productive_counter.inc(seconds)

    def add_lost(self, cause: str, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            self._lost[cause] = self._lost.get(cause, 0.0) + seconds
        self._lost_counter.inc(seconds, cause=cause)

    def summary(self) -> dict:
        with self._lock:
            productive = self._productive
            lost = dict(self._lost)
        lost_total = sum(lost.values())
        total = productive + lost_total
        return {
            "productive_s": round(productive, 4),
            "lost_s": {k: round(v, 4) for k, v in lost.items()},
            "lost_total_s": round(lost_total, 4),
            "goodput_ratio": (round(productive / total, 4)
                              if total > 0 else None),
        }


_goodput: GoodputTracker | None = None
_goodput_lock = threading.Lock()


def goodput() -> GoodputTracker:
    global _goodput
    with _goodput_lock:
        if _goodput is None:
            _goodput = GoodputTracker()
        return _goodput


# ---------------------------------------------------------------------------
# Lifecycle journal (HOROVOD_EVENT_LOG)
# ---------------------------------------------------------------------------


class EventJournal:
    """Append-only JSONL journal of elastic lifecycle events.

    One record per line::

        {"event": "recovery", "generation": 3, "t_wall": ...,
         "t_mono": ..., "rung": "rendezvous", ...}

    ``t_wall`` is ``time.time()`` (cross-host correlation, survives
    restarts); ``t_mono`` is ``time.monotonic()`` (in-process ordering
    immune to NTP steps). Writes are flushed per line under a lock so a
    SIGKILL mid-run loses at most the record being written.

    **Rotation** (``HOROVOD_EVENT_LOG_MAX_BYTES``, 0 = unbounded): a
    long elastic run's journal would otherwise grow without bound. When
    the file crosses the cap after a write, it is retired to
    ``<path>.prev`` — the same one-``.prev``-slot contract as
    :func:`checkpoint.rotate_slots` / ``atomic_install``, via
    :func:`checkpoint.rotate_file` — and a fresh file opens. The
    rotation happens under the write lock between whole lines and the
    rename is atomic, so a tailing reader sees complete records only,
    never a torn one; at most two caps' worth of history exist on disk.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = open(path, "a", encoding="utf-8")

    @staticmethod
    def max_bytes() -> int:
        """Rotation cap (``HOROVOD_EVENT_LOG_MAX_BYTES``; 0 = off).
        Re-read per write so long-lived processes honor env changes."""
        try:
            return int(os.environ.get(
                "HOROVOD_EVENT_LOG_MAX_BYTES", "0") or 0)
        except ValueError:
            return 0

    def _rotate_locked(self) -> None:
        # Lazy import: checkpoint.py imports this module at its top.
        from .checkpoint import rotate_file

        self._fh.close()
        try:
            rotate_file(self.path)
        finally:
            # Reopen even when the rename failed (read-only dir): the
            # journal keeps appending rather than dying over rotation.
            self._fh = open(self.path, "a", encoding="utf-8")

    def event(self, name: str, /, generation: int | None = None,
              **fields: Any) -> None:
        # ``name`` is positional-only so ``fields`` may itself carry a
        # ``name`` key (e.g. retry_budget_exhausted labels the retried
        # operation that way) without a keyword collision.
        record = {
            "event": name,
            "generation": (default_generation()
                           if generation is None else int(generation)),
            # Multi-tenant pod: every record is stamped with the job id
            # from the env contract (HOROVOD_JOB_ID, set per job process
            # tree by the gang scheduler) — null outside a scheduled job
            # — so one merged event log from a shared pool replays in
            # causal order per job. Re-read per record like the
            # generation, never cached.
            "job": default_job(),
            "t_wall": time.time(),
            "t_mono": time.monotonic(),
        }
        record.update(fields)
        line = json.dumps(record, default=str)
        limit = self.max_bytes()
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
            if limit > 0 and self._fh.tell() >= limit:
                try:
                    self._rotate_locked()
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except OSError:
                pass


def default_generation() -> int:
    """The launcher-written world generation, or 0 outside elastic
    worlds. Journal call sites that know better (the elastic driver owns
    the authoritative version) pass ``generation=`` explicitly."""
    try:
        return int(os.environ.get("HOROVOD_WORLD_VERSION", "0") or 0)
    except ValueError:
        return 0


def default_job() -> str | None:
    """The scheduling key this process belongs to (``HOROVOD_JOB_ID``,
    set per job process tree by the multi-tenant scheduler), or None
    outside a scheduled job — the journal's ``job`` field."""
    return os.environ.get("HOROVOD_JOB_ID") or None


_journal: EventJournal | None = None
_journal_lock = threading.Lock()
_journal_failed_paths: set[str] = set()


def journal() -> EventJournal | None:
    """The process journal for the current ``HOROVOD_EVENT_LOG`` path, or
    None when unset. Re-reads the env per call (cheap) so tests and
    long-lived processes can redirect it; an unopenable path warns once
    and disables itself rather than failing training over observability."""
    global _journal
    path = os.environ.get("HOROVOD_EVENT_LOG", "")
    with _journal_lock:
        if not path:
            if _journal is not None:
                _journal.close()
                _journal = None
            return None
        if _journal is not None and _journal.path == path:
            return _journal
        if path in _journal_failed_paths:
            return None
        if _journal is not None:
            _journal.close()
            _journal = None
        try:
            _journal = EventJournal(path)
        except OSError as e:
            _journal_failed_paths.add(path)
            print(f"horovod_tpu_torch: cannot open HOROVOD_EVENT_LOG={path!r}: "
                  f"{e}; lifecycle journal disabled", file=sys.stderr)
            return None
        return _journal


def event(name: str, /, generation: int | None = None,
          **fields: Any) -> None:
    """Record one lifecycle event (no-op when ``HOROVOD_EVENT_LOG`` is
    unset). Never raises: observability must not take down training."""
    try:
        j = journal()
        if j is not None:
            j.event(name, generation=generation, **fields)
    except Exception:  # noqa: BLE001 — journaling is best-effort
        pass
