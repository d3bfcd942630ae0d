"""Cross-rank step tracing: clock-aligned spans, skew attribution, and the
flight recorder.

A copy of ``horovod_tpu/tracing.py`` for the PyTorch port: ``ClockSync``
(:92), ``StepRecord`` / ``StepTracer`` (:165, :198: the ring of the last K
steps, the per-step span cap), :class:`span` (:482), :func:`record_span`,
shipping (:func:`ship_async`, :func:`maybe_ship_heartbeat`),
:func:`dump_flight_record` (:655), :func:`compute_skew` (:736) and
:func:`straggler_summary` (:842).

1. **Span API**: :class:`span` records a host-observable phase into the
   per-rank :class:`StepTracer` and emits it on the host timeline and as a
   ``torch.profiler`` range (``timeline.activity``). ``make_train_step``
   opens a step scope per call; eager collectives record per-op spans.
2. **Clock alignment**: :class:`ClockSync` estimates this process's
   offset from the rendezvous server's clock from the heartbeat round
   trips the elastic worker already makes (the server stamps its wall
   clock into the reply).
3. **Trace shipping**: every ``HOROVOD_TRACE_SAMPLE``-th step's record is
   put (bounded, on a background thread, one attempt, 2 s) to
   ``PUT /trace/<worker>`` on the rendezvous server, whose ``GET
   /timeline`` merges all ranks on one timebase and ``GET /criticalpath``
   and ``GET /stragglers`` analyse them.
4. **Flight recorder**: the ring is dumped through the lifecycle journal
   (``flight_record``) on abort consume, stall shutdown, deadman exit,
   SIGTERM drain and an out-of-memory error at the step boundary, with the
   memory observatory's section (``memory.flight_summary``).
5. **Memory watermarks**: every span close, and each step's end, calls
   ``memory.note_phase`` (the reference's span-exit hook).

On the card a host span around a step's phase measures its launch unless
the step is synced: ``make_train_step`` syncs the compute stream at the end
of each phase of a sampled or watched step only (``StepRecord.sync``), so
an unsampled step adds no synchronization.

Knobs: ``HOROVOD_TRACE_SAMPLE`` (ship every Nth step; 0, the default,
records locally only), ``HOROVOD_TRACE_RING_STEPS`` (ring depth, default
8), ``HOROVOD_TRACE_MAX_SPANS`` (per-step cap, default 64; overflow is
counted).

Stdlib-only at import: the rendezvous server (on the driver, where torch
is never imported) imports :func:`compute_skew` from here. A trace is keyed
by the worker's name (``HOROVOD_ELASTIC_WORKER``, ``<host>:<slot>``), since
one host runs a worker per card.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import socket
import threading
import time
from typing import Any, Callable, Mapping

from . import memory
from .utils.env import get_float, get_int

#: KV scope trace payloads ship to (``PUT /trace/<host>``).
TRACE_SCOPE = "trace"


def sample_every() -> int:
    """Ship every Nth step's spans to the rendezvous KV (0 disables
    shipping; local ring recording is always on)."""
    return get_int("HOROVOD_TRACE_SAMPLE", 0)


def ring_steps() -> int:
    """Flight-recorder depth: how many recent steps the ring keeps."""
    return max(1, get_int("HOROVOD_TRACE_RING_STEPS", 8))


def max_spans_per_step() -> int:
    return max(1, get_int("HOROVOD_TRACE_MAX_SPANS", 64))


def _rank() -> str:
    return os.environ.get("HOROVOD_RANK", "0") or "0"


def _host() -> str:
    """This worker's trace key: its elastic worker name (one per card of a
    host), else the host name."""
    return (os.environ.get("HOROVOD_ELASTIC_WORKER", "")
            or os.environ.get("HOROVOD_HOSTNAME", "")
            or socket.gethostname())


# ---------------------------------------------------------------------------
# Clock alignment
# ---------------------------------------------------------------------------


class ClockSync:
    """NTP-style offset of this process's wall clock vs the rendezvous
    server's, estimated from heartbeat round trips.

    For each exchange the worker records ``t_send``/``t_recv`` on its own
    wall clock and the server stamps ``t_server`` into the reply; the
    classic bound is::

        offset = t_server - (t_send + t_recv) / 2    (server - local)
        error  = (t_recv - t_send) / 2               (half the RTT)

    The estimate is the minimum-error sample over a sliding window (the
    standard NTP minimum-RTT filter: queueing delay only ever inflates
    the RTT, so the tightest round trip is the most truthful). ``clock``
    is injectable so tests can simulate a skewed rank.
    """

    WINDOW = 16

    def __init__(self, clock: Callable[[], float] = time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: collections.deque = collections.deque(
            maxlen=self.WINDOW)

    def now(self) -> float:
        """This process's wall clock (the one spans are stamped with)."""
        return self._clock()

    def observe(self, t_send: float, t_recv: float,
                t_server: float) -> None:
        rtt = max(float(t_recv) - float(t_send), 0.0)
        sample = (rtt / 2.0,
                  float(t_server) - (float(t_send) + float(t_recv)) / 2.0)
        with self._lock:
            self._samples.append(sample)
        try:
            from . import metrics

            metrics.CLOCK_OFFSET.set(self.offset())
            err = self.error()
            if err is not None:
                metrics.CLOCK_ERROR.set(err)
        except Exception:  # noqa: BLE001 — observability is best-effort
            pass

    def _best(self):
        with self._lock:
            if not self._samples:
                return None
            return min(self._samples, key=lambda s: s[0])

    def offset(self) -> float:
        """Best estimate of (server wall clock − local wall clock), or
        0.0 before any exchange (merge degrades to raw local clocks)."""
        best = self._best()
        return best[1] if best is not None else 0.0

    def error(self) -> float | None:
        """± bound on :meth:`offset` (half the best sample's RTT), or
        None before any exchange."""
        best = self._best()
        return best[0] if best is not None else None

    def synced(self) -> bool:
        return self._best() is not None


# ---------------------------------------------------------------------------
# Step tracer + flight-recorder ring
# ---------------------------------------------------------------------------


class StepRecord:
    """One step's spans. ``synced=True`` means the step was waited for, so
    its duration is the real step time, not the launch's; ``sync`` (set by
    the step wrapper before the step runs, never shipped) asks the step's
    phases to wait for their device work; ``ship`` marks it for posting
    to the KV."""

    __slots__ = ("step", "kind", "t_start", "spans", "dropped",
                 "synced", "ship", "dur", "sync")

    def __init__(self, step: int, kind: str, t_start: float):
        self.step = step
        self.kind = kind
        self.t_start = t_start
        self.spans: list[dict] = []
        self.dropped = 0
        self.synced = False
        self.ship = False
        self.dur: float | None = None
        self.sync = False

    def as_dict(self) -> dict:
        out = {
            "step": self.step,
            "kind": self.kind,
            "t": self.t_start,
            "synced": self.synced,
            "spans": list(self.spans),
        }
        if self.dur is not None:
            out["dur"] = self.dur
        if self.dropped:
            out["dropped_spans"] = self.dropped
        return out


class StepTracer:
    """Per-process span recorder: a ring of the last K steps (the flight
    recorder) plus the currently open step and spans. Recording is cheap
    (one dict append under a lock) and always on; only shipping and the
    sampled-step sync are gated by ``HOROVOD_TRACE_SAMPLE``."""

    def __init__(self, clock_sync: ClockSync | None = None):
        self.clock = clock_sync or ClockSync()
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=ring_steps())
        self._current: StepRecord | None = None
        self._ambient: StepRecord | None = None
        self._open: dict[int, tuple[str, str, float]] = {}
        self._next_open = 0
        self._step_count = 0
        self._dispatch_seq: dict[str, int] = {}

    # -- span recording -----------------------------------------------------

    def begin_span(self, name: str, cat: str) -> int:
        """Register an in-flight span (so a wedge shows up in the flight
        record as an OPEN span with its age). Returns a token for
        :meth:`end_span`."""
        t0 = self.clock.now()
        with self._lock:
            token = self._next_open
            self._next_open += 1
            self._open[token] = (name, cat, t0)
        return token

    def end_span(self, token: int,
                 args: Mapping[str, Any] | None = None) -> None:
        now = self.clock.now()
        with self._lock:
            opened = self._open.pop(token, None)
            if opened is None:
                return
            name, cat, t0 = opened
            self._record_locked(name, cat, t0, now - t0, args)
        # The memory observatory's watermark hook: every span close folds
        # the resident total and the card's bytes in use into its phase's
        # high-water mark (cheap, never synchronizes, never raises).
        memory.note_phase(name, cat)

    def record(self, name: str, cat: str, t_start: float, dur: float,
               args: Mapping[str, Any] | None = None) -> None:
        """Record a completed span directly (bench's derived phase
        medians use this)."""
        with self._lock:
            self._record_locked(name, cat, t_start, dur, args)

    def record_dispatch(self, name: str, cat: str = "collective",
                        unique: bool = False) -> None:
        """Record a host-plane collective DISPATCH as a zero-duration
        span, suffixed with a per-name sequence number.

        The native runtime (``horovod_tpu/runtime``) calls this at every
        enqueue — the funnel all torch/TF-surface and hierarchical-leg
        collectives pass through — so eager host-plane workloads feed the
        cross-rank skew attribution, not just compiled factory steps.
        The sequence suffix makes each *instance* of a repeated name
        (``allreduce.weight`` every step) its own matched group: ranks
        run the host plane in lockstep program order, so ``name#k`` pairs
        the k-th dispatch across ranks and the skew gauges track the
        CURRENT lateness instead of the first instance ever seen. The
        counter resets with :meth:`rebase` at world join, keeping
        survivors and replacements aligned within a generation.

        ``unique=True`` marks a name that is already one-per-call
        (auto-generated ``op.N`` counters — lockstep-identical across
        ranks, so they self-match): it is recorded as-is, keeping the
        seq map bounded by the *named* collective vocabulary instead of
        growing one permanent entry per auto-named enqueue.
        """
        t0 = self.clock.now()
        with self._lock:
            if unique:
                self._record_locked(name, cat, t0, 0.0, None)
                return
            seq = self._dispatch_seq.get(name, 0) + 1
            self._dispatch_seq[name] = seq
            self._record_locked(f"{name}#{seq}", cat, t0, 0.0, None)

    def _record_locked(self, name, cat, t_start, dur, args) -> None:
        target = self._current
        if target is None:
            # Spans outside any step (eager scripting) collect into an
            # ambient pseudo-step rotated into the ring when full.
            if self._ambient is None:
                self._ambient = StepRecord(-1, "eager", t_start)
            target = self._ambient
        if len(target.spans) >= max_spans_per_step():
            target.dropped += 1
        else:
            sp = {"name": name, "cat": cat,
                  "t": round(float(t_start), 6),
                  "dur": round(float(dur), 6)}
            if args:
                sp["args"] = dict(args)
            target.spans.append(sp)
        if (target is self._ambient
                and len(target.spans) >= max_spans_per_step()):
            # Full ambient window: rotate it into the ring so eager-only
            # scripts produce bounded records too (same cap as steps).
            self._ring.append(self._ambient.as_dict())
            self._ambient = None

    # -- step scopes ----------------------------------------------------------

    def step_scope(self, kind: str = "step") -> "_StepScope":
        return _StepScope(self, kind)

    def _begin_step(self, kind: str) -> StepRecord:
        with self._lock:
            self._step_count += 1
            if self._ambient is not None and self._ambient.spans:
                self._ring.append(self._ambient.as_dict())
            self._ambient = None
            rec = StepRecord(self._step_count, kind, self.clock.now())
            self._current = rec
            return rec

    def _end_step(self, rec: StepRecord) -> None:
        rec.dur = self.clock.now() - rec.t_start
        with self._lock:
            if self._current is rec:
                self._current = None
            rec.spans.insert(0, {
                "name": rec.kind, "cat": "step",
                "t": round(rec.t_start, 6),
                "dur": round(rec.dur, 6),
                "args": {"synced": rec.synced},
            })
            self._ring.append(rec.as_dict())
        memory.note_phase(rec.kind, "step")
        if rec.synced:
            # Synced steps carry REAL wall time, so they feed the
            # attribution plane: phase decomposition, exposed-comm and
            # MFU gauges, the local regression sentinel. Un-synced
            # steps time the launch only and would report garbage.
            from . import attribution

            attribution.note_step(rec.as_dict())
        if rec.ship:
            ship_async(self.payload())

    def syncing(self) -> bool:
        """Whether the open step waits for its phases' device work."""
        with self._lock:
            return self._current is not None and self._current.sync

    def sample_due(self, step: int) -> bool:
        n = sample_every()
        return n > 0 and step % n == 0

    def steps_recorded(self) -> int:
        with self._lock:
            return self._step_count

    def rebase(self) -> None:
        """Zero the step counter (ring kept — flight history across a
        recovery is the point of the recorder). Called when a worker
        (re-)joins a world epoch: skew matching keys spans on
        (generation, step, name), and SPMD lockstep keeps counters
        rank-aligned only if every member of a generation counts from
        the same join point — a survivor at step 500 next to a
        replacement at step 1 would otherwise never match."""
        with self._lock:
            self._step_count = 0
            self._dispatch_seq.clear()

    # -- snapshots ------------------------------------------------------------

    def ring_snapshot(self) -> list[dict]:
        with self._lock:
            out = list(self._ring)
            if self._ambient is not None and self._ambient.spans:
                out.append(self._ambient.as_dict())
            return out

    def flight_snapshot(self) -> dict:
        """The flight record: the ring plus any still-open spans (a
        wedged collective shows up here with its age, which is exactly
        the postmortem question)."""
        now = self.clock.now()
        with self._lock:
            open_spans = [
                {"name": name, "cat": cat, "t": round(t0, 6),
                 "age_s": round(now - t0, 6)}
                for name, cat, t0 in self._open.values()
            ]
            current = (self._current.as_dict()
                       if self._current is not None else None)
        out = {"steps": self.ring_snapshot(), "open_spans": open_spans}
        if current is not None:
            out["current_step"] = current
        return out

    def payload(self) -> dict:
        """The wire format shipped to ``PUT /trace/<host>`` and merged by
        ``GET /timeline`` / ``GET /criticalpath``. When the model's
        FLOPs-per-step were declared (``hvd.set_model_flops_per_step``)
        they ride along so the driver's critical-path merge can report
        per-rank MFU."""
        from . import metrics

        out = {
            "rank": _rank(),
            "host": _host(),
            "generation": metrics.default_generation(),
            "clock_offset_s": round(self.clock.offset(), 6),
            "clock_error_s": self.clock.error(),
            "t_ship": self.clock.now(),
            "steps": self.ring_snapshot(),
        }
        try:
            from . import attribution

            flops, peak = attribution.model_flops()
            if flops:
                out["model_flops_per_step"] = flops
            if peak:
                out["peak_flops_per_rank"] = peak
        except Exception:  # noqa: BLE001 — attribution is advisory
            pass
        return out


class _StepScope:
    def __init__(self, tracer: StepTracer, kind: str):
        self._tracer = tracer
        self._kind = kind
        self.rec: StepRecord | None = None

    def __enter__(self) -> StepRecord:
        self.rec = self._tracer._begin_step(self._kind)
        return self.rec

    def __exit__(self, exc_type, exc, tb):
        if exc is not None and self.rec is not None:
            self.rec.spans.append({
                "name": f"error:{getattr(exc_type, '__name__', 'Exception')}",
                "cat": "error",
                "t": round(self._tracer.clock.now(), 6), "dur": 0.0,
            })
        self._tracer._end_step(self.rec)
        return False


# ---------------------------------------------------------------------------
# Singletons
# ---------------------------------------------------------------------------

# RLock: get_tracer() materializes the clock sync under the same lock.
_lock = threading.RLock()
_clock_sync: ClockSync | None = None
_tracer: StepTracer | None = None


def clock_sync() -> ClockSync:
    global _clock_sync
    with _lock:
        if _clock_sync is None:
            _clock_sync = ClockSync()
        return _clock_sync


def get_tracer() -> StepTracer:
    global _tracer
    with _lock:
        if _tracer is None:
            _tracer = StepTracer(clock_sync())
        return _tracer


def reset_for_testing() -> None:
    """Fresh tracer + clock sync (re-reads the ring/sampling env)."""
    global _tracer, _clock_sync, _last_hb_ship
    with _lock:
        _tracer = None
        _clock_sync = None
    with _ship_lock:
        _last_hb_ship = 0.0


def record_span(name: str, cat: str, t_start: float, dur: float,
                args: Mapping[str, Any] | None = None) -> None:
    get_tracer().record(name, cat, t_start, dur, args)


class span:
    """Record a host-observable phase: ``with tracing.span('forward',
    'phase'): ...``.

    Triple-emits: a span into the step tracer (ring + shipping), a
    Chrome-trace event on the per-process host timeline, and a
    ``torch.profiler.record_function`` range (NVTX too on a CUDA world),
    both through :class:`horovod_tpu_torch.timeline.activity`.
    """

    def __init__(self, name: str, cat: str = "phase",
                 args: Mapping[str, Any] | None = None):
        self.name = name
        self.cat = cat
        self.args = args
        self._token: int | None = None
        self._act = None

    def __enter__(self):
        from .timeline import activity

        self._act = activity(self.name, self.cat, self.args)
        self._act.__enter__()
        self._token = get_tracer().begin_span(self.name, self.cat)
        return self

    def __exit__(self, *exc):
        get_tracer().end_span(self._token, self.args)
        self._act.__exit__(*exc)
        return False


@contextlib.contextmanager
def phase(name: str, cat: str = "phase"):
    """A training step's phase: a :class:`span` that, on a step that waits
    for its phases (``StepRecord.sync``: a sampled or watched step), ends
    only after the work the phase queued on the current CUDA stream has
    run (``basics.sync_stream``, not a device-wide synchronize). On any
    other step it times the launch and adds no synchronization."""
    with span(name, cat):
        yield
        if get_tracer().syncing():
            from .basics import sync_stream

            sync_stream()


# ---------------------------------------------------------------------------
# Trace shipping (worker -> rendezvous KV)
# ---------------------------------------------------------------------------

_ship_lock = threading.Lock()
_ship_pending: dict | None = None
_ship_event = threading.Event()
_ship_thread: threading.Thread | None = None


def _ship_generation() -> int | None:
    """Generation stamp for trace PUTs: the elastic worker context's
    JOINED generation when one exists (the same source the heartbeat and
    abort clients fence with), else the launcher env, else None
    (static/manual launches stay unfenced)."""
    from .runner.elastic import worker as elastic_worker

    ctx = elastic_worker._context
    if ctx is not None:
        return ctx.joined_version
    from .runner.http.kv_server import env_generation

    return env_generation()


def _ship_epoch() -> int | None:
    """Driver-epoch stamp for trace PUTs: the worker context's, as its
    heartbeat stamps it (None, unfenced, before any takeover)."""
    from .runner.elastic import worker as elastic_worker

    ctx = elastic_worker._context
    if ctx is None or ctx.driver_epoch <= 0:
        return None
    return ctx.driver_epoch


def _shipper_loop() -> None:
    global _ship_pending
    from .utils.logging import get_logger

    while True:
        _ship_event.wait()
        with _ship_lock:
            payload = _ship_pending
            _ship_pending = None
            _ship_event.clear()
        if payload is None:
            continue
        try:
            # Endpoint re-read per payload: elastic re-formations (and
            # tests) can move the rendezvous server; a cached client
            # would strand every later ship on a dead port.
            addr = os.environ.get("HOROVOD_RENDEZVOUS_ADDR", "")
            port = os.environ.get("HOROVOD_RENDEZVOUS_PORT", "")
            if not addr or not port:
                continue
            from .runner.http.kv_server import KVClient

            # Same 1-attempt/2s discipline as the heartbeat client: a
            # slow ship must never back-pressure the train loop (the
            # single pending slot just drops the stale payload). Ships
            # are generation-fenced like every other worker write — a
            # zombie rank resumed from a pre-abort world must not keep
            # repopulating the trace scope the re-formed world's
            # clear_heartbeat() just purged.
            client = KVClient(addr, int(port), timeout=2.0, retries=1,
                              generation_fn=_ship_generation,
                              epoch_fn=_ship_epoch)
            client.put(TRACE_SCOPE, payload.get("host", _host()),
                       json.dumps(payload).encode())
            from . import metrics

            metrics.TRACE_SHIPS.inc()
        except Exception as e:  # noqa: BLE001 — shipping is best-effort
            get_logger().debug("trace ship failed: %s", e)


def ship_async(payload: dict) -> None:
    """Queue a trace payload for the background shipper (single pending
    slot: a new sample replaces an unsent older one — the timeline wants
    the freshest window, not a backlog)."""
    global _ship_thread, _ship_pending
    with _ship_lock:
        _ship_pending = payload
        if _ship_thread is None or not _ship_thread.is_alive():
            _ship_thread = threading.Thread(
                target=_shipper_loop, name="hvd-trace-ship", daemon=True)
            _ship_thread.start()
        _ship_event.set()


def ship_interval_s() -> float:
    """Floor between heartbeat-coupled trace ships (seconds)."""
    return get_float("HOROVOD_TRACE_SHIP_SECONDS", 5.0)


_last_hb_ship = 0.0


def maybe_ship_heartbeat() -> bool:
    """Ship the current tracer window on the heartbeat cadence.

    Step-scoped workloads ship on every sampled step; eager host-plane
    workloads (the torch/TF surfaces) have no step scope, so their spans
    would collect locally and never reach the merged timeline or the
    straggler gauges. The elastic heartbeat sender calls this after each
    successful beat: when shipping is enabled (``HOROVOD_TRACE_SAMPLE >
    0``), the ring + ambient window ships at most once per
    ``HOROVOD_TRACE_SHIP_SECONDS`` — the freshness the self-healing
    policy's skew evidence rides on. Returns True when a ship was queued.
    """
    global _last_hb_ship
    if sample_every() <= 0:
        return False
    now = time.monotonic()
    with _ship_lock:
        if now - _last_hb_ship < ship_interval_s():
            return False
        _last_hb_ship = now
    ship_async(get_tracer().payload())
    return True


# ---------------------------------------------------------------------------
# Flight recorder dump
# ---------------------------------------------------------------------------


def dump_flight_record(reason: str, generation: int | None = None,
                       **fields: Any) -> dict | None:
    """Dump the last-K-steps flight record into the lifecycle journal as
    a ``flight_record`` event. Called on abort-consume, stall shutdown,
    deadman exit, and SIGTERM drain; never raises."""
    try:
        from . import metrics

        snap = get_tracer().flight_snapshot()
        # Replica-pool state rides every dump (abort-consume included):
        # which ranks' shards this process holds, at which step and
        # generation — the first question after a peer-rung recovery.
        from . import peercheck

        pool = peercheck.pool_summary()
        if pool is not None:
            snap["peer_pool"] = pool
        # The integrity plane's state, once it engaged: the last staged
        # fingerprint and the tripwire and rewind counts.
        from . import integrity

        isum = integrity.flight_summary()
        if isum is not None:
            snap["integrity"] = isum
        # Attribution rides too: the last synced step's phase
        # decomposition (where DID the wall time go before the wedge),
        # and — for a wedged collective still open — the gating rank
        # the cluster's partial critical path names (best-effort fetch
        # from GET /criticalpath; the first postmortem question).
        from . import attribution

        asum = attribution.flight_summary(snap)
        if asum is not None:
            snap["attribution"] = asum
        # Memory rides every dump too: per-kind resident bytes, the phase
        # watermarks and the footprint model's drift.
        msum = memory.flight_summary()
        if msum is not None:
            snap["memory"] = msum
        metrics.FLIGHT_DUMPS.inc(reason=reason)
        metrics.event(
            "flight_record", generation=generation, reason=reason,
            rank=_rank(), host=_host(), **snap, **fields)
        return snap
    except Exception:  # noqa: BLE001 — postmortems are best-effort
        return None


# ---------------------------------------------------------------------------
# Skew attribution (runs on the driver, over shipped payloads)
# ---------------------------------------------------------------------------

#: Span categories matched across ranks for arrival-skew attribution:
#: eager/host collectives carry cat="collective"; compiled training's
#: cross-rank signal is the step span itself (all ranks enter step N of
#: the same program — a late entrant IS the straggler).
SKEW_CATS = ("collective", "step")


def straggler_warn_skew() -> float:
    """Arrival skew (seconds) past which the server journals a
    ``straggler_detected`` event."""
    return get_float("HOROVOD_STRAGGLER_WARN_SKEW", 1.0)


def compute_skew(payloads: Mapping[str, Mapping]) -> dict:
    """Per-collective arrival-skew attribution over shipped payloads.

    ``payloads`` maps host -> parsed trace payload. Spans are matched
    across ranks by ``(generation, step, name)`` within
    :data:`SKEW_CATS` — the generation scoping keeps a pre-recovery
    world's spans from matching the re-formed world's, and
    :meth:`StepTracer.rebase` (called at world join) keeps the step
    counters rank-aligned within a generation. For each matched instance
    seen by ≥2 ranks, a rank's *lateness* is its offset-corrected span
    start minus the earliest rank's. Returns::

        {"matched": N,
         "ranks": {rank: {"host", "mean_lateness_s", "max_lateness_s",
                          "samples"}},
         "worst": {"name", "step", "skew_s", "last_rank", "last_host"}
                  | None}

    ``worst`` names the single largest-skew instance — the last-arriver
    identity + magnitude the straggler gauges and journal events carry.
    """
    groups: dict[tuple, list[tuple[str, str, float]]] = {}
    rank_host: dict[str, str] = {}
    rank_err: dict[str, float] = {}
    for host, payload in payloads.items():
        if not isinstance(payload, Mapping):
            continue
        rank = str(payload.get("rank", "?"))
        try:
            offset = float(payload.get("clock_offset_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            offset = 0.0
        generation = payload.get("generation")
        contributed = False
        for steprec in payload.get("steps", ()) or ():
            if not isinstance(steprec, Mapping):
                continue
            step = steprec.get("step")
            for sp in steprec.get("spans", ()) or ():
                if not isinstance(sp, Mapping):
                    continue
                if sp.get("cat") not in SKEW_CATS:
                    continue
                try:
                    t = float(sp["t"]) + offset
                except (KeyError, TypeError, ValueError):
                    continue
                key = (generation, step, sp.get("name"))
                groups.setdefault(key, []).append((rank, host, t))
                contributed = True
        # Only a payload that contributed spans may claim a rank's
        # identity: a spanless payload with a stale/default rank label
        # (a worker mid-bootstrap shipping its empty ring) must not
        # steal a real rank's host attribution — the gauges and the
        # policy would then pin the measured lateness on the wrong
        # host (or drop it entirely, hiding a straggler).
        if not contributed:
            continue
        rank_host[rank] = host
        try:
            rank_err[rank] = float(payload.get("clock_error_s") or 0.0)
        except (TypeError, ValueError):
            rank_err[rank] = 0.0
    matched = 0
    lateness: dict[str, list[float]] = {}
    worst: dict | None = None
    for (generation, step, name), arrivals in groups.items():
        ranks_seen = {r for r, _, _ in arrivals}
        if len(ranks_seen) < 2:
            continue
        matched += 1
        # One arrival per rank per instance: earliest wins (re-shipped
        # windows can repeat a step).
        first: dict[str, tuple[str, float]] = {}
        for r, h, t in arrivals:
            if r not in first or t < first[r][1]:
                first[r] = (h, t)
        first_rank, (_, t_min) = min(
            first.items(), key=lambda kv: kv[1][1])
        last_rank, (last_host, t_max) = max(
            first.items(), key=lambda kv: kv[1][1])
        skew = t_max - t_min
        for r, (_, t) in first.items():
            lateness.setdefault(r, []).append(t - t_min)
        if worst is None or skew > worst["skew_s"]:
            # Combined offset-estimation error of the two clocks being
            # differenced: consumers threshold on skew − err so clock
            # uncertainty can never register as phantom straggling.
            err = (rank_err.get(last_rank, 0.0)
                   + rank_err.get(first_rank, 0.0))
            worst = {"name": name, "step": step,
                     "skew_s": round(skew, 6),
                     "err_s": round(err, 6),
                     "last_rank": last_rank, "last_host": last_host}
    ranks = {
        r: {
            "host": rank_host.get(r, ""),
            "mean_lateness_s": round(sum(ls) / len(ls), 6),
            "max_lateness_s": round(max(ls), 6),
            "samples": len(ls),
        }
        for r, ls in lateness.items()
    }
    return {"matched": matched, "ranks": ranks, "worst": worst}


def straggler_summary(fetch_cluster: bool = True) -> dict:
    """This rank's view for ``profiler.summary()["stragglers"]``: the
    local clock-offset estimate + tracer state, plus (best-effort, when a
    rendezvous KV is configured) the server-computed cluster skew from
    ``GET /stragglers``."""
    cs = clock_sync()
    out: dict = {
        "clock_offset_s": round(cs.offset(), 6),
        "clock_error_s": cs.error(),
        "clock_synced": cs.synced(),
        "steps_recorded": get_tracer().steps_recorded(),
        "trace_sample": sample_every(),
    }
    addr = os.environ.get("HOROVOD_RENDEZVOUS_ADDR", "")
    port = os.environ.get("HOROVOD_RENDEZVOUS_PORT", "")
    if fetch_cluster and addr and port:
        try:
            from urllib.request import urlopen

            with urlopen(f"http://{addr}:{port}/stragglers",
                         timeout=2.0) as r:
                out["cluster"] = json.loads(r.read())
        except Exception as e:  # noqa: BLE001 — summary is best-effort
            out["cluster_error"] = str(e)[:200]
    return out
