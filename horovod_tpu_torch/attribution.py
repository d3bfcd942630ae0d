"""Step-time attribution: where did this step's wall time go?

A copy of ``horovod_tpu/attribution.py`` for the PyTorch port (the port
imports nothing of the JAX package): the phase vocabulary
(``SPAN_*``, ``CAT_*``, ``STEP_PHASES``, ``PHASE_WALL``), the per-rank
decomposition :func:`decompose_step` (:191), the cluster merge
:func:`group_payloads` / :func:`analyze_group` / :func:`analyze_cluster`
(:268-444), the :class:`RegressionSentinel` (:452), the MFU machinery
(:554-635) and the worker-side plane (:func:`note_step` :658,
:func:`summary` :708, :func:`flight_summary` :740).

1. **Phase vocabulary**: the span names ``make_train_step``
   (``parallel/data_parallel.py``) records inside a step scope.
2. **Per-rank decomposition** (:func:`decompose_step`): interval arithmetic
   over one rank's spans splits the step's wall time into ``compute /
   exposed_comm / straggler_wait / overhead``; the four sum to the wall
   time. *exposed_comm* is collective time not hidden under compute spans.
3. **Cluster critical path** (:func:`analyze_cluster`): merges every
   rank's offset-corrected spans of a (generation, step) and names the rank
   that gated each collective barrier (its last arriver).
4. **MFU** (:func:`set_model_flops_per_step`): declare the model's FLOPs
   per step once and every synced step sets ``hvd_mfu_ratio``; the peak
   comes from :data:`CHIP_PEAK_FLOPS` by the card's name.
5. **Regression sentinel**: an EWMA baseline per phase; on the worker it
   sets ``hvd_step_regression_score{phase}``, on the rendezvous server
   (``runner/http/kv_server.py``) it journals ``step_regression``.

Differences from the JAX module: :func:`detect_peak_flops` reads the card
through torch (one card per process), and the chip table has the H100;
:func:`predicted_exposed_comm_s` prices the wire on the link class of the
world's process set (``topology.py``).

Stdlib-only at import: the rendezvous server imports this module on the
driver, where torch is never imported; torch is imported only inside
:func:`detect_peak_flops`.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Mapping, Sequence

from .utils.env import get_float, get_int

# ---------------------------------------------------------------------------
# Phase vocabulary (the one constant set bench/tracing/attribution share)
# ---------------------------------------------------------------------------

#: Canonical phase-span names recorded inside a step scope. The elastic
#: step (``parallel/data_parallel.py``) and ``bench.py``'s derived phase
#: lane both emit exactly these, so ``phase_span_medians_ms`` and the
#: attribution plane can never disagree on vocabulary.
SPAN_FORWARD_BACKWARD = "forward_backward"
SPAN_COLLECTIVE = "collective"
SPAN_OPTIMIZER_UPDATE = "optimizer_update"
PHASE_SPAN_NAMES = (SPAN_FORWARD_BACKWARD, SPAN_COLLECTIVE,
                    SPAN_OPTIMIZER_UPDATE)

#: Span categories. ``phase``-cat spans are host-observable compute
#: segments; ``collective``-cat spans are communication; the ``step``
#: span is the envelope the tracer inserts at step end.
CAT_PHASE = "phase"
CAT_COLLECTIVE = "collective"
CAT_STEP = "step"
COMPUTE_CATS = (CAT_PHASE,)
COMM_CATS = (CAT_COLLECTIVE,)

#: The wall-time decomposition every rank's step splits into. These are
#: the ``phase`` label values of ``hvd_step_phase_seconds`` and
#: ``hvd_step_regression_score`` (zero-materialized in ``metrics.py``).
PHASE_COMPUTE = "compute"
PHASE_EXPOSED_COMM = "exposed_comm"
PHASE_STRAGGLER_WAIT = "straggler_wait"
PHASE_OVERHEAD = "overhead"
STEP_PHASES = (PHASE_COMPUTE, PHASE_EXPOSED_COMM, PHASE_STRAGGLER_WAIT,
               PHASE_OVERHEAD)

#: Extra series the regression sentinel baselines alongside the phases.
PHASE_WALL = "wall"


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------


def sentinel_alpha() -> float:
    """EWMA weight of the per-phase regression baseline."""
    a = get_float("HOROVOD_STEP_REGRESSION_ALPHA", 0.2)
    return min(max(a, 0.01), 1.0)


def sentinel_sigma() -> float:
    """Drift threshold: a phase whose deviation-normalized score crosses
    this many sigmas (and whose absolute excess is non-trivial) alarms."""
    return max(get_float("HOROVOD_STEP_REGRESSION_SIGMA", 6.0), 1.0)


def sentinel_min_steps() -> int:
    """Baseline warm-up: observations before the sentinel may alarm."""
    return max(2, get_int("HOROVOD_STEP_REGRESSION_MIN_STEPS", 8))


# ---------------------------------------------------------------------------
# Interval arithmetic
# ---------------------------------------------------------------------------


def _merge(intervals: Sequence[tuple[float, float]]
           ) -> list[tuple[float, float]]:
    """Sorted union of half-open intervals."""
    out: list[tuple[float, float]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _length(merged: Sequence[tuple[float, float]]) -> float:
    return sum(e - s for s, e in merged)


def _subtract(a: Sequence[tuple[float, float]],
              b: Sequence[tuple[float, float]]
              ) -> list[tuple[float, float]]:
    """Portions of merged ``a`` not covered by merged ``b``."""
    out: list[tuple[float, float]] = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if be >= e:
                break
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


# ---------------------------------------------------------------------------
# Per-rank decomposition
# ---------------------------------------------------------------------------


def _span_interval(sp: Mapping) -> tuple[float, float, str, str] | None:
    """(start, end, name, cat) of a span record, or None if malformed."""
    try:
        t = float(sp["t"])
        dur = max(float(sp.get("dur", 0.0)), 0.0)
    except (KeyError, TypeError, ValueError):
        return None
    if t != t or dur != dur:  # NaN guard
        return None
    return (t, t + dur, str(sp.get("name", "?")), str(sp.get("cat", "")))


def decompose_step(steprec: Mapping, offset: float = 0.0) -> dict | None:
    """Decompose one rank's step record into the four wall-time phases.

    The step interval is the ENVELOPE of all recorded spans (which, for
    a real factory step, is the step span itself — it covers every inner
    span); interval arithmetic over the rank's own timeline then yields::

        compute       = |union(compute spans)|
        exposed_comm  = |union(collective spans) − union(compute spans)|
        overhead      = wall − |union(compute ∪ collective)|
        straggler_wait = 0   (carved out of exposed_comm by the cluster
                              merge, which alone knows the gating rank)

    so ``sum(phases) == wall`` exactly. ``overlap_hidden_s`` is the
    collective time that WAS hidden under concurrent compute — the
    direct measurement behind ``hvd_overlap_hidden_ratio``. Returns None
    when the record carries no usable spans. ``offset`` (the rank's
    measured clock offset) shifts the reported absolute times onto the
    server timebase; durations are offset-invariant.
    """
    if not isinstance(steprec, Mapping):
        return None
    spans = [si for sp in steprec.get("spans", ()) or ()
             if isinstance(sp, Mapping)
             and (si := _span_interval(sp)) is not None]
    if not spans:
        return None
    t0 = min(s for s, _, _, _ in spans)
    t1 = max(e for _, e, _, _ in spans)
    wall = t1 - t0
    if not (wall > 0.0):
        return None
    compute_m = _merge([(s, e) for s, e, _, c in spans
                        if c in COMPUTE_CATS])
    comm_m = _merge([(s, e) for s, e, _, c in spans if c in COMM_CATS])
    compute_s = _length(compute_m)
    comm_total = _length(comm_m)
    exposed = _length(_subtract(comm_m, compute_m))
    busy = _length(_merge(list(compute_m) + list(comm_m)))
    overhead = max(wall - busy, 0.0)
    hidden = max(comm_total - exposed, 0.0)
    collectives = [
        {"name": n, "t": round(s + offset, 6), "dur": round(e - s, 6)}
        for s, e, n, c in spans if c in COMM_CATS
    ]
    return {
        "step": steprec.get("step"),
        "kind": steprec.get("kind"),
        "synced": bool(steprec.get("synced")),
        "t_start": round(t0 + offset, 6),
        "wall_s": round(wall, 6),
        "phases": {
            PHASE_COMPUTE: round(compute_s, 6),
            PHASE_EXPOSED_COMM: round(exposed, 6),
            PHASE_STRAGGLER_WAIT: 0.0,
            PHASE_OVERHEAD: round(overhead, 6),
        },
        "comm_total_s": round(comm_total, 6),
        "overlap_hidden_s": round(hidden, 6),
        "overlap_hidden_ratio": (round(hidden / comm_total, 6)
                                 if comm_total > 0 else None),
        "collectives": collectives,
    }


# ---------------------------------------------------------------------------
# Cluster merge: (generation, step) groups + the critical path
# ---------------------------------------------------------------------------


def _gen_key(generation) -> int:
    try:
        return int(generation)
    except (TypeError, ValueError):
        return -1


def group_payloads(payloads: Mapping[str, Mapping],
                   rank: str | None = None) -> dict[tuple, dict]:
    """Group shipped trace payloads by (generation, step).

    Returns ``{(gen, step): {rank: {"host", "offset", "rec"}}}`` over
    SYNCED step records only (un-synced records time async dispatch, not
    wall time — decomposing them would report garbage phases). Matching
    keys on (generation, step) exactly like :func:`tracing.compute_skew`
    — the generation scoping keeps a pre-recovery world's steps from
    grouping with the re-formed world's, and the tracer's step-counter
    rebase at world join keeps counters rank-aligned within one.
    """
    groups: dict[tuple, dict] = {}
    for host, payload in (payloads or {}).items():
        if not isinstance(payload, Mapping):
            continue
        r = str(payload.get("rank", "?"))
        if rank is not None and r != str(rank):
            continue
        try:
            offset = float(payload.get("clock_offset_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            offset = 0.0
        gen = _gen_key(payload.get("generation"))
        extras = {}
        for key in ("model_flops_per_step", "peak_flops_per_rank"):
            try:
                v = float(payload.get(key))
                if v > 0:
                    extras[key] = v
            except (TypeError, ValueError):
                pass
        for steprec in payload.get("steps", ()) or ():
            if not isinstance(steprec, Mapping):
                continue
            if not steprec.get("synced"):
                continue
            try:
                step = int(steprec.get("step"))
            except (TypeError, ValueError):
                continue
            if step < 0:  # ambient/eager pseudo-steps never group
                continue
            members = groups.setdefault((gen, step), {})
            held = members.get(r)
            if held is not None and \
                    len(held["rec"].get("spans") or ()) >= \
                    len(steprec.get("spans") or ()):
                continue  # re-shipped window: keep the richer record
            members[r] = {"host": host, "offset": offset,
                          "rec": steprec, **extras}
    return groups


def analyze_group(members: Mapping[str, Mapping]) -> dict | None:
    """One (generation, step) group's cluster view: per-rank phase
    decomposition (with ``straggler_wait`` carved out of exposed comm)
    and the critical path through compute segments and collective
    barriers.

    The barrier model: a collective instance (matched across ranks by
    name, the tracer's ``#seq``-suffixed names included) cannot complete
    before its LAST rank arrives — that rank *gates* the barrier, and
    every earlier arriver's excess time inside the collective is
    ``straggler_wait``, not transfer. The critical path walks the
    matched barriers in arrival order, attributing each inter-barrier
    segment to the gating rank's compute.
    """
    per_rank: dict[str, dict] = {}
    arrivals: dict[str, list] = {}
    env_start = None
    env_end = None
    end_rank = None
    for r, m in sorted(members.items()):
        d = decompose_step(m.get("rec"), offset=m.get("offset", 0.0))
        if d is None:
            continue
        flops = m.get("model_flops_per_step")
        peak = m.get("peak_flops_per_rank")
        if flops and peak and d["wall_s"] > 0:
            d["mfu"] = round(flops / (d["wall_s"] * peak), 6)
        d["host"] = m.get("host", "")
        per_rank[r] = d
        if env_start is None or d["t_start"] < env_start:
            env_start = d["t_start"]
        t_end = d["t_start"] + d["wall_s"]
        if env_end is None or t_end > env_end:
            env_end = t_end
            end_rank = r
        for c in d["collectives"]:
            # Earliest instance per (rank, name): re-recorded names keep
            # their first arrival, matching compute_skew's contract.
            slot = arrivals.setdefault(c["name"], [])
            if not any(a[0] == r for a in slot):
                slot.append((r, d["host"], c["t"], c["dur"]))
    if not per_rank:
        return None
    # -- critical path -------------------------------------------------------
    instances = sorted(
        ((name, arr) for name, arr in arrivals.items()),
        key=lambda na: min(a[2] for a in na[1]))
    path: list[dict] = []
    cursor = env_start
    gating_counts: dict[str, int] = {}
    waits: dict[str, float] = {}
    for name, arr in instances:
        t_min = min(a[2] for a in arr)
        g_rank, g_host, t_enter, g_dur = max(arr, key=lambda a: a[2])
        exit_t = max(a[2] + a[3] for a in arr)
        if t_enter > cursor:
            path.append({"kind": "compute", "rank": g_rank,
                         "host": g_host,
                         "dur_s": round(t_enter - cursor, 6)})
        path.append({
            "kind": "collective", "name": name,
            "gating_rank": g_rank, "gating_host": g_host,
            "skew_s": round(t_enter - t_min, 6),
            "t_enter_s": round(t_enter - env_start, 6),
            "dur_s": round(max(exit_t - t_enter, 0.0), 6),
            "ranks": len(arr),
        })
        gating_counts[g_rank] = gating_counts.get(g_rank, 0) + 1
        for r, _, t_r, dur_r in arr:
            wait = max(min(t_enter - t_r, dur_r), 0.0)
            if wait > 0:
                waits[r] = waits.get(r, 0.0) + wait
        cursor = max(cursor, exit_t)
    if env_end is not None and env_end > cursor and end_rank is not None:
        path.append({"kind": "compute", "rank": end_rank,
                     "host": per_rank[end_rank]["host"],
                     "dur_s": round(env_end - cursor, 6)})
        cursor = env_end
    # -- straggler_wait: carved out of exposed comm, sum preserved -----------
    for r, d in per_rank.items():
        wait = min(waits.get(r, 0.0), d["phases"][PHASE_EXPOSED_COMM])
        d["phases"][PHASE_STRAGGLER_WAIT] = round(wait, 6)
        d["phases"][PHASE_EXPOSED_COMM] = round(
            d["phases"][PHASE_EXPOSED_COMM] - wait, 6)
    suspect = (max(gating_counts.items(), key=lambda kv: kv[1])[0]
               if gating_counts else None)
    return {
        "ranks": per_rank,
        "critical_path": path,
        "critical_path_s": round((cursor - env_start)
                                 if env_start is not None else 0.0, 6),
        "wall_s": round(max(d["wall_s"] for d in per_rank.values()), 6),
        "suspect_rank": suspect,
        "suspect_host": (per_rank.get(suspect, {}).get("host")
                         if suspect is not None else None),
    }


def analyze_cluster(payloads: Mapping[str, Mapping],
                    steps: int | None = None,
                    rank: str | None = None) -> dict:
    """The driver-side merge behind ``GET /criticalpath``: every
    (generation, step) group the shipped payloads cover (bounded by the
    per-rank ring depth), newest LAST. ``steps``/``rank`` are the query
    filters — last N groups, one rank's decomposition. A world with no
    synced samples yet (cold start, ``HOROVOD_TRACE_SAMPLE=0``) serves
    an explicit ``insufficient_samples`` status, never an error."""
    groups = group_payloads(payloads, rank=rank)
    keys = sorted(groups)
    if steps is not None and steps > 0:
        keys = keys[-steps:]
    out_groups = []
    for key in keys:
        analyzed = analyze_group(groups[key])
        if analyzed is None:
            continue
        analyzed["generation"] = key[0]
        analyzed["step"] = key[1]
        out_groups.append(analyzed)
    return {
        "status": "ok" if out_groups else "insufficient_samples",
        "groups": out_groups,
    }


# ---------------------------------------------------------------------------
# Regression sentinel
# ---------------------------------------------------------------------------


class RegressionSentinel:
    """EWMA baseline per phase with robust drift detection.

    For each observed series (the four phases plus ``wall``) the
    sentinel keeps an EWMA mean and an EWMA mean-absolute-deviation;
    the **score** of a new value is its positive excess over the mean,
    normalized by the deviation (floored at 5% of the mean so a
    deterministic baseline cannot manufacture infinite sigmas). A score
    crossing ``HOROVOD_STEP_REGRESSION_SIGMA`` after the
    ``HOROVOD_STEP_REGRESSION_MIN_STEPS`` warm-up **alarms** — once,
    latched until the score falls below half the threshold, so a step
    regression journals one event, not one per step. ``excess_s`` (the
    raw seconds over baseline) is the magnitude consumers get; it is
    directly comparable to the policy plane's other lateness-seconds
    evidence channels.
    """

    def __init__(self, alpha: float | None = None,
                 sigma: float | None = None,
                 min_steps: int | None = None):
        self._alpha = sentinel_alpha() if alpha is None else alpha
        self._sigma = sentinel_sigma() if sigma is None else sigma
        self._min_steps = (sentinel_min_steps() if min_steps is None
                           else min_steps)
        self._lock = threading.Lock()
        self._mean: dict[str, float] = {}
        self._dev: dict[str, float] = {}
        self._count = 0
        self._alarmed: set[str] = set()
        self._alarms_total = 0

    def observe(self, phases: Mapping[str, float],
                wall: float | None = None) -> dict:
        """Fold one step's phase seconds into the baselines. Returns
        ``{"scores", "excess_s", "alarms"}`` where ``alarms`` lists the
        phases that newly crossed the drift threshold this observation
        (empty during warm-up and while latched)."""
        values = {str(k): float(v) for k, v in phases.items()
                  if isinstance(v, (int, float)) and v == v}
        if wall is not None and wall == wall:
            values[PHASE_WALL] = float(wall)
        scores: dict[str, float] = {}
        excess: dict[str, float] = {}
        alarms: list[str] = []
        a = self._alpha
        with self._lock:
            warmed = self._count >= self._min_steps
            for phase, v in values.items():
                mean = self._mean.get(phase)
                if mean is None:
                    self._mean[phase] = v
                    self._dev[phase] = 0.0
                    scores[phase] = 0.0
                    excess[phase] = 0.0
                    continue
                dev = self._dev.get(phase, 0.0)
                if warmed:
                    floor = max(dev, 0.05 * max(mean, 0.0), 1e-6)
                    score = max(v - mean, 0.0) / floor
                    score = min(score, 1e3)
                    scores[phase] = round(score, 4)
                    excess[phase] = round(max(v - mean, 0.0), 6)
                    if score >= self._sigma:
                        if phase not in self._alarmed:
                            self._alarmed.add(phase)
                            self._alarms_total += 1
                            alarms.append(phase)
                    elif score < self._sigma / 2.0:
                        self._alarmed.discard(phase)
                else:
                    scores[phase] = 0.0
                    excess[phase] = 0.0
                # Baseline update AFTER scoring: drift registers against
                # the pre-update baseline before the EWMA absorbs it
                # (the comms residual's contract).
                self._mean[phase] = mean + a * (v - mean)
                self._dev[phase] = dev + a * (abs(v - mean) - dev)
            self._count += 1
        return {"scores": scores, "excess_s": excess, "alarms": alarms}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "steps_observed": self._count,
                "baseline_s": {p: round(v, 6)
                               for p, v in sorted(self._mean.items())},
                "deviation_s": {p: round(v, 6)
                                for p, v in sorted(self._dev.items())},
                "alarmed": sorted(self._alarmed),
                "alarms_total": self._alarms_total,
                "sigma": self._sigma,
                "min_steps": self._min_steps,
            }


# ---------------------------------------------------------------------------
# MFU machinery (bench.py's analytic-FLOPs plumbing, promoted)
# ---------------------------------------------------------------------------

#: bf16 dense peak FLOPs/s per chip by device-name substring (no
#: sparsity), first match wins: the JAX package's TPU table and the port's
#: card, the H100 SXM at 989 TFLOP/s.
CHIP_PEAK_FLOPS = {
    "h100": 989e12,
    "v6e": 918e12,
    "v6 lite": 918e12,
    "v5p": 459e12,
    "v5e": 197e12,
    "v5 lite": 197e12,
    "v4": 275e12,
}


def peak_flops_for_kind(device_kind: str) -> float | None:
    """Peak bf16 FLOPs/s for a device-kind string, or None when the
    kind is unknown (CPU meshes, future chips)."""
    kind = str(device_kind or "").lower()
    for key, peak in CHIP_PEAK_FLOPS.items():
        if key in kind:
            return peak
    return None


def detect_peak_flops() -> float | None:
    """This process's peak FLOPs/s: the peak of the card it drives, by
    ``torch.cuda.get_device_name()``; None where no card is visible (the
    CPU, and the driver, which never imports torch) or the name is not in
    :data:`CHIP_PEAK_FLOPS`. One process drives one card, so the peak is
    one card's, whatever ``torch.cuda.device_count()`` sees on the host."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        return None
    return peak_flops_for_kind(
        torch.cuda.get_device_name(torch.cuda.current_device()))


# ---------------------------------------------------------------------------
# Worker-side state: model FLOPs, the local sentinel, the last step
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_model_flops: float | None = None
_peak_flops: float | None = None
_peak_probed = False
_sentinel: RegressionSentinel | None = None
_last_step: dict | None = None


def set_model_flops_per_step(flops: float | None,
                             peak_flops: float | None = None) -> None:
    """Declare the model's analytic FLOPs per training step for THIS
    process's devices — the MFU numerator (``hvd_mfu_ratio`` =
    flops / (step wall × peak)). ``peak_flops`` overrides the detected
    per-process aggregate peak (:func:`detect_peak_flops`); pass it on
    backends the chip table doesn't know. ``None`` clears the setting
    (the gauge stops updating)."""
    global _model_flops, _peak_flops, _peak_probed
    with _lock:
        _model_flops = float(flops) if flops else None
        if peak_flops is not None:
            _peak_flops = float(peak_flops) if peak_flops > 0 else None
            _peak_probed = True
        elif flops is None:
            _peak_flops = None
            _peak_probed = False


def model_flops() -> tuple[float | None, float | None]:
    """(flops_per_step, peak_flops_per_process), detecting the peak on
    first use when it was not passed explicitly."""
    global _peak_flops, _peak_probed
    with _lock:
        flops = _model_flops
        peak = _peak_flops
        probed = _peak_probed
    if flops is not None and peak is None and not probed:
        peak = detect_peak_flops()
        with _lock:
            _peak_flops = peak
            _peak_probed = True
    return flops, peak


def local_sentinel() -> RegressionSentinel:
    global _sentinel
    with _lock:
        if _sentinel is None:
            _sentinel = RegressionSentinel()
        return _sentinel


def reset_for_testing() -> None:
    """Fresh worker-side state (model FLOPs kept out too; env knobs
    re-read on next use)."""
    global _model_flops, _peak_flops, _peak_probed, _sentinel, _last_step
    with _lock:
        _model_flops = None
        _peak_flops = None
        _peak_probed = False
        _sentinel = None
        _last_step = None


def note_step(steprec: Mapping) -> dict | None:
    """Fold one completed SYNCED step into the worker-side attribution
    plane: decompose it, export the scrape gauges, feed the local
    regression sentinel. Called by :meth:`tracing.StepTracer._end_step`
    on every synced step; cheap (interval math over ≤64 spans) and never
    raises past its caller's guard."""
    global _last_step
    d = decompose_step(steprec)
    if d is None:
        return None
    flops, peak = model_flops()
    if flops and peak and d["wall_s"] > 0:
        d["mfu"] = round(flops / (d["wall_s"] * peak), 6)
    verdict = local_sentinel().observe(d["phases"], wall=d["wall_s"])
    d["regression_scores"] = verdict["scores"]
    with _lock:
        _last_step = d
    try:
        from . import metrics

        for phase in STEP_PHASES:
            metrics.STEP_PHASE_SECONDS.set(
                d["phases"].get(phase, 0.0), phase=phase)
        metrics.EXPOSED_COMM.set(d["phases"][PHASE_EXPOSED_COMM]
                                 + d["phases"][PHASE_STRAGGLER_WAIT])
        ratio = d.get("overlap_hidden_ratio")
        if ratio is not None:
            metrics.OVERLAP_HIDDEN.set(ratio)
        if d.get("mfu") is not None:
            metrics.MFU_RATIO.set(d["mfu"])
        for phase, score in verdict["scores"].items():
            metrics.STEP_REGRESSION_SCORE.set(score, phase=phase)
    except Exception:  # noqa: BLE001 — gauges are advisory
        pass
    return d


def predicted_exposed_comm_s() -> float | None:
    """The alpha-beta model's price for this process's gradient wire under
    the live fusion configuration (:func:`comms_model.predict_step_comm_s`),
    on the link class of the world's process set: the roofline the
    observed exposed comm is compared against. None until the model has a
    ready fit and a noted leaf layout."""
    try:
        import sys

        from . import comms_model

        # The world's topology, where this process formed one (never
        # imports torch: on the driver there is no world).
        basics = sys.modules.get(f"{__package__}.basics")
        topo = getattr(getattr(basics, "_state", None), "topology", None)
        link = (topo.set_link_class(range(topo.size)) if topo is not None
                else comms_model.DEFAULT_LINK_CLASS)
        return comms_model.predict_step_comm_s(link_class=link)
    except Exception:  # noqa: BLE001 — prediction is advisory
        return None


def summary() -> dict:
    """``profiler.summary()["attribution"]``: the last synced step's
    decomposition + MFU, the predicted-vs-observed exposed-comm residual
    (the roofline's phase-resolved channel), the model-FLOPs setting,
    and the local sentinel state."""
    with _lock:
        last = dict(_last_step) if _last_step is not None else None
    flops, peak = (_model_flops, _peak_flops)
    out: dict[str, Any] = {
        "last_step": last,
        "model_flops_per_step": flops,
        "peak_flops_per_rank": peak,
        "sentinel": local_sentinel().snapshot(),
    }
    predicted = predicted_exposed_comm_s()
    out["exposed_comm_predicted_s"] = (round(predicted, 6)
                                       if predicted is not None else None)
    if predicted is not None and last is not None:
        observed = (last["phases"][PHASE_EXPOSED_COMM]
                    + last["phases"][PHASE_STRAGGLER_WAIT])
        out["exposed_comm_residual_s"] = round(observed - predicted, 6)
    else:
        out["exposed_comm_residual_s"] = None
    return out


def rendezvous_endpoint() -> tuple[str, str] | None:
    addr = os.environ.get("HOROVOD_RENDEZVOUS_ADDR", "")
    port = os.environ.get("HOROVOD_RENDEZVOUS_PORT", "")
    return (addr, port) if addr and port else None


def flight_summary(snap: Mapping) -> dict | None:
    """The attribution section a ``flight_record`` dump attaches: the
    last SYNCED step's phase decomposition from the ring, plus — for
    every still-OPEN collective span (the wedge) — the gating rank the
    cluster's partial critical path names, fetched best-effort from
    ``GET /criticalpath`` (a wedged rank can still read; 2s budget).
    Returns None when the ring holds nothing attributable."""
    out: dict[str, Any] = {}
    last = None
    for steprec in reversed(list(snap.get("steps", ()) or ())):
        if isinstance(steprec, Mapping) and steprec.get("synced"):
            last = decompose_step(steprec)
            if last is not None:
                break
    if last is not None:
        last.pop("collectives", None)
        out["last_synced_step"] = last
    wedged = [sp for sp in snap.get("open_spans", ()) or ()
              if isinstance(sp, Mapping)
              and sp.get("cat") in COMM_CATS]
    if wedged:
        gating: dict | None = None
        endpoint = rendezvous_endpoint()
        if endpoint is not None:
            try:
                import json
                from urllib.request import urlopen

                addr, port = endpoint
                with urlopen(f"http://{addr}:{port}/criticalpath",
                             timeout=2.0) as r:
                    cluster = json.loads(r.read())
                gating = {
                    node["name"]: {"rank": node.get("gating_rank"),
                                   "host": node.get("gating_host"),
                                   "skew_s": node.get("skew_s")}
                    for g in cluster.get("groups", ())
                    for node in g.get("critical_path", ())
                    if node.get("kind") == "collective"
                }
            except Exception:  # noqa: BLE001 — the dump must still land
                gating = None
        out["wedged_collectives"] = [
            {
                "name": sp.get("name"),
                "age_s": sp.get("age_s"),
                **({"gating": gating[str(sp.get("name"))]}
                   if gating and str(sp.get("name")) in gating else {}),
            }
            for sp in wedged
        ]
    return out or None
