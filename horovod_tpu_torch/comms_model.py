"""Communication observatory: the online alpha-beta link cost model.

Port of ``horovod_tpu/comms_model.py``. Each collective is priced by the
alpha-beta model::

    t(bytes) = alpha + beta * bytes  # alpha latency, beta 1/bandwidth

fitted online per key ``(op, algorithm, link_class)``:

- **Samples** come from every timed eager collective
  (``ops/collective_ops._Dispatch``: on the card its latency between two
  CUDA events, read once the stall inspector has reaped the second, so no
  sample adds a synchronization), from an explicit **microprobe**
  (``ops.collective_ops.run_comms_microprobe``: a sweep of payload sizes
  over a process set) and from shipped trace spans whose names or args
  carry bytes (:func:`ingest_steps`).
- **Fit**: exponentially weighted least squares
  (``HOROVOD_COMMS_DECAY``) with confidence intervals from the weighted
  residual variance, gated by ``HOROVOD_COMMS_MIN_SAMPLES`` and two
  distinct payload sizes.
- **Consumers**: the gauges ``hvd_link_bandwidth_bytes_per_second``,
  ``hvd_link_latency_seconds``, ``hvd_collective_efficiency_ratio`` and
  ``hvd_comms_residual_seconds``; ``GET /comms`` on the rendezvous server
  (each rank's :meth:`CommsModel.payload` rides its heartbeat,
  :func:`merge_payloads` merges them); ``profiler.summary()["comms"]``;
  the attribution plane's predicted exposed comm
  (:func:`predict_step_comm_s`); and the autotune pruning of a comms
  planner (:func:`prune_candidates`, :meth:`CommsModel.predict_exact`).

The link classes are the port's (``topology.py``): ``intra_host`` and
``inter_host`` where the JAX package has ``ici`` and ``dcn``. The comms
planner (``ops/comms_planner.py``) reads the model's exact keys
(:meth:`CommsModel.predict_exact`, :meth:`CommsModel.fit_snapshot`);
``payload()`` carries its plan table, and :func:`_planned_wire_algorithm`
prices a bucket under the schedule it would plan. The planner is
imported only when asked, and answers off in a process that never
formed a world (the driver). :func:`predict_step_comm_s` resolves the fusion
threshold and the segment count as the port's wire uses them: one run of
buckets over all leaves in the allreduce and sharded modes (the port does
not segment them), ``HOROVOD_FSDP_SEGMENTS`` in fsdp.

Stdlib-only at import: the rendezvous server imports
:func:`merge_payloads` on the driver, where torch is never imported.
"""

from __future__ import annotations

import math
import os
import re
import socket
import threading
import time
from typing import Any, Callable, Mapping, Sequence

from . import faults
from .utils.env import get_float, get_int

#: The port's link classes (`link_class` label values; ``topology.py``).
LINK_CLASSES = ("intra_host", "inter_host")

#: The class a key is priced under when nothing names one.
DEFAULT_LINK_CLASS = "intra_host"

#: Algorithm tags (`algorithm` label values): ``flat`` (every eager
#: dispatch), ``hierarchical``, ``rs_ag`` (the sharded mode's reduce-scatter
#: and allgather halves), ``fsdp`` (the fsdp mode's per-segment halves), and
#: the reference's planner schedules ``rhd`` and ``two_level``, kept so that
#: fits and payloads read the same.
ALGORITHMS = ("flat", "hierarchical", "rs_ag", "fsdp", "rhd", "two_level")

#: Span names that carry static bucket bytes (``allreduce.bucket0.1048576B``
#: and the reference's ``moe.dispatch.4224B.two_level``); a trailing
#: ``.<algorithm>`` names the schedule, absent = flat.
_BUCKET_NAME_RE = re.compile(
    r"^(?P<op>allreduce|reducescatter|allgather"
    r"|alltoall|moe\.(?:dispatch|combine))\."
    r"(?:bucket\d+\.)?(?P<bytes>\d+)B"
    r"(?:\.(?P<algo>[a-z0-9_]+))?$")


def min_samples() -> int:
    """Samples a fit needs before it predicts / drives decisions."""
    return max(2, get_int("HOROVOD_COMMS_MIN_SAMPLES", 4))


def decay() -> float:
    """Per-sample exponential decay of the fit's sufficient statistics
    (1.0 = never forget; smaller = faster drift tracking)."""
    d = get_float("HOROVOD_COMMS_DECAY", 0.98)
    return min(max(d, 0.5), 1.0)


def residual_alpha() -> float:
    """EWMA weight for the predicted-vs-observed residual channel."""
    a = get_float("HOROVOD_COMMS_RESIDUAL_ALPHA", 0.3)
    return min(max(a, 0.01), 1.0)


def _rank() -> str:
    return os.environ.get("HOROVOD_RANK", "0") or "0"


def _host() -> str:
    return os.environ.get("HOROVOD_HOSTNAME", "") or socket.gethostname()


def key_of(op: str, algorithm: str, link_class: str) -> str:
    """The wire/JSON form of a fit key."""
    return f"{op}|{algorithm}|{link_class}"


def split_key(key: str) -> tuple[str, str, str] | None:
    parts = str(key).split("|")
    if len(parts) != 3 or not all(parts):
        return None
    return (parts[0], parts[1], parts[2])


class LinkFit:
    """One (op, algorithm, link_class) α–β fit: exponentially-weighted
    least squares of latency on bytes, with confidence intervals.

    Sufficient statistics (weight n and the weighted sums Sx, Sy, Sxx,
    Sxy, Syy) decay by ``HOROVOD_COMMS_DECAY`` per sample, so the fit is
    an EWMA over the sample stream — a degrading link re-fits within
    ~1/(1-decay) samples instead of being diluted forever.
    """

    __slots__ = ("n", "sx", "sy", "sxx", "sxy", "syy", "count", "t_last",
                 "_lock")

    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0.0
        self.sx = self.sy = self.sxx = self.sxy = self.syy = 0.0
        self.count = 0
        self.t_last = 0.0

    def observe(self, nbytes: float, seconds: float) -> None:
        x, y = float(nbytes), float(seconds)
        if not (x >= 0.0) or not (y >= 0.0) \
                or not math.isfinite(x) or not math.isfinite(y):
            return  # NaN/inf/negative: a broken clock must not poison
            # the fit (inf passes a bare >= 0 check but turns β into
            # NaN while ready() stays True — permanent poisoning)
        d = decay()
        with self._lock:
            self.n = self.n * d + 1.0
            self.sx = self.sx * d + x
            self.sy = self.sy * d + y
            self.sxx = self.sxx * d + x * x
            self.sxy = self.sxy * d + x * y
            self.syy = self.syy * d + y * y
            self.count += 1
            self.t_last = time.time()

    # -- solve ----------------------------------------------------------------

    def _solve_locked(self) -> tuple[float, float | None]:
        """(alpha, beta): beta None when the sample xs are degenerate
        (all one payload size — only a latency mean is identifiable)."""
        if self.n <= 0:
            return 0.0, None
        mean_x = self.sx / self.n
        mean_y = self.sy / self.n
        sxx_c = self.sxx - self.n * mean_x * mean_x
        sxy_c = self.sxy - self.n * mean_x * mean_y
        if sxx_c <= max(1e-12, 1e-9 * self.sxx):
            return mean_y, None
        beta = sxy_c / sxx_c
        alpha = mean_y - beta * mean_x
        return alpha, beta

    def ready(self) -> bool:
        """Min-sample gate: enough raw samples AND ≥2 distinct payload
        sizes (otherwise β is unidentifiable)."""
        with self._lock:
            if self.count < min_samples():
                return False
            _, beta = self._solve_locked()
            return beta is not None

    def predict(self, nbytes: float) -> float | None:
        """α + β·bytes (clamped ≥ 0), or the latency mean when only one
        payload size was ever seen, or None before any sample."""
        with self._lock:
            if self.n <= 0:
                return None
            alpha, beta = self._solve_locked()
            if beta is None:
                return max(alpha, 0.0)
            return max(alpha + beta * float(nbytes), 0.0)

    def solved(self) -> tuple[float, float | None]:
        """The current (alpha, beta) — beta None when only one payload
        size was ever seen (a latency mean): the entry a comms planner's
        snapshot takes."""
        with self._lock:
            return self._solve_locked()

    def as_dict(self) -> dict:
        """JSON-able fit summary (the ``/comms`` payload entry)."""
        with self._lock:
            alpha, beta = self._solve_locked()
            n_eff = self.n
            count = self.count
            out: dict[str, Any] = {
                "alpha_s": round(alpha, 9),
                "beta_s_per_byte": (round(beta, 15)
                                    if beta is not None else None),
                "bandwidth_bytes_per_second": (
                    round(1.0 / beta, 3)
                    if beta is not None and beta > 0 else None),
                "samples": count,
                "effective_samples": round(n_eff, 3),
                "t_last": self.t_last,
            }
            # Confidence intervals from the weighted residual variance:
            # s² = Syy_c·(1 − r²) / (n − 2), the standard OLS machinery
            # on decayed sums. Reported as ±95% half-widths.
            if beta is not None and n_eff > 2:
                mean_x = self.sx / n_eff
                mean_y = self.sy / n_eff
                sxx_c = self.sxx - n_eff * mean_x * mean_x
                syy_c = max(self.syy - n_eff * mean_y * mean_y, 0.0)
                ss_res = max(syy_c - beta * (self.sxy
                                             - n_eff * mean_x * mean_y), 0.0)
                s2 = ss_res / (n_eff - 2)
                se_beta = math.sqrt(s2 / sxx_c) if sxx_c > 0 else None
                se_alpha = (math.sqrt(s2 * (1.0 / n_eff
                                            + mean_x * mean_x / sxx_c))
                            if sxx_c > 0 else None)
                out["alpha_ci95_s"] = (round(1.96 * se_alpha, 9)
                                       if se_alpha is not None else None)
                out["beta_ci95"] = (round(1.96 * se_beta, 15)
                                    if se_beta is not None else None)
                out["r2"] = (round(1.0 - ss_res / syy_c, 4)
                             if syy_c > 0 else None)
        out["ready"] = self.ready()
        return out


class CommsModel:
    """The per-process observatory: fits by key, the efficiency/residual
    EWMAs, and the last-seen gradient leaf layout (the autotune
    predictor's input)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fits: dict[tuple[str, str, str], LinkFit] = {}
        self._residual_ewma = 0.0
        self._efficiency_ewma: float | None = None
        self._leaf_sizes: list[tuple[int, str]] = []
        self._probes = 0
        self._export_skip: dict[tuple[str, str, str], int] = {}
        self._ready_exported: set[tuple[str, str, str]] = set()

    # -- intake ---------------------------------------------------------------

    def observe(self, op: str, algorithm: str, link_class: str,
                nbytes: float, seconds: float) -> None:
        """Fold one measured collective into the model.

        Fires the ``comms.link`` fault point first with DELAY semantics
        folded into the observation (an armed delay inflates the
        observed latency — the deterministic slow-link injector the
        residual-channel chaos tests ride). The residual/efficiency
        EWMAs are updated against the PRE-update prediction, so a
        degradation registers before the drifting fit absorbs it.
        """
        try:
            seconds = float(seconds)
            nbytes = float(nbytes)
        except (TypeError, ValueError):
            return
        if not (seconds >= 0.0) or not (nbytes >= 0.0) \
                or not math.isfinite(seconds) or not math.isfinite(nbytes):
            return  # NaN/inf/negative: a broken clock must not poison
            # the EWMAs below (LinkFit.observe guards itself too)
        t0 = time.monotonic()  # monotonic: an NTP step between the two
        if faults.fire(faults.COMMS_LINK):  # reads must not fake a
            return  # drop semantics (sample lost)   # slow link
        fired = time.monotonic() - t0
        if fired >= 1e-3:
            # An armed delay slept here: fold it into the observation
            # (the injected slow link). Below the threshold it is just
            # clock-read noise and must not perturb exact fits.
            seconds += fired
        fit = self._fit_for(op, algorithm, link_class, create=True)
        predicted = fit.predict(nbytes) if fit.ready() else None
        fit.observe(nbytes, seconds)
        if predicted is not None and predicted >= 0.0:
            a = residual_alpha()
            resid = max(seconds - predicted, 0.0)
            eff = (predicted / seconds if seconds > 0 else 1.0)
            eff = min(max(eff, 0.0), 2.0)
            with self._lock:
                self._residual_ewma += a * (resid - self._residual_ewma)
                prev = self._efficiency_ewma
                self._efficiency_ewma = (eff if prev is None
                                         else prev + a * (eff - prev))
        self._export_gauges(op, algorithm, link_class)

    def note_probe(self) -> None:
        with self._lock:
            self._probes += 1

    def note_leaf_sizes(self, sizes: Sequence[tuple[int, str]]) -> None:
        """Remember the gradient wire's leaf layout ``[(nbytes, dtype),
        ...]`` — noted once per bucket plan, where the
        ``DistributedOptimizer`` builds its buckets and by
        ``ops.fusion.start_fused_allreduce``. The LARGEST layout seen wins
        (a grouped allreduce of a few tensors notes a subset; the whole
        model's is the layout the predictor wants)."""
        sizes = [(int(b), str(d)) for b, d in sizes if int(b) > 0]
        if not sizes:
            return
        with self._lock:
            if sum(b for b, _ in sizes) >= sum(
                    b for b, _ in self._leaf_sizes):
                self._leaf_sizes = sizes

    def leaf_sizes(self) -> list[tuple[int, str]]:
        with self._lock:
            return list(self._leaf_sizes)

    def ingest_steps(self, steps: Sequence[Mapping]) -> int:
        """Feed span records (the tracer ring / a shipped trace payload)
        whose names or args carry payload bytes — the fusion pass's
        ``<op>.bucketN.<bytes>B`` vocabulary and the eager dispatch
        spans. Malformed records are skipped. Returns samples folded."""
        folded = 0
        for steprec in steps or ():
            if not isinstance(steprec, Mapping):
                continue
            for sp in steprec.get("spans", ()) or ():
                if not isinstance(sp, Mapping):
                    continue
                if sp.get("cat") != "collective":
                    continue
                try:
                    dur = float(sp.get("dur", 0.0))
                except (TypeError, ValueError):
                    continue
                if not (dur > 0.0):  # rejects NaN too (NaN > 0 is False)
                    continue
                args = sp.get("args") or {}
                name = str(sp.get("name", ""))
                m = _BUCKET_NAME_RE.match(name.split("#")[0])
                nbytes = None
                op = None
                if isinstance(args, Mapping) and "bytes" in args:
                    try:
                        nbytes = float(args["bytes"])
                    except (TypeError, ValueError):
                        nbytes = None
                    op = str(args.get("op", "")) or None
                if nbytes is None and m is not None:
                    nbytes = float(m.group("bytes"))
                    op = m.group("op")
                    if op.startswith("moe."):
                        op = "alltoall"  # the MoE wire IS an alltoall
                if nbytes is None or op is None:
                    continue
                name_algo = (m.group("algo") or "flat") \
                    if m is not None else "flat"
                algorithm = str(args.get("algorithm", name_algo)) \
                    if isinstance(args, Mapping) else name_algo
                link = str(args.get("link_class", DEFAULT_LINK_CLASS)) \
                    if isinstance(args, Mapping) else DEFAULT_LINK_CLASS
                self.observe(op, algorithm, link, nbytes, dur)
                folded += 1
        return folded

    # -- lookup / prediction --------------------------------------------------

    def _fit_for(self, op, algorithm, link_class,
                 create: bool = False) -> LinkFit | None:
        key = (str(op), str(algorithm), str(link_class))
        with self._lock:
            fit = self._fits.get(key)
            if fit is None and create:
                fit = self._fits[key] = LinkFit()
            return fit

    def predict(self, op: str, algorithm: str, link_class: str,
                nbytes: float) -> float | None:
        """Predicted seconds for one collective, with a documented
        fallback chain when the exact key has no ready fit: same op via
        the ``flat`` algorithm on the same link class, then same op on
        any link class, then the flat allreduce fit (every wire
        degenerates to 'a collective moving N bytes' at zeroth order).
        None when nothing relevant is fitted."""
        chain = [
            (op, algorithm, link_class),
            (op, "flat", link_class),
        ]
        with self._lock:
            any_link = [k for k in self._fits if k[0] == op]
        chain.extend(any_link)
        chain.append(("allreduce", "flat", link_class))
        with self._lock:
            flat_any = [k for k in self._fits if k[0] == "allreduce"]
        chain.extend(flat_any)
        seen = set()
        for key in chain:
            if key in seen:
                continue
            seen.add(key)
            fit = self._fit_for(*key)
            if fit is not None and fit.ready():
                return fit.predict(nbytes)
        return None

    def predict_exact(self, op: str, algorithm: str, link_class: str,
                      nbytes: float) -> float | None:
        """Predicted seconds from the EXACT (op, algorithm, link_class)
        key only — no fallback chain. The comms planner prices candidate
        algorithms against each other, where the chain's cross-algorithm
        substitutions would collapse every candidate onto one fit."""
        fit = self._fit_for(op, algorithm, link_class)
        if fit is None or not fit.ready():
            return None
        return fit.predict(nbytes)

    def fit_snapshot(self, ops: Sequence[str] | None = None,
                     algorithms: Sequence[str] | None = None
                     ) -> dict[str, tuple[float, float | None]]:
        """``{key: (alpha, beta)}`` over the READY fits (optionally
        filtered by op/algorithm) — the rank-portable form the planner
        broadcasts so every rank plans from rank 0's model."""
        with self._lock:
            fits = dict(self._fits)
        out: dict[str, tuple[float, float | None]] = {}
        for (op, algorithm, link_class), fit in fits.items():
            if ops is not None and op not in ops:
                continue
            if algorithms is not None and algorithm not in algorithms:
                continue
            if not fit.ready():
                continue
            out[key_of(op, algorithm, link_class)] = fit.solved()
        return out

    def ready(self) -> bool:
        with self._lock:
            fits = list(self._fits.values())
        return any(f.ready() for f in fits)

    def residual_s(self) -> float:
        with self._lock:
            return self._residual_ewma

    def efficiency(self) -> float | None:
        with self._lock:
            return self._efficiency_ewma

    # -- export ---------------------------------------------------------------

    def _export_gauges(self, op, algorithm, link_class) -> None:
        """Mirror the model into the scrape gauges (best-effort).

        The residual/efficiency EWMAs export on EVERY observation (two
        float sets — and they are the degradation signal that must stay
        fresh); the α/β fit export (``as_dict``'s CI math) is throttled
        per key to every 8th observation — the fit moves slowly and the
        gauges hold the last value between exports anyway."""
        key = (str(op), str(algorithm), str(link_class))
        with self._lock:
            skip = self._export_skip.get(key, 0)
            self._export_skip[key] = (skip + 1) % 8
        try:
            from . import metrics

            eff = self.efficiency()
            if eff is not None:
                metrics.COLLECTIVE_EFFICIENCY.set(eff)
            metrics.COMMS_RESIDUAL.set(self.residual_s())
            fit = self._fit_for(op, algorithm, link_class)
            if fit is None or not fit.ready():
                return
            with self._lock:
                first_ready = key not in self._ready_exported
                self._ready_exported.add(key)
            if skip and not first_ready:
                return
            d = fit.as_dict()
            bw = d.get("bandwidth_bytes_per_second")
            if bw is not None:
                metrics.LINK_BANDWIDTH.set(
                    bw, link_class=link_class, op=op,
                    algorithm=algorithm)
            metrics.LINK_LATENCY.set(
                max(d.get("alpha_s") or 0.0, 0.0),
                link_class=link_class, op=op)
        except Exception:  # noqa: BLE001 — gauges are advisory
            pass

    def payload(self) -> dict:
        """The per-rank wire format piggybacked on heartbeats and merged
        by ``GET /comms``. A model with no ready fit serves an explicit
        ``insufficient_samples`` status — never an error."""
        with self._lock:
            fits = dict(self._fits)
            probes = self._probes
        fit_dicts = {key_of(*k): f.as_dict() for k, f in fits.items()}
        status = ("ok" if any(d.get("ready") for d in fit_dicts.values())
                  else "insufficient_samples")
        eff = self.efficiency()
        return {
            "rank": _rank(),
            "host": _host(),
            "t": time.time(),
            "status": status,
            "residual_s": round(self.residual_s(), 9),
            "efficiency": round(eff, 4) if eff is not None else None,
            "samples_total": sum(d["samples"] for d in fit_dicts.values()),
            "probes": probes,
            "fits": fit_dicts,
            # The comms planner's plan table, so that GET /comms shows why
            # buckets get their schedules.
            "planner": _planner_summary(),
        }

    def summary(self) -> dict:
        """``profiler.summary()["comms"]``: the fitted model, sample
        counts, and the residual/efficiency EWMAs, process-local."""
        p = self.payload()
        return {
            "status": p["status"],
            "fits": p["fits"],
            "samples_total": p["samples_total"],
            "probes": p["probes"],
            "residual_s": p["residual_s"],
            "efficiency": p["efficiency"],
            "leaf_sizes_noted": len(self.leaf_sizes()),
        }


# ---------------------------------------------------------------------------
# Singleton + module facade
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_model: CommsModel | None = None


def get_model() -> CommsModel:
    global _model
    with _lock:
        if _model is None:
            _model = CommsModel()
        return _model


def reset_for_testing() -> None:
    """Fresh model (``hvd.cache_stats()``-style reset semantics: the
    singleton is replaced, env knobs re-read on next use)."""
    global _model
    with _lock:
        _model = None


def observe(op: str, algorithm: str, link_class: str, nbytes: float,
            seconds: float) -> None:
    get_model().observe(op, algorithm, link_class, nbytes, seconds)


def summary() -> dict:
    return get_model().summary()


# ---------------------------------------------------------------------------
# Microprobe (the measure callable owns the collective)
# ---------------------------------------------------------------------------

#: Default probe payload sizes: a small/large sweep wide enough to
#: separate α (launch latency) from β (inverse bandwidth).
DEFAULT_PROBE_SIZES = (4096, 65536, 1 << 20)


def microprobe(measure: Callable[[int], float],
               op: str,
               algorithm: str = "flat",
               link_class: str = DEFAULT_LINK_CLASS,
               sizes: Sequence[int] | None = None,
               repeats: int = 3,
               model: CommsModel | None = None) -> dict:
    """Seed the model with an explicit payload sweep.

    ``measure(nbytes) -> seconds`` times ONE collective of that payload
    (the caller leaves its warm-up calls out —
    ``ops.collective_ops.run_comms_microprobe`` is the torch-side
    convenience). Each (size, repeat) sample is folded via
    :meth:`CommsModel.observe`; returns ``{size: [seconds, ...]}``.
    """
    model = model or get_model()
    sizes = list(sizes or DEFAULT_PROBE_SIZES)
    out: dict[int, list[float]] = {}
    for nbytes in sizes:
        samples = []
        for _ in range(max(1, int(repeats))):
            seconds = float(measure(int(nbytes)))
            model.observe(op, algorithm, link_class, nbytes, seconds)
            samples.append(seconds)
        out[int(nbytes)] = samples
    model.note_probe()
    return out


# ---------------------------------------------------------------------------
# Cluster merge (driver-side; the KV server's GET /comms)
# ---------------------------------------------------------------------------


def merge_payloads(payloads: Mapping[str, Mapping]) -> dict:
    """Cluster-merged view over per-rank ``payload()`` dicts (keyed by
    host, as the heartbeat scope stores them). Malformed payloads are
    skipped — one broken worker must not break the merge. A cluster
    where nothing fitted yet reports ``status: insufficient_samples``
    with whatever partial per-rank state exists (never an error)."""
    ranks: dict[str, dict] = {}
    cluster: dict[str, dict] = {}
    residuals: dict[str, float] = {}
    for host, payload in (payloads or {}).items():
        if not isinstance(payload, Mapping):
            continue
        rank = str(payload.get("rank", "?"))
        fits = payload.get("fits")
        fits = fits if isinstance(fits, Mapping) else {}
        clean_fits: dict[str, dict] = {}
        for key, d in fits.items():
            if split_key(key) is None or not isinstance(d, Mapping):
                continue
            clean_fits[str(key)] = {
                str(fk): (None if isinstance(fv, float)
                          and not math.isfinite(fv) else fv)
                for fk, fv in d.items()}  # bare NaN/Infinity would make
            # the whole /comms body unparseable to strict JSON readers
        try:
            resid = float(payload.get("residual_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            resid = 0.0
        if not (resid >= 0.0) or not math.isfinite(resid):
            resid = 0.0  # NaN/inf/negative must not poison the merge
            # (or emit NaN into the /comms JSON body)
        try:
            eff = payload.get("efficiency")
            eff = float(eff) if eff is not None else None
            if eff is not None and not math.isfinite(eff):
                eff = None
        except (TypeError, ValueError):
            eff = None
        try:
            samples_total = int(float(payload.get("samples_total", 0) or 0))
        except (TypeError, ValueError, OverflowError):
            samples_total = 0  # OverflowError: int(inf); same
            # JSON-poisoning hazard as the fields above
        hostname = str(payload.get("host", host))
        if rank in ranks:
            # Self-reported rank labels can collide (HOROVOD_RANK unset
            # defaults every worker to "0"; a departed host's lingering
            # heartbeat can share a reassigned rank). Qualify by host so
            # no worker's model is silently last-writer-wins dropped.
            rank = f"{rank}@{hostname}"
        planner = payload.get("planner")
        ranks[rank] = {
            "host": hostname,
            "status": str(payload.get("status", "insufficient_samples")),
            "residual_s": round(resid, 9),
            "efficiency": eff,
            "samples_total": samples_total,
            "fits": clean_fits,
            "planner": (dict(planner) if isinstance(planner, Mapping)
                        else {"enabled": False}),
        }
        residuals[hostname] = max(residuals.get(hostname, 0.0), resid)
        for key, d in clean_fits.items():
            if not d.get("ready"):
                continue
            try:
                alpha = float(d["alpha_s"])
                beta = d.get("beta_s_per_byte")
                beta = float(beta) if beta is not None else None
                n = float(d.get("effective_samples", d.get("samples", 1)))
            except (KeyError, TypeError, ValueError):
                continue
            if (not math.isfinite(alpha) or not math.isfinite(n)
                    or (beta is not None and not math.isfinite(beta))):
                continue  # same JSON-poisoning hazard as residual_s
            slot = cluster.setdefault(key, {
                "alpha_s": 0.0, "beta_s_per_byte": 0.0, "weight": 0.0,
                "beta_weight": 0.0, "samples": 0, "ranks": 0})
            slot["alpha_s"] += alpha * n
            slot["weight"] += n
            if beta is not None:
                slot["beta_s_per_byte"] += beta * n
                slot["beta_weight"] += n
            slot["samples"] += int(d.get("samples", 0) or 0)
            slot["ranks"] += 1
    merged_cluster: dict[str, dict] = {}
    for key, slot in cluster.items():
        w = slot["weight"]
        bw_w = slot["beta_weight"]
        alpha = slot["alpha_s"] / w if w > 0 else 0.0
        beta = (slot["beta_s_per_byte"] / bw_w) if bw_w > 0 else None
        merged_cluster[key] = {
            "alpha_s": round(alpha, 9),
            "beta_s_per_byte": (round(beta, 15)
                                if beta is not None else None),
            "bandwidth_bytes_per_second": (
                round(1.0 / beta, 3)
                if beta is not None and beta > 0 else None),
            "samples": slot["samples"],
            "ranks": slot["ranks"],
        }
    status = ("ok" if any(r["status"] == "ok" for r in ranks.values())
              else "insufficient_samples")
    return {
        "status": status,
        "ranks": ranks,
        "cluster": merged_cluster,
        "residuals": {h: round(v, 9) for h, v in residuals.items()},
    }


# ---------------------------------------------------------------------------
# Candidate cost prediction + dominance pruning (the autotune consumer)
# ---------------------------------------------------------------------------


def prune_margin() -> float:
    """Dominance margin: a candidate is pruned only when its predicted
    cost exceeds the best predicted cost by more than this FACTOR —
    conservative by default, so model error prunes only clearly
    dominated grid points, never near-ties."""
    m = get_float("HOROVOD_AUTOTUNE_PRUNE_MARGIN", 1.5)
    return max(m, 1.0)


def bucket_byte_sizes(leaf_sizes: Sequence[tuple[int, str]],
                      threshold_bytes: int) -> list[int]:
    """Total bytes per fusion bucket for a leaf layout ``[(nbytes,
    dtype)]`` under a candidate threshold — a stdlib mirror of the port's
    ``ops.fusion.bucket_leaves`` (order-preserving greedy same-dtype
    packing; threshold <= 0 means one bucket per leaf)."""
    buckets: list[int] = []
    bucket_dtype: str | None = None
    bucket_bytes = 0
    first = True
    for nbytes, dtype in leaf_sizes:
        nbytes = int(nbytes)
        if (threshold_bytes <= 0 or first or bucket_dtype != dtype
                or bucket_bytes + nbytes > threshold_bytes):
            buckets.append(nbytes)
            bucket_dtype = dtype
            bucket_bytes = nbytes
            first = False
        else:
            buckets[-1] += nbytes
            bucket_bytes += nbytes
    return buckets


def segment_byte_runs(leaf_sizes: Sequence[tuple[int, str]],
                      num_segments: int) -> list[list[tuple[int, str]]]:
    """Split a leaf layout into <= K contiguous byte-balanced runs — the
    stdlib mirror of the port's ``ops.fusion.segment_leaves``
    (byte-midpoint rule), so predicted per-segment bucketing matches what
    the fsdp wire emits."""
    k = max(1, int(num_segments))
    sizes = [int(b) for b, _ in leaf_sizes]
    total = sum(sizes)
    if not sizes:
        return []
    if total <= 0 or k == 1:
        return [list(leaf_sizes)]
    runs: list[list[tuple[int, str]]] = [[] for _ in range(k)]
    cum = 0
    for leaf, nbytes in zip(leaf_sizes, sizes):
        mid = cum + nbytes / 2.0
        runs[min(k - 1, int(mid * k / total))].append(leaf)
        cum += nbytes
    return [r for r in runs if r]


#: Which collective halves each sync mode's gradient wire issues per
#: bucket (the per-algorithm attribution the predictor prices).
_MODE_WIRE = {
    "allreduce": (("allreduce", "flat"),),
    "sharded": (("reducescatter", "rs_ag"), ("allgather", "rs_ag")),
    "fsdp": (("allgather", "fsdp"), ("reducescatter", "fsdp")),
}

#: The reference comms planner's schedule vocabulary (an autotune grid's
#: algorithm axis; ``auto`` names the un-pinned planner axis).
PLANNER_ALGORITHM_NAMES = ("flat", "rhd", "two_level", "auto")


def _planner_summary() -> dict:
    """``ops.comms_planner.summary()``; ``{"enabled": False}`` where the
    planner cannot be asked."""
    try:
        from .ops.comms_planner import summary

        return summary()
    except Exception:  # noqa: BLE001 — GET /comms must never fail on it
        return {"enabled": False}


def _planned_wire_algorithm(op: str, label: str, bucket_bytes: int,
                            algorithm: str | None) -> str:
    """The fit key a bucket's collective half is priced under: an explicit
    planner ``algorithm`` names its own key (``flat`` keeps the mode's
    label: ``flat``, ``rs_ag`` or ``fsdp``, whose fits are the flat
    schedule's samples); None or ``auto`` asks the live planner what it
    would schedule for the bucket (rank-locally: ``sync=False`` never
    enters its exchange), the mode's label when it is off or flat."""
    if algorithm is not None and algorithm != "auto":
        return label if algorithm == "flat" else algorithm
    try:
        from .ops.comms_planner import (default_world_size, enabled,
                                        planned_algorithm)

        if enabled():
            planned = planned_algorithm(op, bucket_bytes,
                                        default_world_size(), sync=False)
            if planned != "flat":
                return planned
    except Exception:  # noqa: BLE001 — the planner is advisory here
        pass
    return label


def predict_flush_cost(leaf_sizes: Sequence[tuple[int, str]],
                       threshold_bytes: int,
                       num_segments: int = 1,
                       sync_mode: str = "allreduce",
                       link_class: str = DEFAULT_LINK_CLASS,
                       model: CommsModel | None = None,
                       algorithm: str | None = None) -> float | None:
    """Predicted per-step communication seconds for one autotune
    candidate: segment the leaf layout, bucket each run under the
    candidate threshold, and price every bucket's collective halves with
    the fitted α–β model (fallback chain in :meth:`CommsModel.predict`).
    ``algorithm`` — the joint grid's planner axis — prices the halves
    under that schedule's fit keys; None/``auto`` prices the mode's own
    wire. None when the model cannot price the wire yet."""
    model = model or get_model()
    wire = _MODE_WIRE.get(str(sync_mode) or "allreduce",
                          _MODE_WIRE["allreduce"])
    total = 0.0
    for run in segment_byte_runs(leaf_sizes, num_segments):
        for bucket_bytes in bucket_byte_sizes(run, threshold_bytes):
            for op, label in wire:
                algo = _planned_wire_algorithm(op, label, bucket_bytes,
                                               algorithm)
                cost = model.predict(op, algo, link_class, bucket_bytes)
                if cost is None:
                    return None
                total += cost
    return total


def predict_step_comm_s(sync_mode: str | None = None,
                        link_class: str = DEFAULT_LINK_CLASS,
                        threshold_bytes: int | None = None,
                        num_segments: int | None = None,
                        model: CommsModel | None = None) -> float | None:
    """The fitted model's price for this process's gradient wire, the
    per-step communication roofline the attribution plane compares the
    observed exposed comm against (``profiler.summary()["attribution"]``'s
    ``exposed_comm_predicted_s`` and ``exposed_comm_residual_s``).

    Unspecified axes resolve as the port's wire does: the threshold from
    ``HOROVOD_FUSION_THRESHOLD``, the sync mode from ``HOROVOD_SYNC_MODE``,
    and the segments from the mode (one run of buckets over all leaves in
    the allreduce and sharded modes, ``HOROVOD_FSDP_SEGMENTS`` else
    ``HOROVOD_OVERLAP_SEGMENTS`` in fsdp). Env reads only, so this runs
    on the driver too. None until the model has a ready fit and a noted
    leaf layout.
    """
    model = model or get_model()
    leaf_sizes = model.leaf_sizes()
    if not leaf_sizes:
        return None
    if sync_mode is None:
        sync_mode = (os.environ.get("HOROVOD_SYNC_MODE", "")
                     .strip().lower() or "allreduce")
    if threshold_bytes is None:
        threshold_bytes = get_int("HOROVOD_FUSION_THRESHOLD",
                                  64 * 1024 * 1024)
    if num_segments is None:
        num_segments = 1
        if sync_mode == "fsdp":
            explicit = get_int("HOROVOD_FSDP_SEGMENTS", 0)
            num_segments = explicit if explicit > 0 else max(
                1, get_int("HOROVOD_OVERLAP_SEGMENTS", 4))
    return predict_flush_cost(leaf_sizes, threshold_bytes, num_segments,
                              sync_mode, link_class, model=model)


def candidate_axes(candidate) -> tuple[int, int, str, str | None]:
    """Normalize an autotune grid candidate — an int threshold or a
    ``(threshold[, segments][, sync_mode][, algorithm])`` tuple — to
    ``(threshold, segments, sync_mode, algorithm)``. String items are
    assigned by vocabulary membership: planner algorithm names
    (:data:`PLANNER_ALGORITHM_NAMES`) land on the algorithm axis,
    anything else is a sync mode; ``algorithm`` is None when the grid
    has no planner axis."""
    if isinstance(candidate, (tuple, list)):
        threshold = int(candidate[0])
        segments = 1
        sync_mode = "allreduce"
        algorithm = None
        for item in candidate[1:]:
            if isinstance(item, str):
                if item in PLANNER_ALGORITHM_NAMES:
                    algorithm = item
                else:
                    sync_mode = item
            else:
                segments = int(item)
        return threshold, segments, sync_mode, algorithm
    return int(candidate), 1, "allreduce", None


def prune_candidates(candidates: Sequence[Any],
                     leaf_sizes: Sequence[tuple[int, str]],
                     link_class: str = DEFAULT_LINK_CLASS,
                     margin: float | None = None,
                     model: CommsModel | None = None) -> dict:
    """Model-guided dominance pruning of an autotune grid.

    Pure and deterministic: the same (candidates, leaf layout, fitted
    model) always yields the same verdicts — the rank-identical
    guarantee reduces to feeding every rank the same inputs (the
    reference's autotune broadcasts rank 0's kept list).

    A candidate is kept unless its predicted cost exceeds the best
    predicted cost by more than ``margin`` (default
    ``HOROVOD_AUTOTUNE_PRUNE_MARGIN``); candidates the model cannot
    price are always kept. Dominance is judged WITHIN each sync-mode
    group only: fits for the rs_ag/fsdp halves usually resolve through
    the flat-allreduce fallback, which systematically overprices those
    wires (two halves at full bucket bytes vs one ring), so a
    cross-mode comparison could prune the truly-best mode — while
    within one mode the bias is a common factor and threshold/segment
    dominance stays sound. A group whose best prediction is <= 0 (a
    noisy fit's clamped-negative α) is left unpruned: a free-comms
    model cannot rank anything. Returns ``{"kept", "pruned", "costs"}``
    with ``costs`` aligned to ``candidates`` (None = unpriced).
    """
    model = model or get_model()
    margin = prune_margin() if margin is None else max(float(margin), 1.0)
    costs: list[float | None] = []
    modes: list[str] = []
    for cand in candidates:
        threshold, segments, sync_mode, algorithm = candidate_axes(cand)
        modes.append(sync_mode)
        costs.append(predict_flush_cost(
            leaf_sizes, threshold, segments, sync_mode, link_class,
            model=model, algorithm=algorithm))
    if not leaf_sizes:
        return {"kept": list(candidates), "pruned": [], "costs": costs}
    best_by_mode: dict[str, float] = {}
    for mode, cost in zip(modes, costs):
        if cost is not None:
            best_by_mode[mode] = min(best_by_mode.get(mode, cost), cost)
    kept, pruned = [], []
    for cand, mode, cost in zip(candidates, modes, costs):
        best = best_by_mode.get(mode)
        if (cost is not None and best is not None and best > 0.0
                and cost > best * margin):
            pruned.append(cand)
        else:
            kept.append(cand)
    if not kept:  # numerical pathology: never prune the whole grid
        return {"kept": list(candidates), "pruned": [], "costs": costs}
    return {"kept": kept, "pruned": pruned, "costs": costs}
