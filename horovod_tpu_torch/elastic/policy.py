"""The goodput-driven self-healing policy: the controller that acts on the
elastic plane's sensors.

A copy of ``horovod_tpu/elastic/policy.py`` (``target_goodput``,
``PolicyDecision``, ``PolicyController`` with ``export_state`` and
``restore_state`` for the driver's takeover), with the same knobs,
journal events and metric families. The multi-job ``JobArbiter`` is not
here: its one consumer, the pool scheduler, is not ported. The elastic
driver (``runner/elastic/driver.py``) consults the controller from its
monitor loop. It

1. detects **persistent** stragglers from sustained evidence: an EWMA
   (over ``HOROVOD_STRAGGLER_WINDOW`` seconds) of each host's straggler
   score (mean arrival lateness behind the earliest rank, from
   ``tracing.compute_skew``), optionally heartbeat-age drift, the comms
   model's predicted-against-observed residual
   (``HOROVOD_POLICY_COMMS_RESIDUAL``) and the attribution sentinel's
   step regression (``HOROVOD_POLICY_STEP_REGRESSION``), never a single
   spike; the integrity vote's strikes are a channel of their own;
2. gates every **voluntary** resize on ``HOROVOD_TARGET_GOODPUT``: a drain
   fires only when the measured loss drags the projected goodput below
   the target AND the predicted gain over ``HOROVOD_POLICY_HORIZON``
   exceeds the measured cost of a re-rendezvous (an EWMA of the driver's
   own reconfiguration times);
3. journals each decision (``policy_decision``) with the evidence that
   triggered it and the **predicted and realized** goodput, realized
   against the no-action counterfactual (the world's commit rate before
   the drain) over ``HOROVOD_POLICY_REALIZE_WINDOW`` seconds after it.

The controller only deliberates: it never signals, launches or publishes.
The driver owns the actuators (the SIGTERM drain through the final-commit
path, the warm spare's promotion at the next generation) and reports back
what it did (:meth:`record_drain`, :meth:`note_resize_cost`,
:meth:`note_rate`).

Inert by default: with ``HOROVOD_TARGET_GOODPUT`` unset and no integrity
strike the controller decides nothing and the driver gathers no evidence.
Standard library only: the elastic driver imports it and no torch.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Any, Mapping, Sequence

from .. import faults
from .. import metrics as _metrics
from ..utils.env import get_float


def target_goodput() -> float | None:
    """The SLO knob: ``HOROVOD_TARGET_GOODPUT`` (a ratio in (0, 1]), or
    None when unset/empty — the policy plane is then inert."""
    raw = os.environ.get("HOROVOD_TARGET_GOODPUT", "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if 0.0 < v <= 1.0 else None


@dataclasses.dataclass
class PolicyDecision:
    """One drain decision: who, why, and what the model predicts."""

    action: str                     # "drain" | "preempt"
    host: str
    reason: str
    evidence: dict                  # skew instance + EWMAs + hb ages
    predicted: dict                 # gain model inputs + predicted delta
    t_decided: float = 0.0          # controller clock (monotonic)
    generation: int | None = None
    pre_rate: float | None = None   # no-action counterfactual (commits/s)
    t_acted: float | None = None


class PolicyController:
    """Deliberation for the elastic driver's self-healing loop.

    All inputs arrive through ``note_*``/``observe``; :meth:`decide`
    returns at most one :class:`PolicyDecision` per call, throttled by
    its own cooldown and the realization window (one experiment at a
    time — a second drain before the first one's realized goodput is
    measured would corrupt the counterfactual).
    """

    def __init__(self, min_np: int = 1,
                 clock=time.monotonic):
        self._clock = clock
        self._min_np = min_np
        self.target = target_goodput()
        self.window_s = get_float("HOROVOD_STRAGGLER_WINDOW", 30.0)
        self.drain_skew_s = get_float("HOROVOD_POLICY_DRAIN_SKEW", 1.0)
        # Heartbeat-age drift channel: EWMA heartbeat age past this many
        # seconds is straggler evidence too (a degrading host beats late
        # before it stops beating). 0 disables the channel.
        self.hb_drift_s = get_float("HOROVOD_POLICY_HB_DRIFT", 0.0)
        # Comms-residual channel: a host whose collectives run this many
        # seconds slower than its own fitted alpha-beta model predicts
        # (hvd_comms_residual_seconds, shipped on heartbeats and merged
        # by GET /comms) is straggler evidence too — a link going bad
        # shows up as a residual before it shows up as cross-rank skew.
        # 0 disables the channel.
        self.comms_residual_s = get_float(
            "HOROVOD_POLICY_COMMS_RESIDUAL", 0.0)
        # Step-regression channel: the attribution plane's sentinel
        # (kv_server regression_suspects) names the critical-path
        # gating host of a drifting step phase with its excess seconds
        # over the EWMA baseline — lateness the collectives feel every
        # step, directly comparable to the skew score. A host whose
        # sustained excess crosses this many seconds is straggler
        # evidence. 0 disables the channel (advisory-only sentinel).
        self.step_regression_s = get_float(
            "HOROVOD_POLICY_STEP_REGRESSION", 0.0)
        # Integrity-strikes channel (the fourth evidence source): a host
        # the cross-rank voting plane has named divergent this many
        # times is condemned outright — and, uniquely, BYPASSES the SLO
        # gate when drained (corruption is a correctness problem; no
        # goodput arithmetic makes keeping a corrupting host worthwhile).
        # 0 disables the channel (the driver's direct
        # HOROVOD_INTEGRITY_ACTION=drain path is then the only actuator).
        self.integrity_strikes = int(get_float(
            "HOROVOD_POLICY_INTEGRITY_STRIKES", 0.0))
        self.interval_s = get_float("HOROVOD_POLICY_INTERVAL", 5.0)
        self.horizon_s = get_float("HOROVOD_POLICY_HORIZON", 600.0)
        self.realize_window_s = get_float(
            "HOROVOD_POLICY_REALIZE_WINDOW", 60.0)
        self.cooldown_s = get_float(
            "HOROVOD_POLICY_COOLDOWN",
            max(self.window_s, self.realize_window_s))
        # Seed for the resize-cost estimate until the driver has measured
        # one reconfiguration (conservative: err against churn).
        self.default_resize_cost_s = get_float(
            "HOROVOD_POLICY_RESIZE_COST", 30.0)
        self._lock = threading.Lock()
        self._ewma: dict[str, float] = {}
        self._hb_ewma: dict[str, float] = {}
        self._res_ewma: dict[str, float] = {}
        self._regr_ewma: dict[str, float] = {}
        self._integrity: dict[str, int] = {}
        self._above_since: dict[str, float] = {}
        self._last_observe_t: float | None = None
        self._last_worst: dict | None = None
        self._rate_samples: collections.deque = collections.deque(
            maxlen=512)  # (t, world commits/s)
        self._resize_cost_ewma: float | None = None
        self._last_action_t: float | None = None
        self._pending: PolicyDecision | None = None

    @property
    def enabled(self) -> bool:
        return self.target is not None

    @property
    def armed(self) -> bool:
        """Whether :meth:`decide` can produce ANY decision: the goodput
        SLO channel (``HOROVOD_TARGET_GOODPUT``) or the integrity-strikes
        channel (``HOROVOD_POLICY_INTEGRITY_STRIKES``) — the latter is a
        correctness channel and must not require a throughput SLO to be
        configured before a corrupting host can be drained."""
        return self.enabled or self.integrity_strikes > 0

    # -- sensor intake -------------------------------------------------------

    def note_rate(self, rate: float | None) -> None:
        """One sample of the world's aggregate commit rate (commits/s per
        host, averaged over world hosts) — the throughput signal the
        realized-vs-counterfactual comparison rides."""
        if rate is None:
            return
        with self._lock:
            self._rate_samples.append((self._clock(), float(rate)))

    def note_integrity(self, host: str) -> None:
        """One integrity-divergence strike against ``host`` (the driver
        calls this on every vote that names it). Accumulates for the
        life of the host's membership — a corrupting host does not earn
        forgiveness by corrupting slowly."""
        with self._lock:
            self._integrity[host] = self._integrity.get(host, 0) + 1

    def integrity_strike_count(self, host: str) -> int:
        with self._lock:
            return self._integrity.get(host, 0)

    def note_resize_cost(self, seconds: float) -> None:
        """The driver measured one reconfiguration (abort → publish →
        relaunch) taking ``seconds`` of wall time — the re-rendezvous
        price the SLO gate weighs a drain against."""
        if seconds <= 0:
            return
        with self._lock:
            prev = self._resize_cost_ewma
            self._resize_cost_ewma = (
                seconds if prev is None else 0.5 * prev + 0.5 * seconds)

    def resize_cost_s(self) -> float:
        with self._lock:
            return (self._resize_cost_ewma
                    if self._resize_cost_ewma is not None
                    else self.default_resize_cost_s)

    def observe(self, skew: Mapping[str, Any],
                hb_ages: Mapping[str, float],
                world_hosts: Sequence[str],
                comms_residuals: Mapping[str, float] | None = None,
                regression_excess: Mapping[str, float] | None = None
                ) -> None:
        """Fold one evidence snapshot into the per-host EWMAs.

        ``skew`` is :func:`tracing.compute_skew` output (the server's
        ``/stragglers`` body); ``hb_ages`` the server-clock heartbeat
        ages; ``comms_residuals`` (optional) the per-host
        predicted-vs-observed residual seconds from the cluster-merged
        comms model (the server's ``/comms`` body ``"residuals"`` map) —
        the third evidence channel, armed by
        ``HOROVOD_POLICY_COMMS_RESIDUAL``; ``regression_excess``
        (optional) the attribution plane's {host: excess seconds over
        the per-phase step-time baseline} suspect map
        (``RendezvousServer.regression_suspects``) — the step-regression
        channel, armed by ``HOROVOD_POLICY_STEP_REGRESSION``. Hosts
        outside the current world are dropped from the EWMA state (a
        departed host must not carry stale condemnation back in through
        the spare tier)."""
        now = self._clock()
        world = set(world_hosts)
        # Per-host straggler score: mean lateness across the host's ranks
        # (the hvd_straggler_score{host} definition).
        scores: dict[str, list[float]] = {}
        for _rank, info in (skew.get("ranks") or {}).items():
            host = info.get("host", "")
            if host in world:
                scores.setdefault(host, []).append(
                    float(info.get("mean_lateness_s", 0.0)))
        # A host with NO skew evidence this tick is one the trace plane
        # is momentarily BLIND to (its ships starved under load, a
        # re-form just cleared the scope, its spans matched no group) —
        # not one measured healthy. Blind hosts get their skew EWMA and
        # sustained clock FROZEN instead of folding a fake zero: the
        # degrading host most likely to stop shipping must not have its
        # condemnation countdown reset by its own sensor outage.
        # Positive evidence below the threshold (the host's ranks
        # matched, and arrive on time) still resets, as it should.
        with self._lock:
            dt = (now - self._last_observe_t
                  if self._last_observe_t is not None else self.interval_s)
            self._last_observe_t = now
            alpha = max(min(dt / max(self.window_s, 1e-6), 1.0), 0.0)
            if scores:
                self._last_worst = skew.get("worst")
            for state in (self._ewma, self._hb_ewma, self._res_ewma,
                          self._regr_ewma, self._integrity,
                          self._above_since):
                for host in [h for h in state if h not in world]:
                    del state[host]
            residuals = dict(comms_residuals or {})
            regressions = dict(regression_excess or {})
            for host in world:
                has_evidence = host in scores
                if has_evidence:
                    score = sum(scores[host]) / len(scores[host])
                    prev = self._ewma.get(host, 0.0)
                    ewma = prev + alpha * (score - prev)
                    self._ewma[host] = ewma
                else:
                    ewma = self._ewma.get(host, 0.0)  # frozen
                age = float(hb_ages.get(host, 0.0) or 0.0)
                hb_prev = self._hb_ewma.get(host, 0.0)
                self._hb_ewma[host] = hb_prev + alpha * (age - hb_prev)
                # Comms-residual channel: same blindness contract as the
                # skew EWMA — a host whose model stopped shipping is
                # FROZEN, not reset (the degrading host most likely to
                # stop shipping must not self-pardon).
                has_res = host in residuals
                if has_res:
                    try:
                        res = float(residuals[host])
                    except (TypeError, ValueError):
                        res = float("nan")
                    if not (res >= 0.0):  # malformed/NaN = blind:
                        has_res = False   # frozen, never a fake 0.0
                    else:
                        res_prev = self._res_ewma.get(host, 0.0)
                        self._res_ewma[host] = res_prev + alpha * (
                            res - res_prev)
                # Step-regression channel: same shape as the residual
                # channel. The suspect map carries an entry for every
                # world host when the channel is fed (0.0 = measured
                # healthy), so absence here means the attribution plane
                # was blind this tick — frozen, never a fake 0.0.
                has_regr = host in regressions
                if has_regr:
                    try:
                        regr = float(regressions[host])
                    except (TypeError, ValueError):
                        regr = float("nan")
                    if not (regr >= 0.0):
                        has_regr = False
                    else:
                        regr_prev = self._regr_ewma.get(host, 0.0)
                        self._regr_ewma[host] = regr_prev + alpha * (
                            regr - regr_prev)
                # Sustained-evidence clock: the drain threshold must hold
                # CONTINUOUSLY for window_s — one spiky instance resets.
                hb_condemned = (self.hb_drift_s > 0
                                and self._hb_ewma[host] >= self.hb_drift_s)
                res_condemned = (
                    self.comms_residual_s > 0
                    and self._res_ewma.get(host, 0.0)
                    >= self.comms_residual_s)
                regr_condemned = (
                    self.step_regression_s > 0
                    and self._regr_ewma.get(host, 0.0)
                    >= self.step_regression_s)
                if (ewma >= self.drain_skew_s or hb_condemned
                        or res_condemned or regr_condemned):
                    self._above_since.setdefault(host, now)
                elif (has_evidence or self.hb_drift_s > 0
                      or (self.comms_residual_s > 0 and has_res)
                      or (self.step_regression_s > 0 and has_regr)):
                    self._above_since.pop(host, None)
                try:
                    _metrics.POLICY_STRAGGLER_EWMA.set(ewma, host=host)
                except Exception:  # noqa: BLE001 — gauges are advisory
                    pass

    # -- durable control-plane state (driver crash-restart takeover) ---------

    def export_state(self) -> dict:
        """The controller's resumable evidence, for the driver's durable
        snapshot (``runner/elastic/driver_state.py``): per-host skew and
        heartbeat-age EWMAs, each host's SUSTAINED-condemnation age
        (relative seconds — monotonic stamps do not survive a process
        restart), and the measured resize-cost EWMA. Rate samples and a
        pending realization window are deliberately NOT exported: the
        counterfactual was measured against a world the crash just
        perturbed."""
        now = self._clock()
        with self._lock:
            return {
                "ewma": {h: float(v) for h, v in self._ewma.items()},
                "hb_ewma": {h: float(v)
                            for h, v in self._hb_ewma.items()},
                "res_ewma": {h: float(v)
                             for h, v in self._res_ewma.items()},
                "regr_ewma": {h: float(v)
                              for h, v in self._regr_ewma.items()},
                "above_ages": {h: max(now - t, 0.0)
                               for h, t in self._above_since.items()},
                "integrity_strikes": dict(self._integrity),
                "resize_cost": self._resize_cost_ewma,
            }

    def restore_state(self, state: Mapping[str, Any] | None) -> None:
        """Resume exported evidence after a driver restart: EWMAs and
        sustained-condemnation clocks pick up where the predecessor
        left off (a straggler already half-condemned does not get a
        fresh window just because the control plane flapped)."""
        if not isinstance(state, Mapping):
            return
        now = self._clock()
        with self._lock:
            for key, target in (("ewma", self._ewma),
                                ("hb_ewma", self._hb_ewma),
                                ("res_ewma", self._res_ewma),
                                ("regr_ewma", self._regr_ewma)):
                values = state.get(key)
                if isinstance(values, Mapping):
                    for h, v in values.items():
                        try:
                            target[str(h)] = float(v)
                        except (TypeError, ValueError):
                            continue
            strikes = state.get("integrity_strikes")
            if isinstance(strikes, Mapping):
                for h, n in strikes.items():
                    try:
                        self._integrity[str(h)] = int(n)
                    except (TypeError, ValueError):
                        continue
            ages = state.get("above_ages")
            if isinstance(ages, Mapping):
                for h, age in ages.items():
                    try:
                        self._above_since[str(h)] = now - max(
                            float(age), 0.0)
                    except (TypeError, ValueError):
                        continue
            cost = state.get("resize_cost")
            if isinstance(cost, (int, float)) and cost > 0:
                self._resize_cost_ewma = float(cost)

    # -- deliberation --------------------------------------------------------

    def _recent_rate(self, since: float | None = None,
                     until: float | None = None) -> float | None:
        with self._lock:
            samples = [r for t, r in self._rate_samples
                       if (since is None or t >= since)
                       and (until is None or t <= until)]
        if not samples:
            return None
        return sum(samples) / len(samples)

    def decide(self, world_hosts: Sequence[str],
               spares_ready: int) -> PolicyDecision | None:
        """One policy evaluation: the most-condemned world host whose
        sustained evidence, replacement availability, and SLO math all
        say a proactive drain pays for its re-rendezvous. Returns None
        (hold) otherwise. Fires the ``policy.decide`` fault point."""
        if not self.armed:
            return None
        if faults.fire(faults.POLICY_DECIDE):
            return None  # injected drop: this evaluation never happened
        now = self._clock()
        with self._lock:
            if self._pending is not None:
                return None  # one experiment at a time
            if (self._last_action_t is not None
                    and now - self._last_action_t < self.cooldown_s):
                return None
            # Integrity-strikes channel: a host the voting plane has
            # named divergent >= the strike threshold is drained on
            # bitwise evidence — no sustained window (the strikes ARE
            # the confirmations) and no SLO gate (correctness beats
            # throughput arithmetic). Replacement availability still
            # applies below.
            integrity_hosts = []
            if self.integrity_strikes > 0:
                # Strikes live for the host's MEMBERSHIP: prune departed
                # hosts here too, because in strikes-only arming (no
                # goodput SLO) observe() — the usual pruning site —
                # never runs, and a drained host re-entering through the
                # spare tier must not be instantly re-drained on strikes
                # from its previous membership.
                world = set(world_hosts)
                for h in [h for h in self._integrity if h not in world]:
                    del self._integrity[h]
                integrity_hosts = sorted(
                    ((n, h) for h in world_hosts
                     if (n := self._integrity.get(h, 0))
                     >= self.integrity_strikes),
                    reverse=True)
            # A host's effective score is the larger of its two evidence
            # channels: mean collective lateness, or heartbeat-age excess
            # past the drift threshold (lateness the collectives will see
            # the moment the degrading host is on the critical path).
            candidates = []
            for h in world_hosts:
                if (h not in self._above_since
                        or now - self._above_since[h] < self.window_s):
                    continue
                score = self._ewma.get(h, 0.0)
                if self.hb_drift_s > 0:
                    score = max(
                        score, self._hb_ewma.get(h, 0.0) - self.hb_drift_s)
                if self.comms_residual_s > 0:
                    # The residual IS seconds of per-collective lateness
                    # the model cannot explain — directly comparable to
                    # the skew score's lateness seconds.
                    score = max(score, self._res_ewma.get(h, 0.0))
                if self.step_regression_s > 0:
                    # The regression excess IS seconds of per-step
                    # lateness over the host's own baseline — the same
                    # unit again.
                    score = max(score, self._regr_ewma.get(h, 0.0))
                candidates.append((score, h))
            worst = dict(self._last_worst) if self._last_worst else None
            ewma_snapshot = dict(self._ewma)
            hb_snapshot = dict(self._hb_ewma)
            res_snapshot = dict(self._res_ewma)
            regr_snapshot = dict(self._regr_ewma)
            above = {h: now - t for h, t in self._above_since.items()}
        if integrity_hosts:
            strikes, host = integrity_hosts[0]
            if spares_ready <= 0 and len(world_hosts) - 1 < self._min_np:
                return None  # nobody to backfill: hold (fences still up)
            return PolicyDecision(
                action="drain", host=host,
                reason=(f"integrity divergence: {strikes} strike(s) >= "
                        f"HOROVOD_POLICY_INTEGRITY_STRIKES="
                        f"{self.integrity_strikes}"),
                evidence={
                    "integrity_strikes": {h: n for n, h in integrity_hosts},
                    "straggler_ewma_s": {h: round(v, 6)
                                         for h, v in ewma_snapshot.items()},
                },
                predicted={"integrity_strikes": strikes,
                           "slo_bypassed": True},
                t_decided=now)
        if not self.enabled:
            return None  # strikes-only arming: no SLO channel to evaluate
        if not candidates:
            return None
        score, host = max(candidates)
        # Replacement availability: never drain the world below min_np —
        # a warm spare (or surplus capacity) must be able to backfill.
        if spares_ready <= 0 and len(world_hosts) - 1 < self._min_np:
            return None
        # SLO gate: measured loss fraction = lateness per commit x world
        # commit rate (seconds lost per second). Tolerate the straggler
        # while projected goodput still clears the target.
        rate = self._recent_rate(since=now - self.realize_window_s)
        lost_frac = min(max(score * (rate or 0.0), 0.0), 0.95)
        projected_goodput = 1.0 - lost_frac
        if rate is not None and projected_goodput >= (self.target or 1.0):
            return None
        resize_cost = self.resize_cost_s()
        predicted_gain_s = lost_frac * self.horizon_s - resize_cost
        if predicted_gain_s <= 0:
            return None
        evidence = {
            "straggler_ewma_s": {h: round(v, 6)
                                 for h, v in ewma_snapshot.items()},
            "hb_age_ewma_s": {h: round(v, 6)
                              for h, v in hb_snapshot.items()},
            "comms_residual_ewma_s": {h: round(v, 6)
                                      for h, v in res_snapshot.items()},
            "step_regression_ewma_s": {h: round(v, 6)
                                       for h, v in regr_snapshot.items()},
            "sustained_s": {h: round(v, 3) for h, v in above.items()},
            "window_s": self.window_s,
            "drain_skew_s": self.drain_skew_s,
            "worst_instance": worst,
        }
        predicted = {
            "lost_fraction": round(lost_frac, 6),
            "projected_goodput": round(projected_goodput, 6),
            "target_goodput": self.target,
            "world_rate_commits_s": (round(rate, 6)
                                     if rate is not None else None),
            "resize_cost_s": round(resize_cost, 3),
            "horizon_s": self.horizon_s,
            "predicted_gain_s": round(predicted_gain_s, 3),
        }
        return PolicyDecision(
            action="drain", host=host,
            reason=(f"sustained straggler: ewma lateness {score:.3f}s >= "
                    f"{self.drain_skew_s:.3f}s for >= {self.window_s:.0f}s"),
            evidence=evidence, predicted=predicted, t_decided=now)

    # -- actuation feedback + realization ------------------------------------

    def record_drain(self, decision: PolicyDecision,
                     generation: int | None = None) -> None:
        """The driver executed ``decision``: snapshot the no-action
        counterfactual (pre-drain commit rate) and open the realization
        window. The ``policy_decision`` journal record is emitted once,
        when realized — carrying both predicted and measured deltas."""
        now = self._clock()
        decision.t_acted = now
        decision.generation = generation
        decision.pre_rate = self._recent_rate(
            since=now - self.realize_window_s, until=now)
        with self._lock:
            self._last_action_t = now
            self._pending = decision
            # Post-action samples measure the NEW world only.
            self._rate_samples.clear()
        try:
            _metrics.POLICY_DECISIONS.inc(action=decision.action)
        except Exception:  # noqa: BLE001
            pass

    def realize_tick(self) -> PolicyDecision | None:
        """Emit the pending decision's ``policy_decision`` record once
        its realization window has elapsed. Returns the realized decision
        (journaled) or None."""
        with self._lock:
            pending = self._pending
        if pending is None or pending.t_acted is None:
            return None
        if self._clock() - pending.t_acted < self.realize_window_s:
            return None
        return self._finalize(pending)

    def flush(self) -> PolicyDecision | None:
        """Driver shutdown: journal a still-pending decision with
        whatever post-action window was measured (a decision must never
        vanish from the record just because the job finished first)."""
        with self._lock:
            pending = self._pending
        if pending is None:
            return None
        return self._finalize(pending, partial=True)

    def _finalize(self, decision: PolicyDecision,
                  partial: bool = False) -> PolicyDecision:
        now = self._clock()
        post_rate = self._recent_rate(since=decision.t_acted)
        pre = decision.pre_rate
        realized_gain = (None if post_rate is None or pre is None
                         else post_rate - pre)
        realized = {
            "counterfactual_rate_commits_s": (round(pre, 6)
                                              if pre is not None else None),
            "realized_rate_commits_s": (round(post_rate, 6)
                                        if post_rate is not None else None),
            "realized_gain_commits_s": (round(realized_gain, 6)
                                        if realized_gain is not None
                                        else None),
            "window_s": round(now - (decision.t_acted or now), 3),
            "partial": partial,
        }
        _metrics.event(
            "policy_decision", generation=decision.generation,
            action=decision.action, host=decision.host,
            reason=decision.reason, evidence=decision.evidence,
            predicted=decision.predicted, realized=realized)
        with self._lock:
            self._pending = None
        decision.predicted = dict(decision.predicted)
        decision.predicted["realized"] = realized
        return decision
