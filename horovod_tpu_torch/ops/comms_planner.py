"""Per-bucket collective algorithm selection, and the schedules it selects.

Port of ``horovod_tpu/ops/comms_planner.py``: the decision (:82-706) and
the schedules (:796-1135), on ``torch.distributed`` instead of traced
``lax`` collectives.

Algorithms (``algorithm`` label values of the comms model's fits):

- ``flat``: the one NCCL (gloo on the CPU) collective every flush and
  eager op launches with the planner off.
- ``rhd``: recursive halving-doubling, log2(n) rounds of paired
  ``batch_isend_irecv`` exchanges (reduce-scatter by halving, allgather
  by doubling), with the fold-in and fold-out of the ranks above the
  largest power of two for an allreduce on another world size.
- ``two_level``: a reduce-scatter within each island, the cross-island
  leg on the 1/L shard, an allgather within each island, over subgroups
  of the world (``dist.new_group``, built once per world generation).

Selection (:func:`plan_bucket`), per (op, bucket bytes, world): a
:class:`forced` algorithm, the autotune pin (``autotune.tuned_algorithm``),
the env pin (``HOROVOD_COMMS_PLANNER=flat|rhd|two_level``), the fitted
alpha-beta model's exact keys when two or more eligible algorithms have
a ready fit, else the static crossover table of the per-class seeds
(``topology.LINK_CLASS_SEEDS``). An ineligible pin runs flat under the
``:ineligible`` label. The link classes are the port's: ``intra_host``
within an island, ``inter_host`` across (the reference's ``ici`` and
``dcn``); islands are ``Topology.ici_islands`` (one per host, or
``HOROVOD_LINK_CLASS_MAP``'s).

Rank identity: a plan is a function of the bucket, the world, the
islands and the model snapshot, and the snapshot is rank 0's, broadcast
(``functions.broadcast_object``) once per world generation
(``HOROVOD_WORLD_VERSION``). The exchange, and the two-level subgroups,
are made by :func:`prepare` where every rank calls it in one order
outside the backward: when a ``DistributedOptimizer`` reads its world
(at construction and at every later ``init()``), and at an eager
collective; never per bucket. Plans are planned only for the global
process set.

On the card every round is queued on the current stream (NCCL's
``wait`` orders the stream), so a multi-round schedule launched from a
gradient hook does not block the host; on gloo each round blocks.

With ``HOROVOD_COMMS_PLANNER`` unset every caller checks :func:`enabled`
first and dispatches what it dispatched before this module.

Left out: the 2-D mesh-axis legs (``_mesh_shape_for``,
``axis_link_class``, ``price_axis_gather``, ``describe_axis_plans``),
which wait for a port of ``parallel/mesh.py``.

Stdlib at import (torch is imported by the schedules).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any, NamedTuple, Sequence

#: The planner's algorithm vocabulary.
PLANNER_ALGORITHMS = ("flat", "rhd", "two_level")

#: Ops the planner schedules.
PLANNER_OPS = ("allreduce", "reducescatter", "allgather", "alltoall")

#: The gradient wire's ops: the autotune algorithm axis intersects
#: eligibility over these.
_WIRE_OPS = ("allreduce", "reducescatter", "allgather")

#: The port's link classes within and across islands.
_INTRA, _INTER = "intra_host", "inter_host"


class BucketPlan(NamedTuple):
    """One bucket's schedule decision."""

    op: str
    algorithm: str
    nbytes: int
    world: int
    islands: tuple[tuple[int, ...], ...] | None
    provenance: str  # forced|autotune_pin|env_pin|model|static_crossover
    costs: dict  # {algorithm: predicted seconds} (empty for pins)


_lock = threading.Lock()
_plans: dict[tuple, BucketPlan] = {}
_snapshot: dict[str, tuple[float, float | None]] | None = None
_generation: str | None = None
# The Topology of the world the plans were made in: a new world (a re-init,
# in the same generation too) gets new subgroups and a new exchange.
_world = None
_replans = 0
_forced: list[str] = []
# The two-level subgroups by island layout, for the current generation.
_groups: dict[tuple, "_TwoLevelGroups"] = {}


def planner_mode() -> str | None:
    """None (off), ``"auto"`` (price per bucket) or a pinned algorithm:
    ``HOROVOD_COMMS_PLANNER`` = ``1``/``true``/``auto``/``on`` or
    ``flat``/``rhd``/``two_level``; anything else is off."""
    raw = os.environ.get("HOROVOD_COMMS_PLANNER", "").strip().lower()
    if raw in ("1", "true", "auto", "on"):
        return "auto"
    if raw in PLANNER_ALGORITHMS:
        return raw
    return None


def enabled() -> bool:
    return planner_mode() is not None


def reset_for_testing() -> None:
    """Forget every plan, the synced snapshot, the generation fence and
    the subgroups."""
    global _snapshot, _generation, _world, _replans
    with _lock:
        _plans.clear()
        _snapshot = None
        _generation = _world = None
        _replans = 0
        _groups.clear()
    _forced.clear()


class forced:
    """Context manager pinning every plan to ``algorithm`` (the
    microprobe's per-algorithm passes, A/B runs). Nestable."""

    def __init__(self, algorithm: str):
        if algorithm not in PLANNER_ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {algorithm!r}; expected one of "
                f"{PLANNER_ALGORITHMS}")
        self._algorithm = algorithm

    def __enter__(self):
        _forced.append(self._algorithm)
        return self

    def __exit__(self, *exc):
        _forced.pop()
        return False


def _generation_now() -> str:
    return os.environ.get("HOROVOD_WORLD_VERSION", "static") or "static"


def maybe_replan() -> None:
    """Drop every plan, the snapshot and the subgroups when the world
    generation advanced (an elastic world re-formed) or the world was
    formed again."""
    global _generation, _world, _snapshot, _replans
    gen = _generation_now()
    world = _topology()
    with _lock:
        if _generation is None:
            _generation, _world = gen, world
            return
        if gen == _generation and world is _world:
            return
        _generation, _world = gen, world
        _plans.clear()
        _snapshot = None
        _groups.clear()
        _replans += 1
    _note_replan()


def _note_replan() -> None:
    try:
        from .. import metrics

        metrics.PLANNER_REPLANS.inc()
    except Exception:  # noqa: BLE001 — instrumentation is best-effort
        pass


# -- World facts ------------------------------------------------------------


def _topology():
    """The world's ``Topology`` (``basics._state.topology``), or None
    before ``init()`` and in a process that never imported the world (the
    elastic driver, which must not import torch)."""
    basics = sys.modules.get(f"{__package__.rsplit('.', 1)[0]}.basics")
    return None if basics is None else basics._state.topology


def default_world_size() -> int | None:
    """The initialized world's rank count, or None before ``init()``."""
    topo = _topology()
    return topo.size if topo is not None else None


def _islands_for(world_size: int) -> tuple[tuple[int, ...], ...] | None:
    """The island layout of a ``world_size``-rank world
    (``Topology.ici_islands``), or None when unknown."""
    topo = _topology()
    if topo is None or topo.size != int(world_size):
        return None
    return tuple(tuple(int(r) for r in isl) for isl in topo.ici_islands())


def _worst_link_class(islands) -> str:
    return _INTER if islands is not None and len(islands) > 1 else _INTRA


def _regular_factors(islands, world) -> tuple[int, int] | None:
    """(islands G, island size L) for a regular layout of at least two
    islands of at least two ranks covering the world; else None."""
    if islands is None or len(islands) < 2:
        return None
    sizes = {len(isl) for isl in islands}
    if len(sizes) != 1:
        return None
    L = sizes.pop()
    G = len(islands)
    if G * L != int(world) or L < 2:
        return None
    return G, L


def eligible_algorithms(op: str, world: int, islands,
                        candidates: Sequence[str] | None = None
                        ) -> tuple[str, ...]:
    """The algorithms an (op, world, islands) bucket may take: ``rhd``
    for an allreduce on two or more ranks and for the reduce-scatter and
    allgather on a power-of-two world (never an alltoall), ``two_level``
    on a regular layout, ``flat`` always."""
    out = ["flat"]
    n = int(world)
    pow2 = n >= 2 and (n & (n - 1)) == 0
    if op == "alltoall":
        pass
    elif op == "allreduce":
        if n >= 2:
            out.append("rhd")
    elif pow2:
        out.append("rhd")
    if _regular_factors(islands, n) is not None:
        out.append("two_level")
    if candidates is not None:
        out = [a for a in out if a in candidates]
    return tuple(out)


# -- Pricing ------------------------------------------------------------------


def _seed(link_class: str) -> tuple[float, float]:
    from ..topology import link_seed

    return link_seed(link_class)


def _seed_price(op: str, algorithm: str, nbytes: float, world: int,
                islands) -> float | None:
    """The static crossover table: seconds from the per-class seeds, one
    alpha per collective leg and beta times its bytes. None for ``rhd``
    (never chosen statically)."""
    B = float(nbytes)
    n = int(world)
    worst = _worst_link_class(islands)
    a_w, b_w = _seed(worst)
    halves = 2.0 if op == "allreduce" else 1.0
    if op == "alltoall":
        # A permutation: flat sends a message to each peer ((n-1) alphas,
        # the "mixed" class on a split fabric); two_level aggregates them
        # into (L-1) intra and (G-1) inter launches, and the cross leg
        # still carries (G-1)/G of the bytes.
        if algorithm == "flat":
            a_f, b_f = _seed("mixed" if worst == _INTER else worst)
            return a_f * max(n - 1, 1) + b_f * B * (n - 1) / max(n, 1)
        if algorithm == "two_level":
            factors = _regular_factors(islands, n)
            if factors is None:
                return None
            G, L = factors
            a_i, b_i = _seed(_INTRA)
            a_d, b_d = _seed(_INTER)
            local = a_i * (L - 1) + b_i * B * (L - 1) / L
            cross = a_d * (G - 1) + b_d * B * (G - 1) / G
            return local + cross
        return None
    if algorithm == "flat":
        return a_w + b_w * B * halves * (n - 1) / max(n, 1)
    if algorithm == "rhd":
        return None
    if algorithm == "two_level":
        factors = _regular_factors(islands, n)
        if factors is None:
            return None
        G, L = factors
        a_i, b_i = _seed(_INTRA)
        a_d, b_d = _seed(_INTER)
        local = a_i + b_i * B * (L - 1) / L
        cross = a_d + b_d * (B / L) * halves * (G - 1) / G
        if op == "allreduce":
            return 2.0 * local + cross
        return local + cross
    return None


def _model_price(snapshot, op: str, algorithm: str, link_class: str,
                 nbytes: float) -> float | None:
    """alpha + beta * bytes from the snapshot's exact key, else None."""
    if not snapshot:
        return None
    entry = snapshot.get(f"{op}|{algorithm}|{link_class}")
    if entry is None:
        return None
    alpha, beta = entry
    if beta is None:
        return max(float(alpha), 0.0)
    return max(float(alpha) + float(beta) * float(nbytes), 0.0)


def _decide(op: str, nbytes: int, world: int, islands, snapshot,
            candidates: Sequence[str] | None) -> tuple[str, str, dict]:
    """(algorithm, provenance, costs), a pure function of its inputs.
    With two or more fitted eligible candidates the fitted ones compete
    (``model``); otherwise every candidate prices from the seeds
    (``static_crossover``)."""
    elig = eligible_algorithms(op, world, islands, candidates)
    link = _worst_link_class(islands)
    fitted: dict[str, float] = {}
    seeded: dict[str, float] = {}
    for algo in elig:
        cost = _model_price(snapshot, op, algo, link, nbytes)
        if cost is not None:
            fitted[algo] = cost
        cost = _seed_price(op, algo, nbytes, world, islands)
        if cost is not None:
            seeded[algo] = cost
    if len(fitted) >= 2:
        best = min(sorted(fitted), key=lambda a: fitted[a])
        return best, "model", fitted
    if not seeded:
        return "flat", "static_crossover", {}
    best = min(sorted(seeded), key=lambda a: seeded[a])
    return best, "static_crossover", seeded


# -- The synced snapshot ------------------------------------------------------


def _broadcast_decision(decision):
    """Rank 0's value on every rank (a one-rank world passes through)."""
    from .. import basics

    if basics.is_initialized() and basics.size() > 1:
        from ..functions import broadcast_object

        return broadcast_object(decision, name="planner/model-snapshot")
    return decision


def _local_snapshot() -> dict[str, tuple[float, float | None]]:
    from .. import comms_model

    return comms_model.get_model().fit_snapshot(
        ops=PLANNER_OPS, algorithms=PLANNER_ALGORITHMS)


def _synced_snapshot() -> dict[str, tuple[float, float | None]]:
    """Rank 0's ready fits, exchanged once per generation and cached. A
    local failure to build the snapshot sends ``{}`` (only rank 0's value
    counts); a failure of the exchange raises."""
    global _snapshot
    with _lock:
        if _snapshot is not None:
            return _snapshot
    try:
        local = _local_snapshot()
    except Exception:  # noqa: BLE001 — {} is a valid (seeded) snapshot
        local = {}
    snap = _broadcast_decision(local)
    if not isinstance(snap, dict):
        snap = {}
    with _lock:
        if _snapshot is None:
            _snapshot = snap
        return _snapshot


def _peek_snapshot() -> tuple[dict, bool]:
    """(snapshot, synced): the synced one when it exists, else this
    rank's local fits (for paths that must not enter an exchange)."""
    with _lock:
        if _snapshot is not None:
            return _snapshot, True
    try:
        return _local_snapshot(), False
    except Exception:  # noqa: BLE001
        return {}, False


def prepare() -> None:
    """Make this generation's snapshot exchange and two-level subgroups,
    where every rank calls it in the same order outside the backward
    (``DistributedOptimizer``'s world read, the eager collectives). A
    no-op with the planner off or on one rank."""
    n = default_world_size()
    if not enabled() or n is None or n < 2:
        return
    maybe_replan()
    _synced_snapshot()
    islands = _islands_for(n)
    if _regular_factors(islands, n) is not None:
        _two_level_groups(islands)


# -- plan_bucket --------------------------------------------------------------


def _pinned() -> tuple[str, str] | None:
    """(algorithm, provenance) when a pin decides."""
    if _forced:
        return _forced[-1], "forced"
    try:
        from ..autotune import tuned_algorithm

        pin = tuned_algorithm()
    except Exception:  # noqa: BLE001
        pin = None
    if pin == "auto":
        return None
    if pin is not None:
        return str(pin), "autotune_pin"
    mode = planner_mode()
    if mode in PLANNER_ALGORITHMS:
        return mode, "env_pin"
    return None


def plan_bucket(op: str, nbytes: int, world_size: int | None,
                candidates: Sequence[str] | None = None,
                sync: bool = True) -> BucketPlan | None:
    """The schedule of one bucket, or None with the planner off, the
    world unknown or of one rank, or an op it does not plan (callers
    then dispatch flat). ``sync=False`` never enters the snapshot
    exchange and caches nothing (introspection)."""
    if not enabled():
        return None
    if world_size is None or int(world_size) < 2:
        return None
    if op not in PLANNER_OPS:
        return None
    maybe_replan()
    n = int(world_size)
    islands = _islands_for(n)
    pin = _pinned()
    key = (op, int(nbytes), n, islands, pin,
           tuple(candidates) if candidates is not None else None)
    with _lock:
        plan = _plans.get(key)
    if plan is not None:
        return plan
    if pin is not None:
        algo, provenance = pin
        if algo not in eligible_algorithms(op, n, islands, candidates):
            algo = "flat"
            provenance += ":ineligible"
        plan = BucketPlan(op, algo, int(nbytes), n, islands, provenance, {})
    else:
        if sync:
            snapshot = _synced_snapshot()
        else:
            snapshot, _synced = _peek_snapshot()
        algo, provenance, costs = _decide(
            op, int(nbytes), n, islands, snapshot, candidates)
        plan = BucketPlan(op, algo, int(nbytes), n, islands, provenance,
                          costs)
    if not sync:
        return plan
    with _lock:
        _plans.setdefault(key, plan)
    _note_plan()
    return plan


def planned_algorithm(op: str, nbytes: int, world_size: int | None,
                      candidates: Sequence[str] | None = None,
                      sync: bool = True) -> str:
    """The planned algorithm's name (``flat`` with the planner off)."""
    plan = plan_bucket(op, nbytes, world_size, candidates, sync=sync)
    return plan.algorithm if plan is not None else "flat"


def _note_plan() -> None:
    try:
        from .. import metrics

        metrics.PLANNER_PLANS.inc()
    except Exception:  # noqa: BLE001
        pass


def note_dispatch(op: str, algorithm: str) -> None:
    """Count one planned collective (``hvd_planner_dispatch_total``)."""
    try:
        from .. import metrics

        metrics.PLANNER_DISPATCH.inc(op=op, algorithm=algorithm)
    except Exception:  # noqa: BLE001
        pass


def dispatch_plan(op: str, nbytes: int, process_set,
                  reduce_op: str | None = None,
                  candidates: Sequence[str] | None = None
                  ) -> BucketPlan | None:
    """The wiring's one entry (every bucket flush and eager collective):
    the plan of one collective of ``nbytes`` on ``process_set`` when it is
    not flat, else None, and the caller launches what it launched before
    the planner. None with the planner off (checked first, so that unset
    nothing else runs), on a set other than the global one, or for a
    reduction other than Sum or Average; a planned collective counts one
    dispatch by its algorithm, flat included."""
    if not enabled():
        return None
    if process_set.process_set_id != 0 or reduce_op not in (
            None, "sum", "average"):
        return None
    plan = plan_bucket(op, int(nbytes), process_set.size(), candidates)
    if plan is None:
        return None
    note_dispatch(op, plan.algorithm)
    return None if plan.algorithm == "flat" else plan


def autotune_candidates(world_size: int | None = None
                        ) -> tuple[str, ...] | None:
    """The autotune algorithm axis (``"auto"`` first, then every
    algorithm eligible on all the wire's ops), or None when the planner
    is not ``auto`` or only flat is eligible."""
    if planner_mode() != "auto":
        return None
    n = world_size if world_size is not None else default_world_size()
    if n is None or int(n) < 2:
        return None
    islands = _islands_for(int(n))
    elig = set(PLANNER_ALGORITHMS)
    for op in _WIRE_OPS:
        elig &= set(eligible_algorithms(op, int(n), islands))
    ordered = tuple(a for a in PLANNER_ALGORITHMS if a in elig)
    return ("auto",) + ordered if len(ordered) > 1 else None


# -- Introspection ------------------------------------------------------------

#: The payloads summary and describe price plans at (64 KiB, 16 MiB).
_DESCRIBE_PAYLOADS = (64 * 1024, 16 * 1024 * 1024)


def summary() -> dict:
    """The planner leg of ``comms_model.payload()``; never raises."""
    mode = planner_mode()
    out: dict[str, Any] = {
        "enabled": mode is not None,
        "mode": mode,
        "generation": _generation,
        "replans": _replans,
    }
    if mode is None:
        return out
    with _lock:
        plans = list(_plans.values())
    out["plans"] = [
        {
            "op": p.op,
            "bytes": p.nbytes,
            "world": p.world,
            "algorithm": p.algorithm,
            "provenance": p.provenance,
            "costs_s": {a: round(c, 9) for a, c in sorted(p.costs.items())},
        }
        for p in plans[:32]
    ]
    out["plans_total"] = len(plans)
    return out


def describe_plans(topology) -> list[str]:
    """``Topology.describe()``'s plan lines: the planned algorithm per op
    at the representative payloads, priced rank-locally and cached
    nowhere."""
    mode = planner_mode()
    if mode is None:
        return ["planner: off (HOROVOD_COMMS_PLANNER unset)"]
    n = topology.size
    if n < 2:
        return [f"planner: {mode} (degenerate single-rank world)"]
    lines = [f"planner: {mode}"]
    islands = _islands_for(n)
    link = _worst_link_class(islands)
    snapshot, _ = _peek_snapshot()
    pin = _pinned()
    for op in PLANNER_OPS:
        choices = []
        for nbytes in _DESCRIBE_PAYLOADS:
            if pin is not None:
                algo, provenance = pin
                if algo not in eligible_algorithms(op, n, islands):
                    algo, provenance = "flat", provenance + ":ineligible"
            else:
                algo, provenance, _costs = _decide(
                    op, nbytes, n, islands, snapshot, None)
            choices.append(f"{nbytes // 1024}KiB->{algo}({provenance})")
        lines.append(f"  {op}@{link}: " + " ".join(choices))
    return lines


# -- The schedules ------------------------------------------------------------


class _Done:
    """A launched schedule's ``Work``: its rounds are already queued (the
    card) or done (gloo)."""

    def wait(self, timeout=None) -> bool:
        return True

    def is_completed(self) -> bool:
        return True


class _Group:
    """A subgroup as the int8 exchanges take a process set: ``group``,
    ``size()``, ``rank()`` (this rank's position in ``ranks``, which is
    torch's order: ascending)."""

    def __init__(self, ranks: Sequence[int], group):
        self.ranks = sorted(int(r) for r in ranks)
        self.group = group

    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        from .. import basics

        return self.ranks.index(basics.rank())


class _TwoLevelGroups(NamedTuple):
    """A regular island layout's subgroups: ``local[i]`` the island i
    (ascending ranks), ``cross[j]`` the ranks at position j of every
    island (ascending), and this rank's island and position."""

    local: list
    cross: list
    island: int
    position: int


def _two_level_groups(islands) -> _TwoLevelGroups:
    """The layout's subgroups, made once per generation: every rank calls
    ``dist.new_group`` for every island and every cross group, in one
    order."""
    import torch.distributed as dist

    from .. import basics

    key = tuple(tuple(sorted(isl)) for isl in islands)
    with _lock:
        made = _groups.get(key)
    if made is not None:
        return made
    local_ranks = [list(isl) for isl in key]
    L = len(local_ranks[0])
    cross_ranks = [[isl[j] for isl in local_ranks] for j in range(L)]
    local = [_Group(r, dist.new_group(r)) for r in local_ranks]
    cross = [_Group(r, dist.new_group(r)) for r in cross_ranks]
    me = basics.rank()
    island = next(i for i, isl in enumerate(local_ranks) if me in isl)
    made = _TwoLevelGroups(local, cross, island,
                           local_ranks[island].index(me))
    with _lock:
        _groups.setdefault(key, made)
        return _groups[key]


def _wait_all(works) -> None:
    from .collective_ops import wait

    for w in works:
        wait(w)


def _exchange(send, partner: int):
    """Send ``send`` to global rank ``partner`` and receive a buffer of its
    shape from it, as one paired ``batch_isend_irecv`` round."""
    import torch
    import torch.distributed as dist

    send = send.contiguous()
    recv = torch.empty_like(send)
    _wait_all(dist.batch_isend_irecv([dist.P2POp(dist.isend, send, partner),
                                      dist.P2POp(dist.irecv, recv, partner)]))
    return recv


def _send(t, partner: int) -> None:
    import torch.distributed as dist

    _wait_all(dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, t.contiguous(), partner)]))


def _recv_like(t, partner: int):
    import torch
    import torch.distributed as dist

    out = torch.empty_like(t)
    _wait_all(dist.batch_isend_irecv([dist.P2POp(dist.irecv, out, partner)]))
    return out


def _rhd_reduce_scatter_rows(work, n: int, r: int, ranks):
    """Recursive halving of an ``(n, chunk)`` view over ``ranks`` (the
    set's global ranks, this rank at position ``r``): after log2(n)
    paired exchanges this rank holds row r of the sum, ``(1, chunk)``.
    ``n`` is a power of two."""
    size = n
    while size > 1:
        h = size // 2
        keep_upper = (r & h) != 0
        lower, upper = work[:h], work[h:size]
        send, keep = (lower, upper) if keep_upper else (upper, lower)
        work = keep + _exchange(send, ranks[r ^ h])
        size = h
    return work


def _rhd_allgather_rows(work, n: int, r: int, ranks):
    """Recursive doubling: ``(1, chunk)`` (row r) to the ``(n, chunk)``
    rows in order on every rank."""
    import torch

    size = 1
    while size < n:
        recvd = _exchange(work, ranks[r ^ size])
        work = (torch.cat([recvd, work]) if r & size
                else torch.cat([work, recvd]))
        size *= 2
    return work


def rhd_allreduce_sum(flat, process_set):
    """Recursive halving-doubling SUM allreduce of a 1-D tensor over the
    set. On another world size than a power of two p, ranks [p, n) first
    add their buffer into rank i - p, the p ranks run the schedule, and
    the result goes back to ranks [p, n)."""
    import torch.nn.functional as F

    n = process_set.size()
    if n < 2:
        return flat
    ranks = list(process_set.ranks)
    r = process_set.rank()
    m = flat.numel()
    p = 1 << (n.bit_length() - 1)
    chunk = -(-m // p)
    buf = F.pad(flat, (0, p * chunk - m))
    if p != n:
        if r >= p:
            _send(buf, ranks[r - p])
            return _recv_like(flat, ranks[r - p])
        if r < n - p:
            buf = buf + _recv_like(buf, ranks[r + p])
    row = _rhd_reduce_scatter_rows(buf.view(p, chunk), p, r, ranks)
    full = _rhd_allgather_rows(row, p, r, ranks).reshape(-1)[:m]
    if r < n - p:
        _send(full, ranks[r + p])
    return full


def rhd_reducescatter_sum(flat, process_set):
    """Recursive-halving SUM reduce-scatter: ``(n*s,)`` to this rank's
    row ``(s,)``. Power-of-two worlds only."""
    n = process_set.size()
    r = process_set.rank()
    return _rhd_reduce_scatter_rows(flat.view(n, -1), n, r,
                                    list(process_set.ranks)).reshape(-1)


def rhd_allgather_row(row, process_set):
    """Recursive-doubling allgather: ``(s,)`` to the ``(n*s,)``
    concatenation in rank order. Power-of-two worlds only."""
    n = process_set.size()
    r = process_set.rank()
    return _rhd_allgather_rows(row.reshape(1, -1), n, r,
                               list(process_set.ranks)).reshape(-1)


def _reduce_scatter(out, inp, sub: _Group) -> None:
    """SUM reduce-scatter of ``inp`` over a subgroup into ``out``. On the
    CPU an allreduce and this rank's slice (gloo's reduce-scatter work
    never reports completion, so an elastic wait could not poll it)."""
    from .collective_ops import _TORCH_OPS, Sum, _reduce_scatter, wait

    if inp.device.type == "cpu":
        full = inp.clone()
        _allreduce_(full, sub.group)
        out.copy_(full.view(sub.size(), -1)[sub.rank()])
        return
    wait(_reduce_scatter(out, inp.contiguous(), op=_TORCH_OPS[Sum],
                         group=sub.group, async_op=True))


def _allreduce_(t, group) -> None:
    import torch.distributed as dist

    from .collective_ops import wait

    wait(dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group,
                         async_op=True))


def _all_gather(out, inp, group) -> None:
    from .collective_ops import _all_gather, wait

    wait(_all_gather(out, inp.contiguous(), group=group, async_op=True))


def two_level_allreduce_sum(flat, islands):
    """Reduce-scatter within the island, allreduce of the 1/L shard
    across islands (ranks at the same position), allgather within the
    island."""
    import torch.nn.functional as F

    g = _two_level_groups(islands)
    local, cross = g.local[g.island], g.cross[g.position]
    L = local.size()
    m = flat.numel()
    buf = F.pad(flat, (0, (-m) % L))
    shard = buf.new_empty(buf.numel() // L)
    _reduce_scatter(shard, buf, local)
    _allreduce_(shard, cross.group)
    full = buf.new_empty(buf.numel())
    _all_gather(full, shard, local.group)
    return full[:m]


def _two_level_row_order(g: _TwoLevelGroups) -> list[int]:
    """The rows (ranks) in island-position-major, cross-position-minor
    order: reduce-scatters over the island (L chunks of G rows) and then
    over the cross group leave each rank its own row."""
    return [r for c in g.cross for r in c.ranks]


def two_level_reducescatter_sum(flat, process_set, islands):
    """Two-level SUM reduce-scatter of ``(n*s,)``: rank r ends with row r,
    as the flat reduce-scatter leaves it."""
    g = _two_level_groups(islands)
    n = process_set.size()
    order = _two_level_row_order(g)
    rows = flat.view(n, -1)[order].reshape(-1)
    local, cross = g.local[g.island], g.cross[g.position]
    part = rows.new_empty(rows.numel() // local.size())
    _reduce_scatter(part, rows, local)
    row = part.new_empty(part.numel() // cross.size())
    _reduce_scatter(row, part, cross)
    return row


def two_level_allgather_row(row, process_set, islands):
    """Inverse of :func:`two_level_reducescatter_sum`: every rank's
    ``(s,)`` row to the ``(n*s,)`` buffer in rank order."""
    import torch

    g = _two_level_groups(islands)
    n = process_set.size()
    local, cross = g.local[g.island], g.cross[g.position]
    part = row.new_empty(row.numel() * cross.size())
    _all_gather(part, row, cross.group)
    full = row.new_empty(part.numel() * local.size())
    _all_gather(full, part, local.group)
    order = _two_level_row_order(g)
    inv = torch.empty(n, dtype=torch.long)
    inv[torch.tensor(order)] = torch.arange(n)
    return full.view(n, -1)[inv.to(row.device)].reshape(-1)


def two_level_alltoall(chunks, process_set, islands):
    """Staged alltoall of per-destination ``(n, ...)`` chunks: an
    exchange within the island (each rank gathers, from every island
    peer, the chunks for the destinations at its own position), then
    across islands among the ranks of that position. A permutation:
    bitwise the flat ``all_to_all`` result."""
    import torch
    import torch.distributed as dist

    from .collective_ops import wait

    g = _two_level_groups(islands)
    local, cross = g.local[g.island], g.cross[g.position]
    L, G = local.size(), cross.size()
    tail = chunks.shape[1:]
    # Stage 1: block l of the input holds the chunks for the G
    # destinations at island position l, in cross-group order.
    x = chunks[[r for c in g.cross for r in c.ranks]].contiguous()
    y = torch.empty_like(x)
    wait(dist.all_to_all_single(y, x, group=local.group, async_op=True))
    # y is (L sources, G destinations): transpose so that block c holds
    # the chunks for cross peer c from every island peer.
    x2 = y.view(L, G, *tail).transpose(0, 1).contiguous()
    y2 = torch.empty_like(x2)
    wait(dist.all_to_all_single(y2, x2, group=cross.group, async_op=True))
    # y2[c, l] came from island peer l of cross peer c.
    sources = [_local_of(g, c).ranks[l] for c in cross.ranks
               for l in range(L)]
    inv = torch.empty(L * G, dtype=torch.long)
    inv[torch.tensor(sources)] = torch.arange(L * G)
    return y2.reshape(L * G, *tail)[inv.to(chunks.device)]


def _local_of(g: _TwoLevelGroups, rank: int) -> _Group:
    """The island subgroup that holds global ``rank``."""
    return next(isl for isl in g.local if rank in isl.ranks)


# -- The dispatchers the wiring calls -----------------------------------------


def apply_allreduce_sum(plan: BucketPlan, flat, process_set):
    """The plan's SUM allreduce of a 1-D tensor (a new tensor; callers
    own the scaling)."""
    if plan.algorithm == "rhd":
        return rhd_allreduce_sum(flat, process_set)
    if plan.algorithm == "two_level":
        return two_level_allreduce_sum(flat, plan.islands)
    raise ValueError(f"no schedule for a {plan.algorithm!r} allreduce plan")


def start_allreduce_sum_(plan: BucketPlan, t, process_set):
    """Run the plan's SUM allreduce into ``t`` (contiguous) in place and
    return a ``Work`` to wait on, as ``dist.all_reduce(async_op=True)``
    returns one."""
    t.view(-1).copy_(apply_allreduce_sum(plan, t.view(-1), process_set))
    return _Done()


def apply_reducescatter_sum(plan: BucketPlan, flat, process_set):
    if plan.algorithm == "rhd":
        return rhd_reducescatter_sum(flat, process_set)
    if plan.algorithm == "two_level":
        return two_level_reducescatter_sum(flat, process_set, plan.islands)
    raise ValueError(
        f"no schedule for a {plan.algorithm!r} reducescatter plan")


def apply_allgather_row(plan: BucketPlan, row, process_set):
    if plan.algorithm == "rhd":
        return rhd_allgather_row(row, process_set)
    if plan.algorithm == "two_level":
        return two_level_allgather_row(row, process_set, plan.islands)
    raise ValueError(f"no schedule for a {plan.algorithm!r} allgather plan")


def apply_alltoall(plan: BucketPlan, x, process_set):
    """The plan's alltoall of ``x`` (dim 0 divisible by the world size):
    bitwise the flat one."""
    if plan.algorithm != "two_level":
        raise ValueError(
            f"no schedule for a {plan.algorithm!r} alltoall plan")
    n = plan.world
    chunks = x.reshape(n, x.shape[0] // n, *x.shape[1:])
    return two_level_alltoall(chunks, process_set,
                              plan.islands).reshape(x.shape)
