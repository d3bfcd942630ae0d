"""Link classification: which kind of link joins two ranks.

Port of ``horovod_tpu/topology.py``'s link-classification leg: the seeds
``LINK_CLASS_SEEDS`` and :func:`link_seed` (:31-50),
:func:`parse_link_class_map` and ``HOROVOD_LINK_CLASS_MAP`` (:53), and
:class:`Topology`'s ``link_class``, ``set_link_class``, ``ici_islands``,
``link_class_matrix`` and ``describe`` (:212-388). These are the
``link_class`` labels of the alpha-beta cost model (``comms_model.py``) and
of every eager collective's span.

The port's link classes:

- ``intra_host``: two ranks on one host (the counterpart of the TPU's
  ``ici``). The port does not know whether two cards of a host share
  NVLink or PCIe; what it can confirm is the host.
- ``inter_host``: two ranks on different hosts, over the network (the
  counterpart of ``dcn``).
- ``self`` (one rank with itself) and ``mixed`` (a flat alltoall whose
  traffic is part of each), as in the reference.

A rank's host is its ``cross_rank``: the launcher's or the rendezvous
server's assignment (``HOROVOD_CROSS_RANK``), else ``rank // local_size``
(``basics.init``), gathered from every rank through the group's store
when the world forms.

No counterpart: ``sorted_devices``, ``_device_sort_key`` and
``device_coords``, which order TPU chips by their torus coordinates into
the rank order. A port rank is a process that the launcher placed on one
card; the launcher's order is the rank order. ``describe`` renders no mesh
lines (they wait for a port of the 2-D mesh); its plan lines are the comms
planner's (``ops.comms_planner.describe_plans``).

Stdlib-only at import.
"""

from __future__ import annotations

import os
from typing import Sequence

#: The link classes of two ranks on one host and on different hosts.
INTRA_HOST = "intra_host"
INTER_HOST = "inter_host"

#: Per-link-class alpha-beta seeds ``{class: (alpha_s, beta_s_per_byte)}``:
#: the prices a comms planner uses before the online model has a ready fit
#: for a key. Only the ratio between classes decides a crossover, and the
#: live fit replaces a seed as soon as it is ready.
LINK_CLASS_SEEDS: dict[str, tuple[float, float]] = {
    # Fitted by ``python3 chip_diag.py comms``: the cluster merge of
    # run_comms_microprobe's allreduce fits over 4 ranks, 4 KB to 256 MB a
    # rank, on 4 x NVIDIA H100 80GB HBM3 of one host at a 700.00 W power
    # limit (PERF.md; r2 0.9996). Bytes are the world's payload;
    # the times are the card's (the probe's calls queue behind a spin).
    INTRA_HOST: (2.29e-5, 1.25e-12),
    # Not measured: no run of this repository has had two hosts. A stated
    # prior: the intra-host alpha and 50 us of network latency, and a
    # 200 Gb/s port's 25 GB/s of payload.
    INTER_HOST: (7.29e-5, 1.0 / 25e9),
    # A flat alltoall on a world of several hosts moves part of its bytes
    # within hosts and part across: its seed lies between the two.
    "mixed": (4.79e-5, 2.06e-11),
    "self": (0.0, 0.0),
}


def link_seed(link_class: str) -> tuple[float, float]:
    """The seed ``(alpha_s, beta_s_per_byte)`` of a link class (an unknown
    class prices as ``inter_host``, the conservative choice)."""
    return LINK_CLASS_SEEDS.get(str(link_class), LINK_CLASS_SEEDS[INTER_HOST])


def parse_link_class_map(spec: str) -> list[list[int]] | None:
    """Parse ``HOROVOD_LINK_CLASS_MAP``: semicolon-separated islands, each
    a comma-separated list of global ranks and ``a-b`` ranges. ``"0-3;4-7"``
    declares two 4-rank hosts whose links within are ``intra_host`` and
    across are ``inter_host``; tests and benches use it to emulate a
    fabric of several hosts. None for an empty or invalid spec (an invalid
    map never fails ``init()``: the classification then comes from the
    hosts)."""
    spec = (spec or "").strip()
    if not spec:
        return None
    islands: list[list[int]] = []
    seen: set[int] = set()
    try:
        for part in spec.split(";"):
            ranks: list[int] = []
            for item in part.split(","):
                item = item.strip()
                if not item:
                    continue
                if "-" in item:
                    lo, hi = item.split("-", 1)
                    ranks.extend(range(int(lo), int(hi) + 1))
                else:
                    ranks.append(int(item))
            if not ranks:
                return None
            if seen & set(ranks):
                return None  # overlapping islands: malformed
            seen.update(ranks)
            islands.append(sorted(ranks))
    except ValueError:
        return None
    return islands if islands else None


class Topology:
    """The link structure of a world: ``hosts[r]`` is rank r's host index.

    ``basics.init()`` builds one (``basics._state.topology``) from every
    rank's ``cross_rank``; a test builds one from any host list."""

    def __init__(self, hosts: Sequence[int], rank: int = 0):
        self.hosts: list[int] = [int(h) for h in hosts]
        self.num_devices: int = len(self.hosts)
        self.rank: int = int(rank)

    @property
    def size(self) -> int:
        return self.num_devices

    @property
    def cross_size(self) -> int:
        return len(set(self.hosts))

    def link_class_map(self) -> list[list[int]] | None:
        """The ``HOROVOD_LINK_CLASS_MAP`` islands covering this world, or
        None (no map, an invalid one, or one that names ranks outside the
        world). Read at each call, so a map set after ``init()`` applies,
        and parsed once per distinct value."""
        raw = os.environ.get("HOROVOD_LINK_CLASS_MAP", "")
        cached = getattr(self, "_lcm_cache", None)
        if cached is not None and cached[0] == raw:
            return cached[1]
        islands = parse_link_class_map(raw)
        if islands is not None:
            covered = {r for isl in islands for r in isl}
            if not covered <= set(range(self.num_devices)):
                islands = None  # names ranks this world does not have
        self._lcm_cache = (raw, islands)
        return islands

    def ici_islands(self) -> list[list[int]]:
        """Ranks grouped into islands whose links are all ``intra_host``
        (the reference's name: its islands are ICI-connected slices; the
        port's are hosts). The map wins, and ranks it omits become islands
        of one; otherwise the ranks group by host, the fact
        :meth:`link_class` classifies by."""
        mapped = self.link_class_map()
        if mapped is not None:
            covered = {r for isl in mapped for r in isl}
            extras = [[r] for r in range(self.num_devices)
                      if r not in covered]
            return [list(isl) for isl in mapped] + extras
        by_host: dict[int, list[int]] = {}
        for r, h in enumerate(self.hosts):
            by_host.setdefault(h, []).append(r)
        return [sorted(v) for _, v in sorted(by_host.items())]

    def link_class(self, rank_a: int, rank_b: int) -> str:
        """``self`` (one rank), ``intra_host`` (one host, or one island of
        the map) or ``inter_host``."""
        if rank_a == rank_b:
            return "self"
        mapped = self.link_class_map()
        if mapped is not None:
            for island in mapped:
                if rank_a in island:
                    return INTRA_HOST if rank_b in island else INTER_HOST
            return INTER_HOST  # ranks the map omits: the conservative class
        if self.hosts[rank_a] == self.hosts[rank_b]:
            return INTRA_HOST
        return INTER_HOST

    def set_link_class(self, ranks: Sequence[int]) -> str:
        """The worst class a process set's ranks span (what its flat
        collectives are bound by): ``inter_host`` if any member pair
        crosses hosts, else ``intra_host``. A set of zero or one rank
        classifies as ``intra_host``: its collective is local."""
        ranks = list(ranks)
        if len(ranks) < 2:
            return INTRA_HOST
        anchor = ranks[0]
        for r in ranks[1:]:
            if self.link_class(anchor, r) == INTER_HOST:
                return INTER_HOST
        return INTRA_HOST

    def link_class_matrix(self) -> dict[str, int]:
        """Unordered rank-pair counts by link class; empty for a world of
        fewer than two ranks."""
        counts: dict[str, int] = {}
        for i in range(self.num_devices):
            for j in range(i + 1, self.num_devices):
                cls = self.link_class(i, j)
                counts[cls] = counts.get(cls, 0) + 1
        return counts

    def describe(self) -> str:
        """A few lines: ranks and hosts, pair counts by link class, the
        map's islands when one is set, and each rank's host. Never
        raises, on a world of one rank or none too."""
        lines = [f"world: {self.size} device rank(s) across "
                 f"{self.cross_size} host(s)"]
        matrix = self.link_class_matrix()
        if matrix:
            pairs = " ".join(f"{cls}={n}"
                             for cls, n in sorted(matrix.items()))
            lines.append(f"links: {pairs}")
        else:
            lines.append("links: none (degenerate single-rank world)")
        if self.link_class_map() is not None:
            lines.append(
                "islands (HOROVOD_LINK_CLASS_MAP): "
                + " ".join("[" + ",".join(map(str, isl)) + "]"
                           for isl in self.ici_islands()))
        # The comms planner's view: the algorithm it plans per op at two
        # payloads over these islands (rank-local; one line when off).
        try:
            from .ops.comms_planner import describe_plans

            lines.extend(describe_plans(self))
        except Exception:  # noqa: BLE001 — describe never raises
            pass
        for r, h in enumerate(self.hosts):
            lines.append(f"  rank {r}: host={h}")
        return "\n".join(lines)
