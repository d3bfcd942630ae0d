"""The port's link topology (``horovod_tpu_torch/topology.py``) held to the
JAX package's (``horovod_tpu/topology.py``).

The reference classifies the 8-device CPU mesh of ``tests/conftest.py`` and
devices of several processes; the port classifies ranks by host. Through the
map ``ici -> intra_host``, ``dcn -> inter_host`` the two must agree on every
pair, every set, the islands and the pair counts, with and without
``HOROVOD_LINK_CLASS_MAP``. A 2-rank gloo world whose ranks name different
hosts classifies its collectives ``inter_host``.
"""

import itertools
import multiprocessing as mp
import os

import jax
import pytest
import torch

from horovod_tpu import topology as jt
from horovod_tpu_torch import topology as pt

TO_PORT = {"ici": "intra_host", "dcn": "inter_host", "self": "self",
           "mixed": "mixed"}

SPECS = ["0-3;4-7", "0,2;1,3", "0-1", "0-3;3-5", "1;x", "0-9", " ; ", "",
         None]

SETS = [[], [3], [0, 1], [0, 4], [1, 2, 3], [0, 2, 5, 7], [4, 5, 6, 7],
        list(range(8))]


class _Dev:
    """A device of the reference's model: a process index, no coords."""

    platform = "cpu"

    def __init__(self, id, process_index):
        self.id = id
        self.process_index = process_index


def _set_map(monkeypatch, spec):
    if spec is None:
        monkeypatch.delenv("HOROVOD_LINK_CLASS_MAP", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_LINK_CLASS_MAP", spec)


def _hold(port, ref, n):
    for a, b in itertools.product(range(n), repeat=2):
        assert port.link_class(a, b) == TO_PORT[ref.link_class(a, b)], (a, b)
    for ranks in SETS:
        ranks = [r for r in ranks if r < n]
        assert port.set_link_class(ranks) == TO_PORT[
            ref.set_link_class(ranks)], ranks
    assert port.ici_islands() == ref.ici_islands()
    assert port.link_class_matrix() == {
        TO_PORT[k]: v for k, v in ref.link_class_matrix().items()}


@pytest.mark.parametrize("spec", SPECS)
def test_one_host_of_eight_matches_the_cpu_mesh(spec, monkeypatch):
    _set_map(monkeypatch, spec)
    ref = jt.Topology(jax.devices())
    assert ref.size == 8
    _hold(pt.Topology([0] * 8), ref, 8)


@pytest.mark.parametrize("spec", SPECS)
def test_two_hosts_of_four_match_two_processes(spec, monkeypatch):
    _set_map(monkeypatch, spec)
    ref = jt.Topology([_Dev(i, i // 4) for i in range(8)])
    port = pt.Topology([0, 0, 0, 0, 1, 1, 1, 1])
    _hold(port, ref, 8)
    if spec is None:
        assert port.link_class(0, 3) == "intra_host"
        assert port.link_class(3, 4) == "inter_host"
        assert port.ici_islands() == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert port.link_class_matrix() == {"intra_host": 12,
                                            "inter_host": 16}
        assert port.cross_size == 2


@pytest.mark.parametrize("spec", SPECS + ["0-3;4-7;8", "3-1", "0,,1"])
def test_parse_link_class_map_matches(spec):
    assert pt.parse_link_class_map(spec) == jt.parse_link_class_map(spec)


@pytest.mark.parametrize("hosts", [[], [0], [0, 1], [5, 5, 2]])
def test_describe_never_raises(hosts, monkeypatch):
    monkeypatch.setenv("HOROVOD_LINK_CLASS_MAP", "0-1")
    topo = pt.Topology(hosts)
    text = topo.describe()
    assert text.startswith(f"world: {len(hosts)} device rank(s)")
    if len(hosts) < 2:
        assert "links: none" in text
    monkeypatch.delenv("HOROVOD_LINK_CLASS_MAP")
    assert "islands" not in topo.describe()


def test_seeds_are_the_ports_own():
    assert set(pt.LINK_CLASS_SEEDS) == {"intra_host", "inter_host", "mixed",
                                        "self"}
    for port_class, jax_class in (("intra_host", "ici"),
                                  ("inter_host", "dcn"),
                                  ("mixed", "mixed")):
        assert pt.link_seed(port_class) != jt.link_seed(jax_class)
    alpha_intra, beta_intra = pt.link_seed("intra_host")
    alpha_inter, beta_inter = pt.link_seed("inter_host")
    assert 0 < alpha_intra < alpha_inter and 0 < beta_intra < beta_inter
    assert pt.link_seed("nvlink") == pt.link_seed("inter_host")
    assert pt.link_seed("self") == (0.0, 0.0)


def _world_worker(rank, init_file, queue):
    os.environ.update(HOROVOD_NUM_PROCESSES="2",
                      HOROVOD_PROCESS_ID=str(rank), HOROVOD_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE="1", HOROVOD_CROSS_RANK=str(rank))
    os.environ.pop("HOROVOD_LINK_CLASS_MAP", None)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, tracing

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    hvd.allreduce(torch.ones(4))
    spans = tracing.get_tracer().flight_snapshot()
    classes = [sp["args"]["link_class"]
               for step in spans.get("steps", []) + [spans.get("ambient")
                                                     or {}]
               for sp in (step or {}).get("spans", [])
               if sp.get("name") == "allreduce"]
    queue.put(dict(rank=rank, hosts=basics._state.topology.hosts,
                   classes=classes))
    hvd.shutdown()


def test_a_world_of_two_hosts_classifies_its_collectives(tmp_path):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_world_worker,
                         args=(r, str(tmp_path / "init"), queue))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    for _ in procs:
        r = queue.get(timeout=120)
        got[r["rank"]] = r
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    for r in got.values():
        assert r["hosts"] == [0, 1]
        assert r["classes"] == ["inter_host"], r


def test_a_one_rank_world_is_one_host():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics

    hvd.init(device="cpu")
    try:
        topo = basics._state.topology
        assert topo.hosts == [0] and topo.size == 1
        assert topo.set_link_class([0]) == "intra_host"
    finally:
        hvd.shutdown()
    assert basics._state.topology is None
