"""The port's comms planner (``horovod_tpu_torch/ops/comms_planner.py``)
held to the JAX package's (``horovod_tpu/ops/comms_planner.py``).

- Decisions: ``eligible_algorithms``, ``_decide``, ``plan_bucket`` (pins
  included) and ``autotune_candidates`` equal the reference's over ops,
  payloads from 1 KiB to 1 GiB, worlds 2 to 8, regular, ragged and
  single-island layouts, and an empty and a fitted snapshot, under the
  link-class map ``ici -> intra_host``, ``dcn -> inter_host`` and the same
  seeds; costs within 1e-12 relative.
- The schedules run once over four gloo ranks (one spawn for the module):
  ``rhd`` at n = 2, 3 and 4 (process sets of the world) and ``two_level``
  at 2 x 2 islands, for every op; rank r's result is held to row r of
  the reference's function under ``shard_map`` on a sub-mesh of the same
  size: exactly on integer-valued float32 inputs, within 1e-6 relative on
  random ones. The int8 two-level wire within the quantum of
  ``tests/test_torch_quantization.py`` (one per quantization a value
  passes through: four).
- Rank identity: ranks with skewed local fits plan alike (rank 0's
  snapshot), and replan at a generation change.
- Wiring: ``DistributedOptimizer`` steps (allreduce and sharded modes)
  under ``forced("rhd")`` and ``forced("two_level")`` match the flat step;
  with the planner unset nothing is planned; eager collectives and the
  microprobe's per-algorithm passes label their samples by algorithm.
"""

import json
import multiprocessing as mp
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.ops import comms_planner as jcp
from horovod_tpu_torch.ops import comms_planner as tcp

N = 4
ISLANDS = ((0, 1), (2, 3))
TO_PORT = {"ici": "intra_host", "dcn": "inter_host"}
KIB = 1024
PAYLOADS = (KIB, 16 * KIB, 256 * KIB, 4 << 20, 64 << 20, 256 << 20, 1 << 30)
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for key in ("HOROVOD_COMMS_PLANNER", "HOROVOD_LINK_CLASS_MAP",
                "HOROVOD_WORLD_VERSION"):
        monkeypatch.delenv(key, raising=False)
    jcp.reset_for_testing()
    tcp.reset_for_testing()
    yield
    jcp.reset_for_testing()
    tcp.reset_for_testing()


# -- Decisions ----------------------------------------------------------------


def _layouts(n):
    """Regular (two equal islands), ragged and single-island layouts."""
    out = {"single": (tuple(range(n)),),
           "ragged": ((0,), tuple(range(1, n)))}
    if n % 2 == 0:
        out["regular"] = (tuple(range(n // 2)), tuple(range(n // 2, n)))
    return out


def _fitted_snapshot(port):
    """Ready fits of flat, rhd and two_level under the worst class of a
    split fabric and of one island."""
    snap = {}
    for op in jcp.PLANNER_OPS:
        for cls, scale in (("dcn", 1.0), ("ici", 0.1)):
            cls = TO_PORT[cls] if port else cls
            snap[f"{op}|flat|{cls}"] = (2e-5 * scale, 4e-11 * scale)
            snap[f"{op}|rhd|{cls}"] = (8e-6 * scale, 6e-11 * scale)
            snap[f"{op}|two_level|{cls}"] = (5e-5 * scale, 1e-11 * scale)
    return snap


@pytest.fixture
def same_seeds(monkeypatch):
    """The reference prices from the port's seeds, by the class map."""
    from horovod_tpu_torch.topology import link_seed

    monkeypatch.setattr(jcp, "_seed",
                        lambda cls: link_seed(TO_PORT.get(cls, cls)))


def _same_costs(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0.0), k


@pytest.mark.parametrize("world", range(2, 9))
def test_decisions_match_the_reference(world, same_seeds):
    for layout in _layouts(world).values():
        for op in jcp.PLANNER_OPS:
            for cands in (None, ("flat", "two_level")):
                assert tcp.eligible_algorithms(op, world, layout, cands) == \
                    jcp.eligible_algorithms(op, world, layout, cands)
            for fitted in (False, True):
                jsnap = _fitted_snapshot(False) if fitted else {}
                tsnap = _fitted_snapshot(True) if fitted else {}
                for nbytes in PAYLOADS:
                    ja, jp, jc = jcp._decide(op, nbytes, world, layout,
                                             jsnap, None)
                    ta, tp, tc = tcp._decide(op, nbytes, world, layout,
                                             tsnap, None)
                    assert (ta, tp) == (ja, jp), (op, nbytes, layout)
                    _same_costs(tc, jc)


@pytest.mark.parametrize("pin", [None, "flat", "rhd", "two_level", "auto"])
@pytest.mark.parametrize("world", [2, 3, 4, 6, 8])
def test_plan_bucket_and_candidates_match_the_reference(
        world, pin, same_seeds, monkeypatch):
    """``plan_bucket`` through the env pin and the autotune pin (and
    ``auto`` as both), and ``autotune_candidates``, over each layout."""
    from horovod_tpu import autotune as jat
    from horovod_tpu_torch import autotune as tat

    for name, layout in _layouts(world).items():
        for mod in (jcp, tcp):
            monkeypatch.setattr(mod, "_islands_for",
                                lambda n, layout=layout: layout)
            mod.reset_for_testing()
        monkeypatch.setenv("HOROVOD_COMMS_PLANNER", pin or "auto")
        jat.set_tuned_algorithm(None)
        tat.set_tuned_algorithm(None)
        try:
            for use_tuner in (False, True):
                if use_tuner and pin is not None:
                    monkeypatch.setenv("HOROVOD_COMMS_PLANNER", "auto")
                    jat.set_tuned_algorithm(pin)
                    tat.set_tuned_algorithm(pin)
                for op in jcp.PLANNER_OPS:
                    for nbytes in PAYLOADS:
                        want = jcp.plan_bucket(op, nbytes, world)
                        got = tcp.plan_bucket(op, nbytes, world)
                        assert (got.algorithm, got.provenance) == (
                            want.algorithm, want.provenance), (
                            name, op, nbytes, use_tuner)
                        _same_costs(got.costs, want.costs)
                assert tcp.autotune_candidates(world) == \
                    jcp.autotune_candidates(world)
        finally:
            jat.set_tuned_algorithm(None)
            tat.set_tuned_algorithm(None)


def test_planner_off_plans_nothing():
    assert tcp.plan_bucket("allreduce", 1 << 20, N) is None
    assert tcp.planned_algorithm("allreduce", 1 << 20, N) == "flat"
    assert tcp.autotune_candidates(N) is None
    assert tcp.summary() == {"enabled": False, "mode": None,
                             "generation": None, "replans": 0}


def test_forced_wins_and_rejects_unknown_names(monkeypatch):
    monkeypatch.setenv("HOROVOD_COMMS_PLANNER", "auto")
    monkeypatch.setattr(tcp, "_islands_for", lambda n: ISLANDS)
    with tcp.forced("rhd"):
        plan = tcp.plan_bucket("allreduce", 1 << 20, N)
    assert (plan.algorithm, plan.provenance) == ("rhd", "forced")
    with tcp.forced("rhd"):
        plan = tcp.plan_bucket("alltoall", 1 << 20, N)
    assert (plan.algorithm, plan.provenance) == ("flat", "forced:ineligible")
    with pytest.raises(ValueError, match="unknown algorithm"):
        tcp.forced("ring")


# -- Four gloo ranks ----------------------------------------------------------

BLOCK = 1024


def _inputs():
    rng = np.random.RandomState(0)
    return {
        "ar_int": rng.randint(-8, 9, size=(N, 999)).astype(np.float32),
        "ar_rnd": rng.randn(N, 1237).astype(np.float32),
        "rs_int": rng.randint(-8, 9, size=(N, N * 37)).astype(np.float32),
        "rs_rnd": rng.randn(N, N * 37).astype(np.float32),
        "ag_int": rng.randint(-8, 9, size=(N, 23)).astype(np.float32),
        "ag_rnd": rng.randn(N, 23).astype(np.float32),
        "a2a_rnd": rng.randn(N, N * 5, 3).astype(np.float32),
        "int8": rng.randn(N, 4 * BLOCK + 100).astype(np.float32),
    }


def _tiny_model(torch):
    torch.manual_seed(3)
    return torch.nn.Sequential(torch.nn.Linear(16, 33), torch.nn.Tanh(),
                               torch.nn.Linear(33, 5))


def _opt_step(hvd, torch, rank, sync_mode):
    """One SGD step of the tiny model on this rank's batch; the updated
    parameters."""
    model = _tiny_model(torch)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.5), sync_mode=sync_mode,
        fusion_threshold_bytes=512)
    g = torch.Generator().manual_seed(10 + rank)
    x = torch.randn(7, 16, generator=g)
    model(x).square().mean().backward()
    opt.step()
    return [p.detach().clone().numpy() for p in model.parameters()]


def _skewed_fits(cm, rank):
    """Ready allreduce fits under ``inter_host``: rank 0 measured flat
    cheap and two_level slow, the others the opposite."""
    model = cm.get_model()
    cheap, slow = (1e-6, 1e-12), (1e-3, 1e-9)
    flat, two = (cheap, slow) if rank == 0 else (slow, cheap)
    for nbytes in (4096, 1 << 20):
        for _ in range(4):
            model.observe("allreduce", "flat", "inter_host", nbytes,
                          flat[0] + flat[1] * nbytes)
            model.observe("allreduce", "two_level", "inter_host", nbytes,
                          two[0] + two[1] * nbytes)


def _worker(rank, init_file, out_dir):
    os.environ["HOROVOD_NUM_PROCESSES"] = str(N)
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import comms_model as cm
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.ops import comms_planner as cp
    from horovod_tpu_torch.ops import quantization as tq

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    world = hvd.global_process_set
    sets = {2: hvd.add_process_set([0, 1]), 3: hvd.add_process_set([0, 1, 2]),
            4: world}
    x = {k: torch.from_numpy(v[rank]) for k, v in _inputs().items()}
    res, info = {}, {}
    # rhd: the allreduce at n = 2, 3, 4; the halves at n = 2, 4.
    for n, ps in sets.items():
        if rank >= n:
            continue
        for kind in ("int", "rnd"):
            res[f"rhd_ar{n}_{kind}"] = cp.rhd_allreduce_sum(
                x[f"ar_{kind}"], ps).numpy()
            if n != 3:
                rs = x[f"rs_{kind}"][:n * 37]
                res[f"rhd_rs{n}_{kind}"] = cp.rhd_reducescatter_sum(
                    rs, ps).numpy()
                res[f"rhd_ag{n}_{kind}"] = cp.rhd_allgather_row(
                    x[f"ag_{kind}"], ps).numpy()
    # two_level on 2 x 2 islands.
    os.environ["HOROVOD_LINK_CLASS_MAP"] = "0-1;2-3"
    islands = cp._islands_for(N)
    info["islands"] = [list(i) for i in islands]
    for kind in ("int", "rnd"):
        res[f"tl_ar_{kind}"] = cp.two_level_allreduce_sum(
            x[f"ar_{kind}"], islands).numpy()
        res[f"tl_rs_{kind}"] = cp.two_level_reducescatter_sum(
            x[f"rs_{kind}"], world, islands).numpy()
        res[f"tl_ag_{kind}"] = cp.two_level_allgather_row(
            x[f"ag_{kind}"], world, islands).numpy()
    plan = cp.BucketPlan("alltoall", "two_level", 0, N, islands, "forced", {})
    res["tl_a2a"] = cp.apply_alltoall(plan, x["a2a_rnd"], world).numpy()
    res["flat_a2a"] = hvd.alltoall(x["a2a_rnd"]).numpy()
    res["int8_tl"] = tq.int8_two_level_allreduce_flat(
        x["int8"], world, islands, "average", salt=5).numpy()
    res["int8_flat"] = tq.int8_allreduce_flat(
        x["int8"], world, "average", salt=5).numpy()

    # Rank identity: skewed local fits, one exchange per generation.
    os.environ["HOROVOD_COMMS_PLANNER"] = "auto"
    cm.reset_for_testing()
    cp.reset_for_testing()
    _skewed_fits(cm, rank)
    info["local_snapshot"] = cp._local_snapshot()
    cp.prepare()
    sizes = [1 << k for k in range(10, 28, 3)]
    info["plans"] = [cp.plan_bucket("allreduce", s, N).algorithm
                     for s in sizes]
    info["provenance"] = cp.plan_bucket("allreduce", sizes[-1],
                                        N).provenance
    info["replans_before"] = cp.summary()["replans"]
    os.environ["HOROVOD_WORLD_VERSION"] = "2"
    cm.reset_for_testing()
    _skewed_fits(cm, (rank + 1) % N)  # rank 0 now holds the other fits
    cp.prepare()
    info["plans_gen2"] = [cp.plan_bucket("allreduce", s, N).algorithm
                          for s in sizes]
    info["replans_after"] = cp.summary()["replans"]
    info["generation"] = cp.summary()["generation"]

    # Wiring: the optimizer's flushes under each schedule.
    os.environ.pop("HOROVOD_COMMS_PLANNER")
    cm.reset_for_testing()
    cp.reset_for_testing()
    metrics.reset_for_testing()
    for mode in ("allreduce", "sharded"):
        for i, p in enumerate(_opt_step(hvd, torch, rank, mode)):
            res[f"{mode}_off_{i}"] = p
    info["off_plans"] = len(cp._plans)
    info["off_dispatch"] = metrics.PLANNER_DISPATCH.dump()["samples"]
    os.environ["HOROVOD_COMMS_PLANNER"] = "auto"
    for algorithm in ("flat", "rhd", "two_level"):
        with cp.forced(algorithm):
            for mode in ("allreduce", "sharded"):
                for i, p in enumerate(_opt_step(hvd, torch, rank, mode)):
                    res[f"{mode}_{algorithm}_{i}"] = p
    info["dispatch"] = {
        f"{s['labels']['op']}|{s['labels']['algorithm']}": s["value"]
        for s in metrics.PLANNER_DISPATCH.dump()["samples"]}

    # Eager collectives and the microprobe label their samples.
    cm.reset_for_testing()
    os.environ["HOROVOD_COMMS_PLANNER"] = "two_level"
    res["eager_ar"] = hvd.allreduce(x["ar_int"], op=hvd.Sum).numpy()
    res["eager_rs"] = hvd.reducescatter(x["rs_int"], op=hvd.Sum).numpy()
    res["eager_ag"] = hvd.allgather(x["ag_int"]).numpy()
    res["eager_a2a"] = hvd.alltoall(x["a2a_rnd"]).numpy()
    info["eager_fits"] = sorted(cm.get_model().payload()["fits"])
    os.environ["HOROVOD_COMMS_PLANNER"] = "auto"
    cm.reset_for_testing()
    probe = hvd.run_comms_microprobe(sizes=(4096, 65536), repeats=2)
    info["probe_keys"] = {op: sorted(v) for op, v in probe.items()}
    info["probe_fits"] = sorted(cm.get_model().payload()["fits"])
    info["describe"] = hvd.topology.Topology(
        [0, 0, 1, 1], rank).describe()

    # The sync-mode sweep under a clock that makes each rank time the
    # modes differently: every rank pins rank 0's fastest.
    import time

    from horovod_tpu_torch import autotune

    clock = [0.0]
    real = time.perf_counter
    cost = {"allreduce": 1.0, "sharded": 2.0, "fsdp": 3.0}
    if rank:
        cost = {"allreduce": 3.0, "sharded": 2.0, "fsdp": 1.0}

    def build(mode):
        def run():
            clock[0] += cost[mode]
            return torch.zeros(1)
        return run

    time.perf_counter = lambda: clock[0]
    try:
        info["sync_pick"] = autotune.tune_step_sync_mode(build)
    finally:
        time.perf_counter = real
    info["sync_pin"] = autotune.tuned_sync_mode()

    # An optimizer on a subset, built by its members alone, makes no
    # exchange over the world (the planner plans the global set only).
    os.environ["HOROVOD_COMMS_PLANNER"] = "auto"
    cp.reset_for_testing()
    if rank in (0, 1):
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(_tiny_model(torch).parameters(), lr=0.1),
            process_set=sets[2])
        opt.remove_hooks()
    info["subset_snapshot"] = cp._snapshot
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    hvd.shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_comms_planner")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp / "rendezvous"), str(tmp)))
             for r in range(N)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs])
    out = []
    for r in range(N):
        with open(tmp / f"rank{r}.json") as f:
            out.append((dict(np.load(tmp / f"rank{r}.npz")), json.load(f)))
    return out


def _jax_rows(fn, x, n):
    """``fn`` on each row of ``x`` under shard_map over n CPU devices."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("w",))
    wrapped = jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                            in_specs=P("w"), out_specs=P("w"),
                            check_vma=False)
    return np.asarray(jax.jit(wrapped)(x[:n]))


def _plan(op, algorithm, n):
    return jcp.BucketPlan(op, algorithm, 0, n, ISLANDS, "forced", {})


def _hold(got, want, kind, what):
    if kind == "int":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL,
                                   err_msg=what)


def _want(op, algorithm, n, x):
    if op == "ar":
        return _jax_rows(lambda v: jcp.apply_allreduce_sum(
            _plan("allreduce", algorithm, n), v, "w"), x, n)
    if op == "rs":
        return _jax_rows(lambda v: jcp.apply_reducescatter_sum(
            _plan("reducescatter", algorithm, n), v, "w"), x[:, :n * 37], n)
    return _jax_rows(lambda v: jcp.apply_allgather_row(
        _plan("allgather", algorithm, n), v, "w"), x, n)


@pytest.mark.parametrize("kind", ["int", "rnd"])
@pytest.mark.parametrize("op,n", [("ar", 2), ("ar", 3), ("ar", 4),
                                  ("rs", 2), ("rs", 4), ("ag", 2),
                                  ("ag", 4)])
def test_rhd_matches_the_reference(ranks, op, n, kind):
    x = _inputs()[f"{op}_{kind}"]
    want = _want(op, "rhd", n, x)
    for r in range(n):
        _hold(ranks[r][0][f"rhd_{op}{n}_{kind}"], want[r], kind,
              f"rhd {op} n={n} rank {r}")
    if kind == "int" and op == "ar":
        np.testing.assert_array_equal(want[0], x[:n].sum(0))


@pytest.mark.parametrize("kind", ["int", "rnd"])
@pytest.mark.parametrize("op", ["ar", "rs", "ag"])
def test_two_level_matches_the_reference(ranks, op, kind):
    assert ranks[0][1]["islands"] == [list(i) for i in ISLANDS]
    x = _inputs()[f"{op}_{kind}"]
    want = _want(op, "two_level", N, x)
    for r in range(N):
        _hold(ranks[r][0][f"tl_{op}_{kind}"], want[r], kind,
              f"two_level {op} rank {r}")


def test_two_level_alltoall_is_the_flat_permutation(ranks):
    x = _inputs()["a2a_rnd"]
    want = _jax_rows(lambda v: jcp.apply_alltoall(
        _plan("alltoall", "two_level", N), v, "w"), x, N)
    for r in range(N):
        np.testing.assert_array_equal(ranks[r][0]["tl_a2a"], want[r])
        np.testing.assert_array_equal(ranks[r][0]["tl_a2a"],
                                      ranks[r][0]["flat_a2a"])


def test_int8_two_level_within_the_quantum(ranks):
    """Each value passes four quantizations (the island's exchange, the
    cross allreduce's two, the island's gather): within four quanta of
    the reference's two-level wire and of the mean; rank-identical."""
    from horovod_tpu.ops.quantization import int8_two_level_allreduce_flat

    x = _inputs()["int8"]
    want = _jax_rows(lambda v: int8_two_level_allreduce_flat(
        v, "w", ISLANDS, op="average", salt=np.uint32(5)), x, N)
    quantum = np.abs(x).max() / 127.0
    for r in range(N):
        got = ranks[r][0]["int8_tl"]
        assert np.abs(got - want[r]).max() <= 4.0001 * quantum
        assert np.abs(got - x.mean(0)).max() <= 4.0001 * quantum
        np.testing.assert_array_equal(got, ranks[0][0]["int8_tl"])


def test_skewed_local_fits_plan_alike(ranks):
    """Every rank plans from rank 0's snapshot: its plans are rank 0's
    local decisions, on every rank, in both generations."""
    snap0 = ranks[0][1]["local_snapshot"]
    assert ranks[1][1]["local_snapshot"] != snap0
    sizes = [1 << k for k in range(10, 28, 3)]
    want = [tcp._decide("allreduce", s, N, ISLANDS, snap0, None)[0]
            for s in sizes]
    assert set(want) == {"flat"}
    for r in range(N):
        info = ranks[r][1]
        assert info["plans"] == want, r
        assert info["provenance"] == "model"
        # Generation 2: rank 0 holds the other fits, and every rank
        # replans from them once.
        assert info["plans_gen2"] == ["two_level"] * len(sizes), r
        assert (info["replans_before"], info["replans_after"]) == (0, 1)
        assert info["generation"] == "2"


@pytest.mark.parametrize("mode", ["allreduce", "sharded"])
@pytest.mark.parametrize("algorithm", ["flat", "rhd", "two_level"])
def test_optimizer_step_under_each_schedule_matches_flat(ranks, mode,
                                                         algorithm):
    """Float sums in another order: within 1e-6 relative of the planner-
    off step, and the same on every rank."""
    res0 = ranks[0][0]
    n_params = len([k for k in res0 if k.startswith(f"{mode}_off_")])
    assert n_params == 4
    for r in range(N):
        res = ranks[r][0]
        for i in range(n_params):
            got = res[f"{mode}_{algorithm}_{i}"]
            np.testing.assert_allclose(got, res0[f"{mode}_off_{i}"],
                                       rtol=RTOL, atol=RTOL)
            np.testing.assert_array_equal(
                got, res0[f"{mode}_{algorithm}_{i}"])


def test_planner_off_plans_and_counts_nothing(ranks):
    for _, info in ranks:
        assert info["off_plans"] == 0
        assert sum(s["value"] for s in info["off_dispatch"]) == 0
        dispatch = info["dispatch"]
        # Each forced schedule ran the buckets of both modes' halves.
        for key in ("allreduce|rhd", "allreduce|two_level",
                    "reducescatter|rhd", "reducescatter|two_level",
                    "allgather|rhd", "allgather|two_level",
                    "allreduce|flat"):
            assert dispatch.get(key, 0) > 0, (key, dispatch)


def test_eager_collectives_run_and_label_the_schedule(ranks):
    x = _inputs()
    for r, (res, info) in enumerate(ranks):
        np.testing.assert_array_equal(res["eager_ar"], x["ar_int"].sum(0))
        np.testing.assert_array_equal(
            res["eager_rs"], x["rs_int"].sum(0).reshape(N, -1)[r])
        np.testing.assert_array_equal(res["eager_ag"],
                                      x["ag_int"].reshape(-1))
        np.testing.assert_array_equal(res["eager_a2a"], res["flat_a2a"])
        for op in ("allreduce", "reducescatter", "allgather", "alltoall"):
            assert f"{op}|two_level|inter_host" in info["eager_fits"], op


def test_microprobe_seeds_each_schedule_and_returns_flat(ranks):
    for _, info in ranks:
        fits = set(info["probe_fits"])
        for op, algos in (("allreduce", ("flat", "rhd", "two_level")),
                          ("reducescatter", ("flat", "rhd", "two_level")),
                          ("allgather", ("flat", "rhd", "two_level")),
                          ("alltoall", ("flat", "two_level"))):
            for a in algos:
                assert f"{op}|{a}|inter_host" in fits, (op, a)
        assert "alltoall|rhd|inter_host" not in fits
        assert info["probe_keys"]["allreduce"] == [4 * 4096, 4 * 65536]


def test_topology_describe_carries_the_plans(ranks):
    text = ranks[0][1]["describe"]
    assert "planner: auto" in text
    assert "allreduce@inter_host:" in text and "16384KiB->" in text


def test_sync_mode_sweep_pins_rank_0s_choice_on_every_rank(ranks):
    """Rank 0 times allreduce fastest, the others fsdp: every rank pins
    allreduce (the reference would pin each rank's own)."""
    assert [info["sync_pick"] for _, info in ranks] == ["allreduce"] * N
    assert [info["sync_pin"] for _, info in ranks] == ["allreduce"] * N


def test_an_optimizer_on_a_subset_makes_no_world_exchange(ranks):
    """Ranks 0 and 1 build an optimizer on their set alone with the
    planner on: nothing is exchanged (ranks 2 and 3 never join), and the
    run goes on to its end."""
    assert [info["subset_snapshot"] for _, info in ranks] == [None] * N


def test_the_port_imports_no_jax():
    code = ("import sys, horovod_tpu_torch.ops.comms_planner as cp, "
            "horovod_tpu_torch.autotune as at; "
            "assert 'torch' not in sys.modules; "
            "import horovod_tpu_torch.optimizer, "
            "horovod_tpu_torch.parallel.data_parallel; "
            "cp.plan_bucket('allreduce', 1 << 20, 4); "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'horovod_tpu.')) "
            "or m == 'horovod_tpu']; assert not bad, bad")
    env = dict(os.environ, HOROVOD_COMMS_PLANNER="auto")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.dirname(os.path.dirname(__file__)),
                   timeout=120)
