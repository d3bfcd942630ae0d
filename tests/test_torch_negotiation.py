"""The port's negotiated runtime (horovod_tpu_torch.runtime) against the JAX
package's native runtime (horovod_tpu.runtime.NativeWorld), at 2 and 4
processes over localhost.

Each process runs one per-rank script twice: first through the reference's
``NativeWorld`` on numpy arrays (its TCP ring), then through the port's
negotiated world on CPU torch tensors (``hvd.init(device="cpu")``: the
star to rank 0 and a gloo group), with inputs made from seeds with numpy.
The parent holds the port's results to the reference's: bit for bit on
integer payloads, within 1e-6 relative on floating ones; the cache's hits
and misses of the same steps; the stall report's text. The port alone
shows its eager API negotiating by name and a peer's death raising
``HorovodInternalError``. ``test_torch_join.py`` runs the same script for
``join``, the cross-rank stall watch and the online autotuner.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(r'''
    import json, os, sys, time
    import numpy as np
    sys.path.insert(0, os.environ["REPO_ROOT"])
    import ml_dtypes

    rank = int(os.environ["TEST_RANK"]); size = int(os.environ["TEST_SIZE"])
    modes = os.environ["TEST_MODE"].split(",")
    BF16 = np.dtype(ml_dtypes.bfloat16)

    class Ref:
        """The JAX package's NativeWorld, numpy in and out."""
        name = "ref"

        def __init__(self):
            from horovod_tpu.runtime import NativeWorld
            self.w = NativeWorld(rank, size, "127.0.0.1",
                                 int(os.environ["TEST_PORT"]), timeout_s=30.0)

        def __getattr__(self, item):
            return getattr(self.w, item)

    class Port:
        """The port's negotiated world, numpy in and out."""
        name = "port"

        def __init__(self):
            import torch
            import horovod_tpu_torch as hvd
            self.torch, self.hvd = torch, hvd
            hvd.init(device="cpu",
                     init_method="file://" + os.environ["TEST_RDV"])
            self.w = hvd.basics.negotiated_world()

        def t(self, x):
            x = np.asarray(x)
            if x.dtype == BF16:
                return self.torch.from_numpy(
                    x.astype(np.float32)).to(self.torch.bfloat16)
            return self.torch.from_numpy(np.ascontiguousarray(x)).clone()

        def n(self, t):
            if t.dtype == self.torch.bfloat16:
                return t.float().numpy().astype(BF16)
            return t.numpy()

        def allreduce(self, x, name=None, op="average", **kw):
            return self.n(self.w.allreduce(self.t(x), name, op=op, **kw))

        def allreduce_async_(self, x, name=None, op="average", **kw):
            return self.w.allreduce_async(self.t(x), name, op=op, **kw)

        def synchronize(self, h):
            return self.n(self.w.synchronize(h))

        def grouped_allreduce(self, xs, name=None, op="average", **kw):
            return [self.n(o) for o in self.w.grouped_allreduce(
                [self.t(x) for x in xs], name=name, op=op, **kw)]

        def allgather(self, x, name=None, **kw):
            return self.n(self.w.allgather(self.t(x), name, **kw))

        def broadcast(self, x, root, name=None, **kw):
            return self.n(self.w.broadcast(self.t(x), root, name, **kw))

        def alltoall(self, x, name=None, **kw):
            return self.n(self.w.alltoall(self.t(x), name, **kw))

        def alltoall_v(self, x, splits, name=None, process_set_id=0,
                       members=None):
            out, rec = self.w.alltoall_v(self.t(x), splits, name=name,
                                         process_set_id=process_set_id)
            return self.n(out), rec.numpy()

        def reducescatter(self, x, name=None, op="sum", **kw):
            return self.n(self.w.reducescatter(self.t(x), name, op=op, **kw))

        def shutdown(self):
            self.hvd.shutdown()

        def __getattr__(self, item):
            return getattr(self.w, item)

    def run(w, R):
        def rec(key, value):
            if isinstance(value, (list, tuple)):
                for i, v in enumerate(value):
                    rec(f"{key}.{i}", v)
                return
            a = np.asarray(value)
            if a.dtype in (BF16, np.float16):
                a = a.astype(np.float32)
            R[key] = {"dtype": str(a.dtype), "value": a.tolist()}

        Rk = np.arange(size)
        if "battery" in modes:
            rec("ar.sum", w.allreduce(np.arange(8, dtype=np.float32) + rank,
                                      "ar.sum", op="sum"))
            rec("ar.avg.prescale", w.allreduce(
                np.full((5,), float(rank + 1), np.float64), "ar.avg",
                op="average", prescale_factor=2.0))
            xi = np.array([rank, -rank, 100], np.int32)
            rec("ar.min", w.allreduce(xi, "ar.min", op="min"))
            rec("ar.max", w.allreduce(xi, "ar.max", op="max"))
            rec("ar.f16", w.allreduce(np.full((4,), 0.5, np.float16),
                                      "ar.f16", op="sum"))
            rec("ar.bf16", w.allreduce(np.full((6,), 1.5, BF16), "ar.bf16",
                                       op="sum"))
            rec("ar.i64", w.allreduce(np.full((3,), 2**33, np.int64) + rank,
                                      "ar.i64", op="sum"))
            rec("ar.u8.max", w.allreduce(np.full((4,), 100 + rank, np.uint8),
                                         "ar.u8", op="max"))
            rec("ar.i32.avg.postscale", w.allreduce(
                np.array([3 * rank + 1, -7, 5, rank], np.int32), "ar.i32avg",
                op="average", postscale_factor=3.0))
            # Positive summands: the ring's and gloo's summation orders
            # then agree within a few float32 roundings of the result.
            rng = np.random.default_rng(100 + rank)
            rec("ar.f32.avg.random", w.allreduce(
                rng.uniform(0.5, 1.5, 1000).astype(np.float32), "ar.rand",
                op="average"))
            # Out of order: odd ranks enqueue the ten tensors in reverse.
            order = range(10) if rank % 2 == 0 else reversed(range(10))
            hs = {t: w.allreduce_async_(
                (np.arange(6) * (t + 1) + 10 * rank).astype(np.int64),
                f"ooo.{t}", op="sum") for t in order}
            for t in range(10):
                rec(f"ooo.{t}", w.synchronize(hs[t]))
            outs = w.grouped_allreduce(
                [np.full(4, float(rank), np.float32),
                 np.full(2, 10.0 + rank, np.float32)], "grp", op="sum")
            rec("grouped", outs)
            rec("allgather", w.allgather(
                np.full((2, 3), float(rank), np.float32), "ag"))
            rec("allgather.i64", w.allgather(
                np.arange(3, dtype=np.int64) + 2**40 * rank, "ag.i64"))
            root = min(2, size - 1)
            rec("broadcast", w.broadcast(np.full(4, float(rank), np.float32),
                                         root, "bc"))
            blocks = np.concatenate(
                [np.full(2, rank * 10 + j, np.int32) for j in range(size)])
            rec("alltoall", w.alltoall(blocks, "a2a"))
            sp = np.arange(1, size + 1, dtype=np.int64)
            rows = np.concatenate([np.full(j + 1, rank * 100 + j, np.float32)
                                   for j in range(size)])
            rec("alltoall_v", w.alltoall_v(rows, sp, name="atv"))
            rec("reducescatter", w.reducescatter(
                np.arange(size * 3, dtype=np.float32) + rank, "rs",
                op="sum"))
            rec("reducescatter.avg.i64", w.reducescatter(
                np.arange(size * 2, dtype=np.int64) * 7 + rank, "rs.avg",
                op="average"))
            w.barrier()
            for step in range(5):
                for t in range(3):
                    w.allreduce(np.full(8, float(step), np.float32),
                                f"grad.{t}", op="sum")
            R["steady.hits"] = w.cache_hits
        if "group_atomic" in modes:
            for step in range(3):
                h = w.allreduce_async_(np.ones(2, np.float32), f"solo.{step}",
                                       op="sum")
                time.sleep(0.05 * rank)
                outs = w.grouped_allreduce(
                    [np.full(3, float(rank + step), np.float32),
                     np.full(7, float(rank), np.float32)], f"grp.{step}",
                    op="sum")
                rec(f"atomic.{step}", outs)
                rec(f"solo.{step}", w.synchronize(h))
        if "process_sets" in modes:
            evens = w.register_process_set([0, 2])
            odds = w.register_process_set([1, 3])
            R["ps.ids"] = [evens, odds, w.register_process_set([2, 0])]
            mine = evens if rank % 2 == 0 else odds
            peers = [0, 2] if rank % 2 == 0 else [1, 3]
            x = np.full(4, float(rank + 1), np.float32)
            rec("ps.sum", w.allreduce(x, f"ps.sum.{mine}", op="sum",
                                      process_set_id=mine))
            rec("ps.avg", w.allreduce(x, f"ps.avg.{mine}", op="average",
                                      process_set_id=mine))
            xi = np.array([rank + 1, -rank], np.int32)
            rec("ps.min", w.allreduce(xi, f"ps.min.{mine}", op="min",
                                      process_set_id=mine))
            rec("ps.max", w.allreduce(xi, f"ps.max.{mine}", op="max",
                                      process_set_id=mine))
            rec("ps.allgather", w.allgather(
                np.full((2,), float(rank), np.float32), f"ps.ag.{mine}",
                process_set_id=mine))
            rec("ps.broadcast", w.broadcast(
                np.full(3, float(rank), np.float32), peers[1],
                f"ps.bc.{mine}", process_set_id=mine))
            rec("ps.grouped", w.grouped_allreduce(
                [np.full(3, float(rank), np.float32),
                 np.full(5, 10.0 + rank, np.float32)], f"ps.grp.{mine}",
                op="sum", process_set_id=mine))
            blocks = np.concatenate(
                [np.full(2, rank * 10 + j, np.float32) for j in range(2)])
            rec("ps.alltoall", w.alltoall(blocks, f"ps.a2a.{mine}",
                                          process_set_id=mine))
            rs_in = np.arange(2 * 3, dtype=np.float32) + rank
            rec("ps.reducescatter", w.reducescatter(
                rs_in, f"ps.rs.{mine}", op="sum", process_set_id=mine))
            rec("ps.reducescatter.avg", w.reducescatter(
                rs_in, f"ps.rsavg.{mine}", op="average",
                process_set_id=mine))
            sp = np.array([1, 2], np.int64)
            my_index = peers.index(rank)
            rows = np.concatenate([np.full(int(sp[j]), rank * 100 + j,
                                           np.float32) for j in range(2)])
            rec("ps.alltoall_v", w.alltoall_v(
                rows, sp, name=f"ps.atv.{mine}", process_set_id=mine,
                members=peers))
            try:
                w.alltoall(np.arange(3, dtype=np.float32), f"ps.bad.{mine}",
                           process_set_id=mine)
                R["ps.bad_split"] = "accepted"
            except Exception as e:
                R["ps.bad_split"] = str(e).split(": ", 1)[-1]
            w.barrier(process_set_id=mine)
            w.barrier()
        if "cache" in modes:
            # Steps that the cycles see whole: a barrier, then the step's
            # tensors enqueued while every rank's loop sleeps its (50 ms)
            # cycle, so each tensor is announced once on every rank.
            for step in range(6):
                w.barrier()
                time.sleep(0.01)
                h0, m0 = w.cache_hits, w.cache_misses
                names = range(6) if step % 3 != 2 else range(2)
                hs = [w.allreduce_async_(np.full(4, float(t + step),
                                                 np.float32),
                                         f"ev.{t}", op="sum") for t in names]
                rec(f"ev.{step}", [w.synchronize(h) for h in hs])
                R[f"ev.{step}.hits"] = w.cache_hits - h0
                R[f"ev.{step}.misses"] = w.cache_misses - m0
        if "stall" in modes:
            if rank == 1:
                time.sleep(2.0)
            rec("stall", w.allreduce(np.ones(4, np.float32), "stall.t",
                                     op="sum"))
        if "join" in modes:
            # Uneven data: rank r runs r + 1 steps, then joins. Step i is
            # contributed by ranks r >= i; joined ranks serve zeros and
            # Average divides by the contributors.
            for i in range(rank + 1):
                rec(f"join.step{i}", w.allreduce(
                    np.full((4,), float(rank + 1), np.float32),
                    f"join.step{i}", op="average"))
                rec(f"join.int{i}", w.allreduce(
                    np.array([7 * rank + 3, -rank, 1000 + rank], np.int64),
                    f"join.int{i}", op="average"))
            R["join.last"] = w.join()
            rec("join.after", w.allreduce(np.full((2,), 1.0, np.float32),
                                          "post.join", op="sum"))
        if "join_subset" in modes:
            # Rank 1 joins at once; rank 0 gathers over the set {0, 1},
            # which has a joined member: the controller refuses it.
            pair = w.register_process_set([0, 1])
            if rank == 0:
                try:
                    w.allgather(np.ones(2, np.float32), "js.ag",
                                process_set_id=pair)
                    R["join.subset_error"] = "accepted"
                except Exception as e:
                    R["join.subset_error"] = str(e).split(": ", 1)[-1]
            steps = 0 if rank == 1 else rank + 1
            for i in range(steps):
                rec(f"js.step{i}", w.allreduce(
                    np.array([10 * rank + 1, rank], np.int32), f"js.step{i}",
                    op="average"))
            R["join.last"] = w.join()

    out = {}
    for world in os.environ["TEST_WORLDS"].split(","):
        print(f"=== {world} ===", file=sys.stderr, flush=True)
        w = Ref() if world == "ref" else Port()
        R = {}
        run(w, R)
        if world == "port" and "public" in modes:
            # The port's eager API negotiates by name: out of order, in a
            # process set, sync and async.
            import torch
            hvd = w.hvd
            order = [0, 1, 2] if rank % 2 == 0 else [2, 1, 0]
            hs = {i: hvd.allreduce_async(
                torch.full((3,), float(10 * i + rank)), name=f"pub.{i}",
                op=hvd.Sum) for i in order}
            R["public.ooo"] = [hvd.synchronize(hs[i]).tolist()
                               for i in range(3)]
            ps = hvd.add_process_set([1])
            if rank == 1:
                R["public.ps"] = hvd.allreduce(
                    torch.tensor([rank + 1.0]), op=hvd.Sum,
                    process_set=ps, name="pub.ps").tolist()
            R["public.ragged"] = hvd.allgather(
                torch.arange(rank + 1, dtype=torch.int64)).tolist()
            R["public.splits"] = [v.tolist() for v in hvd.alltoall(
                torch.arange(size, dtype=torch.int32) + 10 * rank,
                splits=[1] * size)]
            R["public.dispatch"] = hvd.cache_stats()["eager_dispatch"]
        if world == "port" and "peerdeath" in modes:
            from horovod_tpu_torch.exceptions import HorovodInternalError
            import torch
            w.allreduce(np.ones(4, np.float32), "pd.warmup", op="sum")
            if rank == size - 1:
                os._exit(1)
            try:
                w.allreduce(np.ones(4, np.float32), "pd.next", op="sum")
                R["peerdeath"] = "no error"
            except HorovodInternalError as e:
                R["peerdeath"] = "HorovodInternalError"
            R["alive"] = w.w.alive
        if world == "port" and "stallwatch" in modes:
            # Rank 1 reaches the watched region 2 s late: rank 0's
            # controller names it. Then rank 0 alone watches a region with
            # a 1 s bound.
            hvd = w.hvd
            if rank == 1:
                time.sleep(2.0)
            with hvd.stall.watch("late"):
                pass
            R["stallwatch"] = "ok"
            if rank == 0:
                t0 = time.monotonic()
                try:
                    with hvd.stall.watch("alone", timeout_s=1.0):
                        pass
                    R["stallwatch.bound"] = "no error"
                except Exception as e:
                    R["stallwatch.bound"] = type(e).__name__
                R["stallwatch.waited"] = time.monotonic() - t0
            w.barrier()
        if world == "port" and "autotune" in modes:
            R["autotune.before"] = w.autotune_state()
            for step in range(70):
                hs = [w.allreduce_async_(np.full(8192, float(step),
                                                 np.float32),
                                         f"at.grad.{t}", op="sum")
                      for t in range(16)]
                for h in hs:
                    w.synchronize(h)
            R["autotune.after"] = w.autotune_state()
        R["cache.hits"], R["cache.misses"] = w.cache_hits, w.cache_misses
        R["cycles"] = w.cycles
        w.shutdown()
        out[world] = R
    print("RESULT " + json.dumps(out), flush=True)
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def spawn(tmp_path, size, mode, worlds=("ref", "port"), extra_env=None,
          timeout=120):
    """Run the worker on ``size`` processes; returns per rank
    (returncode, results by world, stderr)."""
    script = tmp_path / "negotiation_worker.py"
    script.write_text(WORKER)
    port = _free_port()
    rdv = tmp_path / f"rdv_{mode.replace(',', '_')}"
    procs = []
    for r in range(size):
        env = dict(os.environ, REPO_ROOT=REPO_ROOT, TEST_RANK=str(r),
                   TEST_SIZE=str(size), TEST_PORT=str(port),
                   TEST_MODE=mode, TEST_WORLDS=",".join(worlds),
                   TEST_RDV=str(rdv), HOROVOD_NUM_PROCESSES=str(size),
                   HOROVOD_PROCESS_ID=str(r), JAX_PLATFORMS="cpu",
                   CUDA_VISIBLE_DEVICES="")
        env.update(extra_env or {})
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = []
    for r, p in enumerate(procs):
        try:
            stdout, stderr = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {r} of {mode} timed out")
        lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        results = json.loads(lines[-1][7:]) if lines else None
        out.append((p.returncode, results, stderr))
    return out


def ok(runs):
    for r, (rc, results, err) in enumerate(runs):
        assert rc == 0 and results is not None, f"rank {r} rc={rc}\n{err}"
    return runs


def same(port, ref, what):
    """Integers bit for bit, floats within 1e-6 relative."""
    assert port["dtype"] == ref["dtype"], (what, port, ref)
    got, want = np.asarray(port["value"]), np.asarray(ref["value"])
    assert got.shape == want.shape, (what, got, want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=what)
    else:
        assert np.array_equal(got, want), (what, got, want)


BATTERY_KEYS = [
    "ar.sum", "ar.avg.prescale", "ar.min", "ar.max", "ar.f16", "ar.bf16",
    "ar.i64", "ar.u8.max", "ar.i32.avg.postscale", "ar.f32.avg.random",
    *[f"ooo.{t}" for t in range(10)], "grouped.0", "grouped.1",
    "allgather", "allgather.i64", "broadcast", "alltoall", "alltoall_v.0",
    "alltoall_v.1", "reducescatter", "reducescatter.avg.i64",
]
ATOMIC_KEYS = [f"{k}.{s}{i}" for s in range(3)
               for k, i in (("atomic", ".0"), ("atomic", ".1"), ("solo", ""))]
PS_KEYS = ["ps.sum", "ps.avg", "ps.min", "ps.max", "ps.allgather",
           "ps.broadcast", "ps.grouped.0", "ps.grouped.1", "ps.alltoall",
           "ps.reducescatter", "ps.reducescatter.avg", "ps.alltoall_v.0",
           "ps.alltoall_v.1"]


@pytest.fixture(scope="module")
def battery2(tmp_path_factory):
    return ok(spawn(tmp_path_factory.mktemp("b2"), 2,
                    "battery,group_atomic,public,stall",
                    extra_env={"HOROVOD_STALL_CHECK_TIME": "0.5"}))


@pytest.fixture(scope="module")
def battery4(tmp_path_factory):
    return ok(spawn(tmp_path_factory.mktemp("b4"), 4,
                    "battery,process_sets"))


def test_runtime_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; import horovod_tpu_torch.runtime as r; "
            "import horovod_tpu_torch.ops.collective_ops; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'horovod_tpu.')) or m == 'horovod_tpu']; "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("key", BATTERY_KEYS)
def test_battery_at_2_ranks_matches_reference(battery2, key):
    for r, (_, res, _) in enumerate(battery2):
        same(res["port"][key], res["ref"][key], f"rank {r} {key}")


@pytest.mark.parametrize("key", BATTERY_KEYS)
def test_battery_at_4_ranks_matches_reference(battery4, key):
    for r, (_, res, _) in enumerate(battery4):
        same(res["port"][key], res["ref"][key], f"rank {r} {key}")


@pytest.mark.parametrize("key", ATOMIC_KEYS)
def test_grouped_enqueue_is_atomic_as_the_reference(battery2, key):
    for r, (_, res, _) in enumerate(battery2):
        same(res["port"][key], res["ref"][key], f"rank {r} {key}")


@pytest.mark.parametrize("key", PS_KEYS)
def test_process_sets_match_reference(battery4, key):
    for r, (_, res, _) in enumerate(battery4):
        same(res["port"][key], res["ref"][key], f"rank {r} {key}")


def test_process_set_ids_and_refusals_match_reference(battery4):
    for _, res, _ in battery4:
        assert res["port"]["ps.ids"] == res["ref"]["ps.ids"] == [1, 2, 1]
        assert res["port"]["ps.bad_split"] == res["ref"]["ps.bad_split"]
        assert "must divide" in res["port"]["ps.bad_split"]


@pytest.mark.parametrize("size", [2, 4])
def test_steady_state_names_hit_the_cache(battery2, battery4, size):
    runs = battery2 if size == 2 else battery4
    for _, res, _ in runs:
        # The last steps of the named loop ride the bitvector fast path.
        assert res["port"]["steady.hits"] >= 9
        assert res["port"]["cycles"] > 0


def test_eager_api_negotiates_by_name(battery2):
    for r, (_, res, _) in enumerate(battery2):
        port = res["port"]
        assert port["public.ooo"] == [[float(10 * i * 2 + 1)] * 3
                                      for i in range(3)]
        if r == 1:
            assert port["public.ps"] == [2.0]
        assert port["public.ragged"] == [0, 0, 1]
        assert port["public.splits"][0] == [r, 10 + r]
        assert port["public.splits"][1] == [1, 1]
        assert port["public.dispatch"]["allreduce"] == 3 + r


@pytest.fixture(scope="module")
def cache2(tmp_path_factory):
    return ok(spawn(tmp_path_factory.mktemp("c2"), 2, "cache",
                    extra_env={"HOROVOD_CACHE_CAPACITY": "3",
                               "HOROVOD_CYCLE_TIME": "50"}))


@pytest.mark.parametrize("step", range(6))
def test_cache_lru_eviction_matches_reference(cache2, step):
    """Capacity 3 under six hot names: the same results, and the same
    hits and misses per step, on every rank."""
    for r, (_, res, _) in enumerate(cache2):
        port, ref = res["port"], res["ref"]
        for i in range(6 if step % 3 != 2 else 2):
            same(port[f"ev.{step}.{i}"], ref[f"ev.{step}.{i}"],
                 f"rank {r} step {step}")
        assert (port[f"ev.{step}.hits"], port[f"ev.{step}.misses"]) == (
            ref[f"ev.{step}.hits"], ref[f"ev.{step}.misses"]), (r, step)


def _stall_lines(stderr: str) -> dict:
    """The stall reports of each world's part of rank 0's stderr, without
    the log line's prefix."""
    out, world = {}, None
    for line in stderr.splitlines():
        if line.startswith("=== ") and line.endswith(" ==="):
            world = line[4:-4]
            out[world] = []
        elif "stall detected:" in line and world is not None:
            out[world].append(line[line.index("stall detected:"):])
    return out


def test_stall_report_matches_reference(battery2):
    """Rank 1 enqueues ``stall.t`` 2 s after rank 0 (the check time is
    0.5 s): rank 0's controller reports it in the same words."""
    for r, (_, res, _) in enumerate(battery2):
        same(res["port"]["stall"], res["ref"]["stall"], f"rank {r}")
    lines = {world: [ln for ln in found if "tensor stall.t " in ln]
             for world, found in _stall_lines(battery2[0][2]).items()}
    assert lines["ref"], battery2[0][2]
    assert lines["port"] == lines["ref"]
    assert "missing from rank(s) [1]" in lines["port"][0]


def test_peer_death_raises_horovod_internal_error(tmp_path):
    runs = spawn(tmp_path, 3, "peerdeath", worlds=("port",))
    assert runs[2][0] == 1
    for r in (0, 1):
        rc, res, err = runs[r]
        assert rc == 0 and res is not None, err
        assert res["port"]["peerdeath"] == "HorovodInternalError"
        assert res["port"]["alive"] is False


@pytest.mark.parametrize("compiler", ["false", "/nonexistent/g++"])
def test_a_failed_build_raises(monkeypatch, compiler):
    """The control plane builds with g++ or raises: a compiler that fails
    or is missing is a ``RuntimeError`` naming it, and the library is not
    loaded."""
    from horovod_tpu_torch import runtime

    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "GXX", compiler)
    monkeypatch.setattr(runtime, "GXX_FLAGS",
                        runtime.GXX_FLAGS + ("-DHVD_FAILED_BUILD_PROBE",))
    with pytest.raises(RuntimeError, match="g\\+\\+|C\\+\\+ compiler"):
        runtime.load_library()
    assert runtime._lib is None
