"""The port's process sets, reducescatter, alltoall, grouped forms and async
API (horovod_tpu_torch) against the JAX package's eager ops, over four
gloo ranks.

Four ranks run everything once (one spawn for the module; a ``file://``
rendezvous under the test's tmp dir). Rank r's result is held to row r of
the JAX package's stacked-rank result on a process set of the same number
of devices, on the same numpy inputs; on the subsets {0, 1} and {1, 2, 3}
rank r is held to the row of its place in the set. Tolerance: float32,
1e-6 relative (a four-term sum has a few roundings on either side; the
scale factors add one more each). The reference's reducescatter takes Sum
and Average; the port's Min, Max and Product are held to slice r of the
JAX package's allreduce with that op. Ragged gathers are held to
``np.concatenate`` of the ranks' tensors, as the JAX package's stacked
arrays cannot be ragged. The same spawn trains a process-set-scoped
``DistributedOptimizer`` on ranks {1, 3} (held to the JAX package's
two-device trajectory of tests/test_torch_optimizer.py), and checks the
world facts, ``allgather_object`` and ``masked_average``.
"""

import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
OPS = ("average", "sum", "min", "max", "product")
SCALES = ((1.0, 1.0), (2.0, 0.5))
TOL = dict(rtol=1e-6, atol=1e-6)
SUBSETS = ((0, 1), (1, 2, 3))
OPT_SET = (1, 3)


def _data():
    rng = np.random.RandomState(3)
    return {
        # dim 0 = 8: divisible by 4 (and by 2 for the grouped forms).
        "x": rng.randn(WORLD, 8, 3).astype(np.float32),
        # Near 1 so the product stays well scaled.
        "p": (1.0 + 0.1 * rng.randn(WORLD, 8, 3)).astype(np.float32),
        "bad": rng.randn(WORLD, 6, 3).astype(np.float32),
        "v": rng.randn(WORLD, 6, 2).astype(np.float32),
        # dim 0 = 6: divisible by the subsets' sizes 2 and 3.
        "y": rng.randn(WORLD, 6, 2).astype(np.float32),
        "g": [rng.randn(WORLD, *s).astype(np.float32)
              for s in ((4,), (8, 3), (12,))],
        "ragged": [[rng.randn(r + 1, 2).astype(np.float32)
                    for r in range(WORLD)],
                   [rng.randn(3 - r % 2, 5).astype(np.float32)
                    for r in range(WORLD)]],
        "mask": np.array([1.0, 1.0, 0.0, 1.0], np.float32),
    }


# This rank's send splits: one vector for every rank (an empty chunk to
# rank 1), and a table whose row r is rank r's.
SPLITS_VECTOR = np.array([3, 0, 2, 1])
SPLITS_TABLE = np.array([[1, 2, 3, 0], [0, 0, 6, 0], [2, 2, 1, 1],
                         [6, 0, 0, 0]])


def _objects():
    return [{"rank": r, "name": "x" * r, "tuple": (r, 1.5)}
            for r in range(WORLD)]


def _error(res, key, call):
    try:
        call()
    except ValueError as e:
        res[key] = np.array(str(e))
    else:
        res[key] = np.array("")


def _collectives(hvd, rank, d, res):
    T = torch.from_numpy
    for op in OPS:
        src = d["p"] if op == "product" else d["x"]
        for pre, post in SCALES:
            res[f"rs.{op}.{pre}.{post}"] = hvd.reducescatter(
                T(src[rank]), op=op, prescale_factor=pre,
                postscale_factor=post).numpy()
    res["rs.default"] = hvd.reducescatter(T(d["x"][rank])).numpy()
    _error(res, "rs.bad", lambda: hvd.reducescatter(T(d["bad"][rank])))
    res["a2a"] = hvd.alltoall(T(d["x"][rank])).numpy()
    _error(res, "a2a.bad", lambda: hvd.alltoall(T(d["bad"][rank])))
    for name, splits in (("vector", SPLITS_VECTOR), ("table", SPLITS_TABLE)):
        out, received = hvd.alltoall(T(d["v"][rank]), splits=splits)
        res[f"a2a.{name}"] = out.numpy()
        res[f"a2a.{name}.received"] = received.numpy()
    res["a2a.rank_splits"] = hvd.alltoall(
        T(d["v"][rank]), splits=torch.from_numpy(SPLITS_TABLE[rank]))[0].numpy()
    _error(res, "a2a.bad_splits",
           lambda: hvd.alltoall(T(d["v"][rank]), splits=[1, 1, 1, 1]))
    for i, t in enumerate(hvd.grouped_reducescatter(
            [T(g[rank]) for g in d["g"]], op=hvd.Sum, prescale_factor=0.5)):
        res[f"grs.{i}"] = t.numpy()
    for i, t in enumerate(hvd.grouped_allgather(
            [T(parts[rank]) for parts in d["ragged"]])):
        res[f"gag.{i}"] = t.numpy()


def _async(hvd, rank, d, res):
    T = torch.from_numpy
    inplace = T(d["x"][rank].copy())
    bcast = T(d["y"][rank].copy())
    handles = {
        "allreduce_": hvd.allreduce_async_(inplace, op=hvd.Sum),
        "allreduce": hvd.allreduce_async(T(d["x"][rank]), op=hvd.Average,
                                         prescale_factor=2.0,
                                         postscale_factor=0.5),
        "allgather": hvd.allgather_async(T(d["ragged"][0][rank])),
        "broadcast": hvd.broadcast_async(T(d["y"][rank]), root_rank=2),
        "broadcast_": hvd.broadcast_async_(bcast, root_rank=3),
        "alltoall": hvd.alltoall_async(T(d["x"][rank])),
        "alltoall_splits": hvd.alltoall_async(T(d["v"][rank]),
                                              splits=SPLITS_TABLE),
        "reducescatter": hvd.reducescatter_async(T(d["x"][rank]),
                                                 op=hvd.Sum),
        "grouped_allreduce": hvd.grouped_allreduce_async(
            [T(g[rank]) for g in d["g"]], op=hvd.Average),
        "grouped_allgather": hvd.grouped_allgather_async(
            [T(parts[rank]) for parts in d["ragged"]]),
        "grouped_reducescatter": hvd.grouped_reducescatter_async(
            [T(g[rank]) for g in d["g"]]),
    }
    deadline = time.monotonic() + 60
    polled = {k: False for k in handles}
    while not all(polled.values()) and time.monotonic() < deadline:
        for k, h in handles.items():
            polled[k] = polled[k] or hvd.poll(h)
    res["async.polled"] = np.array(all(polled.values()))
    out = {k: hvd.synchronize(h) for k, h in handles.items()}
    res["async.allreduce_.same"] = np.array(out["allreduce_"] is inplace)
    res["async.broadcast_.same"] = np.array(out["broadcast_"] is bcast)
    for k, v in out.items():
        if isinstance(v, tuple):
            res[f"async.{k}"], res[f"async.{k}.received"] = (t.numpy()
                                                             for t in v)
        elif isinstance(v, list):
            for i, t in enumerate(v):
                res[f"async.{k}.{i}"] = t.numpy()
        else:
            res[f"async.{k}"] = v.numpy()
    _error(res, "async.unknown",
           lambda: hvd.synchronize(handles["allreduce"]))
    _error(res, "async.poll_unknown", lambda: hvd.poll(10**9))


def _subsets(hvd, rank, d, res):
    T = torch.from_numpy
    sets = [hvd.add_process_set(list(s)) for s in SUBSETS]
    res["ids"] = np.array(hvd.get_process_set_ids())
    _error(res, "dup", lambda: hvd.add_process_set([1, 0]))
    _error(res, "dup_global", lambda: hvd.add_process_set(range(WORLD)))
    _error(res, "range", lambda: hvd.add_process_set([0, WORLD]))
    for s, ps in zip(SUBSETS, sets):
        tag = "".join(map(str, s))
        if rank not in s:
            _error(res, f"ps{tag}.nonmember",
                   lambda: hvd.allreduce(T(d["y"][rank]), process_set=ps))
            continue
        res[f"ps{tag}.rank"] = np.array(ps.rank())
        res[f"ps{tag}.allreduce"] = hvd.allreduce(
            T(d["y"][rank]), op=hvd.Sum, process_set=ps).numpy()
        res[f"ps{tag}.average"] = hvd.allreduce(
            T(d["y"][rank]), process_set=ps).numpy()
        res[f"ps{tag}.allgather"] = hvd.allgather(
            T(d["y"][rank]), process_set=ps).numpy()
        res[f"ps{tag}.broadcast"] = hvd.broadcast(
            T(d["y"][rank]), root_rank=s[-1], process_set=ps).numpy()
        res[f"ps{tag}.reducescatter"] = hvd.reducescatter(
            T(d["y"][rank]), op=hvd.Sum, process_set=ps).numpy()
        res[f"ps{tag}.alltoall"] = hvd.alltoall(
            T(d["y"][rank]), process_set=ps).numpy()
        res[f"ps{tag}.object"] = np.array(repr(hvd.allgather_object(
            _objects()[rank], process_set=ps)))
        _error(res, f"ps{tag}.root", lambda: hvd.broadcast(
            T(d["y"][rank]), root_rank=next(r for r in range(WORLD)
                                            if r not in s), process_set=ps))
        hvd.barrier(process_set=ps)
    res["removed"] = np.array([hvd.remove_process_set(sets[0]),
                               hvd.remove_process_set(sets[0]),
                               hvd.remove_process_set(hvd.global_process_set)])
    res["ids_after"] = np.array(hvd.get_process_set_ids())
    _error(res, "removed_use",
           lambda: hvd.allreduce(T(d["y"][rank]), process_set=sets[0]))


def _scoped_optimizer(hvd, rank, res):
    from test_torch_optimizer import (LR, MOMENTUM, _Params, _problem,
                                      _torch_loss)

    leaves, batches = _problem()
    ps = hvd.add_process_set(list(OPT_SET))
    if rank in OPT_SET:
        model = _Params(leaves)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
            process_set=ps)
        step = hvd.make_train_step(model, _torch_loss, opt)
        rows = slice(ps.rank() * 8, ps.rank() * 8 + 8)
        res["opt.loss"] = np.array([
            float(step((torch.from_numpy(x[rows]),
                        torch.from_numpy(y[rows]))))
            for x, y in batches[:3]])
        for key in leaves:
            res[f"opt.{key}"] = model[key].detach().numpy().copy()
        opt.remove_hooks()
    else:
        _error(res, "opt.nonmember", lambda: hvd.DistributedOptimizer(
            torch.optim.SGD([torch.nn.Parameter(torch.ones(1))], lr=LR),
            process_set=ps))
    hvd.barrier()


def _worker(rank, init_file, out_dir):
    os.environ["HOROVOD_NUM_PROCESSES"] = str(WORLD)
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    os.environ["HOROVOD_LOCAL_SIZE"] = "2"
    os.environ["HOROVOD_LOCAL_RANK"] = str(rank % 2)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    d = _data()
    res = {"facts": np.array([
        hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
        hvd.cross_rank(), hvd.cross_size(), hvd.process_rank(),
        hvd.process_count(), hvd.is_homogeneous()])}
    res["flags"] = np.array([
        hvd.mpi_enabled(), hvd.mpi_built(), hvd.mpi_threads_supported(),
        hvd.gloo_enabled(), hvd.gloo_built(), hvd.nccl_built(),
        hvd.cuda_built(), hvd.rocm_built(), hvd.ddl_built(),
        hvd.ccl_built()])
    _collectives(hvd, rank, d, res)
    _async(hvd, rank, d, res)
    _subsets(hvd, rank, d, res)
    res["object"] = np.array(repr(hvd.allgather_object(_objects()[rank])))
    res["masked"] = hvd.masked_average(
        torch.from_numpy(d["y"][rank]), float(d["mask"][rank])).numpy()
    masked = hvd.masked_average(
        {"a": torch.from_numpy(d["v"][rank]),
         "b": torch.from_numpy(d["v"][rank]).to(torch.bfloat16)},
        torch.tensor(d["mask"][rank]))
    res["masked.a"] = masked["a"].numpy()
    res["masked.b"] = masked["b"].float().numpy()
    res["masked.b.dtype"] = np.array(str(masked["b"].dtype))
    _scoped_optimizer(hvd, rank, res)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_process_sets")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp / "rendezvous"), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs])
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def jhvd():
    import horovod_tpu as jhvd

    return jhvd


@pytest.fixture(scope="module")
def jax_sets(jhvd):
    """Process sets of the JAX package's 8-device CPU world: four devices
    (the port's world), and the two subsets. A set that another test
    module left registered is used as it is; the ones added here are
    removed after."""
    from test_torch_optimizer import _jax_set

    sets, added = {}, []
    for ranks in ((0, 1, 2, 3),) + SUBSETS:
        sets[ranks], own = _jax_set(ranks)
        if own:
            added.append(sets[ranks])
    yield sets
    for ps in added:
        jhvd.remove_process_set(ps)


def _rows(results, key):
    return [res[key] for res in results]


@pytest.mark.parametrize("op", OPS)
def test_reducescatter_matches_jax(port_results, jhvd, jax_sets, op):
    ps = jax_sets[(0, 1, 2, 3)]
    src = _data()["p" if op == "product" else "x"]
    for pre, post in SCALES:
        if op in ("average", "sum"):
            want = np.asarray(jhvd.reducescatter(
                src, op=op, prescale_factor=pre, postscale_factor=post,
                process_set=ps))
        else:
            full = np.asarray(jhvd.allreduce(
                src, op=op, prescale_factor=pre, postscale_factor=post,
                process_set=ps))
            want = full.reshape(WORLD, WORLD, 2, 3)[np.arange(WORLD),
                                                    np.arange(WORLD)]
        for r, got in enumerate(_rows(port_results,
                                      f"rs.{op}.{pre}.{post}")):
            assert got.shape == (2, 3)
            np.testing.assert_allclose(got, want[r], err_msg=f"rank {r}",
                                       **TOL)


def test_reducescatter_defaults_to_average_and_checks_dim0(port_results,
                                                           jhvd, jax_sets):
    want = np.asarray(jhvd.reducescatter(
        _data()["x"], process_set=jax_sets[(0, 1, 2, 3)]))
    for r, res in enumerate(port_results):
        np.testing.assert_allclose(res["rs.default"], want[r], **TOL)
        assert "divisible by the set size 4" in str(res["rs.bad"])
        assert "divisible by the set size 4" in str(res["a2a.bad"])


def test_alltoall_matches_jax(port_results, jhvd, jax_sets):
    want = np.asarray(jhvd.alltoall(_data()["x"],
                                    process_set=jax_sets[(0, 1, 2, 3)]))
    for r, res in enumerate(port_results):
        np.testing.assert_array_equal(res["a2a"], want[r])


@pytest.mark.parametrize("name,splits", [("vector", SPLITS_VECTOR),
                                         ("table", SPLITS_TABLE)])
def test_alltoall_with_splits_matches_jax(port_results, jhvd, jax_sets, name,
                                          splits):
    outputs, received = jhvd.alltoall(_data()["v"], splits=splits,
                                      process_set=jax_sets[(0, 1, 2, 3)])
    for r, res in enumerate(port_results):
        np.testing.assert_array_equal(res[f"a2a.{name}"],
                                      np.asarray(outputs[r]))
        np.testing.assert_array_equal(res[f"a2a.{name}.received"],
                                      np.asarray(received)[r])
    if name == "vector":  # rank 1 receives empty chunks from everyone
        assert port_results[1]["a2a.vector"].shape == (0, 2)
    if name == "table":  # each rank passing only its own row: the same
        for res in port_results:
            np.testing.assert_array_equal(res["a2a.rank_splits"],
                                          res["a2a.table"])


def test_alltoall_splits_must_sum_to_dim0(port_results):
    for res in port_results:
        assert "sum to its dim-0 size 6" in str(res["a2a.bad_splits"])


def test_grouped_forms_match_jax(port_results, jhvd, jax_sets):
    d = _data()
    want = [np.asarray(a) for a in jhvd.grouped_reducescatter(
        d["g"], op=jhvd.Sum, prescale_factor=0.5,
        process_set=jax_sets[(0, 1, 2, 3)])]
    for r, res in enumerate(port_results):
        for i in range(len(d["g"])):
            np.testing.assert_allclose(res[f"grs.{i}"], want[i][r], **TOL)
        for i, parts in enumerate(d["ragged"]):
            np.testing.assert_array_equal(res[f"gag.{i}"],
                                          np.concatenate(parts))


def test_async_api_matches_jax(port_results, jhvd, jax_sets):
    ps = jax_sets[(0, 1, 2, 3)]
    d = _data()
    want = {
        "allreduce_": jhvd.allreduce(d["x"], op=jhvd.Sum, process_set=ps),
        "allreduce": jhvd.allreduce(d["x"], op=jhvd.Average,
                                    prescale_factor=2.0,
                                    postscale_factor=0.5, process_set=ps),
        "broadcast": jhvd.broadcast(d["y"], root_rank=2, process_set=ps),
        "broadcast_": jhvd.broadcast(d["y"], root_rank=3, process_set=ps),
        "alltoall": jhvd.alltoall(d["x"], process_set=ps),
        "reducescatter": jhvd.reducescatter(d["x"], op=jhvd.Sum,
                                            process_set=ps),
    }
    grouped_ar = jhvd.grouped_allreduce(d["g"], op=jhvd.Average,
                                        process_set=ps)
    grouped_rs = jhvd.grouped_reducescatter(d["g"], process_set=ps)
    outputs, received = jhvd.alltoall(d["v"], splits=SPLITS_TABLE,
                                      process_set=ps)
    for r, res in enumerate(port_results):
        assert bool(res["async.polled"])
        assert bool(res["async.allreduce_.same"])
        assert bool(res["async.broadcast_.same"])
        for k, w in want.items():
            np.testing.assert_allclose(res[f"async.{k}"], np.asarray(w)[r],
                                       err_msg=k, **TOL)
        np.testing.assert_array_equal(res["async.allgather"],
                                      np.concatenate(d["ragged"][0]))
        np.testing.assert_array_equal(res["async.alltoall_splits"],
                                      np.asarray(outputs[r]))
        np.testing.assert_array_equal(res["async.alltoall_splits.received"],
                                      np.asarray(received)[r])
        for i in range(len(d["g"])):
            np.testing.assert_allclose(res[f"async.grouped_allreduce.{i}"],
                                       np.asarray(grouped_ar[i])[r], **TOL)
            np.testing.assert_allclose(
                res[f"async.grouped_reducescatter.{i}"],
                np.asarray(grouped_rs[i])[r], **TOL)
        for i, parts in enumerate(d["ragged"]):
            np.testing.assert_array_equal(
                res[f"async.grouped_allgather.{i}"], np.concatenate(parts))
        assert "unknown handle" in str(res["async.unknown"])
        assert "unknown handle" in str(res["async.poll_unknown"])


@pytest.mark.parametrize("subset", SUBSETS, ids=["01", "123"])
def test_subset_collectives_match_jax(port_results, jhvd, jax_sets, subset):
    ps = jax_sets[subset]
    y = _data()["y"][list(subset)]
    tag = "".join(map(str, subset))
    want = {
        "allreduce": jhvd.allreduce(y, op=jhvd.Sum, process_set=ps),
        "average": jhvd.allreduce(y, process_set=ps),
        "allgather": jhvd.allgather(y, process_set=ps),
        "broadcast": jhvd.broadcast(y, root_rank=subset[-1], process_set=ps),
        "reducescatter": jhvd.reducescatter(y, op=jhvd.Sum, process_set=ps),
        "alltoall": jhvd.alltoall(y, process_set=ps),
    }
    objects = repr([_objects()[r] for r in subset])
    for r, res in enumerate(port_results):
        if r not in subset:
            assert f"this rank ({r}) is not a member" in str(
                res[f"ps{tag}.nonmember"])
            continue
        i = subset.index(r)
        assert int(res[f"ps{tag}.rank"]) == i
        for k, w in want.items():
            np.testing.assert_allclose(res[f"ps{tag}.{k}"], np.asarray(w)[i],
                                       err_msg=k, **TOL)
        assert str(res[f"ps{tag}.object"]) == objects
        assert "is not a member of process set" in str(res[f"ps{tag}.root"])


def test_process_set_registration(port_results):
    for res in port_results:
        assert res["ids"].tolist() == [0, 1, 2]
        assert "already exists" in str(res["dup"])
        assert "already exists" in str(res["dup_global"])
        assert "out of range for world size 4" in str(res["range"])
        assert res["removed"].tolist() == [True, False, False]
        assert res["ids_after"].tolist() == [0, 2]
        assert "not registered" in str(res["removed_use"])


def test_process_set_scoped_optimizer_matches_jax(port_results, jax_sets):
    """Ranks {1, 3} train with a DistributedOptimizer on their set (the
    loss averaged over it too) while ranks 0 and 2 stay out: the same
    trajectory as the JAX package's on a two-device set."""
    from test_torch_optimizer import _jax_trajectory, _problem

    leaves, batches = _problem()
    losses, final = _jax_trajectory(leaves, batches, "none", 1, 3,
                                    ps=jax_sets[(0, 1)])
    opt_tol = dict(rtol=1e-4, atol=1e-6)
    for r, res in enumerate(port_results):
        if r not in OPT_SET:
            assert "is not a member" in str(res["opt.nonmember"])
            continue
        np.testing.assert_allclose(res["opt.loss"], losses, **opt_tol)
        for key, want in final.items():
            np.testing.assert_allclose(res[f"opt.{key}"], want,
                                       err_msg=key, **opt_tol)


def test_world_facts_and_build_flags(port_results):
    """Two hosts of two ranks (HOROVOD_LOCAL_SIZE=2): host index and count
    from the local size, one process per rank; no MPI, gloo without
    CUDA on this build."""
    for r, res in enumerate(port_results):
        assert res["facts"].tolist() == [r, WORLD, r % 2, 2, r // 2, 2, r,
                                         WORLD, True]
        flags = res["flags"].tolist()
        assert flags[:3] == [False, False, False]
        assert flags[3:5] == [True, True]
        assert flags[6] == (torch.version.cuda is not None)
        assert flags[8:] == [False, False]


def test_allgather_object_gathers_in_rank_order(port_results):
    for res in port_results:
        assert str(res["object"]) == repr(_objects())


def test_masked_average_matches_jax(port_results, jhvd, jax_sets):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    ps = jax_sets[(0, 1, 2, 3)]
    d = _data()

    def body(v, m):
        return jax.tree.map(lambda t: t[None], jhvd.masked_average(
            jax.tree.map(lambda t: t[0], v), m[0], process_set=ps))

    fn = jax.jit(jax.shard_map(
        body, mesh=ps.mesh, in_specs=(P(ps.axis_name), P(ps.axis_name)),
        out_specs=P(ps.axis_name), check_vma=False))
    want = fn({"y": jnp.asarray(d["y"]), "a": jnp.asarray(d["v"]),
               "b": jnp.asarray(d["v"], jnp.bfloat16)},
              jnp.asarray(d["mask"]))
    for r, res in enumerate(port_results):
        np.testing.assert_allclose(res["masked"], np.asarray(want["y"])[r],
                                   **TOL)
        np.testing.assert_allclose(res["masked.a"], np.asarray(want["a"])[r],
                                   **TOL)
        np.testing.assert_allclose(
            res["masked.b"], np.asarray(want["b"], np.float32)[r], rtol=1e-2)
        assert str(res["masked.b.dtype"]) == "torch.bfloat16"


def test_chip_diag_collectives_rehearses_on_four_gloo_ranks():
    """``chip_diag.py collectives --cpu``, the multi-card check's rehearsal:
    four gloo ranks started by the port's launcher, each holding every
    result to the numpy reference."""
    import subprocess
    import sys

    script = os.path.join(os.path.dirname(__file__), os.pardir,
                          "chip_diag.py")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    out = subprocess.run([sys.executable, script, "collectives", "--cpu"],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert ("4 ranks over gloo started by hvdrun-torch, exit code 0,"
            in out.stdout)
    assert out.stdout.count("results held to the numpy reference") == 4
