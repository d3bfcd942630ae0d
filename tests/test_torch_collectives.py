"""The port's world and eager collectives (horovod_tpu_torch) against the
JAX package's eager ops.

Two gloo ranks run every collective once (one spawn for the module; a
``file://`` rendezvous under the test's tmp dir, since test files run in
parallel). Rank r's result is compared with row r of the JAX package's
stacked-rank result on a 2-device process set, on the same numpy inputs.
Tolerance: float32, 1e-6 relative (a two-term sum has one rounding on
either side; Product and the scale factors add one more each). Ragged
``allgather`` (ranks sending different dim-0 sizes, the reference's
``allgather_v``) is held to ``np.concatenate`` of the ranks' tensors.
"""

import multiprocessing as mp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD = 2
OPS = ("average", "sum", "min", "max", "product")
SCALES = ((1.0, 1.0), (2.0, 0.5), (0.25, 3.0))
TOL = dict(rtol=1e-6, atol=1e-6)


def _data():
    rng = np.random.RandomState(0)
    return {
        "x": rng.randn(WORLD, 3, 5).astype(np.float32),
        # Near 1 so the product stays well scaled.
        "p": (1.0 + 0.1 * rng.randn(WORLD, 7)).astype(np.float32),
        "g": [rng.randn(WORLD, *s).astype(np.float32)
              for s in ((4,), (2, 3), (5,), (1,), (3, 3))],
    }


def _ragged():
    """Per-rank tensors for allgather: ragged dim 0, an empty rank, and a
    rank whose trailing dims disagree."""
    rng = np.random.RandomState(1)
    return {
        "ragged": [rng.randn(2, 3).astype(np.float32),
                   rng.randn(3, 3).astype(np.float32)],
        "empty": [rng.randn(2, 3).astype(np.float32),
                  np.zeros((0, 3), np.float32)],
        "mismatch": [rng.randn(2, 3).astype(np.float32),
                     rng.randn(3, 4).astype(np.float32)],
    }


def _worker(rank, init_file, out_dir):
    """One rank: run every collective, save its results."""
    os.environ["HOROVOD_NUM_PROCESSES"] = str(WORLD)
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    d = _data()
    res = {"rank": np.array(hvd.rank()), "size": np.array(hvd.size())}
    for op in OPS:
        src = d["p"] if op == "product" else d["x"]
        for pre, post in SCALES:
            x = torch.from_numpy(src[rank].copy())
            res[f"allreduce.{op}.{pre}.{post}"] = hvd.allreduce(
                x, op=op, prescale_factor=pre,
                postscale_factor=post).numpy()
            assert torch.equal(x, torch.from_numpy(src[rank]))  # not in place
    res["allgather"] = hvd.allgather(torch.from_numpy(d["x"][rank])).numpy()
    for case, parts in _ragged().items():
        try:
            res[f"allgather.{case}"] = hvd.allgather(
                torch.from_numpy(parts[rank])).numpy()
        except ValueError as e:
            res[f"allgather.{case}.error"] = np.array(str(e))
    for root in range(WORLD):
        res[f"broadcast.{root}"] = hvd.broadcast(
            torch.from_numpy(d["x"][rank]), root_rank=root).numpy()
    # Two-leaf buckets: a 48-byte cap splits the five gradients into several.
    os.environ["HOROVOD_FUSION_THRESHOLD"] = "48"
    grouped = hvd.grouped_allreduce(
        [torch.from_numpy(g[rank]) for g in d["g"]], op=hvd.Average)
    for i, t in enumerate(grouped):
        res[f"grouped.{i}"] = t.numpy()
    from horovod_tpu_torch.ops.fusion import fused_allreduce

    fused = fused_allreduce([torch.from_numpy(g[rank]) for g in d["g"]],
                            hvd.Sum, threshold_bytes=32,
                            prescale_factor=0.5, issue_reversed=True)
    for i, t in enumerate(fused):
        res[f"fused.{i}"] = t.numpy()
    hvd.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_collectives")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp / "rendezvous"), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs])
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def jax_pair():
    """A 2-device process set of the JAX package's 8-device CPU world (one
    that another test module left registered is used as it is)."""
    import horovod_tpu as jhvd
    from test_torch_optimizer import _jax_set

    ps, own = _jax_set([0, 1])
    yield jhvd, ps
    if own:
        jhvd.remove_process_set(ps)


def test_world_facts(port_results):
    for r, res in enumerate(port_results):
        assert int(res["rank"]) == r and int(res["size"]) == WORLD


@pytest.mark.parametrize("op", OPS)
def test_allreduce_matches_jax(port_results, jax_pair, op):
    jhvd, ps = jax_pair
    src = _data()["p" if op == "product" else "x"]
    for pre, post in SCALES:
        want = np.asarray(jhvd.allreduce(src, op=op, prescale_factor=pre,
                                         postscale_factor=post,
                                         process_set=ps))
        for r, res in enumerate(port_results):
            np.testing.assert_allclose(res[f"allreduce.{op}.{pre}.{post}"],
                                       want[r], **TOL)


def test_allgather_matches_jax(port_results, jax_pair):
    jhvd, ps = jax_pair
    want = np.asarray(jhvd.allgather(_data()["x"], process_set=ps))
    for r, res in enumerate(port_results):
        np.testing.assert_array_equal(res["allgather"], want[r])


@pytest.mark.parametrize("case", ["ragged", "empty"])
def test_ragged_allgather_concatenates_on_every_rank(port_results, case):
    parts = _ragged()[case]
    want = np.concatenate(parts)
    assert want.shape == (5 if case == "ragged" else 2, 3)
    for res in port_results:
        np.testing.assert_array_equal(res[f"allgather.{case}"], want)


def test_allgather_with_mismatched_trailing_dims_raises_on_every_rank(
        port_results):
    # Both processes went on to the later collectives and exited 0
    # (port_results checks the exit codes).
    for res in port_results:
        assert "allgather.mismatch" not in res
        msg = str(res["allgather.mismatch.error"])
        assert "[2, 3] torch.float32" in msg and "[3, 4] torch.float32" in msg


@pytest.mark.parametrize("root", range(WORLD))
def test_broadcast_matches_jax(port_results, jax_pair, root):
    jhvd, ps = jax_pair
    want = np.asarray(jhvd.broadcast(_data()["x"], root_rank=root,
                                     process_set=ps))
    for r, res in enumerate(port_results):
        np.testing.assert_array_equal(res[f"broadcast.{root}"], want[r])


def test_grouped_and_fused_allreduce_match_jax(port_results, jax_pair):
    jhvd, ps = jax_pair
    grads = _data()["g"]
    grouped = [np.asarray(a) for a in jhvd.grouped_allreduce(
        grads, op=jhvd.Average, process_set=ps)]
    summed = [np.asarray(a) for a in jhvd.grouped_allreduce(
        grads, op=jhvd.Sum, prescale_factor=0.5, process_set=ps)]
    for r, res in enumerate(port_results):
        for i in range(len(grads)):
            np.testing.assert_allclose(res[f"grouped.{i}"], grouped[i][r],
                                       **TOL)
            np.testing.assert_allclose(res[f"fused.{i}"], summed[i][r],
                                       **TOL)


@pytest.mark.parametrize("sizes,threshold", [
    ([(4, "float32"), (6, "float32"), (5, "float32"), (1, "float32"),
      (9, "float32")], 48),
    ([(4, "float32"), (6, "bfloat16"), (5, "bfloat16"), (100, "float32"),
      (2, "float32")], 64),
    ([(3, "float32")] * 4, 0),
    ([(8, "float16"), (8, "float16"), (1000, "float16")], None),
])
def test_bucket_leaves_equals_jax(sizes, threshold):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.ops.fusion import bucket_leaves as jax_buckets
    from horovod_tpu_torch.ops.fusion import bucket_leaves

    leaves = [jax.ShapeDtypeStruct((n,), jnp.dtype(dt)) for n, dt in sizes]
    port = bucket_leaves([(n, getattr(torch, dt)) for n, dt in sizes],
                         threshold)
    assert port == jax_buckets(leaves, threshold)


def test_init_needs_cuda_unless_cpu_is_asked():
    code = (
        "import horovod_tpu_torch as hvd, torch\n"
        "assert not torch.cuda.is_available()\n"
        "try:\n"
        "    hvd.init()\n"
        "except RuntimeError as e:\n"
        "    assert \"device='cpu'\" in str(e), e\n"
        "else:\n"
        "    raise SystemExit('init() formed a world without CUDA')\n"
        "assert not hvd.is_initialized()\n"
        "hvd.init(device='cpu')\n"
        "assert hvd.is_initialized() and hvd.device().type == 'cpu'\n"
        "assert hvd.size() == 1 and hvd.rank() == 0\n"
        "hvd.shutdown()\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_error_probes():
    """The verify probes: API before init -> NotInitializedError naming
    init(); bad op / out-of-range root -> ValueError listing the valid
    options."""
    code = (
        "import torch, horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch import NotInitializedError\n"
        "for call in (hvd.size, hvd.rank, lambda: hvd.allreduce(torch.ones(2))):\n"
        "    try:\n"
        "        call()\n"
        "    except NotInitializedError as e:\n"
        "        assert 'horovod_tpu_torch.init()' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no NotInitializedError')\n"
        "hvd.init(device='cpu')\n"
        "for call, needle in (\n"
        "        (lambda: hvd.allreduce(torch.ones(2), op='mean'), \"'product'\"),\n"
        "        (lambda: hvd.broadcast(torch.ones(2), root_rank=1), '[0]'),\n"
        "        (lambda: hvd.broadcast_parameters({}, root_rank=2), '[0]'),\n"
        "        (lambda: hvd.DistributedOptimizer(\n"
        "            torch.optim.SGD([torch.nn.Parameter(torch.ones(1))], 0.1),\n"
        "            sync_mode='zero'), 'allreduce')):\n"
        "    try:\n"
        "        call()\n"
        "    except ValueError as e:\n"
        "        assert needle in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no ValueError')\n"
        "hvd.shutdown()\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
