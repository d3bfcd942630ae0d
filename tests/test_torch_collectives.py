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
import socket
import subprocess
import sys
import textwrap

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


# Integer Average and scale factors, held to the reference's per-process
# path: two NativeWorld processes (horovod_tpu/runtime), whose ScaleBuffer
# (runtime/cpp/transport.cc:147) rounds llround(x * factor) in float64 and
# keeps the dtype, once for the prescale, once for Average's 1 / n and once
# for the postscale (runtime.cc:268-276; reducescatter :414). The JAX
# package's stacked-rank path is no reference here, as it disagrees with the
# per-process one in two places: its integer Average is lax.pmean's float32
# mean (horovod_tpu/ops/collective_ops.py:172), and its reducescatter rounds
# postscale / n to the integer dtype, so an Average gives zeros (:218-223).
# Each case: name, collective, op, prescale, postscale, then rank 0's and
# rank 1's values.
INT_CASES = (
    ("allreduce_average_int32", "allreduce", "average", 1.0, 1.0,
     np.array([0, 1, 2], np.int32), np.array([3, 4, 5], np.int32)),
    ("allreduce_average_int64", "allreduce", "average", 1.0, 1.0,
     np.array([-3, -1, 4, 2**40 + 1], np.int64),
     np.array([0, -2, -1, 2**40], np.int64)),
    ("allreduce_sum_prescale_0.5", "allreduce", "sum", 0.5, 1.0,
     np.array([0, 1, 2], np.int32), np.array([3, 4, 5], np.int32)),
    ("allreduce_sum_postscale_2.5", "allreduce", "sum", 1.0, 2.5,
     np.array([0, 1, 2], np.int32), np.array([3, 4, 5], np.int32)),
    ("allreduce_async__sum_prescale_0.5", "allreduce_async_", "sum", 0.5,
     1.0, np.array([-3, 1, 7], np.int32), np.array([0, 4, -5], np.int32)),
    ("grouped_allreduce_average", "grouped_allreduce", "average", 1.0, 1.0,
     np.array([0, 1, 2, 7, -9], np.int32),
     np.array([3, 4, 5, -2, 6], np.int32)),
    ("reducescatter_average", "reducescatter", "average", 1.0, 1.0,
     np.array([1, 2, 3, 4], np.int32), np.array([6, 7, 8, 9], np.int32)),
    ("reducescatter_async_average", "reducescatter_async", "average", 1.0,
     1.0, np.array([1, -2, 3, 5], np.int64),
     np.array([6, -7, 8, 0], np.int64)),
)
# The grouped case splits its values into two tensors at this index.
GROUPED_SPLIT = 2


def _port_int_case(hvd, rank, kind, op, pre, post, values):
    x = torch.from_numpy(values[rank].copy())
    if kind == "allreduce":
        return [hvd.allreduce(x, op=op, prescale_factor=pre,
                              postscale_factor=post)]
    if kind == "allreduce_async_":
        out = hvd.synchronize(hvd.allreduce_async_(
            x, op=op, prescale_factor=pre, postscale_factor=post))
        assert out is x  # in place, dtype kept
        return [out]
    if kind == "grouped_allreduce":
        return hvd.grouped_allreduce(
            [x[:GROUPED_SPLIT], x[GROUPED_SPLIT:]], op=op,
            prescale_factor=pre, postscale_factor=post)
    if kind == "reducescatter":
        return [hvd.reducescatter(x, op=op, prescale_factor=pre,
                                  postscale_factor=post)]
    return [hvd.synchronize(hvd.reducescatter_async(x, op=op))]


NATIVE_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    sys.path.insert(0, os.environ["REPO_ROOT"])
    sys.path.insert(0, os.environ["TEST_DIR"])
    from horovod_tpu.runtime import NativeWorld
    from test_torch_collectives import GROUPED_SPLIT, INT_CASES

    rank = int(os.environ["TEST_RANK"])
    w = NativeWorld(rank, 2, "127.0.0.1", int(os.environ["TEST_PORT"]),
                    timeout_s=30.0)
    res = {}
    for name, kind, op, pre, post, *values in INT_CASES:
        x = values[rank].copy()
        if kind == "allreduce":
            out = [w.allreduce(x, name, op=op, prescale_factor=pre,
                               postscale_factor=post)]
        elif kind == "allreduce_async_":
            out = [w.synchronize(w.allreduce_async_(
                x, name, op=op, prescale_factor=pre,
                postscale_factor=post))]
        elif kind == "grouped_allreduce":
            out = w.grouped_allreduce(
                [x[:GROUPED_SPLIT], x[GROUPED_SPLIT:]], name, op=op,
                prescale_factor=pre, postscale_factor=post)
        elif kind == "reducescatter":
            out = [w.reducescatter(x, name, op=op)]
        else:
            out = [w.synchronize(w.reducescatter_async(x, name, op=op))]
        for i, t in enumerate(out):
            res[f"{name}.{i}"] = np.asarray(t)
    np.savez(os.path.join(os.environ["OUT_DIR"], f"native{rank}.npz"), **res)
    w.shutdown()
""")


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
    for name, kind, op, pre, post, *values in INT_CASES:
        for i, t in enumerate(_port_int_case(hvd, rank, kind, op, pre, post,
                                             values)):
            res[f"{name}.{i}"] = t.numpy()
    res["reducescatter.float32"] = hvd.reducescatter(
        torch.from_numpy(d["x"][rank][:WORLD]), op=hvd.Average,
        prescale_factor=2.0,
        postscale_factor=0.5).numpy()
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
def native_results(tmp_path_factory):
    """Every INT_CASES collective run by two NativeWorld processes over
    localhost TCP, as tests/test_native_runtime.py starts them."""
    tmp = tmp_path_factory.mktemp("native_collectives")
    script = tmp / "native_worker.py"
    script.write_text(NATIVE_WORKER)
    with socket.socket() as sock:
        sock.bind(("", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, str(script)],
        env=dict(os.environ, REPO_ROOT=os.path.dirname(here), TEST_DIR=here,
                 TEST_RANK=str(r), TEST_PORT=str(port), OUT_DIR=str(tmp)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    outs = []
    for r, p in enumerate(procs):
        try:
            outs.append(p.communicate(timeout=120))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"native rank {r} timed out")
    assert all(p.returncode == 0 for p in procs), outs
    return [dict(np.load(tmp / f"native{r}.npz")) for r in range(WORLD)]


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


@pytest.mark.parametrize("case", INT_CASES, ids=[c[0] for c in INT_CASES])
def test_integer_scaling_matches_native_runtime(port_results, native_results,
                                                case):
    name = case[0]
    for port, native in zip(port_results, native_results):
        keys = sorted(k for k in native if k.startswith(name + "."))
        assert keys and keys == sorted(k for k in port
                                       if k.startswith(name + "."))
        for k in keys:
            assert port[k].dtype == native[k].dtype == case[5].dtype, k
            np.testing.assert_array_equal(port[k], native[k], err_msg=k)


def test_integer_average_rounds_half_away_from_zero(port_results):
    """The values the reference's runtime gives (ROADMAP's C4 record):
    [0, 1, 2] and [3, 4, 5] average to [2, 3, 4], as they sum to it with a
    prescale of 0.5; [1, 2, 3, 4] and [6, 7, 8, 9] reduce-scatter to
    [4, 5] and [6, 7]."""
    for r, res in enumerate(port_results):
        for name in ("allreduce_average_int32",
                     "allreduce_sum_prescale_0.5"):
            np.testing.assert_array_equal(res[f"{name}.0"], [2, 3, 4])
        np.testing.assert_array_equal(res["allreduce_sum_postscale_2.5.0"],
                                      [8, 13, 18])
        np.testing.assert_array_equal(res["reducescatter_average.0"],
                                      [[4, 5], [6, 7]][r])
        np.testing.assert_array_equal(res["allreduce_average_int64.0"],
                                      [-2, -2, 2, 2**40 + 1])


@pytest.mark.parametrize("pre,post", SCALES)
def test_float_average_is_bitwise_unchanged(port_results, pre, post):
    """Float tensors keep their single multiplies by factors rounded to the
    dtype: allreduce (x0 pre + x1 pre) / n * post, reducescatter
    (x0 pre + x1 pre) * (post / n), each step in float32."""
    x = [torch.from_numpy(a) for a in _data()["x"]]

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    summed = x[0] * f32(pre) + x[1] * f32(pre)
    want = summed / WORLD * f32(post)
    rs_sum = x[0][:WORLD] * f32(2.0) + x[1][:WORLD] * f32(2.0)
    want_rs = rs_sum * f32(0.5 / WORLD)
    for r, res in enumerate(port_results):
        assert torch.equal(torch.from_numpy(
            res[f"allreduce.average.{pre}.{post}"]), want)
        assert torch.equal(torch.from_numpy(res["reducescatter.float32"]),
                           want_rs[r:r + 1])


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int32,
                                   torch.int64])
def test_integer_scale_helpers(dtype):
    """The in-place helpers every integer path shares: float64 scale, round
    half away from zero, dtype kept; Average's 1 / n and the postscale
    rounded apart."""
    from horovod_tpu_torch.ops.collective_ops import (
        _average_and_postscale_, _divide_, _scale_)

    values = [0, 1, 3, 5, 7, 9, 40]
    if dtype.is_signed:
        values += [-1, -3, -5, -7]
    t = torch.tensor(values, dtype=dtype)
    _scale_(t, 0.5)
    want = [int(np.sign(v) * np.floor(abs(v) * 0.5 + 0.5)) for v in values]
    assert t.dtype == dtype and t.tolist() == want
    t = torch.tensor(values, dtype=dtype)
    _divide_(t, 2)
    assert t.tolist() == want
    t = torch.tensor(values, dtype=dtype)
    _average_and_postscale_(t, "average", 3.0, 2)
    assert t.dtype == dtype and t.tolist() == [
        int(np.sign(w) * np.floor(abs(w) * 3.0 + 0.5)) for w in want]
    t = torch.tensor(values, dtype=dtype)
    _average_and_postscale_(t, "sum", 1.0, 2)
    assert t.tolist() == values


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
