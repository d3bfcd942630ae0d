"""The port's int8 wire (``horovod_tpu_torch/ops/quantization.py``) against
the JAX package's ``horovod_tpu/ops/quantization.py``.

``_sround`` and ``_quantize_blocks`` must agree bit for bit on the same
float32 inputs (salted and unsalted; tripwire armed and unarmed; NaN and
+-Inf in the input). The collectives run once over four gloo ranks (one
spawn for the module) and once in the JAX package over four CPU devices
under ``shard_map``, on the same seeded per-rank inputs; rank r's result
is held to row r of the JAX result:

- within one quantum (``max |input| / 127``, the largest block scale) for
  each quantization a value passes through: one for
  ``int8_alltoall_rows``, ``int8_fused_reducescatter`` and
  ``int8_fused_allgather_shards``, two (the input's and the reduced
  output's) for ``int8_allreduce_flat``. The rounding offset hashes each
  value's bits, so a value one ulp apart may round the other way: the
  float32 sums of the two packages differ in order, and the JAX package's
  compiled program under ``shard_map`` does not always reproduce its own
  eager quotients bit for bit (its eager ``_quantize_blocks`` is what the
  port matches exactly, above).
"""

import multiprocessing as mp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.ops import quantization as jq
from horovod_tpu_torch.ops import quantization as tq

N = 4
BLOCK = jq.BLOCK
SALT = 5
# The reduce-scatter's and allgather's leaves: ragged sizes, one past a
# block, spread over buckets by a small threshold.
SHAPES = [(37,), (64, 33), (5, 7, 11), (2000,)]
THRESHOLD = 8 * 1024


def _special_values(seed=0, m=4 * BLOCK):
    """float32 values over many magnitudes, with NaN, +-Inf, a run of zeros
    and a run of one repeated value."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(m) * rng.choice([1e-3, 1.0, 1e3], m)).astype(np.float32)
    x[5], x[BLOCK + 6], x[2 * BLOCK + 52] = np.nan, np.inf, -np.inf
    x[3 * BLOCK: 3 * BLOCK + 100] = 0.0
    x[3 * BLOCK + 100: 3 * BLOCK + 200] = 1.5
    return x


def _jax_salt(salt):
    return None if salt is None else np.uint32(salt)


@pytest.mark.parametrize("salt", [None, 0, 7, 2**32 - 3])
def test_sround_is_bit_exact(salt):
    rng = np.random.RandomState(1)
    x = (rng.uniform(-130, 130, 8192)).astype(np.float32)
    x[:4] = [0.0, -0.0, 126.99999, -127.5]
    want = np.asarray(jq._sround(jnp.asarray(x), _jax_salt(salt)))
    got = tq._sround(torch.from_numpy(x), salt).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("armed", [False, True], ids=["unarmed", "armed"])
@pytest.mark.parametrize("salt", [None, 3], ids=["unsalted", "salted"])
def test_quantize_blocks_is_bit_exact(monkeypatch, armed, salt):
    """Unarmed, NaN and +-Inf saturate before the scale; armed, a block
    holding one gets scale +Inf. Both packages alike, bit for bit."""
    if armed:
        monkeypatch.setenv("HOROVOD_NONFINITE_ACTION", "warn")
    else:
        monkeypatch.delenv("HOROVOD_NONFINITE_ACTION", raising=False)
    x = _special_values()
    wq, ws = (np.asarray(a) for a in jq._quantize_blocks(
        jnp.asarray(x), _jax_salt(salt)))
    gq, gs = (a.numpy() for a in tq._quantize_blocks(
        torch.from_numpy(x), salt))
    np.testing.assert_array_equal(gq, wq)
    np.testing.assert_array_equal(gs, ws)
    assert np.isinf(gs).sum() == (3 if armed else 0)


def _inputs():
    rng = np.random.RandomState(2)
    flat = rng.randn(N, 3 * BLOCK + 77).astype(np.float32)
    leaves = [rng.randn(N, *s).astype(np.float32) for s in SHAPES]
    sizes = [-(-int(np.prod(s)) // N) for s in SHAPES]
    shards = [rng.randn(N, s).astype(np.float32) for s in sizes]
    rows = rng.randn(N, N, 700).astype(np.float32)
    return flat, leaves, shards, rows


def _worker(rank, init_file, out_dir):
    os.environ["HOROVOD_NUM_PROCESSES"] = str(N)
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import global_process_set as ps

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    flat, leaves, shards, rows = _inputs()
    t = torch.from_numpy
    res = {"allreduce": tq.int8_allreduce_flat(
        t(flat[rank]), ps, "average", salt=SALT).numpy()}
    for i, s in enumerate(tq.int8_fused_reducescatter(
            [t(x[rank]) for x in leaves], ps, "average", THRESHOLD,
            salt=SALT)):
        res[f"rs{i}"] = s.numpy()
    templates = [torch.empty(s, device="meta") for s in SHAPES]
    for i, f in enumerate(tq.int8_fused_allgather_shards(
            [t(x[rank]) for x in shards], templates, ps, THRESHOLD,
            salt=SALT)):
        res[f"ag{i}"] = f.numpy()
    res["a2a"] = tq.int8_alltoall_rows(t(rows[rank]), ps, salt=SALT)[0].numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_quantization")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp / "rendezvous"), str(tmp)))
             for r in range(N)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs])
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]


def _jax_run(fn, *arrays):
    """``fn`` under shard_map over 4 CPU devices, each array's row r on
    device r; outputs stacked by rank."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("w",))
    n_in = len(arrays)
    wrapped = jax.shard_map(
        lambda *xs: [o[None] for o in fn(*[x[0] for x in xs])],
        mesh=mesh, in_specs=(P("w"),) * n_in, out_specs=P("w"),
        check_vma=False)
    return [np.asarray(o) for o in jax.jit(wrapped)(*arrays)]


def _within(got, want, quantum, what):
    err = np.abs(got - want).max()
    assert err <= 1.0001 * quantum, (what, err, quantum)


def _quantum(x):
    return np.abs(x).max() / 127.0


def test_int8_allreduce_matches_jax_rows(port_results):
    flat, _, _, _ = _inputs()
    (want,) = _jax_run(lambda x: [jq.int8_allreduce_flat(
        x, "w", N, op="average", salt=np.uint32(SALT))], flat)
    quantum = _quantum(flat) + _quantum(want)
    for r, res in enumerate(port_results):
        _within(res["allreduce"], want[r], quantum, f"allreduce rank {r}")
    # And the quantized mean is the mean within the wire's error.
    assert np.abs(want[0] - flat.mean(0)).max() < quantum


def test_int8_reducescatter_matches_jax_rows(port_results):
    _, leaves, _, _ = _inputs()
    want = _jax_run(lambda *xs: jq.int8_fused_reducescatter(
        list(xs), "w", N, op="average", threshold_bytes=THRESHOLD,
        salt=np.uint32(SALT)), *leaves)
    quantum = max(_quantum(x) for x in leaves)
    for r, res in enumerate(port_results):
        for i, w in enumerate(want):
            _within(res[f"rs{i}"], w[r], quantum, f"rs{i} rank {r}")


def test_int8_allgather_matches_jax_rows(port_results):
    _, _, shards, _ = _inputs()
    templates = [jnp.zeros(s) for s in SHAPES]
    want = _jax_run(lambda *xs: jq.int8_fused_allgather_shards(
        list(xs), templates, "w", N, threshold_bytes=THRESHOLD,
        salt=np.uint32(SALT)), *shards)
    quantum = max(_quantum(x) for x in shards)
    for r, res in enumerate(port_results):
        for i, w in enumerate(want):
            assert res[f"ag{i}"].shape == SHAPES[i]
            _within(res[f"ag{i}"], w[r], quantum, f"ag{i} rank {r}")


def test_int8_alltoall_rows_match_jax_rows(port_results):
    _, _, _, rows = _inputs()
    (want,) = _jax_run(lambda x: [jq.int8_alltoall_rows(
        x, "w", salt=np.uint32(SALT))[0]], rows)
    for r, res in enumerate(port_results):
        _within(res["a2a"], want[r], _quantum(rows), f"a2a rank {r}")
