"""The port's Adasum (horovod_tpu_torch.ops.adasum, ``op=Adasum`` of the
eager allreduce and of the DistributedOptimizer) against the JAX package's.

- ``adasum_pair`` / ``adasum_tree`` against ``horovod_tpu.ops.adasum``
  (float32: 1e-5 relative + 1e-7 absolute) and against the float64 tree
  ``horovod_tpu.process_world.adasum_tree_np`` at N = 1-5 and 8, with a
  zero member, and in bf16 and fp16 (each pair's result rounded to the
  dtype on both sides: within 2e-2 and 5e-3 of the largest value).
- The eager ``allreduce(op=Adasum)`` (and ``allreduce_``) on 4 gloo ranks
  (one spawn: the world, the set {1, 2, 3} and the set {0, 1}) and on 2
  (a second spawn), with and without pre- and post-scale, against row r of
  the JAX package's stacked-rank ``allreduce(op=Adasum)`` on a process set
  of as many devices, and the 2-rank world against 2 ``NativeWorld``
  processes running the reference torch surface's
  ``horovod_tpu.torch.allreduce(op=Adasum)`` (as tests/test_torch_
  collectives.py does for integers); every member's result is the same
  bit for bit. On the same 4 ranks, ``DistributedOptimizer(op=Adasum)``
  on the bf16 wire with pre- and post-scale, at three fusion thresholds
  (one bucket per leaf, several, one), gives each gradient exactly what
  the eager Adasum gives it on the same wire: the tree runs per tensor,
  whatever the bucketing.
- The forms the reference rejects raise with its messages: async, grouped,
  reducescatter, ``num_groups``, and the sharded and fsdp sync modes.
- Three data-parallel SGD-momentum steps of BERT_TINY with
  ``DistributedOptimizer(op=Adasum)`` on 2 ranks against the JAX package's
  optimizer with ``op=Adasum`` on a 2-device set: losses 1e-5 relative,
  parameters 1e-4 relative + 1e-5 absolute (summation order; Adasum's
  scale factors of a near-zero gradient, such as the key bias's, are
  ratios of rounding noise, bounded by the absolute term).
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

# pre- and post-scale pairs of the eager cases.
SCALES = ((1.0, 1.0), (2.0, 0.5))
# The sets of the 4-rank spawn (the world first).
SETS4 = ([0, 1, 2, 3], [1, 2, 3], [0, 1])
TOL = dict(rtol=1e-5, atol=1e-7)
SGD_LR, SGD_MOMENTUM = 0.1, 0.9


def _members(n, shape, seed):
    """n per-rank tensors, correlated and of different scales (where
    Adasum differs from a sum), the second all zero."""
    rng = np.random.RandomState(seed)
    shared = rng.randn(*shape)
    out = np.stack([(r + 1) * (0.7 * shared + rng.randn(*shape))
                    for r in range(n)]).astype(np.float32)
    if n > 1:
        out[1] = 0.0
    return out


def _eager_inputs(n):
    return _members(n, (4, 6), 10 + n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_tree_matches_jax_and_float64(n):
    import jax.numpy as jnp

    from horovod_tpu.ops.adasum import adasum_tree as jax_tree
    from horovod_tpu.process_world import adasum_tree_np
    from horovod_tpu_torch.ops.adasum import adasum_tree

    x = _members(n, (7, 5), n)
    got = adasum_tree(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (7, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_tree(
        jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(got.numpy(), adasum_tree_np(
        list(x.astype(np.float64))), **TOL)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2),
                                       ("float16", 5e-3)])
@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_half_precision_tree_matches_jax_and_float64(n, dtype, tol):
    import jax.numpy as jnp

    from horovod_tpu.ops.adasum import adasum_tree as jax_tree
    from horovod_tpu.process_world import adasum_tree_np
    from horovod_tpu_torch.ops.adasum import adasum_tree

    t = torch.from_numpy(_members(n, (7, 5), n)).to(getattr(torch, dtype))
    x32 = t.float().numpy()  # the values both sides start from
    got = adasum_tree(t)
    assert got.dtype == t.dtype
    got = got.float().numpy()
    want = np.asarray(jax_tree(jnp.asarray(x32).astype(dtype))).astype(
        np.float32)
    f64 = adasum_tree_np(list(x32.astype(np.float64)))
    for ref in (want, f64):
        assert np.abs(got - ref).max() <= tol * np.abs(f64).max()


def test_pair_guards_zero_norms():
    from horovod_tpu_torch.ops.adasum import adasum_pair

    a = torch.tensor([1.0, -2.0, 3.0])
    zero = torch.zeros(3)
    assert torch.equal(adasum_pair(zero, a), a)
    assert torch.equal(adasum_pair(a, zero), a)
    assert torch.equal(adasum_pair(zero, zero), zero)
    # Identical vectors combine to themselves, orthogonal ones to their sum.
    assert torch.allclose(adasum_pair(a, a), a)
    b = torch.tensor([2.0, 1.0, 0.0])
    assert torch.allclose(adasum_pair(a, b), a + b)


def _worker4(rank, init_file, out_dir):
    """One of 4 ranks: Adasum on the world and on the sets of SETS4."""
    os.environ["HOROVOD_NUM_PROCESSES"] = "4"
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    sets = [hvd.global_process_set] + [hvd.add_process_set(s)
                                       for s in SETS4[1:]]
    res = {}
    for ranks, ps in zip(SETS4, sets):
        if rank not in ranks:
            continue
        x = torch.from_numpy(_eager_inputs(len(ranks))[ranks.index(rank)])
        for pre, post in SCALES:
            key = f"{ranks}.{pre}.{post}"
            res[key] = hvd.allreduce(x, op=hvd.Adasum, prescale_factor=pre,
                                     postscale_factor=post,
                                     process_set=ps).numpy()
            inplace = x.clone()
            assert hvd.allreduce_(inplace, op=hvd.Adasum,
                                  prescale_factor=pre, postscale_factor=post,
                                  process_set=ps) is inplace
            res[f"{key}.inplace"] = inplace.numpy()
        res[f"{ranks}.optimizer"] = np.array(_optimizer_matches_eager(
            hvd, ps, ranks.index(rank)))
    hvd.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


def _optimizer_matches_eager(hvd, ps, member):
    """The optimizer's Adasum (bf16 wire, pre- and post-scale, one gather
    per bucket, three fusion thresholds) gives each gradient exactly what
    the eager allreduce(op=Adasum) gives it on the same wire."""
    shapes = [(3, 5), (7,), (2, 2, 4), (1,)]
    rng = np.random.RandomState(50 + member)
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32))
             for s in shapes]
    want = [hvd.allreduce(g.bfloat16(), op=hvd.Adasum, prescale_factor=0.5,
                          postscale_factor=3.0, process_set=ps).float()
            for g in grads]
    same = []
    for threshold in (0, 40, 1 << 20):
        params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(params, lr=0.1), op=hvd.Adasum,
            compression=hvd.Compression.bf16, prescale_factor=0.5,
            postscale_factor=3.0, process_set=ps,
            fusion_threshold_bytes=threshold)
        for p, g in zip(params, grads):
            p.grad = g.clone()
        opt.synchronize()
        same.append(all(torch.equal(p.grad, w) for p, w in zip(params, want)))
        opt.remove_hooks()
    return same


def _bert_worker(rank, init_file, out_dir, flax_params, batches):
    """One of 2 ranks: the world's eager Adasum, then BERT_TINY trained
    with DistributedOptimizer(op=Adasum)."""
    os.environ["HOROVOD_NUM_PROCESSES"] = "2"
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    import horovod_tpu_torch as hvd
    from test_torch_bert import B_PER_RANK, _port_bert, _port_loss

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    res = {}
    x = torch.from_numpy(_eager_inputs(2)[rank])
    for pre, post in SCALES:
        res[f"world.{pre}.{post}"] = hvd.allreduce(
            x, op=hvd.Adasum, prescale_factor=pre,
            postscale_factor=post).numpy()
    model = _port_bert(flax_params)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=SGD_LR, momentum=SGD_MOMENTUM),
        named_parameters=model.named_parameters(), op=hvd.Adasum)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    step = hvd.make_train_step(model, _port_loss, opt)
    rows = slice(rank * B_PER_RANK, (rank + 1) * B_PER_RANK)
    res["losses"] = np.array([float(step(tuple(
        torch.from_numpy(a[rows]).long() for a in batch)))
        for batch in batches])
    for k, v in model.state_dict().items():
        res[f"param.{k}"] = v.numpy()
    opt.remove_hooks()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


def _spawn(target, n, tmp, *args):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, str(tmp / "rendezvous"), str(tmp), *args))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs])
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(n)]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawn(_worker4, 4, tmp_path_factory.mktemp("adasum4"))


@pytest.fixture(scope="module")
def flax_bert():
    from test_torch_bert import _flax_bert

    return _flax_bert()


NATIVE_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    sys.path.insert(0, os.environ["REPO_ROOT"])
    sys.path.insert(0, os.environ["TEST_DIR"])
    import torch
    import horovod_tpu.torch as hvd
    from test_torch_adasum import SCALES, _eager_inputs

    hvd.init()
    rank = hvd.rank()
    x = torch.from_numpy(_eager_inputs(2)[rank])
    res = {}
    for pre, post in SCALES:
        res[f"world.{pre}.{post}"] = hvd.allreduce(
            x, op=hvd.Adasum, prescale_factor=pre, postscale_factor=post,
            name=f"ada.{pre}.{post}").numpy()
    np.savez(os.path.join(os.environ["OUT_DIR"], f"native{rank}.npz"), **res)
    hvd.shutdown()
""")


def _start_native(tmp, source):
    """Two processes of ``source`` (a script on the reference torch
    surface) in a NativeWorld over localhost TCP, started in the
    background; each saves ``native{rank}.npz`` under ``tmp``."""
    script = tmp / "native_worker.py"
    script.write_text(source)
    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("", 0))
            ports.append(sock.getsockname()[1])
    here = os.path.dirname(os.path.abspath(__file__))
    return [subprocess.Popen(
        [sys.executable, str(script)],
        env=dict(os.environ, REPO_ROOT=os.path.dirname(here), TEST_DIR=here,
                 OUT_DIR=str(tmp), HOROVOD_NUM_PROCESSES="2",
                 HOROVOD_PROCESS_ID=str(r),
                 HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{ports[0]}",
                 HOROVOD_NATIVE_PORT=str(ports[1])),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]


def _native_results(procs, tmp):
    outs = []
    for r, p in enumerate(procs):
        try:
            outs.append(p.communicate(timeout=120))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"native rank {r} timed out")
    assert all(p.returncode == 0 for p in procs), outs
    return [dict(np.load(tmp / f"native{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def two_ranks_and_native(tmp_path_factory, flax_bert):
    """The port's 2-rank spawn and the reference torch surface's Adasum
    allreduce on two NativeWorld processes (its per-process form,
    ``process_world.adasum_allreduce_host``), run side by side."""
    from test_torch_bert import _batches

    model, params = flax_bert
    native_tmp = tmp_path_factory.mktemp("adasum_native")
    native = _start_native(native_tmp, NATIVE_WORKER)
    try:
        port = _spawn(_bert_worker, 2, tmp_path_factory.mktemp("adasum2"),
                      params, _batches(model.config.vocab_size))
    finally:
        ref = _native_results(native, native_tmp)
    return port, ref


def _jax_adasum(ranks, pre, post):
    """Row i of the JAX package's stacked-rank Adasum over ``ranks``."""
    import horovod_tpu as jhvd
    from test_torch_optimizer import _jax_set

    ps, own = _jax_set(ranks)
    try:
        return np.asarray(jhvd.allreduce(
            _eager_inputs(len(ranks)), op=jhvd.Adasum, prescale_factor=pre,
            postscale_factor=post, process_set=ps))
    finally:
        if own:
            jhvd.remove_process_set(ps)


@pytest.mark.parametrize("ranks", SETS4, ids=["world4", "set123", "set01"])
def test_eager_adasum_on_four_ranks_matches_jax(four_ranks, ranks):
    for pre, post in SCALES:
        want = _jax_adasum(ranks, pre, post)
        key = f"{ranks}.{pre}.{post}"
        first = four_ranks[ranks[0]][key]
        for i, r in enumerate(ranks):
            np.testing.assert_allclose(four_ranks[r][key], want[i], **TOL)
            # Every member computes the same tree: the same bits.
            assert np.array_equal(four_ranks[r][key], first)
            assert np.array_equal(four_ranks[r][f"{key}.inplace"], first)
        for r in set(range(4)) - set(ranks):
            assert key not in four_ranks[r]
    for r in ranks:
        assert four_ranks[r][f"{ranks}.optimizer"].tolist() == [True] * 3


def test_eager_adasum_on_two_ranks_matches_jax_and_the_native_world(
        two_ranks_and_native):
    two_ranks, native_results = two_ranks_and_native
    for pre, post in SCALES:
        key = f"world.{pre}.{post}"
        want = _jax_adasum([0, 1], pre, post)
        for r in range(2):
            np.testing.assert_allclose(two_ranks[r][key], want[r], **TOL)
            np.testing.assert_allclose(two_ranks[r][key],
                                       native_results[r][key], **TOL)
            assert np.array_equal(two_ranks[r][key], two_ranks[0][key])


def _raised(call):
    with pytest.raises(Exception) as info:
        call()
    return type(info.value).__name__, str(info.value)


def test_the_forms_the_reference_rejects_raise_with_its_messages(
        monkeypatch):
    import optax

    import horovod_tpu as jhvd
    import horovod_tpu.torch as ref
    import horovod_tpu_torch as hvd

    t = torch.ones(4)
    param = [torch.nn.Parameter(torch.ones(2))]
    sgd = torch.optim.SGD(param, lr=0.1)
    want = {
        "async": _raised(lambda: ref.allreduce_async(t, op=ref.Adasum)),
        "async_": _raised(lambda: ref.allreduce_async_(t, op=ref.Adasum)),
        "grouped": _raised(lambda: ref.grouped_allreduce([t], op=ref.Adasum)),
        "grouped_async": _raised(
            lambda: ref.grouped_allreduce_async([t], op=ref.Adasum)),
        "num_groups": _raised(lambda: ref.DistributedOptimizer(
            sgd, named_parameters=[("w", param[0])], op=ref.Adasum,
            num_groups=2)),
        "sharded": _raised(lambda: jhvd.DistributedOptimizer(
            optax.sgd(0.1), op=jhvd.Adasum, sync_mode="sharded")),
        "fsdp": _raised(lambda: jhvd.DistributedOptimizer(
            optax.sgd(0.1), op=jhvd.Adasum, sync_mode="fsdp")),
    }
    for key in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(key)
    hvd.init(device="cpu")
    try:
        got = {
            "async": _raised(lambda: hvd.allreduce_async(t, op=hvd.Adasum)),
            "async_": _raised(lambda: hvd.allreduce_async_(t, op=hvd.Adasum)),
            "grouped": _raised(
                lambda: hvd.grouped_allreduce([t], op=hvd.Adasum)),
            "grouped_async": _raised(
                lambda: hvd.grouped_allreduce_async([t], op=hvd.Adasum)),
            "num_groups": _raised(lambda: hvd.DistributedOptimizer(
                sgd, op=hvd.Adasum, num_groups=2)),
            "sharded": _raised(lambda: hvd.DistributedOptimizer(
                sgd, op=hvd.Adasum, sync_mode="sharded")),
            "fsdp": _raised(lambda: hvd.DistributedOptimizer(
                sgd, op=hvd.Adasum, sync_mode="fsdp")),
        }
        assert got == want
        # reducescatter takes no Adasum, in any form (collective_ops.py:213).
        for call in (hvd.reducescatter, hvd.reducescatter_async):
            name, msg = _raised(lambda: call(t, op=hvd.Adasum))
            assert name == "ValueError" and "'adasum'" in msg
        name, msg = _raised(
            lambda: hvd.grouped_reducescatter([t], op=hvd.Adasum))
        assert name == "ValueError" and "'adasum'" in msg
        # One member and no forced wire: the identity times the scales.
        assert torch.equal(hvd.allreduce(t * 3, op=hvd.Adasum,
                                         prescale_factor=0.5,
                                         postscale_factor=4.0), t * 6)
    finally:
        hvd.shutdown()


def _jax_adasum_trajectory(model, params, batches):
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as jhvd
    from horovod_tpu.models.bert import mlm_loss
    from horovod_tpu.parallel import data_parallel as dp
    from test_torch_optimizer import _jax_set

    def loss_fn(p, batch):
        ids, pos, labels, lmask = batch
        _, logits = model.apply({"params": p}, ids, masked_positions=pos)
        return mlm_loss(logits, labels, lmask)

    ps, own = _jax_set([0, 1])
    try:
        opt = jhvd.DistributedOptimizer(
            optax.sgd(SGD_LR, momentum=SGD_MOMENTUM), op=jhvd.Adasum,
            process_set=ps)
        step = dp.make_train_step(loss_fn, opt, mesh=ps.mesh,
                                  axis_name=ps.axis_name)
        jparams = jax.tree.map(jnp.asarray, params)
        p = dp.replicate(jparams, mesh=ps.mesh)
        s = dp.replicate(opt.init(jparams), mesh=ps.mesh)
        losses = []
        for batch in batches:
            p, s, loss = step(p, s, dp.shard_batch(
                tuple(jnp.asarray(a) for a in batch), mesh=ps.mesh,
                axis_name=ps.axis_name))
            losses.append(float(loss))
        return np.array(losses), jax.tree.map(np.asarray, p)
    finally:
        if own:
            jhvd.remove_process_set(ps)


def test_adasum_optimizer_trajectory_matches_jax(two_ranks_and_native,
                                                  flax_bert):
    from horovod_tpu_torch.models.convert import bert_params_from_flax
    from test_torch_bert import _batches

    two_ranks = two_ranks_and_native[0]
    model, params = flax_bert
    losses, final = _jax_adasum_trajectory(
        model, params, _batches(model.config.vocab_size))
    want = bert_params_from_flax(final)
    start = bert_params_from_flax(params)
    moved = 0
    for r in range(2):
        np.testing.assert_allclose(two_ranks[r]["losses"], losses, rtol=1e-5)
        for key, w in want.items():
            got = two_ranks[r][f"param.{key}"]
            np.testing.assert_allclose(got, w.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=key)
            assert np.array_equal(got, two_ranks[0][f"param.{key}"]), key
            moved += not np.array_equal(got, start[key].numpy())
    assert losses[-1] < losses[0] and moved > len(want)
