"""The port's SyncBatchNorm (horovod_tpu_torch.SyncBatchNorm, torch's
conventions) and ``models.resnet.BatchNorm(process_set=...)`` (flax's)
against the JAX package's.

Two gloo ranks (one spawn) hold uneven halves of one batch: 5 and 3
images of 6 channels. Each runs both modules in training mode (two
iterations for the running statistics; the second module also with
``momentum=None``, the cumulative average), then evaluation, counting the
allreduces the modules launch. Held to:

- the reference torch surface's ``horovod_tpu.torch.SyncBatchNorm`` on two
  ``NativeWorld`` processes with the same halves (as tests/test_torch_
  collectives.py runs them): y and dx within 1e-5, dweight and dbias (each
  rank's own) within 1e-4, the running statistics within 1e-6;
- flax's ``horovod_tpu.SyncBatchNorm`` under ``shard_map`` over ``'hvd'``
  on the 8-device mesh (one image per device): y, dx, dscale and dbias
  (summed over the devices) within 1e-5 / 1e-4, and its batch statistics
  (momentum 0.9, biased variance) against ``BatchNorm(process_set=...)``'s
  within 1e-6;
- one process's ``torch.nn.functional.batch_norm`` in float64 over the
  concatenated batch (the ranks' dweight and dbias summed);
- evaluation launches no allreduce and normalizes with the running
  statistics.
"""

import os
import textwrap

import numpy as np
import pytest
import torch

SIZES = (5, 3)  # images per rank
C, H, W = 6, 4, 3
EPS = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD = dict(rtol=1e-4, atol=1e-4)
TOL_STATS = dict(rtol=1e-6, atol=1e-6)


def _data():
    """Two iterations' images and output cotangents, whole batches (NCHW),
    and the affine parameters."""
    rng = np.random.RandomState(0)
    n = sum(SIZES)
    xs = [(2.0 * rng.randn(n, C, H, W) + 0.5).astype(np.float32)
          for _ in range(2)]
    gs = [rng.randn(n, C, H, W).astype(np.float32) for _ in range(2)]
    weight = np.linspace(0.5, 1.5, C).astype(np.float32)
    bias = np.linspace(-0.5, 0.5, C).astype(np.float32)
    return xs, gs, weight, bias


def _rows(rank):
    start = sum(SIZES[:rank])
    return slice(start, start + SIZES[rank])


def _run(bn, rank, prefix, res):
    """Two training iterations and one evaluation of ``bn`` on this rank's
    rows: y, dx, dweight and dbias of the first, the running statistics
    after the second, and the evaluation output."""
    xs, gs, weight, bias = _data()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    for it in range(2):
        x = torch.from_numpy(xs[it][_rows(rank)]).requires_grad_()
        y = bn(x)
        y.backward(torch.from_numpy(gs[it][_rows(rank)]))
        if it == 0:
            res[f"{prefix}.y"] = y.detach().numpy()
            res[f"{prefix}.dx"] = x.grad.numpy()
            res[f"{prefix}.dweight"] = bn.weight.grad.numpy().copy()
            res[f"{prefix}.dbias"] = bn.bias.grad.numpy().copy()
    res[f"{prefix}.mean"] = bn.running_mean.numpy().copy()
    res[f"{prefix}.var"] = bn.running_var.numpy().copy()
    bn.eval()
    with torch.no_grad():
        res[f"{prefix}.eval"] = bn(torch.from_numpy(
            xs[1][_rows(rank)])).numpy()
    bn.train()


def _worker(rank, init_file, out_dir):
    os.environ["HOROVOD_NUM_PROCESSES"] = "2"
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.sync_batch_norm as sbn
    from horovod_tpu_torch.models.resnet import BatchNorm

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    calls = []
    allreduce = sbn.allreduce

    def counted(*args, **kwargs):
        calls.append(args[0].numel())
        return allreduce(*args, **kwargs)

    sbn.allreduce = counted
    res = {}
    for prefix, bn in (
            ("torch", hvd.SyncBatchNorm(C)),
            ("cumulative", hvd.SyncBatchNorm(C, momentum=None)),
            ("flax", BatchNorm(C, process_set=hvd.global_process_set))):
        before = len(calls)
        _run(bn, rank, prefix, res)
        # Two per training iteration (forward, backward), none in eval.
        res[f"{prefix}.allreduces"] = np.array(calls[before:])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """The port's two ranks, and the reference torch surface's
    SyncBatchNorm on two NativeWorld processes, run side by side."""
    from test_torch_adasum import _native_results, _spawn, _start_native

    native_tmp = tmp_path_factory.mktemp("native_syncbn")
    native = _start_native(native_tmp, NATIVE_WORKER)
    try:
        port = _spawn(_worker, 2, tmp_path_factory.mktemp("torch_syncbn"))
    finally:
        ref = _native_results(native, native_tmp)
    return port, ref


NATIVE_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    sys.path.insert(0, os.environ["REPO_ROOT"])
    sys.path.insert(0, os.environ["TEST_DIR"])
    import horovod_tpu.torch as hvd
    from test_torch_sync_batch_norm import C, _run

    hvd.init()
    rank = hvd.rank()
    res = {}
    _run(hvd.SyncBatchNorm(C), rank, "torch", res)
    _run(hvd.SyncBatchNorm(C, momentum=None), rank, "cumulative", res)
    np.savez(os.path.join(os.environ["OUT_DIR"], f"native{rank}.npz"), **res)
    hvd.shutdown()
""")


def _whole(results, key):
    """A per-image result of both ranks, concatenated in rank order."""
    return np.concatenate([res[key] for res in results])


@pytest.mark.parametrize("prefix", ["torch", "cumulative"])
def test_matches_the_reference_torch_surface(port_results, prefix):
    port, native = port_results
    for r in range(2):
        for key, tol in (("y", TOL), ("dx", TOL), ("eval", TOL),
                         ("dweight", TOL_GRAD), ("dbias", TOL_GRAD),
                         ("mean", TOL_STATS), ("var", TOL_STATS)):
            np.testing.assert_allclose(port[r][f"{prefix}.{key}"],
                                       native[r][f"{prefix}.{key}"], **tol,
                                       err_msg=f"rank {r} {key}")


def _concatenated_reference(momentum, unbiased):
    """One process's BatchNorm in float64 over the whole batch: y, dx,
    dweight, dbias of the first iteration, the running statistics after
    the second (``momentum``: the new batch's weight; None: cumulative)."""
    xs, gs, weight, bias = _data()
    w = torch.tensor(weight, dtype=torch.float64, requires_grad=True)
    b = torch.tensor(bias, dtype=torch.float64, requires_grad=True)
    mean, var = torch.zeros(C, dtype=torch.float64), torch.ones(
        C, dtype=torch.float64)
    out = {}
    for it in range(2):
        x = torch.tensor(xs[it], dtype=torch.float64, requires_grad=True)
        y = torch.nn.functional.batch_norm(x, None, None, w, b, True, 0.0,
                                           EPS)
        y.backward(torch.tensor(gs[it], dtype=torch.float64))
        if it == 0:
            out.update(y=y.detach().numpy(), dx=x.grad.numpy(),
                       dweight=w.grad.numpy().copy(),
                       dbias=b.grad.numpy().copy())
        n = x.numel() // C
        batch_mean = x.detach().mean(dim=(0, 2, 3))
        batch_var = x.detach().var(dim=(0, 2, 3), unbiased=False)
        if unbiased:
            batch_var = batch_var * n / (n - 1)
        m = 1.0 / (it + 1) if momentum is None else momentum
        mean = (1 - m) * mean + m * batch_mean
        var = (1 - m) * var + m * batch_var
    out.update(mean=mean.numpy(), var=var.numpy())
    return out


@pytest.mark.parametrize("prefix,momentum,unbiased", [
    ("torch", 0.1, True), ("cumulative", None, True), ("flax", 0.1, False)])
def test_matches_batch_norm_over_the_concatenated_batch(
        port_results, prefix, momentum, unbiased):
    port, _ = port_results
    want = _concatenated_reference(momentum, unbiased)
    for key in ("y", "dx"):
        np.testing.assert_allclose(_whole(port, f"{prefix}.{key}"),
                                   want[key], **TOL, err_msg=key)
    for key in ("dweight", "dbias"):
        np.testing.assert_allclose(
            port[0][f"{prefix}.{key}"] + port[1][f"{prefix}.{key}"],
            want[key], **TOL_GRAD, err_msg=key)
    for r in range(2):
        for key in ("mean", "var"):
            np.testing.assert_allclose(port[r][f"{prefix}.{key}"], want[key],
                                       **TOL_STATS, err_msg=key)


def _flax_sync_batch_norm():
    """flax's SyncBatchNorm over the global 'hvd' axis, one image per
    device of the 8-device mesh: (y, dx, dscale, dbias, mean, var) after
    the two iterations (y and the gradients of the first), NCHW."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import horovod_tpu as jhvd

    assert jhvd.size() == sum(SIZES)
    xs, gs, weight, bias = _data()
    bn = jhvd.SyncBatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=EPS)
    nhwc = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in xs]
    variables = bn.init(jax.random.PRNGKey(0), nhwc[0][:1])
    params = {"bn": {"scale": jnp.asarray(weight),
                     "bias": jnp.asarray(bias)}}

    def body(params, stats, x, g):
        def fwd(p, x):
            return bn.apply({"params": p, "batch_stats": stats}, x,
                            mutable=["batch_stats"])

        y, pullback, updates = jax.vjp(fwd, params, x, has_aux=True)
        dp, dx = pullback(g)
        dp = jax.lax.psum(dp, "hvd")
        return y, dx, dp, updates["batch_stats"]

    step = jax.jit(jax.shard_map(
        body, mesh=jhvd.global_mesh(), in_specs=(P(), P(), P("hvd"),
                                                 P("hvd")),
        out_specs=(P("hvd"), P("hvd"), P(), P()), check_vma=False))
    stats = variables["batch_stats"]
    for it in range(2):
        y, dx, dp, stats = step(params, stats, nhwc[it],
                                jnp.asarray(gs[it].transpose(0, 2, 3, 1)))
        if it == 0:
            first = (np.asarray(y).transpose(0, 3, 1, 2),
                     np.asarray(dx).transpose(0, 3, 1, 2),
                     np.asarray(dp["bn"]["scale"]),
                     np.asarray(dp["bn"]["bias"]))
    return (*first, np.asarray(stats["bn"]["mean"]),
            np.asarray(stats["bn"]["var"]))


def test_matches_flax_sync_batch_norm_on_the_mesh(port_results):
    port, _ = port_results
    y, dx, dscale, dbias, mean, var = _flax_sync_batch_norm()
    for prefix in ("torch", "flax"):
        np.testing.assert_allclose(_whole(port, f"{prefix}.y"), y, **TOL)
        np.testing.assert_allclose(_whole(port, f"{prefix}.dx"), dx, **TOL)
        np.testing.assert_allclose(
            port[0][f"{prefix}.dweight"] + port[1][f"{prefix}.dweight"],
            dscale, **TOL_GRAD)
        np.testing.assert_allclose(
            port[0][f"{prefix}.dbias"] + port[1][f"{prefix}.dbias"], dbias,
            **TOL_GRAD)
    # flax's conventions: momentum 0.9, the biased variance.
    for r in range(2):
        np.testing.assert_allclose(port[r]["flax.mean"], mean, **TOL_STATS)
        np.testing.assert_allclose(port[r]["flax.var"], var, **TOL_STATS)


@pytest.mark.parametrize("prefix", ["torch", "cumulative", "flax"])
def test_evaluation_sends_nothing(port_results, prefix):
    port, _ = port_results
    for r, res in enumerate(port):
        # (sum, sum of squares, count) forward and (sum_dy, sum_dy_xhat)
        # backward, for each of the two training iterations; nothing for
        # the evaluation.
        assert res[f"{prefix}.allreduces"].tolist() == [2 * C + 1, 2 * C] * 2
        xs, _, weight, bias = _data()
        want = torch.nn.functional.batch_norm(
            torch.from_numpy(xs[1][_rows(r)]),
            torch.from_numpy(res[f"{prefix}.mean"]),
            torch.from_numpy(res[f"{prefix}.var"]), torch.from_numpy(weight),
            torch.from_numpy(bias), False, 0.0, EPS)
        np.testing.assert_allclose(res[f"{prefix}.eval"], want.numpy(),
                                   **TOL)


def test_half_precision_input_normalizes_in_float32(monkeypatch):
    """A bf16 input gives a bf16 output: the float32 result rounded once."""
    import horovod_tpu_torch as hvd

    for key in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    hvd.init(device="cpu")
    try:
        x = torch.from_numpy(_data()[0][0]).bfloat16()
        got = hvd.SyncBatchNorm(C)(x)
        want = hvd.SyncBatchNorm(C)(x.float())
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want.bfloat16())
    finally:
        hvd.shutdown()
