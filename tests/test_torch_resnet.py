"""The port's ResNet and LeNet (horovod_tpu_torch.models) against the JAX
package's flax models, with weights carried across by
``models.convert.resnet_variables_from_flax`` / ``lenet_params_from_flax``.

Inputs are made by numpy from a seed; everything runs in float32.

- ResNet-50 logits in evaluation mode at 32x32, batch 2 (bench.py's
  off-TPU size): rtol and atol 1e-4 (summation order of the convolutions).
- ResNet-50 in training mode, one apply: logits within 1e-4, and the
  updated running statistics within rtol 1e-5 and atol 1e-6, at 64x64,
  batch 2. Not at 32x32: there the last stage is 1x1 pixels, so each of
  its BatchNorms sees two values per channel, and normalizing two values
  divides their half-difference by sqrt(d^2 + 1e-5), which magnifies the
  convolutions' rounding differences (3e-5) about 150-fold in channels
  whose two values nearly agree; at 64x64 it sees eight. An unbiased
  variance is off by 8/7 or more in every layer, far outside the bound.
- LeNet logits: 1e-5.
- Two gloo ranks run three data-parallel SGD-momentum steps (lr 0.1,
  momentum 0.9) of a narrow ResNet (stages [1, 1, 1, 1], 8 filters, 64x64)
  against a JAX step built as bench.py's ``_build_step`` builds it
  (``DistributedOptimizer``, ``mutable=["batch_stats"]``) on a 2-device
  process set, with each shard's running statistics kept (``P(axis)`` in
  and out): losses within rtol 1e-4, parameters within rtol 1e-4 and atol
  1e-5, and rank r's running statistics within 1e-5 of shard r's.
"""

import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

WORLD = 2
B_PER_RANK = 2
STEPS = 3
LR, MOMENTUM = 0.1, 0.9
NARROW = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=10)


def _flax_variables(model, image):
    import jax
    import jax.numpy as jnp

    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, image, image, 3)),
        train=True))()
    return (jax.tree.map(np.asarray, variables["params"]),
            jax.tree.map(np.asarray, variables["batch_stats"]))


@pytest.fixture(scope="module")
def resnet50():
    import jax.numpy as jnp

    from horovod_tpu.models.resnet import ResNet50

    model = ResNet50(num_classes=1000, dtype=jnp.float32)
    return (model, *_flax_variables(model, 32))


def _port_resnet(params, batch_stats, **kwargs):
    from horovod_tpu_torch.models import resnet as tresnet
    from horovod_tpu_torch.models.convert import resnet_variables_from_flax

    model = tresnet.ResNet(**kwargs)
    model.load_state_dict(resnet_variables_from_flax(params, batch_stats),
                          strict=True)
    return model


def _images(n, size, seed):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(
        np.float32)


def test_resnet50_eval_logits_match_flax(resnet50):
    model, params, stats = resnet50
    x = _images(2, 32, 0)
    want = model.apply({"params": params, "batch_stats": stats}, x,
                       train=False)
    port = _port_resnet(params, stats, stage_sizes=[3, 4, 6, 3])
    port.eval()
    got = port(torch.from_numpy(x))
    assert got.shape == (2, 1000) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_resnet50_train_logits_and_batch_stats_match_flax(resnet50):
    import jax

    from horovod_tpu_torch.models.convert import resnet_variables_from_flax

    model, params, stats = resnet50
    x = _images(2, 64, 1)
    logits, updated = jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"]))(params, stats, x)
    port = _port_resnet(params, stats, stage_sizes=[3, 4, 6, 3])
    port.train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)
    want = resnet_variables_from_flax(
        params, jax.tree.map(np.asarray, updated["batch_stats"]))
    running = {k: v for k, v in port.state_dict().items() if "running" in k}
    assert len(running) == 2 * 53  # mean and var of every BatchNorm
    for key, value in running.items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_every_flax_leaf_is_consumed_once(resnet50):
    import jax

    from horovod_tpu_torch.models.convert import resnet_variables_from_flax

    _, params, stats = resnet50
    sd = resnet_variables_from_flax(params, stats)
    assert len(sd) == len(jax.tree.leaves(params)) + len(
        jax.tree.leaves(stats))
    port = _port_resnet(params, stats, stage_sizes=[3, 4, 6, 3])
    assert set(sd) == set(port.state_dict())
    np.testing.assert_array_equal(
        port.conv_init.weight.detach().numpy(),
        params["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    stray = dict(params, stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="stray/kernel"):
        resnet_variables_from_flax(stray, stats)
    missing = {k: dict(v) for k, v in stats.items()}
    del missing["Bottleneck_3"]["BatchNorm_1"]
    with pytest.raises(KeyError, match="Bottleneck_3/BatchNorm_1/mean"):
        resnet_variables_from_flax(params, missing)


@pytest.mark.parametrize("size", [8, 7, 112])
def test_stride2_same_padding_matches_xla(size):
    """A stride-2 3x3 convolution and max-pool with SAME padding: on an
    even input XLA pads 0 before and 1 after, on an odd one 1 and 1."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from horovod_tpu_torch.models import resnet as tresnet

    assert tresnet.same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0
                                             else (1, 1))
    rng = np.random.RandomState(size)
    x = rng.randn(2, size, size, 4).astype(np.float32)
    w = rng.randn(3, 3, 4, 5).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = tresnet.Conv(4, 5, 3, 2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = conv(xt).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    pooled = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                          padding="SAME")
    xp, pad = tresnet._same(xt, 3, 2, value=-float("inf"))
    got = torch.nn.functional.max_pool2d(xp, 3, 2, pad).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pooled))


def test_lenet_logits_match_flax():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models.lenet import LeNet, cross_entropy_loss
    from horovod_tpu_torch.models import lenet as tlenet
    from horovod_tpu_torch.models.convert import lenet_params_from_flax

    rng = np.random.RandomState(3)
    x = rng.rand(4, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, size=4)
    model = LeNet()
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 28, 28, 1)))["params"])
    want = model.apply({"params": params}, x)
    port = tlenet.LeNet()
    port.load_state_dict(lenet_params_from_flax(params), strict=True)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(tlenet.cross_entropy_loss(got.detach(), torch.from_numpy(y))),
        float(cross_entropy_loss(want, jnp.asarray(y))), rtol=1e-5)
    # Dense_0's rows are flax's (h, w, c) order, taken as they are.
    np.testing.assert_array_equal(port.fc1.weight.detach().numpy(),
                                  params["Dense_0"]["kernel"].T)


def _batches():
    """One batch, repeated every step (the loss must fall on it)."""
    rng = np.random.RandomState(4)
    n = WORLD * B_PER_RANK
    batch = (rng.rand(n, 64, 64, 3).astype(np.float32),
             rng.randint(0, NARROW["num_classes"], size=n).astype(np.int32))
    return [batch] * STEPS


def _port_loss(model, batch):
    from horovod_tpu_torch.models.lenet import cross_entropy_loss

    x, y = batch
    return cross_entropy_loss(model(x), y, NARROW["num_classes"])


def _dp_worker(rank, init_file, out_dir, params, stats, batches):
    os.environ["HOROVOD_NUM_PROCESSES"] = str(WORLD)
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    model = _port_resnet(params, stats, **NARROW)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = hvd.make_train_step(model, _port_loss, opt)
    rows = slice(rank * B_PER_RANK, (rank + 1) * B_PER_RANK)
    losses = [float(step((torch.from_numpy(x[rows]),
                          torch.from_numpy(y[rows]))))
              for x, y in batches]
    res = {f"param.{k}": v.numpy() for k, v in model.state_dict().items()}
    res["losses"] = np.array(losses)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


def _jax_dp_trajectory(model, params, stats, batches):
    """bench.py's ``_build_step`` on a 2-device process set, with the
    running statistics kept per shard: ``(mean loss per step, final params,
    each shard's final batch_stats)``."""
    import jax
    import optax
    from jax.sharding import PartitionSpec as P

    import horovod_tpu as jhvd
    from horovod_tpu.models.lenet import cross_entropy_loss
    from horovod_tpu.parallel import data_parallel as dp

    ps = jhvd.add_process_set([0, 1])
    try:
        opt = jhvd.DistributedOptimizer(optax.sgd(LR, momentum=MOMENTUM),
                                        process_set=ps)
        axis = ps.axis_name

        def spmd_step(params, batch_stats, opt_state, batch):
            x, y = batch
            local = jax.tree.map(lambda a: a[0], batch_stats)

            def loss_of(p):
                logits, updated = model.apply(
                    {"params": p, "batch_stats": local}, x, train=True,
                    mutable=["batch_stats"])
                return (cross_entropy_loss(logits, y, NARROW["num_classes"]),
                        updated["batch_stats"])

            (loss, new_stats), grads = jax.value_and_grad(
                loss_of, has_aux=True)(params)
            updates, new_opt = opt.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates),
                    jax.tree.map(lambda a: a[None], new_stats), new_opt,
                    loss[None])

        step = jax.jit(jax.shard_map(
            spmd_step, mesh=ps.mesh, in_specs=(P(), P(axis), P(), P(axis)),
            out_specs=(P(), P(axis), P(), P(axis)), check_vma=False))
        p = dp.replicate(params, mesh=ps.mesh)
        s = dp.shard_batch(jax.tree.map(lambda a: np.stack([a] * WORLD),
                                        stats), mesh=ps.mesh, axis_name=axis)
        o = dp.replicate(opt.init(params), mesh=ps.mesh)
        losses = []
        for batch in batches:
            p, s, o, loss = step(p, s, o, dp.shard_batch(
                batch, mesh=ps.mesh, axis_name=axis))
            losses.append(float(np.mean(np.asarray(loss))))
        return (np.array(losses), jax.tree.map(np.asarray, p),
                jax.tree.map(np.asarray, s))
    finally:
        jhvd.remove_process_set(ps)


def test_data_parallel_sgd_momentum_steps_match_jax(tmp_path):
    import jax

    from horovod_tpu.models.resnet import ResNet
    from horovod_tpu_torch.models.convert import resnet_variables_from_flax

    model = ResNet(**NARROW)
    params, stats = _flax_variables(model, 64)
    batches = _batches()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dp_worker, args=(
        r, str(tmp_path / "rendezvous"), str(tmp_path), params, stats,
        batches)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs])
    losses, final, shard_stats = _jax_dp_trajectory(model, params, stats,
                                                    batches)
    assert losses[-1] < losses[0]
    for r in range(WORLD):
        res = dict(np.load(tmp_path / f"rank{r}.npz"))
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-4)
        want = resnet_variables_from_flax(
            final, jax.tree.map(lambda a, r=r: a[r], shard_stats))
        for key, w in want.items():
            tol = (dict(rtol=0, atol=1e-5) if "running" in key
                   else dict(rtol=1e-4, atol=1e-5))
            np.testing.assert_allclose(res[f"param.{key}"], w.numpy(),
                                       err_msg=f"rank {r}: {key}", **tol)
