"""The port's BERT (horovod_tpu_torch.models.bert) against the JAX
package's flax BERT, with weights carried across by
``models.convert.bert_params_from_flax``.

A BERT_TINY-width model in float32, dropout 0: logits through the flash
attention path (JAX: the Pallas kernels in interpret mode; the port: the
kernels' plain versions on the CPU), and three data-parallel AdamW steps on
two ranks (gloo, one spawn) against JAX ``make_train_step`` on a 2-device
process set. Tolerances: 1e-5 for the logits (float32, summation order);
1e-4 relative + 1e-5 absolute for the three-step trajectory (Adam divides
by the gradient's running RMS, which magnifies float32 rounding for
gradients near zero; the key projection's bias, whose gradient is zero
in exact arithmetic, is held to Adam's largest possible step instead).
"""

import dataclasses
import functools
import multiprocessing as mp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD = 2
B_PER_RANK, SEQ, PREDS = 2, 32, 5
LR, WEIGHT_DECAY = 1e-3, 1e-2
STEPS = 3


def _flax_bert():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import bert as jbert

    cfg = dataclasses.replace(jbert.BERT_TINY, dropout_rate=0.0,
                              dtype=jnp.float32)
    model = jbert.Bert(cfg, attention_fn=functools.partial(
        jbert.flash_attention_fn, interpret=True))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, SEQ), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _batches(vocab):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        n = WORLD * B_PER_RANK
        ids = rng.randint(0, vocab, size=(n, SEQ)).astype(np.int32)
        pos = np.stack([rng.choice(SEQ, PREDS, replace=False)
                        for _ in range(n)]).astype(np.int32)
        labels = rng.randint(0, vocab, size=(n, PREDS)).astype(np.int32)
        out.append((ids, pos, labels, np.ones((n, PREDS), np.int32)))
    return out


def _port_bert(flax_params):
    from horovod_tpu_torch.models import bert as tbert
    from horovod_tpu_torch.models.convert import bert_params_from_flax

    cfg = dataclasses.replace(tbert.BERT_TINY, dropout_rate=0.0,
                              dtype=torch.float32)
    model = tbert.Bert(cfg, attention_fn=tbert.flash_attention_fn)
    model.load_state_dict(bert_params_from_flax(flax_params), strict=True)
    return model


def _port_loss(model, batch):
    from horovod_tpu_torch.models.bert import mlm_loss

    ids, pos, labels, lmask = batch
    _, logits = model(ids, masked_positions=pos)
    return mlm_loss(logits, labels, lmask)


@pytest.fixture(scope="module")
def flax_bert():
    return _flax_bert()


def test_logits_match_flax_with_flash_attention(flax_bert):
    model, params = flax_bert
    ids, pos, _, _ = _batches(model.config.vocab_size)[0]
    seq_out, logits = model.apply({"params": params}, ids,
                                  masked_positions=pos)
    port = _port_bert(params)
    t_seq, t_logits = port(torch.from_numpy(ids).long(),
                           masked_positions=torch.from_numpy(pos).long())
    assert t_logits.shape == (WORLD * B_PER_RANK, PREDS,
                              model.config.vocab_size)
    np.testing.assert_allclose(t_seq.detach().numpy(), np.asarray(seq_out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(logits),
                               rtol=1e-5, atol=1e-5)


def test_dense_and_flash_attention_agree():
    from horovod_tpu_torch.models import bert as tbert

    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(2, 24, 4, 16).astype(np.float32))
               for _ in range(3))
    bias = torch.zeros(2, 1, 1, 24)
    np.testing.assert_allclose(
        tbert.flash_attention_fn(q, k, v, bias, torch.float32).numpy(),
        tbert.default_attention(q, k, v, bias, torch.float32).numpy(),
        rtol=1e-5, atol=1e-6)


def test_every_flax_leaf_is_consumed_once(flax_bert):
    import jax

    from horovod_tpu_torch.models.convert import bert_params_from_flax

    _, params = flax_bert
    n_leaves = len(jax.tree.leaves(params))
    sd = bert_params_from_flax(params)
    # One state_dict entry per flax leaf, and the port's module has exactly
    # these entries (load_state_dict(strict=True) in _port_bert).
    assert len(sd) == n_leaves
    assert set(sd) == set(_port_bert(params).state_dict())
    # The logits stay tied to the token embeddings.
    port = _port_bert(params)
    assert "token_embeddings.weight" in sd and not any(
        "decoder" in k or "lm_head" in k for k in sd)
    np.testing.assert_array_equal(
        port.token_embeddings.weight.detach().numpy(),
        params["token_embeddings"]["embedding"])
    extra = dict(params, stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="stray/kernel"):
        bert_params_from_flax(extra)
    missing = dict(params)
    del missing["mlm_bias"]
    with pytest.raises(KeyError, match="mlm_bias"):
        bert_params_from_flax(missing)


def _dp_worker(rank, init_file, out_dir, flax_params, batches):
    os.environ["HOROVOD_NUM_PROCESSES"] = str(WORLD)
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    model = _port_bert(flax_params)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR,
                          weight_decay=WEIGHT_DECAY),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = hvd.make_train_step(model, _port_loss, opt)
    rows = slice(rank * B_PER_RANK, (rank + 1) * B_PER_RANK)
    losses = [float(step(tuple(torch.from_numpy(a[rows]).long()
                               for a in batch))) for batch in batches]
    res = {f"param.{k}": v.numpy() for k, v in model.state_dict().items()}
    res["losses"] = np.array(losses)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


def _jax_dp_trajectory(model, params, batches):
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as jhvd
    from horovod_tpu.models.bert import mlm_loss
    from horovod_tpu.parallel import data_parallel as dp

    def loss_fn(p, batch):
        ids, pos, labels, lmask = batch
        _, logits = model.apply({"params": p}, ids, masked_positions=pos)
        return mlm_loss(logits, labels, lmask)

    ps = jhvd.add_process_set([0, 1])
    try:
        opt = jhvd.DistributedOptimizer(
            optax.adamw(LR, weight_decay=WEIGHT_DECAY), process_set=ps)
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
        jhvd.remove_process_set(ps)


def test_data_parallel_adamw_steps_match_jax(flax_bert, tmp_path):
    from horovod_tpu_torch.models.convert import bert_params_from_flax

    model, params = flax_bert
    batches = _batches(model.config.vocab_size)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dp_worker, args=(
        r, str(tmp_path / "rendezvous"), str(tmp_path), params, batches))
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
    losses, final = _jax_dp_trajectory(model, params, batches)
    want = bert_params_from_flax(final)
    for r in range(WORLD):
        res = dict(np.load(tmp_path / f"rank{r}.npz"))
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-4)
        for key, w in want.items():
            if key.endswith("attention.key.bias"):
                # Softmax is invariant to a per-row shift of the scores, so
                # this gradient is zero in exact arithmetic and Adam's step
                # is the ratio of two rounding noises: hold both sides to
                # the most Adam can move it (lr per step), not to each other.
                start = bert_params_from_flax(params)[key].numpy()
                for got in (res[f"param.{key}"], w.numpy()):
                    assert np.abs(got - start).max() <= STEPS * LR * 1.01
                continue
            np.testing.assert_allclose(res[f"param.{key}"], w.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=key)
    assert losses[-1] < losses[0]


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys\n"
        "import horovod_tpu_torch\n"
        "import horovod_tpu_torch.models.bert, horovod_tpu_torch.models.convert\n"
        "import horovod_tpu_torch.models.resnet, horovod_tpu_torch.models.lenet\n"
        "import horovod_tpu_torch.ops._kernels, horovod_tpu_torch.optimizer\n"
        "import horovod_tpu_torch.ops.quantization, horovod_tpu_torch.checkpoint\n"
        "import horovod_tpu_torch.parallel.param_sharding\n"
        "import horovod_tpu_torch.ops.adasum, horovod_tpu_torch.sync_batch_norm\n"
        "import horovod_tpu_torch.runner.launch, horovod_tpu_torch.runner.task_fn\n"
        "import horovod_tpu_torch.runner.driver_service\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'horovod_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
