"""The port's sharded (ZeRO-1) and fsdp (ZeRO-3) sync modes against the JAX
package's, and against the port's own allreduce mode.

The problem is ``_mlp_problem`` of tests/test_overlap.py (a 4-layer tanh
MLP, 8 leaves). Four gloo ranks train it with horovod_tpu_torch (one spawn
for the module, every configuration in turn); the JAX package trains it
with ``make_train_step`` on a 4-device process set; both take the same
per-step batches, split by rank, and the same bucket cap (600 bytes: 6
buckets of the float32 wire). Compared:

- SGD with momentum and AdamW in both modes: the averaged loss of every
  step and the final full parameters, to JAX's trajectory and to the
  port's allreduce trajectory, at 1e-4 relative and 1e-5 absolute (float32
  over three updates; the frameworks and the modes sum in other orders);
- rank r's parameter shards (fsdp) and momentum shards (both modes) to row
  r of the JAX package's stacked layout (``init_sharded_state``'s, after
  the updates), and to row r of the port's ``init_sharded_state``;
- the int8 wire in both modes: no noisier than the JAX package's. Its
  stochastic rounding hashes each value's bits, so a value one ulp apart
  rounds independently and the two packages' int8 trajectories cannot be
  held to each other ulp for ulp; on this problem a quantization block
  spans several small leaves, and either package's int8 parameters stray
  about 0.1 from its float32 ones within three steps. So the port's largest
  distance from its own float32 trajectory must stay within 1.5x the JAX
  package's, its losses fall, and every rank holds the same parameters;
- the tripwire's skip in both modes (a NaN in rank 1's rows on step 2):
  every rank skips, parameters and optimizer shards hold bit for bit;
- fsdp's resident parameter bytes and both modes' optimizer-state bytes
  per rank: a quarter of the whole, plus at most one padding element per
  leaf;
- the plans: ``shard_ownership``, the bucket and segment plans and the
  packed shard rows equal the JAX package's; the guard table's rejections.
"""

import json
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

N = 4
LR, MOMENTUM = 0.1, 0.9
ADAM_LR, WD = 0.05, 1e-2
THRESHOLD = 600
TOL = dict(rtol=1e-4, atol=1e-5)
# name, mode, optimizer, compression
CONFIGS = [
    ("allreduce_sgd", "allreduce", "sgd", "none"),
    ("sharded_sgd", "sharded", "sgd", "none"),
    ("fsdp_sgd", "fsdp", "sgd", "none"),
    ("allreduce_adamw", "allreduce", "adamw", "none"),
    ("sharded_adamw", "sharded", "adamw", "none"),
    ("fsdp_adamw", "fsdp", "adamw", "none"),
    ("sharded_int8", "sharded", "sgd", "int8"),
    ("fsdp_int8", "fsdp", "sgd", "int8"),
]

# The fsdp just-in-time gathers on a tied-embedding BERT: tag, mode,
# HOROVOD_FSDP_SEGMENTS, HOROVOD_FSDP_RESHARD_AFTER_FORWARD, and whether
# every saved leaf is freed (param_sharding.KEEP_SAVED_BELOW = 1; "kept"
# runs with the default, which keeps all of this model's but the
# embedding).
JIT_RUNS = [("allreduce", "allreduce", 4, "1", False),
            ("fsdp4", "fsdp", 4, "1", True), ("fsdp1", "fsdp", 1, "1", True),
            ("upfront", "fsdp", 4, "0", True), ("kept", "fsdp", 4, "1", False)]


def _problem():
    from test_torch_optimizer import _problem as two_rank_problem

    return two_rank_problem()


def _inner(hvd_params, kind):
    if kind == "sgd":
        return torch.optim.SGD(hvd_params, lr=LR, momentum=MOMENTUM)
    return torch.optim.AdamW(hvd_params, lr=ADAM_LR, weight_decay=WD)


def _run(hvd, rank, leaves, batches, mode, kind, comp, res, name):
    from test_torch_optimizer import _Params, _torch_loss

    model = _Params(leaves)
    total_bytes = sum(p.numel() * 4 for p in model.parameters())
    opt = hvd.DistributedOptimizer(
        _inner(model.parameters(), kind), sync_mode=mode,
        compression=getattr(hvd.Compression, comp),
        fusion_threshold_bytes=THRESHOLD)
    step = hvd.make_train_step(model, _torch_loss, opt)
    rows = slice(rank * 4, rank * 4 + 4)
    res[f"{name}.loss"] = np.array([
        float(step((torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))))
        for x, y in batches[:3]])
    full = (opt.full_parameters() if mode == "fsdp"
            else [p.detach() for p in model.parameters()])
    for key, t in zip(leaves, full):
        res[f"{name}.{key}"] = t.numpy().copy()
    if mode == "allreduce":
        return
    shards = opt.shards if mode == "fsdp" else opt._shards
    for i, (key, s) in enumerate(zip(leaves, shards)):
        if kind == "sgd":
            res[f"{name}.mom.{key}"] = (
                opt._opt.state[s]["momentum_buffer"].numpy().copy())
        if mode == "fsdp":
            res[f"{name}.shard.{key}"] = s.detach().numpy().copy()
    stacked = hvd.init_sharded_state(opt)
    local = opt._opt.state_dict()["state"]
    res[f"{name}.stacked_row_is_local"] = np.array(all(
        torch.equal(stacked["state"][i][k][rank], v)
        for i, st in local.items() for k, v in st.items()))
    state_bytes = sum(v.numel() * v.element_size() for st in local.values()
                      for v in st.values() if v.dim() > 0)
    res[f"{name}.state_bytes"] = np.array(state_bytes)
    res[f"{name}.total_bytes"] = np.array(total_bytes)
    if mode == "fsdp":
        res[f"{name}.resident"] = np.array(hvd.resident_param_bytes(opt))


def _skip_run(hvd, rank, leaves, batches, mode, res):
    from test_torch_optimizer import _Params, _torch_loss

    os.environ["HOROVOD_NONFINITE_ACTION"] = "skip"
    model = _Params(leaves)
    opt = hvd.DistributedOptimizer(_inner(model.parameters(), "sgd"),
                                   sync_mode=mode)
    del os.environ["HOROVOD_NONFINITE_ACTION"]
    step = hvd.make_train_step(model, _torch_loss, opt)
    rows = slice(rank * 4, rank * 4 + 4)
    shards = opt.shards if mode == "fsdp" else opt._shards

    def snapshot():
        params = (opt.shards if mode == "fsdp"
                  else list(model.parameters()))
        return [t.detach().clone() for t in params] + [
            opt._opt.state[s]["momentum_buffer"].clone() for s in shards]

    states = []
    for x, y in batches[:3]:
        step((torch.from_numpy(x[rows]), torch.from_numpy(y[rows])))
        states.append(snapshot())
    res[f"skip_{mode}.held"] = np.array(all(
        torch.equal(a, b) for a, b in zip(states[0], states[1])))
    res[f"skip_{mode}.moved"] = np.array(not all(
        torch.equal(a, b) for a, b in zip(states[1], states[2])))
    res[f"skip_{mode}.detections"] = np.array(opt.nonfinite_steps)


def _bert_loss(log):
    def loss_fn(model, batch):
        ids, labels = batch
        _, logits = model(ids)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
        log.append(("end",))
        return loss
    return loss_fn


def _jit_run(hvd, rank, res, tag, mode, segments, reshard, free_all):
    """A 2-layer float32 BERT (tied input and output embeddings, dense
    weights read by the parent's forward) for 3 steps, each rank on
    its own rows, SGD with momentum (AdamW would blow the summation order's
    rounding in the key bias, whose gradient is zero but for it, up to
    lr); the fsdp runs log every gather and reduce-scatter, and an ``end``
    mark where each forward returns."""
    import dataclasses
    import json

    from horovod_tpu_torch.models import bert
    from horovod_tpu_torch.ops.fusion import segment_leaves

    cfg = dataclasses.replace(bert.BERT_TINY, num_layers=2, dropout_rate=0.0,
                              dtype=torch.float32)
    from horovod_tpu_torch.parallel import param_sharding

    os.environ["HOROVOD_FSDP_SEGMENTS"] = str(segments)
    os.environ["HOROVOD_FSDP_RESHARD_AFTER_FORWARD"] = reshard
    keep = param_sharding.KEEP_SAVED_BELOW
    param_sharding.KEEP_SAVED_BELOW = 1 if free_all else keep
    torch.manual_seed(0)
    model = bert.Bert(cfg)
    names = [n for n, _ in model.named_parameters()]
    opt = hvd.DistributedOptimizer(_inner(model.parameters(), "sgd"),
                                   sync_mode=mode)
    log = []
    if mode == "fsdp":
        gather, scatter = opt.gather_shards, opt.reduce_scatter

        def logged_gather(idx, shards, salt, wire=True):
            if wire:  # not full_parameters()' exact gather
                log.append(("g", [int(i) for i in idx]))
            return gather(idx, shards, salt, wire)

        def logged_scatter(idx, grads, salt):
            log.append(("rs", [int(i) for i in idx]))
            return scatter(idx, grads, salt)

        opt.gather_shards, opt.reduce_scatter = logged_gather, logged_scatter
    step = hvd.make_train_step(model, _bert_loss(log), opt)
    del os.environ["HOROVOD_FSDP_SEGMENTS"]
    del os.environ["HOROVOD_FSDP_RESHARD_AFTER_FORWARD"]
    g = torch.Generator().manual_seed(7)
    ids = torch.randint(0, cfg.vocab_size, (4 * N, 16), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (4 * N, 16), generator=g)
    rows = slice(rank * 4, rank * 4 + 4)
    res[f"jit_{tag}.loss"] = np.array(
        [float(step((ids[rows], labels[rows]))) for _ in range(3)])
    full = (opt.full_parameters() if mode == "fsdp"
            else [p.detach() for p in model.parameters()])
    for i, t in enumerate(full):
        res[f"jit_{tag}.{i}"] = t.numpy().copy()
    param_sharding.KEEP_SAVED_BELOW = keep
    res[f"jit_{tag}.log"] = np.array(json.dumps(log))
    res["jit.names"] = np.array(json.dumps(names))
    if mode == "fsdp":
        res["jit.segments"] = np.array(json.dumps(
            segment_leaves([(p.numel(), p.dtype) for p in full],
                           segments)))


def _worker(rank, init_file, out_dir, leaves, batches, poisoned):
    os.environ["HOROVOD_NUM_PROCESSES"] = str(N)
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    res = {}
    for name, mode, kind, comp in CONFIGS:
        _run(hvd, rank, leaves, batches, mode, kind, comp, res, name)
    for mode in ("sharded", "fsdp"):
        _skip_run(hvd, rank, leaves, poisoned, mode, res)
    for run in JIT_RUNS:
        _jit_run(hvd, rank, res, *run)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


def _poisoned(batches):
    """The batches with rank 1's rows of the second one made NaN."""
    out = [(x.copy(), y.copy()) for x, y in batches]
    out[1][0][4:8] = np.nan
    return out


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture(scope="module")
def port_results(problem, tmp_path_factory):
    leaves, batches = problem
    tmp = tmp_path_factory.mktemp("torch_sharded")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(
        r, str(tmp / "rendezvous"), str(tmp), leaves, batches,
        _poisoned(batches))) for r in range(N)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs])
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]


_JAX_CACHE: dict = {}


def _jax_trajectory(mode, kind, comp):
    """The JAX package's trajectory on a 4-device process set: losses,
    final full parameters by key, and the stacked parameter rows (fsdp)
    and optimizer state leaves."""
    key = (mode, kind, comp)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as jhvd
    from horovod_tpu.parallel import data_parallel as dp
    from test_overlap import _mlp_problem
    from test_torch_optimizer import _jax_set

    params, _, loss_fn = _mlp_problem()
    _, batches = _problem()
    ps, own = _jax_set(list(range(N)))
    inner = (optax.sgd(LR, momentum=MOMENTUM) if kind == "sgd"
             else optax.adamw(ADAM_LR, weight_decay=WD))
    try:
        opt = jhvd.DistributedOptimizer(
            inner, compression=getattr(jhvd.Compression, comp),
            process_set=ps, sync_mode=mode, fusion_threshold_bytes=THRESHOLD)
        step = dp.make_train_step(loss_fn, opt, mesh=ps.mesh,
                                  axis_name=ps.axis_name, donate=False)
        place = dict(mesh=ps.mesh, axis_name=ps.axis_name)
        p = (dp.shard_state(jhvd.shard_params(params, N), **place)
             if mode == "fsdp" else dp.replicate(params, mesh=ps.mesh))
        s = (dp.replicate(opt.init(params), mesh=ps.mesh)
             if mode == "allreduce" else dp.shard_state(opt.init(params),
                                                        **place))
        losses = []
        for x, y in batches[:3]:
            batch = dp.shard_batch((jnp.asarray(x), jnp.asarray(y)),
                                   mesh=ps.mesh, axis_name=ps.axis_name)
            p, s, loss = step(p, s, batch)
            losses.append(float(loss))
        p = jax.device_get(p)
        rows = None
        if mode == "fsdp":
            rows = [np.asarray(r) for r in p.rows]
            p = jhvd.unshard_params(p)
        final = {f"{layer}/{name}": np.asarray(arr)
                 for layer, sub in p.items() for name, arr in sub.items()}
        state = [np.asarray(a) for a in jax.tree.leaves(jax.device_get(s))]
        out = (np.array(losses), final, rows, state)
    finally:
        if own:
            jhvd.remove_process_set(ps)
    _JAX_CACHE[key] = out
    return out


@pytest.mark.parametrize("name,mode,kind", [
    (c[0], c[1], c[2]) for c in CONFIGS if c[3] == "none"],
    ids=[c[0] for c in CONFIGS if c[3] == "none"])
def test_trajectory_matches_jax_and_allreduce(problem, port_results, name,
                                              mode, kind):
    leaves, _ = problem
    jmode = "allreduce" if mode == "allreduce" else mode
    losses, final, _, _ = _jax_trajectory(jmode, kind, "none")
    ref = f"allreduce_{kind}"
    for res in port_results:
        np.testing.assert_allclose(res[f"{name}.loss"], losses, **TOL)
        np.testing.assert_allclose(res[f"{name}.loss"], res[f"{ref}.loss"],
                                   **TOL)
        for key, want in final.items():
            np.testing.assert_allclose(res[f"{name}.{key}"], want,
                                       err_msg=f"{name}: {key}", **TOL)
            np.testing.assert_allclose(res[f"{name}.{key}"],
                                       res[f"{ref}.{key}"],
                                       err_msg=f"{name}: {key}", **TOL)
    assert not np.allclose(final["layer0/w"], leaves["layer0/w"])


@pytest.mark.parametrize("mode", ["sharded", "fsdp"])
def test_rank_shards_equal_jax_rows(problem, port_results, mode):
    """Rank r's momentum shards (and fsdp parameter shards) are row r of
    the JAX package's stacked layout, and of the port's
    ``init_sharded_state``."""
    leaves, _ = problem
    _, _, rows, state = _jax_trajectory(mode, "sgd", "none")
    name = f"{mode}_sgd"
    for r, res in enumerate(port_results):
        assert bool(res[f"{name}.stacked_row_is_local"])
        for i, key in enumerate(leaves):
            np.testing.assert_allclose(res[f"{name}.mom.{key}"],
                                       state[i][r], err_msg=key, **TOL)
            if mode == "fsdp":
                np.testing.assert_allclose(res[f"{name}.shard.{key}"],
                                           rows[i][r], err_msg=key, **TOL)


@pytest.mark.parametrize("mode", ["sharded", "fsdp"])
def test_int8_wire_in_both_modes(problem, port_results, mode):
    leaves, _ = problem
    losses, final, _, _ = _jax_trajectory(mode, "sgd", "int8")
    _, final_f32, _, _ = _jax_trajectory(mode, "sgd", "none")
    jax_stray = max(np.abs(final[k] - final_f32[k]).max() for k in final)
    name = f"{mode}_int8"
    for res in port_results:
        stray = max(np.abs(res[f"{name}.{k}"] - res[f"allreduce_sgd.{k}"])
                    .max() for k in final)
        assert 0 < stray <= 1.5 * jax_stray, (stray, jax_stray)
        assert np.isfinite(res[f"{name}.loss"]).all()
        assert res[f"{name}.loss"][-1] < res[f"{name}.loss"][0]
    assert losses[-1] < losses[0]
    # Every rank holds the same parameters after the quantized gathers.
    for key in leaves:
        assert all(np.array_equal(res[f"{name}.{key}"],
                                  port_results[0][f"{name}.{key}"])
                   for res in port_results)


@pytest.mark.parametrize("mode", ["sharded", "fsdp"])
def test_tripwire_skip_holds_every_rank(port_results, mode):
    for res in port_results:
        assert bool(res[f"skip_{mode}.held"])
        assert bool(res[f"skip_{mode}.moved"])
        assert int(res[f"skip_{mode}.detections"]) == 1


@pytest.mark.parametrize("name", ["sharded_sgd", "fsdp_sgd", "fsdp_adamw"])
def test_resident_bytes_are_a_quarter(problem, port_results, name):
    leaves, _ = problem
    slack = len(leaves) * 4  # one float32 of padding per leaf
    for res in port_results:
        total = int(res[f"{name}.total_bytes"])
        per_state = 2 if "adamw" in name else 1
        assert (total * per_state // N <= int(res[f"{name}.state_bytes"])
                <= total * per_state // N + per_state * slack)
        if name.startswith("fsdp"):
            assert total // N <= int(res[f"{name}.resident"]) <= (
                total // N + slack)


def test_plans_equal_jax():
    import jax.numpy as jnp

    from horovod_tpu.ops import fusion as jf
    from horovod_tpu_torch.ops import fusion as tf

    rng = np.random.RandomState(3)
    shapes = [(37,), (64, 33), (5, 7, 11), (2000,), (3,), (8, 8)]
    arrays = [rng.randn(*s).astype(np.float32) for s in shapes]
    jleaves = [jnp.asarray(a) for a in arrays]
    tleaves = [torch.from_numpy(a) for a in arrays]
    pairs = [(t.numel(), t.dtype) for t in tleaves]
    for n in (1, 2, 3, 4, 8):
        sizes = jf.shard_ownership(jleaves, n)
        assert tf.shard_ownership([t.numel() for t in tleaves], n) == sizes
        np.testing.assert_array_equal(
            tf._pack_shard_rows(tleaves, sizes, n).numpy(),
            np.asarray(jf._pack_shard_rows(jleaves, sizes, n)))
    for threshold in (0, 100, 600, 10_000, 1 << 26):
        assert tf.bucket_leaves(pairs, threshold) == jf.bucket_leaves(
            jleaves, threshold)
    for k in (1, 2, 3, 4, 9):
        assert tf.segment_leaves(pairs, k) == jf.segment_leaves(jleaves, k)


@pytest.mark.parametrize("mode,kwargs,match", [
    ("sharded", dict(op="max"), "Average/Sum"),
    ("fsdp", dict(op="min"), "Average/Sum"),
    ("sharded", dict(backward_passes_per_step=2), "backward_passes_per_step"),
    ("fsdp", dict(backward_passes_per_step=3), "backward_passes_per_step"),
    ("fsdp", dict(num_groups=2), "fusion_threshold_bytes"),
])
def test_guard_table_rejects_and_names_the_fix(mode, kwargs, match):
    import horovod_tpu_torch as hvd

    w = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(hvd.SyncModeIneligibleError, match=match):
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                 sync_mode=mode, **kwargs)


@pytest.mark.parametrize("tag", ["fsdp4", "fsdp1", "upfront", "kept"])
def test_fsdp_gathers_just_in_time_match_allreduce(port_results, tag):
    """fsdp on a tied-embedding BERT (parameters read by a parent's
    forward, the embedding read again by the output layer) follows the
    allreduce run, just-in-time (4 or 1 segments) or gathered up front."""
    for res in port_results:
        np.testing.assert_allclose(res[f"jit_{tag}.loss"],
                                   res["jit_allreduce.loss"], **TOL)
        for i in range(len(json.loads(str(res["jit.names"])))):
            np.testing.assert_allclose(res[f"jit_{tag}.{i}"],
                                       res[f"jit_allreduce.{i}"],
                                       err_msg=f"{tag}: leaf {i}", **TOL)
        assert res["jit_allreduce.loss"][-1] < res["jit_allreduce.loss"][0]


@pytest.mark.parametrize("tag", ["fsdp4", "fsdp1", "upfront", "kept"])
def test_fsdp_gather_schedule(port_results, tag):
    """Each forward gathers every segment once, in order, when it first
    reads it. In the first step a leaf read again after its segment was
    released (the tied embedding, the output bias) is gathered alone; from
    the second step on such leaves leave their segments and are gathered
    alone once, at their first read. Each backward gathers again only what
    autograd saved of the released segments, and reduce-scatters each
    gather once. Up front: one gather of everything, no second gather.
    With the default ``KEEP_SAVED_BELOW`` only the embedding (the one leaf
    of this model that large) is freed and gathered again."""
    res = port_results[0]
    names = json.loads(str(res["jit.names"]))
    log = [tuple(e) if e[0] == "end" else (e[0], tuple(e[1]))
           for e in json.loads(str(res[f"jit_{tag}.log"]))]
    assert all(json.loads(str(r[f"jit_{tag}.log"])) == json.loads(
        str(res[f"jit_{tag}.log"])) for r in port_results)
    segments = [tuple(s) for s in json.loads(str(res["jit.segments"]))]
    if tag in ("fsdp1", "upfront"):
        segments = [tuple(range(len(names)))]
    # A step's backward ends where the next forward's first gather comes,
    # which follows the previous step's last reduce-scatter.
    steps, fwd, bwd, in_bwd = [], [], [], False
    for e in log:
        if e == ("end",):
            in_bwd = True
        elif in_bwd and e[0] == "g" and bwd and bwd[-1][0] == "rs" and (
                sum(k == "rs" for k, _ in bwd)
                == sum(k == "g" for k, _ in fwd)):
            steps.append((fwd, bwd))
            fwd, bwd, in_bwd = [e], [], False
        elif in_bwd:
            bwd.append(e)
        else:
            fwd.append(e)
    steps.append((fwd, bwd))
    assert len(steps) == 3
    reread = (set() if tag not in ("fsdp4", "kept") else
              {names.index("mlm_bias"),
               names.index("token_embeddings.weight")})
    for n, (fwd, bwd) in enumerate(steps):
        assert all(kind == "g" for kind, _ in fwd)
        held = reread if n else set()
        whole = [tuple(j for j in seg if j not in held) for seg in segments]
        whole = [seg for seg in whole if seg]
        gathered = [idx for _, idx in fwd]
        assert [idx for idx in gathered if idx in whole] == whole
        alone = [idx for idx in gathered if idx not in whole]
        assert sorted(alone) == sorted((i,) for i in reread)
        regathers = [idx for kind, idx in bwd if kind == "g"]
        scatters = sorted(idx for kind, idx in bwd if kind == "rs")
        assert scatters == sorted(gathered)
        if tag == "upfront":
            assert regathers == []
            continue
        if tag == "kept":
            assert regathers == [(names.index("token_embeddings.weight"),)]
            continue
        # Each gather gathered again at most once, before its
        # reduce-scatter, and only in the leaves autograd saved (the
        # weights of the float32 products and LayerNorms, not the biases).
        assert regathers
        owners = [next(g for g in gathered if set(idx) <= set(g))
                  for idx in regathers]
        assert len(set(owners)) == len(owners)
        for idx, rec in zip(regathers, owners):
            assert bwd.index(("g", idx)) < bwd.index(("rs", rec))
            assert not any(names[i].endswith("attention.query.bias")
                           for i in idx)
        assert names.index("layers.0.attention.query.weight") in sum(
            regathers, ())
