"""The port's overlap scheduler (``overlap_gradient_sync``,
``make_overlapped_train_step``, ``make_train_step(...,
deferred_param_gather=True)``) against the JAX package's, and against the
port's own ``make_train_step``.

The problem is ``_mlp_problem`` of tests/test_overlap.py (a 4-layer tanh
MLP, 8 leaves). Four gloo ranks train it with horovod_tpu_torch (one spawn
for the module, every configuration in turn); the JAX package trains it on
a 4-device process set; both take the same per-step batches, split by
rank, and the same bucket cap (600 bytes). Each overlapped run takes 3
segments. Compared, at 1e-4 relative and 1e-5 absolute (float32 over
three updates; the frameworks sum in other orders):

- allreduce mode, SGD with momentum and AdamW, on the float32 and fp16
  wires: the loss of every step and the final parameters, to the JAX
  package's ``make_overlapped_train_step`` and to the port's
  ``make_train_step``. The fp16 wire runs on the process set {0, 1}: a sum
  of two fp16 values rounds once whatever the order, where gloo's ring and
  XLA sum four in other orders and round each partial sum to fp16 (2e-4
  apart after three steps). On the float32 wire at four ranks the port's
  two steps are not bit for bit equal (gloo's ring sums an element in an
  order set by its place in its bucket, and segments move the bucket
  boundaries); at one rank (the card's ``overlap`` phase) they are. The
  sharded and fsdp steps are bit for bit the port's ``make_train_step``
  here, which the test holds;
- sharded mode against the JAX package's overlapped sharded step, and rank
  r's momentum shards to row r of its stacked state;
- fsdp mode: the overlapped step at 3 segments bit for bit equal to the
  port's ``make_train_step`` at 3 segments (the same step), and to the JAX
  package's overlapped fsdp step;
- the int8 wire: no noisier than the JAX package's (as
  tests/test_torch_sharded.py holds it), every rank holding the same
  parameters;
- the deferred gather, float32 and int8: bit for bit the step without it
  (the same gathers, the int8 one salted before the increment), and a
  checkpoint written between steps holds the gathered parameters;
- ``overlap_gradient_sync`` used directly through ``functional_call``: each
  ``.grad`` after ``backward()`` is the JAX package's reduced gradient;
- the launch order: the last segment's collective is launched before the
  first segment's gradients exist;
- the segment maps, the refusals, and the joint (threshold, segments)
  grid under ``HOROVOD_AUTOTUNE=1``.
"""

import json
import multiprocessing as mp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

N = 4
LR, MOMENTUM = 0.1, 0.9
ADAM_LR, WD = 0.05, 1e-2
THRESHOLD = 600
K = 3
TOL = dict(rtol=1e-4, atol=1e-5)
SEGMENT_COUNTS = (1, 2, 3, 8, 100)
# name, mode, optimizer, compression, members (the first ranks)
CONFIGS = [
    ("ar_sgd", "allreduce", "sgd", "none", N),
    ("ar_adamw", "allreduce", "adamw", "none", N),
    ("ar_sgd_fp16", "allreduce", "sgd", "fp16", 2),
    ("ar_adamw_fp16", "allreduce", "adamw", "fp16", 2),
    ("ar_int8", "allreduce", "sgd", "int8", N),
    ("sh_sgd", "sharded", "sgd", "none", N),
    ("sh_adamw", "sharded", "adamw", "none", N),
    ("fsdp_adamw", "fsdp", "adamw", "none", N),
]
DEFERRED = [("deferred_f32", "adamw", "none"), ("deferred_int8", "sgd", "int8")]
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem():
    from test_torch_optimizer import _problem as mlp_problem

    return mlp_problem()


def _inner(params, kind):
    if kind == "sgd":
        return torch.optim.SGD(params, lr=LR, momentum=MOMENTUM)
    return torch.optim.AdamW(params, lr=ADAM_LR, weight_decay=WD)


def _batch(batch, rank, members=N):
    x, y = batch
    m = len(x) // members
    rows = slice(rank * m, rank * m + m)
    return torch.from_numpy(x[rows]), torch.from_numpy(y[rows])


def _full(opt, model, mode):
    return (opt.full_parameters() if mode == "fsdp"
            else [p.detach().clone() for p in model.parameters()])


def _train(hvd, rank, leaves, batches, mode, kind, comp, overlapped,
           members=N, process_set=None):
    """Three steps of one factory: (losses, final full parameters, model,
    optimizer)."""
    from test_torch_optimizer import _Params, _torch_loss

    model = _Params(leaves)
    opt = hvd.DistributedOptimizer(
        _inner(model.parameters(), kind), sync_mode=mode,
        compression=getattr(hvd.Compression, comp),
        fusion_threshold_bytes=THRESHOLD, process_set=process_set)
    if overlapped:
        step = hvd.make_overlapped_train_step(model, _torch_loss, opt,
                                              num_segments=K)
    else:
        os.environ["HOROVOD_FSDP_SEGMENTS"] = str(K)
        step = hvd.make_train_step(model, _torch_loss, opt)
        del os.environ["HOROVOD_FSDP_SEGMENTS"]
    losses = [float(step(_batch(b, rank, members))) for b in batches[:3]]
    return np.array(losses), _full(opt, model, mode), model, opt


def _run(hvd, rank, leaves, batches, name, mode, kind, comp, members, sets,
         res):
    if rank >= members:
        return
    kw = dict(members=members, process_set=sets.get(members))
    losses, full, _, opt = _train(hvd, rank, leaves, batches, mode, kind,
                                  comp, overlapped=True, **kw)
    mono_losses, mono, _, _ = _train(hvd, rank, leaves, batches, mode, kind,
                                     comp, overlapped=False, **kw)
    res[f"{name}.loss"] = losses
    res[f"{name}.mono_loss"] = mono_losses
    for key, t, m in zip(leaves, full, mono):
        res[f"{name}.{key}"] = t.numpy().copy()
        res[f"{name}.mono.{key}"] = m.numpy().copy()
    res[f"{name}.bitwise"] = np.array(
        list(losses) == list(mono_losses)
        and all(torch.equal(a, b) for a, b in zip(full, mono)))
    if mode == "sharded" and kind == "sgd":
        for key, s in zip(leaves, opt._shards):
            res[f"{name}.mom.{key}"] = (
                opt._opt.state[s]["momentum_buffer"].numpy().copy())


def _deferred_run(hvd, rank, leaves, batches, name, kind, comp, tmp, res):
    """Sharded steps with and without the deferred gather; a checkpoint
    after the deferred run's second step."""
    from test_torch_optimizer import _Params, _torch_loss

    from horovod_tpu_torch import checkpoint

    runs = {}
    for deferred in (False, True):
        model = _Params(leaves)
        opt = hvd.DistributedOptimizer(
            _inner(model.parameters(), kind), sync_mode="sharded",
            compression=getattr(hvd.Compression, comp),
            fusion_threshold_bytes=THRESHOLD)
        step = hvd.make_train_step(model, _torch_loss, opt,
                                   deferred_param_gather=deferred)
        losses = []
        for i, b in enumerate(batches[:3]):
            losses.append(float(step(_batch(b, rank))))
            if i != 1:
                continue
            if not deferred:
                runs["after2"] = [p.detach().clone()
                                  for p in model.parameters()]
                continue
            stale = [p.detach().clone() for p in model.parameters()]
            path = os.path.join(tmp, f"{name}.ckpt")
            hvd.save_state_on_rank_0(path, opt, model)
            saved = checkpoint.load_and_broadcast(path)["params"]
            res[f"{name}.in_flight"] = np.array(not all(
                torch.equal(a, b) for a, b in zip(stale, runs["after2"])))
            res[f"{name}.ckpt_equal"] = np.array(all(
                torch.equal(saved[n], b) for (n, _), b in zip(
                    model.named_parameters(), runs["after2"])))
        if deferred:
            handle = step.deferred_params
            res[f"{name}.handle"] = np.array(
                isinstance(handle, hvd.DeferredParams))
            final = [p.detach().clone() for p in handle.block_until_ready()]
            res[f"{name}.salt"] = np.array(opt._updates)
        else:
            final = [p.detach().clone() for p in model.parameters()]
        runs[deferred] = (losses, final)
    res[f"{name}.equal"] = np.array(
        runs[True][0] == runs[False][0]
        and all(torch.equal(a, b) for a, b in zip(runs[True][1],
                                                  runs[False][1])))
    for key, t in zip(leaves, runs[True][1]):
        res[f"{name}.{key}"] = t.numpy().copy()


class _Loss(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch):
        from test_torch_optimizer import _torch_loss

        return _torch_loss(self.model, batch)


def _direct_run(hvd, rank, leaves, batches, res):
    """``overlap_gradient_sync`` through ``functional_call``, with a log of
    the segments' launches, the collectives' launches and the gradients of
    the first segment's leaves (layer 0) as the backward computes them."""
    from test_torch_optimizer import _Params

    import horovod_tpu_torch.optimizer as hopt
    from horovod_tpu_torch.parallel import data_parallel as dp

    model = _Params(leaves)
    opt = hvd.DistributedOptimizer(_inner(model.parameters(), "sgd"),
                                   fusion_threshold_bytes=THRESHOLD)
    spec = hvd.reduce_spec_of(opt)
    log = []
    launch, start = dp._Overlap._launch, hopt.start_allreduce

    def logged_launch(self, si):
        log.append(["segment", si])
        return launch(self, si)

    def logged_start(*a, **k):
        log.append(["collective"])
        return start(*a, **k)

    dp._Overlap._launch, hopt.start_allreduce = logged_launch, logged_start
    try:
        synced = hvd.overlap_gradient_sync(dict(model.named_parameters()),
                                           spec, num_segments=K)
        for name in ("p.layer0_b", "p.layer0_w"):
            synced[name].register_hook(
                lambda g, name=name: log.append(["grad", name]))
        loss = torch.func.functional_call(
            _Loss(model), {f"model.{n}": t for n, t in synced.items()},
            (_batch(batches[0], rank),))
        loss.backward()
    finally:
        dp._Overlap._launch, hopt.start_allreduce = launch, start
    for key, p in zip(leaves, model.parameters()):
        res[f"direct.grad.{key}"] = p.grad.numpy().copy()
    res["direct.log"] = np.array(json.dumps(log))
    opt.remove_hooks()


def _refusals(hvd, res):
    """The factories' refusals, with their messages."""
    from test_torch_optimizer import _torch_loss

    w = torch.nn.Parameter(torch.zeros(3))
    model = torch.nn.Module()
    model.w = w
    cases = {
        "accumulation": lambda: hvd.make_overlapped_train_step(
            model, _torch_loss, hvd.DistributedOptimizer(
                torch.optim.SGD([w], lr=0.1), backward_passes_per_step=4)),
        "deferred_fsdp": lambda: hvd.make_train_step(
            model, _torch_loss, hvd.DistributedOptimizer(
                torch.optim.SGD([w], lr=0.1), sync_mode="fsdp"),
            deferred_param_gather=True),
        "deferred_allreduce": lambda: hvd.make_train_step(
            model, _torch_loss, hvd.DistributedOptimizer(
                torch.optim.SGD([w], lr=0.1)), deferred_param_gather=True),
    }
    for name, make in cases.items():
        try:
            make()
            res[f"refuse.{name}"] = np.array(json.dumps(["accepted", ""]))
        except Exception as e:  # noqa: BLE001 -- the message is the result
            res[f"refuse.{name}"] = np.array(json.dumps(
                [type(e).__name__, str(e)]))


def _segment_maps(hvd, leaves, res):
    from test_torch_optimizer import _Params, _torch_loss

    for k in SEGMENT_COUNTS:
        model = _Params(leaves)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=LR))
        step = hvd.make_overlapped_train_step(model, _torch_loss, opt,
                                              num_segments=k)
        res[f"segments.{k}"] = np.array(json.dumps(step.segments()))
        opt.remove_hooks()


def _autotune_run(hvd, rank, leaves, batches, res):
    """The joint grid under HOROVOD_AUTOTUNE=1 with an injected clock that
    favours more segments (tests/test_overlap.py:259-299)."""
    from test_torch_optimizer import _Params, _torch_loss

    from horovod_tpu_torch import autotune as at
    from horovod_tpu_torch.ops.fusion import overlap_segments

    os.environ["HOROVOD_AUTOTUNE"] = "1"
    try:
        model = _Params(leaves)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=LR))
        step = hvd.make_overlapped_train_step(model, _torch_loss, opt)
        tuner = step._fn
        res["tune.is_tuner"] = np.array(
            isinstance(tuner, at.AutotuneStep) and tuner._tune_segments)
        res["tune.candidates"] = np.array(len(tuner._cands))
        t = {"now": 0.0}

        def clock():  # more segments -> cheaper, deterministically
            t["now"] += 2.0 - (at.tuned_segments() or 0) / 10.0
            return t["now"]

        tuner._clock = clock
        b = _batch(batches[0], rank)
        for _ in range(len(tuner._cands) * (1 + tuner._iters)):
            step(b)
        res["tune.done"] = np.array(not tuner._hvd_tuning)
        res["tune.pinned"] = np.array(at.tuned_segments())
        res["tune.overlap_segments"] = np.array(overlap_segments())
        res["tune.state"] = np.array(
            at.autotune_state()["overlap_segments"])
        res["tune.step_segments"] = np.array(len(step.segments()))
        res["tune.loss"] = np.array(float(step(b)))
    finally:
        del os.environ["HOROVOD_AUTOTUNE"]
        at.reset_for_testing()


def _worker(rank, init_file, out_dir, leaves, batches):
    os.environ["HOROVOD_NUM_PROCESSES"] = str(N)
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    # Every rank registers the set, members or not (one new_group each).
    sets = {2: hvd.add_process_set([0, 1])}
    res = {}
    _segment_maps(hvd, leaves, res)
    for name, mode, kind, comp, members in CONFIGS:
        _run(hvd, rank, leaves, batches, name, mode, kind, comp, members,
             sets, res)
    for name, kind, comp in DEFERRED:
        _deferred_run(hvd, rank, leaves, batches, name, kind, comp, out_dir,
                      res)
    _direct_run(hvd, rank, leaves, batches, res)
    _refusals(hvd, res)
    _autotune_run(hvd, rank, leaves, batches, res)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture(scope="module")
def port_results(problem, tmp_path_factory):
    leaves, batches = problem
    tmp = tmp_path_factory.mktemp("torch_overlap")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(
        r, str(tmp / "rendezvous"), str(tmp), leaves, batches))
        for r in range(N)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs])
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]


_JAX_CACHE: dict = {}


def _jax_run(mode, kind, comp, overlapped=True, members=N):
    """The JAX package's trajectory on a process set of the first
    ``members`` devices: losses, final full parameters by key, and the
    stacked state leaves."""
    key = (mode, kind, comp, overlapped, members)
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
    ps, own = _jax_set(list(range(members)))
    inner = (optax.sgd(LR, momentum=MOMENTUM) if kind == "sgd"
             else optax.adamw(ADAM_LR, weight_decay=WD))
    try:
        opt = jhvd.DistributedOptimizer(
            inner, compression=getattr(jhvd.Compression, comp),
            process_set=ps, sync_mode=mode, fusion_threshold_bytes=THRESHOLD)
        place = dict(mesh=ps.mesh, axis_name=ps.axis_name)
        if overlapped:
            step = dp.make_overlapped_train_step(
                loss_fn, opt, donate=False, num_segments=K, **place)
        else:
            step = dp.make_train_step(loss_fn, opt, donate=False, **place)
        p = (dp.shard_state(jhvd.shard_params(params, members), **place)
             if mode == "fsdp" else dp.replicate(params, mesh=ps.mesh))
        s = (dp.replicate(opt.init(params), mesh=ps.mesh)
             if mode == "allreduce" else dp.shard_state(opt.init(params),
                                                        **place))
        losses = []
        for x, y in batches[:3]:
            batch = dp.shard_batch((jnp.asarray(x), jnp.asarray(y)), **place)
            p, s, loss = step(p, s, batch)
            losses.append(float(loss))
        p = jax.device_get(p)
        if mode == "fsdp":
            p = jhvd.unshard_params(p)
        final = {f"{layer}/{name}": np.asarray(arr)
                 for layer, sub in p.items() for name, arr in sub.items()}
        state = [np.asarray(a) for a in jax.tree.leaves(jax.device_get(s))]
        out = (np.array(losses), final, state)
    finally:
        if own:
            jhvd.remove_process_set(ps)
    _JAX_CACHE[key] = out
    return out


def _jax_reduced_grads():
    """The JAX package's ``overlap_gradient_sync`` gradients of batch 0 at
    the initial parameters, over the 4-device set (averaged)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    import horovod_tpu as jhvd
    from test_overlap import _mlp_problem
    from test_torch_optimizer import _jax_set

    params, _, loss_fn = _mlp_problem()
    _, batches = _problem()
    ps, own = _jax_set(list(range(N)))
    try:
        opt = jhvd.DistributedOptimizer(optax.sgd(LR), process_set=ps,
                                        fusion_threshold_bytes=THRESHOLD)
        spec = jhvd.reduce_spec_of(opt)

        def grads(p, b):
            return jax.grad(lambda q: loss_fn(jhvd.overlap_gradient_sync(
                q, spec, axis_name=ps.axis_name, num_segments=K), b))(p)

        fn = jax.jit(jax.shard_map(
            grads, mesh=ps.mesh, in_specs=(P(), P(ps.axis_name)),
            out_specs=P(), check_vma=False))
        x, y = batches[0]
        g = jax.device_get(fn(params, (jnp.asarray(x), jnp.asarray(y))))
    finally:
        if own:
            jhvd.remove_process_set(ps)
    return {f"{layer}/{name}": np.asarray(arr)
            for layer, sub in g.items() for name, arr in sub.items()}


def test_segment_maps_equal_jax(problem, port_results):
    import jax.numpy as jnp

    from horovod_tpu.ops.fusion import segment_leaves
    from test_overlap import _mlp_problem

    params, _, _ = _mlp_problem()
    jleaves = [jnp.asarray(a) for a in jax_leaves(params)]
    for k in SEGMENT_COUNTS:
        want = segment_leaves(jleaves, k)
        for res in port_results:
            assert json.loads(str(res[f"segments.{k}"])) == want, k


def jax_leaves(params):
    import jax

    return jax.tree.leaves(params)


@pytest.mark.parametrize("name,mode,kind,comp,members", [
    c for c in CONFIGS if c[3] != "int8"], ids=[
    c[0] for c in CONFIGS if c[3] != "int8"])
def test_overlapped_step_matches_jax_and_make_train_step(
        problem, port_results, name, mode, kind, comp, members):
    leaves, _ = problem
    losses, final, _ = _jax_run(mode, kind, comp, members=members)
    for res in port_results[:members]:
        np.testing.assert_allclose(res[f"{name}.loss"], losses, **TOL)
        np.testing.assert_allclose(res[f"{name}.loss"],
                                   res[f"{name}.mono_loss"], **TOL)
        for key, want in final.items():
            np.testing.assert_allclose(res[f"{name}.{key}"], want,
                                       err_msg=f"{name}: {key}", **TOL)
            np.testing.assert_allclose(res[f"{name}.{key}"],
                                       res[f"{name}.mono.{key}"],
                                       err_msg=f"{name}: {key}", **TOL)
        if mode != "allreduce":
            assert bool(res[f"{name}.bitwise"]), name
    assert not np.allclose(final["layer0/w"], leaves["layer0/w"])


def test_sharded_moment_shards_equal_jax_rows(problem, port_results):
    leaves, _ = problem
    _, _, state = _jax_run("sharded", "sgd", "none")
    for r, res in enumerate(port_results):
        for i, key in enumerate(leaves):
            np.testing.assert_allclose(res[f"sh_sgd.mom.{key}"],
                                       state[i][r], err_msg=key, **TOL)


def test_int8_wire_no_noisier_than_jax(problem, port_results):
    leaves, _ = problem
    losses, final, _ = _jax_run("allreduce", "sgd", "int8")
    _, final_f32, _ = _jax_run("allreduce", "sgd", "none", overlapped=False)
    jax_stray = max(np.abs(final[k] - final_f32[k]).max() for k in final)
    for res in port_results:
        stray = max(np.abs(res[f"ar_int8.{k}"] - res[f"ar_sgd.mono.{k}"])
                    .max() for k in final)
        assert 0 < stray <= 1.5 * jax_stray, (stray, jax_stray)
        assert np.isfinite(res["ar_int8.loss"]).all()
        assert res["ar_int8.loss"][-1] < res["ar_int8.loss"][0]
    assert losses[-1] < losses[0]
    for key in leaves:
        assert all(np.array_equal(res[f"ar_int8.{key}"],
                                  port_results[0][f"ar_int8.{key}"])
                   for res in port_results)


@pytest.mark.parametrize("name", [d[0] for d in DEFERRED])
def test_deferred_gather_equals_the_step_without_it(port_results, name):
    for res in port_results:
        assert bool(res[f"{name}.handle"])
        assert bool(res[f"{name}.equal"]), name
        assert bool(res[f"{name}.in_flight"]), name
        assert bool(res[f"{name}.ckpt_equal"]), name
        assert int(res[f"{name}.salt"]) == 3


def test_deferred_gather_matches_jax(problem, port_results):
    """The deferred sharded AdamW trajectory against the JAX package's
    deferred sharded step."""
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as jhvd
    from horovod_tpu.parallel import data_parallel as dp
    from test_overlap import _mlp_problem
    from test_torch_optimizer import _jax_set

    params, _, loss_fn = _mlp_problem()
    _, batches = problem
    ps, own = _jax_set(list(range(N)))
    try:
        opt = jhvd.DistributedOptimizer(
            optax.adamw(ADAM_LR, weight_decay=WD), process_set=ps,
            sync_mode="sharded", fusion_threshold_bytes=THRESHOLD)
        place = dict(mesh=ps.mesh, axis_name=ps.axis_name)
        step = dp.make_train_step(loss_fn, opt, donate=False,
                                  deferred_param_gather=True, **place)
        p = dp.replicate(params, mesh=ps.mesh)
        s = dp.shard_state(opt.init(params), **place)
        for x, y in batches[:3]:
            p, s, _ = step(p, s, dp.shard_batch(
                (jnp.asarray(x), jnp.asarray(y)), **place))
        assert isinstance(p, jhvd.DeferredParams)
        final = jax.device_get(p.block_until_ready())
    finally:
        if own:
            jhvd.remove_process_set(ps)
    for res in port_results:
        for layer, sub in final.items():
            for leaf, want in sub.items():
                np.testing.assert_allclose(
                    res[f"deferred_f32.{layer}/{leaf}"], np.asarray(want),
                    err_msg=f"{layer}/{leaf}", **TOL)


def test_overlap_gradient_sync_through_functional_call(port_results):
    want = _jax_reduced_grads()
    for res in port_results:
        for key, g in want.items():
            np.testing.assert_allclose(res[f"direct.grad.{key}"], g,
                                       err_msg=key, **TOL)


def test_last_segment_launches_before_first_segment_gradients(
        port_results):
    """The port's counterpart of the JAX package's interleaving test: on
    every rank the last segment's reduction (and its collectives) is
    launched before the backward has formed any gradient of the first
    segment (layer 0), and the segments launch last first."""
    for res in port_results:
        log = json.loads(str(res["direct.log"]))
        segments = [e[1] for e in log if e[0] == "segment"]
        assert segments == list(reversed(range(K))), log
        first_grad = next(i for i, e in enumerate(log) if e[0] == "grad")
        last = log.index(["segment", K - 1])
        assert last < first_grad, log
        assert ["collective"] in log[last:first_grad], log


def test_refusals_keep_the_reference_words(port_results):
    for res in port_results:
        kind, msg = json.loads(str(res["refuse.accumulation"]))
        assert kind == "ValueError" and "backward_passes_per_step" in msg
        kind, msg = json.loads(str(res["refuse.deferred_fsdp"]))
        assert kind == "SyncModeIneligibleError" and "NO trailing" in msg
        kind, msg = json.loads(str(res["refuse.deferred_allreduce"]))
        assert kind == "ValueError" and "sync_mode='sharded'" in msg


def test_refuses_a_bare_optimizer():
    import horovod_tpu_torch as hvd

    w = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="DistributedOptimizer"):
        hvd.make_overlapped_train_step(torch.nn.Linear(3, 3),
                                       lambda m, b: m(b).sum(),
                                       torch.optim.SGD([w], lr=0.1))


def test_joint_grid_pins_the_largest_segment_count(port_results):
    from horovod_tpu_torch import autotune as at

    for res in port_results:
        assert bool(res["tune.is_tuner"])
        assert int(res["tune.candidates"]) == (
            len(at.DEFAULT_SEGMENT_CANDIDATES) * len(at.DEFAULT_THRESHOLDS))
        assert bool(res["tune.done"])
        top = max(at.DEFAULT_SEGMENT_CANDIDATES)
        assert int(res["tune.pinned"]) == top
        assert int(res["tune.overlap_segments"]) == top
        assert int(res["tune.state"]) == top
        assert int(res["tune.step_segments"]) == top  # 8 leaves, 8 segments
        assert np.isfinite(float(res["tune.loss"]))


def test_overlap_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys; import horovod_tpu_torch as hvd; "
            "hvd.make_overlapped_train_step; hvd.overlap_gradient_sync; "
            "hvd.DeferredParams; hvd.ReduceSpec; hvd.reduce_spec_of; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'horovod_tpu.')) or m == 'horovod_tpu']; "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
