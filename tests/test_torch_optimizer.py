"""The port's DistributedOptimizer and train step against the JAX
package's, on the same SGD-momentum problem.

The problem is ``_mlp_problem`` of tests/test_overlap.py (a 4-layer tanh
MLP). Two gloo ranks train it with horovod_tpu_torch (one spawn for the
module, every configuration in turn); JAX trains it with
``make_train_step`` on a 2-device process set; both take the same
per-step batches, split by rank. Compared: the averaged loss of every call
and the parameters after the last update. Tolerance: 1e-4 relative
(float32 trajectories of three updates; the two frameworks sum in
different orders). The same spawn trains under
``HOROVOD_NONFINITE_ACTION=skip`` with one rank's batch poisoned by a NaN
on the second step, held to the JAX package's trajectory under the same
setting. ``num_groups`` bucket plans are held to the plans the JAX
package's gradient reduction hands its fused allreduce.
"""

import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

WORLD = 2
LR, MOMENTUM = 0.1, 0.9
# name, compression, backward_passes_per_step, calls to the step function
CONFIGS = [("none", "none", 1, 3), ("bf16", "bf16", 1, 3),
           ("bpps2", "none", 2, 6)]
TOL = dict(rtol=1e-4, atol=1e-6)


def _problem():
    from test_overlap import _mlp_problem

    params, _, _ = _mlp_problem()
    leaves = {f"{layer}/{name}": np.asarray(arr)
              for layer, sub in sorted(params.items())
              for name, arr in sorted(sub.items())}
    rng = np.random.RandomState(1)
    batches = [(rng.randn(16, 8).astype(np.float32),
                rng.randn(16).astype(np.float32)) for _ in range(6)]
    return leaves, batches


def _poisoned(batches):
    """The batches with rank 1's rows of the second one made NaN."""
    out = [(x.copy(), y.copy()) for x, y in batches]
    out[1][0][8:] = np.nan
    return out


def _torch_loss(model, batch):
    x, y = batch
    h = x
    for i in range(4):
        h = torch.tanh(h @ model[f"layer{i}/w"] + model[f"layer{i}/b"])
    return ((h.sum(dim=-1) - y) ** 2).mean()


class _Params(torch.nn.Module):
    def __init__(self, leaves):
        super().__init__()
        self.p = torch.nn.ParameterDict(
            {k.replace("/", "_"): torch.nn.Parameter(torch.tensor(v))
             for k, v in leaves.items()})

    def __getitem__(self, key):
        return self.p[key.replace("/", "_")]


def _worker(rank, init_file, out_dir, leaves, batches):
    os.environ["HOROVOD_NUM_PROCESSES"] = str(WORLD)
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    res = {}
    for name, comp, k, calls in CONFIGS:
        model = _Params(leaves)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
            compression=getattr(hvd.Compression, comp),
            backward_passes_per_step=k)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        step = hvd.make_train_step(model, _torch_loss, opt)
        rows = slice(rank * 8, rank * 8 + 8)
        res[f"{name}.loss"] = np.array([
            float(step((torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))))
            for x, y in batches[:calls]])
        for key in leaves:
            res[f"{name}.{key}"] = model[key].detach().numpy().copy()
        opt.remove_hooks()
    _skip_run(hvd, rank, leaves, _poisoned(batches), res)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


def _skip_run(hvd, rank, leaves, batches, res):
    """Three steps under HOROVOD_NONFINITE_ACTION=skip, the second with a
    NaN in rank 1's rows: that step leaves every parameter and momentum
    buffer as it was, bit for bit, and the third moves them."""
    os.environ["HOROVOD_NONFINITE_ACTION"] = "skip"
    model = _Params(leaves)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM))
    del os.environ["HOROVOD_NONFINITE_ACTION"]
    step = hvd.make_train_step(model, _torch_loss, opt)
    rows = slice(rank * 8, rank * 8 + 8)

    def snapshot():
        return [t.detach().clone() for t in model.parameters()] + [
            opt.state[p]["momentum_buffer"].clone()
            for p in model.parameters()]

    losses, states = [], []
    for x, y in batches[:3]:
        losses.append(float(step((torch.from_numpy(x[rows]),
                                  torch.from_numpy(y[rows])))))
        states.append(snapshot())
    res["skip.loss"] = np.array(losses)
    res["skip.held"] = np.array(all(
        torch.equal(a, b) for a, b in zip(states[0], states[1])))
    res["skip.moved"] = np.array(not all(
        torch.equal(a, b) for a, b in zip(states[1], states[2])))
    res["skip.detections"] = np.array(opt.nonfinite_steps)
    for key in leaves:
        res[f"skip.{key}"] = model[key].detach().numpy().copy()
    opt.remove_hooks()


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture(scope="module")
def port_results(problem, tmp_path_factory):
    leaves, batches = problem
    tmp = tmp_path_factory.mktemp("torch_optimizer")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(
        r, str(tmp / "rendezvous"), str(tmp), leaves, batches))
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


def _jax_set(ranks):
    """The JAX world's process set over ``ranks``, and whether it was
    registered here: a set that another test module left registered is
    used as it is."""
    import horovod_tpu as jhvd
    from horovod_tpu import process_sets

    for ps in list(process_sets._table.values()):
        if ps.ranks == list(ranks):
            return ps, False
    return jhvd.add_process_set(list(ranks)), True


def _jax_trajectory(leaves, batches, comp, k, calls, ps=None):
    """The JAX package's trajectory on a two-device process set: ``ps``, or
    the set over devices 0 and 1."""
    import jax.numpy as jnp
    import optax

    import horovod_tpu as jhvd
    from horovod_tpu.parallel import data_parallel as dp
    from test_overlap import _mlp_problem

    params, _, loss_fn = _mlp_problem()
    own = False
    if ps is None:
        ps, own = _jax_set([0, 1])
    try:
        opt = jhvd.DistributedOptimizer(
            optax.sgd(LR, momentum=MOMENTUM),
            compression=getattr(jhvd.Compression, comp),
            backward_passes_per_step=k, process_set=ps)
        step = dp.make_train_step(loss_fn, opt, mesh=ps.mesh,
                                  axis_name=ps.axis_name)
        p = dp.replicate(params, mesh=ps.mesh)
        s = dp.replicate(opt.init(params), mesh=ps.mesh)
        losses = []
        for x, y in batches[:calls]:
            batch = dp.shard_batch((jnp.asarray(x), jnp.asarray(y)),
                                   mesh=ps.mesh, axis_name=ps.axis_name)
            p, s, loss = step(p, s, batch)
            losses.append(float(loss))
        final = {f"{layer}/{name}": np.asarray(arr)
                 for layer, sub in p.items() for name, arr in sub.items()}
        return np.array(losses), final
    finally:
        if own:
            jhvd.remove_process_set(ps)


@pytest.mark.parametrize("name,comp,k,calls", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_trajectory_matches_jax(problem, port_results, name, comp, k,
                                calls):
    leaves, batches = problem
    losses, final = _jax_trajectory(leaves, batches, comp, k, calls)
    for res in port_results:
        np.testing.assert_allclose(res[f"{name}.loss"], losses, **TOL)
        for key, want in final.items():
            np.testing.assert_allclose(res[f"{name}.{key}"], want,
                                       err_msg=f"{name}: {key}", **TOL)
    # The parameters moved: the comparison is not of two initial states.
    assert not np.allclose(final["layer0/w"], leaves["layer0/w"])


def test_skip_trajectory_matches_jax(problem, port_results, monkeypatch):
    """HOROVOD_NONFINITE_ACTION=skip with a poisoned step: both packages
    drop that step's update (its loss is NaN on both) and agree after."""
    leaves, batches = problem
    monkeypatch.setenv("HOROVOD_NONFINITE_ACTION", "skip")
    losses, final = _jax_trajectory(leaves, _poisoned(batches), "none", 1, 3)
    assert np.isnan(losses[1]) and np.isfinite(losses[[0, 2]]).all()
    for res in port_results:
        assert bool(res["skip.held"]) and bool(res["skip.moved"])
        assert int(res["skip.detections"]) == 1
        np.testing.assert_allclose(res["skip.loss"], losses, **TOL)
        for key, want in final.items():
            np.testing.assert_allclose(res[f"skip.{key}"], want,
                                       err_msg=f"skip: {key}", **TOL)


@pytest.mark.parametrize("num_groups,comp", [(1, "none"), (3, "none"),
                                             (4, "bf16"), (100, "none")])
def test_num_groups_bucket_plan_matches_jax(problem, monkeypatch, num_groups,
                                            comp):
    """num_groups caps each bucket at total / num_groups bytes of the wire:
    the port's buckets equal the ones the JAX package's _reduce_grads
    plans for the same leaves."""
    import jax.numpy as jnp

    import horovod_tpu as jhvd
    import horovod_tpu.optimizer as jopt
    import horovod_tpu_torch as hvd
    from horovod_tpu.ops.fusion import bucket_leaves as jax_buckets

    leaves, _ = problem
    plans = []

    def planned(wire, op, axis_name, threshold_bytes, **kw):
        plans.append(jax_buckets(wire, threshold_bytes))
        return wire

    monkeypatch.setattr(jopt, "fused_allreduce", planned)
    jopt._reduce_grads([jnp.asarray(v) for v in leaves.values()],
                       jhvd.Average, "hvd", getattr(jhvd.Compression, comp),
                       1.0, 1.0, None, num_groups, world_size=2)
    for key in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(key)
    hvd.init(device="cpu")
    try:
        model = _Params(leaves)
        params = list(model.parameters())
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(params, lr=LR), num_groups=num_groups,
            compression=getattr(hvd.Compression, comp))
        got = [[next(i for i, q in enumerate(params) if q is p) for p in b]
               for b in opt._buckets]
    finally:
        hvd.shutdown()
    assert len(plans) == 1 and got == plans[0]


def test_nonfinite_warn_and_abort():
    """warn logs, counts and steps; abort raises HorovodInternalError before
    the step; unset checks nothing. One rank, on the short-circuit path and
    with the wire forced on."""
    import subprocess
    import sys

    code = (
        "import os, torch, horovod_tpu_torch as hvd\n"
        "hvd.init(device='cpu')\n"
        "def run(action, force):\n"
        "    os.environ.pop('HOROVOD_NONFINITE_ACTION', None)\n"
        "    if action:\n"
        "        os.environ['HOROVOD_NONFINITE_ACTION'] = action\n"
        "    os.environ['HOROVOD_FORCE_WIRE_MACHINERY'] = force\n"
        "    w = torch.nn.Parameter(torch.tensor([1.0, 2.0]))\n"
        "    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0))\n"
        "    (w * torch.tensor([float('nan'), 1.0])).sum().backward()\n"
        "    try:\n"
        "        opt.step()\n"
        "    except hvd.HorovodInternalError as e:\n"
        "        return 'raised', opt.nonfinite_steps, w.detach().clone()\n"
        "    return 'stepped', opt.nonfinite_steps, w.detach().clone()\n"
        "for force in ('0', '1'):\n"
        "    out, n, w = run('warn', force)\n"
        "    assert out == 'stepped' and n == 1 and torch.isnan(w[0]), (out, n, w)\n"
        "    out, n, w = run('abort', force)\n"
        "    assert out == 'raised' and n == 1 and torch.equal(w, torch.tensor([1.0, 2.0]))\n"
        "    out, n, w = run('skip', force)\n"
        "    assert out == 'stepped' and n == 1 and torch.equal(w, torch.tensor([1.0, 2.0]))\n"
        "    out, n, w = run(None, force)\n"
        "    assert out == 'stepped' and n == 0 and torch.isnan(w[0])\n"
        "hvd.shutdown()\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stderr.count("non-finite reduced gradients") == 6


def test_single_rank_short_circuit_applies_only_the_scales():
    """One member: no wire, gradients scaled by prescale * postscale (and
    averaged over the accumulated passes); HOROVOD_FORCE_WIRE_MACHINERY=1
    runs the full path with the same result."""
    import subprocess
    import sys

    code = (
        "import os, torch, horovod_tpu_torch as hvd\n"
        "hvd.init(device='cpu')\n"
        "def grads(**kw):\n"
        "    w = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))\n"
        "    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0), **kw)\n"
        "    for _ in range(opt.backward_passes_per_step):\n"
        "        (w * torch.tensor([1.0, 2.0, 4.0])).sum().backward()\n"
        "    opt.step()\n"
        "    return opt, w.grad.clone()\n"
        "kw = dict(prescale_factor=2.0, postscale_factor=0.25,\n"
        "          backward_passes_per_step=2)\n"
        "opt, g = grads(**kw)\n"
        "assert opt._short_circuit and not opt._hooks\n"
        "os.environ['HOROVOD_FORCE_WIRE_MACHINERY'] = '1'\n"
        "opt2, g2 = grads(**kw)\n"
        "assert not opt2._short_circuit and opt2._hooks\n"
        "want = torch.tensor([0.5, 1.0, 2.0])\n"
        "assert torch.equal(g, want) and torch.equal(g2, want), (g, g2)\n"
        "hvd.shutdown()\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_optimizer_reads_each_new_world_once():
    """The wire decision is read when a world forms, not per gradient: an
    optimizer built in a short-circuited world goes on the wire (hooks,
    buckets launched in backward) in the next world that forces it, and
    leaves it again in a world that does not; one whose hooks the caller
    removed is never hooked again."""
    import subprocess
    import sys

    code = (
        "import os, torch, horovod_tpu_torch as hvd\n"
        "hvd.init(device='cpu')\n"
        "w = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))\n"
        "opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.0),\n"
        "                               postscale_factor=0.5)\n"
        "gone = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.0))\n"
        "gone.remove_hooks()\n"
        "def grad():\n"
        "    w.grad = None\n"
        "    (w * torch.tensor([1.0, 2.0, 4.0])).sum().backward()\n"
        "    launched = len(opt._launched)\n"
        "    opt.step()\n"
        "    return launched, w.grad.clone()\n"
        "assert opt._short_circuit and not opt._hooks\n"
        "want = torch.tensor([0.5, 1.0, 2.0])\n"
        "n, g = grad()\n"
        "assert n == 0 and torch.equal(g, want), (n, g)\n"
        "hvd.shutdown()\n"
        "os.environ['HOROVOD_FORCE_WIRE_MACHINERY'] = '1'\n"
        "hvd.init(device='cpu')\n"
        "assert not opt._short_circuit and opt._hooks and not gone._hooks\n"
        "n, g = grad()\n"
        "assert n == 1 and torch.equal(g, want), (n, g)\n"
        "hvd.shutdown()\n"
        "del os.environ['HOROVOD_FORCE_WIRE_MACHINERY']\n"
        "hvd.init(device='cpu')\n"
        "assert opt._short_circuit and not opt._hooks\n"
        "n, g = grad()\n"
        "assert n == 0 and torch.equal(g, want), (n, g)\n"
        "hvd.shutdown()\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sync_modes_not_yet_ported_raise(monkeypatch):
    """The sync modes resolve from the argument, then ``HOROVOD_SYNC_MODE``,
    then the default; every mode of the reference is ported, and an unknown
    one (``zero3``) still raises listing the valid ones."""
    from horovod_tpu_torch.optimizer import resolve_sync_mode

    monkeypatch.delenv("HOROVOD_SYNC_MODE", raising=False)
    assert resolve_sync_mode() == "allreduce"
    for mode in ("allreduce", "sharded", "fsdp"):
        assert resolve_sync_mode(mode) == mode
        monkeypatch.setenv("HOROVOD_SYNC_MODE", mode.upper())
        assert resolve_sync_mode() == mode
    monkeypatch.setenv("HOROVOD_SYNC_MODE", "fsdp")
    assert resolve_sync_mode("sharded") == "sharded"
    with pytest.raises(ValueError, match="expected one of"):
        resolve_sync_mode("zero3")
    monkeypatch.setenv("HOROVOD_SYNC_MODE", "zero3")
    with pytest.raises(ValueError, match="expected one of"):
        resolve_sync_mode()


def test_int8_builds_an_optimizer():
    """Compression.int8 builds a DistributedOptimizer (one gloo rank, the
    wire forced on): a step quantizes and dequantizes the gradient, within
    one quantum of each block's scale; as a plain compressor it raises."""
    import subprocess
    import sys

    code = (
        "import os, torch\n"
        "os.environ['HOROVOD_FORCE_WIRE_MACHINERY'] = '1'\n"
        "import horovod_tpu_torch as hvd\n"
        "hvd.init(device='cpu')\n"
        "w = torch.nn.Parameter(torch.zeros(3000))\n"
        "opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),\n"
        "                               compression=hvd.Compression.int8)\n"
        "g = torch.linspace(-2.0, 3.0, 3000)\n"
        "(w * g).sum().backward()\n"
        "opt.step()\n"
        "quantum = 3.0 / 127\n"
        "assert (w.grad - g).abs().max().item() <= quantum, w.grad\n"
        "assert torch.equal(w.detach(), -w.grad) and opt._updates == 1\n"
        "try:\n"
        "    hvd.Compression.int8.compress(g)\n"
        "except ValueError as e:\n"
        "    assert 'DistributedOptimizer' in str(e)\n"
        "else:\n"
        "    raise AssertionError('int8 compress did not raise')\n"
        "hvd.shutdown()\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr