"""The port's device-memory observatory (``horovod_tpu_torch/memory.py``)
held to the JAX package's (``horovod_tpu/memory.py``), and to the bytes
torch holds.

``predict_footprint`` on the same leaf descriptors (made from a seed with
numpy) gives the reference's numbers exactly in every sync mode;
``footprint_of`` of a small BERT's ``DistributedOptimizer`` equals the
parameters, gradients and optimizer state torch holds after one step, on one
rank and on three gloo ranks (uneven shards). The call sites note resident
bytes, the tracer drives the watermarks, an out-of-memory error at the step
boundary dumps the memory flight record, the merges and the autotune guard
agree with the reference's, and the rendezvous server serves ``/comms`` and
``/memory`` from heartbeats as the reference's does.
"""

import dataclasses
import json
import multiprocessing as mp
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu import memory as jmem
from horovod_tpu_torch import memory as pmem

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for key in ("HOROVOD_HBM_BYTES_PER_DEVICE", "HOROVOD_HBM_OPT_SLOTS",
                "HOROVOD_FUSION_THRESHOLD", "HOROVOD_AUTOTUNE_MEMORY_GUARD",
                "HOROVOD_SIZE", "HOROVOD_FSDP_SEGMENTS", "HOROVOD_SYNC_MODE",
                "HOROVOD_FAULTS", "HOROVOD_EVENT_LOG"):
        monkeypatch.delenv(key, raising=False)
    jmem.reset_for_testing()
    pmem.reset_for_testing()
    yield
    jmem.reset_for_testing()
    pmem.reset_for_testing()


def _descriptors(seed):
    """Leaf descriptors with uneven, scalar and mixed-dtype leaves."""
    rng = np.random.RandomState(seed)
    dtypes = [(4, "float32"), (2, "bfloat16"), (1, "int8")]
    leaves = [(1, 4, "float32"), (int(rng.randint(2, 9)), 4, "float32")]
    for _ in range(rng.randint(3, 40)):
        itemsize, name = dtypes[rng.randint(3)] if rng.rand() < 0.3 \
            else dtypes[0]
        leaves.append((int(rng.randint(1, 1 << 18)), itemsize, name))
    return leaves


CONFIGS = [
    dict(),
    dict(world_size=8),
    dict(world_size=3, int8=True),
    dict(world_size=8, num_segments=4, threshold_bytes=1 << 16),
    dict(world_size=8, mesh_shape=(4, 2), num_segments=3),
    dict(world_size=6, opt_slots=2, grad_itemsize=2),
    dict(world_size=4, expert_set={"tokens_per_rank": 64, "hidden": 32},
         serving_staging=True, capacity=1 << 24),
    dict(world_size=5, expert_set={"bytes": 12345}, capacity=1 << 40),
]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("config", range(len(CONFIGS)))
@pytest.mark.parametrize("mode", ["allreduce", "sharded", "fsdp"])
def test_predict_footprint_is_the_references(seed, config, mode):
    leaves = _descriptors(seed)
    kw = dict(CONFIGS[config])
    if config % 2 == 0:
        # The monolithic opt templates: two moments and a scalar count.
        kw["opt_templates"] = ([(s, i, d) for s, i, d in leaves] * 2
                               + [(1, 4, "int32")])
    assert pmem.predict_footprint(leaves, mode, **kw) == \
        jmem.predict_footprint(leaves, mode, **kw)


@pytest.mark.parametrize("size,n", [(10, 8), (1, 4), (7, 7), (100, 3),
                                    (0, 2)])
def test_ceil_shard_is_the_references(size, n):
    assert pmem.ceil_shard(size, n) == jmem.ceil_shard(size, n)


# -- footprint_of against what torch holds ------------------------------------


def _bert(seed=0):
    from horovod_tpu_torch.models import bert

    cfg = dataclasses.replace(bert.BERT_TINY, dropout_rate=0.0,
                              dtype=torch.float32)
    torch.manual_seed(seed)
    return bert.Bert(cfg), cfg


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16)))
    pos = torch.from_numpy(np.stack([rng.choice(16, 3, replace=False)
                                     for _ in range(2)]))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 3)))
    return ids, pos, labels, torch.ones(2, 3)


def _loss(model, b):
    from horovod_tpu_torch.models import bert

    _, logits = model(b[0], masked_positions=b[1])
    return bert.mlm_loss(logits, b[2], b[3])


INNER = {
    "sgd": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
    "adam": lambda ps: torch.optim.Adam(ps, lr=1e-3),
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=0.01),
}


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _held_after_one_step(hvd, mode, inner, seed):
    """One step of ``make_train_step``; the footprint, with its transient
    gradients beside the resident kinds, and the bytes torch holds at the
    step's ``zero_grad``, before it drops the gradients."""
    from horovod_tpu_torch import memory

    model, cfg = _bert(seed)
    opt = hvd.DistributedOptimizer(
        INNER[inner](model.parameters()), sync_mode=mode,
        named_parameters=model.named_parameters())
    shards = (opt._shards if mode == "sharded" else
              opt.shards if mode == "fsdp" else [])
    held = {}
    zero_grad = opt.zero_grad

    def measured(set_to_none=True):
        grads = [p.grad for p in list(model.parameters()) + list(shards)
                 if p.grad is not None]
        params = (list(shards) if mode == "fsdp" else
                  list(model.parameters()) + list(shards))
        held.update(params=_nbytes(params), grads=_nbytes(grads),
                    opt_state=_nbytes(
                        v for st in opt._opt.state.values()
                        for v in st.values() if torch.is_tensor(v)))
        zero_grad(set_to_none=set_to_none)

    object.__setattr__(opt, "zero_grad", measured)
    step = hvd.make_train_step(model, _loss, opt)
    step(_batch(cfg, seed))
    fp = memory.footprint_of(opt, model.parameters())
    noted = memory.get_observatory().measured_resident()
    opt.remove_hooks()
    return fp, held, noted


@pytest.mark.parametrize("inner", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("mode", ["allreduce", "sharded", "fsdp"])
def test_footprint_of_is_what_torch_holds(mode, inner):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        fp, held, noted = _held_after_one_step(hvd, mode, inner, 0)
    finally:
        hvd.shutdown()
    assert fp["opt_exact"] and fp["sync_mode"] == mode
    assert {**fp["resident"], "grads": fp["transient"]["grads"]} == held
    assert fp["resident_total"] + fp["transient"]["grads"] == sum(
        held.values())
    # The optimizer noted what it holds at rest.
    assert noted["params"] == held["params"]
    assert noted["opt_state"] == held["opt_state"]
    # Every state tensor counts on a CPU world's device, the host scalars
    # too.
    assert fp["opt_state_host"] == 0
    # At rest (make_train_step drops the gradients) they are transient.
    model, _ = _bert()
    opt = torch.optim.AdamW(model.parameters())
    rest = pmem.footprint_of(opt, world_size=1)
    assert "grads" not in rest["resident"]
    assert rest["transient"]["grads"] == _nbytes(model.parameters())
    assert rest["peak_total"] == rest["resident_total"] + max(
        v for k, v in rest["transient"].items() if k != "grads") + \
        rest["transient"]["grads"]


def test_opt_state_templates_keep_the_step_scalars_on_the_host():
    model, _ = _bert()
    params = list(model.parameters())
    opt = torch.optim.AdamW(params)
    shapes = [tuple(p.shape) for p in params]
    dtypes = [p.dtype for p in params]
    groups = [(list(range(len(params))), {k: v for k, v in
                                          opt.param_groups[0].items()
                                          if k != "params"})]
    on_device, on_host = pmem.opt_state_templates(opt, shapes, dtypes,
                                                  groups)
    assert len(on_host) == len(params)  # one float32 step per parameter
    assert all(leaf == (1, 4, "float32") for leaf in on_host)
    assert sum(s * i for s, i, _ in on_device) == 2 * _nbytes(params)
    sgd = torch.optim.SGD(params, lr=0.1)  # no momentum: no state
    assert pmem.opt_state_templates(sgd, shapes, dtypes, groups) == ([], [])


def _footprint_worker(rank, init_file, queue):
    os.environ.update(HOROVOD_NUM_PROCESSES="3",
                      HOROVOD_PROCESS_ID=str(rank), HOROVOD_RANK=str(rank))
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    out = {}
    for mode in ("allreduce", "sharded", "fsdp"):
        for inner in ("sgd", "adamw"):
            fp, held, _ = _held_after_one_step(hvd, mode, inner, 1)
            out[(mode, inner)] = (
                {**fp["resident"], "grads": fp["transient"]["grads"]}, held)
    queue.put((rank, out))
    hvd.shutdown()


def test_footprint_of_on_three_ranks_prices_uneven_shards(tmp_path):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_footprint_worker,
                         args=(r, str(tmp_path / "init"), queue))
             for r in range(3)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=240) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    for rank, out in got.items():
        for key, (resident, held) in out.items():
            assert resident == held, (rank, key)
    # Rank 2's shards are as long as rank 0's (padded rows).
    assert got[0] == got[2]


# -- live accounting ----------------------------------------------------------


def test_shard_params_and_the_sharded_optimizers_note_resident_bytes():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import memory

    model, _ = _bert()
    params = dict(model.named_parameters())
    hvd.shard_params(params, world_size=3)
    obs = memory.get_observatory()
    want = sum(pmem.ceil_shard(p.numel(), 3) * p.element_size()
               for p in params.values())
    assert obs.measured_resident()["params"] == want
    top = obs.top_leaves()
    assert top[0]["kind"] == "params" and top[0]["leaf"] in params
    full = _nbytes(params.values())
    hvd.init(device="cpu")
    try:
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1),
                                       sync_mode="sharded")
        # Full parameters and this rank's shard copies (the whole, here).
        assert obs.measured_resident()["params"] == 2 * full
        opt.remove_hooks()
        model2, _ = _bert()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model2.parameters(), lr=0.1), sync_mode="fsdp",
            named_parameters=model2.named_parameters())
        assert obs.measured_resident()["params"] == full
        assert obs.top_leaves()[0]["leaf"].endswith("(shard)")
    finally:
        hvd.shutdown()


def test_torch_state_and_the_replica_pool_are_measured():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import memory, peercheck

    model, _ = _bert()
    hvd.init(device="cpu")
    try:
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        hvd.elastic.TorchState(model=model, optimizer=opt, epoch=0)
        resident = memory.get_observatory().measured_resident()
        assert resident["params"] == _nbytes(model.parameters())
        assert resident["opt_state"] == 0  # no step yet
        pool = peercheck.ReplicaPool()
        assert memory.get_observatory().measured_resident()[
            "peer_pool"] == pool.nbytes() == 0
    finally:
        hvd.shutdown()


def test_watermarks_come_from_the_ports_tracer():
    from horovod_tpu_torch import memory, tracing

    tracing.reset_for_testing()
    memory.note_resident("params", 1000)
    tracer = tracing.get_tracer()
    with tracer.step_scope("train_step"):
        with tracing.span("forward_backward"):
            memory.note_resident("opt_state", 500)
        token = tracer.begin_span("allreduce", "collective")
        tracer.end_span(token, {"bytes": 4})
        with tracing.span("optimizer_update"):
            pass
        with tracing.span("embedding", "phase"):
            pass
    marks = memory.get_observatory().watermarks()
    assert marks == {"forward_backward": 1500, "collective": 1500,
                     "optimizer_update": 1500, "other": 1500, "step": 1500}
    assert memory.get_observatory().peak_bytes() == 1500
    # A CPU world has no allocator to read.
    assert memory.device_memory_stats() is None
    tracing.reset_for_testing()


def test_oom_at_the_step_boundary_dumps_the_memory_record(tmp_path,
                                                          monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults, metrics, tracing

    assert pmem.is_oom_error(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert not pmem.is_oom_error(RuntimeError("room for doom"))
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("HOROVOD_EVENT_LOG", str(log))
    metrics.reset_for_testing()
    tracing.reset_for_testing()
    model, cfg = _bert()
    hvd.init(device="cpu")
    try:
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        step = hvd.make_train_step(model, _loss, opt)
        step(_batch(cfg, 0))
        faults.inject(faults.MEMORY_PRESSURE, "drop", at=1, count=1)
        with pytest.raises(torch.cuda.OutOfMemoryError,
                           match="memory.pressure"):
            step(_batch(cfg, 1))
        step(_batch(cfg, 2))  # the next step runs
        opt.remove_hooks()
    finally:
        faults.reset()
        hvd.shutdown()
        metrics.reset_for_testing()
    records = [json.loads(line) for line in log.read_text().splitlines()]
    oom = [r for r in records if r.get("event") == "flight_record"
           and r.get("reason") == "oom"]
    assert len(oom) == 1
    rec = oom[0]
    assert rec["memory"]["resident"]["params"] == _nbytes(
        model.parameters())
    assert rec["memory_top_leaves"][0]["leaf"] in dict(
        model.named_parameters())
    assert "injected memory pressure" in rec["error"]
    assert rec["step"] == "train_step"


# -- merges and the autotune and admission guards -----------------------------


def _payload(rank, host, seed):
    rng = np.random.RandomState(seed + rank)
    return {
        "rank": str(rank % 2), "host": host, "t": 0.0, "status": "ok",
        "resident": {"params": int(rng.randint(1, 1 << 30)),
                     "opt_state": int(rng.randint(1, 1 << 30)),
                     "peer_pool": float(rng.randint(0, 100))},
        "resident_total": 0,
        "watermarks": {"step": int(rng.randint(1, 1 << 31)),
                       "forward_backward": int(rng.randint(1, 1 << 31))},
        "peak_bytes": int(rng.randint(1, 1 << 31)),
        "headroom_ratio": float(rng.uniform(0, 1)),
        "residual_bytes": int(rng.randint(-1000, 1000)),
        "capacity_bytes": 80 << 30,
    }


@pytest.mark.parametrize("seed", range(3))
def test_merge_payloads_is_the_references(seed):
    payloads = {f"h{r}:0": _payload(r, f"h{r}", seed) for r in range(4)}
    payloads["bad:0"] = ["not", "a", "dict"]
    payloads["bad:1"] = {"rank": "7", "resident": {"params": "x"},
                         "watermarks": {"step": float("nan")},
                         "headroom_ratio": float("inf"),
                         "residual_bytes": "z", "peak_bytes": float("inf")}
    assert pmem.merge_payloads(payloads) == jmem.merge_payloads(payloads)
    assert pmem.merge_payloads({}) == jmem.merge_payloads({})


def _layout(seed):
    return _descriptors(seed)


@pytest.mark.parametrize("capacity", [None, 1 << 10, 1 << 20, 1 << 40])
def test_autotune_guard_is_the_references(capacity, monkeypatch):
    from horovod_tpu_torch.exceptions import MemoryBudgetExceededError

    layout = _layout(4)
    pmem.get_observatory().note_layout(layout)
    jmem.get_observatory().note_layout(layout)
    candidates = [1 << 20, (1 << 20, 4, "sharded"), (1 << 20, 2, "fsdp"),
                  (8 << 20, 1, "fsdp", "two_level")]
    monkeypatch.setenv("HOROVOD_SIZE", "4")
    for armed in (False, True):
        if armed:
            monkeypatch.setenv("HOROVOD_AUTOTUNE_MEMORY_GUARD", "1")
        if capacity is not None:
            monkeypatch.setenv("HOROVOD_HBM_BYTES_PER_DEVICE", str(capacity))
        assert pmem.filter_candidates(candidates) == \
            jmem.filter_candidates(candidates)
        for mode, segments in (("allreduce", 1), ("sharded", 1),
                               ("fsdp", 4)):
            assert pmem.candidate_footprint_bytes(mode, segments) == \
                jmem.candidate_footprint_bytes(mode, segments)
            outcome = []
            for mod in (pmem, jmem):
                try:
                    mod.check_candidate(mode, num_segments=segments)
                    outcome.append(None)
                except Exception as e:  # noqa: BLE001
                    outcome.append(type(e).__name__)
            assert outcome[0] == outcome[1]
            if outcome[0] is not None:
                with pytest.raises(MemoryBudgetExceededError):
                    pmem.check_candidate(mode, num_segments=segments)


@pytest.mark.parametrize("predicted,capacity", [
    (None, 10), (10, None), (0, 10), (10, 10), (11, 10), (5 << 30, 1 << 30),
    ("x", 3), (-4, 3)])
def test_admission_check_is_the_references(predicted, capacity):
    assert pmem.admission_check(predicted, capacity) == \
        jmem.admission_check(predicted, capacity)


# -- the rendezvous server's /comms and /memory -------------------------------


@pytest.fixture
def servers(monkeypatch):
    from horovod_tpu.runner.http import kv_server as jkv
    from horovod_tpu_torch.runner.http import kv_server as pkv

    monkeypatch.delenv("HOROVOD_SECRET_KEY", raising=False)
    monkeypatch.delenv("HOROVOD_JOB_ID", raising=False)
    js, ps = jkv.RendezvousServer("127.0.0.1"), pkv.RendezvousServer(
        "127.0.0.1")
    js.start()
    ps.start()
    yield pkv, js, ps
    js.stop()
    ps.stop()


def _get(server, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{route}",
                                timeout=10) as r:
        assert r.status == 200
        return json.loads(r.read())


def test_comms_and_memory_routes_serve_the_heartbeats(servers):
    from horovod_tpu_torch import comms_model

    pkv, js, ps = servers
    for route in ("/comms", "/memory"):
        assert _get(ps, route) == _get(js, route)
        assert _get(ps, route)["status"] == "insufficient_samples"
    bodies = {}
    for r in range(2):
        m = comms_model.CommsModel()
        for size in (4096, 1 << 20, 1 << 24):
            for _ in range(2):
                m.observe("allreduce", "flat", "intra_host", size,
                          1e-5 + size * 1e-11 * (1 + r))
        payload = dict(m.payload(), rank=str(r))
        bodies[f"localhost:{r}"] = {
            "steps": 1, "commits": 0, "rank": str(r), "comms": payload,
            "memory": _payload(r, "localhost", 9)}
    bodies["localhost:2"] = {"steps": 1, "rank": "2", "comms": "junk"}
    for server in (js, ps):
        for name, body in bodies.items():
            pkv.KVClient("127.0.0.1", server.port).put(
                "heartbeat", name, json.dumps(body).encode())
    comms, memory_body = _get(ps, "/comms"), _get(ps, "/memory")
    assert comms == _get(js, "/comms") == ps.comms_summary()
    assert memory_body == _get(js, "/memory") == ps.memory_summary()
    assert comms["status"] == "ok" and set(comms["ranks"]) == {"0", "1"}
    assert "allreduce|flat|intra_host" in comms["cluster"]
    assert memory_body["status"] == "ok"
    assert comms["generation"] == memory_body["generation"] == 0
    # The bodies carry the world's generation.
    ps.publish_epoch("world", {})
    assert _get(ps, "/comms")["generation"] == 1
    assert _get(ps, "/memory")["generation"] == 1


def test_comms_and_memory_import_without_torch_or_jax():
    code = ("import sys\n"
            "import horovod_tpu_torch.comms_model, horovod_tpu_torch.memory\n"
            "import horovod_tpu_torch.topology\n"
            "import horovod_tpu_torch.runner.http.kv_server\n"
            "bad = [m for m in ('torch', 'jax', 'horovod_tpu') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n"
            "print('CLEAN')\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = REPO_ROOT
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout
