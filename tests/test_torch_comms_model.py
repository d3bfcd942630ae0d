"""The port's communication observatory (``horovod_tpu_torch/comms_model.py``)
held to the JAX package's (``horovod_tpu/comms_model.py``).

The same sample streams, made from a seed with numpy, go to both packages'
``LinkFit`` and ``CommsModel``: fits, readiness, predictions and confidence
intervals agree within 1e-12, under the link-class map ``ici ->
intra_host``, ``dcn -> inter_host``. The cluster merge, the span ingest, the
fusion mirrors, the flush pricing and the autotune pruning agree too. A
2-rank gloo world runs ``run_comms_microprobe`` and its samples reach the
model; the attribution plane prices the exposed comm once the model is
ready.
"""

import contextlib
import math
import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

from horovod_tpu import comms_model as jcm
from horovod_tpu_torch import comms_model as pcm

TO_PORT = {"ici": "intra_host", "dcn": "inter_host"}
TIME_KEYS = ("t", "t_last")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for key in ("HOROVOD_COMMS_DECAY", "HOROVOD_COMMS_MIN_SAMPLES",
                "HOROVOD_COMMS_RESIDUAL_ALPHA", "HOROVOD_SYNC_MODE",
                "HOROVOD_FUSION_THRESHOLD", "HOROVOD_FSDP_SEGMENTS",
                "HOROVOD_AUTOTUNE_PRUNE_MARGIN", "HOROVOD_FAULTS"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.delenv("HOROVOD_COMMS_PLANNER", raising=False)
    from horovod_tpu.ops import comms_planner as jcp
    from horovod_tpu_torch.ops import comms_planner as pcp

    for mod in (jcm, pcm, jcp, pcp):
        mod.reset_for_testing()
    yield
    for mod in (jcm, pcm, jcp, pcp):
        mod.reset_for_testing()


def _close(got, want, path="$"):
    """Equal structures, floats within 1e-12 (relative above 1)."""
    if isinstance(want, float) and isinstance(got, (int, float)):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=1e-12), (
            path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(got), sorted(want))
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


@contextlib.contextmanager
def _steady_clock():
    """``CommsModel.observe`` folds a delay of 1 ms or more around its fault
    point into the sample (an injected slow link). On a loaded machine a
    preempted clock read can pass that mark in one package's model and not
    the other's, so samples fed to both are fed on a stopped monotonic
    clock."""
    real = time.monotonic
    time.monotonic = lambda: 0.0
    try:
        yield
    finally:
        time.monotonic = real


def _untimed(d):
    if isinstance(d, dict):
        return {k: _untimed(v) for k, v in d.items() if k not in TIME_KEYS}
    return d


def _stream(seed, n=40):
    """(nbytes, seconds) samples of a noisy alpha-beta line, with NaN,
    inf and negative samples mixed in."""
    rng = np.random.RandomState(seed)
    alpha, beta = rng.uniform(1e-6, 1e-4), rng.uniform(1e-11, 1e-9)
    sizes = rng.choice([4096, 65536, 1 << 20, 1 << 24, 1 << 27], size=n)
    out = []
    for s in sizes:
        t = alpha + beta * s + rng.normal(0, alpha * 0.1)
        out.append((float(s), float(max(t, 0.0))))
    out[3] = (1024.0, float("nan"))
    out[7] = (2048.0, float("inf"))
    out[11] = (4096.0, -1.0)
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("decay,min_samples", [(None, None), ("0.9", "6"),
                                               ("1.0", "2")])
def test_linkfit_matches(seed, decay, min_samples, monkeypatch):
    if decay is not None:
        monkeypatch.setenv("HOROVOD_COMMS_DECAY", decay)
        monkeypatch.setenv("HOROVOD_COMMS_MIN_SAMPLES", min_samples)
    jf, pf = jcm.LinkFit(), pcm.LinkFit()
    for i, (x, y) in enumerate(_stream(seed)):
        jf.observe(x, y)
        pf.observe(x, y)
        assert pf.ready() == jf.ready()
        _close(pf.solved(), jf.solved())
        for size in (0, 4096, 1 << 20, 1 << 28):
            _close(pf.predict(size), jf.predict(size))
        if i % 5 == 0:
            _close(_untimed(pf.as_dict()), _untimed(jf.as_dict()))
    d = pf.as_dict()
    assert d["ready"] and d["alpha_ci95_s"] is not None
    _close(_untimed(d), _untimed(jf.as_dict()))


def _feed(model, seed, classes):
    """The same keyed samples into a model, under ``classes`` (the
    reference's names or the port's)."""
    ici, dcn = classes
    keys = [("allreduce", "flat", ici), ("allreduce", "flat", dcn),
            ("reducescatter", "rs_ag", ici), ("allgather", "fsdp", ici),
            ("alltoall", "flat", dcn)]
    with _steady_clock():
        for k, key in enumerate(keys):
            for x, y in _stream(seed * 10 + k, n=12 + 3 * k):
                model.observe(*key, x, y)
    model.note_leaf_sizes([(4 << 20, "float32"), (1 << 20, "bfloat16")])
    model.note_probe()


def _to_port_key(key):
    op, algorithm, link = key.split("|")
    return f"{op}|{algorithm}|{TO_PORT.get(link, link)}"


def _port_payload(p):
    p = _untimed(p)
    p["fits"] = {_to_port_key(k): v for k, v in p["fits"].items()}
    return p


@pytest.mark.parametrize("seed", range(3))
def test_comms_model_matches(seed):
    jm, pm = jcm.CommsModel(), pcm.CommsModel()
    _feed(jm, seed, ("ici", "dcn"))
    _feed(pm, seed, ("intra_host", "inter_host"))
    assert pm.ready() == jm.ready()
    _close(pm.residual_s(), jm.residual_s())
    _close(pm.efficiency(), jm.efficiency())
    for op in ("allreduce", "reducescatter", "allgather", "alltoall",
               "broadcast"):
        for algo in ("flat", "rs_ag", "fsdp", "two_level"):
            for link in ("ici", "dcn"):
                for size in (1024, 1 << 22):
                    _close(pm.predict(op, algo, TO_PORT[link], size),
                           jm.predict(op, algo, link, size))
                    _close(pm.predict_exact(op, algo, TO_PORT[link], size),
                           jm.predict_exact(op, algo, link, size))
    _close({_to_port_key(k): v for k, v in pm.fit_snapshot().items()},
           {_to_port_key(k): v for k, v in jm.fit_snapshot().items()})
    _close(_untimed(pm.payload()), _port_payload(jm.payload()))
    want = _untimed(jm.summary())
    want["fits"] = {_to_port_key(k): v for k, v in want["fits"].items()}
    _close(_untimed(pm.summary()), want)


@pytest.mark.parametrize("seed", range(3))
def test_microprobe_driver_matches(seed):
    rng = np.random.RandomState(seed)
    times = rng.uniform(1e-5, 1e-3, size=64).tolist()

    def measure_from(it):
        return lambda nbytes: next(it) + nbytes * 1e-10

    jm, pm = jcm.CommsModel(), pcm.CommsModel()
    with _steady_clock():
        want = jcm.microprobe(measure_from(iter(times)), "allreduce",
                              sizes=(4096, 1 << 20, 1 << 24), model=jm)
        got = pcm.microprobe(measure_from(iter(times)), "allreduce",
                             sizes=(4096, 1 << 20, 1 << 24), model=pm)
    assert got == want
    _close(_untimed(pm.payload()), _port_payload(jm.payload()))
    assert list(pm.payload()["fits"]) == ["allreduce|flat|intra_host"]


def _payloads(seed):
    """Per-worker payloads of several models, and malformed ones."""
    out = {}
    for r in range(3):
        m = pcm.CommsModel()
        _feed(m, seed + r, ("intra_host", "inter_host"))
        p = m.payload()
        p["rank"] = str(r % 2)  # a colliding label
        p["host"] = f"host{r}"
        out[f"host{r}:0"] = p
    out["bad:0"] = "not a dict"
    out["bad:1"] = {"rank": "9", "fits": {"x|y": {}, "a|b|c": 3},
                    "residual_s": float("nan"), "efficiency": float("inf"),
                    "samples_total": float("inf")}
    out["bad:2"] = {"rank": "8", "fits": {"allreduce|flat|intra_host": {
        "ready": True, "alpha_s": float("inf"), "beta_s_per_byte": 1e-9}}}
    return out


@pytest.mark.parametrize("seed", range(3))
def test_merge_payloads_matches(seed):
    payloads = _payloads(seed)
    got, want = pcm.merge_payloads(payloads), jcm.merge_payloads(payloads)
    _close(got, want)
    assert got["status"] == "ok" and len(got["ranks"]) == 5
    assert pcm.merge_payloads({}) == jcm.merge_payloads({})


def _span_records(seed):
    rng = np.random.RandomState(seed)
    spans = []
    for i in range(30):
        kind = rng.randint(4)
        dur = float(rng.uniform(1e-5, 1e-2))
        if kind == 0:
            nbytes = rng.randint(1, 1 << 24)
            spans.append({"name": f"allreduce.bucket{i}.{nbytes}B",
                          "cat": "collective", "dur": dur})
        elif kind == 1:
            spans.append({"name": "allgather", "cat": "collective",
                          "dur": dur, "args": {
                              "bytes": int(rng.randint(1, 1 << 20)),
                              "op": "allgather", "algorithm": "flat",
                              "link_class": "inter_host"}})
        elif kind == 2:
            spans.append({"name": "moe.dispatch.4224B.two_level",
                          "cat": "collective", "dur": dur})
        else:
            spans.append({"name": "forward_backward", "cat": "phase",
                          "dur": dur})
    spans.append({"name": "allreduce.12B", "cat": "collective",
                  "dur": float("nan")})
    spans.append("junk")
    return [{"spans": spans[:15]}, {"spans": spans[15:]}, "junk"]


@pytest.mark.parametrize("seed", range(3))
def test_ingest_steps_folds_the_same_samples(seed):
    jm, pm = jcm.CommsModel(), pcm.CommsModel()
    records = _span_records(seed)
    with _steady_clock():
        assert pm.ingest_steps(records) == jm.ingest_steps(records) > 0
    _close(_untimed(pm.payload()), _port_payload(jm.payload()))


def _bert_large_layout():
    from horovod_tpu_torch.models import bert

    with torch.device("meta"):
        model = bert.Bert(bert.BERT_LARGE)
    return [(p.numel(), p.dtype) for p in model.parameters()]


def _random_layout(seed):
    rng = np.random.RandomState(seed)
    dtypes = [torch.float32, torch.bfloat16, torch.float16]
    return [(int(rng.randint(1, 1 << 20)),
             dtypes[rng.randint(3)] if rng.rand() < 0.2 else torch.float32)
            for _ in range(rng.randint(1, 60))]


LAYOUTS = ["bert_large", 0, 1, 2, 3]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fusion_mirrors_match_the_ports_fusion(layout):
    import jax

    from horovod_tpu.ops import fusion as jfusion
    from horovod_tpu_torch import memory
    from horovod_tpu_torch.ops import fusion

    leaves = (_bert_large_layout() if layout == "bert_large"
              else _random_layout(layout))
    sizes = [(m * d.itemsize, memory.dtype_name(d)) for m, d in leaves]
    structs = [jax.ShapeDtypeStruct((m,), memory.dtype_name(d))
               for m, d in leaves]
    for threshold in (0, 1, 64 << 10, 4 << 20, 64 << 20):
        want = [sum(sizes[i][0] for i in b)
                for b in fusion.bucket_leaves(leaves, threshold)]
        assert pcm.bucket_byte_sizes(sizes, threshold) == want
        assert jcm.bucket_byte_sizes(sizes, threshold) == want
        assert [sum(sizes[i][0] for i in b) for b in
                jfusion.bucket_leaves(structs, threshold)] == want
    for k in (1, 2, 4, 7, 100):
        want = [[sizes[i] for i in run]
                for run in fusion.segment_leaves(leaves, k)]
        assert pcm.segment_byte_runs(sizes, k) == want
        assert jcm.segment_byte_runs(sizes, k) == want


def _fitted_pair(seed):
    jm, pm = jcm.CommsModel(), pcm.CommsModel()
    _feed(jm, seed, ("ici", "dcn"))
    _feed(pm, seed, ("intra_host", "inter_host"))
    return jm, pm


@pytest.mark.parametrize("sync_mode", ["allreduce", "sharded", "fsdp",
                                       "unknown"])
@pytest.mark.parametrize("link", ["ici", "dcn"])
def test_flush_and_step_pricing_match(sync_mode, link, monkeypatch):
    from horovod_tpu_torch import memory

    jm, pm = _fitted_pair(7)
    layout = [(m * d.itemsize, memory.dtype_name(d))
              for m, d in _bert_large_layout()]
    for threshold in (0, 1 << 20, 64 << 20):
        for segments in (1, 4):
            for algorithm in (None, "auto", "flat", "two_level"):
                _close(pcm.predict_flush_cost(layout, threshold, segments,
                                              sync_mode, TO_PORT[link],
                                              model=pm, algorithm=algorithm),
                       jcm.predict_flush_cost(layout, threshold, segments,
                                              sync_mode, link, model=jm,
                                              algorithm=algorithm))
    jm.note_leaf_sizes(layout)
    pm.note_leaf_sizes(layout)
    for segments in (1, 4):
        _close(pcm.predict_step_comm_s(sync_mode, TO_PORT[link], 8 << 20,
                                       segments, model=pm),
               jcm.predict_step_comm_s(sync_mode, link, 8 << 20, segments,
                                       model=jm))
    # Unspecified axes resolve as the port's wire: one run of buckets in
    # the allreduce and sharded modes, HOROVOD_FSDP_SEGMENTS in fsdp.
    monkeypatch.setenv("HOROVOD_FSDP_SEGMENTS", "3")
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(4 << 20))
    monkeypatch.setenv("HOROVOD_SYNC_MODE", sync_mode)
    segments = 3 if sync_mode == "fsdp" else 1
    _close(pcm.predict_step_comm_s(link_class=TO_PORT[link], model=pm),
           jcm.predict_step_comm_s(None, link, 4 << 20, segments, model=jm))
    assert pcm.predict_step_comm_s(model=pcm.CommsModel()) is None


CANDIDATES = [1 << 20, 64 << 20, (4 << 20, 2), (4 << 20, 4, "sharded"),
              (64 << 20, 1, "fsdp"), (1 << 10,), (256 << 20, "allreduce"),
              (16 << 20, 2, "sharded", "two_level"), (16 << 20, "auto"),
              [8 << 20, 3, "fsdp", "flat"], (0, 1)]


@pytest.mark.parametrize("margin", [None, 1.0, 1.5, 3.0])
def test_prune_candidates_and_axes_match(margin):
    from horovod_tpu_torch import memory

    jm, pm = _fitted_pair(3)
    layout = [(m * d.itemsize, memory.dtype_name(d))
              for m, d in _random_layout(5)]
    for cand in CANDIDATES:
        assert pcm.candidate_axes(cand) == jcm.candidate_axes(cand)
    for link in ("ici", "dcn"):
        got = pcm.prune_candidates(CANDIDATES, layout, TO_PORT[link],
                                   margin=margin, model=pm)
        want = jcm.prune_candidates(CANDIDATES, layout, link, margin=margin,
                                    model=jm)
        _close(got, want)
    assert pcm.prune_candidates(CANDIDATES, [], model=pm)["pruned"] == []
    cold = pcm.prune_candidates(CANDIDATES, layout, model=pcm.CommsModel())
    assert cold["kept"] == CANDIDATES and cold["costs"] == [None] * len(
        CANDIDATES)


def test_comms_link_fault_inflates_or_drops_samples(monkeypatch):
    from horovod_tpu_torch import faults

    faults.reset()
    m = pcm.CommsModel()
    faults.inject(faults.COMMS_LINK, "drop", at=1, count=1)
    m.observe("allreduce", "flat", "intra_host", 4096, 1e-4)
    assert m.payload()["samples_total"] == 0
    faults.inject(faults.COMMS_LINK, "delay", at=1, count=1, arg=0.01)
    m.observe("allreduce", "flat", "intra_host", 4096, 1e-4)
    fit = m.payload()["fits"]["allreduce|flat|intra_host"]
    assert fit["samples"] == 1 and fit["alpha_s"] > 0.005
    faults.reset()


# -- a 2-rank gloo world ------------------------------------------------------


def _probe_worker(rank, init_file, queue):
    os.environ.update(HOROVOD_NUM_PROCESSES="2",
                      HOROVOD_PROCESS_ID=str(rank), HOROVOD_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE="2")
    for key in ("HOROVOD_LINK_CLASS_MAP", "HOROVOD_CROSS_RANK",
                "HOROVOD_COMMS_MIN_SAMPLES", "HOROVOD_COMMS_DECAY"):
        os.environ.pop(key, None)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import attribution, comms_model

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    out = hvd.run_comms_microprobe(sizes=(4096, 65536, 1 << 20), repeats=2)
    payload = comms_model.get_model().payload()
    no_layout = attribution.predicted_exposed_comm_s()
    # A bucket plan notes the wire's layout: the attribution plane then
    # prices the step's exposed comm.
    hvd.grouped_allreduce([torch.ones(1000), torch.ones(300)])
    predicted = attribution.predicted_exposed_comm_s()
    want = comms_model.predict_flush_cost(
        [(4000, "float32"), (1200, "float32")], 64 << 20, 1, "allreduce",
        "intra_host")
    queue.put(dict(rank=rank, out=out, payload=payload, no_layout=no_layout,
                   predicted=predicted, want=want,
                   summary=attribution.summary()))
    hvd.shutdown()


def test_microprobe_over_two_gloo_ranks_feeds_the_model(tmp_path):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_probe_worker,
                         args=(r, str(tmp_path / "init"), queue))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    for _ in procs:
        r = queue.get(timeout=180)
        got[r["rank"]] = r
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    for rank, r in got.items():
        assert set(r["out"]) == {"allreduce", "reducescatter", "allgather",
                                 "alltoall"}
        for per_op in r["out"].values():
            # The set's total payload: 2 ranks' rows of float32.
            assert sorted(per_op) == [2 * 4096, 2 * 65536, 2 * (1 << 20)]
            assert all(len(v) == 2 and min(v) > 0 for v in per_op.values())
        p = r["payload"]
        assert p["rank"] == str(rank) and p["probes"] == 1
        for op in ("allreduce", "reducescatter", "allgather", "alltoall"):
            fit = p["fits"][f"{op}|flat|intra_host"]
            # Two timed calls a size, the warm-up calls left out.
            assert fit["samples"] == 6 and fit["ready"], (op, fit)
        assert p["status"] == "ok"
        assert r["no_layout"] is None
        assert r["predicted"] is not None and r["predicted"] > 0
        assert r["predicted"] == pytest.approx(r["want"], rel=1e-12)
        assert r["summary"]["exposed_comm_predicted_s"] == round(
            r["predicted"], 6)
