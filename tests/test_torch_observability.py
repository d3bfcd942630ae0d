"""The port's observability plane held to the JAX package's: metrics,
tracing, timeline, stall inspector, profiler and step attribution, and the
cluster scrape on the rendezvous server.

Same instrument operations render the same Prometheus text and snapshots;
the attribution math and the skew agree within 1e-12 relative on seeded
span payloads; trace payloads and heartbeat bodies merge in either
package's rendezvous server with the same results. Then the port's own
contracts: a timeline loadable after SIGKILL, the journal's rotation, the
stall inspector's warning, shutdown and deadman exit, the launcher's
flags, a 2-rank BERT whose parameters do not move when every plane is on,
and an elastic gloo run scraped while it trains and journaled through a
recovery.
"""

import dataclasses
import json
import math
import multiprocessing as mp
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-12


def _close(a, b, path="$"):
    """Structural equality, floats within ``REL`` relative."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), (path, a, b)
        else:
            assert abs(a - b) <= REL * max(abs(a), abs(b), 1e-300), \
                (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


# -- metrics ------------------------------------------------------------------


@pytest.fixture
def both_metrics():
    from horovod_tpu import metrics as jm
    from horovod_tpu_torch import metrics as pm

    jm.reset_for_testing()
    pm.reset_for_testing()
    yield jm, pm
    jm.reset_for_testing()
    pm.reset_for_testing()


def _drive(m, seed):
    """The same instrument operations, from ``seed``."""
    rng = np.random.RandomState(seed)
    for kind in ("allreduce", "allgather", "broadcast", "alltoall",
                 "reducescatter", "barrier"):
        for _ in range(rng.randint(1, 6)):
            m.COLLECTIVE_DISPATCH.inc(kind=kind)
            m.COLLECTIVE_LATENCY.observe(float(rng.exponential(0.02)),
                                         kind=kind)
            m.COLLECTIVE_BYTES.observe(int(rng.randint(1, 1 << 31)),
                                       kind=kind)
    for mode in ("allreduce", "sharded", "fsdp"):
        m.GRAD_SYNC_FLUSHES.inc(sync_mode=mode)
        m.GRAD_SYNC_BYTES.observe(int(rng.randint(1, 1 << 30)),
                                  sync_mode=mode)
        m.GRAD_SYNC_BUCKETS.observe(int(rng.randint(1, 200)), sync_mode=mode)
    m.ALLTOALL_LATENCY.observe(float(rng.exponential(0.01)),
                               algorithm="flat")
    m.OVERLAP_SEGMENTS.set(int(rng.randint(1, 8)))
    m.STALL_TICKETS.inc(int(rng.randint(1, 50)))
    m.STALL_OUTSTANDING.set(int(rng.randint(0, 3)))
    m.STALL_WARNINGS.inc(int(rng.randint(0, 3)))
    m.ABORT_POSTS.inc()
    m.ABORT_CONSUMES.inc()
    m.RETRIES.inc(int(rng.randint(0, 9)))
    for rung in ("restore", "rendezvous", "peer", "durable"):
        m.RECOVERIES.inc(int(rng.randint(0, 3)), rung=rung)
    m.TRACE_SHIPS.inc(int(rng.randint(0, 20)))
    m.FLIGHT_DUMPS.inc(reason="abort_consumed")
    m.CLOCK_OFFSET.set(float(rng.randn() * 1e-3))
    m.CLOCK_ERROR.set(float(rng.exponential(1e-4)))
    for kind in ("save", "restore"):
        m.CHECKPOINT_SECONDS.observe(float(rng.exponential(2.0)), kind=kind,
                                     rung="durable")
    m.CHECKPOINT_SECONDS.observe(float(rng.exponential(0.5)), kind="save",
                                 rung="peer")
    m.PEER_REPLICATION_BYTES.observe(int(rng.randint(1, 1 << 30)))
    m.PEER_REPLICATION_SECONDS.observe(float(rng.exponential(0.1)))
    m.PEER_POOL_REPLICAS.set(int(rng.randint(0, 4)))
    m.PARAM_GATHER_BYTES.observe(int(rng.randint(1, 1 << 28)), axis="batch")
    m.RESIDENT_BYTES.set(int(rng.randint(1, 1 << 32)), kind="opt_state",
                         sync_mode="sharded")
    m.DRIVER_EPOCH.set(int(rng.randint(0, 5)))
    m.DRIVER_LOST.inc(host="localhost:1")
    m.DRIVER_TAKEOVERS.inc()
    for phase in ("compute", "exposed_comm", "straggler_wait", "overhead"):
        m.STEP_PHASE_SECONDS.set(float(rng.uniform(0, 0.2)), phase=phase)
        m.STEP_REGRESSION_SCORE.set(float(rng.uniform(0, 9)), phase=phase)
    m.EXPOSED_COMM.set(float(rng.uniform(0, 0.1)))
    m.OVERLAP_HIDDEN.set(float(rng.uniform(0, 1)))
    m.MFU_RATIO.set(float(rng.uniform(0, 1)))
    # Label values that need escaping.
    m.counter("hvd_test_escaping_total", "A test family: \\ and\nnewline.",
              ("value",)).inc(value='a"b\\c\nd')
    g = m.goodput()
    g.add_productive(float(rng.uniform(1, 100)))
    for cause in g.CAUSES:
        g.add_lost(cause, float(rng.uniform(0, 5)))


# The JAX package's link classes and the port's (topology.py): the comms
# families' zero cells carry them.
_PORT_LINK_CLASSES = {"ici": "intra_host", "dcn": "inter_host"}


def _port_classes(snapshot):
    """A snapshot of the JAX module with its link-class labels renamed to
    the port's."""
    out = []
    for fam in snapshot:
        fam = dict(fam)
        fam["samples"] = [
            dict(s, labels={k: _PORT_LINK_CLASSES.get(v, v)
                            if k == "link_class" else v
                            for k, v in s["labels"].items()})
            for s in fam["samples"]]
        out.append(fam)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_instrument_operations_render_the_same(both_metrics, seed):
    jm, pm = both_metrics
    _drive(jm, seed)
    _drive(pm, seed)
    assert pm.snapshot() == _port_classes(jm.snapshot())
    labels = {"rank": "3", "host": "gpu-7:3"}
    text = pm.render(labels)
    want = jm.render(labels)
    for jax_class, port_class in _PORT_LINK_CLASSES.items():
        want = want.replace(f'link_class="{jax_class}"',
                            f'link_class="{port_class}"')
    assert text == want
    parsed = jm.validate_prometheus_text(text)
    assert parsed == pm.validate_prometheus_text(text)
    assert parsed["hvd_collective_dispatch_total"]["samples"]
    assert pm.goodput().summary() == jm.goodput().summary()
    assert pm.checkpoint_summary() == jm.checkpoint_summary()
    assert pm.fsdp_summary() == jm.fsdp_summary()


def test_every_family_of_the_jax_package_is_in_the_port(both_metrics):
    jm, pm = both_metrics
    names = [f["name"] for f in pm.snapshot()]
    assert names == [f["name"] for f in jm.snapshot()]
    assert len(names) >= 66


def test_validator_rejects_what_the_jax_one_rejects():
    from horovod_tpu import metrics as jm
    from horovod_tpu_torch import metrics as pm

    bad = ["x 1\nx 2\n",
           "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 1"
           "\nh_sum 1\nh_count 1\n",
           "# TYPE a counter\n# TYPE a gauge\n", "a{b=c} 1\n"]
    for text in bad:
        with pytest.raises(ValueError):
            jm.validate_prometheus_text(text)
        with pytest.raises(ValueError):
            pm.validate_prometheus_text(text)


def test_journal_rotates_at_its_cap(tmp_path, monkeypatch):
    from horovod_tpu_torch import metrics

    path = tmp_path / "events.jsonl"
    monkeypatch.setenv("HOROVOD_EVENT_LOG", str(path))
    monkeypatch.setenv("HOROVOD_EVENT_LOG_MAX_BYTES", "2000")
    monkeypatch.setenv("HOROVOD_WORLD_VERSION", "7")
    try:
        for i in range(60):
            metrics.event("probe", i=i, pad="x" * 40)
    finally:
        monkeypatch.delenv("HOROVOD_EVENT_LOG")
        assert metrics.journal() is None  # closes the file
    prev = [json.loads(line) for line in
            open(f"{path}.prev").read().splitlines()]
    cur = [json.loads(line) for line in open(path).read().splitlines()]
    assert prev and cur
    assert os.path.getsize(path) < 2000 + 200
    ids = [r["i"] for r in prev + cur]
    assert ids == sorted(ids) and ids[-1] == 59
    assert {r["generation"] for r in prev + cur} == {7}
    assert all(r["event"] == "probe" and "t_wall" in r and "t_mono" in r
               for r in prev + cur)


# -- attribution and skew -----------------------------------------------------


def _payloads(seed, ranks=3, steps=5, collectives=3):
    """Trace payloads of ``ranks`` ranks: a step span, forward_backward,
    collectives partly overlapping it, optimizer_update, every rank with
    its own clock offset and lateness."""
    rng = np.random.RandomState(seed)
    out = {}
    for r in range(ranks):
        host = f"node{r}:0"
        records = []
        for s in range(1, steps + 1):
            t0 = 1.7e9 + 10.0 * s + float(rng.uniform(0, 0.05))
            fb = float(rng.uniform(0.2, 0.3))
            spans = [{"name": "forward_backward", "cat": "phase", "t": t0,
                      "dur": fb}]
            t = t0 + fb * float(rng.uniform(0.5, 1.2))
            for c in range(collectives):
                d = float(rng.uniform(0.01, 0.05))
                spans.append({"name": f"allreduce#{c}", "cat": "collective",
                              "t": t, "dur": d, "args": {"bytes": 1 << c}})
                t += d * float(rng.uniform(0.5, 1.5))
            spans.append({"name": "optimizer_update", "cat": "phase",
                          "t": t, "dur": float(rng.uniform(0.01, 0.02))})
            end = max(sp["t"] + sp["dur"] for sp in spans)
            spans.insert(0, {"name": "train_step", "cat": "step", "t": t0,
                             "dur": end - t0, "args": {"synced": True}})
            records.append({"step": s, "kind": "train_step", "t": t0,
                            "synced": s != 3, "spans": spans})
        out[host] = {"rank": str(r), "host": host, "generation": 2,
                     "clock_offset_s": float(rng.uniform(-0.01, 0.01)),
                     "clock_error_s": 0.0005, "t_ship": 1.7e9 + 99,
                     "steps": records, "model_flops_per_step": 3.2e12,
                     "peak_flops_per_rank": 989e12}
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_attribution_and_skew_match_the_jax_package(seed):
    from horovod_tpu import attribution as ja
    from horovod_tpu import tracing as jt
    from horovod_tpu_torch import attribution as pa
    from horovod_tpu_torch import tracing as pt

    payloads = _payloads(seed)
    for payload in payloads.values():
        for rec in payload["steps"]:
            _close(pa.decompose_step(rec, offset=0.25),
                   ja.decompose_step(rec, offset=0.25))
            d = pa.decompose_step(rec)
            assert abs(sum(d["phases"].values()) - d["wall_s"]) < 1e-5
    _close(pa.analyze_cluster(payloads), ja.analyze_cluster(payloads))
    _close(pa.analyze_cluster(payloads, steps=2, rank="1"),
           ja.analyze_cluster(payloads, steps=2, rank="1"))
    _close(pt.compute_skew(payloads), jt.compute_skew(payloads))
    cluster = pa.analyze_cluster(payloads)
    assert cluster["status"] == "ok" and len(cluster["groups"]) == 4
    assert all(g["suspect_rank"] in {"0", "1", "2"}
               for g in cluster["groups"])


@pytest.mark.parametrize("seed", [0, 1])
def test_regression_sentinel_matches_the_jax_package(seed):
    from horovod_tpu import attribution as ja
    from horovod_tpu_torch import attribution as pa

    rng = np.random.RandomState(seed)
    js = ja.RegressionSentinel(alpha=0.3, sigma=4.0, min_steps=3)
    ps = pa.RegressionSentinel(alpha=0.3, sigma=4.0, min_steps=3)
    alarms = 0
    for i in range(40):
        scale = 3.0 if 20 <= i < 25 else 1.0  # a regression, then recovery
        phases = {p: float(rng.uniform(0.01, 0.02)) * scale
                  for p in pa.STEP_PHASES}
        wall = sum(phases.values())
        got, want = ps.observe(phases, wall=wall), js.observe(phases, wall)
        _close(got, want)
        alarms += len(got["alarms"])
    _close(ps.snapshot(), js.snapshot())
    assert alarms > 0


def test_peak_flops_table_and_cpu_detection():
    from horovod_tpu_torch import attribution

    assert attribution.peak_flops_for_kind("NVIDIA H100 80GB HBM3") == 989e12
    assert attribution.peak_flops_for_kind("TPU v5 lite") == 197e12
    assert attribution.peak_flops_for_kind("cpu") is None
    if not torch.cuda.is_available():
        assert attribution.detect_peak_flops() is None


# -- the rendezvous server: traces and the scrape, both ways -------------------


def _tracer_payload(tracing, rank, host, t0, skew):
    """A payload of one package's own tracer: three synced steps with the
    canonical phases and a collective."""
    tracer = tracing.StepTracer()
    for s in range(3):
        with tracer.step_scope("train_step") as rec:
            base = t0 + s + skew
            tracer.record("forward_backward", "phase", base, 0.2)
            tracer.record("allreduce", "collective", base + 0.15, 0.1)
            tracer.record("optimizer_update", "phase", base + 0.25, 0.03)
            rec.synced = True
    payload = tracer.payload()
    payload.update(rank=str(rank), host=host, generation=1,
                   clock_offset_s=0.001 * rank, clock_error_s=0.0002)
    return payload


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
    yield jkv, pkv, js, ps
    js.stop()
    ps.stop()


def test_trace_payloads_merge_both_ways(servers):
    from horovod_tpu import tracing as jt
    from horovod_tpu_torch import tracing as pt

    jkv, pkv, js, ps = servers
    t0 = time.time()
    port_payload = _tracer_payload(pt, 0, "a:0", t0, 0.0)
    jax_payload = _tracer_payload(jt, 1, "b:0", t0, 0.05)
    # Each package's client puts its own payload into the other's server
    # and into its own.
    for client_mod, payload in ((pkv, port_payload), (jkv, jax_payload)):
        for server in (js, ps):
            client_mod.KVClient("127.0.0.1", server.port).put(
                "trace", payload["host"], json.dumps(payload).encode())
    assert ps.timeline_json() == js.timeline_json()
    tracks = {e["pid"] for e in ps.timeline_json()["traceEvents"]
              if e["ph"] == "X"}
    assert tracks == {0, 1}
    _close(ps.criticalpath_summary(), js.criticalpath_summary())
    cp = ps.criticalpath_summary()
    assert cp["status"] == "ok" and cp["groups"]
    assert cp["groups"][-1]["suspect_rank"] == "1"  # it arrives 50 ms late
    _close(ps.straggler_summary(), js.straggler_summary())
    _close(ps.criticalpath_summary(steps=1, rank="0"),
           js.criticalpath_summary(steps=1, rank="0"))
    # The same over HTTP, with the query filters.
    from urllib.request import urlopen

    for route in ("/timeline", "/criticalpath?steps=2", "/stragglers",
                  "/timeline?rank=1"):
        got = json.loads(urlopen(f"http://127.0.0.1:{ps.port}{route}").read())
        want = json.loads(urlopen(f"http://127.0.0.1:{js.port}{route}")
                          .read())
        _close(got, want)


def test_scrape_of_the_same_heartbeats_equals_the_jax_servers(servers,
                                                               both_metrics):
    jkv, pkv, js, ps = servers
    jm, pm = both_metrics
    _drive(jm, 5)
    _drive(pm, 5)
    bodies = {
        "localhost:0": {"steps": 4, "commits": 3, "rank": "0",
                        "time": time.time(), "metrics": pm.snapshot()},
        "localhost:1": {"steps": 4, "commits": 2, "rank": "1",
                        "time": time.time(), "metrics": jm.snapshot()},
    }
    for server in (js, ps):
        server.set_cluster_info(world_np=1, blacklisted=0)
        for name, body in bodies.items():
            reply = pkv.KVClient("127.0.0.1", server.port).put(
                "heartbeat", name, json.dumps(body).encode())
            assert "t_server" in json.loads(reply)
        for payload in _payloads(4).values():
            jkv.KVClient("127.0.0.1", server.port).put(
                "trace", payload["host"], json.dumps(payload).encode())

    def body(server):
        # Heartbeat ages differ by when each server is read.
        return "\n".join(line for line in server.metrics_text().split("\n")
                         if not line.startswith("hvd_heartbeat_age_seconds"))

    assert body(ps) == body(js)
    parsed = jm.validate_prometheus_text(ps.metrics_text())
    ranks = {s[0].get("rank") for s in
             parsed["hvd_collective_dispatch_total"]["samples"]}
    assert ranks == {"0", "1"}
    assert "hvd_collective_skew_seconds" in parsed


# -- timeline, stall inspector, launcher --------------------------------------


def _run(code, env=None, timeout=120):
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("HOROVOD_")}
    full.update(PYTHONPATH=REPO_ROOT, **(env or {}))
    return subprocess.run([sys.executable, "-c", code], env=full,
                          capture_output=True, text=True, timeout=timeout)


def test_timeline_stays_loadable_after_sigkill(tmp_path):
    path = tmp_path / "timeline.json"
    code = (
        "import sys\n"
        "from horovod_tpu_torch import timeline\n"
        f"timeline.start_timeline({str(path)!r}, mark_cycles=True)\n"
        "i = 0\n"
        "while True:\n"
        "    with timeline.activity(f'allreduce.{i}', 'collective',\n"
        "                           {'i': i}):\n"
        "        pass\n"
        "    timeline.mark_cycle()\n"
        "    i += 1\n"
        "    if i == 300:\n"
        "        print('ready', flush=True)\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = REPO_ROOT
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        # The writer thread trails the emitter: the kill lands once it has
        # written the 600 events emitted before "ready" (at most 30 s; a
        # read that catches a write half done is read again).
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            try:
                if len(json.loads(path.read_text())) >= 600:
                    break
            except ValueError:
                pass
            time.sleep(0.05)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert proc.returncode == -9
    events = json.loads(path.read_text())
    names = [e["name"] for e in events]
    assert len(events) >= 600
    assert "allreduce.0" in names and "cycle.1" in names
    assert {e["ph"] for e in events} == {"X", "i"}


def test_timeline_loads_after_every_write(tmp_path, monkeypatch):
    """The file loads after each of the writer thread's writes (the JAX
    writer's ``tell()`` flushed each event before its closing ``]``), and
    after ``drain()`` while the emitter goes on emitting bursts."""
    from horovod_tpu_torch import timeline

    path = tmp_path / "timeline.json"
    bad, writes = [], []
    real = os.pwrite

    def checked(fd, data, offset):
        n = real(fd, data, offset)
        writes.append(offset)
        try:
            json.loads(path.read_bytes())
        except ValueError as e:
            bad.append(str(e))
        return n

    monkeypatch.setattr(timeline.os, "pwrite", checked)
    timeline.start_timeline(str(path), mark_cycles=True)
    try:
        reads = []
        for burst in range(20):
            for i in range(25):
                with timeline.activity(f"allreduce.{burst}.{i}",
                                       "collective",
                                       {"pad": "x" * (13 * i)}):
                    pass
                timeline.mark_cycle()
            timeline.get_timeline().drain()
            reads.append(len(json.loads(path.read_bytes())))
    finally:
        timeline.stop_timeline()
    assert not bad, bad[:3]
    assert len(writes) >= 1000
    assert reads == [50 * (b + 1) for b in range(20)]


def test_stall_inspector_warns_and_reaps_device_completions():
    from horovod_tpu_torch import metrics, stall

    ins = stall.StallInspector(warning_s=1.0, shutdown_s=0.0)
    try:
        before = metrics.STALL_WARNINGS.labels().get()
        t = ins.begin("allreduce[(4,)]")
        stalled = ins.check_once(now=time.monotonic() + 2.0)
        assert stalled and stalled[0].startswith("allreduce[(4,)]")
        assert metrics.STALL_WARNINGS.labels().get() == before + 1
        # A ticket waiting for its device work: open until the probe says
        # done, then closed by the reaper, which calls on_done once.
        done, called = [False], []
        ins.end(t)
        t2 = ins.begin("allreduce[(8,)]")
        ins.end_when(t2, lambda: done[0], lambda: called.append(1))
        ins.reap()
        assert t2 in ins._outstanding and not called
        done[0] = True
        assert ins.check_once() == []
        assert t2 not in ins._outstanding and called == [1]
        ins.reap()
        assert called == [1]
    finally:
        ins.stop()


def test_stall_shutdown_posts_the_abort_and_raises_from_watch(tmp_path):
    log = tmp_path / "events.jsonl"
    code = (
        "import time\n"
        "from horovod_tpu_torch import abort, metrics, stall\n"
        "from horovod_tpu_torch.exceptions import HorovodInternalError\n"
        "try:\n"
        "    with stall.watch(name='wedged'):\n"
        "        time.sleep(30)\n"
        "except HorovodInternalError as e:\n"
        "    print('raised:', e, flush=True)\n"
        "print('posts', metrics.ABORT_POSTS.labels().get(),\n"
        "      'aborted', abort.is_aborted(), flush=True)\n")
    out = _run(code, {"HOROVOD_STALL_CHECK_TIME": "0.2",
                      "HOROVOD_STALL_SHUTDOWN_TIME": "0.6",
                      "HOROVOD_EVENT_LOG": str(log)})
    assert out.returncode == 0, out.stderr
    assert "raised: stall shutdown: stall exceeded " \
           "HOROVOD_STALL_SHUTDOWN_TIME" in out.stdout, out.stdout
    assert "posts 1.0 aborted True" in out.stdout
    assert "Stall detected" in out.stderr and "watch[wedged]" in out.stderr
    events = [json.loads(line) for line in log.read_text().splitlines()]
    kinds = [(e["event"], e.get("reason")) for e in events]
    flight = kinds.index(("flight_record", "stall_shutdown"))
    assert kinds[flight + 1][0] == "abort_posted", kinds
    assert "open_spans" in events[flight] and "steps" in events[flight]


def test_stall_deadman_exits_204(tmp_path):
    from horovod_tpu_torch.runner.elastic.constants import \
        EXIT_STALL_ABANDONED

    log = tmp_path / "events.jsonl"
    code = (
        "import signal, time\n"
        "from horovod_tpu_torch import stall\n"
        "# A main thread no interrupt reaches.\n"
        "signal.signal(signal.SIGINT, lambda *a: None)\n"
        "with stall.watch(name='wedged'):\n"
        "    time.sleep(60)\n"
        "print('returned', flush=True)\n")
    out = _run(code, {"HOROVOD_STALL_CHECK_TIME": "0.2",
                      "HOROVOD_STALL_SHUTDOWN_TIME": "0.4",
                      "HOROVOD_STALL_EXIT_GRACE": "0.5",
                      "HOROVOD_EVENT_LOG": str(log)}, timeout=60)
    assert EXIT_STALL_ABANDONED == 204
    assert out.returncode == 204, (out.returncode, out.stderr)
    assert "returned" not in out.stdout
    reasons = [json.loads(line).get("reason")
               for line in log.read_text().splitlines()]
    assert "stall_shutdown" in reasons and "deadman_exit" in reasons


def test_fetch_watches_a_tree_and_returns_it():
    from horovod_tpu_torch import metrics, stall

    tree = {"a": [torch.ones(2), (torch.zeros(1), 3)], "b": "x"}
    tickets = metrics.STALL_TICKETS.labels().get()
    assert stall.fetch(tree, name="step.1") is tree
    assert metrics.STALL_TICKETS.labels().get() == tickets + 1


def test_profiler_from_the_env_and_its_summary(tmp_path):
    """``HOROVOD_PROFILER_LOGDIR`` starts a capture at ``init()``; ``stop``
    writes ``rank<r>.trace.json`` with the collectives' ranges; the summary
    has the JAX package's keys this slice fills."""
    code = (
        "import json, torch\n"
        "import horovod_tpu_torch as hvd\n"
        "hvd.init(device='cpu')\n"
        "assert hvd.profiler.active()\n"
        "hvd.allreduce(torch.ones(3))\n"
        "path = hvd.profiler.stop()\n"
        "names = {e.get('name') for e in json.load(open(path))"
        "['traceEvents']}\n"
        "assert 'allreduce' in names, sorted(names)[:20]\n"
        "s = hvd.profiler.summary()\n"
        "print('KEYS', sorted(s), path)\n"
        "print('CACHE', s['executable_cache'], s['eager_dispatch'])\n")
    out = _run(code, {"HOROVOD_PROFILER_LOGDIR": str(tmp_path / "prof")})
    assert out.returncode == 0, out.stderr
    assert "KEYS ['attribution', 'checkpoint', 'comms', 'eager_dispatch', " \
           "'executable_cache', 'fsdp', 'goodput', 'integrity', 'memory', " \
           "'stragglers', 'trace_active', 'trace_logdir']" in out.stdout, \
        out.stdout
    assert str(tmp_path / "prof" / "rank0.trace.json") in out.stdout
    assert "CACHE {'hits': 0, 'misses': 0, 'size': 0, 'capacity': 0, " \
           "'bytes': 0} {'allreduce': 1}" in out.stdout


def test_launcher_passes_the_four_flags_to_the_workers():
    from horovod_tpu.runner import launch as ref
    from horovod_tpu_torch.runner import launch

    flags = ["--timeline-filename", "/tmp/t.json", "--timeline-mark-cycles",
             "--stall-check-time", "5", "--stall-shutdown-time", "30"]
    argv = ["-np", "1", *flags, "python", "x.py"]
    env = launch.args_to_env(launch.parse_args(argv))
    assert env == {"HOROVOD_TIMELINE": "/tmp/t.json",
                   "HOROVOD_TIMELINE_MARK_CYCLES": "1",
                   "HOROVOD_STALL_CHECK_TIME": "5.0",
                   "HOROVOD_STALL_SHUTDOWN_TIME": "30.0"}
    assert env == ref.args_to_env(ref.parse_args(argv))
    child = ("import os; print('ENV', [os.environ.get(k) for k in "
             "('HOROVOD_TIMELINE', 'HOROVOD_TIMELINE_MARK_CYCLES', "
             "'HOROVOD_STALL_CHECK_TIME', 'HOROVOD_STALL_SHUTDOWN_TIME')])")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "1",
         "--cpu-mode", *flags, sys.executable, "-c", child],
        capture_output=True, text=True, timeout=60, cwd=REPO_ROOT,
        env={**{k: v for k, v in os.environ.items()
                if not k.startswith("HOROVOD_")}, "PYTHONPATH": REPO_ROOT})
    assert out.returncode == 0, out.stderr
    assert "ENV ['/tmp/t.json', '1', '5.0', '30.0']" in out.stdout, out.stdout


# -- a 2-rank BERT with every plane on ------------------------------------------

STEPS = 4


def _bert_planes_worker(rank, init_file, tmp, queue):
    os.environ.update(HOROVOD_NUM_PROCESSES="2",
                      HOROVOD_PROCESS_ID=str(rank), HOROVOD_RANK=str(rank))
    for key in ("HOROVOD_TRACE_SAMPLE", "HOROVOD_STALL_CHECK_STEPS",
                "HOROVOD_EVENT_LOG", "HOROVOD_TIMELINE"):
        os.environ.pop(key, None)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import attribution, metrics
    from horovod_tpu_torch.models import bert as bert_mod

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    cfg = dataclasses.replace(bert_mod.BERT_TINY, num_layers=2,
                              dropout_rate=0.0, dtype=torch.float32)
    torch.manual_seed(0)
    model = bert_mod.Bert(cfg)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(10 + rank)
    batches = []
    for _ in range(STEPS):
        ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 32)))
        pos = torch.from_numpy(np.stack([rng.choice(32, 4, replace=False)
                                         for _ in range(2)]))
        labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 4)))
        batches.append((ids, pos, labels, torch.ones(2, 4)))

    def loss_fn(m, b):
        _, logits = m(b[0], masked_positions=b[1])
        return bert_mod.mlm_loss(logits, b[2], b[3])

    def run():
        model.load_state_dict(initial)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3),
            fusion_threshold_bytes=64 << 10)
        step = hvd.make_train_step(model, loss_fn, opt)
        losses = [float(step(b)) for b in batches]
        opt.remove_hooks()
        return ([p.detach().clone() for p in model.parameters()],
                opt.state_dict(), losses)

    off = run()
    os.environ.update(HOROVOD_TRACE_SAMPLE="2", HOROVOD_STALL_CHECK_STEPS="3",
                      HOROVOD_EVENT_LOG=os.path.join(tmp, f"ev{rank}.jsonl"))
    hvd.start_timeline(os.path.join(tmp, f"tl{rank}.json"), mark_cycles=True)
    attribution.set_model_flops_per_step(1e9, peak_flops=1e12)
    metrics.reset_for_testing()
    with hvd.profiler.trace(os.path.join(tmp, "prof")) as prof:
        on = run()
    hvd.stop_timeline()
    same = (all(torch.equal(a, b) for a, b in zip(off[0], on[0]))
            and off[2] == on[2]
            and all(torch.equal(x, y)
                    for sa, sb in zip(off[1]["state"].values(),
                                      on[1]["state"].values())
                    for x, y in zip(sa.values(), sb.values())))
    parsed = metrics.validate_prometheus_text(metrics.render())

    def total(name):
        return sum(v for _, v in parsed[name]["samples"])

    queue.put(dict(
        rank=rank, same=same, trace=prof.path,
        dispatch=total("hvd_collective_dispatch_total"),
        flushes=total("hvd_grad_sync_flushes_total"),
        phases=total("hvd_step_phase_seconds"),
        mfu=metrics.MFU_RATIO.labels().get(),
        last=attribution.summary()["last_step"],
        tickets=metrics.STALL_TICKETS.labels().get()))
    hvd.shutdown()


def test_two_rank_bert_with_every_plane_on_moves_nothing(tmp_path):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init_file = tmp_path / "init"
    procs = [ctx.Process(target=_bert_planes_worker,
                         args=(r, str(init_file), str(tmp_path), queue))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    for _ in procs:
        r = queue.get(timeout=240)
        got[r["rank"]] = r
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    for rank, r in got.items():
        assert r["same"], rank
        assert r["dispatch"] >= STEPS  # the loss average, each step
        assert r["flushes"] == STEPS
        assert r["phases"] > 0 and 0 < r["mfu"] < 1
        assert r["last"]["synced"] and set(r["last"]["phases"]) == {
            "compute", "exposed_comm", "straggler_wait", "overhead"}
        # Every call of the step holds a ticket on its 3rd call, every
        # collective on each.
        assert r["tickets"] >= STEPS + 1
        tl = json.loads((tmp_path / f"tl{rank}.json").read_text())
        names = {e["name"] for e in tl}
        assert {"forward_backward", "collective", "optimizer_update",
                "allreduce"} <= names
        assert any(n.startswith("cycle.") for n in names)
        trace = json.load(open(r["trace"]))
        tnames = {e.get("name", "") for e in trace["traceEvents"]}
        assert any(n.startswith("hvd.allreduce.bucket") for n in tnames)
        assert "forward_backward" in tnames
        events = [json.loads(line)["event"] for line in
                  (tmp_path / f"ev{rank}.jsonl").read_text().splitlines()] \
            if (tmp_path / f"ev{rank}.jsonl").exists() else []
        assert "abort_posted" not in events


# -- an elastic gloo run, scraped and journaled ---------------------------------


def test_elastic_run_serves_the_scrape_and_journals_the_recovery(tmp_path):
    from horovod_tpu import metrics as jm

    sys.path.insert(0, os.path.join(REPO_ROOT, "tests"))
    from test_torch_elastic_e2e import (launcher_argv, launcher_env,
                                        run_launcher, write_discovery)

    script, _ = write_discovery(tmp_path, ["localhost", "127.0.0.1"])
    log = tmp_path / "events.jsonl"
    rc, text = run_launcher(
        launcher_argv(script, 2, 2, 2),
        launcher_env(tmp_path, "observe", HOROVOD_TRACE_SAMPLE="1",
                     HOROVOD_EVENT_LOG=str(log),
                     HOROVOD_ELASTIC_HEARTBEAT_INTERVAL="0.3"))
    assert rc == 0, text
    assert text.count("finished at epoch 5") == 2, text
    scrape = (tmp_path / "metrics.txt").read_text()
    parsed = jm.validate_prometheus_text(scrape)
    ranks = {s[0].get("rank") for s in
             parsed["hvd_grad_sync_flushes_total"]["samples"]}
    assert ranks == {"0", "1"}, ranks
    timeline = json.loads((tmp_path / "timeline.json").read_text())
    assert {e["pid"] for e in timeline["traceEvents"]
            if e["ph"] == "X"} == {0, 1}
    cp = json.loads((tmp_path / "criticalpath.json").read_text())
    assert cp["status"] == "ok" and cp["groups"]
    stragglers = json.loads((tmp_path / "stragglers.json").read_text())
    assert set(stragglers["ranks"]) == {"0", "1"}
    events = [json.loads(line) for line in log.read_text().splitlines()]
    names = [e["event"] for e in events]
    posted = names.index("abort_posted")
    consumed = names.index("abort_consumed", posted)
    synced = names.index("world_synced", consumed)
    gens = [events[i]["generation"] for i in (posted, consumed, synced)]
    assert gens == sorted(gens), gens
    assert any(e["event"] == "flight_record"
               and e["reason"] == "abort_consumed" for e in events)
    assert "driver_start" in names and "job_complete" in names
    assert re.search(r"recovery", " ".join(names))
