"""The port's self-healing policy plane held against the JAX package's.

- ``PolicyController`` (``horovod_tpu_torch/elastic/policy.py``): the
  scenarios of the reference's controller tests run through both
  controllers with one injected clock and the same evidence; every
  decision (action, host, reason, evidence, prediction, realized goodput)
  and ``export_state`` must be the reference's, and a ``restore_state``
  resumes the same condemnation. The integrity-strikes channel drains
  with no goodput target.
- The rendezvous server's ``spare`` and ``preempt`` scopes and the
  scrape's policy families.
- End to end on the CPU, through the port's elastic driver (in this
  process) over three one-slot local hosts, two in the world and one warm
  spare, workers on gloo (``tests/torch_robust_worker.py``):
  - the silent-data-corruption scenario: ``grad.corrupt`` on one host,
    two voters, the drift tie-break names it once, the drain, the
    blacklist, the spare promoted, the survivors recovered on the peer
    rung with no durable read, and every printed loss on the
    uninterrupted run's trajectory;
  - the straggler scenario: one host delayed every step, drained by the
    policy under ``HOROVOD_TARGET_GOODPUT``, the spare promoted, one
    ``policy_decision`` with its predicted and realized goodput, and the
    losses on the trajectory;
  - a ``PUT /preempt/<host>`` notice drains its host, and the spare joins;
  - both planes inert with no knob: the same corruption and the same
    straggler ride along, one world, no vote, no drain, no spare.
"""

import dataclasses
import json
import os
import re
import signal
import stat
import sys
import threading
import time
import types

import pytest

from horovod_tpu import faults as ref_faults
from horovod_tpu.elastic import policy as ref_policy
from horovod_tpu_torch import faults
from horovod_tpu_torch import metrics as port_metrics
from horovod_tpu_torch.elastic import policy
from horovod_tpu_torch.runner.elastic.constants import EXIT_REMOVED
from horovod_tpu_torch.runner.http.kv_server import (PREEMPT_SCOPE,
                                                     SPARE_SCOPE, KVClient,
                                                     RendezvousServer)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO_ROOT, "tests", "torch_robust_worker.py")
WORLD = ["good", "bad"]


@pytest.fixture(autouse=True)
def _fresh_faults():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


def _skew(host, lateness, rank="1"):
    return {"matched": 4,
            "ranks": {rank: {"host": host, "mean_lateness_s": lateness,
                             "max_lateness_s": lateness, "samples": 4}},
            "worst": {"name": "allreduce.w#7", "step": -1,
                      "skew_s": lateness, "last_rank": rank,
                      "last_host": host}}


POLICY_ENV = {"HOROVOD_STRAGGLER_WINDOW": "1.0",
              "HOROVOD_POLICY_DRAIN_SKEW": "0.2",
              "HOROVOD_POLICY_REALIZE_WINDOW": "2.0",
              "HOROVOD_POLICY_RESIZE_COST": "1.0"}


@pytest.mark.parametrize("raw", ["", "abc", "0", "-0.5", "1.5", "0.9", "1.0"])
def test_target_goodput_parses_as_the_reference(monkeypatch, raw):
    monkeypatch.setenv("HOROVOD_TARGET_GOODPUT", raw)
    assert policy.target_goodput() == ref_policy.target_goodput()


def _decision(d):
    return None if d is None else dataclasses.asdict(d)


def _drive(mod, script, min_np=1):
    """Run ``script`` (a list of (clock, op, args)) through one module's
    controller; every decision, realization and the final export."""
    clock = [0.0]
    c = mod.PolicyController(min_np=min_np, clock=lambda: clock[0])
    out = []
    for t, op, args in script:
        clock[0] = t
        if op == "feed":
            lateness, rate, host, hb = args
            c.note_rate(rate)
            c.observe(_skew(host, lateness), hb, WORLD)
        elif op == "blind":
            c.note_rate(2.0)
            c.observe({"ranks": {}, "worst": None}, {}, WORLD)
        elif op == "decide":
            out.append(_decision(c.decide(WORLD, args)))
        elif op == "drain":
            d = c.decide(WORLD, 1)
            out.append(_decision(d))
            if d is not None:
                c.record_drain(d, generation=args)
        elif op == "rate":
            c.note_rate(args)
        elif op == "realize":
            out.append(_decision(c.realize_tick()))
        elif op == "flush":
            out.append(_decision(c.flush()))
        elif op == "cost":
            c.note_resize_cost(args)
            out.append(c.resize_cost_s())
        elif op == "integrity":
            c.note_integrity(args)
        elif op == "fault":
            mod.faults.inject(mod.faults.POLICY_DECIDE, "drop", at=1,
                              count=1)
    out.append(c.export_state())
    return out


def _feed(t, lateness=0.5, rate=2.0, host="bad", hb=None):
    return (t, "feed", (lateness, rate, host, hb or {}))


SCRIPTS = {
    "single_spike": [_feed(0, 5.0), (0, "decide", 1), _feed(1, 0.0),
                     _feed(2, 5.0), (2, "decide", 1)],
    "blind_tick_freezes": [_feed(0), (0.8, "blind", None), _feed(1.2),
                           (1.2, "decide", 1)],
    "healthy_resets": [_feed(0), _feed(1, 0.0), _feed(2), (2, "decide", 1)],
    "sustained_drains": [_feed(0), _feed(1.2), (1.2, "decide", 1)],
    "no_spare_below_min": [_feed(0), _feed(1.2), (1.2, "decide", 0),
                           (1.2, "decide", 1)],
    "cheap_straggler": [_feed(0, 0.3, 0.1), _feed(1.2, 0.3, 0.1),
                        (1.2, "decide", 1)],
    "costly_resize": [(0, "cost", 500.0), _feed(0), _feed(1.2),
                      (1.2, "decide", 1)],
    "cost_ewma": [(0, "cost", 10.0), (0, "cost", 20.0), (0, "cost", -1.0)],
    "heartbeat_drift": [_feed(0, 0.0, hb={"bad": 10.0}),
                        _feed(1.2, 0.0, hb={"bad": 10.0}),
                        (1.2, "decide", 1)],
    "realized": [_feed(0), _feed(1.2), (1.2, "drain", 3), (2.0, "rate", 10.0),
                 (2.5, "rate", 10.0), (3.0, "realize", None),
                 (3.5, "realize", None), (3.6, "realize", None)],
    "cooldown": [_feed(0), _feed(1.2), (1.2, "drain", 2), _feed(2.0),
                 _feed(3.1), (3.1, "decide", 1), (3.8, "realize", None),
                 _feed(10.0), _feed(11.5), (11.5, "decide", 1)],
    "flush_partial": [_feed(0), _feed(1.2), (1.2, "drain", 2),
                      (1.5, "flush", None), (1.6, "flush", None)],
    "decide_fault": [_feed(0), _feed(1.2), (1.2, "fault", None),
                     (1.2, "decide", 1), (1.3, "decide", 1)],
    "integrity_strikes": [(0, "integrity", "bad"), (0, "decide", 1),
                          (0, "integrity", "bad"), (0, "decide", 1)],
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_decisions_match_the_reference(case, monkeypatch, tmp_path):
    """The same evidence under one injected clock: the same decisions,
    realizations, journal records and exported state."""
    for k, v in POLICY_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("HOROVOD_TARGET_GOODPUT", "0.9")
    if case == "cheap_straggler":
        monkeypatch.setenv("HOROVOD_TARGET_GOODPUT", "0.5")
    if case == "costly_resize":
        monkeypatch.setenv("HOROVOD_POLICY_HORIZON", "10.0")
    if case == "heartbeat_drift":
        monkeypatch.setenv("HOROVOD_POLICY_HB_DRIFT", "2.0")
    if case == "cooldown":
        monkeypatch.setenv("HOROVOD_POLICY_COOLDOWN", "50.0")
    if case == "integrity_strikes":
        monkeypatch.delenv("HOROVOD_TARGET_GOODPUT")
        monkeypatch.setenv("HOROVOD_POLICY_INTEGRITY_STRIKES", "2")
    min_np = 2 if case == "no_spare_below_min" else 1
    journals = {}
    outs = {}
    for name, mod in (("ref", ref_policy), ("port", policy)):
        path = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("HOROVOD_EVENT_LOG", str(path))
        outs[name] = _drive(mod, SCRIPTS[case], min_np)
        journals[name] = [
            {k: v for k, v in json.loads(line).items()
             if k not in ("t_wall", "t_mono", "pid")}
            for line in (path.read_text().splitlines()
                         if path.exists() else [])]
    assert outs["port"] == outs["ref"]
    assert journals["port"] == journals["ref"]
    decided = [d for d in outs["port"][:-1] if isinstance(d, dict)
               and d.get("host")]
    if case in ("sustained_drains", "realized", "heartbeat_drift",
                "integrity_strikes"):
        assert decided and decided[0]["host"] == "bad"
    if case == "realized":
        realized = [d for d in outs["port"][:-1] if isinstance(d, dict)
                    and "realized" in d["predicted"]]
        assert realized[0]["predicted"]["realized"][
            "realized_gain_commits_s"] == 8.0
    if case == "integrity_strikes":
        assert outs["port"][0] is None  # one strike of two
        assert decided[0]["predicted"].get("slo_bypassed") is True


def test_restore_state_resumes_the_condemnation(monkeypatch):
    """A successor's controller, restored from the export, drains at the
    same moment the predecessor's would have, as the reference's does."""
    for k, v in POLICY_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("HOROVOD_TARGET_GOODPUT", "0.9")
    got = []
    for mod in (ref_policy, policy):
        clock = [0.0]
        c = mod.PolicyController(clock=lambda: clock[0])
        c.note_rate(2.0)
        c.observe(_skew("bad", 0.5), {}, WORLD)
        clock[0] = 0.6
        snap = json.loads(json.dumps(c.export_state()))
        heir = mod.PolicyController(clock=lambda: clock[0])
        heir.restore_state(snap)
        clock[0] = 1.2
        heir.note_rate(2.0)
        heir.observe(_skew("bad", 0.5), {}, WORLD)
        got.append((snap, _decision(heir.decide(WORLD, 1)),
                    heir.export_state()))
    assert got[1] == got[0] and got[1][1]["host"] == "bad"


def test_strikes_without_a_goodput_target(monkeypatch):
    """The strikes channel is a correctness channel: it drains with no
    HOROVOD_TARGET_GOODPUT, holds below min_np without a replacement,
    never runs the SLO channel, and forgets a host that left the world."""
    monkeypatch.delenv("HOROVOD_TARGET_GOODPUT", raising=False)
    monkeypatch.setenv("HOROVOD_POLICY_INTEGRITY_STRIKES", "2")
    c = policy.PolicyController(min_np=1)
    assert not c.enabled and c.armed
    c.observe(_skew("h1", 9.9), {}, ["h0", "h1"])
    assert c.decide(["h0", "h1"], spares_ready=1) is None
    c.note_integrity("h1")
    c.note_integrity("h1")
    assert c.decide(["h1"], spares_ready=0) is None
    d = c.decide(["h0", "h1"], spares_ready=1)
    assert (d.action, d.host) == ("drain", "h1")
    c2 = policy.PolicyController(min_np=1)
    c2.note_integrity("h1")
    c2.note_integrity("h1")
    assert c2.decide(["h0", "h2"], spares_ready=1) is None
    assert c2.integrity_strike_count("h1") == 0
    monkeypatch.delenv("HOROVOD_POLICY_INTEGRITY_STRIKES")
    assert not policy.PolicyController(min_np=1).armed


def test_integrity_strikes_drain_a_worker_with_no_goodput_target(
        monkeypatch):
    """The driver's vote under HOROVOD_INTEGRITY_ACTION=drain drains the
    named worker's host with no HOROVOD_TARGET_GOODPUT: abort first, then
    the drain, the blacklist and a new world."""
    from horovod_tpu import integrity as ref_integrity
    from horovod_tpu_torch.runner.elastic import driver as port_driver
    from horovod_tpu_torch.runner.elastic.discovery import FixedHostDiscovery
    from horovod_tpu_torch.runner.hosts import HostInfo
    from horovod_tpu_torch.runner.launch import Settings

    monkeypatch.delenv("HOROVOD_TARGET_GOODPUT", raising=False)
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "1")
    monkeypatch.setenv("HOROVOD_SECRET_KEY", "a" * 64)
    drv = port_driver.ElasticDriver(
        Settings(num_proc=3, hosts=[], command=["true"], elastic=True,
                 min_np=1, max_np=3),
        discovery=FixedHostDiscovery([HostInfo(h, 1) for h in "abc"]))
    drv._world_hosts = [HostInfo(h, 1) for h in "abc"]
    drv._workers = {f"{h}:0": object() for h in "abc"}
    recs = {r: {"rank": r, "host": f"{h}:0", "generation": 0, "step": 4,
                "digest": "bad" if h == "b" else "ok", "prev": None,
                "summaries": [{"n": 4, "finite": 4, "l2": 1.0}], "t": 0.0}
            for r, h in enumerate("abc")}
    monkeypatch.setattr(drv._server, "heartbeat_version", lambda: 1)
    monkeypatch.setattr(drv._server, "integrity_vote_cached",
                        lambda: (recs, ref_integrity.vote_latest(recs, 3)))
    calls = []
    monkeypatch.setattr(drv, "_post_abort", lambda why: calls.append(
        ("abort", why)))
    monkeypatch.setattr(drv, "_drain_host", lambda name, why, **kw: calls.append(
        ("drain", name, kw)))
    drv._integrity_tick()
    assert [c[0] for c in calls] == ["abort", "drain"]
    assert calls[1][1] == "b:0" and calls[1][2]["abort_posted"] is True
    assert drv._policy.integrity_strike_count("b:0") == 1
    assert drv._server.quarantine_export()["1"]["host"] == "b:0"


# -- The drain's abort inside a step ---------------------------------------------


def test_the_abort_hook_ends_every_group_at_once(monkeypatch):
    """A drain's abort that lands inside a step of a negotiated world:
    each group's teardown waits until every other group's abort has
    started (an NCCL communicator's teardown waits for the card, where
    another group's collective runs until its own abort ends it), so the
    hook starts them all together; then it fails the negotiated runtime's
    pending handles with the abort's reason."""
    from torch.distributed import distributed_c10d as c10d

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.exceptions import HorovodInternalError

    class Group:
        def __init__(self, name):
            self.name, self.started = name, threading.Event()
            self.waited_out = False

        def abort(self):
            self.started.set()
            for other in groups:
                if not other.started.wait(5.0):
                    self.waited_out = True

    class World:
        errors = []

        def _fail_all(self, error):
            self.errors.append(error)

    groups = [Group("default"), Group("negotiated")]
    world = World()
    monkeypatch.setattr(basics._state, "owns_group", True)
    monkeypatch.setattr(basics._state, "negotiated", world)
    monkeypatch.setattr(basics.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(c10d, "_world", types.SimpleNamespace(
        pg_names={g: g.name for g in groups}))
    t0 = time.monotonic()
    basics._abort_groups("drain of hostC", 1)
    assert time.monotonic() - t0 < 4.0
    assert [g.waited_out for g in groups] == [False, False]
    assert len(world.errors) == 1
    assert isinstance(world.errors[0], HorovodInternalError)
    assert str(world.errors[0]) == \
        "coordinated abort (world generation 1): drain of hostC"


# -- The KV scopes -------------------------------------------------------------


@pytest.fixture()
def server():
    s = RendezvousServer(host="127.0.0.1")
    s.start()
    yield s
    s.stop()


def test_spare_and_preempt_scopes(server):
    client = KVClient("127.0.0.1", server.port)
    assert server.spare_records() == {} and server.preempt_notices() == {}
    client.put(SPARE_SCOPE, "a:0", json.dumps({"host": "a",
                                               "pid": 42}).encode())
    client.put(SPARE_SCOPE, "b:0", b"\xff not json")
    assert server.spare_records() == {"a:0": {"host": "a", "pid": 42},
                                      "b:0": {}}
    server.clear_spare("a:0")
    server.clear_spare("a:0")
    assert list(server.spare_records()) == ["b:0"]
    client.put(PREEMPT_SCOPE, "hostA", b"{}")
    assert server.preempt_notices() == {"hostA": {}}
    server.consume_preempt("hostA")
    assert server.preempt_notices() == {}


def test_the_scrape_counts_policy_actions_and_spares(server):
    parsed = port_metrics.validate_prometheus_text(server.metrics_text())
    assert parsed["hvd_policy_spare_hosts"]["samples"] == [({}, 0.0)]
    actions = {lb["action"]: v for lb, v in
               parsed["hvd_policy_decisions_total"]["samples"]}
    assert actions == {"drain": 0.0, "promote": 0.0, "preempt": 0.0}
    server.record_policy_action("drain")
    server.record_policy_action("drain")
    server.set_cluster_info(spares=2)
    parsed = port_metrics.validate_prometheus_text(server.metrics_text())
    assert parsed["hvd_policy_spare_hosts"]["samples"] == [({}, 2.0)]
    actions = {lb["action"]: v for lb, v in
               parsed["hvd_policy_decisions_total"]["samples"]}
    assert actions["drain"] == 2.0


# -- End to end on the CPU ----------------------------------------------------


HOSTS = ["127.0.0.41", "127.0.0.42", "127.0.0.43"]
# Seconds a job may run.
WALL_S = 100


def _run_job(tmp_path, monkeypatch, mode, epochs, env, armed, during=None):
    """One elastic job of ``tests/torch_robust_worker.py`` through the
    port's driver in this process: (rc, lines, journal records)."""
    from horovod_tpu_torch.runner.elastic.driver import run_elastic
    from horovod_tpu_torch.runner.launch import Settings
    from horovod_tpu_torch.utils.logging import get_logger

    jpath = tmp_path / "journal.jsonl"
    for k in ("HOROVOD_TARGET_GOODPUT", "HOROVOD_INTEGRITY_INTERVAL",
              "HOROVOD_WARM_SPARES", "HOROVOD_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_EVENT_LOG", str(jpath))
    monkeypatch.setenv("HOROVOD_ELASTIC_HEARTBEAT_INTERVAL", "0.1")
    monkeypatch.setenv("HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT", "30")
    monkeypatch.setenv("HOROVOD_BLACKLIST_COOLDOWN", "600")
    monkeypatch.setenv("HOROVOD_POLICY_DRAIN_GRACE", "10")
    monkeypatch.delenv("HOROVOD_DRIVER_STATE_DIR", raising=False)
    if armed:
        monkeypatch.setenv("HOROVOD_WARM_SPARES", "1")
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    hosts_file = tmp_path / "hosts.txt"
    hosts_file.write_text("\n".join(HOSTS) + "\n")
    discover = tmp_path / "discover.sh"
    discover.write_text(f"#!/bin/sh\ncat {hosts_file}\n")
    discover.chmod(discover.stat().st_mode | stat.S_IEXEC)
    settings = Settings(
        num_proc=2, hosts=[], command=[sys.executable, WORKER],
        cpu_mode=True, elastic=True, min_np=2, max_np=2,
        discovery_script=str(discover), elastic_timeout=60.0,
        env={"ROBUST_TEST_MODE": mode, "ROBUST_TEST_EPOCHS": str(epochs),
             "ROBUST_TEST_CORRUPT": HOSTS[0],
             "ROBUST_TEST_STRAGGLER": HOSTS[0],
             "ROBUST_TEST_DELAY": "0.6",
             "ROBUST_TEST_STEP_SLEEP": "0.8" if mode == "sdc" else "0.02",
             "HOROVOD_RECOVERY_BACKOFF_MAX": "0.2",
             "HOROVOD_ABORT_POLL_INTERVAL": "0.1",
             "HOROVOD_STALL_CHECK_STEPS": "1",
             "HOROVOD_TRACE_SAMPLE": "1",
             "HOROVOD_TRACE_SHIP_SECONDS": "0.3",
             "PYTHONPATH": REPO_ROOT})
    lines: list = []
    import logging

    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(f"[driver] {rec.getMessage()}")
    logger = get_logger()
    logger.addHandler(handler)
    watcher = None
    if during is not None:
        watcher = threading.Thread(target=during, args=(lines, jpath),
                                   daemon=True)
        watcher.start()
    # The job's wall limit: SIGTERM drains the driver's workers (the
    # driver forwards it), and the asserts below then fail.
    limit = threading.Timer(WALL_S, os.kill, (os.getpid(), signal.SIGTERM))
    limit.start()
    try:
        rc = run_elastic(settings, sink=lines.append)
    finally:
        limit.cancel()
        logger.removeHandler(handler)
    if watcher is not None:
        watcher.join(timeout=5)
    records = []
    if jpath.exists():
        for line in jpath.read_text().splitlines():
            try:
                records.append(json.loads(line))
            except ValueError:
                pass
    return rc, [str(x) for x in lines], records


_LINE = re.compile(r"rank=(\d+) host=(\S+) epoch=(\d+) np=(\d+) gen=(\d+) "
                   r"loss=(-?[0-9.]+) w=(-?[0-9.]+)")


def _hold_trajectory(mode, text, epochs):
    """Every printed step (any world, any host) lies on the uninterrupted
    two-rank run's losses and parameters."""
    sys.path.insert(0, os.path.join(REPO_ROOT, "tests"))
    from torch_robust_worker import expected

    losses, w = expected(mode, epochs)
    seen = set()
    for m in _LINE.finditer(text):
        r, e, n = int(m.group(1)), int(m.group(3)), int(m.group(4))
        assert n == 2, m.group(0)
        assert abs(float(m.group(6)) - losses[(e, r)]) < 1e-5, (
            m.group(0), losses[(e, r)])
        assert abs(float(m.group(7)) - w[e]) < 1e-5, (m.group(0), w[e])
        seen.add((e, r))
    missing = {(e, r) for e in range(epochs) for r in (0, 1)} - seen
    assert not missing, sorted(missing)


def _events(records):
    out = {}
    for r in records:
        out.setdefault(r["event"], []).append(r)
    return out


def test_sdc_corrupt_host_voted_drained_and_replaced(tmp_path, monkeypatch):
    epochs = 8
    t0 = time.time()
    rc, lines, records = _run_job(
        tmp_path, monkeypatch, "sdc", epochs,
        {"HOROVOD_INTEGRITY_INTERVAL": "1"}, armed=True)
    text = "\n".join(lines)
    assert rc == 0, text[-6000:]
    ev = _events(records)
    bad, survivor, spare = (f"{h}:0" for h in HOSTS)
    divergences = ev.get("integrity_divergence", [])
    assert len(divergences) == 1, divergences
    d = divergences[0]
    assert (d["host"], d["ambiguous"], d["strikes"]) == (bad, False, 1)
    assert d["method"] in ("drift", "nonfinite") and d["voters"] == 2
    assert any(r["host"] == HOSTS[0] for r in ev.get("policy_drain", []))
    assert any(r["host"] == HOSTS[0] for r in ev.get("blacklist", []))
    promoted = [r for r in ev.get("spare_promoted", []) if r["host"] == spare]
    assert promoted and promoted[0]["generation"] >= 2, sorted(ev)
    flights = [r for r in ev.get("flight_record", [])
               if r.get("reason") == "integrity_divergence"]
    assert flights and flights[0]["host"] == bad
    rungs = [r["rung"] for r in ev.get("recovery", [])]
    assert "peer" in rungs and "durable" not in rungs, rungs
    assert "DURABLE_RESTORE_USED" not in text
    assert "peer_fallback" not in ev
    for r in ev.get("world_published", []):
        assert r["np"] == 2
    assert f"host={HOSTS[1]} finished at epoch {epochs}" in text
    assert f"host={HOSTS[2]} finished at epoch {epochs}" in text
    assert f"host={HOSTS[0]} finished" not in text
    _hold_trajectory("sdc", text, epochs)
    assert time.time() - t0 < 120


def test_straggler_drained_spare_promoted(tmp_path, monkeypatch):
    """The delayed host is drained by the policy (its final commit lands:
    EXIT_REMOVED), the spare joins at the next generation, and one
    policy_decision carries the predicted and realized goodput."""
    epochs = 70
    t0 = time.time()
    rc, lines, records = _run_job(
        tmp_path, monkeypatch, "straggler", epochs,
        {"HOROVOD_TARGET_GOODPUT": "0.9",
         "HOROVOD_STRAGGLER_WINDOW": "1.5",
         "HOROVOD_POLICY_DRAIN_SKEW": "0.15",
         "HOROVOD_POLICY_INTERVAL": "0.4",
         "HOROVOD_POLICY_REALIZE_WINDOW": "3",
         "HOROVOD_POLICY_COOLDOWN": "120",
         "HOROVOD_POLICY_RESIZE_COST": "2.0"}, armed=True)
    text = "\n".join(lines)
    assert rc == 0, text[-6000:]
    ev = _events(records)
    straggler, survivor, spare = HOSTS
    assert any(r["host"] == f"{spare}:0"
               for r in ev.get("spare_launched", [])), sorted(ev)
    promoted = [r for r in ev.get("spare_promoted", [])
                if r["host"] == f"{spare}:0"]
    assert promoted and promoted[0]["generation"] >= 2, text[-4000:]
    drains = ev.get("policy_drain", [])
    assert len(drains) == 1 and drains[0]["host"] == straggler, drains
    assert drains[0]["action"] == "drain" and drains[0]["rc"] == EXIT_REMOVED
    flights = [r for r in ev.get("flight_record", [])
               if r.get("reason") == "policy_drain"]
    assert flights and flights[0]["evidence"]["straggler_ewma_s"][
        f"{straggler}:0"] > 0
    decisions = ev.get("policy_decision", [])
    assert len(decisions) == 1, decisions
    dec = decisions[0]
    assert dec["host"] == f"{straggler}:0" and dec["action"] == "drain"
    assert dec["predicted"]["target_goodput"] == 0.9
    assert dec["predicted"]["predicted_gain_s"] > 0
    assert dec["realized"]["counterfactual_rate_commits_s"] is not None
    assert dec["realized"]["realized_rate_commits_s"] is not None
    assert not any(r.get("rung") == "durable" for r in records)
    for r in ev.get("world_published", []):
        assert r["np"] == 2
    assert f"host={survivor} finished at epoch {epochs}" in text
    assert f"host={spare} finished at epoch {epochs}" in text
    assert f"host={straggler} finished" not in text
    _hold_trajectory("straggler", text, epochs)
    assert time.time() - t0 < 120


def test_a_preemption_notice_drains_its_host(tmp_path, monkeypatch):
    """``PUT /preempt/<host>``: the driver forwards the SIGTERM to that
    host's worker (its final commit, EXIT_REMOVED), blacklists the host
    and re-forms the world with the warm spare."""
    from horovod_tpu_torch.runner.http.kv_server import KVClient as Client

    epochs = 60

    from horovod_tpu_torch.runner.elastic import driver as port_driver

    real = port_driver.ElasticDriver._publish_world
    seen = {}

    def publish(self, hosts):
        seen["server"] = self._server
        return real(self, hosts)

    monkeypatch.setattr(port_driver.ElasticDriver, "_publish_world", publish)

    def preempt(lines, jpath):
        deadline = time.time() + 60
        while time.time() < deadline:
            if "server" in seen and re.search(r"epoch=5 np=2",
                                              "\n".join(lines)):
                Client("127.0.0.1", seen["server"].port).put(
                    PREEMPT_SCOPE, HOSTS[1], b"{}")
                return
            time.sleep(0.1)

    rc, lines, records = _run_job(tmp_path, monkeypatch, "straggler", epochs,
                                  {"HOROVOD_POLICY_INTERVAL": "0.3"},
                                  armed=True, during=preempt)
    text = "\n".join(lines)
    assert rc == 0, text[-6000:]
    ev = _events(records)
    assert [r["host"] for r in ev.get("preempt_notice", [])] == [HOSTS[1]]
    drains = ev.get("policy_drain", [])
    assert [(r["host"], r["action"], r["rc"]) for r in drains] == [
        (HOSTS[1], "preempt", EXIT_REMOVED)]
    assert any(r["host"] == f"{HOSTS[2]}:0"
               for r in ev.get("spare_promoted", []))
    assert f"host={HOSTS[0]} finished at epoch {epochs}" in text
    assert f"host={HOSTS[2]} finished at epoch {epochs}" in text
    assert "policy_decision" not in ev  # no target: no policy decision
    _hold_trajectory("straggler", text, epochs)


@pytest.mark.parametrize("mode", ["sdc", "straggler"])
def test_both_planes_are_inert_with_no_knob(tmp_path, monkeypatch, mode):
    """The same corrupting or delayed host with every knob unset: one
    world, no vote, no drain, no spare, no blacklist; both hosts finish on
    the uninterrupted trajectory (the injector touches snapshots only)."""
    epochs = 4 if mode == "sdc" else 8
    rc, lines, records = _run_job(tmp_path, monkeypatch, mode, epochs, {},
                                  armed=False)
    text = "\n".join(lines)
    assert rc == 0, text[-6000:]
    names = {r["event"] for r in records}
    for event in ("integrity_divergence", "policy_decision", "policy_drain",
                  "blacklist", "recovery", "rewind"):
        assert event not in names, (event, sorted(names))
    assert not any(n.startswith("spare_") for n in names), names
    assert len([r for r in records
                if r["event"] == "world_published"]) == 1
    for h in HOSTS[:2]:
        assert f"host={h} finished at epoch {epochs}" in text, text[-3000:]
    _hold_trajectory(mode, text, epochs)
