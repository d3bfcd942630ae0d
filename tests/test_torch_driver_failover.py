"""The port's driver failover (``horovod_tpu_torch/runner/elastic/
driver_state.py``, the driver's takeover, the worker's rejoin and the
rendezvous server's driver-epoch fence) held against the JAX package's
(``horovod_tpu/runner/elastic/driver_state.py``; the scenarios of
``tests/test_driver_failover.py``):

- driver-state files both ways: a snapshot or endpoint record that one
  package's ``DriverStateStore`` writes is read by the other's ``open``,
  ``load`` and ``read_endpoint``; the epoch rises, a stale driver's
  snapshot and endpoint are fenced, a torn current slot falls back to
  ``.prev``, concurrent opens claim distinct epochs, and both packages
  agree on each of these; adoption refuses a recycled pid;
- the driver-epoch fence: each package's client against the other's
  server answers 409 on a stale epoch as the reference's own pair does;
- the driver: a fenced snapshot makes it stand down
  (``EXIT_DRIVER_SUPERSEDED``), and the blacklist's cooldowns survive the
  snapshot;
- the worker: with no state directory an orphan exits on the driver-lost
  deadline as before; with one it waits the rejoin budget, follows a
  successor's endpoint record (and not a stale one) and repoints;
- end to end under ``hvdrun-torch --cpu-mode`` (fsdp, 2 workers): the
  driver is SIGKILLed after both committed epoch 2; a driver started with
  the same command and state directory adopts both workers by pid, and
  they rejoin it at generation g+1 without a restart, recover on the peer
  rung from their own pools (the digest of the state of their last
  commit), read nothing durable, and finish with the parameters of an
  uninterrupted run.
"""

import os
import re
import signal
import subprocess
import sys
import time
from urllib.error import HTTPError

import numpy as np
import pytest

from horovod_tpu import faults as ref_faults
from horovod_tpu.runner.elastic import driver_state as ref_ds
from horovod_tpu.runner.http import kv_server as ref_kv
from horovod_tpu_torch import faults as port_faults
from horovod_tpu_torch.runner.elastic import driver_state as port_ds
from horovod_tpu_torch.runner.http import kv_server as port_kv

from test_torch_peercheck import (REPO_ROOT, expected_weights, final_weights,
                                  hosts_script, launch_argv, worker_env)

DS = {"ref": ref_ds, "port": port_ds}
KV = {"ref": ref_kv, "port": port_kv}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("HOROVOD_FAULTS", "HOROVOD_SECRET_KEY",
                 "HOROVOD_DRIVER_STATE_DIR", "HOROVOD_DRIVER_EPOCH",
                 "HOROVOD_JOB_ID"):
        monkeypatch.delenv(name, raising=False)
    for mod in (ref_faults, port_faults):
        mod.reset()
    yield
    for mod in (ref_faults, port_faults):
        mod.reset()


# -- the snapshot store -------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_state_files_read_in_the_other_package(writer, reader, tmp_path):
    d = str(tmp_path)
    store, snap = DS[writer].DriverStateStore.open(d)
    assert snap is None and store.epoch == 1
    store.save({"generation": 3, "world": [["a", 1], ["b", 2]]})
    store.publish_endpoint("127.0.0.1", 4242, 3)
    rec = DS[reader].read_endpoint(d)
    assert {k: rec[k] for k in ("addr", "port", "driver_epoch",
                                "generation")} == {
        "addr": "127.0.0.1", "port": 4242, "driver_epoch": 1,
        "generation": 3}
    nxt, snap = DS[reader].DriverStateStore.open(d)
    assert nxt.epoch == 2
    assert (snap["generation"], snap["world"], snap["driver_epoch"]) == (
        3, [["a", 1], ["b", 2]], 1)
    # The successor's save fences the writer's store out.
    nxt.save({"generation": 4})
    with pytest.raises(DS[writer].DriverFencedError):
        store.save({"generation": 99})
    with pytest.raises(DS[writer].DriverFencedError):
        store.publish_endpoint("127.0.0.1", 1, 1)
    assert DS[writer].DriverStateStore(d, epoch=2).load()["generation"] == 4
    # The same bytes: both packages encode a record alike.
    assert port_ds._encode({"a": 1, "b": [2]}) == ref_ds._encode(
        {"a": 1, "b": [2]})


def _store_scenarios(ds, tmp_path):
    """What one package's store does in the reference's store cases."""
    out = []
    d = str(tmp_path / "a")
    store = ds.DriverStateStore(d, epoch=7)
    store.publish_endpoint("127.0.0.1", 1, 0)
    nxt, snap = ds.DriverStateStore.open(d)
    out.append(("endpoint_epoch_cleared", snap, nxt.epoch))
    d = str(tmp_path / "b")
    store, _ = ds.DriverStateStore.open(d)
    store.save({"generation": 1, "tag": "good"})
    store.save({"generation": 2, "tag": "newer"})
    blob = open(store.state_path, "rb").read()
    with open(store.state_path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    out.append(("torn_current", store.load()["tag"]))
    d = str(tmp_path / "c")
    a, _ = ds.DriverStateStore.open(d)
    b, _ = ds.DriverStateStore.open(d)
    b.save({"generation": 0})
    try:
        a.save({"generation": 0})
        fenced = False
    except ds.DriverFencedError:
        fenced = True
    c, _ = ds.DriverStateStore.open(d)
    out.append(("concurrent", a.epoch, b.epoch, fenced, c.epoch))
    d = str(tmp_path / "d")
    os.makedirs(d)
    out.append(("none_yet", ds.read_endpoint(d)))
    store = ds.DriverStateStore(d, epoch=1)
    store._fenced_install(store.endpoint_path, {"addr": "x"})
    out.append(("malformed", ds.read_endpoint(d)))
    out.append(("no_dir", ds.read_endpoint(None)))
    out.append(("state_dir_unset", ds.state_dir()))
    return out


def test_store_cases_match_the_reference(tmp_path):
    ref = _store_scenarios(ref_ds, tmp_path / "ref")
    assert _store_scenarios(port_ds, tmp_path / "port") == ref
    assert ("concurrent", 1, 2, True, 3) in ref


@pytest.mark.parametrize("name", sorted(DS))
def test_snapshot_fault_point(name, tmp_path):
    ds = DS[name]
    faults = {"ref": ref_faults, "port": port_faults}[name]
    store, _ = ds.DriverStateStore.open(str(tmp_path))
    faults.inject(faults.DRIVER_SNAPSHOT, "raise", at=1, count=1)
    with pytest.raises(faults.InjectedFault):
        store.save({"generation": 1})
    store.save({"generation": 1})
    assert store.load()["generation"] == 1


def test_proc_start_ticks_match_the_reference():
    me = os.getpid()
    ticks = port_ds.proc_start_ticks(me)
    assert ticks is not None and ticks == ref_ds.proc_start_ticks(me)
    assert port_ds.proc_start_ticks(2 ** 22 + 12345) is None


def _driver(tmp_path, monkeypatch, state_dir=None):
    from horovod_tpu_torch.runner.elastic.discovery import FixedHostDiscovery
    from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
    from horovod_tpu_torch.runner.hosts import HostInfo
    from horovod_tpu_torch.runner.launch import Settings

    # The driver sets the job's secret in the env: the fixture's undo
    # drops it again.
    monkeypatch.setenv("HOROVOD_SECRET_KEY", "a" * 64)
    if state_dir is not None:
        monkeypatch.setenv("HOROVOD_DRIVER_STATE_DIR", state_dir)
    settings = Settings(num_proc=1, hosts=[], command=["true"],
                        elastic=True, min_np=1, max_np=1)
    return ElasticDriver(settings, discovery=FixedHostDiscovery(
        [HostInfo("localhost", 1)]))


def test_adoption_refuses_a_recycled_pid(tmp_path, monkeypatch):
    drv = _driver(tmp_path, monkeypatch)
    me = os.getpid()
    good = port_ds.proc_start_ticks(me)
    info = {"pid": me, "local": True}
    assert drv._adopt_from_snapshot({"workers": {"localhost:0": {
        **info, "start_ticks": good - 7}}}) == []
    assert not drv._workers
    assert drv._adopt_from_snapshot({"workers": {"localhost:0": {
        **info, "start_ticks": good}, "remote:0": {
        "pid": me, "local": False}}}) == ["localhost:0"]
    assert drv._workers["localhost:0"].popen.poll() is None


def test_a_fenced_driver_stands_down(tmp_path, monkeypatch):
    from horovod_tpu_torch.runner.elastic.constants import (
        EXIT_DRIVER_SUPERSEDED)

    d = str(tmp_path / "state")
    drv = _driver(tmp_path, monkeypatch, state_dir=d)
    assert drv.driver_epoch == 1
    drv._save_state()
    snap = port_ds.DriverStateStore(d, epoch=1).load()
    assert snap["secret_key"] == os.environ["HOROVOD_SECRET_KEY"]
    assert sorted(snap) == sorted(
        ["generation", "min_np", "max_np", "world", "workers", "spares",
         "blacklist", "driver_lost_counts", "integrity_strikes",
         "integrity_acted_group", "integrity_last_outlier",
         "integrity_quarantine", "policy", "secret_key", "driver_epoch",
         "t_wall"])
    successor, _ = port_ds.DriverStateStore.open(d)
    successor.save({"generation": 0})
    drv._save_state()
    assert drv._superseded
    assert drv._monitor() == EXIT_DRIVER_SUPERSEDED


def test_blacklist_cooldown_survives_the_snapshot():
    from horovod_tpu.runner.elastic.discovery import (
        FixedHostDiscovery as RefFixed, HostManager as RefManager)
    from horovod_tpu.runner.hosts import HostInfo as RefHost
    from horovod_tpu_torch.runner.elastic.discovery import (
        FixedHostDiscovery, HostManager)
    from horovod_tpu_torch.runner.hosts import HostInfo

    out = {}
    for name, fixed, manager, host in (
            ("ref", RefFixed, RefManager, RefHost),
            ("port", FixedHostDiscovery, HostManager, HostInfo)):
        m = manager(fixed([host("a", 1), host("b", 1)]), cooldown_s=60.0)
        m.blacklist("a")
        ages = m.export_blacklist()
        m2 = manager(fixed([host("a", 1)]), cooldown_s=60.0)
        m2.restore_blacklist({"a": 50.0, "b": "bad"})
        m3 = manager(fixed([host("a", 1)]), cooldown_s=60.0)
        m3.restore_blacklist({"a": 61.0})
        m3.restore_blacklist(None)
        out[name] = (sorted(ages), all(0 <= v < 5 for v in ages.values()),
                     m2.is_blacklisted("a"), m2.is_blacklisted("b"),
                     m3.is_blacklisted("a"))
    assert out["port"] == out["ref"] == (["a"], True, True, False, False)


# -- the driver-epoch fence ---------------------------------------------------


def _answer(fn):
    try:
        return ("ok", fn())
    except HTTPError as e:
        return ("http", e.code, e.read())


def _fence_sequence(server, client):
    kv = KV[client]
    server.seed(generation=5, driver_epoch=3)
    mk = lambda **k: kv.KVClient("127.0.0.1", server.port, timeout=5.0,  # noqa: E731
                                 retries=1, **k)
    ok = mk(generation_fn=lambda: 5, epoch_fn=lambda: 3)
    stale = mk(generation_fn=lambda: 5, epoch_fn=lambda: 2)
    out = [_answer(lambda: ok.put("s", "k", b"v")),
           _answer(lambda: stale.put("s", "k", b"zombie")),
           _answer(lambda: stale.delete_scope("s")),
           _answer(lambda: ok.get("s", "k")),
           _answer(lambda: mk().put("s", "plain", b"p")),
           _answer(lambda: mk(epoch_fn=lambda: 2).put("abort", "3", b"{}")),
           _answer(lambda: mk(epoch_fn=lambda: 3).put("abort", "3", b"{}")),
           _answer(lambda: mk(epoch_fn=lambda: 4).put("abort", "4", b"{}")),
           _answer(lambda: ok.driver_epoch()),
           _answer(lambda: ok.world_version()),
           ("fenced", server.fenced_writes)]
    server.publish_epoch("world", {})
    out.append(_answer(lambda: ok.put("s", "k", b"w")))
    out.append(_answer(lambda: ok.world_version()))
    return out


def test_driver_epoch_fence_answers_as_the_reference():
    runs = {}
    for name, server_kv, client in (("ref-ref", ref_kv, "ref"),
                                    ("port-client", ref_kv, "port"),
                                    ("port-server", port_kv, "ref")):
        server = server_kv.RendezvousServer(host="127.0.0.1")
        server.start()
        try:
            runs[name] = _fence_sequence(server, client)
        finally:
            server.stop()
    assert runs["port-client"] == runs["ref-ref"]
    assert runs["port-server"] == runs["ref-ref"]
    assert ("fenced", 3) in runs["ref-ref"]
    assert ("ok", 3) in runs["ref-ref"]  # GET /_epoch


# -- the worker's rejoin ------------------------------------------------------


def _context(monkeypatch, port, **env):
    from horovod_tpu_torch.runner.elastic.worker import ElasticWorkerContext

    for k, v in {"HOROVOD_RENDEZVOUS_ADDR": "127.0.0.1",
                 "HOROVOD_RENDEZVOUS_PORT": str(port),
                 "HOROVOD_HOSTNAME": "hostA", "HOROVOD_KV_RETRIES": "1",
                 **env}.items():
        monkeypatch.setenv(k, v)
    return ElasticWorkerContext


def _wait(pred, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.05)
    return pred()


def test_no_state_dir_keeps_the_driver_lost_exit(monkeypatch):
    from horovod_tpu_torch.runner.network import free_port

    cls = _context(monkeypatch, free_port(),
                   HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT="0.4")
    lost = []
    ctx = cls(on_driver_lost=lost.append)
    assert ctx.rejoin_timeout() == 0.0
    ctx.start_polling(interval=0.05)
    try:
        assert _wait(lambda: lost, 20)
    finally:
        ctx.stop_polling()
    assert lost[0] >= 0.4


def test_an_orphan_waits_the_rejoin_budget(monkeypatch, tmp_path):
    from horovod_tpu_torch.runner.network import free_port

    cls = _context(monkeypatch, free_port(),
                   HOROVOD_DRIVER_STATE_DIR=str(tmp_path),
                   HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT="0.4",
                   HOROVOD_DRIVER_REJOIN_TIMEOUT="1.0",
                   HOROVOD_DRIVER_REJOIN_PROBE_INTERVAL="0.1")
    lost = []
    ctx = cls(on_driver_lost=lost.append)
    assert ctx.rejoin_timeout() == 1.0
    ctx.start_polling(interval=0.05)
    try:
        assert _wait(lambda: lost, 30), "the orphan never gave up"
    finally:
        ctx.stop_polling()
    assert lost[0] >= 1.4


def test_an_orphan_rejoins_the_successor(monkeypatch, tmp_path):
    """Driver 1 dies; driver 2 (epoch 2) starts at the old generation and
    publishes its endpoint and g+1: the worker repoints, takes the epoch,
    arms the host update, its heartbeats reach the new server, and the
    peer replicator's next client points there."""
    from horovod_tpu_torch import peercheck
    from horovod_tpu_torch.elastic.runner import notification_manager

    s1 = port_kv.RendezvousServer(host="127.0.0.1")
    s1.seed(driver_epoch=1)
    s1.start()
    s1.publish_epoch("world", {"hostA:0": b"{}"})
    cls = _context(monkeypatch, s1.port,
                   HOROVOD_DRIVER_STATE_DIR=str(tmp_path),
                   HOROVOD_DRIVER_EPOCH="1", HOROVOD_WORLD_VERSION="1",
                   HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT="1.0",
                   HOROVOD_DRIVER_REJOIN_TIMEOUT="60",
                   HOROVOD_DRIVER_REJOIN_PROBE_INTERVAL="0.1")
    ctx = cls()
    rep = peercheck.PeerReplicator(rank=0, world_size_fn=lambda: 1,
                                   generation_fn=lambda: 1)
    assert rep.client() is not None
    notification_manager.clear()
    ctx.start_polling(interval=0.05)
    ctx.start_heartbeat(interval=0.2)
    s2 = None
    try:
        s1.stop()
        s2 = port_kv.RendezvousServer(host="127.0.0.1")
        s2.seed(generation=1, driver_epoch=2)
        s2.start()
        port_ds.DriverStateStore(str(tmp_path), epoch=2).publish_endpoint(
            "127.0.0.1", s2.port, 1)
        assert _wait(lambda: ctx.driver_epoch == 2, 30), "never repointed"
        assert os.environ["HOROVOD_RENDEZVOUS_PORT"] == str(s2.port)
        assert os.environ["HOROVOD_DRIVER_EPOCH"] == "2"
        assert rep._client is None
        assert rep.replicate(b"shard", step=1)
        assert s2.fenced_writes == 0
        s2.publish_epoch("world", {"hostA:0": b'{"process_id": 0}'})
        assert _wait(lambda: notification_manager._pending, 20)
        assert _wait(lambda: s2.heartbeat_age("hostA:0") is not None, 20)
    finally:
        ctx.stop_polling()
        notification_manager.clear()
        peercheck.reset_for_testing()
        if s2 is not None:
            s2.stop()


def test_a_stale_endpoint_record_is_ignored(monkeypatch, tmp_path):
    from horovod_tpu_torch.runner.network import free_port

    cls = _context(monkeypatch, free_port(),
                   HOROVOD_DRIVER_STATE_DIR=str(tmp_path),
                   HOROVOD_DRIVER_EPOCH="2")
    ctx = cls()
    port_ds.DriverStateStore(str(tmp_path), epoch=2).publish_endpoint(
        "127.0.0.1", 1, 1)
    ctx._next_rejoin_probe = 0.0
    assert ctx._try_rejoin() is False
    assert ctx.driver_epoch == 2


# -- end to end ---------------------------------------------------------------

WORKER_LINE = re.compile(r"gen=(\d+) host=(\S+) rank=(\d+) epoch=(\d+) "
                         r"np=(\d+)")


def test_sigkilled_driver_is_taken_over_and_workers_rejoin(tmp_path):
    hosts = ("localhost", "127.0.0.1")
    script = hosts_script(tmp_path, hosts)
    env = worker_env(
        tmp_path, "failover", "fsdp",
        HOROVOD_DRIVER_STATE_DIR=str(tmp_path / "state"),
        HOROVOD_DRIVER_STATE_REFRESH="0.5",
        HOROVOD_DRIVER_REJOIN_TIMEOUT="60",
        HOROVOD_DRIVER_REJOIN_PROBE_INTERVAL="0.2",
        HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT="2", HOROVOD_KV_RETRIES="1")
    argv = launch_argv(script, 2, 2, 2)

    def logs():
        return {h: (tmp_path / f"worker-{h}.log").read_text()
                if (tmp_path / f"worker-{h}.log").exists() else ""
                for h in hosts}

    def start(name):
        return subprocess.Popen(
            argv, env=env, cwd=REPO_ROOT, start_new_session=True,
            stdout=open(tmp_path / f"{name}.txt", "w"),
            stderr=subprocess.STDOUT)

    first = start("driver1")
    second = None
    try:
        assert _wait(lambda: all(re.search(r"epoch=2 np=", t)
                                 for t in logs().values()), 90), logs()
        port_faults.kill_driver(first.pid)
        assert first.wait(timeout=30) == -signal.SIGKILL
        second = start("driver2")
        assert second.wait(timeout=90) == 0, (
            (tmp_path / "driver2.txt").read_text(), logs())
    finally:
        for proc in (first, second):
            if proc is not None and proc.poll() is None:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    driver2 = (tmp_path / "driver2.txt").read_text()
    assert "taking over from driver epoch 1 at generation 1" in driver2
    text = "\n".join(logs().values())
    commits = dict(re.findall(r"COMMIT epoch=(\d+) digest=(\w+)", text))
    for host, log in logs().items():
        assert "finished at epoch 6" in log, (host, log)
        assert "DURABLE_RESTORE_USED" not in log, (host, log)
        assert "recovery rung 'durable'" not in log, (host, log)
        assert "GATE TIMED OUT" not in log, (host, log)
        # One process per host: the successor adopted the workers that
        # outlived their driver, and launched none.
        assert len(set(re.findall(r"^pid=(\d+) ", log, re.M))) == 1, log
        assert "driver epoch 2 > 1" in log, log
        restored = re.findall(r"PEER_RESTORED host=\S+ epoch=(\d+) "
                              r"digest=(\w+)", log)
        assert restored and all(d == commits[e] for e, d in restored), (
            restored, commits)
        gens = {int(e): int(g) for g, _, _, e, n in WORKER_LINE.findall(log)}
        assert sorted(gens) == list(range(6)), log
        assert {g for e, g in gens.items() if e < 3} == {1}, gens
        assert {g for e, g in gens.items() if e >= 3} == {2}, gens
        assert all(n == "2" for *_, n in WORKER_LINE.findall(log))
    weights = final_weights(text)
    assert sorted(weights) == sorted(hosts)
    np.testing.assert_array_equal(weights["localhost"],
                                  weights["127.0.0.1"])
    np.testing.assert_allclose(weights["localhost"],
                               expected_weights(lambda e: 2),
                               rtol=1e-5, atol=1e-6)
