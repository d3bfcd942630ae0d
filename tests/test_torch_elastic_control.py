"""The port's elastic control plane held against the JAX package's: the
rendezvous KV's wire (each package's client against the other's server),
host discovery and the blacklist, the fault-injection grammar and
registry, and the import hygiene of the new modules."""

import json
import os
import stat
import subprocess
import sys
import time
from urllib.error import HTTPError

import pytest

from horovod_tpu.runner.elastic import discovery as ref_discovery
from horovod_tpu.runner.hosts import HostInfo as RefHostInfo
from horovod_tpu.runner.http import kv_server as ref_kv
from horovod_tpu import exceptions as ref_exceptions
from horovod_tpu import faults as ref_faults
from horovod_tpu_torch import exceptions as port_exceptions
from horovod_tpu_torch import faults as port_faults
from horovod_tpu_torch.runner.elastic import discovery as port_discovery
from horovod_tpu_torch.runner.hosts import HostInfo as PortHostInfo
from horovod_tpu_torch.runner.http import kv_server as port_kv

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECRET = "a" * 64


# -- KV wire --------------------------------------------------------------


def _answer(fn):
    """What one client call saw: ("ok", value) or ("http", code, body)."""
    try:
        return ("ok", fn())
    except HTTPError as e:
        return ("http", e.code, e.read())


def _wire_sequence(server, client_cls, monkeypatch) -> list:
    """One request sequence against ``server`` (started), every answer
    normalized where it carries a clock."""
    port = server.port
    c = client_cls("127.0.0.1", port, timeout=5.0, retries=1)
    out = []
    out.append(_answer(lambda: c.put("s", "k", b"v")))
    out.append(_answer(lambda: c.get("s", "k")))
    out.append(_answer(lambda: c.get("s", "missing")))
    out.append(_answer(lambda: c.put("s", "k2", b"w")))
    out.append(_answer(lambda: c.keys("s")))
    out.append(_answer(lambda: c.delete_scope("s")))
    out.append(_answer(lambda: c.get("s", "k")))
    out.append(_answer(lambda: c.keys("s")))
    out.append(_answer(lambda: c.world_version()))
    out.append(_answer(lambda: c.driver_epoch()))
    # A world publish: the version bumps after the scope is written.
    v = server.publish_epoch("world", {"h:0": b'{"process_id": 0}'})
    out.append(("published", v))
    out.append(_answer(lambda: c.world_version()))
    out.append(_answer(lambda: c.get("world/1", "h:0")))
    out.append(_answer(lambda: c.keys("world/1")))
    # The generation fence: a write stamped below the world's generation
    # is a zombie's (409, counted); at the generation it lands.
    stale = client_cls("127.0.0.1", port, timeout=5.0, retries=1,
                       generation_fn=lambda: 0)
    fresh = client_cls("127.0.0.1", port, timeout=5.0, retries=1,
                       generation_fn=lambda: 1)
    out.append(_answer(lambda: stale.put("coord/1", "addr", b"x:1")))
    out.append(_answer(lambda: stale.delete_scope("coord/1")))
    out.append(("fenced", server.fenced_writes))
    out.append(_answer(lambda: fresh.put("coord/1", "addr", b"x:2")))
    out.append(_answer(lambda: c.get("coord/1", "addr")))
    out.append(("fenced", server.fenced_writes))
    # Heartbeats: stamped with the server's receive time, answered with its
    # wall clock.
    before = time.time()
    hb = _answer(lambda: c.put("heartbeat", "h:0", b'{"steps": 1}'))
    t_server = json.loads(hb[1])["t_server"]
    out.append(("heartbeat", hb[0], sorted(json.loads(hb[1])),
                before - 1 <= t_server <= time.time() + 1))
    age = server.heartbeat_age("h:0")
    out.append(("hb_age", age is not None and 0 <= age < 5,
                server.heartbeat_age("nobody")))
    out.append(("hb_payload", server.heartbeat_payload("h:0")))
    server.clear_heartbeat("h:0")
    out.append(("hb_cleared", server.heartbeat_age("h:0")))
    # One abort record per generation: a second post overwrites it.
    out.append(("posted", server.post_abort("first")))
    out.append(("posted", server.post_abort("second")))
    rec = c.abort_posted(1)
    out.append(("abort", sorted(rec), rec["reason"]))
    server.publish_epoch("world", {"h:0": b"{}"})
    out.append(("posted", server.post_abort("third")))
    out.append(_answer(lambda: c.keys("abort")))
    out.append(("record", json.loads(server.abort_record(2))["reason"]))
    out.append(_answer(lambda: c.abort_posted(3)))
    # A wrong secret: 403, the server's body.
    monkeypatch.setenv("HOROVOD_SECRET_KEY", "b" * 64)
    out.append(_answer(lambda: c.get("world/2", "h:0")))
    out.append(_answer(lambda: c.put("s", "k", b"v")))
    monkeypatch.setenv("HOROVOD_SECRET_KEY", SECRET)
    # A request with no tag at all.
    from urllib.request import urlopen

    out.append(_answer(lambda: urlopen(
        f"http://127.0.0.1:{port}/_version", timeout=5).read()))
    return out


def test_kv_wire_matches_the_reference_in_both_directions(monkeypatch):
    """The port's client against the reference's server, and the
    reference's client against the port's server, see what the
    reference's client sees against its own server: the same status codes
    and bodies."""
    monkeypatch.setenv("HOROVOD_SECRET_KEY", SECRET)
    monkeypatch.delenv("HOROVOD_FAULTS", raising=False)
    runs = {}
    for name, server_cls, client_cls in (
            ("ref-ref", ref_kv.RendezvousServer, ref_kv.KVClient),
            ("port-client", ref_kv.RendezvousServer, port_kv.KVClient),
            ("port-server", port_kv.RendezvousServer, ref_kv.KVClient)):
        server = server_cls(host="127.0.0.1")
        server.start()
        try:
            runs[name] = _wire_sequence(server, client_cls, monkeypatch)
        finally:
            server.stop()
    assert runs["port-client"] == runs["ref-ref"]
    assert runs["port-server"] == runs["ref-ref"]
    # The fence counted the two stale writes, and a 403 carries its body.
    assert ("fenced", 2) in runs["ref-ref"]
    assert ("http", 403, b"bad auth tag") in runs["ref-ref"]
    assert any(a[:2] == ("http", 409) for a in runs["ref-ref"])


def test_env_generation_and_auth_payload_match(monkeypatch):
    for raw in ("", "3", "x"):
        monkeypatch.setenv("HOROVOD_WORLD_VERSION", raw)
        assert port_kv.env_generation() == ref_kv.env_generation()
    assert (port_kv._auth_payload("PUT", "/a/b", b"x")
            == ref_kv._auth_payload("PUT", "/a/b", b"x"))


# -- Discovery ------------------------------------------------------------


class _Mutable:
    """A discovery source whose host list the test sets."""

    def __init__(self, hosts):
        self.hosts = dict(hosts)
        self.fail = False

    def find_available_hosts_and_slots(self):
        if self.fail:
            raise RuntimeError("discovery script timed out")
        return dict(self.hosts)


def _names(hosts):
    return [(h.hostname, h.slots) for h in hosts]


def _discovery_sequence(mod, host_info, exc_mod) -> list:
    out = []
    d = _Mutable({"a": 1, "b": 1})
    m = mod.HostManager(d, cooldown_s=0.2, max_discovery_failures=3)
    out.append(m.update_available_hosts())
    out.append(_names(m.usable_hosts()))
    out.append(_names(m.pick_world([], None)))
    m.blacklist("a")
    out.append((m.is_blacklisted("a"), m.blacklist_count()))
    out.append(_names(m.pick_world(["a", "b"], None)))
    out.append(m.update_available_hosts())  # steady state, a banned
    # Churn: c joins discovery while a's cooldown runs out.
    d.hosts = {"a": 1, "b": 1, "c": 1}
    time.sleep(0.25)
    out.append(m.update_available_hosts())
    out.append(_names(m.pick_world(["b"], None)))
    out.append(m.update_available_hosts())  # edge-triggered
    # Stability and the cap.
    out.append(_names(m.pick_world(["c", "b"], 2)))
    out.append(_names(m.pick_world(["c", "b", "a"], 1)))
    # Mixed slots snap to one local size.
    d.hosts = {"a": 4, "b": 2, "c": 4, "d": 1}
    out.append(m.update_available_hosts())
    out.append(_names(m.pick_world(["d", "b"], None)))
    out.append(_names(m.pick_world([], 2)))
    # The discovery-failure limit: two blips propagate, the third raises.
    d.fail = True
    for _ in range(3):
        try:
            m.update_available_hosts()
            out.append("no error")
        except exc_mod.HostDiscoveryFailedError as e:
            out.append(("failed", str(e)))
        except RuntimeError as e:
            out.append(("blip", str(e)))
    d.fail = False
    out.append(m.update_available_hosts())
    # valid_sizes: only even host counts.
    even = mod.HostManager(_Mutable({"a": 1, "b": 1, "c": 1}),
                           valid_sizes=lambda n: n % 2 == 0)
    even.update_available_hosts()
    out.append(_names(even.pick_world([], None)))
    for hosts, cap in (([("a", 8), ("b", 4), ("c", 4), ("d", 2)], None),
                       ([("a", 2), ("b", 3), ("c", 3)], None),
                       ([("a", 1), ("b", 8)], 1), ([], None)):
        out.append(_names(mod.snap_to_topology(
            [host_info(h, s) for h, s in hosts], max_hosts=cap)))
    return out


def test_host_manager_matches_the_reference():
    assert (_discovery_sequence(port_discovery, PortHostInfo,
                                port_exceptions)
            == _discovery_sequence(ref_discovery, RefHostInfo,
                                   ref_exceptions))


def test_discovery_script_and_fixed_discovery_match(tmp_path):
    hosts_file = tmp_path / "hosts.txt"
    hosts_file.write_text("node-a:2\n\nnode-b\n127.0.0.1:4\n")
    script = tmp_path / "discover.sh"
    script.write_text(f"#!/bin/sh\ncat {hosts_file}\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    port = port_discovery.HostDiscoveryScript(str(script))
    ref = ref_discovery.HostDiscoveryScript(str(script))
    assert (port.find_available_hosts_and_slots()
            == ref.find_available_hosts_and_slots()
            == {"node-a": 2, "node-b": 1, "127.0.0.1": 4})
    fixed = [("x", 2), ("y", 1)]
    assert (port_discovery.FixedHostDiscovery(
        [PortHostInfo(*h) for h in fixed]).find_available_hosts_and_slots()
        == ref_discovery.FixedHostDiscovery(
            [RefHostInfo(*h) for h in fixed]).find_available_hosts_and_slots())


def test_warm_spares_are_not_ported_yet(monkeypatch):
    monkeypatch.setenv("HOROVOD_WARM_SPARES", "1")
    with pytest.raises(NotImplementedError, match="warm-spare"):
        port_discovery.HostManager(_Mutable({"a": 1}))
    monkeypatch.setenv("HOROVOD_WARM_SPARES", "0")
    port_discovery.HostManager(_Mutable({"a": 1}))


# -- Faults ---------------------------------------------------------------


SPECS = [
    "kv.request=raise@3x2",
    "heartbeat.send=drop@1x999;abort.poll=delay:0.01",
    " kv.fence=drop , kv.serve=hang:0.5@2 ",
    "checkpoint.save=corrupt:8@4x3;discovery.poll=raise",
    "",
]
BAD_SPECS = ["kv.request", "kv.request=explode", "kv.request=raise@x"]


def test_parse_spec_matches_the_reference():
    import dataclasses

    for spec in SPECS:
        assert ([dataclasses.astuple(s) for s in port_faults.parse_spec(spec)]
                == [dataclasses.astuple(s)
                    for s in ref_faults.parse_spec(spec)]), spec
    for spec in BAD_SPECS:
        with pytest.raises(ValueError) as ref_err:
            ref_faults.parse_spec(spec)
        with pytest.raises(ValueError) as port_err:
            port_faults.parse_spec(spec)
        assert str(port_err.value) == str(ref_err.value)


def _fire_sequence(mod, monkeypatch) -> list:
    monkeypatch.setenv("HOROVOD_FAULTS",
                       "kv.request=raise@2x2;heartbeat.send=drop@3")
    reg = mod._Registry()
    reg.inject("abort.poll", "drop", at=2, count=3)
    reg.inject("kv.fence", "corrupt", arg=5, at=1)
    out = []
    for point in ("kv.request", "heartbeat.send", "abort.poll"):
        for _ in range(6):
            try:
                out.append((point, reg.fire(point)))
            except mod.InjectedFault as e:
                out.append((point, "raised", str(e)))
        out.append((point, reg.hits(point), reg.fired(point)))
    out.append(reg.corrupt_payload("kv.fence", b"payload bytes"))
    out.append(reg.corrupt_payload("kv.fence", b"payload bytes"))
    out.append(sorted(reg.active()))
    reg.reset()
    return out


def test_fault_registry_fires_like_the_reference(monkeypatch):
    assert (_fire_sequence(port_faults, monkeypatch)
            == _fire_sequence(ref_faults, monkeypatch))
    for nbits in (0, 1, 64):
        assert (port_faults.flip_bits(b"\x00" * 16, nbits, "s")
                == ref_faults.flip_bits(b"\x00" * 16, nbits, "s"))


def test_the_kv_client_fires_its_points(monkeypatch):
    """kv.request drops are transport failures the client retries; a
    kv.fence firing stamps a stale generation the server 409s."""
    monkeypatch.delenv("HOROVOD_SECRET_KEY", raising=False)
    monkeypatch.delenv("HOROVOD_FAULTS", raising=False)
    port_faults.reset()
    server = port_kv.RendezvousServer(host="127.0.0.1")
    server.start()
    try:
        server.publish_epoch("world", {})
        c = port_kv.KVClient("127.0.0.1", server.port, retries=3,
                             backoff=0.0, generation_fn=lambda: 1)
        port_faults.inject("kv.request", "drop", at=1, count=2)
        assert c.world_version() == 1  # two drops, the third attempt lands
        assert port_faults.fired("kv.request") == 2
        port_faults.inject("kv.fence", "drop")
        with pytest.raises(HTTPError) as info:
            c.put("s", "k", b"v")
        assert info.value.code == 409 and server.fenced_writes == 1
        port_faults.inject("kv.serve", "drop")
        single = port_kv.KVClient("127.0.0.1", server.port, retries=1)
        with pytest.raises(Exception):
            single.get("s", "k")
        assert single.get("s", "k") is None  # the next request is served
    finally:
        port_faults.reset()
        server.stop()


# -- Import hygiene -------------------------------------------------------


def test_every_port_module_imports_without_jax():
    """A fresh interpreter imports every module of the port, the elastic
    ones included, and neither jax nor the JAX package comes with them;
    the launcher side of elastic imports no torch either."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import horovod_tpu_torch.runner.elastic\n"
        "import horovod_tpu_torch.runner.http.kv_server\n"
        "assert 'torch' not in sys.modules, 'launcher side imported torch'\n"
        "import horovod_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'horovod_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for n in ('horovod_tpu_torch.elastic', "
        "'horovod_tpu_torch.abort', 'horovod_tpu_torch.faults', "
        "'horovod_tpu_torch.runner.elastic.worker', "
        "'horovod_tpu_torch.runner.elastic.driver'):\n"
        "    assert n in names, n\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'horovod_tpu' or "
        "m.startswith('horovod_tpu.')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO_ROOT
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr
