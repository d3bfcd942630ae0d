"""The port's peer replica plane (``horovod_tpu_torch/peercheck.py``, the
``peerstate`` scope of its rendezvous server, ``PeerShardedState`` and the
ladder's ``peer`` rung) held against the JAX package's
(``horovod_tpu/peercheck.py``; the scenarios of ``tests/test_peercheck.py``):

- the wire format both ways: the same record encodes to the same bytes in
  both packages, each decodes the other's, and both refuse the same torn,
  truncated and corrupt blobs with the same reasons;
- ``ReplicaPool`` and ``checkpoint.rotate_slots`` leave the same slots
  after the same installs; ``assemble_records`` picks the same group, or
  raises the same error, on each record set of the reference's assembly
  and quarantine cases; ``checkpoint.assemble_full_params`` rebuilds the
  same full parameters from fsdp rows;
- the ``peerstate`` route: each package's client against the other's
  server answers 200/409/413/422 and keeps the slots as the reference's
  own pair does, and replicas one package publishes assemble in the other;
- ``PeerShardedState`` on 3 gloo ranks in sharded and in fsdp mode: the
  commit is shard-local, ``restore`` is pending and ``sync`` refuses, the
  peer restore equals the full state gathered at the commit byte for byte
  and ``sync`` installs it, a gap raises ``ReplicaUnavailableError``, and
  a replacement rank takes the survivors' state and commit counter;
- the ladder: on the four failure scripts of the reference's
  ``TestLadderPeerRung`` the port's loop makes the reference's calls;
- end to end under ``hvdrun-torch --cpu-mode``: one of 3 workers is
  SIGKILLed at epoch 2; both survivors recover on the peer rung with no
  durable read, rebuild the state of the last commit (its digest), and
  finish with the same parameters, those of an in-test replication of the
  schedule (3 ranks, then 2).
"""

import hashlib
import multiprocessing as mp
import os
import re
import stat
import subprocess
import sys
import time
from queue import Empty
from urllib.error import HTTPError

import numpy as np
import pytest
import torch

import horovod_tpu.elastic.runner as ref_runner
import horovod_tpu.elastic.state as ref_state
import horovod_tpu.exceptions as ref_exc
from horovod_tpu import basics as ref_basics
from horovod_tpu import checkpoint as ref_ckpt
from horovod_tpu import faults as ref_faults
from horovod_tpu import peercheck as ref_pc
from horovod_tpu.runner.http import kv_server as ref_kv
import horovod_tpu_torch.elastic.runner as port_runner
import horovod_tpu_torch.elastic.state as port_state
import horovod_tpu_torch.exceptions as port_exc
from horovod_tpu_torch import basics as port_basics
from horovod_tpu_torch import checkpoint as port_ckpt
from horovod_tpu_torch import faults as port_faults
from horovod_tpu_torch import peercheck as port_pc
from horovod_tpu_torch.runner.http import kv_server as port_kv

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO_ROOT, "tests", "torch_peer_worker.py")
PC = {"ref": ref_pc, "port": port_pc}
KV = {"ref": ref_kv, "port": port_kv}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("HOROVOD_FAULTS", "HOROVOD_PEER_RETAIN",
                 "HOROVOD_PEERCHECK_MAX_BYTES", "HOROVOD_SECRET_KEY",
                 "HOROVOD_INTEGRITY_INTERVAL", "HOROVOD_RENDEZVOUS_ADDR",
                 "HOROVOD_RENDEZVOUS_PORT"):
        monkeypatch.delenv(name, raising=False)
    for mod in (ref_faults, port_faults):
        mod.reset()
    for mod in (ref_pc, port_pc):
        mod.reset_for_testing()
    yield
    for mod in (ref_faults, port_faults):
        mod.reset()


def _record(pc, rank, step=1, generation=0, world=2, payload=b"shard-bytes",
            has_params=False):
    return pc.encode_record(pc.ReplicaRecord(
        rank=rank, step=step, generation=generation, world_size=world,
        payload=payload, has_params=has_params))


# -- wire format --------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_records_decode_in_the_other_package(writer, reader):
    blob = _record(PC[writer], 3, step=7, generation=2, world=4,
                   payload=bytes(range(256)) * 3, has_params=True)
    assert blob == _record(PC[reader], 3, step=7, generation=2, world=4,
                           payload=bytes(range(256)) * 3, has_params=True)
    rec = PC[reader].decode_record(blob, verify=True)
    assert (rec.rank, rec.step, rec.generation, rec.world_size,
            rec.has_params, rec.payload) == (
        3, 7, 2, 4, True, bytes(range(256)) * 3)
    assert PC[reader].verify_wire(blob) is None


def _flip(blob, at):
    b = bytearray(blob)
    b[at] ^= 0xFF
    return bytes(b)


BAD_BLOBS = {
    "corrupt_payload": lambda pc: _flip(_record(pc, 0, payload=b"a" * 8), -3),
    "truncated": lambda pc: _record(pc, 0, payload=b"a" * 100)[:-40],
    "no_header_line": lambda pc: b"garbage with no newline",
    "unparseable_header": lambda pc: b"{not json}\npayload",
    "no_magic": lambda pc: b'{"magic": "nope"}\nx',
    "header_incomplete": lambda pc: b'{"magic": "HVDPEER1", "rank": 0}\nx',
}


@pytest.mark.parametrize("kind", sorted(BAD_BLOBS))
def test_bad_blobs_are_refused_by_both(kind):
    blob = BAD_BLOBS[kind](port_pc)
    assert blob == BAD_BLOBS[kind](ref_pc)
    reasons = {name: pc.verify_wire(blob) for name, pc in PC.items()}
    assert reasons["port"] is not None
    assert reasons["port"] == reasons["ref"]
    for pc in PC.values():
        with pytest.raises(pc.ReplicaCorruptError):
            pc.decode_record(blob)


@pytest.mark.parametrize("name", sorted(PC))
def test_verify_injection_point(name):
    pc = PC[name]
    faults = {"ref": ref_faults, "port": port_faults}[name]
    blob = _record(pc, 0)
    faults.inject(faults.PEER_VERIFY, "drop", at=1, count=1)
    with pytest.raises(pc.ReplicaCorruptError, match="injected"):
        pc.decode_record(blob)
    assert pc.decode_record(blob).rank == 0


# -- pool and slots -----------------------------------------------------------


@pytest.mark.parametrize("depth", [None, "2"])
def test_pool_keeps_the_reference_slots(depth, monkeypatch):
    if depth is not None:
        monkeypatch.setenv("HOROVOD_PEER_RETAIN", depth)
    seen = {}
    for name, pc in PC.items():
        pool = pc.ReplicaPool()
        log = []
        for blob in (_record(pc, 1, step=1), _record(pc, 1, step=2),
                     _record(pc, 1, step=2),
                     _flip(_record(pc, 1, step=3), -1),
                     _record(pc, 0, step=1, has_params=True),
                     _record(pc, 1, step=3), _record(pc, 1, step=4)):
            try:
                log.append(("ok", pool.install(blob).step))
            except pc.ReplicaCorruptError as e:
                log.append(("corrupt", str(e)))
        seen[name] = (log, pool.summary(), pool.nbytes(),
                      [(r.rank, r.step) for r in pool.records()])
    assert seen["port"] == seen["ref"]
    assert seen["port"][1]["count"] == (3 if depth is None else 4)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_rotate_slots_matches_the_reference(depth):
    out = {}
    for name, mod in (("ref", ref_ckpt), ("port", port_ckpt)):
        store = {}
        for v in range(5):
            mod.rotate_slots(store, "r", v, prev_suffix=".prev", depth=depth)
            mod.rotate_slots(store, "q", -v, prev_suffix=".p", depth=depth)
        out[name] = store
    assert out["port"] == out["ref"]


# -- assembly -----------------------------------------------------------------

# name: ([(rank, step, generation, world)], current generation, quarantine)
ASSEMBLY = {
    "complete_set_sorted": ([(1, 4, 0, 2), (0, 4, 0, 2)], 0, None),
    "missing_rank": ([(0, 4, 0, 3), (2, 4, 0, 3)], 0, None),
    "wave_completes_from_prev": (
        [(0, 4, 0, 2), (1, 4, 0, 2), (0, 5, 0, 2)], 0, None),
    "future_generation_excluded": ([(0, 9, 5, 2), (1, 9, 5, 2)], 3, None),
    "future_generation_reached": ([(0, 9, 5, 2), (1, 9, 5, 2)], 6, None),
    "inconsistent_world_sizes": ([(0, 3, 0, 2), (1, 3, 0, 3)], 0, None),
    "nothing_visible": ([], 0, None),
    "newest_complete_wins": (
        [(r, s, g, 2) for r in (0, 1) for s, g in ((1, 0), (2, 0), (1, 1))]
        + [(0, 2, 1, 2)], 1, None),
    "prev_wave_spanning_condemned_range": (
        [(0, 5, 0, 2), (0, 4, 0, 2), (1, 4, 0, 2)], 0,
        {"1": {"generation": 0, "step": 4, "host": "h1"}}),
    "mixed_generation_condemned_old_wave": (
        [(0, 1, 1, 2), (0, 9, 0, 2), (1, 9, 0, 2)], 1,
        {"1": {"generation": 0, "step": 9, "host": "h1"}}),
    "clean_group_below_the_range": (
        [(r, s, 0, 2) for r in (0, 1) for s in (3, 4)], 0,
        {"1": {"generation": 0, "step": 4, "host": "h1"}}),
    "malformed_quarantine_fails_closed": (
        [(0, 4, 0, 2), (1, 4, 0, 2)], 0,
        {"1": {"generation": "corrupted", "step": None}}),
    "newer_generation_is_another_owner": (
        [(0, 1, 1, 2), (1, 1, 1, 2)], 1,
        {"1": {"generation": 0, "step": 7, "host": "h1"}}),
    "back_dated_range": (
        [(r, s, 0, 2) for r in (0, 1) for s in (2, 3, 4)], 0,
        {"0": {"generation": 0, "step": 4, "from_step": 3}}),
}


def _assemble(pc, records, current, quarantine):
    recs = [pc.ReplicaRecord(rank=r, step=s, generation=g, world_size=w,
                             payload=b"shard-%d-%d-%d" % (r, s, g))
            for r, s, g, w in records]
    try:
        got = pc.assemble_records(recs, current, quarantine=quarantine)
        return ("ok", [(m.rank, m.step, m.generation, m.payload)
                       for m in got])
    except pc.ReplicaUnavailableError as e:
        return ("unavailable", str(e))


@pytest.mark.parametrize("case", sorted(ASSEMBLY))
def test_assembly_picks_the_reference_group(case):
    records, current, quarantine = ASSEMBLY[case]
    ref = _assemble(ref_pc, records, current, quarantine)
    assert _assemble(port_pc, records, current, quarantine) == ref
    if case in ("complete_set_sorted", "wave_completes_from_prev",
                "future_generation_reached", "clean_group_below_the_range",
                "newer_generation_is_another_owner"):
        assert ref[0] == "ok", ref


@pytest.mark.parametrize("world", [1, 3])
def test_assemble_full_params_rebuilds_the_reference_params(world):
    from horovod_tpu.parallel import param_sharding as ref_ps
    from horovod_tpu_torch.parallel import param_sharding as port_ps

    rng = np.random.RandomState(0)
    full = [rng.randn(5, 3).astype(np.float32),
            rng.randn(7).astype(np.float32), np.float32(2.5) * np.ones(
                (2, 2, 2), np.float32)]
    ref_sp = ref_ps.shard_params(full, world)
    port_sp = port_ps.shard_params([torch.from_numpy(a) for a in full],
                                   world)
    for r in range(world):
        for a, b in zip(ref_sp.row(r), port_sp.row(r)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ref_out, _ = ref_ckpt.assemble_full_params(
        [{"param_layout": "row", "param_row": ref_sp.row(r),
          "param_meta": ref_sp.meta} for r in range(world)])
    port_out, template = port_ckpt.assemble_full_params(
        [{"param_layout": "row", "param_row": port_sp.row(r),
          "param_meta": port_sp.meta if r == world - 1 else None}
         for r in range(world)])
    assert template.world_size == world
    for a, b in zip(ref_out, port_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    params = {"w": torch.ones(2)}
    assert port_ckpt.assemble_full_params(
        [{"params": None}, {"params": params}]) == (params, params)
    for payloads in ([{"params": None}],
                     [{"param_layout": "row", "param_row": None,
                       "param_meta": port_sp.meta}]):
        with pytest.raises(ValueError):
            port_ckpt.assemble_full_params(payloads)


# -- the peerstate route ------------------------------------------------------


def _answer(fn):
    try:
        return ("ok", fn())
    except HTTPError as e:
        return ("http", e.code, e.read())


def _route_sequence(server, client_name, monkeypatch):
    kv, pc = KV[client_name], PC[client_name]
    c = kv.KVClient("127.0.0.1", server.port, timeout=5.0, retries=1)
    scope = "peerstate"
    out = [_answer(lambda: c.put(scope, "0", _record(pc, 0, step=1))),
           _answer(lambda: c.put(scope, "0", _record(pc, 0, step=2))),
           _answer(lambda: c.put(scope, "1", _record(pc, 1, step=2))),
           _answer(lambda: c.keys(scope)),
           _answer(lambda: c.get(scope, "0")),
           _answer(lambda: c.get(scope, "0.prev"))]
    # A flipped record: 422 with the reason, the slots untouched.
    out.append(_answer(lambda: c.put(scope, "0", _flip(
        _record(pc, 0, step=3), -1))))
    out.append(_answer(lambda: c.put(scope, "0", b"torn")))
    out.append(_answer(lambda: c.get(scope, "0")))
    out.append(_answer(lambda: c.keys(scope)))
    # Oversize: 413, read and dropped.
    monkeypatch.setenv("HOROVOD_PEERCHECK_MAX_BYTES", "1024")
    out.append(_answer(lambda: c.put(scope, "2", _record(
        pc, 2, payload=b"x" * 4096))))
    monkeypatch.delenv("HOROVOD_PEERCHECK_MAX_BYTES")
    # The generation fence: the world moved to generation 1.
    server.publish_epoch("world", {})
    zombie = kv.KVClient("127.0.0.1", server.port, timeout=5.0, retries=1,
                         generation_fn=lambda: 0)
    fresh = kv.KVClient("127.0.0.1", server.port, timeout=5.0, retries=1,
                        generation_fn=lambda: 1)
    out.append(_answer(lambda: zombie.put(scope, "0", _record(
        pc, 0, step=99))))
    out.append(("fenced", server.fenced_writes))
    out.append(_answer(lambda: fresh.put(scope, "0", _record(
        pc, 0, step=3, generation=1))))
    out.append(_answer(lambda: c.keys(scope)))
    out.append(_answer(lambda: [pc.decode_record(c.get(scope, k)).step
                                for k in c.keys(scope)]))
    return out


def test_peerstate_route_answers_as_the_reference(monkeypatch):
    runs = {}
    for name, server_kv, client in (("ref-ref", ref_kv, "ref"),
                                    ("port-client", ref_kv, "port"),
                                    ("port-server", port_kv, "ref")):
        server = server_kv.RendezvousServer(host="127.0.0.1")
        server.start()
        try:
            runs[name] = _route_sequence(server, client, monkeypatch)
        finally:
            server.stop()
    assert runs["port-client"] == runs["ref-ref"]
    assert runs["port-server"] == runs["ref-ref"]
    codes = [a[1] for a in runs["ref-ref"] if a[0] == "http"]
    assert sorted(set(codes)) == [409, 413, 422], runs["ref-ref"]


@pytest.mark.parametrize("server_name", ["ref", "port"])
def test_replicas_assemble_across_packages(server_name):
    """Each package's replicator publishes to one server; the other
    package's replicator assembles the set, and a dropped replication
    degrades without raising."""
    server = KV[server_name].RendezvousServer(host="127.0.0.1")
    server.start()
    try:
        reps = {}
        for rank, name in ((0, "port"), (1, "ref")):
            reps[name] = PC[name].PeerReplicator(
                client=KV[name].KVClient("127.0.0.1", server.port),
                rank=rank, world_size_fn=lambda: 2,
                generation_fn=lambda: 0)
        assert reps["port"].replicate(b"rank0-shard", step=1,
                                      has_params=True)
        assert reps["ref"].replicate(b"rank1-shard", step=1)
        # K = 1 ring: rank 1 holds rank 0's record.
        assert reps["ref"].pool.get(0).has_params
        port_view = PC["port"].PeerReplicator(
            client=KV["port"].KVClient("127.0.0.1", server.port), rank=1,
            world_size_fn=lambda: 2, generation_fn=lambda: 0)
        assert [r.payload for r in port_view.assemble()] == [
            b"rank0-shard", b"rank1-shard"]
        assert port_view.latest_step(before_generation=1) == 1
        assert port_view.latest_step(before_generation=0) == 0
        port_faults.inject(port_faults.PEER_REPLICATE, "drop", at=1)
        assert reps["port"].replicate(b"dropped", step=2) is False
        assert reps["port"].replicate(b"landed", step=3) is True
        port_faults.inject(port_faults.PEER_CORRUPT, "corrupt", at=1)
        # A flip on the wire: the server refuses it (422) and keeps step 3.
        assert reps["port"].replicate(b"flipped", step=4) is False
        assert port_pc.decode_record(KV["port"].KVClient(
            "127.0.0.1", server.port).get("peerstate", "0")).step == 3
    finally:
        server.stop()


# -- PeerShardedState on gloo -------------------------------------------------

SPAWN_WORLD = 3


def _digest(flat, opt_state):
    h = hashlib.sha256()
    for t in flat:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    for i in sorted(opt_state["state"]):
        for k in sorted(opt_state["state"][i]):
            h.update(opt_state["state"][i][k].detach().cpu().contiguous()
                     .numpy().tobytes())
    return h.hexdigest()


def _state_worker(rank, mode, tmp, port, queue):
    os.environ.update(HOROVOD_NUM_PROCESSES=str(SPAWN_WORLD),
                      HOROVOD_PROCESS_ID=str(rank),
                      HOROVOD_RENDEZVOUS_ADDR="127.0.0.1",
                      HOROVOD_RENDEZVOUS_PORT=str(port),
                      HOROVOD_WORLD_VERSION="0")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import peercheck
    from horovod_tpu_torch.optimizer import unshard_opt_state

    hvd.init(device="cpu", init_method=f"file://{tmp}/rdv_{mode}")
    out = {}

    def build():
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Tanh(),
                                    torch.nn.Linear(7, 3))
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=0.05), sync_mode=mode)
        return model, opt

    def flat_params(model, opt):
        return (opt.full_parameters() if mode == "fsdp"
                else [p.detach().clone() for p in opt._params])

    def gathered(model, opt):
        flat = flat_params(model, opt)
        stacked = hvd.gather_sharded_state(opt)
        return hvd.broadcast_object(
            None if stacked is None
            else _digest(flat, unshard_opt_state(opt, stacked)))

    model, opt = build()
    names = {id(p): n for n, p in model.named_parameters()}
    step = hvd.make_train_step(model, lambda m, b: (m(b) ** 2).mean(), opt)
    st = hvd.elastic.PeerShardedState(model=model, optimizer=opt, epoch=0)
    for e in range(2):
        x = torch.from_numpy(np.random.RandomState(10 * e + rank)
                             .randn(4, 5).astype(np.float32))
        step(x)
        st.epoch += 1
        st.commit()
    want = gathered(model, opt)
    import pickle

    rec = pickle.loads(st._replicator.pool.get(rank).payload)
    out["row_numel"] = sum(v.numel() for s in rec["row"]["state"].values()
                           for v in s.values() if v.dim() > 0)
    out["param_row_numel"] = sum(
        t.numel() for t in (rec["param_row"] or []))
    out["carries_params"] = rec["params"] is not None
    out["full_numel"] = sum(torch.Size(shape).numel() for shape in (
        opt.meta.shapes if mode == "fsdp" else [p.shape for p in opt._params]))
    # A diverged live value: the replicas hold the commit's.
    st.epoch = 99
    st.restore()
    out["pending"] = (st.peer_restore_pending(), st.needs_world_sync())
    try:
        st.sync()
        out["refused"] = None
    except hvd.HorovodInternalError as e:
        out["refused"] = str(e)
    out["restored"] = st.restore_peer()
    full = st._full
    flat = (full["flat"] if mode == "fsdp"
            else [full["params"][names[id(p)]] for p in opt._params])
    out["peer_digest"] = _digest(flat, full["opt"])
    out["want"] = want
    out["epoch"] = st.epoch
    st.sync()
    out["installed"] = gathered(model, opt)
    # A gap: rank 0 drops the scope, every pool keeps its own record only.
    hvd.barrier()
    if rank == 0:
        st._replicator.client().delete_scope("peerstate")
    hvd.barrier()
    own = st._replicator.pool.get(rank)
    st._replicator.pool.clear()
    st._replicator.pool.install(own)
    st.restore()
    try:
        st.restore_peer()
        out["gap"] = None
    except peercheck.ReplicaUnavailableError as e:
        out["gap"] = str(e)
    # A replacement: the world moves to generation 1; ranks 0 and 1 hold
    # the state from their peers, rank 2 starts afresh.
    for s in (st,):
        s._replicator.pool.clear()
    hvd.barrier()
    st.epoch = 2
    st._peer_dirty = False
    st.commit()  # a complete set at generation 0 again
    hvd.barrier()
    os.environ["HOROVOD_WORLD_VERSION"] = "1"
    before = st._commit_seq
    if rank == 2:
        hvd.barrier()
        model, opt = build()
        st = hvd.elastic.PeerShardedState(model=model, optimizer=opt,
                                          epoch=0)
        out["fresh_seq"] = st._commit_seq
    else:
        st.restore()
        st.restore_peer()
        hvd.barrier()
    st.sync()
    out["after_sync"] = (before, st._commit_seq, st.epoch)
    out["replacement_state"] = gathered(model, opt)
    out["assembled"] = [(r.rank, r.generation, r.step)
                        for r in st._replicator.assemble()]
    queue.put((rank, out))
    hvd.shutdown()


@pytest.fixture(scope="module", params=["sharded", "fsdp"])
def state_runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"peer_state_{request.param}")
    server = port_kv.RendezvousServer(host="127.0.0.1")
    server.start()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_state_worker,
                         args=(r, request.param, str(tmp), server.port,
                               queue))
             for r in range(SPAWN_WORLD)]
    results = {}
    try:
        for p in procs:
            p.start()
        deadline = time.time() + 120
        while len(results) < len(procs) and time.time() < deadline:
            try:
                rank, out = queue.get(timeout=1)
                results[rank] = out
            except Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        server.stop()
    assert all(p.exitcode == 0 for p in procs) and len(results) == len(
        procs), [p.exitcode for p in procs]
    return request.param, [results[r] for r in range(SPAWN_WORLD)]


def test_commit_is_shard_local(state_runs):
    mode, runs = state_runs
    for r, out in enumerate(runs):
        # AdamW's two moments, a third of each parameter (rounded up).
        assert out["full_numel"] * 2 // 3 <= out["row_numel"] <= (
            out["full_numel"] * 2 // 3 + 2 * 4)
        if mode == "fsdp":
            assert out["row_numel"] == 2 * out["param_row_numel"]
            assert out["carries_params"] == (r == 0)  # rank 0: buffers
        else:
            assert out["param_row_numel"] == 0
            assert out["carries_params"] == (r == 0)


def test_restore_is_pending_and_sync_refuses(state_runs):
    _, runs = state_runs
    for out in runs:
        assert out["pending"] == (True, True)
        assert out["refused"] is not None and "peer" in out["refused"]


def test_peer_restore_equals_the_gathered_commit(state_runs):
    _, runs = state_runs
    want = runs[0]["want"]
    for out in runs:
        assert out["restored"] is True
        assert out["want"] == want
        assert out["peer_digest"] == want
        assert out["installed"] == want
        assert out["epoch"] == 2


def test_a_gap_is_unavailable(state_runs):
    _, runs = state_runs
    for out in runs:
        assert out["gap"] is not None and "missing ranks" in out["gap"]


def test_a_replacement_rank_takes_the_state_and_the_counter(state_runs):
    _, runs = state_runs
    assert runs[2]["fresh_seq"] == 1
    before = runs[0]["after_sync"][0]
    states = {out["replacement_state"] for out in runs}
    assert len(states) == 1
    for out in runs:
        # Realigned to the newest commit of generation 0, then committed
        # once at generation 1; the extras are rank 0's.
        assert out["after_sync"] == (before, before + 1, 2)
        assert out["assembled"] == [(r, 1, before + 1) for r in range(3)]


# -- the ladder ---------------------------------------------------------------

PACKAGES = {"ref": (ref_basics, ref_runner, ref_state, ref_exc, ref_pc),
            "port": (port_basics, port_runner, port_state, port_exc,
                     port_pc)}


def _ladder(name, script, monkeypatch):
    """One failure script through one package's loop: the calls it made."""
    import time

    basics, runner, state_mod, exc, pc = PACKAGES[name]
    calls: list = []
    world = {"up": True}

    def init(*a, **k):
        calls.append("init")
        world["up"] = True

    def shutdown():
        calls.append("shutdown")
        world["up"] = False

    monkeypatch.setattr(basics, "init", init)
    monkeypatch.setattr(basics, "shutdown", shutdown)
    monkeypatch.setattr(basics, "is_initialized", lambda: world["up"])
    monkeypatch.setattr(basics, "size", lambda: 2)
    monkeypatch.setattr(time, "sleep", lambda s: calls.append("sleep"))
    monkeypatch.setenv("HOROVOD_RECOVERY_BACKOFF_MAX", "0.1")
    monkeypatch.delenv("HOROVOD_RECOVERY_MAX_ATTEMPTS", raising=False)

    class Recording(state_mod.State):
        def __init__(self):
            super().__init__()
            self.dirty = False

        def commit(self):
            calls.append("commit")
            self.check_host_updates()

        def restore(self):
            calls.append("restore")
            self.dirty = script["pending"]

        def sync(self):
            calls.append("sync")
            if self.dirty:
                raise exc.HorovodInternalError("pending")

        def peer_restore_pending(self):
            return self.dirty and self.peer_restore_armed()

    state = Recording()

    def peer():
        calls.append("peer")
        if script["peer"] == "fails":
            raise pc.ReplicaUnavailableError("replica gap")
        state.dirty = False

    if script["peer"] is not None:
        state.register_peer_restore(peer)
    state.register_durable_restore(lambda: calls.append("durable"))
    failures = []

    def train(st):
        calls.append("train")
        if len(failures) < script["failures"]:
            failures.append(1)
            raise exc.HorovodInternalError("boom")
        return "recovered"

    try:
        result = runner.run(train)(state)
    finally:
        runner.notification_manager.clear()
    return calls, result


LADDER = {
    "peer_between_sync_and_durable": dict(failures=3, peer="ok",
                                          pending=False),
    "peer_failure_falls_through": dict(failures=3, peer="fails",
                                       pending=False),
    "unarmed_skips_to_durable": dict(failures=3, peer=None, pending=False),
    "pending_jumps_to_peer": dict(failures=1, peer="ok", pending=True),
}


@pytest.mark.parametrize("script", sorted(LADDER))
def test_the_peer_rung_makes_the_reference_calls(script, monkeypatch):
    ref = _ladder("ref", LADDER[script], monkeypatch)
    port = _ladder("port", LADDER[script], monkeypatch)
    assert port == ref
    calls, result = port
    assert result == "recovered"
    rungs = [c for c in calls if c in ("peer", "durable")]
    assert rungs == {"peer_between_sync_and_durable": ["peer"],
                     "peer_failure_falls_through": ["peer", "durable"],
                     "unarmed_skips_to_durable": ["durable"],
                     "pending_jumps_to_peer": ["peer"]}[script]


# -- end to end ---------------------------------------------------------------

LINE = re.compile(r"gen=(\d+) host=(\S+) rank=(\d+) epoch=(\d+) np=(\d+) "
                  r"loss=([-0-9.e]+)")
EPOCHS = 6


def expected_weights(world_at):
    """The worker's schedule in plain torch: epoch e averages the
    gradients of ``world_at(e)`` ranks, rank r on its rows of the batch;
    AdamW. The full parameters after the last epoch, flattened."""
    sys.path.insert(0, os.path.join(REPO_ROOT, "tests"))
    import torch_peer_worker as m

    model = m.build_model()
    opt = torch.optim.AdamW(model.parameters(), lr=m.LR, weight_decay=m.WD)
    for e in range(EPOCHS):
        n = world_at(e)
        grads = [torch.zeros_like(p) for p in model.parameters()]
        for r in range(n):
            model.zero_grad()
            m.loss_fn(model, m.batch(e)[r * 16 // n:(r + 1) * 16 // n]
                      ).backward()
            for g, p in zip(grads, model.parameters()):
                g += p.grad / n
        for g, p in zip(grads, model.parameters()):
            p.grad = g
        opt.step()
    return np.concatenate([p.detach().numpy().ravel()
                           for p in model.parameters()])


def hosts_script(tmp_path, hosts):
    hosts_file = tmp_path / "hosts.txt"
    hosts_file.write_text("\n".join(hosts) + "\n")
    script = tmp_path / "discover.sh"
    script.write_text(f"#!/bin/sh\ncat {hosts_file}\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def launch_argv(script, np_, min_np, max_np):
    return [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
            "-np", str(np_), "--min-np", str(min_np), "--max-np",
            str(max_np), "--cpu-mode", "--host-discovery-script", script,
            "--elastic-timeout", "60", sys.executable, WORKER]


def worker_env(tmp_path, mode, sync, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "JAX_", "XLA_"))}
    env.update({"PYTHONPATH": REPO_ROOT, "PEER_TEST_MODE": mode,
                "PEER_TEST_SYNC": sync, "PEER_TEST_TMP": str(tmp_path),
                "HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT": "15",
                "HOROVOD_RECOVERY_BACKOFF_MAX": "0.2",
                "HOROVOD_ABORT_POLL_INTERVAL": "0.2", **extra})
    return env


def final_weights(text):
    return {host: np.array(eval(w)) for host, w in re.findall(
        r"host=(\S+) finished at epoch 6 weights=(\[.*\])", text)}


@pytest.mark.parametrize("sync", ["sharded", "fsdp"])
def test_sigkilled_worker_recovers_on_the_peer_rung(sync, tmp_path):
    script = hosts_script(tmp_path, ["localhost", "127.0.0.1", "127.0.0.2"])
    out = subprocess.run(launch_argv(script, 3, 2, 3),
                         env=worker_env(tmp_path, "kill", sync),
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO_ROOT)
    text = out.stdout + out.stderr
    assert out.returncode == 0, text
    assert "host=127.0.0.1 dying at epoch 2" in text, text
    assert "DURABLE_RESTORE_USED" not in text, text
    assert "recovery rung 'durable'" not in text, text
    commits = dict(re.findall(r"COMMIT epoch=(\d+) digest=(\w+)", text))
    restored = re.findall(r"PEER_RESTORED host=(\S+) epoch=(\d+) "
                          r"digest=(\w+)", text)
    # Both survivors rebuilt the state of the commit of epoch 2.
    assert sorted(h for h, _, _ in restored) == ["127.0.0.2", "localhost"]
    for _, epoch, digest in restored:
        assert epoch == "2" and digest == commits["2"], (restored, commits)
    seen = {(int(m[3]), m[1]): (int(m[0]), int(m[4]))
            for m in LINE.findall(text)}
    for (epoch, host), (gen, n) in seen.items():
        assert n == (3 if epoch < 2 else 2), (epoch, host, n)
        assert gen == (1 if epoch < 2 else 2), (epoch, host, gen)
    weights = final_weights(text)
    assert sorted(weights) == ["127.0.0.2", "localhost"], text
    np.testing.assert_array_equal(weights["localhost"],
                                  weights["127.0.0.2"])
    np.testing.assert_allclose(
        weights["localhost"], expected_weights(lambda e: 3 if e < 2 else 2),
        rtol=1e-5, atol=1e-6)
