"""The port's integrity plane (``horovod_tpu_torch/integrity.py``) held
against the JAX package's (``horovod_tpu/integrity.py``) on the same
inputs.

- Fingerprints: the same numpy trees give the reference's digests and
  summaries exactly, and so do the same trees of torch tensors (float32,
  bfloat16 against ``ml_dtypes``' bfloat16); records cover what they should
  in each sync mode; an unarmed hook is inert; the interval gate follows
  the caller's step.
- The ``corrupt`` fault mode and the ``grad.corrupt`` injector: the same
  seed flips the reference's bits; the saved copy changes, the live state
  never does (a ``TorchState`` commit on one gloo rank); a ``peer.corrupt``
  record is refused at install.
- Votes: the record sets of the reference's voting tests give its
  verdicts field for field through ``vote`` and ``vote_latest``.
- The tripwire: burst dedup counts a step once; ``abort`` posts the KV
  record; on four gloo ranks every sync mode (allreduce, sharded, the
  int8 wire) skips the poisoned step, counts, journals and arms the abort
  alike on every rank.
- The spike detector trips where the reference's trips, with its trend;
  ``@hvd.elastic.run`` rewinds without a ladder step, the storm breaker
  escalates, a commit resets it (the same calls as the reference's loop),
  and the metric counts; the precommit block holds when a plane is armed.
- The KV plane: ``GET /integrity`` cold and warm, malformed heartbeats,
  the zombie record, quarantine fencing and its lifting by a newer
  generation, the live-vote fence, the assembly filter, the scrape's
  families; the worker's heartbeat piggyback.
- The driver's two-voter continuity rule.
"""

import json
import multiprocessing as mp
import os
import signal
import time
import urllib.request
from urllib.error import HTTPError

import numpy as np
import pytest
import torch

from horovod_tpu import faults as ref_faults
from horovod_tpu import integrity as ref
from horovod_tpu_torch import abort, faults, integrity, peercheck
from horovod_tpu_torch import metrics as port_metrics
from horovod_tpu_torch.exceptions import (HorovodInternalError,
                                          LossSpikeError)
from horovod_tpu_torch.runner.http.kv_server import (PEERSTATE_SCOPE,
                                                     KVClient,
                                                     RendezvousServer)

KNOBS = ("HOROVOD_INTEGRITY_INTERVAL", "HOROVOD_NONFINITE_ACTION",
         "HOROVOD_LOSS_SPIKE_SIGMA", "HOROVOD_LOSS_SPIKE_WARMUP",
         "HOROVOD_REWIND_MAX", "HOROVOD_FAULTS", "HOROVOD_EVENT_LOG",
         "HOROVOD_RENDEZVOUS_ADDR", "HOROVOD_RENDEZVOUS_PORT",
         "HOROVOD_INTEGRITY_ACTION", "HOROVOD_INTEGRITY_CONFIRMATIONS")


@pytest.fixture(autouse=True)
def _clean_planes(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for mod in (faults, ref_faults):
        mod.reset()
    abort.reset()
    integrity.reset_for_testing()
    ref.reset_for_testing()
    yield
    for mod in (faults, ref_faults):
        mod.reset()
    abort.reset()
    integrity.reset_for_testing()
    ref.reset_for_testing()


def _tensors(tree):
    """The same tree with every numpy array as a torch tensor."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


# -- Fingerprints ------------------------------------------------------------


def _flipped():
    y = np.ones(8, np.float32)
    y.view(np.uint8)[3] ^= 1
    return y


TREES = {
    "key_order": ({"b": np.arange(4, dtype=np.float32),
                   "a": np.ones((2, 2), np.float32)}),
    "reshaped": {"x": np.arange(4, dtype=np.float32).reshape(2, 2)},
    "reinterpreted": {"x": np.arange(4, dtype=np.float32).view(np.int32)},
    "one_bit": _flipped(),
    "nonfinite": {"a": np.array([1.0, np.nan, np.inf, 2.0], np.float32),
                  "b": np.ones(4, np.float32)},
    "twenty_leaves": {f"l{i}": np.full(3, i, np.float32) for i in range(20)},
    "mixed": {"w": np.linspace(-1, 1, 7).astype(np.float32),
              "count": np.arange(5, dtype=np.int64),
              "lr": 0.1, "flag": None, "half": np.ones(3, np.float16),
              "groups": [{"params": [0, 1], "betas": (0.9, 0.999)}]},
    "empty_leaf": {"e": np.zeros((0, 3), np.float32),
                   "s": np.float32(2.5) * np.ones(())},
}


@pytest.mark.parametrize("case", sorted(TREES))
def test_digests_and_summaries_match_the_reference(case):
    tree = TREES[case]
    want = (ref.digest_tree(tree), ref.summarize_tree(tree),
            ref.summarize_tree(tree, buckets=1))
    got = (integrity.digest_tree(tree), integrity.summarize_tree(tree),
           integrity.summarize_tree(tree, buckets=1))
    assert got == want
    as_tensors = _tensors(tree)
    assert (integrity.digest_tree(as_tensors),
            integrity.summarize_tree(as_tensors),
            integrity.summarize_tree(as_tensors, buckets=1)) == want


def test_digest_guards_order_shape_dtype_and_bits():
    d = integrity.digest_tree
    a = TREES["key_order"]
    assert d(a) == d({"a": a["a"], "b": a["b"]})
    flat = np.arange(4, dtype=np.float32)
    assert len({d({"x": flat}), d(TREES["reshaped"]),
                d(TREES["reinterpreted"])}) == 3
    assert d(np.ones(8, np.float32)) != d(TREES["one_bit"])
    out = integrity.summarize_tree(TREES["nonfinite"], buckets=1)
    assert out == [{"n": 8, "finite": 6, "l2": pytest.approx(3.0)}]
    buckets = integrity.summarize_tree(TREES["twenty_leaves"])
    assert 1 <= len(buckets) <= integrity.SUMMARY_BUCKETS
    assert sum(b["n"] for b in buckets) == 60


def test_bfloat16_tensors_match_ml_dtypes_bfloat16():
    """A bfloat16 tensor digests, summarizes and corrupts as the
    reference's ml_dtypes bfloat16 array of the same bits."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    bf16 = ml_dtypes.bfloat16
    arr = np.linspace(-3, 3, 16).astype(bf16)
    arr[3] = float("nan")
    t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    assert integrity.digest_tree({"w": t}) == ref.digest_tree({"w": arr})
    s = integrity.summarize_tree({"w": t})
    assert s == ref.summarize_tree({"w": arr})
    assert s[0]["n"] == 16 and s[0]["finite"] == 15
    for mod in (ref_faults, faults):
        mod.inject(mod.GRAD_CORRUPT, "corrupt", arg=64, at=1, count=1)
    got = integrity.maybe_corrupt_snapshot(
        {"params": {"w": torch.ones(64, dtype=torch.bfloat16)}})
    want = ref.maybe_corrupt_snapshot({"params": {"w": np.ones(64, bf16)}})
    w = got["params"]["w"]
    assert w.dtype == torch.bfloat16
    assert w.view(torch.uint16).numpy().tobytes() == \
        want["params"]["w"].tobytes() != np.ones(64, bf16).tobytes()


def _record_fields(rec):
    return {k: v for k, v in rec.items() if k != "t"}


def test_records_match_the_reference_in_every_mode():
    params = {"w": np.linspace(0, 1, 4).astype(np.float32),
              "b": np.ones(3, np.float32)}
    opt = {"m": np.zeros(4, np.float32), "step": np.array(3, np.int64)}
    shard = [np.full(2, 0.5, np.float32)]
    for mode, o, sh in (("allreduce", opt, None), ("sharded", opt, shard),
                        ("fsdp", None, shard)):
        kw = dict(step=3, sync_mode=mode, shard=sh, rank=1, host="h",
                  generation=2)
        want = _record_fields(ref.make_record(params, o, **kw))
        assert _record_fields(integrity.make_record(params, o, **kw)) == want
        assert _record_fields(integrity.make_record(
            _tensors(params), _tensors(o),
            **dict(kw, shard=_tensors(sh)))) == want
    rec = integrity.make_record
    ar = rec(params, opt, step=3)
    assert ar["digest"] != rec(params, {"m": np.ones(4, np.float32)},
                               step=3)["digest"]
    sh = rec(params, opt, 3, sync_mode="sharded", shard=shard)
    assert sh["digest"] == rec(params, {"m": np.ones(4, np.float32)}, 3,
                               sync_mode="sharded", shard=shard)["digest"]
    fs = rec(params, None, 3, sync_mode="fsdp", shard=shard)
    assert fs["digest"] is None and fs["shard_digest"] and fs["summaries"]


def test_records_are_named_by_the_elastic_worker(monkeypatch):
    monkeypatch.setenv("HOROVOD_HOSTNAME", "node-a")
    assert integrity.make_record({"w": np.ones(1)}, None, 1)["host"] == \
        "node-a"
    monkeypatch.setenv("HOROVOD_ELASTIC_WORKER", "node-a:1")
    assert integrity.make_record({"w": np.ones(1)}, None, 1)["host"] == \
        "node-a:1"


def test_unarmed_fingerprint_is_inert_and_the_gate_follows_the_step(
        monkeypatch):
    for mod in (ref, integrity):
        assert mod.maybe_fingerprint({"w": np.ones(2)}, None, 1) is None
        assert mod.heartbeat_payload() is None
        assert mod.summary()["checks"] == 0
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "2")
    out = {}
    for name, mod in (("ref", ref), ("port", integrity)):
        p = {"w": np.ones(4, np.float32)}
        seq = [mod.maybe_fingerprint(p, None, s) for s in (7, 8, 9)]
        seq.append(mod.maybe_fingerprint(
            {"w": 2 * np.ones(4, np.float32)}, None, 10))
        assert seq[0] is None and seq[2] is None
        assert seq[3]["prev"]["digest"] == seq[1]["digest"]
        assert seq[3]["prev"]["l2"] == [b["l2"] for b in seq[1]["summaries"]]
        assert mod.heartbeat_payload() is seq[3]
        out[name] = [None if r is None else _record_fields(r) for r in seq]
        out[name + "_summary"] = mod.summary()
    assert out["port"] == out["ref"]
    assert out["port_summary"] == out["ref_summary"]
    assert integrity.last_fingerprint_seconds() is not None


# -- The corrupt fault mode and the snapshot injector -------------------------


def test_corrupt_mode_flips_the_references_bits():
    data = bytes(range(256)) * 4
    assert faults.flip_bits(data, 16, "x#1") == ref_faults.flip_bits(
        data, 16, "x#1") != data
    for mod in (faults, ref_faults):
        mod.inject(mod.GRAD_CORRUPT, "corrupt", arg=8, at=2, count=1)
    got = [faults.corrupt_payload(faults.GRAD_CORRUPT, data)
           for _ in range(3)]
    want = [ref_faults.corrupt_payload(ref_faults.GRAD_CORRUPT, data)
            for _ in range(3)]
    assert got == want and got[0] == data != got[1] and got[2] == data
    spec = ("grad.corrupt=corrupt:16@2x3,policy.decide=drop@1;"
            "spare.promote=raise@2x3")
    assert faults.parse_spec(spec) == [
        faults.FaultSpec(**vars(s)) for s in ref_faults.parse_spec(spec)]
    assert (faults.GRAD_CORRUPT, faults.POLICY_DECIDE,
            faults.SPARE_PROMOTE) == (ref_faults.GRAD_CORRUPT,
                                      ref_faults.POLICY_DECIDE,
                                      ref_faults.SPARE_PROMOTE)
    faults.reset()
    faults.inject(faults.GRAD_CORRUPT, "corrupt", at=1, count=1)
    assert faults.armed(faults.GRAD_CORRUPT)
    assert faults.hits(faults.GRAD_CORRUPT) == 0
    assert faults.fire(faults.GRAD_CORRUPT) is False  # never a drop


def _snapshot():
    return {"params": {"w": np.ones(8, np.float32),
                       "b": np.arange(3, dtype=np.float32)},
            "opt_state": [np.zeros(8, np.float32)], "epoch": 3}


def test_snapshot_corruption_matches_the_reference_and_spares_the_input():
    saved = _snapshot()
    assert integrity.maybe_corrupt_snapshot(saved) is saved  # unarmed
    for mod in (ref_faults, faults):
        mod.inject(mod.GRAD_CORRUPT, "corrupt", arg=16, at=1, count=2)
    want = ref.maybe_corrupt_snapshot(_snapshot())
    live = _snapshot()
    got = integrity.maybe_corrupt_snapshot(dict(live))
    assert integrity.digest_tree(got) == ref.digest_tree(want)
    assert not np.array_equal(got["params"]["b"], live["params"]["b"])
    assert got["epoch"] == 3
    # The inputs: not a byte written, and their containers kept.
    assert integrity.digest_tree(live) == integrity.digest_tree(_snapshot())
    tensors = _tensors(_snapshot())
    before = {k: v.clone() for k, v in tensors["params"].items()}
    got_t = integrity.maybe_corrupt_snapshot(dict(tensors))
    assert integrity.digest_tree(got_t) == ref.digest_tree(
        ref.maybe_corrupt_snapshot(_snapshot()))
    assert all(torch.equal(tensors["params"][k], v)
               for k, v in before.items())


def test_torch_state_commit_corrupts_the_saved_copy_only(monkeypatch):
    """A TorchState commit with grad.corrupt armed: the fingerprint sees
    the corrupted copy, the saved model holds it, and the live model and
    optimizer never change."""
    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "1")
    hvd.init(device="cpu")
    try:
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 3)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
        model(torch.ones(2, 4)).sum().backward()
        opt.step()
        state = hvd.elastic.TorchState(model=model, optimizer=opt, epoch=0)
        clean = integrity.heartbeat_payload()
        live = {k: v.clone() for k, v in model.state_dict().items()}
        live_opt = {i: s["momentum_buffer"].clone()
                    for i, s in opt.state_dict()["state"].items()}
        faults.inject(faults.GRAD_CORRUPT, "corrupt", arg=16, at=1, count=1)
        state.commit()
        rec = integrity.heartbeat_payload()
        assert rec["step"] == clean["step"] + 1
        assert rec["digest"] != clean["digest"]
        assert rec["digest"] == integrity.digest_tree(
            (state._saved_model, state._saved_opt))
        assert any(not torch.equal(state._saved_model[k], v)
                   for k, v in live.items())
        assert all(torch.equal(model.state_dict()[k], v)
                   for k, v in live.items())
        assert all(torch.equal(opt.state_dict()["state"][i]
                               ["momentum_buffer"], v)
                   for i, v in live_opt.items())
        opt.remove_hooks()
    finally:
        hvd.shutdown()


def test_a_peer_corrupt_record_is_refused_at_install():
    server = RendezvousServer()
    server.start()
    try:
        client = KVClient("127.0.0.1", server.port)
        rep = peercheck.PeerReplicator(client=client, rank=0,
                                       world_size_fn=lambda: 1,
                                       generation_fn=lambda: 0)
        assert rep.replicate(b"good-shard" * 20, step=1)
        faults.inject(faults.PEER_CORRUPT, "corrupt", at=1, count=1)
        assert not rep.replicate(b"next-shard" * 20, step=2)
        rec = peercheck.decode_record(client.get(PEERSTATE_SCOPE, "0"))
        assert rec.step == 1 and rec.payload == b"good-shard" * 20
    finally:
        server.stop()


# -- Votes --------------------------------------------------------------------


def _rec(rank, digest, step=5, generation=1, summaries=None, prev=None,
         host=None, shard_digest=None):
    return {"v": 1, "rank": rank, "host": host or f"host{rank}",
            "generation": generation, "step": step, "digest": digest,
            "sync_mode": "allreduce", "shard_digest": shard_digest,
            "summaries": summaries if summaries is not None
            else [{"n": 8, "finite": 8, "l2": 1.0}],
            "prev": prev, "t": float(rank)}


_PREV = {"digest": "old", "step": 4, "l2": [1.0], "finite": [8]}
VOTES = {
    "agreement": {r: _rec(r, "aaa") for r in range(4)},
    "majority": {0: _rec(0, "aaa"), 1: _rec(1, "bbb"), 2: _rec(2, "aaa")},
    "three_way": {0: _rec(0, "aaa"), 1: _rec(1, "bbb"), 2: _rec(2, "ccc")},
    "nonfinite_no_digest": {
        0: _rec(0, None), 1: _rec(1, None),
        2: _rec(2, None, summaries=[{"n": 8, "finite": 5, "l2": 1.0}])},
    "two_nonfinite": {
        0: _rec(0, "a"),
        1: _rec(1, "a", summaries=[{"n": 8, "finite": 5, "l2": 1.0}]),
        2: _rec(2, "a", summaries=[{"n": 8, "finite": 6, "l2": 1.0}])},
    "everyone_nonfinite": {
        r: _rec(r, "aaa", summaries=[{"n": 8, "finite": 4, "l2": 1.0}])
        for r in range(3)},
    "stuck_shard": {
        r: _rec(r, None, shard_digest=f"S{r}-new" if r != 2 else "S2",
                prev={"digest": None, "step": 4,
                      "shard_digest": f"S{r}-old" if r != 2 else "S2"})
        for r in range(3)},
    "all_shards_moved": {
        r: _rec(r, None, shard_digest=f"S{r}-new",
                prev={"digest": None, "step": 4,
                      "shard_digest": f"S{r}-old"}) for r in range(3)},
    "shard_without_prev": {
        0: _rec(0, None, shard_digest="S0", prev=None),
        1: _rec(1, None, shard_digest="S1",
                prev={"shard_digest": "S1"})},
    "two_voter_drift": {
        0: _rec(0, "aaa", prev=_PREV,
                summaries=[{"n": 8, "finite": 8, "l2": 1.01}]),
        1: _rec(1, "bbb", prev=_PREV,
                summaries=[{"n": 8, "finite": 8, "l2": 5.0e12}])},
    "two_voter_no_prev": {0: _rec(0, "aaa"), 1: _rec(1, "bbb")},
    "two_voter_comparable_drift": {
        0: _rec(0, "aaa", prev=_PREV,
                summaries=[{"n": 8, "finite": 8, "l2": 1.5}]),
        1: _rec(1, "bbb", prev=_PREV,
                summaries=[{"n": 8, "finite": 8, "l2": 2.0}])},
    "two_voter_disagreeing_prev": {
        0: _rec(0, "aaa", prev={"digest": "old0", "step": 4, "l2": [1.0]},
                summaries=[{"n": 8, "finite": 8, "l2": 1.3}]),
        1: _rec(1, "bbb", prev={"digest": "old1", "step": 4, "l2": [7.7]},
                summaries=[{"n": 8, "finite": 8, "l2": 7.7}])},
}


@pytest.mark.parametrize("case", sorted(VOTES))
def test_votes_match_the_reference(case):
    records = VOTES[case]
    assert integrity.vote(records) == ref.vote(records)
    n = len(records)
    assert integrity.vote_latest(records, n) == ref.vote_latest(records, n)


def test_vote_latest_takes_the_newest_complete_group():
    for mod in (ref, integrity):
        assert mod.vote_latest({0: _rec(0, "a", step=7),
                                1: _rec(1, "a", step=6)}, 2) is None
        (group, verdict) = mod.vote_latest(
            {0: _rec(0, "a", step=6), 1: _rec(1, "b", step=6)}, 2)
        assert group == (1, 6) and verdict["divergent"]
        got = mod.vote_latest({0: _rec(0, "a"), 1: _rec(1, "a"),
                               2: "not a record", 3: {"no": "step"}}, 2)
        assert got is not None and not got[1]["divergent"]
    v = integrity.vote(VOTES["majority"])
    assert (v["method"], v["outlier_rank"], v["outlier_host"]) == (
        "majority", 1, "host1")


# -- The tripwire ------------------------------------------------------------


def _journal(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_note_nonfinite_counts_a_step_once_as_the_reference(tmp_path,
                                                             monkeypatch):
    monkeypatch.setenv("HOROVOD_EVENT_LOG", str(tmp_path / "j.jsonl"))
    calls = ([("warn", False, i) for i in range(4)] * 2
             + [("warn", True, i) for i in range(4)]
             + [("skip", False, 0)] * 3)
    for mod in (ref, integrity):
        for call in calls:
            mod.note_nonfinite(*call)
    assert integrity.summary()["nonfinite_detections"] == \
        ref.summary()["nonfinite_detections"] == 5
    events = [e for e in _journal(tmp_path / "j.jsonl")
              if e["event"] == "nonfinite_step"]
    # Each package journals its own five (same file, same fields).
    assert [(e["action"], e["detections"]) for e in events] == \
        [("warn", 1), ("warn", 2), ("skip", 3), ("skip", 4), ("skip", 5)] * 2
    text = port_metrics.render()
    assert 'hvd_nonfinite_steps_total{action="skip"} 3' in text


def test_the_abort_action_posts_the_kv_record(monkeypatch):
    server = RendezvousServer()
    server.start()
    try:
        monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HOROVOD_RENDEZVOUS_PORT", str(server.port))
        integrity.note_nonfinite("abort", False, 0)
        assert "non-finite" in json.loads(server.abort_record(0))["reason"]
        with pytest.raises(HorovodInternalError):
            abort.raise_if_aborted()
    finally:
        abort.reset()
        server.stop()


TRIPWIRE_MODES = [("allreduce", "none"), ("sharded", "none"),
                  ("allreduce", "int8")]


def _tripwire_rank(rank, init_file, out_dir):
    """One of 4 gloo ranks: for each mode, three SGD steps on a 2-leaf
    model under HOROVOD_NONFINITE_ACTION=abort, rank 1's gradient NaN in
    step 2; what the abort left behind after each step."""
    os.environ.update(HOROVOD_NUM_PROCESSES="4", HOROVOD_PROCESS_ID=str(rank),
                      HOROVOD_NONFINITE_ACTION="abort",
                      HOROVOD_EVENT_LOG=os.path.join(out_dir,
                                                     f"j{rank}.jsonl"))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import abort as ab
    from horovod_tpu_torch import integrity as integ

    hvd.init(device="cpu", init_method=f"file://{init_file}")
    res = {}
    for mode, comp in TRIPWIRE_MODES:
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(6, 4),
                                    torch.nn.Linear(4, 2))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(), sync_mode=mode,
            compression=getattr(hvd.Compression, comp))
        rows = []
        for step in range(3):
            x = torch.full((3, 6), 0.1 * (rank + step + 1))
            if step == 1 and rank == 1:
                x[0, 0] = float("nan")
            opt.zero_grad()
            model(x).square().sum().backward()
            before = [p.detach().clone() for p in model.parameters()]
            opt.step()
            held = all(torch.equal(a, p) for a, p in
                       zip(before, model.parameters()))
            aborted = ab.is_aborted()
            if aborted:
                try:
                    ab.raise_if_aborted()
                except hvd.HorovodInternalError:
                    ab.consume()
            rows.append([held, aborted, opt.nonfinite_steps])
        res[f"{mode}_{comp}"] = np.array(rows, dtype=np.int64)
        res[f"{mode}_{comp}.params"] = torch.cat(
            [p.detach().reshape(-1) for p in model.parameters()]).numpy()
        opt.remove_hooks()
    res["detections"] = np.array(integ.summary()["nonfinite_detections"])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


def test_the_abort_tripwire_on_four_gloo_ranks(tmp_path):
    """Every rank, in every mode: the poisoned step's update is skipped,
    the detection counted once, the abort armed (and consumed before the
    next step), the clean steps applied; parameters identical on every
    rank; each rank journaled nonfinite_step and abort_posted."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_tripwire_rank,
                         args=(r, str(tmp_path / "rdv"), str(tmp_path)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * 4
    out = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for mode, comp in TRIPWIRE_MODES:
        key = f"{mode}_{comp}"
        for r in range(4):
            np.testing.assert_array_equal(
                out[r][key], [[0, 0, 0], [1, 1, 1], [0, 0, 1]], err_msg=key)
            np.testing.assert_array_equal(out[r][key + ".params"],
                                          out[0][key + ".params"])
            assert np.isfinite(out[r][key + ".params"]).all()
    for r in range(4):
        assert int(out[r]["detections"]) == len(TRIPWIRE_MODES)
        events = _journal(tmp_path / f"j{r}.jsonl")
        names = [e["event"] for e in events]
        assert names.count("nonfinite_step") == len(TRIPWIRE_MODES)
        assert names.count("abort_posted") == len(TRIPWIRE_MODES)
        first = names.index("nonfinite_step")
        assert names.index("abort_posted", first) > first


# -- The spike detector and the rewind ---------------------------------------


def _streams():
    rng = np.random.default_rng(7)
    calm = list(1.0 + 0.05 * rng.standard_normal(40))
    spiky = list(calm)
    spiky[20] = 9.0
    spiky[30] = 6.0
    nan = [float("nan"), 1.0, 1.1, float("inf"), float("nan")]
    trend = list(np.linspace(3.0, 1.0, 30) + 0.02 * rng.standard_normal(30))
    trend[25] = 50.0
    return {"calm": calm, "spiky": spiky, "nan": nan, "trend": trend,
            "all_nan": [float("nan")] * 4}


@pytest.mark.parametrize("stream", sorted(_streams()))
@pytest.mark.parametrize("sigma,alpha,warmup", [(3.0, 0.1, 8),
                                                (2.0, 0.3, 3)])
def test_the_detector_trips_where_the_reference_trips(stream, sigma, alpha,
                                                      warmup):
    losses = _streams()[stream]
    port = integrity.LossSpikeDetector(sigma, alpha=alpha, warmup=warmup)
    want = ref.LossSpikeDetector(sigma, alpha=alpha, warmup=warmup)
    got = [(port.observe(x), port.mean, port.var, port.samples)
           for x in losses]
    expected = [(want.observe(x), want.mean, want.var, want.samples)
                for x in losses]
    assert got == expected


def test_observe_loss_raises_stages_and_is_inert_unarmed(monkeypatch):
    for loss in (1.0, float("nan"), 1e30):
        integrity.observe_loss(loss)
    assert integrity.consume_skip_ahead() == 0
    monkeypatch.setenv("HOROVOD_LOSS_SPIKE_SIGMA", "3")
    monkeypatch.setenv("HOROVOD_LOSS_SPIKE_WARMUP", "3")
    for _ in range(5):
        integrity.observe_loss(torch.tensor(1.0))
    with pytest.raises(LossSpikeError, match="loss spike"):
        integrity.observe_loss(torch.tensor([500.0]))
    assert abort.is_aborted()
    assert integrity.consume_skip_ahead() == 1
    assert integrity.consume_skip_ahead() == 0


def _rewind_run(name, script, monkeypatch, tmp_path, rewind_max="3"):
    """One package's @elastic.run over ``script`` (one list of actions per
    attempt: commit, spike, internal) with a recording state and world
    formation patched out: its calls and its journal's rewind events."""
    import horovod_tpu.basics as ref_basics
    import horovod_tpu.elastic.runner as ref_runner
    import horovod_tpu.elastic.state as ref_state
    import horovod_tpu.exceptions as ref_exc
    import horovod_tpu_torch.basics as port_basics
    import horovod_tpu_torch.elastic.runner as port_runner
    import horovod_tpu_torch.elastic.state as port_state
    import horovod_tpu_torch.exceptions as port_exc
    from test_torch_elastic_ladder import _recording_state

    basics, runner, state_mod, exc = {
        "ref": (ref_basics, ref_runner, ref_state, ref_exc),
        "port": (port_basics, port_runner, port_state, port_exc)}[name]
    journal = tmp_path / f"{name}.jsonl"
    monkeypatch.setenv("HOROVOD_EVENT_LOG", str(journal))
    monkeypatch.setenv("HOROVOD_REWIND_MAX", rewind_max)
    calls: list = []
    world = {"up": True}
    monkeypatch.setattr(basics, "init",
                        lambda *a, **k: (calls.append("init"),
                                         world.update(up=True)))
    monkeypatch.setattr(basics, "shutdown",
                        lambda: (calls.append("shutdown"),
                                 world.update(up=False)))
    monkeypatch.setattr(basics, "is_initialized", lambda: world["up"])
    monkeypatch.setattr(basics, "size", lambda: 2)
    monkeypatch.setattr(time, "sleep", lambda s: calls.append(f"sleep {s}"))
    state = _recording_state(state_mod, calls)
    attempts = iter(script)

    def train(st):
        calls.append("train")
        for action in next(attempts):
            if action == "commit":
                st.value += 1
                st.commit()
            elif action == "spike":
                raise exc.LossSpikeError("synthetic spike")
            elif action == "internal":
                raise exc.HorovodInternalError("peer died")
        return st.value

    prev = signal.getsignal(signal.SIGTERM)
    try:
        result = runner.run(train)(state)
    finally:
        signal.signal(signal.SIGTERM, prev)
    events = [(e["event"], e.get("consecutive"), e.get("rung"))
              for e in _journal(journal)
              if e["event"] in ("rewind", "rewind_storm", "recovery")]
    return calls, result, events


REWIND_SCRIPTS = {
    # A spike rewinds with no ladder step.
    "rewind": ([["commit", "commit", "spike"], ["commit"]], "3"),
    # Past HOROVOD_REWIND_MAX consecutive rewinds the spike climbs.
    "storm": ([["spike"], ["spike"], ["spike"], ["commit"]], "2"),
    # A landed commit resets the breaker.
    "reset": ([["commit", "spike"], ["commit", "spike"], ["commit"]], "1"),
    # A failure after a rewind climbs from the first rung.
    "mixed": ([["commit", "spike"], ["internal"], ["internal"], ["commit"]],
              "3"),
}


@pytest.mark.parametrize("case", sorted(REWIND_SCRIPTS))
def test_the_rewind_makes_the_reference_calls(case, monkeypatch, tmp_path):
    script, cap = REWIND_SCRIPTS[case]
    port = _rewind_run("port", script, monkeypatch, tmp_path, cap)
    integrity.reset_for_testing()
    ref.reset_for_testing()
    want = _rewind_run("ref", script, monkeypatch, tmp_path, cap)
    assert port == want
    if case == "rewind":
        assert port[2] == [("rewind", 1, None)]
    if case == "storm":
        assert [e for e in port[2] if e[0] != "rewind"] == [
            ("rewind_storm", 2, None), ("recovery", None, "restore")]
    text = port_metrics.render()
    assert 'hvd_rewinds_total{reason="loss_spike"}' in text


def test_the_precommit_block_holds_when_a_plane_is_armed(monkeypatch):
    """An armed abort refuses the commit before its snapshot when a plane
    that posts aborts is live (voting, the tripwire, the detector); with
    no knob the hook passes (the port's own post-snapshot check stays)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import state as state_mod

    class Counting(state_mod.ObjectState):
        snapshots = 0

        def commit(self):
            self._integrity_precommit()
            Counting.snapshots += 1
            super().commit()

    hvd.init(device="cpu")
    try:
        st = Counting(step=0)
        abort.trigger_local("a failure elsewhere")
        st._integrity_precommit()  # no knob: inert
        for knob, value in (("HOROVOD_INTEGRITY_INTERVAL", "1"),
                            ("HOROVOD_NONFINITE_ACTION", "abort"),
                            ("HOROVOD_LOSS_SPIKE_SIGMA", "3")):
            monkeypatch.setenv(knob, value)
            before = Counting.snapshots
            with pytest.raises(HorovodInternalError):
                st.commit()
            assert Counting.snapshots == before
            monkeypatch.delenv(knob)
    finally:
        abort.reset()
        hvd.shutdown()


# -- The KV plane ------------------------------------------------------------


@pytest.fixture()
def kv_server():
    server = RendezvousServer()
    server.start()
    yield server
    server.stop()


def _put_heartbeat(client, worker, rank, record):
    client.put("heartbeat", worker, json.dumps(
        {"rank": str(rank), "steps": 1, "commits": 1,
         "integrity": record}).encode())


def _view(server):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/integrity", timeout=5) as r:
        return json.loads(r.read().decode())


def test_get_integrity_cold_and_warm(kv_server):
    cold = _view(kv_server)
    assert cold["status"] == "no_records"
    assert cold["records"] == {} and cold["vote"] is None
    client = KVClient("127.0.0.1", kv_server.port)
    _put_heartbeat(client, "a:0", 0, _rec(0, "aaa", step=6))
    _put_heartbeat(client, "b:0", 1, _rec(1, "bbb", step=6))
    kv_server.set_cluster_info(world_np=2, ranks=2)
    assert sorted(kv_server.integrity_records()) == [0, 1]
    warm = _view(kv_server)
    assert warm["status"] == "ok" and warm["world_size"] == 2
    assert warm["vote"] == {"group": [1, 6], **ref.vote(
        {0: _rec(0, "aaa", step=6), 1: _rec(1, "bbb", step=6)})}
    assert client.integrity_view() == warm


def test_malformed_heartbeats_and_the_zombie_record(kv_server):
    client = KVClient("127.0.0.1", kv_server.port)
    client.put("heartbeat", "a:0", b"not json")
    client.put("heartbeat", "b:0", json.dumps({"rank": "1"}).encode())
    client.put("heartbeat", "c:0", json.dumps(
        {"rank": "2", "integrity": {"rank": "NaN?"}}).encode())
    assert kv_server.integrity_records() == {}
    fresh, stale = _rec(0, "aaa", step=9), _rec(0, "zzz", step=3)
    fresh["t"], stale["t"] = 100.0, 1.0
    _put_heartbeat(client, "a:0", 0, fresh)
    _put_heartbeat(client, "zombie:0", 0, stale)
    assert kv_server.integrity_records()[0]["digest"] == "aaa"


def _record(rank, step, generation, payload, world=2):
    return peercheck.encode_record(peercheck.ReplicaRecord(
        rank=rank, step=step, generation=generation, world_size=world,
        payload=payload))


def test_quarantine_fences_puts_and_evicts_the_current_record(kv_server):
    client = KVClient("127.0.0.1", kv_server.port, generation_fn=lambda: 0)
    rep = peercheck.PeerReplicator(client=client, rank=1,
                                   world_size_fn=lambda: 2,
                                   generation_fn=lambda: 0)
    assert rep.replicate(b"step-one" * 8, step=1)
    assert rep.replicate(b"step-two" * 8, step=2)
    kv_server.quarantine_rank(1, "b:0", generation=0, step=2)
    assert client.get(PEERSTATE_SCOPE, "1") is None
    assert peercheck.decode_record(
        client.get(PEERSTATE_SCOPE, "1.prev")).step == 1
    for c in (client, KVClient("127.0.0.1", kv_server.port)):
        with pytest.raises(HTTPError) as e:
            c.put(PEERSTATE_SCOPE, "1", _record(1, 3, 0, b"replay" * 8))
        assert e.value.code == 409
    assert kv_server.fenced_writes == 2
    assert kv_server.quarantine_export()["1"]["host"] == "b:0"


def test_a_newer_generation_lifts_the_fence_to_a_tombstone(kv_server,
                                                          monkeypatch):
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "1")
    client0 = KVClient("127.0.0.1", kv_server.port, generation_fn=lambda: 0)
    rep = peercheck.PeerReplicator(client=client0, rank=1,
                                   world_size_fn=lambda: 2,
                                   generation_fn=lambda: 0)
    assert rep.replicate(b"old-world" * 8, step=1)
    kv_server.quarantine_rank(1, "b:0", generation=0, step=1)
    kv_server.seed(generation=1)
    client1 = KVClient("127.0.0.1", kv_server.port, generation_fn=lambda: 1)
    client1.put(PEERSTATE_SCOPE, "1", _record(1, 2, 1, b"new-world" * 8))
    rec = peercheck.decode_record(client1.get(PEERSTATE_SCOPE, "1"))
    assert (rec.generation, rec.step) == (1, 2)
    q = rep.quarantined()
    assert q["1"]["lifted"] is True
    old = peercheck.ReplicaRecord(rank=1, step=1, generation=0,
                                  world_size=2, payload=b"x")
    assert peercheck._condemned(old, q["1"])
    assert not peercheck._condemned(rec, q["1"])
    parsed = port_metrics.validate_prometheus_text(kv_server.metrics_text())
    assert parsed["hvd_integrity_quarantined_ranks"]["samples"] == \
        [({}, 0.0)]


def test_the_live_vote_fence(kv_server, monkeypatch):
    """Before the driver's tick lands, a PUT from the named outlier of a
    complete divergent vote is refused, a tombstoned rank id included;
    an ambiguous vote or another rank passes."""
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "1")
    kv_server.seed(generation=1)
    kv_server.set_cluster_info(world_np=3, ranks=3)
    client = KVClient("127.0.0.1", kv_server.port, generation_fn=lambda: 1)
    kv_server.quarantine_rank(1, "b:0", generation=0, step=1)
    client.put(PEERSTATE_SCOPE, "1", _record(1, 2, 1, b"lift" * 8, 3))
    for r, d in ((0, "aaa"), (1, "bad"), (2, "aaa")):
        _put_heartbeat(client, f"h{r}:0", r, _rec(r, d, step=7))
    with pytest.raises(HTTPError) as e:
        client.put(PEERSTATE_SCOPE, "1", _record(1, 3, 1, b"corrupt" * 8, 3))
    assert e.value.code == 409 and b"live-vote" in e.value.read()
    client.put(PEERSTATE_SCOPE, "0", _record(0, 3, 1, b"fine" * 8, 3))
    # A newer generation passes the fence.
    kv_server.seed(generation=2)
    KVClient("127.0.0.1", kv_server.port, generation_fn=lambda: 2).put(
        PEERSTATE_SCOPE, "1", _record(1, 3, 2, b"new" * 8, 3))


def test_assembly_drops_a_condemned_ranks_pooled_records(kv_server,
                                                        monkeypatch):
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_PORT", str(kv_server.port))
    assert peercheck.retention_depth() == 2
    client = KVClient("127.0.0.1", kv_server.port)
    survivor = peercheck.PeerReplicator(client=client, rank=0,
                                        world_size_fn=lambda: 2,
                                        generation_fn=lambda: 0)
    corrupt = peercheck.PeerReplicator(client=client, rank=1,
                                       world_size_fn=lambda: 2,
                                       generation_fn=lambda: 0)
    for step, payload in ((1, b"good-1"), (2, b"good-2")):
        assert survivor.replicate(payload + b"-r0" * 8, step=step)
        assert corrupt.replicate(payload + b"-r1" * 8, step=step)
        survivor._pull_neighbors(client)
    assert survivor.replicate(b"good-3-r0" * 8, step=3)
    assert corrupt.replicate(b"CORRUPT-r1" * 8, step=3)
    survivor._pull_neighbors(client)
    assert [r.step for r in survivor.assemble()] == [3, 3]
    kv_server.quarantine_rank(1, "b:0", generation=0, step=3)
    got = survivor.assemble()
    assert [r.step for r in got] == [2, 2]
    assert got[1].payload == b"good-2" + b"-r1" * 8
    monkeypatch.delenv("HOROVOD_INTEGRITY_INTERVAL")
    assert survivor.quarantined() == {} and peercheck.retention_depth() == 1


def test_the_scrape_counts_divergence_and_quarantine(kv_server):
    parsed = port_metrics.validate_prometheus_text(kv_server.metrics_text())
    assert parsed["hvd_integrity_divergence_total"]["samples"] == \
        [({}, 0.0)]
    assert parsed["hvd_integrity_quarantined_ranks"]["samples"] == \
        [({}, 0.0)]
    kv_server.record_integrity_divergence("b:0")
    kv_server.quarantine_rank(1, "b:0", generation=0, step=5)
    parsed = port_metrics.validate_prometheus_text(kv_server.metrics_text())
    div = {tuple(sorted(lb.items())): v for lb, v in
           parsed["hvd_integrity_divergence_total"]["samples"]}
    assert div == {(): 1.0, (("host", "b:0"),): 1.0}
    assert parsed["hvd_integrity_quarantined_ranks"]["samples"] == \
        [({}, 1.0)]


def test_the_heartbeat_carries_the_staged_record(kv_server, monkeypatch):
    from horovod_tpu_torch.runner.elastic import worker as elastic_worker

    monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_PORT", str(kv_server.port))
    monkeypatch.setenv("HOROVOD_HOSTNAME", "sdc")
    monkeypatch.setenv("HOROVOD_ELASTIC_WORKER", "sdc:0")
    monkeypatch.setenv("HOROVOD_RANK", "0")
    ctx = elastic_worker.ElasticWorkerContext()
    assert ctx.send_heartbeat()
    assert "integrity" not in json.loads(kv_server.heartbeat_payload("sdc:0"))
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "1")
    rec = integrity.maybe_fingerprint({"w": np.ones(4, np.float32)}, None, 1)
    assert ctx.send_heartbeat()
    assert kv_server.integrity_records()[0]["digest"] == rec["digest"]
    assert kv_server.integrity_records()[0]["host"] == "sdc:0"
    ctx.parked = True  # a parked spare has no world rank: nothing rides
    kv_server.clear_heartbeat("sdc:0")
    assert ctx.send_heartbeat()
    assert kv_server.integrity_records() == {}


def test_the_flight_record_and_the_profiler_carry_the_plane(monkeypatch):
    from horovod_tpu_torch import profiler

    assert integrity.flight_summary() is None
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "1")
    integrity.maybe_fingerprint({"w": np.ones(2, np.float32)}, None, 4)
    ref.maybe_fingerprint({"w": np.ones(2, np.float32)}, None, 4)
    assert integrity.flight_summary() == ref.flight_summary()
    assert integrity.flight_summary()["latest"]["step"] == 4
    assert profiler.summary()["integrity"] == integrity.summary()
    assert set(integrity.summary()) == set(ref.summary())
    parsed = port_metrics.validate_prometheus_text(port_metrics.render())
    assert "hvd_integrity_checks_total" in parsed


# -- The driver's continuity rule ---------------------------------------------


def _driver(monkeypatch):
    from horovod_tpu_torch.runner.elastic.discovery import FixedHostDiscovery
    from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
    from horovod_tpu_torch.runner.hosts import HostInfo
    from horovod_tpu_torch.runner.launch import Settings

    monkeypatch.setenv("HOROVOD_SECRET_KEY", "a" * 64)
    monkeypatch.delenv("HOROVOD_DRIVER_STATE_DIR", raising=False)
    drv = ElasticDriver(
        Settings(num_proc=2, hosts=[], command=["true"], elastic=True,
                 min_np=1, max_np=2),
        discovery=FixedHostDiscovery([HostInfo("a", 1), HostInfo("b", 1)]))
    drv._world_hosts = [HostInfo("a", 1), HostInfo("b", 1)]
    return drv


def _vrec(rank, step, digest, prev=None, nonfinite=False):
    return {"rank": rank, "host": f"{'ab'[rank]}:0", "generation": 0,
            "step": step, "sync_mode": "allreduce", "digest": digest,
            "prev": prev, "t": 0.0,
            "summaries": [{"n": 4, "finite": 3 if nonfinite else 4,
                           "l2": 1.0}]}


def test_two_voter_persistent_corruption_keeps_striking(monkeypatch):
    """Two voters: the vote after the first names nobody (the outlier's
    prev, its own condemned record, disagrees with its peer's), but the
    driver attributes it to the rank whose prev is the condemned digest;
    without that memory the vote stays ambiguous. The quarantine and the
    strikes land on the named worker."""
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "1")
    monkeypatch.setenv("HOROVOD_INTEGRITY_ACTION", "warn")
    drv = _driver(monkeypatch)
    hbv = [1]
    recs = {}
    monkeypatch.setattr(drv._server, "heartbeat_version", lambda: hbv[0])
    monkeypatch.setattr(drv._server, "integrity_vote_cached",
                        lambda: (recs, integrity.vote_latest(recs, 2)))
    recs.update({0: _vrec(0, 1, "DA"), 1: _vrec(1, 1, "DX", nonfinite=True)})
    drv._integrity_tick()
    assert drv._integrity_strikes == {"b:0": 1}
    assert drv._last_outlier == (1, "DX")
    assert drv._server.quarantine_export()["1"]["step"] == 1
    recs.update({0: _vrec(0, 2, "DB", prev={"digest": "DA", "step": 1}),
                 1: _vrec(1, 2, "DY", prev={"digest": "DX", "step": 1})})
    hbv[0] = 2
    drv._last_integrity_tick = -1e9
    drv._integrity_tick()
    assert drv._integrity_strikes == {"b:0": 2}
    # The same group again is not voted twice.
    hbv[0] = 3
    drv._last_integrity_tick = -1e9
    drv._integrity_tick()
    assert drv._integrity_strikes == {"b:0": 2}
    fresh = _driver(monkeypatch)
    monkeypatch.setattr(fresh._server, "heartbeat_version", lambda: 1)
    monkeypatch.setattr(fresh._server, "integrity_vote_cached",
                        lambda: (recs, integrity.vote_latest(recs, 2)))
    fresh._integrity_tick()
    assert not fresh._integrity_strikes
