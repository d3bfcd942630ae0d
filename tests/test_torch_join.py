"""``hvd.join()``, the cross-rank stall watch and the online autotuner of
the port's negotiated runtime, against the JAX package's native runtime
where it has them.

The per-rank script and its spawner are ``test_torch_negotiation.py``'s:
each process runs it through the reference's ``NativeWorld`` and then
through the port's world (gloo), and the parent holds the results, the
last rank to join and the errors to the reference's.
"""

import numpy as np
import pytest

from test_torch_negotiation import _stall_lines, ok, same, spawn


@pytest.fixture(scope="module")
def join3(tmp_path_factory):
    return ok(spawn(tmp_path_factory.mktemp("j3"), 3, "join"))


@pytest.fixture(scope="module")
def join4(tmp_path_factory):
    return ok(spawn(tmp_path_factory.mktemp("j4"), 4, "join_subset"))


JOIN_KEYS = [f"join.{kind}{i}" for i in range(3) for kind in ("step", "int")]


@pytest.mark.parametrize("key", JOIN_KEYS + ["join.after"])
def test_uneven_steps_match_reference(join3, key):
    seen = 0
    for r, (_, res, _) in enumerate(join3):
        if key not in res["ref"]:
            assert key not in res["port"]
            continue
        seen += 1
        same(res["port"][key], res["ref"][key], f"rank {r} {key}")
    assert seen


def test_join_contributors_mean(join3):
    """Step i is averaged over the ranks that had data: ranks i..n-1."""
    for r, (_, res, _) in enumerate(join3):
        for i in range(r + 1):
            contributors = [q + 1 for q in range(i, 3)]
            got = np.asarray(res["port"][f"join.step{i}"]["value"])
            np.testing.assert_allclose(
                got, sum(contributors) / len(contributors), rtol=1e-6)
            ints = np.array([[7 * q + 3, -q, 1000 + q] for q in range(i, 3)])
            # Integer Average: the sum times 1/n, rounded half away.
            want = np.sign(ints.sum(0)) * np.floor(
                np.abs(ints.sum(0) * (1.0 / len(ints))) + 0.5)
            assert res["port"][f"join.int{i}"]["value"] == want.tolist()


def test_last_rank_to_join_matches_reference(join3, join4):
    for runs, last in ((join3, 2), (join4, 3)):
        for _, res, _ in runs:
            assert res["port"]["join.last"] == res["ref"]["join.last"] == last


def test_subset_gather_with_a_joined_member_raises_as_reference(join4):
    _, res, _ = join4[0]
    assert res["port"]["join.subset_error"] == \
        res["ref"]["join.subset_error"]
    assert "has joined member rank 1" in res["port"]["join.subset_error"]


@pytest.mark.parametrize("key", [f"js.step{i}" for i in range(4)])
def test_steps_beside_a_joined_rank_match_reference(join4, key):
    seen = 0
    for r, (_, res, _) in enumerate(join4):
        if key in res["ref"]:
            seen += 1
            same(res["port"][key], res["ref"][key], f"rank {r} {key}")
    assert seen


def test_join_at_one_rank_returns_size_minus_one(tmp_path):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        assert hvd.join() == hvd.size() - 1 == 0
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def watch2(tmp_path_factory):
    return ok(spawn(tmp_path_factory.mktemp("w2"), 2, "stallwatch,autotune",
                    worlds=("port",),
                    extra_env={"HOROVOD_STALL_CHECK_TIME": "0.5",
                               "HOROVOD_AUTOTUNE": "1",
                               "HOROVOD_FUSION_THRESHOLD": "2048"},
                    timeout=180))


def test_stallwatch_names_the_late_rank_and_bounds_the_wait(watch2):
    lines = _stall_lines(watch2[0][2])["port"]
    assert any("tensor stallwatch/late" in ln
               and "missing from rank(s) [1]" in ln for ln in lines), lines
    res = watch2[0][1]["port"]
    assert res["stallwatch"] == "ok"
    assert res["stallwatch.bound"] == "NativeRuntimeError"
    assert 0.9 < res["stallwatch.waited"] < 10


def test_autotune_moves_the_knobs(watch2):
    """``HOROVOD_AUTOTUNE=1`` arms the ParameterManager on the loop: from
    a 2 KiB fusion threshold, 70 steps of sixteen 32 KiB tensors take
    samples and move it."""
    for _, res, _ in watch2:
        before, after = res["port"]["autotune.before"], \
            res["port"]["autotune.after"]
        assert before["active"] and before["fusion_threshold"] == 2048
        assert after["samples"] >= 3
        assert after["fusion_threshold"] != 2048
