"""The port's autotuner (``horovod_tpu_torch/autotune.py``) held to the JAX
package's (``horovod_tpu/autotune.py``).

- ``BayesianTuner``: the port's copy of the native optimizer
  (``horovod_tpu_torch/csrc/bayes_opt.cc``, built with g++) suggests the
  reference's points bit for bit over several seeds and score sequences;
  ``tune_fusion_threshold`` picks the same threshold and logs the same
  lines.
- ``AutotuneStep`` under one injected clock and one cost model of the pins
  (each package reads its own): the same samples, the same pinned
  decision and the same ``HOROVOD_AUTOTUNE_LOG`` line, for the threshold
  axis alone and jointly with the segments, sync-mode and algorithm axes;
  the same kept list from model-guided pruning on the same fits and leaf
  layout; the same pin and the poison after a mid-warmup abort; co-built
  steps re-traced (the port: re-bucketed) alike.
- ``tune_step_sync_mode`` and ``tune_step_fusion`` pin what the reference
  pins under the same clock and cost model (an ineligible mode skipped).
- Re-bucketing in a one-rank gloo world: the buckets are
  ``bucket_leaves(layout, pin)``, an explicit threshold or ``num_groups``
  wins over the pin, and a re-bucket asked mid-step waits for the step.
- ``make_train_step`` under ``HOROVOD_AUTOTUNE=1`` pins a threshold after
  three windows, writes one log line, re-buckets, and its losses equal an
  untuned run's bit for bit.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import autotune as ja
from horovod_tpu_torch import autotune as ta

MIB = 1 << 20


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for key in ("HOROVOD_AUTOTUNE", "HOROVOD_AUTOTUNE_LOG",
                "HOROVOD_AUTOTUNE_MODEL_GUIDED", "HOROVOD_COMMS_PLANNER",
                "HOROVOD_AUTOTUNE_MEMORY_GUARD", "HOROVOD_FUSION_THRESHOLD",
                "HOROVOD_AUTOTUNE_PRUNE_MARGIN"):
        monkeypatch.delenv(key, raising=False)
    _reset_reference()
    ta.reset_for_testing()
    yield
    _reset_reference()
    ta.reset_for_testing()


def _reset_reference():
    ja._tuned.update(threshold=None, segments=None, sync_mode=None,
                     algorithm=None, mesh_shape=None, aborted=False,
                     history=[], pruned=[])
    ja._active_tuner.clear()


# -- The Bayesian optimizer ---------------------------------------------------


@pytest.mark.parametrize("seed", [42, 7, 12345])
@pytest.mark.parametrize("dims", [1, 2])
def test_bayesian_suggestions_are_the_reference_bit_for_bit(seed, dims):
    lows = [64 * 1024.0, 0.5][:dims]
    highs = [128.0 * MIB, 50.0][:dims]
    a = ta.BayesianTuner(lows, highs, seed=seed)
    b = ja.BayesianTuner(lows, highs, seed=seed)
    rng = np.random.RandomState(seed)
    try:
        for r in range(12):
            got, want = a.suggest(), b.suggest()
            assert got == want, (r, got, want)
            # Scores: noise, then a trend, then repeats (a flat GP).
            score = (float(rng.rand()) if r < 6 else
                     1.0 / (1.0 + abs(got[0] - 8 * MIB) / MIB))
            a.add_sample(got, score)
            b.add_sample(want, score)
        assert a.best() == b.best()
    finally:
        a.close()
        b.close()


def test_tune_fusion_threshold_picks_the_reference_threshold(tmp_path):
    def cost(threshold):
        return 0.1 + abs(np.log2(threshold / (6 * MIB))) * 1e-3

    picks = []
    for mod, name in ((ta, "port"), (ja, "reference")):
        log = tmp_path / f"{name}.csv"
        picks.append(mod.tune_fusion_threshold(
            lambda t: t, cost, rounds=8, log_path=str(log)))
        picks.append(log.read_text())
    assert picks[0] == picks[2] and picks[1] == picks[3]
    assert len(picks[1].splitlines()) == 8


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a compiler that fails is an error, with its output."""
    from horovod_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(ta, "GXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ta.build_bayes_library()


# -- AutotuneStep against the reference ---------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _cost(mod):
    """Seconds a step under ``mod``'s pins (a fixed cost model)."""
    state = mod._tuned
    t = state["threshold"] or 0
    cost = 0.05 + abs(np.log2(max(t, 1) / (4 * MIB))) * 1e-3
    cost += {None: 0, 2: 3e-3, 4: 0.0, 8: 2e-3}[state["segments"]]
    cost += {None: 0, "allreduce": 0.0, "sharded": 4e-3,
             "fsdp": 1e-3}[state["sync_mode"]]
    cost += {None: 0, "auto": 1e-3, "flat": 2e-3, "rhd": 5e-3,
             "two_level": 0.0}[state["algorithm"]]
    return cost


class _PortStep:
    """A fake factory step: each call costs what the pins say; re-buckets
    are counted."""

    def __init__(self, clock):
        self.clock, self.rebuckets, self.calls = clock, 0, 0

    def __call__(self, fail_at=None):
        self.calls += 1
        if self.calls == fail_at:
            raise RuntimeError("a window failed")
        self.clock.t += _cost(ta)
        return torch.tensor([float(self.calls)])

    def rebucket(self):
        self.rebuckets += 1


class _RefStep(_PortStep):
    def __call__(self, fail_at=None):
        self.calls += 1
        if self.calls == fail_at:
            raise RuntimeError("a window failed")
        self.clock.t += _cost(ja)
        return jnp.asarray([float(self.calls)])

    def clear_cache(self):
        self.rebuckets += 1


AXES = {
    "threshold": {},
    "segments": {"segment_candidates": (2, 4, 8)},
    "sync_mode": {"sync_mode_candidates": ("allreduce", "sharded",
                                           "fsdp")},
    "algorithm": {"algorithm_candidates": ("auto", "flat", "rhd",
                                           "two_level")},
    "sync_and_algorithm": {"sync_mode_candidates": ("allreduce", "fsdp"),
                           "algorithm_candidates": ("auto", "two_level")},
}


def _tuned_run(mod, step_cls, axes, tmp_path, monkeypatch, name,
               calls=None, fail_at=None):
    clock = _Clock()
    step = step_cls(clock)
    log = tmp_path / f"{name}.jsonl"
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
    tuner = mod.AutotuneStep(step, iters=2, clock=clock, **axes)
    n = calls or len(tuner._cands) * 3 + 2
    error = None
    for _ in range(n):
        try:
            tuner(fail_at=fail_at)
        except Exception as e:  # noqa: BLE001 — compared across packages
            error = type(e).__name__
            if fail_at is None or "HorovodInternalError" in error:
                break
    pins = {k: mod._tuned[k] for k in ("threshold", "segments",
                                       "sync_mode", "algorithm")}
    lines = log.read_text().splitlines() if log.exists() else []
    return dict(samples=tuner._samples, pins=pins, lines=lines,
                rebuckets=step.rebuckets, error=error,
                aborted=mod.warmup_aborted(), tuning=tuner._hvd_tuning,
                history=list(mod._tuned["history"]))


@pytest.mark.parametrize("axes", list(AXES), ids=list(AXES))
def test_autotune_step_matches_the_reference(axes, tmp_path, monkeypatch):
    got = _tuned_run(ta, _PortStep, AXES[axes], tmp_path, monkeypatch,
                     "port")
    want = _tuned_run(ja, _RefStep, AXES[axes], tmp_path, monkeypatch,
                      "reference")
    assert got == want
    assert len(got["lines"]) == 1 and not got["tuning"]
    line = json.loads(got["lines"][0])
    assert line["tunable"].startswith("fusion_threshold_bytes")


def test_abort_pins_the_first_candidate_and_poisons(tmp_path, monkeypatch):
    from horovod_tpu_torch import exceptions
    from horovod_tpu_torch.parallel.data_parallel import _StallWatchedStep

    kw = dict(calls=9, fail_at=6)
    got = _tuned_run(ta, _PortStep, AXES["algorithm"], tmp_path,
                     monkeypatch, "port", **kw)
    want = _tuned_run(ja, _RefStep, AXES["algorithm"], tmp_path,
                      monkeypatch, "reference", **kw)
    assert got == want
    assert got["aborted"] and got["error"] == "HorovodInternalError"
    assert got["pins"]["threshold"] == ja.DEFAULT_THRESHOLDS[0]
    assert got["pins"]["algorithm"] == "auto" and got["lines"] == []
    # Every factory step of the process refuses to run.
    with pytest.raises(exceptions.HorovodInternalError, match="aborted"):
        _StallWatchedStep(lambda: None, "train_step")()


@pytest.mark.parametrize("axes", ["threshold", "algorithm"])
def test_model_guided_pruning_keeps_the_reference_list(
        axes, tmp_path, monkeypatch):
    """Same fits (class names mapped) and leaf layout: the same kept
    grid and pruned list after the first window."""
    from horovod_tpu import comms_model as jcm
    from horovod_tpu.ops import collective_ops as jco
    from horovod_tpu_torch import comms_model as tcm
    from horovod_tpu_torch.ops import collective_ops as tco

    monkeypatch.setenv("HOROVOD_AUTOTUNE_MODEL_GUIDED", "1")
    monkeypatch.setattr(jco, "_link_class_of", lambda ps: "ici")
    monkeypatch.setattr(tco, "_link_class", lambda ps: "intra_host")
    out = []
    for mod, cm, cls, step_cls in ((ta, tcm, "intra_host", _PortStep),
                                   (ja, jcm, "ici", _RefStep)):
        cm.reset_for_testing()
        model = cm.get_model()
        for nbytes in (64 * 1024, 16 * MIB):
            for _ in range(4):
                model.observe("allreduce", "flat", cls, nbytes,
                              5e-3 + 1e-12 * nbytes)
                model.observe("allreduce", "two_level", cls, nbytes,
                              1e-4 + 1e-12 * nbytes)
        model.note_leaf_sizes([(64 * 1024, "float32")] * 400)
        clock = _Clock()
        tuner = mod.AutotuneStep(step_cls(clock), iters=1, clock=clock,
                                 **AXES[axes])
        for _ in range(2):
            tuner()
        out.append((tuner._cands, list(mod._tuned["pruned"])))
        cm.reset_for_testing()
    assert out[0] == out[1]
    assert out[0][1], "the cost model pruned nothing"


def test_co_built_steps_are_retraced_at_the_pin(monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    counts = []
    for mod, step_cls in ((ta, _PortStep), (ja, _RefStep)):
        clock = _Clock()
        main, co = step_cls(clock), step_cls(clock)
        tuned = mod.maybe_autotune_step(main)
        assert isinstance(tuned, mod.AutotuneStep)
        tuned._clock = clock
        # Built before the first window pins: bare, and re-traced at the
        # pin (once a candidate is pinned, a new step is not registered).
        assert mod.maybe_autotune_step(co) is co
        for _ in range(len(tuned._cands) * 4):
            tuned()
        assert mod.maybe_autotune_step(co) is co  # a pin exists now
        counts.append((main.rebuckets, co.rebuckets, mod._tuned["threshold"]))
    assert counts[0] == counts[1] and counts[0][1] == 1


def test_tune_step_sync_mode_matches_the_reference(monkeypatch):
    import time

    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    cost = {"allreduce": 0.02, "sharded": 0.015, "fsdp": 0.001}
    picks = []
    for mod, exc, out in ((ta, "horovod_tpu_torch.exceptions",
                           lambda: torch.zeros(1)),
                          (ja, "horovod_tpu.exceptions",
                           lambda: jnp.zeros(1))):
        import importlib

        ineligible = importlib.import_module(exc).SyncModeIneligibleError

        def build(mode, out=out, ineligible=ineligible):
            if mode == "fsdp":
                raise ineligible("fsdp needs resident shards")

            def run():
                clock.t += cost[mode]
                return out()
            return run

        picks.append((mod.tune_step_sync_mode(build), mod.tuned_sync_mode()))
    assert picks[0] == picks[1] == ("sharded", "sharded")


def test_tune_step_fusion_matches_the_reference():
    def measure(threshold):
        return 0.1 + abs(np.log2(threshold / (2 * MIB))) * 1e-3

    got = ta.tune_step_fusion(None, (), thresholds=(MIB, 4 * MIB, 64 * MIB),
                              measure=measure)
    want = ja.tune_step_fusion(None, (), thresholds=(MIB, 4 * MIB,
                                                     64 * MIB),
                               measure=measure)
    assert got == want == ta.tuned_threshold() == ja.tuned_threshold()
    assert ta.autotune_state()["history"] == ja.autotune_state()["history"]


def test_pins_reject_unknown_values():
    with pytest.raises(ValueError, match="unknown algorithm"):
        ta.set_tuned_algorithm("ring")
    with pytest.raises(ValueError, match="unknown sync_mode"):
        ta.set_tuned_sync_mode("zero9")


# -- Re-bucketing in a one-rank gloo world ------------------------------------


@pytest.fixture
def world(monkeypatch):
    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(256, 300), torch.nn.ReLU(),
                               torch.nn.Linear(300, 64), torch.nn.ReLU(),
                               torch.nn.Linear(64, 10))


def _layout(model):
    return [(p.numel(), p.dtype) for p in model.parameters()]


def _bucket_index(opt, model):
    ids = {id(p): i for i, p in enumerate(model.parameters())}
    return [[ids[id(p)] for p in b] for b in opt._buckets]


@pytest.mark.parametrize("mode", ["allreduce", "sharded"])
def test_rebucket_follows_the_pin(world, mode):
    from horovod_tpu_torch.ops.fusion import bucket_leaves

    model = _model()
    opt = world.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), sync_mode=mode)
    assert _bucket_index(opt, model) == bucket_leaves(_layout(model))
    for pin in (4096, 256 * 1024, 64 * MIB):
        ta.set_tuned_threshold(pin)
        opt.rebucket()
        assert opt._threshold == pin
        assert _bucket_index(opt, model) == bucket_leaves(_layout(model),
                                                          pin)
    explicit = world.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), sync_mode=mode,
        fusion_threshold_bytes=1000)
    grouped = world.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), sync_mode=mode,
        num_groups=2)
    before = (_bucket_index(explicit, model), _bucket_index(grouped, model))
    ta.set_tuned_threshold(64 * MIB)
    explicit.rebucket()
    grouped.rebucket()
    assert (_bucket_index(explicit, model),
            _bucket_index(grouped, model)) == before
    assert explicit._threshold == 1000
    for o in (opt, explicit, grouped):
        o.remove_hooks()


def test_rebucket_mid_step_waits_for_the_step(world):
    from horovod_tpu_torch.ops.fusion import bucket_leaves

    model = _model()
    opt = world.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1))
    x = torch.randn(4, 256)
    model(x).sum().backward()
    assert opt._launched  # the hooks launched buckets
    before = _bucket_index(opt, model)
    ta.set_tuned_threshold(4096)
    opt.rebucket()
    assert _bucket_index(opt, model) == before and opt._rebucket_due
    opt.step()
    assert _bucket_index(opt, model) == bucket_leaves(_layout(model), 4096)
    assert not opt._rebucket_due
    opt.zero_grad()
    model(x).sum().backward()
    opt.step()  # the hooks follow the new buckets
    opt.remove_hooks()


def test_fsdp_rebucket_takes_the_pin(world):
    from horovod_tpu_torch.ops.fusion import bucket_leaves

    model = _model()
    layout = _layout(model)
    opt = world.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), sync_mode="fsdp")
    ta.set_tuned_threshold(4096)
    opt.rebucket()
    assert opt._threshold == 4096
    assert opt._nbuckets == len(bucket_leaves(layout, 4096))


def _loss(model, batch):
    x, y = batch
    return torch.nn.functional.cross_entropy(model(x), y)


def _train(hvd, steps, seed=0):
    model = _model(seed)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9))
    step = hvd.make_train_step(model, _loss, opt)
    g = torch.Generator().manual_seed(1)
    batch = (torch.randn(8, 256, generator=g),
             torch.randint(0, 10, (8,), generator=g))
    losses = [float(step(batch)) for _ in range(steps)]
    return model, opt, step, losses


def test_make_train_step_tunes_under_hvd_autotune(world, tmp_path,
                                                  monkeypatch):
    from horovod_tpu_torch.ops.fusion import bucket_leaves

    calls = len(ta.DEFAULT_THRESHOLDS) * 4 + 2
    _, _, _, plain = _train(world, calls)
    log = tmp_path / "autotune.jsonl"
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
    model, opt, step, tuned = _train(world, calls)
    pin = ta.tuned_threshold()
    assert pin in ta.DEFAULT_THRESHOLDS
    assert tuned == plain  # bit for bit: re-bucketing moves no value
    (line,) = log.read_text().splitlines()
    entry = json.loads(line)
    assert entry["tunable"] == "fusion_threshold_bytes"
    assert entry["decision"] == pin and len(entry["samples"]) == 3
    assert _bucket_index(opt, model) == bucket_leaves(_layout(model), pin)
    assert ta.autotune_state()["samples"] == 3
    opt.remove_hooks()
