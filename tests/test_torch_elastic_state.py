"""The port's elastic state held against the JAX package's torch surface
(``horovod_tpu/torch/elastic.py``: ``TorchState``, ``ElasticSampler``) and
``ObjectState``: commit and restore of a model, an AdamW state and user
objects (one assigned after construction), and the sampler's shards at
world sizes 1 to 4 after ``record_batch`` and ``reset``. Sharded and fsdp
optimizers, which a re-formed world could not re-assemble, are refused."""

import numpy as np
import pytest
import torch

import horovod_tpu.elastic.state as ref_state
import horovod_tpu.torch.elastic as ref_elastic
import horovod_tpu_torch.elastic.torch_state as port_elastic
from horovod_tpu_torch.elastic import state as port_state


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 4), torch.nn.Tanh(),
                               torch.nn.Linear(4, 2))


def _step(model, opt, seed):
    x = torch.from_numpy(np.random.RandomState(seed).randn(5, 6)
                         .astype(np.float32))
    opt.zero_grad()
    (model(x) ** 2).mean().backward()
    opt.step()


def _flat(model, opt):
    params = [p.detach().clone() for p in model.parameters()]
    moments = [v.clone() for s in opt.state.values() for v in s.values()
               if torch.is_tensor(v)]
    return params + moments


def _torch_state_run(mod):
    model = _model()
    opt = torch.optim.AdamW(model.parameters(), lr=0.01, weight_decay=0.1)
    state = mod.TorchState(model=model, optimizer=opt, epoch=0, batch=0)
    _step(model, opt, 1)
    state.epoch = 1
    state.lr_scale = 0.5  # tracked though assigned after construction
    state.commit()
    committed = _flat(model, opt)
    _step(model, opt, 2)
    _step(model, opt, 3)
    state.epoch = 7
    state.lr_scale = 9.0
    state.batch = 3
    state.restore()
    restored = _flat(model, opt)
    return committed, restored, (state.epoch, state.batch, state.lr_scale)


def test_torch_state_commit_restore_matches_the_reference():
    ref_committed, ref_restored, ref_extras = _torch_state_run(ref_elastic)
    committed, restored, extras = _torch_state_run(port_elastic)
    assert extras == ref_extras == (1, 0, 0.5)
    for a, b in zip(committed + restored, ref_committed + ref_restored,
                    strict=True):
        assert torch.equal(a, b)
    for a, b in zip(restored, committed, strict=True):
        assert torch.equal(a, b)


def test_a_second_restore_gives_the_commit_again():
    """Steps after a restore do not change the commit: a second restore
    with no commit between gives the committed optimizer state again. (The
    JAX package's TorchState hands the commit's own tensors to
    load_state_dict, so its second restore gives the moments of the steps
    in between.)"""
    model = _model()
    opt = torch.optim.AdamW(model.parameters(), lr=0.01)
    state = port_elastic.TorchState(model=model, optimizer=opt, epoch=0)
    _step(model, opt, 1)
    state.commit()
    committed = _flat(model, opt)
    for seed in (2, 3):
        _step(model, opt, seed)
        state.restore()
        for a, b in zip(_flat(model, opt), committed, strict=True):
            assert torch.equal(a, b)


def test_object_state_matches_the_reference():
    def run(mod):
        s = mod.ObjectState(epoch=0, names=["a"])
        s.epoch, s.names = 2, ["a", "b"]
        s.commit()
        s.epoch, s.names = 5, []
        s.restore()
        return s.epoch, s.names

    assert run(port_state) == run(ref_state) == (2, ["a", "b"])


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_elastic_sampler_matches_the_reference(world, monkeypatch):
    def shards(mod):
        out = []
        for r in range(world):
            monkeypatch.setattr(mod, "rank", lambda r=r: r)
            monkeypatch.setattr(mod, "size", lambda: world)
            s = mod.ElasticSampler(list(range(23)), shuffle=True, seed=3)
            first = list(s)
            s.record_batch(0, 2)
            s.record_batch(1, 2)
            s.reset()
            after = list(s)
            s.set_epoch(1)
            out.append((first, after, sorted(s.processed_indices), list(s),
                        len(s)))
        return out

    assert shards(port_elastic) == shards(ref_elastic)


@pytest.mark.parametrize("mode", ["sharded", "fsdp"])
def test_sharded_optimizers_are_refused(mode):
    from horovod_tpu_torch.exceptions import SyncModeIneligibleError
    from horovod_tpu_torch.optimizer import _FsdpOptimizer, _ShardedOptimizer
    from horovod_tpu_torch.parallel.data_parallel import \
        make_elastic_train_step

    cls = _ShardedOptimizer if mode == "sharded" else _FsdpOptimizer
    opt = object.__new__(cls)
    with pytest.raises(ValueError,
                       match=f"sync_mode={mode!r}.*PeerShardedState"):
        port_elastic.TorchState(model=_model(), optimizer=opt)
    with pytest.raises(SyncModeIneligibleError,
                       match=f"does not support sync_mode='{mode}'"):
        make_elastic_train_step(_model(), lambda m, b: m(b).sum(), opt)
