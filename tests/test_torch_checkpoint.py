"""The port's rank-0 checkpoints (``horovod_tpu_torch/checkpoint.py``).

- The integrity footer and digest equal the JAX package's
  (``horovod_tpu/checkpoint.py``) for the same bytes.
- A corrupt file is detected (``CheckpointCorruptError``), every write
  keeps the previous file at ``.prev``, and ``load_and_broadcast`` falls
  back to it on every rank.
- A train state saved under one sync mode and world size resumes under
  another: AdamW on the MLP of tests/test_overlap.py, the global batch of
  16 rows split evenly over the ranks. Saved after 2 of 4 steps at 4
  sharded ranks and at 4 fsdp ranks, resumed at 2 allreduce ranks; saved
  at 2 allreduce ranks, resumed at 4 sharded ranks and at 4 fsdp ranks.
  The sharded save gathers the state to rank 0 alone. Each resumed run's
  parameters after step 4 are held to an uninterrupted 2-rank allreduce
  run at 1e-4 relative and 1e-5 absolute (float32; the world sizes and
  modes sum in other orders).

Three spawns (2, 4 and 2 gloo ranks) share one directory.
"""

import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-4, atol=1e-5)
LR, WD = 0.05, 1e-2


def _train(hvd, model, opt, batches, rank, n):
    from test_torch_optimizer import _torch_loss

    step = hvd.make_train_step(model, _torch_loss, opt)
    per = 16 // n
    rows = slice(rank * per, (rank + 1) * per)
    return [float(step((torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))))
            for x, y in batches]


def _fresh(hvd, leaves, mode):
    from test_torch_optimizer import _Params

    model = _Params(leaves)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD),
        sync_mode=mode)
    return model, opt


def _final(model, opt, mode):
    full = (opt.full_parameters() if mode == "fsdp"
            else [p.detach() for p in model.parameters()])
    return [t.numpy().copy() for t in full]


def _worker(rank, world, phase, tmp, leaves, batches):
    os.environ["HOROVOD_NUM_PROCESSES"] = str(world)
    os.environ["HOROVOD_PROCESS_ID"] = str(rank)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{tmp}/rendezvous_{phase}")
    res = {}
    if phase == "a":
        model, opt = _fresh(hvd, leaves, "allreduce")
        _train(hvd, model, opt, batches, rank, world)
        res["reference"] = _final(model, opt, "allreduce")
        model, opt = _fresh(hvd, leaves, "allreduce")
        _train(hvd, model, opt, batches[:2], rank, world)
        hvd.save_state_on_rank_0(f"{tmp}/allreduce2.ckpt", opt, model,
                                 step=2)
        path = f"{tmp}/small.ckpt"
        hvd.save_on_rank_0(path, {"v": 1})
        hvd.save_on_rank_0(path, {"v": 2})
        hvd.barrier()
        if rank == 0:
            with open(path, "r+b") as f:
                f.seek(10)
                f.write(b"\x00\xff\x00")
        hvd.barrier()
        res["fallback"] = hvd.load_and_broadcast(path)["v"]
    elif phase == "b":
        model, opt = _fresh(hvd, leaves, "sharded")
        _train(hvd, model, opt, batches[:2], rank, world)
        hvd.save_state_on_rank_0(f"{tmp}/sharded4.ckpt", opt, model, step=2)
        stacked = hvd.init_sharded_state(opt)
        gathered = hvd.gather_sharded_state(opt)
        res["root_only"] = (gathered is None) == (rank != 0)
        res["root_rows_equal"] = gathered is None or all(
            torch.equal(gathered["state"][i][k], v)
            for i, st in stacked["state"].items() for k, v in st.items())
        model, opt = _fresh(hvd, leaves, "fsdp")
        _train(hvd, model, opt, batches[:2], rank, world)
        hvd.save_state_on_rank_0(f"{tmp}/fsdp4.ckpt", opt, model, step=2)
        for mode in ("sharded", "fsdp"):
            model, opt = _fresh(hvd, leaves, mode)
            obj = hvd.load_state_and_broadcast(f"{tmp}/allreduce2.ckpt", opt,
                                               model)
            assert obj["step"] == 2
            _train(hvd, model, opt, batches[2:], rank, world)
            res[f"from_allreduce2_{mode}"] = _final(model, opt, mode)
    else:
        model, opt = _fresh(hvd, leaves, "allreduce")
        hvd.load_state_and_broadcast(f"{tmp}/sharded4.ckpt", opt, model)
        _train(hvd, model, opt, batches[2:], rank, world)
        res["from_sharded4_allreduce"] = _final(model, opt, "allreduce")
        model, opt = _fresh(hvd, leaves, "allreduce")
        hvd.load_state_and_broadcast(f"{tmp}/fsdp4.ckpt", opt, model)
        _train(hvd, model, opt, batches[2:], rank, world)
        res["from_fsdp4_allreduce"] = _final(model, opt, "allreduce")
    np.savez(f"{tmp}/{phase}{rank}.npz",
             **{f"{k}.{i}" if isinstance(v, list) else k: a
                for k, v in res.items()
                for i, a in (enumerate(v) if isinstance(v, list)
                             else [(0, np.array(v))])})
    hvd.shutdown()


def _spawn(world, phase, tmp, leaves, batches):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, phase, str(tmp), leaves, batches))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), (
        phase, [p.exitcode for p in procs])
    return [dict(np.load(tmp / f"{phase}{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_optimizer import _problem

    leaves, batches = _problem()
    batches = batches[:4]
    tmp = tmp_path_factory.mktemp("torch_checkpoint")
    out = {}
    for world, phase in ((2, "a"), (4, "b"), (2, "c")):
        out[phase] = _spawn(world, phase, tmp, leaves, batches)
    return out, len(leaves)


def test_footer_and_digest_equal_jax():
    from horovod_tpu import checkpoint as jckpt
    from horovod_tpu_torch import checkpoint as tckpt

    for payload in (b"", b"horovod", bytes(range(256)) * 37):
        assert tckpt._with_footer(payload) == jckpt._with_footer(payload)
        assert tckpt.payload_digest(payload) == jckpt.payload_digest(payload)
    assert tckpt._CKPT_MAGIC == jckpt._CKPT_MAGIC


def test_corrupt_file_is_detected_and_prev_kept(tmp_path):
    from horovod_tpu_torch import checkpoint as tckpt
    from horovod_tpu_torch.exceptions import CheckpointCorruptError

    def read(p):
        with open(p, "rb") as f:
            return tckpt._verified(f.read(), p)

    path = str(tmp_path / "state.ckpt")
    for v in (1, 2):
        tckpt.atomic_install(path, tckpt._with_footer(tckpt._dumps(
            {"v": v, "t": torch.arange(5) * v})))
    assert read(path)["v"] == 2
    assert read(path + ".prev")["v"] == 1
    assert [w for _, w in tckpt.atomic_read(path)] == ["current", "prev"]
    with open(path, "r+b") as f:
        f.seek(5)
        f.write(b"\xff")
    with pytest.raises(CheckpointCorruptError, match="integrity"):
        read(path)
    assert read(path + ".prev")["v"] == 1
    os.unlink(path)
    assert [w for _, w in tckpt.atomic_read(path)] == ["prev"]


def test_sharded_state_gathers_to_rank_0_only(runs):
    """A sharded save gathers the optimizer state to rank 0 alone; rank 0's
    rows are those of the all-rank ``init_sharded_state``."""
    out, _ = runs
    assert [bool(r["root_only"]) for r in out["b"]] == [True] * 4
    assert all(bool(r["root_rows_equal"]) for r in out["b"])


def test_load_falls_back_to_prev_on_every_rank(runs):
    out, _ = runs
    assert [int(r["fallback"]) for r in out["a"]] == [1, 1]


@pytest.mark.parametrize("phase,key", [
    ("c", "from_sharded4_allreduce"),
    ("c", "from_fsdp4_allreduce"),
    ("b", "from_allreduce2_sharded"),
    ("b", "from_allreduce2_fsdp")])
def test_resume_across_modes_and_world_sizes(runs, phase, key):
    out, n_leaves = runs
    reference = out["a"][0]
    for res in out[phase]:
        for i in range(n_leaves):
            np.testing.assert_allclose(res[f"{key}.{i}"],
                                       reference[f"reference.{i}"],
                                       err_msg=f"{key} leaf {i}", **TOL)
