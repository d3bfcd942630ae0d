"""Training script of the port's peer-rung end-to-end tests
(``tests/test_torch_peercheck.py``, ``tests/test_torch_driver_failover.py``),
run by ``hvdrun-torch --cpu-mode --host-discovery-script ...``.

A small tanh MLP trains ``EPOCHS`` epochs with AdamW under
``hvd.elastic.PeerShardedState`` in the sync mode ``PEER_TEST_SYNC``
(``sharded`` or ``fsdp``); rank r of an n-rank world takes rows
[r*16/n, (r+1)*16/n) of epoch e's batch of 16. ``PEER_TEST_MODE``:

- ``kill``: the worker on ``127.0.0.1`` SIGKILLs itself at the start of
  epoch 2, once; the survivors recover on the peer rung and finish at
  np = 2.
- ``failover``: from epoch 3 on a worker waits for the coordinated abort
  that a driver taking over posts (the test kills the first driver once
  both workers committed epoch 2). Each worker writes its output to
  ``worker-<host>.log`` under ``PEER_TEST_TMP``: its launcher's pipe dies
  with the driver.

Before each commit every rank gathers the full state (parameters and
AdamW state), and rank 0 prints its sha256 (``COMMIT epoch= digest=``);
a peer restore prints the sha256 of the state it rebuilt
(``PEER_RESTORED epoch= digest=``), so the test can hold the two to each
other. A durable restore prints ``DURABLE_RESTORE_USED`` and fails.
"""

import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

EPOCHS = 6
LR, WD = 0.05, 1e-2


def build_model() -> torch.nn.Module:
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 3))


def batch(epoch: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(1000 + epoch)
                            .randn(16, 6).astype(np.float32))


def loss_fn(model, x):
    return (model(x) ** 2).mean()


def digest(flat, opt_state) -> str:
    """sha256 of the full parameters (in the optimizer's order) and the
    monolithic optimizer state (by parameter index and key)."""
    h = hashlib.sha256()
    for t in flat:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    for i in sorted(opt_state["state"]):
        for k in sorted(opt_state["state"][i]):
            h.update(opt_state["state"][i][k].detach().cpu().contiguous()
                     .numpy().tobytes())
    return h.hexdigest()


def main() -> None:
    mode = os.environ["PEER_TEST_MODE"]
    host = os.environ["HOROVOD_HOSTNAME"]
    tmp = os.environ["PEER_TEST_TMP"]
    sync = os.environ["PEER_TEST_SYNC"]
    if mode == "failover":
        fd = os.open(os.path.join(tmp, f"worker-{host}.log"),
                     os.O_WRONLY | os.O_CREAT | os.O_APPEND)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        sys.stdout = os.fdopen(1, "w", buffering=1)
        sys.stderr = os.fdopen(2, "w", buffering=1)
        print(f"pid={os.getpid()} host={host}", flush=True)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.ops.collective_ops import elastic_errors
    from horovod_tpu_torch.optimizer import unshard_opt_state

    hvd.init(device="cpu")
    model = build_model()
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD),
        sync_mode=sync)
    names = {id(p): n for n, p in model.named_parameters()}
    step = hvd.make_train_step(model, loss_fn, opt, loss_is_averaged=False)
    state = hvd.elastic.PeerShardedState(model=model, optimizer=opt, epoch=0)

    def durable():
        print("DURABLE_RESTORE_USED", flush=True)
        raise RuntimeError("the durable rung must not run in this test")

    state.register_durable_restore(durable)
    peer_restore = state._restore_from_peers

    def restore_from_peers():
        peer_restore()
        full = state._full
        flat = (full["flat"] if sync == "fsdp"
                else [full["params"][names[id(p)]] for p in opt._params])
        print(f"PEER_RESTORED host={host} epoch={state.epoch} "
              f"digest={digest(flat, full['opt'])}", flush=True)

    state.register_peer_restore(restore_from_peers)

    def committed_digest() -> str | None:
        flat = (opt.full_parameters() if sync == "fsdp"
                else [p.detach() for p in opt._params])
        stacked = hvd.gather_sharded_state(opt)
        if stacked is None:
            return None
        return digest(flat, unshard_opt_state(opt, stacked))

    @hvd.elastic.run
    def train(state):
        import time

        while state.epoch < EPOCHS:
            e = state.epoch
            marker = os.path.join(tmp, "died")
            if (mode == "kill" and host == "127.0.0.1" and e == 2
                    and not os.path.exists(marker)):
                open(marker, "w").close()
                print(f"host={host} dying at epoch 2", flush=True)
                faults.kill_process(os.getpid())
            if mode == "failover" and e >= 3:
                # Epochs 3 on run in the successor's world: the abort it
                # posts for the old generation ends this wait.
                deadline = time.time() + 120
                while int(os.environ["HOROVOD_WORLD_VERSION"]) < 2:
                    hvd.abort.raise_if_aborted()
                    if time.time() > deadline:
                        print("GATE TIMED OUT", flush=True)
                        os._exit(9)
                    time.sleep(0.05)
            r, n = hvd.rank(), hvd.size()
            rows = slice(r * 16 // n, (r + 1) * 16 // n)
            loss = float(step(batch(e)[rows]))
            with elastic_errors():
                d = committed_digest()
            state.epoch = e + 1
            state.commit()
            if d is not None:
                print(f"COMMIT epoch={e + 1} digest={d}", flush=True)
            print(f"gen={os.environ['HOROVOD_WORLD_VERSION']} host={host} "
                  f"rank={r} epoch={e} np={n} loss={loss:.8f}", flush=True)
        return state.epoch

    final = train(state)
    flat = (opt.full_parameters() if sync == "fsdp"
            else [p.detach() for p in opt._params])
    weights = [float(v) for t in flat for v in t.reshape(-1)]
    print(f"host={host} finished at epoch {final} weights={weights}",
          flush=True)


if __name__ == "__main__":
    main()
