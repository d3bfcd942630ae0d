"""Training script of the robustness plane's end-to-end tests
(``tests/test_torch_policy.py``), run by the port's elastic driver in
``--cpu-mode`` over three one-slot local hosts, two in the world and one
warm spare (``HOROVOD_WARM_SPARES=1``). Every worker prints one line per
step, ``rank= host= epoch= np= gen= loss= w=`` (``w``: the first
parameter's first value), and ``host= finished at epoch N`` at the end.

``ROBUST_TEST_MODE``:

- ``sdc``: a tanh MLP, SGD with momentum under ``sync_mode="sharded"``
  and ``hvd.elastic.PeerShardedState``; the worker of the host named by
  ``ROBUST_TEST_CORRUPT`` arms ``grad.corrupt`` (48 bits) from its third
  commit on, so its committed snapshots carry flipped bits while its live
  state stays clean. A durable restore prints ``DURABLE_RESTORE_USED`` and
  fails.
- ``straggler``: a linear model, SGD under ``hvd.elastic.TorchState``;
  the worker of the host named by ``ROBUST_TEST_STRAGGLER`` enters every
  watched step ``ROBUST_TEST_DELAY`` seconds late (``worker.step``).

Rank r of epoch e trains on ``RandomState(100 e + r)``'s batch, so the
losses of an uninterrupted two-rank run are known whichever hosts hold
the ranks.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

LR, MOMENTUM = 0.05, 0.9


def build(mode):
    torch.manual_seed(0)
    if mode == "sdc":
        return torch.nn.Sequential(torch.nn.Linear(4, 6), torch.nn.Tanh(),
                                   torch.nn.Linear(6, 1))
    return torch.nn.Linear(4, 1, bias=False)


def batch(epoch, rank):
    return torch.from_numpy(np.random.RandomState(100 * epoch + rank)
                            .randn(8, 4).astype(np.float32))


def loss_fn(model, x):
    return (model(x) ** 2).mean()


def expected(mode, epochs):
    """{(epoch, rank): loss} of an uninterrupted two-rank run, and the
    first parameter's first value after each epoch."""
    model = build(mode)
    opt = torch.optim.SGD(model.parameters(), lr=LR,
                          momentum=MOMENTUM if mode == "sdc" else 0.0)
    losses, w = {}, {}
    for e in range(epochs):
        grads = []
        for r in range(2):
            opt.zero_grad()
            loss = loss_fn(model, batch(e, r))
            losses[(e, r)] = float(loss.detach())
            loss.backward()
            grads.append([p.grad.clone() for p in model.parameters()])
        for p, g0, g1 in zip(model.parameters(), *grads):
            p.grad = (g0 + g1) / 2
        opt.step()
        w[e] = float(next(model.parameters()).reshape(-1)[0])
    return losses, w


def main():
    mode = os.environ["ROBUST_TEST_MODE"]
    host = os.environ["HOROVOD_HOSTNAME"]
    epochs = int(os.environ["ROBUST_TEST_EPOCHS"])
    pause = float(os.environ.get("ROBUST_TEST_STEP_SLEEP", "0"))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults

    if mode == "sdc" and host == os.environ.get("ROBUST_TEST_CORRUPT"):
        faults.inject(faults.GRAD_CORRUPT, "corrupt", arg=48, at=3,
                      count=10 ** 9)
    if mode == "straggler" and host == os.environ.get(
            "ROBUST_TEST_STRAGGLER"):
        faults.inject(faults.WORKER_STEP, "delay",
                      arg=float(os.environ["ROBUST_TEST_DELAY"]), at=1,
                      count=10 ** 9)
    hvd.init(device="cpu")
    model = build(mode)
    if mode == "sdc":
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
            sync_mode="sharded")
        step = hvd.make_train_step(model, loss_fn, opt,
                                   loss_is_averaged=False)
        state = hvd.elastic.PeerShardedState(model=model, optimizer=opt,
                                             epoch=0)

        def durable():
            print("DURABLE_RESTORE_USED", flush=True)
            raise RuntimeError("the durable rung must not run in this test")

        state.register_durable_restore(durable)
    else:
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=LR),
            named_parameters=model.named_parameters())
        step = hvd.make_elastic_train_step(model, loss_fn, opt,
                                           loss_is_averaged=False)
        state = hvd.elastic.TorchState(model=model, optimizer=opt, epoch=0)

    @hvd.elastic.run
    def train(state):
        while state.epoch < epochs:
            e, r, n = state.epoch, hvd.rank(), hvd.size()
            loss = float(step(batch(e, r)))
            w = float(next(model.parameters()).detach().reshape(-1)[0])
            # Printed before the commit: a commit that raises (a drain, a
            # host update) lands its state all the same.
            print(f"rank={r} host={host} epoch={e} np={n} "
                  f"gen={os.environ['HOROVOD_WORLD_VERSION']} "
                  f"loss={loss:.8f} w={w:.8f}", flush=True)
            state.epoch = e + 1
            state.commit()
            time.sleep(pause)
        return state.epoch

    done = train(state)
    print(f"host={host} finished at epoch {done}", flush=True)


if __name__ == "__main__":
    main()
