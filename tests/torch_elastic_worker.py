"""Training script of the port's elastic end-to-end tests, run by
``hvdrun-torch --cpu-mode --host-discovery-script ...`` (or, in the
``blocked`` mode, started by the test itself against its own rendezvous
server). ``ELASTIC_TEST_MODE`` picks the scenario:

- ``death``: the worker on ``localhost`` dies at epoch 2, once; the
  survivor finishes alone.
- ``relaunch``: every worker dies at epoch 2, once; the next generation
  resumes from the ``Checkpointer`` that rank 0 saves at each commit.
- ``scale``: trains until it has run two epochs in a world of two (the
  test adds the second host).
- ``observe``: after epoch 2's commit rank 0 scrapes the driver's
  ``/metrics``, ``/timeline``, ``/criticalpath`` and ``/stragglers``
  (waiting until both ranks show in them) into files, then posts the
  coordinated abort; both ranks recover and finish.
- ``blocked``: rank 1 dies (``ELASTIC_TEST_PEER=dead``) or stops itself
  (``hung``) after one allreduce; rank 0 enters a second allreduce and
  reports the error it gets.

Each committed epoch prints ``gen= host= rank= epoch= np= loss=``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402

MODE = os.environ["ELASTIC_TEST_MODE"]
HOST = os.environ["HOROVOD_HOSTNAME"]
TMP = os.environ["ELASTIC_TEST_TMP"]
EPOCHS = 5


def batch(epoch: int, rank: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(100 * epoch + rank)
                            .randn(8, 4).astype(np.float32))


def blocked() -> None:
    hvd.init(device="cpu")
    hvd.allreduce(torch.ones(4))
    if hvd.rank() == 1:
        print("peer ready", flush=True)
        if os.environ["ELASTIC_TEST_PEER"] == "dead":
            os._exit(1)
        from horovod_tpu_torch import faults

        faults.self_suspend()
        return
    print("survivor entering the allreduce", flush=True)
    try:
        hvd.allreduce(torch.ones(4))
    except hvd.HorovodInternalError as e:
        print(f"survivor got HorovodInternalError: {e}", flush=True)
        return
    print("survivor's allreduce returned", flush=True)


def scrape(tmp: str) -> None:
    """Rank 0's view of the driver's four observability routes, once both
    ranks' heartbeats since their third step and their traces have reached
    it."""
    import json
    import re
    import time
    from urllib.request import urlopen

    base = (f"http://{os.environ['HOROVOD_RENDEZVOUS_ADDR']}:"
            f"{os.environ['HOROVOD_RENDEZVOUS_PORT']}")
    deadline = time.time() + 30
    while True:
        metrics = urlopen(f"{base}/metrics").read().decode()
        timeline = json.loads(urlopen(f"{base}/timeline").read())
        tracks = {e["pid"] for e in timeline["traceEvents"]
                  if e["ph"] == "X"}
        steps = re.findall(r'^hvd_worker_steps_total\{.*\} (\d+)', metrics,
                           re.M)
        if (len(steps) == 2 and min(map(int, steps)) >= 3
                and tracks == {0, 1}) or time.time() > deadline:
            break
        time.sleep(0.2)
    bodies = {"metrics.txt": metrics.encode(),
              "timeline.json": json.dumps(timeline).encode(),
              "criticalpath.json": urlopen(f"{base}/criticalpath").read(),
              "stragglers.json": urlopen(f"{base}/stragglers").read()}
    for name, body in bodies.items():
        with open(os.path.join(tmp, name), "wb") as f:
            f.write(body)


def main() -> None:
    hvd.init(device="cpu")
    gen = os.environ["HOROVOD_WORLD_VERSION"]
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1, bias=False)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters())
    ckpt = hvd.Checkpointer(os.path.join(TMP, "ckpt"), max_to_keep=2,
                            async_save=False)
    start = 0
    if MODE == "relaunch" and ckpt.latest_step() is not None:
        saved = ckpt.restore()
        model.load_state_dict(saved["model"])
        start = saved["epoch"]
        print(f"gen={gen} host={HOST} restored epoch={start}", flush=True)
    state = hvd.elastic.TorchState(model=model, optimizer=opt, epoch=start,
                                   at2=0)
    step = hvd.make_elastic_train_step(
        model, lambda m, x: (m(x) ** 2).mean(), opt, loss_is_averaged=False)

    def done() -> bool:
        if MODE == "scale":
            return state.at2 >= 2 or state.epoch >= 400
        return state.epoch >= EPOCHS

    @hvd.elastic.run
    def train(state):
        while not done():
            marker = os.path.join(TMP, "died_" + HOST)
            dies = (MODE == "relaunch"
                    or (MODE == "death" and HOST == "localhost"))
            if dies and state.epoch == 2 and not os.path.exists(marker):
                open(marker, "w").close()
                print(f"gen={gen} host={HOST} dying at epoch 2", flush=True)
                os._exit(1)
            r, n = hvd.rank(), hvd.size()
            loss = float(step(batch(state.epoch, r)))
            epoch = state.epoch
            state.epoch += 1
            if n == 2:
                state.at2 += 1
            if MODE == "scale" and n == 1:
                import time

                time.sleep(0.2)
            state.commit()
            marker = os.path.join(TMP, "observed")
            if MODE == "observe" and state.epoch == 3 and r == 0 \
                    and not os.path.exists(marker):
                open(marker, "w").close()
                scrape(TMP)
                hvd.abort.post("observe: abort after epoch 2's commit")
            if MODE == "relaunch" and r == 0:
                ckpt.save(state.epoch, {"model": model.state_dict(),
                                        "epoch": state.epoch}, wait=True)
            print(f"gen={os.environ['HOROVOD_WORLD_VERSION']} host={HOST} "
                  f"rank={r} epoch={epoch} np={n} loss={loss:.8f}",
                  flush=True)
        return state.epoch

    final = train(state)
    weights = model.weight.detach().numpy().ravel().tolist()
    print(f"host={HOST} finished at epoch {final} weights={weights}",
          flush=True)


if __name__ == "__main__":
    blocked() if MODE == "blocked" else main()
