"""Elastic end to end on gloo through ``hvdrun-torch``: a worker dies and
the survivor finishes alone; a whole generation dies and the driver
relaunches it from the ``Checkpointer``. The hosts are ``localhost`` and
``127.0.0.1`` (one slot each, ``--cpu-mode``), listed by a discovery
script that reads a file, as the JAX package's tests do
(``tests/test_elastic_driver.py:366-600``). Each run's per-rank losses
are held to an in-test replication of the averaged-SGD schedule."""

import os
import re
import stat
import subprocess
import sys

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO_ROOT, "tests", "torch_elastic_worker.py")
LINE = re.compile(r"gen=(\d+) host=(\S+) rank=(\d+) epoch=(\d+) np=(\d+) "
                  r"loss=([-0-9.e]+)")


def write_discovery(tmp_path, hosts):
    hosts_file = tmp_path / "hosts.txt"
    hosts_file.write_text("\n".join(hosts) + "\n")
    script = tmp_path / "discover.sh"
    script.write_text(f"#!/bin/sh\ncat {hosts_file}\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script), hosts_file


def launcher_env(tmp_path, mode, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "JAX_", "XLA_"))}
    env.update({
        "PYTHONPATH": REPO_ROOT,
        "ELASTIC_TEST_MODE": mode,
        "ELASTIC_TEST_TMP": str(tmp_path),
        # A launcher killed by the timeout below leaves no worker behind
        # for long: the workers exit when the driver's KV goes quiet.
        "HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT": "15",
        **extra,
    })
    return env


def launcher_argv(script, np_, min_np, max_np):
    return [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
            "-np", str(np_), "--min-np", str(min_np), "--max-np",
            str(max_np), "--cpu-mode", "--host-discovery-script", script,
            "--elastic-timeout", "60", sys.executable, WORKER]


def losses(text):
    """{(epoch, rank): (gen, np, loss)} from the workers' lines."""
    seen = {}
    for m in LINE.finditer(text):
        gen, _, r, e, n, loss = m.groups()
        seen[(int(e), int(r))] = (int(gen), int(n), float(loss))
    return seen


def schedule(world_at):
    """The averaged-SGD schedule the workers run: epoch e averages the
    gradients of ``world_at(e)`` ranks, rank r on batch (e, r); the
    per-rank losses before each update."""
    torch.manual_seed(0)
    m = torch.nn.Linear(4, 1, bias=False)
    sgd = torch.optim.SGD(m.parameters(), lr=0.05)
    expected = {}
    for e in range(5):
        grads = []
        for r in range(world_at(e)):
            x = torch.from_numpy(np.random.RandomState(100 * e + r)
                                 .randn(8, 4).astype(np.float32))
            sgd.zero_grad()
            loss = (m(x) ** 2).mean()
            expected[(e, r)] = float(loss.detach())
            loss.backward()
            grads.append(m.weight.grad.clone())
        m.weight.grad = sum(grads) / len(grads)
        sgd.step()
    return expected


def run_launcher(argv, env, timeout=150):
    out = subprocess.run(argv, env=env, capture_output=True, text=True,
                         timeout=timeout, cwd=REPO_ROOT)
    return out.returncode, out.stdout + out.stderr


def test_worker_death_survivor_finishes_alone(tmp_path):
    """np = 2, then np = 1: the worker on localhost (rank 1) dies at epoch
    2; the driver reaps it, posts the coordinated abort and re-forms the
    world without it; the survivor takes HorovodInternalError, restores
    its last commit and finishes alone."""
    script, _ = write_discovery(tmp_path, ["localhost", "127.0.0.1"])
    rc, text = run_launcher(launcher_argv(script, 2, 1, 2),
                            launcher_env(tmp_path, "death"))
    assert rc == 0, text
    assert "host=localhost dying at epoch 2" in text, text
    assert "host=127.0.0.1 finished at epoch 5" in text, text
    seen = losses(text)
    expected = schedule(lambda e: 2 if e < 2 else 1)
    assert sorted(seen) == sorted(expected), (sorted(seen), text)
    for key, (gen, n, loss) in seen.items():
        assert n == (2 if key[0] < 2 else 1), (key, n)
        assert gen == (1 if key[0] < 2 else 2), (key, gen)
        assert abs(loss - expected[key]) < 1e-6, (key, loss, expected[key])


def test_generation_crash_relaunch_resumes_from_the_checkpointer(tmp_path):
    """Both workers die at epoch 2. Their hosts are blacklisted; after
    HOROVOD_BLACKLIST_COOLDOWN=1 they come back, and the driver launches a
    new generation of fresh processes, which restores the Checkpointer's
    newest step and trains epochs 2-4 at np = 2 with the losses of an
    uninterrupted run."""
    script, _ = write_discovery(tmp_path, ["localhost", "127.0.0.1"])
    rc, text = run_launcher(
        launcher_argv(script, 2, 2, 2),
        launcher_env(tmp_path, "relaunch", HOROVOD_BLACKLIST_COOLDOWN="1"))
    assert rc == 0, text
    assert text.count("dying at epoch 2") == 2, text
    assert text.count("restored epoch=2") == 2, text
    assert "finished at epoch 5" in text, text
    seen = losses(text)
    expected = schedule(lambda e: 2)
    assert sorted(seen) == sorted(expected), (sorted(seen), text)
    first = seen[(0, 0)][0]
    for key, (gen, n, loss) in seen.items():
        assert n == 2
        assert abs(loss - expected[key]) < 1e-6, (key, loss, expected[key])
        # Epochs 2-4 ran in the relaunched generation.
        assert (gen > first) == (key[0] >= 2), (key, gen, first)
