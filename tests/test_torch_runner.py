"""The port's launcher (horovod_tpu_torch.runner, ``hvdrun-torch``) against
the JAX package's (horovod_tpu.runner) wherever the concept survives, and
end to end on the CPU.

Held equal on the same inputs: host and hostfile parsing (and their
errors), the flags-to-env table, LSF and Slurm detection, the config
file's precedence, and the rank facts of one slot per host. The port
assigns one process per slot (one GPU each), upstream Horovod's rule
(``horovod/runner/common/util/hosts.py — get_host_assignments``), written
out below as the expected tables. ``build_worker_env`` carries exactly the
keys ``horovod_tpu_torch.basics`` reads and nothing of JAX's. End to end,
``python -m horovod_tpu_torch.runner.launch -np 2 --cpu-mode`` runs two
gloo workers that check an Adasum allreduce and a SyncBatchNorm layer; a
rank that exits 3 makes the launcher return 3 and terminate the other;
the elastic flags raise instead of launching statically.
"""

import os
import subprocess
import sys
import textwrap
import time

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOST_SPECS = ["a:4,b:4", "localhost", "h1:2,h2,h3:8", "n-01:16"]
BAD_HOST_SPECS = ["a:0", "a:x", "a:2,a:3", "", " , "]
FLAG_SETS = [
    [],
    ["--fusion-threshold-mb", "32", "--log-level", "debug"],
    ["--log-level", "error", "--fusion-threshold-mb", "0"],
    # The observability plane's flags.
    ["--timeline-filename", "t.json"],
    ["--timeline-filename", "t.json", "--timeline-mark-cycles"],
    ["--stall-check-time", "30"],
    ["--stall-check-time", "1.5", "--stall-shutdown-time", "60"],
    # The autotuner's flags.
    ["--autotune"],
    ["--autotune-log-file", "a.csv"],
    ["--autotune", "--autotune-log-file", "tune.jsonl",
     "--fusion-threshold-mb", "4"],
    # The negotiated runtime's cadence and response cache.
    ["--cycle-time-ms", "2.5"],
    ["--cache-capacity", "0"],
    ["--cycle-time-ms", "5", "--cache-capacity", "64", "--autotune"],
]
# The reference's runtime flags with no counterpart in the port: the
# hierarchical 2-D mesh.
UNREAD_FLAGS = [
    ["--hierarchical-allreduce"],
]
SCHEDULER_ENVS = [
    {"LSB_JOBID": "7", "LSB_MCPU_HOSTS": "batch1 1 gpu01 4 gpu02 4"},
    {"LSB_JOBID": "7", "LSB_HOSTS": "h1 h1 h2 h2 h2"},
    {"SLURM_JOB_ID": "9", "SLURM_JOB_NODELIST": "gpu[001-003,007],login1",
     "SLURM_TASKS_PER_NODE": "4(x3),2,1"},
    {"SLURM_JOB_ID": "9", "SLURM_NODELIST": "node[08-10]"},
    {},
]
# Upstream's rule: (hosts, np) -> (hostname, rank, local_rank, local_size,
# cross_rank, cross_size) per rank.
ASSIGNMENTS = [
    ("a:4,b:4", 8, [("a", 0, 0, 4, 0, 2), ("a", 1, 1, 4, 0, 2),
                    ("a", 2, 2, 4, 0, 2), ("a", 3, 3, 4, 0, 2),
                    ("b", 4, 0, 4, 1, 2), ("b", 5, 1, 4, 1, 2),
                    ("b", 6, 2, 4, 1, 2), ("b", 7, 3, 4, 1, 2)]),
    # Hosts are filled in order: -np 5 leaves one process on b.
    ("a:4,b:4", 5, [("a", 0, 0, 4, 0, 2), ("a", 1, 1, 4, 0, 1),
                    ("a", 2, 2, 4, 0, 1), ("a", 3, 3, 4, 0, 1),
                    ("b", 4, 0, 1, 1, 2)]),
    # Uneven hosts: cross_rank counts the hosts with that local rank.
    ("a:1,b:2,c:2", None, [("a", 0, 0, 1, 0, 3), ("b", 1, 0, 2, 1, 3),
                           ("b", 2, 1, 2, 0, 2), ("c", 3, 0, 2, 2, 3),
                           ("c", 4, 1, 2, 1, 2)]),
    ("localhost:2", None, [("localhost", 0, 0, 2, 0, 1),
                           ("localhost", 1, 1, 2, 0, 1)]),
]


def _hosts(hosts):
    return [(h.hostname, h.slots) for h in hosts]


@pytest.mark.parametrize("spec", HOST_SPECS)
def test_parse_hosts_matches_reference(spec):
    from horovod_tpu.runner import hosts as ref
    from horovod_tpu_torch.runner import hosts

    assert _hosts(hosts.parse_hosts(spec)) == _hosts(ref.parse_hosts(spec))


@pytest.mark.parametrize("spec", BAD_HOST_SPECS)
def test_bad_host_specs_raise_as_the_reference(spec):
    from horovod_tpu.runner import hosts as ref
    from horovod_tpu_torch.runner import hosts

    with pytest.raises(ValueError) as want:
        ref.parse_hosts(spec)
    with pytest.raises(ValueError) as got:
        hosts.parse_hosts(spec)
    assert str(got.value) == str(want.value)


def test_parse_hostfile_matches_reference(tmp_path):
    from horovod_tpu.runner import hosts as ref
    from horovod_tpu_torch.runner import hosts

    path = tmp_path / "hostfile"
    path.write_text("# cluster\nnode1 slots=8\nnode2:4\n\nnode3  # one\n"
                    "node4 slots = 2\n")
    assert _hosts(hosts.parse_hostfile(str(path))) == _hosts(
        ref.parse_hostfile(str(path))) == [("node1", 8), ("node2", 4),
                                           ("node3", 1), ("node4", 2)]
    empty = tmp_path / "empty"
    empty.write_text("# nothing\n")
    for parse in (hosts.parse_hostfile, ref.parse_hostfile):
        with pytest.raises(ValueError, match="contains no hosts"):
            parse(str(empty))


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_flags_to_env_match_reference(flags):
    from horovod_tpu.runner import launch as ref
    from horovod_tpu_torch.runner import launch

    argv = ["-np", "2", *flags, "python", "train.py"]
    assert launch.args_to_env(launch.parse_args(argv)) == ref.args_to_env(
        ref.parse_args(argv))


@pytest.mark.parametrize("flags", UNREAD_FLAGS, ids=lambda f: f[0])
def test_flags_the_port_does_not_read_are_refused(flags, capsys):
    from horovod_tpu_torch.runner import launch

    with pytest.raises(SystemExit) as info:
        launch.parse_args(["-np", "2", *flags, "python", "train.py"])
    assert info.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_config_file_matches_reference(tmp_path):
    from horovod_tpu.runner import launch as ref
    from horovod_tpu_torch.runner import launch

    cfg = tmp_path / "hvd.yml"
    cfg.write_text("cpu-mode: true\nfusion-threshold-mb: 16\n"
                   "log-level: debug\nnum_proc: 4\n")
    argv = ["-np", "2", "--config-file", str(cfg), "python", "t.py"]
    got, want = launch.parse_args(argv), ref.parse_args(argv)
    for key in ("num_proc", "cpu_mode", "fusion_threshold_mb", "log_level"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.num_proc == 2  # the command line beats the file
    assert launch.args_to_env(got) == ref.args_to_env(want)
    bad = tmp_path / "bad.yml"
    bad.write_text("bogus-flag: 1\n")
    for parse in (launch.parse_args, ref.parse_args):
        with pytest.raises(SystemExit, match="unknown option"):
            parse(["--config-file", str(bad), "python", "t.py"])


@pytest.mark.parametrize("environ", SCHEDULER_ENVS,
                         ids=["lsf_mcpu", "lsf_hosts", "slurm_tasks",
                              "slurm_nodelist", "none"])
def test_scheduler_detection_matches_reference(environ):
    from horovod_tpu.runner import schedulers as ref
    from horovod_tpu_torch.runner import schedulers

    got = schedulers.detect_scheduler_hosts(environ)
    want = ref.detect_scheduler_hosts(environ)
    assert (got is None and want is None) or _hosts(got) == _hosts(want)


def test_malformed_allocations_raise_as_the_reference():
    from horovod_tpu.runner import schedulers as ref
    from horovod_tpu_torch.runner import schedulers

    for environ in ({"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "h1 2 h2"},
                    {"SLURM_JOB_ID": "1", "SLURM_NODELIST": "n[3-1]"}):
        with pytest.raises(ValueError) as want:
            ref.detect_scheduler_hosts(environ)
        with pytest.raises(ValueError) as got:
            schedulers.detect_scheduler_hosts(environ)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec,np_,want", ASSIGNMENTS)
def test_one_process_per_slot_by_upstreams_rule(spec, np_, want):
    from horovod_tpu_torch.runner.hosts import (get_host_assignments,
                                                parse_hosts)

    got = get_host_assignments(parse_hosts(spec), np_)
    assert [(a.hostname, a.rank, a.local_rank, a.local_size, a.cross_rank,
             a.cross_size) for a in got] == want
    assert {a.size for a in got} == {len(want)}


@pytest.mark.parametrize("spec", ["a,b,c", "a:1,b:1", "localhost"])
def test_one_slot_per_host_gives_the_reference_facts(spec):
    from horovod_tpu.runner import hosts as ref
    from horovod_tpu_torch.runner import hosts

    facts = ("hostname", "rank", "size", "local_rank", "local_size",
             "cross_rank", "cross_size")
    got = hosts.get_host_assignments(hosts.parse_hosts(spec))
    want = ref.get_host_assignments(ref.parse_hosts(spec))
    assert [[getattr(a, f) for f in facts] for a in got] == [
        [getattr(a, f) for f in facts] for a in want]


def test_more_processes_than_slots_raise():
    from horovod_tpu_torch.runner.hosts import (HostInfo,
                                                get_host_assignments)
    from horovod_tpu_torch.runner.launch import (parse_args,
                                                 settings_from_args)

    with pytest.raises(ValueError, match="2 slot"):
        get_host_assignments([HostInfo("a", 2)], 3)
    with pytest.raises(SystemExit, match="exceeds the 8 slot"):
        settings_from_args(parse_args(["-np", "9", "-H", "a:4,b:4",
                                       "python", "t.py"]))
    # Without -H, -np N means localhost:N.
    settings = settings_from_args(parse_args(["-np", "4", "train.py"]))
    assert _hosts(settings.hosts) == [("localhost", 4)]
    assert settings.command == [sys.executable, "train.py"]


def test_worker_env_is_what_init_reads(monkeypatch):
    from horovod_tpu_torch.runner.exec_utils import build_worker_env
    from horovod_tpu_torch.runner.hosts import (get_host_assignments,
                                                parse_hosts)

    monkeypatch.setenv("HOROVOD_SECRET_KEY", "s3cret")
    a = get_host_assignments(parse_hosts("a:2,b:2"))[3]
    base = {"PATH": "/bin", "XLA_FLAGS": "--keep"}
    env = build_worker_env(a, base, "a", 1234, extra_env={
        "HOROVOD_LOG_LEVEL": "debug"})
    assert {k: v for k, v in env.items() if k.startswith("HOROVOD_")} == {
        "HOROVOD_RANK": "3", "HOROVOD_SIZE": "4", "HOROVOD_LOCAL_RANK": "1",
        "HOROVOD_LOCAL_SIZE": "2", "HOROVOD_CROSS_RANK": "1",
        "HOROVOD_CROSS_SIZE": "2", "HOROVOD_NUM_PROCESSES": "4",
        "HOROVOD_PROCESS_ID": "3", "HOROVOD_COORDINATOR_ADDR": "a:1234",
        "HOROVOD_SECRET_KEY": "s3cret", "HOROVOD_LOG_LEVEL": "debug"}
    # The base env passes through; nothing of JAX's is added.
    assert env["PATH"] == "/bin" and env["XLA_FLAGS"] == "--keep"
    assert not {"JAX_PLATFORMS", "HOROVOD_NATIVE_PORT",
                "CUDA_VISIBLE_DEVICES"} & set(env)
    cpu = build_worker_env(a, base, "a", 1234, cpu_mode=True)
    assert cpu["CUDA_VISIBLE_DEVICES"] == ""


def test_worker_env_carries_the_native_port_as_the_reference():
    from horovod_tpu.runner.exec_utils import build_worker_env as ref_env
    from horovod_tpu.runner.hosts import (get_host_assignments as ref_assign,
                                          parse_hosts as ref_parse)
    from horovod_tpu_torch.runner.exec_utils import build_worker_env
    from horovod_tpu_torch.runner.hosts import (get_host_assignments,
                                                parse_hosts)

    a = get_host_assignments(parse_hosts("a:2,b:2"))[2]
    ref_a = ref_assign(ref_parse("a:2,b:2"))[0]
    got = build_worker_env(a, {}, "a", 1234, native_port=4321)
    want = ref_env(ref_a, {}, "a", 99, "a", 1234, native_port=4321)
    assert got["HOROVOD_NATIVE_PORT"] == want["HOROVOD_NATIVE_PORT"] == "4321"


def test_remote_workers_get_the_cuda_and_nccl_env(monkeypatch):
    from horovod_tpu_torch.runner import exec_utils
    from horovod_tpu_torch.runner.hosts import HostInfo, get_host_assignments

    captured = {}

    class FakePopen:
        def __init__(self, cmd, **kwargs):
            captured["cmd"] = cmd
            self.stdout = iter([])

        def poll(self):
            return 0

    monkeypatch.setattr(exec_utils.subprocess, "Popen", FakePopen)
    monkeypatch.setattr(exec_utils, "_pump_output", lambda *a: None)
    a = get_host_assignments([HostInfo("remote-node-1", 1)])[0]
    exec_utils.launch_worker(a, ["python", "train.py"], {
        "HOROVOD_RANK": "0", "CUDA_VISIBLE_DEVICES": "0,1",
        "NCCL_DEBUG": "INFO", "TORCH_NCCL_BLOCKING_WAIT": "1",
        "PYTHONPATH": "/repo", "JAX_PLATFORMS": "cpu", "HOME": "/home/u"})
    remote = captured["cmd"][-1]
    for key in ("HOROVOD_RANK", "CUDA_VISIBLE_DEVICES", "NCCL_DEBUG",
                "TORCH_NCCL_BLOCKING_WAIT", "PYTHONPATH"):
        assert f"export {key}=" in remote, key
    assert "JAX_PLATFORMS" not in remote and "HOME=" not in remote
    assert captured["cmd"][:2] == ["ssh", "-tt"]


@pytest.mark.parametrize("flag", [["--min-np", "1"], ["--max-np", "4"],
                                  ["--host-discovery-script", "d.sh"],
                                  ["--elastic-timeout", "600"]])
def test_elastic_flags_raise(flag, monkeypatch):
    """The elastic flags no longer raise: each parses to the elastic
    settings the reference's ``settings_from_args`` derives (a discovery
    script makes the launch elastic; -np is the target size, min/max
    default to it)."""
    from horovod_tpu.runner.launch import parse_args as ref_parse
    from horovod_tpu.runner.launch import settings_from_args as ref_settings
    from horovod_tpu_torch.runner.launch import (parse_args,
                                                 settings_from_args)

    monkeypatch.delenv("HOROVOD_ELASTIC_TIMEOUT", raising=False)
    argv = ["-np", "2", "--host-discovery-script", "d.sh", *flag,
            "python", "train.py"]
    got, want = (settings_from_args(parse_args(argv)),
                 ref_settings(ref_parse(argv)))
    fields = ("num_proc", "hosts", "elastic", "min_np", "max_np",
              "discovery_script", "elastic_timeout")
    assert ({f: getattr(got, f) for f in fields}
            == {f: getattr(want, f) for f in fields})
    assert got.elastic and got.discovery_script == "d.sh"


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    assert n == 2 and hvd.local_size() == 2 and hvd.local_rank() == r
    assert hvd.cross_rank() == 0 and hvd.cross_size() == 1
    assert not torch.cuda.is_available()
    # Adasum of a and 2a is 1.5a (each side keeps half of itself), and of
    # orthogonal tensors their sum.
    a = torch.tensor([1.0, -2.0, 0.5])
    assert torch.allclose(hvd.allreduce(a * (r + 1), op=hvd.Adasum), 1.5 * a)
    e = torch.eye(2)[r]
    assert torch.equal(hvd.allreduce(e, op=hvd.Adasum), torch.ones(2))
    # SyncBatchNorm over ranks holding 3 and 1 images: BatchNorm over all 4.
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 2, 3, 3).astype(np.float32))
    mine = x[:3] if r == 0 else x[3:]
    y = hvd.SyncBatchNorm(2)(mine)
    want = torch.nn.functional.batch_norm(x, None, None, training=True)
    assert torch.allclose(y, want[:3] if r == 0 else want[3:], atol=1e-5)
    print(f"worker {r} ok", flush=True)
    hvd.shutdown()
""")


def _launch(argv, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *argv],
        cwd=REPO_ROOT, env=dict(os.environ, PYTHONPATH=REPO_ROOT),
        capture_output=True, text=True, timeout=timeout)


def test_two_cpu_workers_end_to_end(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = _launch(["-np", "2", "--cpu-mode", "python", str(script)])
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert "[0] worker 0 ok" in lines and "[1] worker 1 ok" in lines
    assert all(line[:4] in ("[0] ", "[1] ") for line in lines)


def test_a_failing_rank_ends_the_job_with_its_code(tmp_path):
    from horovod_tpu_torch.runner.launch import (parse_args, run_static,
                                                 settings_from_args)

    script = tmp_path / "fail.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        if os.environ["HOROVOD_RANK"] == "1":
            sys.exit(3)
        print("rank 0 waiting", flush=True)
        time.sleep(60)
        print("rank 0 finished", flush=True)
    """))
    lines = []
    t0 = time.monotonic()
    rc = run_static(settings_from_args(parse_args(
        ["-np", "2", "--cpu-mode", sys.executable, str(script)])),
        sink=lines.append)
    assert rc == 3
    assert time.monotonic() - t0 < 30  # rank 0 was terminated, not awaited
    assert "[0] rank 0 finished" not in lines


def test_an_init_without_cpu_in_cpu_mode_fails(tmp_path):
    """--cpu-mode hides the cards: a script that forgets init(device='cpu')
    fails in init(); it does not land on the CPU silently."""
    script = tmp_path / "forgot.py"
    script.write_text("import horovod_tpu_torch as hvd\nhvd.init()\n")
    out = _launch(["-np", "1", "--cpu-mode", "python", str(script)])
    assert out.returncode != 0
    assert "device='cpu'" in out.stdout


def test_network_probe_finds_this_host():
    from horovod_tpu_torch.runner import secret
    from horovod_tpu_torch.runner.hosts import HostInfo
    from horovod_tpu_torch.runner.launch import _network_probe

    os.environ.setdefault(secret.ENV_KEY, secret.make_secret_key())
    addrs = _network_probe([HostInfo("localhost", 2)], None, 60.0, None)
    assert addrs is not None and set(addrs) == {"localhost"}


def test_check_build_and_version(capsys):
    from horovod_tpu_torch.runner.launch import run_commandline

    assert run_commandline(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert "[X] adasum" in out and "[X] sync batch norm" in out
    assert "[X] elastic" in out and "Gloo" in out
    assert run_commandline(["--version"]) == 0
    assert capsys.readouterr().out.startswith("horovod_tpu_torch")


def test_the_launcher_does_not_import_torch():
    """The launcher starts the workers without paying torch's import: the
    package imports a module at the first use of one of its names."""
    code = ("import sys\n"
            "import horovod_tpu_torch.runner.launch\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "import horovod_tpu_torch as hvd\n"
            "assert hvd.Adasum == 'adasum' and 'torch' in sys.modules\n"
            "missing = [n for n in hvd.__all__ if not hasattr(hvd, n)]\n"
            "assert not missing, missing\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
