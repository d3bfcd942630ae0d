"""Worker process execution: env plumbing, spawn, output multiplexing.

Port of ``horovod_tpu/runner/exec_utils.py``, itself the analog of
upstream's Gloo launch path (``horovod/runner/gloo_run.py —
launch_gloo``): per-rank env construction, exec on each host (local fork
or ssh), stdout/stderr multiplexed with rank prefixes, first failure
propagated by terminating the rest. One worker per slot (one GPU); the
env block is what ``horovod_tpu_torch/basics.py`` reads, and carries
nothing of JAX's.
"""

from __future__ import annotations

import dataclasses
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Sequence

from .hosts import ProcessAssignment
from .network import is_local


def build_worker_env(
    assignment: ProcessAssignment,
    base_env: dict[str, str],
    coordinator_addr: str,
    coordinator_port: int,
    cpu_mode: bool = False,
    extra_env: dict[str, str] | None = None,
    rendezvous_addr: str | None = None,
    rendezvous_port: int | None = None,
    native_port: int | None = None,
) -> dict[str, str]:
    """The env contract between launcher and worker: exactly what
    ``horovod_tpu_torch.basics.init`` reads.

    The reference's world facts (``HOROVOD_RANK`` et al., written in
    upstream's ``launch_gloo``), the same rank and size as
    ``HOROVOD_PROCESS_ID`` / ``HOROVOD_NUM_PROCESSES``, and
    ``HOROVOD_COORDINATOR_ADDR``: rank 0's host and a port, where ``init()``
    opens torch's TCP store. ``cpu_mode`` hides the cards from the worker
    (``CUDA_VISIBLE_DEVICES=``): its script calls ``init(device="cpu")``,
    and one that does not fails in ``init()``. An elastic worker also gets
    the elastic driver's rendezvous KV (``HOROVOD_RENDEZVOUS_ADDR`` and
    ``_PORT``). ``native_port`` becomes ``HOROVOD_NATIVE_PORT``: the port
    rank 0 listens on for the negotiated runtime's star, on its host
    (``horovod_tpu/runner/exec_utils.py:77-82``).
    """
    a = assignment
    env = dict(base_env)
    env.update(
        {
            "HOROVOD_RANK": str(a.rank),
            "HOROVOD_SIZE": str(a.size),
            "HOROVOD_LOCAL_RANK": str(a.local_rank),
            "HOROVOD_LOCAL_SIZE": str(a.local_size),
            "HOROVOD_CROSS_RANK": str(a.cross_rank),
            "HOROVOD_CROSS_SIZE": str(a.cross_size),
            "HOROVOD_NUM_PROCESSES": str(a.size),
            "HOROVOD_PROCESS_ID": str(a.rank),
            "HOROVOD_COORDINATOR_ADDR":
                f"{coordinator_addr}:{coordinator_port}",
        }
    )
    if rendezvous_addr is not None:
        env["HOROVOD_RENDEZVOUS_ADDR"] = rendezvous_addr
        env["HOROVOD_RENDEZVOUS_PORT"] = str(rendezvous_port)
    # The per-job secret rides the env block even when base_env is empty.
    job_secret = os.environ.get("HOROVOD_SECRET_KEY", "")
    if job_secret and "HOROVOD_SECRET_KEY" not in env:
        env["HOROVOD_SECRET_KEY"] = job_secret
    if native_port is not None:
        env["HOROVOD_NATIVE_PORT"] = str(native_port)
    if cpu_mode:
        env["CUDA_VISIBLE_DEVICES"] = ""
    if extra_env:
        env.update(extra_env)
    return env


@dataclasses.dataclass
class WorkerProc:
    assignment: ProcessAssignment
    popen: subprocess.Popen
    pump: threading.Thread
    # Remote-termination facts (ssh-launched workers only): killing the
    # local ssh client does not kill the remote process tree, so
    # terminate_worker needs the host and a unique marker to pkill by.
    remote_host: str | None = None
    ssh_port: int | None = None
    kill_marker: str | None = None


def _pump_output(
    proc: subprocess.Popen,
    prefix: str,
    sink: Callable[[str], None],
) -> None:
    """Line-multiplex a worker's combined stdout/stderr with a rank prefix.

    Parity: the reference's ``MultiFile``/prefixed streaming in
    ``gloo_run``; rank prefixes like ``[1]<stdout>`` become ``[1] `` here.
    """
    assert proc.stdout is not None
    for raw in iter(proc.stdout.readline, b""):
        # \r\n: ssh -tt allocates a pty, which emits CRLF line endings.
        line = raw.decode(errors="replace").rstrip("\r\n")
        sink(f"{prefix}{line}")
    proc.stdout.close()


_print_lock = threading.Lock()


def _print_line(line: str) -> None:
    """The default sink: whole lines, from every worker's pump thread."""
    with _print_lock:
        print(line, flush=True)


def launch_worker(
    assignment: ProcessAssignment,
    command: Sequence[str],
    env: dict[str, str],
    ssh_port: int | None = None,
    sink: Callable[[str], None] | None = None,
) -> WorkerProc:
    """Start one worker (local subprocess, or ssh for a remote host)."""
    sink = sink or _print_line
    if is_local(assignment.hostname):
        popen = subprocess.Popen(
            list(command),
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        worker = WorkerProc(assignment, popen, None)  # pump set below
    else:
        # Remote: ssh with the env inlined (the reference does the same —
        # env vars exported in the remote command line). The remote shell
        # records its PID — which (under ssh -tt, making it the session
        # and group leader) is the process-group id of the whole worker
        # tree — into a pidfile, so terminate_worker can kill the tree by
        # group. The pidfile lives in a per-user 0700 directory with an
        # unpredictable (random-token) name, and an EXIT trap removes it on
        # normal worker exit so /tmp doesn't accumulate stale files.
        import secrets

        marker = f"hvd_{assignment.rank}_{secrets.token_hex(8)}"
        exports = " ".join(
            f"export {k}={shlex.quote(v)};"
            for k, v in env.items()
            if k.startswith(("HOROVOD_", "CUDA_", "NCCL_", "TORCH_", "PATH",
                             "PYTHON"))
        )
        pidfile = _remote_pidfile(marker)
        # umask scoped to a subshell so worker-written files keep the
        # user's umask; [ -O ] rejects a pre-planted dir owned by another
        # local user (sticky /tmp lets anyone create /tmp/hvd-<victim>,
        # which would let them redirect the group-kill).
        remote_cmd = (
            f'(umask 077; mkdir -p "/tmp/hvd-$(id -un)"); '
            f'[ -O "/tmp/hvd-$(id -un)" ] || '
            f'{{ echo "hvdrun-torch: /tmp/hvd-$(id -un) not owned by us" >&2; '
            f"exit 86; }}; "
            f"echo $$ > {pidfile}; trap 'rm -f {pidfile}' EXIT; "
            f"cd {shlex.quote(os.getcwd())} >/dev/null 2>&1; {exports} "
            + " ".join(shlex.quote(c) for c in command)
        )
        # -tt forces a remote pty: when this ssh client dies, the pty closes
        # and the remote process group gets SIGHUP — so even an unclean
        # launcher death doesn't leave remote workers running.
        ssh_cmd = ["ssh", "-tt", "-o", "StrictHostKeyChecking=no"]
        if ssh_port:
            ssh_cmd += ["-p", str(ssh_port)]
        ssh_cmd += [assignment.hostname, remote_cmd]
        popen = subprocess.Popen(
            ssh_cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        worker = WorkerProc(assignment, popen, None,
                            remote_host=assignment.hostname,
                            ssh_port=ssh_port, kill_marker=marker)
    pump = threading.Thread(
        target=_pump_output,
        args=(popen, f"[{assignment.rank}] ", sink),
        name=f"hvd-pump-{assignment.rank}",
        daemon=True,
    )
    worker.pump = pump
    pump.start()
    return worker


def wait_for_workers(workers: list[WorkerProc],
                     poll_interval: float = 0.1) -> int:
    """Wait for all workers; on first non-zero exit, terminate the rest.

    Returns the first failing exit code, or 0. Parity: the reference
    propagates the first failure and kills remaining workers so a crashed
    rank cannot hang the job (the surviving ranks would block in collectives
    forever — the exact stall the stall inspector warns about).
    """
    pending = {w.assignment.rank: w for w in workers}
    first_rc = 0
    while pending:
        done = [r for r, w in pending.items() if w.popen.poll() is not None]
        for r in done:
            w = pending.pop(r)
            rc = w.popen.returncode
            if rc != 0 and first_rc == 0:
                first_rc = rc if rc is not None else 1
                terminate_workers(list(pending.values()))
        if not done:
            time.sleep(poll_interval)
    for w in workers:
        w.pump.join(timeout=5)
    return first_rc


def _remote_pidfile(marker: str) -> str:
    # $(id -un) expands REMOTELY: a per-user directory (created 0700 by the
    # launch shell's umask) so another local user can't pre-plant a symlink
    # or rewrite the pidfile to aim the group-kill at an arbitrary process.
    return f'"/tmp/hvd-$(id -un)/{marker}.pid"'


def _remote_kill(w: WorkerProc, timeout_s: float = 15.0) -> None:
    """Kill an ssh-launched worker's REMOTE process tree via its pidfile.

    The local ssh client dying only closes the pty (SIGHUP — which a
    nohup'ing or signal-ignoring worker survives), so we explicitly signal
    the remote process group recorded at launch (kill -- -PID falls back to
    the single PID if the group signal fails). TERM is sent synchronously;
    the KILL escalation runs as a detached remote background job so this
    call doesn't block 2s per worker.
    """
    pidfile = _remote_pidfile(w.kill_marker)
    script = (
        f"p=$(cat {pidfile} 2>/dev/null) && "
        "{ kill -TERM -- -$p 2>/dev/null || kill -TERM $p 2>/dev/null; "
        "(sleep 2; kill -KILL -- -$p 2>/dev/null || kill -KILL $p 2>/dev/null) "
        "</dev/null >/dev/null 2>&1 & "
        f"}}; rm -f {pidfile}"
    )
    cmd = ["ssh", "-o", "StrictHostKeyChecking=no", "-o", "BatchMode=yes"]
    if w.ssh_port:
        cmd += ["-p", str(w.ssh_port)]
    cmd += [w.remote_host, script]
    try:
        subprocess.run(cmd, timeout=timeout_s, capture_output=True)
    except (subprocess.TimeoutExpired, OSError):
        pass  # host unreachable: nothing more we can do


def drain_worker(w: WorkerProc, timeout_s: float = 15.0) -> None:
    """Deliver SIGTERM, the graceful-drain signal, to a worker, remote
    process tree included, with no KILL escalation (the caller owns the
    grace wait and any escalation).

    A local ``killpg`` cannot drain an ssh-launched worker: it signals only
    the local ssh client, whose death gives the remote tree SIGHUP, not
    SIGTERM, so the worker's drain handler never runs. Remote workers get
    an explicit ``kill -TERM`` of the pidfile-recorded group instead; the
    pidfile stays for the eventual :func:`terminate_worker`.
    """
    if w.remote_host and w.kill_marker:
        pidfile = _remote_pidfile(w.kill_marker)
        script = (
            f"p=$(cat {pidfile} 2>/dev/null) && "
            "{ kill -TERM -- -$p 2>/dev/null || kill -TERM $p 2>/dev/null; }"
        )
        cmd = ["ssh", "-o", "StrictHostKeyChecking=no", "-o",
               "BatchMode=yes"]
        if w.ssh_port:
            cmd += ["-p", str(w.ssh_port)]
        cmd += [w.remote_host, script]
        try:
            subprocess.run(cmd, timeout=timeout_s, capture_output=True)
        except (subprocess.TimeoutExpired, OSError):
            pass  # host unreachable: the caller's grace/escalation owns it
        return
    try:
        os.killpg(os.getpgid(w.popen.pid), signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        pass


def terminate_worker(w: WorkerProc, grace_s: float = 5.0) -> None:
    """SIGTERM the worker's process group, escalate to SIGKILL.

    For remote (ssh) workers this kills the remote process tree too: the
    explicit pidfile-based group kill runs even when the local ssh client
    already exited — a dropped connection leaves the remote worker running
    (SIGHUP-ignoring/nohup'd processes survive pty teardown), which is
    exactly the leak this path exists to close.
    """
    if w.remote_host and w.kill_marker and not getattr(w, "_remote_killed",
                                                      False):
        w._remote_killed = True
        _remote_kill(w)
    if w.popen.poll() is not None:
        return
    try:
        os.killpg(os.getpgid(w.popen.pid), signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        return
    deadline = time.time() + grace_s
    while time.time() < deadline:
        if w.popen.poll() is not None:
            return
        time.sleep(0.05)
    try:
        os.killpg(os.getpgid(w.popen.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def terminate_workers(workers: Sequence[WorkerProc],
                      grace_s: float = 5.0) -> None:
    """Terminate many workers concurrently.

    Remote terminations each pay an ssh round-trip; a serial loop over
    many workers would block the launcher for their sum — fan out
    instead. Remote workers
    whose local ssh client already exited still need the remote kill.
    """
    workers = [
        w for w in workers
        if w.popen.poll() is None or (w.remote_host and w.kill_marker)
    ]
    if not workers:
        return
    if len(workers) == 1:
        terminate_worker(workers[0], grace_s)
        return
    threads = [
        threading.Thread(target=terminate_worker, args=(w, grace_s),
                         daemon=True)
        for w in workers
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=grace_s + 20.0)


def python_command(script_and_args: Sequence[str]) -> list[str]:
    """Prefix a user command with the current interpreter when it's a .py."""
    cmd = list(script_and_args)
    if cmd and cmd[0].endswith(".py"):
        return [sys.executable] + cmd
    return cmd
