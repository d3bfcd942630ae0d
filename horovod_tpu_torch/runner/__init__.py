"""The launcher of the port: ``hvdrun-torch``.

Port of ``horovod_tpu/runner/``'s static path: the CLI (``launch.py``),
host parsing and one-process-per-GPU rank assignment (``hosts.py``),
LSF and Slurm detection (``schedulers.py``), worker exec with output
multiplexing (``exec_utils.py``) and the pre-flight NIC probe
(``driver_service.py``, ``task_fn.py``). Workers meet at rank 0's TCP
store, so the static path runs no rendezvous server; the elastic path
(``elastic/``: discovery, the driver, the worker context) runs one,
``http/kv_server.py``.

Programmatic entry (parity: ``horovod.run()``)::

    from horovod_tpu_torch.runner import run
    run(["python", "train.py"], np=2, cpu_mode=True)
"""

from __future__ import annotations

from .hosts import (HostInfo, get_host_assignments,  # noqa: F401
                    parse_hostfile, parse_hosts)


def run(
    command: list[str],
    np: int = 1,
    hosts: str | None = None,
    hostfile: str | None = None,
    cpu_mode: bool = False,
    extra_args: list[str] | None = None,
    sink=None,
) -> int:
    """Programmatic launch (the reference's ``horovod.run()``): the first
    failing rank's exit code, or 0. ``sink`` receives each prefixed output
    line (default: print)."""
    # Imported here, so that ``python -m horovod_tpu_torch.runner.launch``
    # finds the module unimported when it runs it.
    from .launch import parse_args, run_static, settings_from_args
    argv: list[str] = ["-np", str(np)]
    if hosts:
        argv += ["-H", hosts]
    if hostfile:
        argv += ["--hostfile", hostfile]
    if cpu_mode:
        argv += ["--cpu-mode"]
    if extra_args:
        argv += extra_args
    argv += command
    settings = settings_from_args(parse_args(argv))
    if settings.elastic:
        from .elastic.driver import run_elastic

        return run_elastic(settings, sink=sink)
    return run_static(settings, sink=sink)
