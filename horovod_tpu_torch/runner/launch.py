"""``hvdrun-torch``: the static launcher of the port.

Port of ``horovod_tpu/runner/launch.py`` (``parse_args``, ``args_to_env``,
``settings_from_args``, ``run_static``, ``check_build``,
``run_commandline``, ``main``), itself a re-design of upstream's
``horovodrun`` (``horovod/runner/launch.py``). The flags keep the
reference's names; the runtime flags the port reads
(``--fusion-threshold-mb``, ``--cycle-time-ms``, ``--cache-capacity``,
``--log-level``, ``--timeline-filename``, ``--timeline-mark-cycles``,
``--stall-check-time``, ``--stall-shutdown-time``, ``--autotune``,
``--autotune-log-file``) become the ``HOROVOD_*`` env vars the workers
read; the cycle time and the cache capacity are the negotiated runtime's
(``runtime``). Each worker also gets ``HOROVOD_NATIVE_PORT``, the port its
rank 0 listens on for the negotiated runtime's star. The reference's
``--hierarchical-allreduce`` is refused as an unknown flag: it feeds a
hierarchical 2-D mesh, not ported yet (the comms planner's ``two_level``
schedule, ``HOROVOD_COMMS_PLANNER``, composes the same legs per bucket).

The process model is upstream Horovod's, not the JAX package's: one
process per slot, one slot per GPU (``hosts.get_host_assignments``).
``-H a:4,b:4 -np 8`` starts four processes on each host; without ``-H``,
``-np N`` means ``localhost:N``. Workers meet at rank 0's TCP store
(``HOROVOD_COORDINATOR_ADDR``), which ``init()`` opens, so the static path
needs no rendezvous server. ``--cpu-mode`` hides the cards
(``CUDA_VISIBLE_DEVICES=``): the script calls ``init(device="cpu")``.

Elastic launch (``--host-discovery-script``, with ``--min-np``,
``--max-np`` and ``--elastic-timeout``; ``horovod_tpu/runner/launch.py:
197-260`` and :418-421) runs the elastic driver (``elastic/driver.py``)
instead: hosts come from the discovery script, one worker per slot, and
the world re-forms as workers fail or hosts come and go.

Usage::

    hvdrun-torch -np 4 python train.py              # 4 cards of this host
    hvdrun-torch -np 8 -H host1:4,host2:4 python train.py
    hvdrun-torch -np 2 --cpu-mode python train.py   # 2 gloo processes
    hvdrun-torch -np 2 --min-np 1 --max-np 4 \
        --host-discovery-script ./discover.sh python train.py   # elastic
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from . import network
from . import secret as _secret
from .exec_utils import (
    build_worker_env,
    launch_worker,
    python_command,
    terminate_workers,
    wait_for_workers,
)
from .hosts import (
    HostInfo,
    get_host_assignments,
    parse_hostfile,
    parse_hosts,
)
from .schedulers import detect_scheduler_hosts


@dataclasses.dataclass
class Settings:
    """Resolved launch settings (reference: ``horovod/runner/common/util/
    settings.py — Settings``)."""

    num_proc: int
    hosts: list[HostInfo]
    command: list[str]
    cpu_mode: bool = False
    ssh_port: int | None = None
    # The network probe's wait for its task services, in seconds.
    start_timeout: float = 30.0
    verbose: bool = False
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    network_probe: bool = False
    # Elastic:
    elastic: bool = False
    min_np: int | None = None
    max_np: int | None = None
    discovery_script: str | None = None
    elastic_timeout: float = 600.0


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="hvdrun-torch",
        description="Launch a horovod_tpu_torch job: one process per GPU.",
        allow_abbrev=False,
    )
    p.add_argument("-v", "--version", action="store_true", help="print version")
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="number of worker processes (one per GPU; default: "
                        "every slot)")
    p.add_argument("-H", "--hosts", default=None,
                   help="comma separated host:slots (slots = GPUs per host)")
    p.add_argument("--hostfile", default=None,
                   help="hostfile path (host slots=N per line)")
    p.add_argument("--cpu-mode", action="store_true",
                   help="hide the GPUs from the workers (they run on the "
                        "CPU over gloo: init(device='cpu'))")
    p.add_argument("--ssh-port", type=int, default=None)
    p.add_argument("--network-probe", action="store_true",
                   help="pre-flight NIC probe: start a task service per "
                        "host, intersect interfaces, and advertise rank 0's "
                        "address on the common network (multi-NIC hosts)")
    p.add_argument("--start-timeout", type=float,
                   default=float(os.environ.get("HOROVOD_START_TIMEOUT", 30)),
                   help="seconds the network probe waits for its task "
                        "services")
    p.add_argument("--verbose", action="store_true",
                   help="print each rank's host and world facts")
    p.add_argument("--check-build", action="store_true",
                   help="print framework capabilities and exit")
    # The runtime knobs the port reads → env for children (the reference
    # CLI's names).
    p.add_argument("--fusion-threshold-mb", type=int, default=None)
    p.add_argument("--cycle-time-ms", type=float, default=None)
    p.add_argument("--cache-capacity", type=int, default=None)
    p.add_argument("--timeline-filename", default=None)
    p.add_argument("--timeline-mark-cycles", action="store_true")
    p.add_argument("--log-level", default=None,
                   choices=["trace", "debug", "info", "warning", "error", "fatal"])
    p.add_argument("--stall-check-time", type=float, default=None)
    p.add_argument("--stall-shutdown-time", type=float, default=None)
    p.add_argument("--autotune", action="store_true",
                   help="tune the fusion threshold (and the comms "
                        "planner's algorithm) in the first training steps")
    p.add_argument("--autotune-log-file", default=None,
                   help="rank 0 appends the autotune decision here as a "
                        "JSON line")
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--host-discovery-script", default=None,
                   help="script printing 'host:slots' per line; enables "
                        "elastic mode")
    p.add_argument("--elastic-timeout", type=float,
                   default=float(os.environ.get("HOROVOD_ELASTIC_TIMEOUT", 600)))
    p.add_argument("--config-file", default=None,
                   help="YAML of long-form flag defaults (CLI wins); "
                        "parity: horovodrun --config-file")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command (python train.py ...)")
    args = p.parse_args(argv)
    if args.config_file:
        _apply_config_file(p, args, argv)
    return args


def _apply_config_file(parser: argparse.ArgumentParser,
                       args: argparse.Namespace,
                       argv: list[str] | None) -> None:
    """YAML keys are long flag names (dashes or underscores); values fill
    any flag the command line did NOT set explicitly — the reference's
    config-file precedence (CLI > config file > defaults)."""
    import yaml

    with open(args.config_file) as f:
        config = yaml.safe_load(f) or {}
    if not isinstance(config, dict):
        raise SystemExit(f"--config-file {args.config_file}: expected a "
                         "mapping of flag: value")
    # Map EVERY option string (short and long) to its argparse dest so
    # explicit CLI flags always win, e.g. -H -> hosts, -np -> num_proc.
    opt_to_dest = {
        opt: a.dest
        for a in parser._actions
        for opt in a.option_strings
    }
    given = set()
    for tok in (argv if argv is not None else sys.argv[1:]):
        if tok.startswith("-") and not tok[1:2].isdigit():
            flag = tok.split("=", 1)[0]
            if flag in opt_to_dest:
                given.add(opt_to_dest[flag])
    valid = {a.dest for a in parser._actions}
    for key, value in config.items():
        dest = key.replace("-", "_")
        if dest not in valid:
            raise SystemExit(
                f"--config-file: unknown option {key!r}; valid: "
                + ", ".join(sorted(v for v in valid if v != "help"))
            )
        if dest in given:
            continue  # explicit CLI wins
        setattr(args, dest, value)


def args_to_env(args: argparse.Namespace) -> dict[str, str]:
    """CLI flags → HOROVOD_* env for children (the reference's contract)."""
    env: dict[str, str] = {}
    if args.fusion_threshold_mb is not None:
        env["HOROVOD_FUSION_THRESHOLD"] = str(args.fusion_threshold_mb * 1024 * 1024)
    if args.cycle_time_ms is not None:
        env["HOROVOD_CYCLE_TIME"] = str(args.cycle_time_ms)
    if args.cache_capacity is not None:
        env["HOROVOD_CACHE_CAPACITY"] = str(args.cache_capacity)
    if args.timeline_filename:
        env["HOROVOD_TIMELINE"] = args.timeline_filename
    if args.timeline_mark_cycles:
        env["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
    if args.autotune:
        env["HOROVOD_AUTOTUNE"] = "1"
    if args.autotune_log_file:
        env["HOROVOD_AUTOTUNE_LOG"] = args.autotune_log_file
    if args.log_level:
        env["HOROVOD_LOG_LEVEL"] = args.log_level
    if args.stall_check_time is not None:
        env["HOROVOD_STALL_CHECK_TIME"] = str(args.stall_check_time)
    if args.stall_shutdown_time is not None:
        env["HOROVOD_STALL_SHUTDOWN_TIME"] = str(args.stall_shutdown_time)
    return env


def settings_from_args(args: argparse.Namespace) -> Settings:
    if args.hosts and args.hostfile:
        raise SystemExit("specify either -H/--hosts or --hostfile, not both")
    command = python_command([c for c in args.command if c != "--"])
    if not command:
        raise SystemExit("no training command given")
    elastic = args.host_discovery_script is not None
    common = dict(
        command=command,
        cpu_mode=args.cpu_mode,
        ssh_port=args.ssh_port,
        start_timeout=args.start_timeout,
        verbose=args.verbose,
        env=args_to_env(args),
        network_probe=args.network_probe,
    )
    if elastic:
        # Reference semantics: -np is the starting/target world size;
        # min/max default to it when not given explicitly. Hosts are
        # discovered at runtime.
        np = args.num_proc or (args.min_np or 1)
        if args.min_np is None:
            args.min_np = np
        if args.max_np is None and args.num_proc is not None:
            args.max_np = args.num_proc
        return Settings(
            num_proc=np, hosts=[], elastic=True, min_np=args.min_np,
            max_np=args.max_np, discovery_script=args.host_discovery_script,
            elastic_timeout=args.elastic_timeout, **common)
    if args.hosts:
        hosts = parse_hosts(args.hosts)
    elif args.hostfile:
        hosts = parse_hostfile(args.hostfile)
    elif (
        not args.cpu_mode
        and (scheduler_hosts := detect_scheduler_hosts()) is not None
    ):
        # Inside an LSF/Slurm allocation with no -H/--hostfile: use the
        # allocation's hosts (parity: horovod/runner/util/lsf.py
        # auto-detection). Explicit flags win even over a malformed
        # allocation env, and --cpu-mode keeps its local fan-out.
        hosts = scheduler_hosts
    else:
        hosts = [HostInfo("localhost", args.num_proc or 1)]
    slots = sum(h.slots for h in hosts)
    np = args.num_proc or slots
    if np > slots:
        raise SystemExit(
            f"-np {np} exceeds the {slots} slot(s) of the hosts; one "
            "process per slot (GPU)")
    return Settings(num_proc=np, hosts=hosts, **common)


def _network_probe(hosts, ssh_port, timeout, sink) -> dict[str, str] | None:
    """Pre-flight NIC probe (parity: driver_service._driver_fn): start a
    task service per host, read its port from the muxed output, intersect
    interfaces. Returns {hostname: address-on-common-network} or None.
    """
    import re
    import time

    from .driver_service import probe_cluster

    ports: dict[str, int] = {}
    lines: list[str] = []

    def capture(line: str) -> None:
        lines.append(line)
        if sink:
            sink(line)

    unique = [HostInfo(h.hostname, 1) for h in hosts]
    assignments = get_host_assignments(unique)
    workers = [
        launch_worker(
            a, [sys.executable, "-m", "horovod_tpu_torch.runner.task_fn"],
            dict(os.environ), ssh_port=ssh_port, sink=capture,
        )
        for a in assignments
    ]
    try:
        deadline = time.time() + timeout
        while len(ports) < len(assignments) and time.time() < deadline:
            for line in list(lines):
                m = re.search(r"\[(\d+)\] HVD_TASK_SERVICE_PORT=(\d+)", line)
                if m:
                    rank = int(m.group(1))
                    ports[assignments[rank].hostname] = int(m.group(2))
            time.sleep(0.05)
        if len(ports) < len(assignments):
            return None  # probe inconclusive: fall back to defaults
        _, addrs = probe_cluster({
            h: (h if h != "localhost" else "127.0.0.1", p)
            for h, p in ports.items()
        })
        return addrs
    except Exception:
        return None
    finally:
        terminate_workers(workers)


def run_static(settings: Settings, sink=None) -> int:
    """The static launch path.

    Parity: upstream's ``gloo_run``: assign ranks, exec the workers,
    multiplex their output, return the first failing rank's exit code and
    terminate the others.
    """
    assignments = get_host_assignments(settings.hosts, settings.num_proc)
    # The per-job HMAC secret first: the probe's task services read it when
    # they start, and the workers inherit it through the env block.
    os.environ.setdefault(_secret.ENV_KEY, _secret.make_secret_key())
    hostnames = [h.hostname for h in settings.hosts]
    coord_addr = network.coordinator_addr(hostnames)
    if settings.network_probe:
        probed = _network_probe(settings.hosts, settings.ssh_port,
                                settings.start_timeout, sink)
        if probed and hostnames[0] in probed:
            # Rank 0's address on the network every host shares: its
            # hostname may resolve to an unreachable management NIC.
            coord_addr = probed[hostnames[0]]
    coord_port = network.free_port()
    native_port = network.free_port()
    workers = []
    try:
        for a in assignments:
            if settings.verbose:
                print(f"hvdrun-torch: rank {a.rank} on {a.hostname}: {a}",
                      file=sys.stderr, flush=True)
            env = build_worker_env(
                a,
                base_env=dict(os.environ),
                coordinator_addr=coord_addr,
                coordinator_port=coord_port,
                cpu_mode=settings.cpu_mode,
                extra_env=settings.env,
                native_port=native_port,
            )
            workers.append(launch_worker(
                a, settings.command, env, ssh_port=settings.ssh_port,
                sink=sink))
        return wait_for_workers(workers)
    finally:
        # Nothing is left running, whatever ended the wait.
        terminate_workers(workers)


def check_build() -> str:
    import torch
    import torch.distributed as dist

    def mark(flag: bool) -> str:
        return "X" if flag else " "

    lines = [
        f"horovod_tpu_torch (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})",
        "",
        "Available frameworks:",
        "    [X] PyTorch",
        "",
        "Available controllers:",
        "    [X] torch.distributed TCP store",
        "    [X] negotiated runtime (rank-0 controller, response cache)",
        "",
        "Available collective backends:",
        f"    [{mark(dist.is_nccl_available())}] NCCL",
        f"    [{mark(dist.is_gloo_available())}] Gloo",
        "",
        "Available features:",
        "    [X] elastic",
        "    [X] process sets",
        "    [X] grouped allreduce / tensor fusion",
        "    [X] adasum",
        "    [X] sync batch norm",
        "    [X] sharded / fsdp sync modes",
    ]
    return "\n".join(lines)


def run_commandline(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    if args.version:
        print(check_build().splitlines()[0])
        return 0
    if args.check_build:
        print(check_build())
        return 0
    settings = settings_from_args(args)
    if settings.elastic:
        from .elastic.driver import run_elastic

        return run_elastic(settings)
    return run_static(settings)


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
