"""Lifecycle and world facts: ``init()``, ``rank()``, ``size()``, ...

Port of ``horovod_tpu/basics.py`` (``init`` :175, ``shutdown`` :218, the
world facts and build flags :330-421) to ``torch.distributed``. One
process drives one device, as in the reference Horovod: the world facts
come from the launcher's env contract (``HOROVOD_NUM_PROCESSES``,
``HOROVOD_PROCESS_ID``, ``HOROVOD_LOCAL_RANK``, ``HOROVOD_LOCAL_SIZE``,
``HOROVOD_CROSS_RANK``, ``HOROVOD_CROSS_SIZE``;
``horovod_tpu/process_world.py``), and the collectives run over NCCL on
the card, or over gloo when the caller asks for the CPU. ``init()`` also
gathers every rank's host, through the store the group was formed on,
into the world's ``topology.Topology`` (``_state.topology``, the link
classes of the comms model), as the reference builds its own at init.

Elastic worlds (``HOROVOD_ELASTIC=1``, workers of ``hvdrun-torch
--host-discovery-script``; ``horovod_tpu/basics.py:66-172``): ``init()``
first fetches this worker's assignment for the newest world from the
driver's rendezvous KV and applies it to the env, starts the worker's
poll loop, heartbeat and abort monitor, and has rank 0 pick its TCP
store's port on its own host and publish it under ``coord/<version>``.
The group gets an explicit collective timeout
(``ELASTIC_COLLECTIVE_TIMEOUT_S``). Each
re-formation is a new group: ``shutdown()`` aborts the old one's
communicators and destroys it, even when it is broken, and the objects
that captured it drop it (``on_shutdown`` hooks).
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Callable

import torch
import torch.distributed as dist

from . import abort, process_sets
from .exceptions import NotInitializedError
from .topology import Topology
from .utils import env
from .utils.logging import get_logger

_lock = threading.Lock()

# Objects that captured this world's group register a call here to drop it
# at shutdown (the optimizer's in-flight work, ...).
_shutdown_hooks: list[Callable[[], None]] = []
# Objects that read facts of the world (the optimizer: is its set one
# member?) register a call here to read them again when a world forms.
_init_hooks: list[Callable[[], None]] = []

# What a torch NCCL group does when its watchdog sees a failed or timed-out
# collective, in an elastic world (unless the env sets it): 2 = abort the
# communicators and keep the process alive. torch's default kills the
# process, which is the survivor elastic recovery exists to keep.
ELASTIC_NCCL_ERROR_HANDLING = "2"

# An elastic group's collective timeout: a collective still waiting after it
# fails (torch's default is 10 minutes). The coordinated abort ends a wait
# on a dead peer well before; this bounds one the abort never reaches.
ELASTIC_COLLECTIVE_TIMEOUT_S = 300.0


class _State:
    def __init__(self) -> None:
        self.initialized = False
        self.owns_group = False  # init() formed the process group
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.cross_rank = 0
        self.cross_size = 1
        self.device: torch.device | None = None
        # The world's link structure (topology.Topology): each rank's host.
        self.topology = None
        # (world version, TCP store address) of the last group this
        # process formed in an elastic world.
        self.last_coordinator: tuple[str, str] | None = None
        # The device the last init() of an elastic world asked for: the
        # elastic loop's re-init, which passes none, keeps it.
        self.elastic_device = None
        # The negotiated runtime's world (runtime.NativeWorld) of a
        # multi-rank world: the eager collectives' plane.
        self.negotiated = None

    def require_init(self) -> "_State":
        if not self.initialized:
            raise NotInitializedError()
        return self


_state = _State()


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch.init(): no CUDA device is available; pass "
                "device='cpu' to run the world on the CPU over gloo")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"init(device=...) takes 'cuda' or 'cpu'; got {device.type!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init(device='cuda'): no CUDA device is available")
    return device


def on_shutdown(hook: Callable[[], None]) -> None:
    """Run ``hook()`` at every :func:`shutdown` (errors are logged)."""
    _shutdown_hooks.append(hook)


def on_init(hook: Callable[[], None]) -> None:
    """Run ``hook()`` at the end of every :func:`init` that forms a world."""
    _init_hooks.append(hook)


def elastic() -> bool:
    return env.get_str("HOROVOD_ELASTIC") == "1"


def _join_elastic_world() -> None:
    """Fetch this worker's assignment for the newest world, apply it to
    the env, and start the poll loop, heartbeat and abort monitor."""
    from .runner.elastic import worker as elastic_worker

    ctx = elastic_worker.get_worker_context()
    ctx.apply_to_env(ctx.fetch_assignment())
    ctx.start_polling()
    ctx.start_heartbeat()


def _exchange_coordinator_port(coord: str, rank: int) -> str:
    """Rank 0 picks the TCP store's port ON ITS OWN HOST and publishes it
    under ``coord/<version>`` in the rendezvous KV; the others poll for
    it (the launcher cannot probe a free port on a remote host). A rank
    that formed a group of this version before waits for a new address:
    a recovery that rejoins the same generation re-forms the group too."""
    from .runner.http.kv_server import KVClient, env_generation
    from .runner.network import free_port

    addr = env.get_str("HOROVOD_RENDEZVOUS_ADDR")
    port = env.get_int("HOROVOD_RENDEZVOUS_PORT", -1)
    if not addr or port < 0:
        return coord  # manual launch: trust the env as given
    version = env.get_str("HOROVOD_WORLD_VERSION", "static")
    scope = f"coord/{version}"
    # Generation-fenced: a zombie rank 0 resumed from a pre-abort world
    # must not republish a stale endpoint.
    kv = KVClient(addr, port, generation_fn=env_generation)
    stale = (_state.last_coordinator[1]
             if _state.last_coordinator
             and _state.last_coordinator[0] == version else None)
    if rank == 0:
        chosen = stale
        while chosen == stale:
            chosen = f"{coord.rsplit(':', 1)[0]}:{free_port()}"
        kv.put(scope, "addr", chosen.encode())
        _state.last_coordinator = (version, chosen)
        return chosen
    deadline = time.time() + 60.0
    while time.time() < deadline:
        val = kv.get(scope, "addr")
        if val is not None and val.decode() != stale:
            _state.last_coordinator = (version, val.decode())
            return val.decode()
        time.sleep(0.05)
    raise TimeoutError(
        f"coordinator address not published to rendezvous KV scope {scope!r}")


def _abort_groups(reason: str = "", generation: int = -1) -> None:
    """Abort the communicators of every group of this world (the abort
    hook): a collective already waiting on a dead peer then ends with an
    error instead of hanging. Runs on the abort monitor's thread; a group
    the main thread tears down meanwhile is skipped."""
    del reason, generation
    if not _state.owns_group or not dist.is_initialized():
        return
    from torch.distributed import distributed_c10d as c10d

    try:
        pgs = sorted(c10d._world.pg_names, key=c10d._world.pg_names.get,
                     reverse=True)
        for pg in pgs:
            pg.abort()
    except Exception as e:  # noqa: BLE001 — the flag still raises
        get_logger().warning("aborting the process group failed: %s", e)


abort.on_abort(_abort_groups)


def _gather_hosts(cross_rank: int, rank: int, size: int) -> list[int]:
    """Every rank's host index (its ``cross_rank``), in rank order,
    through the store the group was formed on: a key per rank, no
    collective on the card (none at all on one rank)."""
    if size == 1:
        return [cross_rank]
    from torch.distributed import distributed_c10d as c10d

    store = c10d._get_default_store()
    prefix = f"hvd_hosts/{env.get_str('HOROVOD_WORLD_VERSION', 'static')}"
    store.set(f"{prefix}/{rank}", str(cross_rank))
    return [int(store.get(f"{prefix}/{r}")) for r in range(size)]


def init(device=None, init_method: str | None = None) -> None:
    """Form the world. Idempotent.

    ``device``: ``None`` or ``"cuda"`` runs on the card (NCCL group, and
    ``torch.cuda.set_device(local_rank)``); ``"cpu"`` runs on the CPU over
    gloo. With no card and no explicit ``"cpu"`` this raises. In an
    elastic world, ``None`` after an earlier ``init(device=...)`` keeps
    that device, so the elastic loop's re-init forms the next world where
    the first one was.

    ``init_method``: where the ranks meet (``tcp://host:port`` or
    ``file:///path``). Defaults to ``tcp://$HOROVOD_COORDINATOR_ADDR`` for a
    multi-process world; a one-process world needs none. A process group
    the caller already formed is adopted as it is.
    """
    with _lock:
        if _state.initialized:
            return
        elastic_world = elastic()
        if elastic_world:
            if device is None:
                device = _state.elastic_device
            _state.elastic_device = device
        device = _resolve_device(device)
        if elastic_world:
            _join_elastic_world()
        size = env.get_int(env.NUM_PROCESSES, 1)
        rank = env.get_int(env.PROCESS_ID, 0)
        local_rank = env.get_int(env.LOCAL_RANK, 0)
        local_size = env.get_int(env.LOCAL_SIZE, 1)
        if device.type == "cuda":
            device = torch.device("cuda", local_rank)
            torch.cuda.set_device(device)
        if dist.is_initialized():
            rank, size = dist.get_rank(), dist.get_world_size()
        else:
            backend = "nccl" if device.type == "cuda" else "gloo"
            if init_method is None and size > 1:
                addr = env.get_str(env.COORDINATOR_ADDR)
                if not addr:
                    raise RuntimeError(
                        f"a {size}-process world needs a rendezvous: pass "
                        f"init_method= or set {env.COORDINATOR_ADDR}=host:port")
                if elastic_world:
                    addr = _exchange_coordinator_port(addr, rank)
                init_method = f"tcp://{addr}"
            kwargs = {}
            if elastic_world:
                os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING",
                                      ELASTIC_NCCL_ERROR_HANDLING)
                kwargs["timeout"] = datetime.timedelta(
                    seconds=ELASTIC_COLLECTIVE_TIMEOUT_S)
            if init_method is None:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1, **kwargs)
            else:
                dist.init_process_group(backend, init_method=init_method,
                                        rank=rank, world_size=size, **kwargs)
            # Set at once: shutdown() tears the group down even if init()
            # fails after this point.
            _state.owns_group = True
        _state.rank, _state.size = rank, size
        _state.local_rank, _state.local_size = local_rank, local_size
        # Hosts: the launcher's numbers, else hosts of local_size ranks each
        # in rank order.
        _state.cross_rank = env.get_int(env.CROSS_RANK,
                                        rank // max(local_size, 1))
        _state.cross_size = env.get_int(env.CROSS_SIZE,
                                        -(-size // max(local_size, 1)))
        _state.device = device
        _state.topology = Topology(
            _gather_hosts(_state.cross_rank, rank, size), rank)
        _state.initialized = True
        process_sets._reset(size)
        try:
            _form_negotiated_world(init_method)
        except BaseException:
            _state.initialized = False
            raise
        for hook in list(_init_hooks):
            hook()
        # HOROVOD_PROFILER_LOGDIR: a torch.profiler capture from init on
        # (the reference's NVTX-activation-by-env contract).
        from . import profiler

        profiler.maybe_start_from_env()


def shutdown() -> None:
    """Tear down the world (and the process group, if ``init`` formed it).

    In an elastic world the group's communicators are aborted before it
    is destroyed, so a group broken by a dead peer tears down without
    waiting on it; the group goes even if ``init()`` failed after forming
    it, so that the next ``init()`` can form a new one."""
    with _lock:
        world, _state.negotiated = _state.negotiated, None
        if world is not None:
            try:
                world.shutdown(wait_s=0.0 if abort.is_aborted() else None)
            except Exception as e:  # noqa: BLE001 — the world still goes
                get_logger().warning("negotiated world shutdown: %s", e)
        if _state.owns_group and dist.is_initialized():
            if elastic():
                from torch.distributed import distributed_c10d as c10d

                c10d._abort_process_group()
            else:
                dist.destroy_process_group()
        _state.owns_group = False
        if not _state.initialized:
            return
        process_sets._clear()
        for hook in list(_shutdown_hooks):
            try:
                hook()
            except Exception as e:  # noqa: BLE001 — the world still goes
                get_logger().warning("shutdown hook failed: %s", e)
        _state.initialized = False
        _state.device = None
        _state.topology = None


def _form_negotiated_world(init_method: str | None) -> None:
    """In a world of two or more ranks, form the negotiated runtime's
    world (``runtime.NativeWorld``) over it: the star to rank 0 and a
    process group of its own over the same ranks. Rank 0 listens on
    ``HOROVOD_NATIVE_PORT`` (the launcher's) or a free port on its host,
    and sends the address to the others over the default group."""
    if _state.size < 2:
        return
    from .runner.network import free_port
    from .runtime import NativeWorld

    box = [None]
    if _state.rank == 0:
        host = "127.0.0.1"
        if init_method and init_method.startswith("tcp://"):
            host = init_method[len("tcp://"):].rsplit(":", 1)[0]
        elif env.get_str(env.COORDINATOR_ADDR):
            host = env.get_str(env.COORDINATOR_ADDR).rsplit(":", 1)[0]
        port = env.get_int("HOROVOD_NATIVE_PORT", 0) or free_port()
        box = [f"{host}:{port}"]
    dist.broadcast_object_list(box, src=0)
    host, port = box[0].rsplit(":", 1)
    _state.negotiated = NativeWorld(
        _state.rank, _state.size, host, int(port),
        timeout_s=env.get_float("HOROVOD_NATIVE_INIT_TIMEOUT", 30.0),
        device=_state.device)


def negotiated_world():
    """The negotiated runtime's world of this multi-rank world
    (``runtime.NativeWorld``), or None on one rank."""
    return _state.require_init().negotiated


def sync_stream(device=None) -> None:
    """Wait on the host for the work queued so far on the current CUDA
    stream of ``device`` (default: the world's device), and for nothing
    else: not a device-wide synchronize, so a collective still running on
    its own stream is not waited for unless that stream was made to wait
    for it. A no-op on the CPU, where the work is done when its call
    returns."""
    device = _state.device if device is None else torch.device(device)
    if device is None or device.type != "cuda":
        return
    torch.cuda.current_stream(device).synchronize()


def is_initialized() -> bool:
    return _state.initialized


def rank() -> int:
    """This process's global rank."""
    return _state.require_init().rank


def size() -> int:
    """Number of ranks (one device each) in the world."""
    return _state.require_init().size


def local_rank() -> int:
    return _state.require_init().local_rank


def local_size() -> int:
    return _state.require_init().local_size


def device() -> torch.device:
    """The device this rank's collectives and tensors run on."""
    return _state.require_init().device


def cross_rank() -> int:
    """This rank's host index."""
    return _state.require_init().cross_rank


def cross_size() -> int:
    """Number of hosts."""
    return _state.require_init().cross_size


def process_rank() -> int:
    """This process's index (one process per device: the rank)."""
    return _state.require_init().rank


def process_count() -> int:
    """Number of processes (one per device: the world size)."""
    return _state.require_init().size


def is_homogeneous() -> bool:
    """True if every host has the same number of local ranks."""
    st = _state.require_init()
    return st.size == st.local_size * st.cross_size


# -- Build and capability flags (parity: HorovodBasics' *_built / *_enabled),
# answered for this build: torch.distributed's NCCL and gloo backends, no MPI.


def mpi_enabled() -> bool:
    return False


def mpi_built() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False


def gloo_enabled() -> bool:
    return dist.is_gloo_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def nccl_built() -> bool:
    return dist.is_nccl_available()


def cuda_built() -> bool:
    return torch.version.cuda is not None


def rocm_built() -> bool:
    return torch.version.hip is not None


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False
