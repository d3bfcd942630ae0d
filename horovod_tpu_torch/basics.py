"""Lifecycle and world facts: ``init()``, ``rank()``, ``size()``, ...

Port of ``horovod_tpu/basics.py`` (``init`` :175, ``shutdown`` :218, the
world facts and build flags :330-421) to ``torch.distributed``. One
process drives one device, as in the reference Horovod: the world facts
come from the launcher's env contract (``HOROVOD_NUM_PROCESSES``,
``HOROVOD_PROCESS_ID``, ``HOROVOD_LOCAL_RANK``, ``HOROVOD_LOCAL_SIZE``,
``HOROVOD_CROSS_RANK``, ``HOROVOD_CROSS_SIZE``;
``horovod_tpu/process_world.py``), and the collectives run over NCCL on
the card, or over gloo when the caller asks for the CPU.
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist

from . import process_sets
from .exceptions import NotInitializedError
from .utils import env

_lock = threading.Lock()


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


def init(device=None, init_method: str | None = None) -> None:
    """Form the world. Idempotent.

    ``device``: ``None`` or ``"cuda"`` runs on the card (NCCL group, and
    ``torch.cuda.set_device(local_rank)``); ``"cpu"`` runs on the CPU over
    gloo. With no card and no explicit ``"cpu"`` this raises.

    ``init_method``: where the ranks meet (``tcp://host:port`` or
    ``file:///path``). Defaults to ``tcp://$HOROVOD_COORDINATOR_ADDR`` for a
    multi-process world; a one-process world needs none. A process group
    the caller already formed is adopted as it is.
    """
    with _lock:
        if _state.initialized:
            return
        device = _resolve_device(device)
        size = env.get_int(env.NUM_PROCESSES, 1)
        rank = env.get_int(env.PROCESS_ID, 0)
        local_rank = env.get_int(env.LOCAL_RANK, 0)
        local_size = env.get_int(env.LOCAL_SIZE, 1)
        if device.type == "cuda":
            device = torch.device("cuda", local_rank)
            torch.cuda.set_device(device)
        owns = False
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
                init_method = f"tcp://{addr}"
            if init_method is None:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
            else:
                dist.init_process_group(backend, init_method=init_method,
                                        rank=rank, world_size=size)
            owns = True
        _state.rank, _state.size = rank, size
        _state.local_rank, _state.local_size = local_rank, local_size
        # Hosts: the launcher's numbers, else hosts of local_size ranks each
        # in rank order.
        _state.cross_rank = env.get_int(env.CROSS_RANK,
                                        rank // max(local_size, 1))
        _state.cross_size = env.get_int(env.CROSS_SIZE,
                                        -(-size // max(local_size, 1)))
        _state.device = device
        _state.owns_group = owns
        _state.initialized = True
        process_sets._reset(size)


def shutdown() -> None:
    """Tear down the world (and the process group, if ``init`` formed it)."""
    with _lock:
        if not _state.initialized:
            return
        if _state.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        process_sets._clear()
        _state.initialized = False
        _state.owns_group = False
        _state.device = None


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
