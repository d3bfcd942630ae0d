"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

Synchronous data-parallel training on NVIDIA GPUs, with the JAX package's
semantics: ``init()``, eager collectives (sync and async, on the world or
on process sets), a ``DistributedOptimizer`` that averages gradients with
a bucketed allreduce during backward (or an int8 exchange), or shards the
optimizer state (``sync_mode="sharded"``) or the parameters too
(``"fsdp"``), ``broadcast_parameters``, and rank-0 checkpoints that resume
across modes and world sizes (``checkpoint``). The
flash-attention kernels that the JAX package wrote in Pallas for the TPU
are hand-written CUDA kernels for Hopper here (``ops/csrc``). Imports
torch, never jax or ``horovod_tpu``.

Entry points run on the card unless the caller asks for the CPU
(``init(device="cpu")``, which forms a gloo world). ``op=Adasum`` and
``SyncBatchNorm`` complete the data-parallel surface; ``hvdrun-torch``
(``runner/``) launches one process per card, statically or elastically
(``hvd.elastic``: a world that loses a worker or gains a host and keeps
training). The observability plane (``metrics``, ``tracing``,
``timeline``, ``stall``, ``profiler``, ``attribution``) counts and times
what the job does, on each rank and, through the elastic driver's
rendezvous server, across the cluster; the comms and memory observatories
(``comms_model``, with the link classes of ``topology``, and ``memory``)
fit an alpha-beta price to the collectives and account the card's bytes
(``run_comms_microprobe`` seeds the first). In a world of more than one
rank the eager collectives are named requests to the negotiated runtime
(``runtime``): a rank-0 controller puts them in one order for every rank,
caches and fuses them, names a rank that holds the others back, and lets a
rank that ran out of data ``join``.
"""

from __future__ import annotations

import importlib

# Each public name and the module it comes from. The package imports a
# module at the first use of one of its names, so that importing the
# package (the launcher, ``python -m horovod_tpu_torch.runner.launch``,
# does) does not import torch: a job's workers start without waiting for
# it.
_EXPORTS = {
    "attribution": ("set_model_flops_per_step",),
    "basics": (
        "ccl_built", "cross_rank", "cross_size", "cuda_built", "ddl_built",
        "device", "gloo_built", "gloo_enabled", "init", "is_homogeneous",
        "is_initialized", "local_rank", "local_size", "mpi_built",
        "mpi_enabled", "mpi_threads_supported", "nccl_built",
        "process_count", "process_rank", "rank", "rocm_built", "shutdown",
        "size"),
    "checkpoint": ("Checkpointer", "load_and_broadcast",
                   "load_state_and_broadcast", "save_on_rank_0",
                   "save_state_on_rank_0"),
    "compression": ("Compression",),
    "exceptions": ("CheckpointCorruptError", "HorovodInternalError",
                   "HorovodTpuError", "HostsUpdatedInterrupt",
                   "NotInitializedError", "RecoveryExhaustedError",
                   "RemovedFromWorldError", "SyncModeIneligibleError"),
    "functions": ("allgather_object", "broadcast_object",
                  "broadcast_optimizer_state", "broadcast_parameters", "join",
                  "masked_average"),
    "ops.collective_ops": (
        "Adasum", "Average", "Max", "Min", "Product", "Sum", "allgather",
        "allgather_async", "allreduce", "allreduce_", "allreduce_async",
        "allreduce_async_", "alltoall", "alltoall_async", "barrier",
        "broadcast", "broadcast_async", "broadcast_async_",
        "grouped_allgather", "grouped_allgather_async", "grouped_allreduce",
        "grouped_allreduce_async", "grouped_reducescatter",
        "grouped_reducescatter_async", "cache_stats", "poll",
        "reducescatter", "reducescatter_async", "run_comms_microprobe",
        "synchronize"),
    "optimizer": ("DistributedOptimizer", "gather_sharded_state",
                  "init_sharded_state", "load_sharded_state",
                  "reshard_opt_state", "resolve_sync_mode",
                  "unshard_opt_state"),
    "parallel.data_parallel": ("make_elastic_train_step", "make_train_step"),
    "parallel.param_sharding": ("ShardedParams", "reshard_params",
                                "resident_param_bytes", "shard_params",
                                "unshard_params"),
    "process_sets": ("ProcessSet", "add_process_set", "get_process_set_ids",
                     "global_process_set", "remove_process_set"),
    "stall": ("fetch",),
    "sync_batch_norm": ("SyncBatchNorm",),
    "timeline": ("start_timeline", "stop_timeline"),
}
_SOURCE = {name: module for module, names in _EXPORTS.items()
           for name in names}


def __getattr__(name):
    if name in _SOURCE:
        value = getattr(importlib.import_module(f".{_SOURCE[name]}",
                                                __name__), name)
    else:
        # A submodule (``hvd.checkpoint``, ``hvd.models``, ...).
        try:
            value = importlib.import_module(f".{name}", __name__)
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))


# The public names, and the submodules that are public by name
# (``hvd.elastic``: ``run``, ``TorchState``, ``ElasticSampler``, ...).
_SUBMODULES = ("attribution", "autotune", "checkpoint", "comms_model",
               "elastic", "memory", "metrics", "profiler", "runtime",
               "topology", "tracing")
__all__ = sorted(_SOURCE) + list(_SUBMODULES)
