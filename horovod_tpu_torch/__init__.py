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
(``init(device="cpu")``, which forms a gloo world).
"""

from .basics import (ccl_built, cross_rank, cross_size, cuda_built,
                     ddl_built, device, gloo_built, gloo_enabled, init,
                     is_homogeneous, is_initialized, local_rank, local_size,
                     mpi_built, mpi_enabled, mpi_threads_supported,
                     nccl_built, process_count, process_rank, rank,
                     rocm_built, shutdown, size)
from . import checkpoint
from .checkpoint import (load_and_broadcast, load_state_and_broadcast,
                         save_on_rank_0, save_state_on_rank_0)
from .compression import Compression
from .exceptions import (CheckpointCorruptError, HorovodInternalError,
                         HorovodTpuError, NotInitializedError,
                         SyncModeIneligibleError)
from .functions import (allgather_object, broadcast_object,
                        broadcast_optimizer_state, broadcast_parameters,
                        masked_average)
from .ops.collective_ops import (
    Average, Max, Min, Product, Sum, allgather, allgather_async, allreduce,
    allreduce_async, allreduce_async_, alltoall, alltoall_async, barrier,
    broadcast, broadcast_async, broadcast_async_, grouped_allgather,
    grouped_allgather_async, grouped_allreduce, grouped_allreduce_async,
    grouped_reducescatter, grouped_reducescatter_async, poll, reducescatter,
    reducescatter_async, synchronize)
from .optimizer import (DistributedOptimizer, gather_sharded_state,
                        init_sharded_state, load_sharded_state,
                        reshard_opt_state,
                        resolve_sync_mode, unshard_opt_state)
from .parallel.data_parallel import make_train_step
from .parallel.param_sharding import (ShardedParams, reshard_params,
                                      resident_param_bytes, shard_params,
                                      unshard_params)
from .process_sets import (ProcessSet, add_process_set, get_process_set_ids,
                           global_process_set, remove_process_set)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "process_rank",
    "process_count", "is_homogeneous", "device", "mpi_enabled", "mpi_built",
    "mpi_threads_supported", "gloo_enabled", "gloo_built", "nccl_built",
    "cuda_built", "rocm_built", "ddl_built", "ccl_built", "Compression",
    "HorovodTpuError", "HorovodInternalError", "NotInitializedError",
    "allgather_object", "broadcast_object", "broadcast_optimizer_state",
    "broadcast_parameters", "masked_average", "Average", "Sum", "Min", "Max",
    "Product", "allreduce", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_async", "allgather",
    "allgather_async", "grouped_allgather", "grouped_allgather_async",
    "broadcast", "broadcast_async", "broadcast_async_", "alltoall",
    "alltoall_async", "reducescatter", "reducescatter_async",
    "grouped_reducescatter", "grouped_reducescatter_async", "synchronize",
    "poll", "barrier", "DistributedOptimizer", "resolve_sync_mode",
    "init_sharded_state", "gather_sharded_state", "unshard_opt_state",
    "reshard_opt_state",
    "load_sharded_state", "make_train_step", "ShardedParams",
    "shard_params", "unshard_params", "reshard_params",
    "resident_param_bytes", "ProcessSet", "global_process_set",
    "add_process_set", "remove_process_set", "get_process_set_ids",
    "SyncModeIneligibleError", "CheckpointCorruptError", "checkpoint",
    "save_on_rank_0", "load_and_broadcast", "save_state_on_rank_0",
    "load_state_and_broadcast",
]
