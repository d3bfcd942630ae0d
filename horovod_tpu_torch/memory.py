"""Device-memory observatory: the analytic footprint model, live resident
accounting, per-phase watermarks, and out-of-memory forensics.

Port of ``horovod_tpu/memory.py``. The card's memory bounds a training
configuration's batch and model long before its FLOPs do; the comms
observatory (``comms_model.py``) prices time, this module bytes:

- **Model**: :func:`predict_footprint` prices a configuration's per-rank
  bytes from leaf descriptors, bit for bit as the reference does:
  resident parameters and optimizer state under each sync mode's layout
  (the per-leaf ``ceil(size/n)`` ownership of ``ops.fusion.shard_ownership``
  makes it exact), plus the transient peaks. :func:`footprint_of` prices
  what the port's ``DistributedOptimizer`` holds (its docstring lists where
  that differs from the JAX layout).
- **Measure**: the call sites that materialize resident state note its
  bytes (``parallel/param_sharding.shard_params``, the sharded and fsdp
  optimizers, the allreduce optimizer after its first update,
  ``elastic.TorchState``); the peer replica pool is polled as a supplier;
  the card's allocator is read (:func:`device_memory_stats`). Every span
  close of the tracing plane folds the bytes in use into its phase's
  watermark (:meth:`MemoryObservatory.note_phase`).
- **Expose**: the gauges ``hvd_hbm_bytes{kind}``,
  ``hvd_hbm_watermark_bytes{phase}``, ``hvd_hbm_headroom_ratio`` and
  ``hvd_hbm_model_residual_bytes`` (the family names of the reference),
  ``GET /memory`` on the rendezvous server (each rank's :meth:`payload`
  rides its heartbeat, :func:`merge_payloads` merges them) and
  ``profiler.summary()["memory"]``.
- **Consume**: the training step's boundary catches an out-of-memory
  error (``torch.cuda.OutOfMemoryError``), dumps a flight record naming the
  largest resident leaves (:func:`dump_oom_record`) and re-raises it; an
  autotune memory guard (:func:`check_candidate`,
  :func:`filter_candidates`) and a scheduler's advisory admission check
  (:func:`admission_check`) price candidates against the capacity.

The reference's executable-cache supplier has no counterpart: the port
compiles no executable per collective and has no executable cache
(``ops.collective_ops.cache_stats``).

Stdlib-only at import: the rendezvous server imports
:func:`merge_payloads` on the driver, where torch is never imported.
torch is imported inside the device helpers only.
"""

from __future__ import annotations

import math
import os
import socket
import sys
import threading
import time
from typing import Any, Callable, Mapping, Sequence

from .comms_model import bucket_byte_sizes, segment_byte_runs
from .utils.env import get_int

#: Resident-state kinds (`kind` label values of ``hvd_hbm_bytes``).
#: ``params``/``opt_state`` are the model kinds the footprint model prices;
#: the rest are measured live only.
KINDS = ("params", "opt_state", "grads", "peer_pool", "executables",
         "serving", "other")

#: The model kinds: what :func:`predict_footprint` prices and the residual
#: (predicted minus measured) gauge compares.
MODEL_KINDS = ("params", "opt_state")

#: Watermark phases (`phase` label values of ``hvd_hbm_watermark_bytes``):
#: the attribution plane's phase spans, the whole step and a catch-all.
PHASES = ("step", "forward_backward", "collective", "optimizer_update",
          "other")

#: Transient-peak kinds in a footprint's ``transient`` section.
TRANSIENT_KINDS = ("grad_buckets", "fsdp_gather", "model_axis_gather",
                   "moe_alltoall", "serve_staging")


def _rank() -> str:
    return os.environ.get("HOROVOD_RANK", "0") or "0"


def _host() -> str:
    return os.environ.get("HOROVOD_HOSTNAME", "") or socket.gethostname()


def top_n() -> int:
    """How many resident leaves a forensics record names."""
    return max(1, get_int("HOROVOD_HBM_TOP_LEAVES", 8))


def ceil_shard(size: int, world_size: int) -> int:
    """Per-rank shard ELEMENTS of a leaf under the ownership map
    (``ops.fusion.shard_ownership`` for one leaf):
    ``max(1, ceil(size / world_size))``."""
    n = max(1, int(world_size))
    return max(1, -(-int(size) // n))


def capacity_bytes() -> int | None:
    """The card's memory capacity, when a source knows it:
    ``HOROVOD_HBM_BYTES_PER_DEVICE`` (the operator's declared budget, the
    only source in a CPU world), else the card's total memory
    (``torch.cuda.mem_get_info``). None when neither exists: headroom then
    reads 0 (unknown), never a guess."""
    env = get_int("HOROVOD_HBM_BYTES_PER_DEVICE", 0)
    if env > 0:
        return env
    stats = device_memory_stats()
    if stats:
        limit = stats.get("bytes_limit")
        if isinstance(limit, (int, float)) and limit > 0:
            return int(limit)
    return None


# Set when a read of the card's allocator failed: later calls answer None
# at once, so the per-span watermark hook never probes it again.
_device_stats_dead = False
# The card's total memory by device index (read once: it does not change).
_limits: dict[int, int] = {}


def _world_device():
    """The device of the world this process formed, or None: no world, or
    no ``basics`` imported at all (the driver, which never imports
    torch)."""
    basics = sys.modules.get(f"{__package__}.basics")
    state = getattr(basics, "_state", None)
    return getattr(state, "device", None)


def _allocator_stats(index: int) -> dict:
    """The caching allocator's nested statistics of card ``index``:
    ``torch._C._cuda_memoryStats``, which ``torch.cuda.memory_allocated``
    and its siblings flatten into a dict of every counter before reading
    one."""
    import torch

    raw = getattr(torch._C, "_cuda_memoryStats", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.memory_stats_as_nested_dict(index)


def device_memory_stats() -> dict | None:
    """The card's memory as the reference's keys name it: ``bytes_in_use``
    (``torch.cuda.memory_allocated``), ``peak_bytes_in_use``
    (``max_memory_allocated``), ``bytes_reserved`` (``memory_reserved``)
    and ``bytes_limit`` (the total of ``torch.cuda.mem_get_info``, read
    once). None in a CPU world, before ``init()`` and on the driver; a
    read that fails once is not tried again. Never synchronizes, never
    raises."""
    global _device_stats_dead
    if _device_stats_dead:
        return None
    device = _world_device()
    if device is None or device.type != "cuda":
        return None
    try:
        import torch

        index = device.index if device.index is not None else \
            torch.cuda.current_device()
        stats = _allocator_stats(index)
        if index not in _limits:
            _limits[index] = int(torch.cuda.mem_get_info(index)[1])
        return {
            "bytes_in_use": int(stats["allocated_bytes"]["all"]["current"]),
            "peak_bytes_in_use": int(stats["allocated_bytes"]["all"]["peak"]),
            "bytes_reserved": int(stats["reserved_bytes"]["all"]["current"]),
            "bytes_limit": _limits[index],
        }
    except Exception:  # noqa: BLE001 — the stats are advisory
        _device_stats_dead = True
        return None


# ---------------------------------------------------------------------------
# Leaf descriptors
# ---------------------------------------------------------------------------
#
# The model's unit of account is the leaf descriptor
# ``(size_elems, itemsize[, dtype])``: element counts, not bytes, because the
# ownership map shards ELEMENTS (``ceil(10/8)*4 = 8`` bytes per rank for a
# 10-element float32 leaf, where a byte-level ``ceil(40/8) = 5`` would be
# wrong). ``dtype`` (optional) feeds the fusion-bucket mirror's same-dtype
# packing rule.


def _normalize_leaves(leaves) -> list[tuple[int, int, str]]:
    """Normalize to ``[(size_elems, itemsize, dtype), ...]``. Accepts
    descriptor lists (2- or 3-tuples) or tensors (:func:`leaf_templates`)."""
    if leaves is None:
        return []
    if isinstance(leaves, (list, tuple)) and (
            not leaves or (isinstance(leaves[0], (list, tuple))
                           and len(leaves[0]) in (2, 3)
                           and all(isinstance(v, (int, float))
                                   for v in leaves[0][:2]))):
        out = []
        for entry in leaves:
            size, itemsize = int(entry[0]), int(entry[1])
            dtype = str(entry[2]) if len(entry) > 2 else f"i{itemsize}"
            if size > 0 and itemsize > 0:
                out.append((size, itemsize, dtype))
        return out
    return leaf_templates(leaves)


def dtype_name(dtype) -> str:
    """A torch dtype as the reference names a dtype (``float32``,
    ``bfloat16``): the fusion mirror packs by this name."""
    return str(dtype).replace("torch.", "")


def _named_tensors(tree, prefix: str = ""):
    """``(path, tensor)`` pairs of a module's parameters, a mapping, a
    sequence or a tensor, in order (nested containers too)."""
    if hasattr(tree, "named_parameters"):
        yield from tree.named_parameters()
    elif isinstance(tree, Mapping):
        for key, value in tree.items():
            yield from _named_tensors(value, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _named_tensors(value, f"{prefix}{i}.")
    elif hasattr(tree, "numel") and hasattr(tree, "element_size"):
        yield prefix[:-1] or "<root>", tree


def leaf_templates(tree) -> list[tuple[int, int, str]]:
    """Leaf descriptors ``[(size_elems, itemsize, dtype), ...]`` of a
    module's parameters or a (nested) mapping or sequence of tensors, in
    order; a scalar counts one element. Reads shapes only, never data
    (meta tensors work)."""
    out = []
    for _, t in _named_tensors(tree):
        out.append((max(1, int(t.numel())), int(t.element_size()),
                    dtype_name(t.dtype)))
    return out


def tree_nbytes(tree) -> int:
    """Total bytes of a tree's tensors (:func:`leaf_templates`)."""
    return sum(s * i for s, i, _ in leaf_templates(tree))


def named_leaf_bytes(tree, limit: int | None = None,
                     ) -> list[tuple[str, int]]:
    """``[(path, nbytes), ...]`` of a tree's tensors, largest first: the
    view an out-of-memory flight record names. Never raises (a tree it
    cannot walk gives ``[]``)."""
    try:
        out = [(name, max(1, int(t.numel())) * int(t.element_size()))
               for name, t in _named_tensors(tree)]
        out.sort(key=lambda p: p[1], reverse=True)
        return out[:limit] if limit else out
    except Exception:  # noqa: BLE001 — forensics must not raise
        return []


# ---------------------------------------------------------------------------
# The analytic footprint model
# ---------------------------------------------------------------------------


def _resident_leaf_bytes(leaves: Sequence[tuple[int, int, str]],
                         sharded: bool, world_size: int) -> int:
    """Per-rank resident bytes of a leaf list: full bytes, or the
    per-leaf ``ceil(size/n)`` shard rows (exact: a rank holds a ``(s,)``
    shard of each leaf, ``param_sharding.resident_param_bytes``)."""
    if not sharded:
        return sum(size * itemsize for size, itemsize, _ in leaves)
    n = max(1, int(world_size))
    return sum(ceil_shard(size, n) * itemsize
               for size, itemsize, _ in leaves)


def predict_footprint(
    param_templates,
    sync_mode: str = "allreduce",
    world_size: int = 1,
    mesh_shape: tuple[int, int] | None = None,
    opt_templates=None,
    opt_slots: int | None = None,
    int8: bool = False,
    num_segments: int | None = None,
    threshold_bytes: int | None = None,
    grad_itemsize: int | None = None,
    expert_set: Mapping | None = None,
    serving_staging: bool = False,
    capacity: int | None = None,
) -> dict:
    """Price one training configuration's per-rank device bytes.

    ``param_templates`` / ``opt_templates`` are leaf descriptor lists
    ``[(size_elems, itemsize[, dtype])]`` or tensors (full-shape
    MONOLITHIC templates in both cases — the model derives each sync
    mode's layout itself). The numbers are the reference's, bit for bit,
    on the same descriptors; :func:`footprint_of` adds what the port holds
    beyond them. Resident pricing is exact:

    - ``monolithic`` (allreduce): full params + full optimizer state.
    - ``sharded`` (ZeRO-1): full params + per-leaf
      ``ceil(size/n)·itemsize`` optimizer rows (the stacked
      ``(n, ceil(size/n))`` layout of ``optimizer.init_sharded_state``;
      scalar leaves ride the ``max(1, ·)`` floor).
    - ``fsdp`` (ZeRO-3): per-leaf ceil rows for params AND optimizer
      state. A 2-D ``mesh_shape`` changes nothing resident (the ceil
      identity — see :func:`ceil_shard`), only the transient gather
      legs.

    ``opt_templates`` should be the INNER optimizer's monolithic state
    templates (:func:`opt_state_templates`); per-rank sharded state
    equals the per-leaf ceil of those monolithic leaves because the
    shard-local inner optimizer's state is shaped like its
    ``(ceil(size/n),)`` parameter shards. Omitted, optimizer state falls
    back to ``opt_slots`` param-sized copies (default
    ``HOROVOD_HBM_OPT_SLOTS`` = 1 — SGD momentum; Adam wants 2) —
    approximate, flagged ``"opt_exact": False``. ``int8`` adds the
    reference's stochastic-rounding salt (one uint32 per rank).

    Transient peaks (modeled, not exactness-tested):

    - ``grad_buckets`` — 2× the largest fused gradient bucket under
      ``threshold_bytes`` (in-flight fused buffer + collective
      output), at ``grad_itemsize`` wire bytes per element (int8 wire
      = 1).
    - ``fsdp_gather`` — the largest per-segment just-in-time gather's
      full-leaf bytes (``segment_byte_runs`` over ``num_segments``,
      the stdlib mirror of ``ops.fusion.segment_leaves``).
    - ``model_axis_gather`` — the reference's 2-D wire's intermediate
      batch-leg block (``batch·ceil(size/(batch·model))`` elements per
      leaf) for the largest segment; 0 on a flat mesh (the port's).
    - ``moe_alltoall`` — dispatch + combine buffers from
      ``expert_set`` (``{"bytes": ...}`` explicit, or
      ``tokens_per_rank × hidden × itemsize``), ×2 for the two wires.
    - ``serve_staging`` — a full staged replica during a serving
      hot-swap (``serving_staging=True``).

    Returns a per-kind breakdown with ``resident_total``,
    ``transient_peak`` (the max single transient — they do not
    coexist at peak), ``peak_total``, and — when ``capacity`` (or
    :func:`capacity_bytes`) is known — ``predicted_headroom_ratio``.
    """
    params = _normalize_leaves(param_templates)
    mode = (str(sync_mode) or "allreduce").strip().lower()
    n = max(1, int(world_size))
    if mesh_shape:
        b, m = max(1, int(mesh_shape[0])), max(1, int(mesh_shape[1]))
        if b * m != n:
            n = b * m
    else:
        b, m = n, 1

    # -- resident ----------------------------------------------------------
    params_sharded = mode == "fsdp"
    opt_sharded = mode in ("sharded", "fsdp")
    resident_params = _resident_leaf_bytes(params, params_sharded, n)
    opt_exact = opt_templates is not None
    if opt_exact:
        opt_leaves = _normalize_leaves(opt_templates)
        resident_opt = _resident_leaf_bytes(opt_leaves, opt_sharded, n)
    else:
        slots = (max(0, int(opt_slots)) if opt_slots is not None
                 else max(0, get_int("HOROVOD_HBM_OPT_SLOTS", 1)))
        resident_opt = slots * _resident_leaf_bytes(params, opt_sharded, n)
    if int8:
        resident_opt += 4  # the stochastic-rounding salt: a () uint32
        # monolithic, one row of a (n,) uint32 stacked — 4 bytes/rank
        # either way

    # -- transients --------------------------------------------------------
    k = max(1, int(num_segments)) if num_segments else 1
    if threshold_bytes is None:
        threshold_bytes = get_int("HOROVOD_FUSION_THRESHOLD",
                                  64 * 1024 * 1024)
    wire = [(size * (int(grad_itemsize) if grad_itemsize
                     else (1 if int8 else itemsize)), dtype)
            for size, itemsize, dtype in params]
    buckets = []
    for run in segment_byte_runs(wire, k):
        buckets.extend(bucket_byte_sizes(run, int(threshold_bytes)))
    grad_buckets = 2 * max(buckets, default=0)

    fsdp_gather = 0
    model_axis_gather = 0
    if mode == "fsdp" and params:
        runs = segment_byte_runs(
            [(size * itemsize, dtype) for size, itemsize, dtype in params],
            k)
        fsdp_gather = max((sum(nb for nb, _ in run) for run in runs),
                          default=0)
        if m > 1:
            # The batch-leg gather materializes each leaf's model block
            # (batch rows of the resident shard) before the model-axis
            # allgather completes it — price the largest segment's
            # blocks. Segments index the same contiguous runs, so walk
            # leaves through the byte-midpoint rule directly.
            by_leaf = segment_byte_runs(
                [(size * itemsize, f"{i}") for i, (size, itemsize, _)
                 in enumerate(params)], k)
            best = 0
            for run in by_leaf:
                block = sum(
                    b * ceil_shard(params[int(tag)][0], n)
                    * params[int(tag)][1] for _, tag in run)
                best = max(best, block)
            model_axis_gather = best

    moe_alltoall = 0
    if expert_set:
        try:
            explicit = expert_set.get("bytes")
            if explicit is not None:
                moe_alltoall = 2 * int(explicit)
            else:
                tokens = int(expert_set.get("tokens_per_rank", 0))
                hidden = int(expert_set.get("hidden", 0))
                itemsize = int(expert_set.get("itemsize", 4))
                moe_alltoall = 2 * tokens * hidden * itemsize
        except (TypeError, ValueError):
            moe_alltoall = 0

    serve_staging = (sum(size * itemsize for size, itemsize, _ in params)
                     if serving_staging else 0)

    transient = {
        "grad_buckets": int(grad_buckets),
        "fsdp_gather": int(fsdp_gather),
        "model_axis_gather": int(model_axis_gather),
        "moe_alltoall": int(moe_alltoall),
        "serve_staging": int(serve_staging),
    }
    resident = {"params": int(resident_params),
                "opt_state": int(resident_opt)}
    resident_total = sum(resident.values())
    transient_peak = max(transient.values(), default=0)
    out = {
        "sync_mode": mode,
        "world_size": n,
        "mesh_shape": [b, m] if mesh_shape else None,
        "num_segments": k,
        "int8": bool(int8),
        "opt_exact": bool(opt_exact),
        "resident": resident,
        "transient": transient,
        "resident_total": int(resident_total),
        "transient_peak": int(transient_peak),
        "peak_total": int(resident_total + transient_peak),
    }
    cap = capacity if capacity is not None else capacity_bytes()
    if cap:
        out["capacity_bytes"] = int(cap)
        out["predicted_headroom_ratio"] = round(
            max(0.0, 1.0 - out["peak_total"] / float(cap)), 4)
    return out


def _optimizer_leaves(optimizer):
    """The full parameters a (``Distributed``) optimizer updates, as
    ``(shapes, dtypes, groups)``: each parameter's full shape and dtype in
    ``param_groups`` order (an fsdp optimizer's from its shard meta: its
    model's own Parameters hold no data), and each param group's indices
    into them with the group's hyper-parameters."""
    from .optimizer import _FsdpOptimizer, _ShardedOptimizer

    inner = getattr(optimizer, "_opt", optimizer)
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in inner.param_groups]
    if isinstance(optimizer, _FsdpOptimizer):
        shapes = list(optimizer.meta.shapes)
        dtypes = list(optimizer.meta.dtypes)
        return shapes, dtypes, list(zip(optimizer._groups, hyper))
    if isinstance(optimizer, _ShardedOptimizer):
        # The inner optimizer's groups hold the shards.
        params = optimizer._params
        groups = list(zip(optimizer._groups, hyper))
    else:
        params = list(getattr(optimizer, "_params", []))
        index = {id(p): i for i, p in enumerate(params)}
        if not params:  # a plain torch.optim.Optimizer
            for g in inner.param_groups:
                for p in g["params"]:
                    if id(p) not in index:
                        index[id(p)] = len(params)
                        params.append(p)
        groups = [([index[id(p)] for p in g["params"] if id(p) in index], h)
                  for g, h in zip(inner.param_groups, hyper)]
    return ([tuple(p.shape) for p in params], [p.dtype for p in params],
            groups)


def opt_state_templates(optimizer, shapes, dtypes, groups,
                        host_too: bool = False):
    """The wrapped optimizer's state after one step over full parameters
    of ``shapes`` and ``dtypes``, as leaf descriptors: ``(on_device,
    on_host)``. A copy of the optimizer's class with its groups'
    hyper-parameters steps once on meta tensors (no memory, no data), so
    the templates are the class's own state: SGD's momentum buffer, Adam's
    and AdamW's two moments (and ``max_exp_avg_sq`` with ``amsgrad``) in
    the parameter's dtype, and their ``step`` scalars, which torch keeps on
    the host unless the optimizer is ``capturable`` or ``fused``
    (``on_host``; ``host_too`` counts them on the device, as a CPU world
    holds them beside the parameters). None when the class cannot step on
    meta tensors."""
    import torch

    inner = getattr(optimizer, "_opt", optimizer)
    metas = [torch.nn.Parameter(torch.empty(s, dtype=d, device="meta"))
             for s, d in zip(shapes, dtypes)]
    for p in metas:
        p.grad = torch.zeros_like(p)
    try:
        probe = type(inner).__new__(type(inner))
        torch.optim.Optimizer.__init__(
            probe, [{**h, "params": [metas[i] for i in idx]}
                    for idx, h in groups if idx], dict(inner.defaults))
        with torch.no_grad():
            probe.step()
    except Exception:  # noqa: BLE001 — the caller falls back to slots
        return None
    on_device, on_host = [], []
    for p in metas:
        for v in probe.state.get(p, {}).values():
            if not torch.is_tensor(v):
                continue
            leaf = (max(1, int(v.numel())), int(v.element_size()),
                    dtype_name(v.dtype))
            (on_device if v.is_meta or host_too else on_host).append(leaf)
    return on_device, on_host


def footprint_of(optimizer, params=None, world_size: int | None = None,
                 sync_mode: str | None = None,
                 mesh_shape: tuple[int, int] | None = None,
                 num_segments: int | None = None,
                 **kwargs) -> dict:
    """:func:`predict_footprint` for a live ``DistributedOptimizer`` (or
    a plain ``torch.optim`` optimizer, priced in allreduce mode): the
    parameters' full shapes, the sync mode, the world size, the wire's
    itemsize and the fsdp segment count come from the optimizer, and the
    inner optimizer's state templates from one step of its class on meta
    tensors (:func:`opt_state_templates`: exact, nothing allocates).
    ``params`` is accepted for the reference's signature and not read:
    the optimizer knows its parameters in every mode.

    It prices what the port holds, which differs from the JAX layout:

    - ``resident["opt_state"]`` is the state on the parameters' device.
      AdamW keeps a float32 ``step`` tensor per parameter (optax keeps one
      ``count``), on the host unless ``capturable`` or ``fused``: those
      scalars are ``opt_state_host``, and count on the device in a CPU
      world.
    - The sharded mode keeps, beside the full parameters, a flat copy of
      this rank's shard of each (the Parameters its inner optimizer
      steps): ``resident["params"]`` adds their ``ceil(size/n)`` rows.
    - The int8 wire's rounding salt is a Python counter, not a device
      scalar: no 4 bytes.
    - torch keeps the gradients in ``.grad`` from the backward until
      ``zero_grad(set_to_none=True)``, which ``make_train_step`` calls
      after each update: ``transient["grads"]`` (the full gradients;
      sharded: and the shards' gradients; fsdp: the shards' only). It
      lives beside every other transient, so ``transient_peak`` adds it
      to their largest.
    - Every bucket of a step's wire is in flight at once (the hooks launch
      them during the backward, ``step()`` waits for all):
      ``transient["grad_buckets"]`` is the whole bucketed wire (fsdp: its
      largest segment's), where the reference counts twice the largest
      bucket.
    """
    from . import basics
    from .compression import Compression
    from .ops import fusion
    from .optimizer import _is_int8, sync_mode_of

    del params
    distributed = hasattr(optimizer, "_ps")
    if sync_mode is None:
        sync_mode = (sync_mode_of(optimizer) if distributed
                     else "allreduce")
    if world_size is None:
        world_size = (optimizer._ps.size() if distributed
                      else basics.size() if basics.is_initialized() else 1)
    n = max(1, int(world_size))
    if num_segments is None:
        num_segments = fusion.fsdp_segments() if sync_mode == "fsdp" else 1
    compression = getattr(optimizer, "_compression", Compression.none)
    int8 = _is_int8(compression)
    shapes, dtypes, groups = _optimizer_leaves(optimizer)
    numels = [max(1, math.prod(s)) for s in shapes]
    itemsizes = [d.itemsize for d in dtypes]
    param_leaves = [(m, i, dtype_name(d))
                    for m, i, d in zip(numels, itemsizes, dtypes)]
    device = _world_device()
    templates = opt_state_templates(
        optimizer, shapes, dtypes, groups,
        host_too=device is None or device.type == "cpu")
    opt_device, opt_host = templates if templates is not None else (None,
                                                                    [])
    if int8:
        wire_itemsize = [1] * len(dtypes)
    else:
        import torch

        wire_itemsize = [compression.compress(torch.empty(
            0, dtype=d, device="meta"))[0].element_size() for d in dtypes]
    fp = predict_footprint(
        param_leaves, sync_mode=sync_mode, world_size=n,
        mesh_shape=mesh_shape, opt_templates=opt_device,
        num_segments=num_segments,
        grad_itemsize=wire_itemsize[0] if wire_itemsize else None,
        **kwargs)
    shards = sum(ceil_shard(m, n) * i for m, i in zip(numels, itemsizes))
    full = sum(m * i for m, i in zip(numels, itemsizes))
    if sync_mode == "sharded":
        fp["resident"]["params"] += shards
    grads = {"allreduce": full, "sharded": full + shards,
             "fsdp": shards}.get(sync_mode, full)
    sharded_wire = sync_mode in ("sharded", "fsdp")
    wire = [((n * ceil_shard(m, n)) if sharded_wire else m) * w
            for m, w in zip(numels, wire_itemsize)]
    threshold = getattr(optimizer, "_threshold", None)
    if threshold is None:
        threshold = fusion.fusion_threshold_bytes()
    runs = segment_byte_runs(
        [(b, dtype_name(d)) for b, d in zip(wire, dtypes)],
        num_segments if sync_mode == "fsdp" else 1)
    fp["transient"]["grad_buckets"] = max(
        (sum(bucket_byte_sizes(run, int(threshold))) for run in runs),
        default=0)
    fp["transient"]["grads"] = grads
    fp["int8"] = int8
    fp["opt_state_host"] = sum(s * i for s, i, _ in opt_host)
    fp["resident_total"] = sum(fp["resident"].values())
    others = [v for k, v in fp["transient"].items() if k != "grads"]
    fp["transient_peak"] = (max(others, default=0)
                            + fp["transient"].get("grads", 0))
    fp["peak_total"] = fp["resident_total"] + fp["transient_peak"]
    if "capacity_bytes" in fp:
        fp["predicted_headroom_ratio"] = round(
            max(0.0, 1.0 - fp["peak_total"] / float(fp["capacity_bytes"])), 4)
    return fp


# ---------------------------------------------------------------------------
# Live accounting
# ---------------------------------------------------------------------------


class MemoryObservatory:
    """The per-process observatory: exact resident bytes by kind (noted
    by the call sites that materialize state, or polled from registered
    byte suppliers), per-phase watermarks driven by the tracing plane's
    span exits, the last predicted footprint, and the forensics leaf
    table."""

    def __init__(self):
        self._lock = threading.Lock()
        self._resident: dict[str, int] = {}
        self._suppliers: dict[str, Callable[[], int]] = {}
        self._top_leaves: dict[str, list[tuple[str, int]]] = {}
        self._watermarks: dict[str, int] = {}
        self._peak = 0
        self._journaled_peak = 0
        self._predicted: dict | None = None
        self._layout: list[tuple[int, int, str]] = []
        self._phase_notes = 0
        self._oom_dumps = 0

    # -- intake ---------------------------------------------------------------

    def note_resident(self, kind: str, nbytes: int,
                      top_leaves: Sequence[tuple[str, int]] | None = None,
                      ) -> None:
        """Record the exact resident bytes of one kind (a call site
        that just materialized or resized that state). ``top_leaves``
        (``[(path, nbytes)]``, largest first) feeds the OOM forensics
        table. Negative/non-finite values are rejected; never
        raises."""
        try:
            nbytes = int(nbytes)
        except (TypeError, ValueError):
            return
        if nbytes < 0:
            return
        with self._lock:
            self._resident[str(kind)] = nbytes
            if top_leaves:
                self._top_leaves[str(kind)] = [
                    (str(p), int(b)) for p, b in top_leaves][:top_n()]
        self._export_gauges()

    def register_supplier(self, kind: str, fn: Callable[[], int]) -> None:
        """Register a live byte supplier for a kind whose size changes
        outside any noting call site (the peer replica pool). Polled —
        cheaply, and exception-guarded — on every measurement."""
        with self._lock:
            self._suppliers[str(kind)] = fn

    def note_layout(self, leaves) -> None:
        """Remember the model's parameter leaf layout
        ``[(size_elems, itemsize[, dtype])]`` — noted once per bucket plan
        beside the comms model's byte layout. The largest layout seen
        wins (a grouped allreduce notes a subset). This is the autotune
        memory guard's pricing input."""
        leaves = _normalize_leaves(leaves)
        if not leaves:
            return
        with self._lock:
            if sum(s * i for s, i, _ in leaves) >= sum(
                    s * i for s, i, _ in self._layout):
                self._layout = leaves

    def layout(self) -> list[tuple[int, int, str]]:
        with self._lock:
            return list(self._layout)

    def note_predicted(self, footprint: Mapping | None) -> None:
        """Pin the model's current prediction (a
        :func:`predict_footprint` result) — the residual gauge compares
        every subsequent measurement against it."""
        with self._lock:
            self._predicted = dict(footprint) if footprint else None
        self._export_gauges()

    # -- measurement ----------------------------------------------------------

    def measured_resident(self) -> dict[str, int]:
        """Per-kind resident bytes: the noted cells plus one guarded
        poll of every registered supplier."""
        with self._lock:
            out = dict(self._resident)
            suppliers = dict(self._suppliers)
        for kind, fn in suppliers.items():
            try:
                nbytes = int(fn())
                if nbytes >= 0:
                    out[kind] = nbytes
            except Exception:  # noqa: BLE001 — a dead supplier must
                pass  # not break the measurement
        return out

    def resident_total(self) -> int:
        return sum(self.measured_resident().values())

    def predicted(self) -> dict | None:
        with self._lock:
            return dict(self._predicted) if self._predicted else None

    def residual_bytes(self) -> int | None:
        """Predicted − measured over the MODEL kinds (params +
        opt_state) — the drift alarm. None until both sides exist."""
        pred = self.predicted()
        if not pred:
            return None
        measured = self.measured_resident()
        model_measured = sum(measured.get(k, 0) for k in MODEL_KINDS)
        if model_measured <= 0:
            return None
        try:
            return int(pred["resident_total"]) - model_measured
        except (KeyError, TypeError, ValueError):
            return None

    def headroom_ratio(self) -> float | None:
        """``1 − resident_total/capacity`` clamped to [0, 1], or None
        when no capacity source exists (the gauge then reads its
        zero-materialized 0 = unknown)."""
        cap = capacity_bytes()
        if not cap:
            return None
        return max(0.0, min(1.0, 1.0 - self.resident_total() / float(cap)))

    def note_phase(self, name: str, cat: str | None = None) -> None:
        """Watermark hook, called by the tracer at every span close
        (``tracing.StepTracer.end_span``, and the step envelope): fold the
        current resident total, and the card's bytes in use where there is
        a card (one read of the allocator's counters, no synchronization),
        into the span's phase watermark. A new process-lifetime peak ≥5%
        above the last journaled one emits an ``hbm_watermark`` journal
        event (latched — growth bursts journal once, steady state never).
        Never raises."""
        try:
            phase = str(name) if str(name) in PHASES else (
                "collective" if cat == "collective" else
                "step" if cat == "step" else "other")
            total = self.resident_total()
            stats = device_memory_stats()
            if stats:
                total = max(total, int(stats.get("bytes_in_use", 0)))
            journal = False
            with self._lock:
                self._phase_notes += 1
                if total > self._watermarks.get(phase, 0):
                    self._watermarks[phase] = total
                if total > self._peak:
                    self._peak = total
                    if total > self._journaled_peak * 1.05:
                        self._journaled_peak = total
                        journal = True
            try:
                from . import metrics

                metrics.HBM_WATERMARK.set(
                    self._watermarks.get(phase, total), phase=phase)
                if journal:
                    metrics.event("hbm_watermark", phase=phase,
                                  bytes=total)
            except Exception:  # noqa: BLE001 — gauges are advisory
                pass
        except Exception:  # noqa: BLE001 — the span close must not fail
            pass

    def watermarks(self) -> dict[str, int]:
        with self._lock:
            return dict(self._watermarks)

    def peak_bytes(self) -> int:
        with self._lock:
            return self._peak

    def top_leaves(self, limit: int | None = None) -> list[dict]:
        """The forensics table: the largest noted resident leaves
        across every kind, ``[{"kind", "leaf", "bytes"}, ...]``
        largest first."""
        with self._lock:
            rows = [
                {"kind": kind, "leaf": path, "bytes": nbytes}
                for kind, entries in self._top_leaves.items()
                for path, nbytes in entries
            ]
        rows.sort(key=lambda r: r["bytes"], reverse=True)
        return rows[:limit or top_n()]

    # -- export ---------------------------------------------------------------

    def _export_gauges(self) -> None:
        """Mirror the observatory into the scrape gauges
        (best-effort)."""
        try:
            from . import metrics

            for kind, nbytes in self.measured_resident().items():
                metrics.HBM_BYTES.set(nbytes, kind=kind)
            residual = self.residual_bytes()
            if residual is not None:
                metrics.HBM_RESIDUAL.set(residual)
            ratio = self.headroom_ratio()
            if ratio is not None:
                metrics.HBM_HEADROOM.set(ratio)
        except Exception:  # noqa: BLE001 — gauges are advisory
            pass

    def payload(self) -> dict:
        """The per-rank wire format piggybacked on heartbeats and
        merged by ``GET /memory``. A process that has noted nothing
        resident serves an explicit ``insufficient_samples`` status —
        never an error."""
        measured = self.measured_resident()
        status = "ok" if measured else "insufficient_samples"
        ratio = self.headroom_ratio()
        residual = self.residual_bytes()
        pred = self.predicted()
        with self._lock:
            watermarks = dict(self._watermarks)
            peak = self._peak
        return {
            "rank": _rank(),
            "host": _host(),
            "t": time.time(),
            "status": status,
            "resident": {k: int(v) for k, v in measured.items()},
            "resident_total": int(sum(measured.values())),
            "watermarks": {k: int(v) for k, v in watermarks.items()},
            "peak_bytes": int(peak),
            "predicted": pred,
            "residual_bytes": residual,
            "headroom_ratio": (round(ratio, 4)
                               if ratio is not None else None),
            "capacity_bytes": capacity_bytes(),
            "device": device_memory_stats(),
        }

    def summary(self) -> dict:
        """``profiler.summary()["memory"]``: the process-local view."""
        p = self.payload()
        return {
            "status": p["status"],
            "resident": p["resident"],
            "resident_total": p["resident_total"],
            "watermarks": p["watermarks"],
            "peak_bytes": p["peak_bytes"],
            "predicted": p["predicted"],
            "residual_bytes": p["residual_bytes"],
            "headroom_ratio": p["headroom_ratio"],
            "capacity_bytes": p["capacity_bytes"],
            "top_leaves": self.top_leaves(),
        }

    def flight_summary(self) -> dict | None:
        """The compact section every flight record carries (like
        ``peercheck.pool_summary``): per-kind bytes + watermarks +
        the drift. None when nothing was ever measured (the dump then
        omits the section rather than carrying an empty one)."""
        measured = self.measured_resident()
        if not measured and not self.peak_bytes():
            return None
        return {
            "resident": {k: int(v) for k, v in measured.items()},
            "resident_total": int(sum(measured.values())),
            "watermarks": self.watermarks(),
            "peak_bytes": self.peak_bytes(),
            "residual_bytes": self.residual_bytes(),
        }


# ---------------------------------------------------------------------------
# Singleton + module facade
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_observatory: MemoryObservatory | None = None


def get_observatory() -> MemoryObservatory:
    global _observatory
    with _lock:
        if _observatory is None:
            _observatory = MemoryObservatory()
        return _observatory


def reset_for_testing() -> None:
    """Fresh observatory (``comms_model.reset_for_testing``
    semantics)."""
    global _observatory
    with _lock:
        _observatory = None


def note_resident(kind: str, nbytes: int,
                  top_leaves: Sequence[tuple[str, int]] | None = None,
                  ) -> None:
    get_observatory().note_resident(kind, nbytes, top_leaves)


def note_named(kind: str, named) -> None:
    """Note ``named`` (``(name, tensor or bytes)`` pairs) as this rank's
    resident ``kind``: their total, the largest named for the forensics
    table. Never raises."""
    try:
        sizes = sorted(
            ((str(name), v if isinstance(v, int)
              else int(v.numel()) * int(v.element_size()))
             for name, v in named),
            key=lambda kv: kv[1], reverse=True)
    except Exception:  # noqa: BLE001 — instrumentation is best-effort
        return
    note_resident(kind, sum(b for _, b in sizes), top_leaves=sizes)


def note_phase(name: str, cat: str | None = None) -> None:
    get_observatory().note_phase(name, cat)


def summary() -> dict:
    return get_observatory().summary()


def flight_summary() -> dict | None:
    return get_observatory().flight_summary()


# ---------------------------------------------------------------------------
# OOM forensics (the training step boundary's consumer)
# ---------------------------------------------------------------------------

#: Substrings that identify an out-of-memory failure: torch's
#: ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory. Tried to allocate
#: ..."), the reference's XLA and allocator grammars, and the injected
#: ``memory.pressure`` marker. Deliberately no bare "oom" — it matches
#: innocent words.
_OOM_MARKERS = ("resource_exhausted", "resource exhausted",
                "out of memory", "out_of_memory", "hbm oom",
                "memory.pressure", "failed to allocate")


def is_oom_error(exc: BaseException) -> bool:
    """Does this exception look like device memory exhaustion
    (``torch.cuda.OutOfMemoryError`` among others)? String match, as the
    reference's: the type name and the message are what every backend
    shares."""
    try:
        text = f"{type(exc).__name__}: {exc}".lower()
    except Exception:  # noqa: BLE001 — an unprintable exception
        return False
    return any(marker in text for marker in _OOM_MARKERS)


def oom_flight_fields(exc: BaseException | None = None) -> dict:
    """The memory forensics fields an OOM flight record carries: the
    top-N resident leaves, the per-kind breakdown, and the
    predicted-vs-measured delta. Never raises."""
    obs = get_observatory()
    fields: dict[str, Any] = {
        "memory_top_leaves": obs.top_leaves(),
        "memory_resident": {k: int(v)
                            for k, v in obs.measured_resident().items()},
        "memory_peak_bytes": obs.peak_bytes(),
    }
    residual = obs.residual_bytes()
    if residual is not None:
        fields["memory_residual_bytes"] = residual
    pred = obs.predicted()
    if pred:
        fields["memory_predicted_total"] = pred.get("resident_total")
    cap = capacity_bytes()
    if cap:
        fields["memory_capacity_bytes"] = cap
    if exc is not None:
        fields["error"] = str(exc)[:500]
    return fields


def dump_oom_record(exc: BaseException, generation: int | None = None,
                    **extra) -> None:
    """Dump the OOM flight record (reason ``oom``) naming the top
    resident leaves and the model drift — the training step's boundary
    (``parallel/data_parallel.py``) calls this before re-raising. Never
    raises."""
    try:
        get_observatory()._oom_dumps += 1
        from . import tracing

        tracing.dump_flight_record("oom", generation=generation,
                                   **oom_flight_fields(exc), **extra)
    except Exception:  # noqa: BLE001 — forensics must not mask the OOM
        pass


# ---------------------------------------------------------------------------
# Autotune consumer: the memory guard
# ---------------------------------------------------------------------------


def memory_guard_enabled() -> bool:
    """The autotune memory guard (``HOROVOD_AUTOTUNE_MEMORY_GUARD=1``):
    model-guided pruning additionally rejects (sync_mode, segments,
    mesh-shape) candidates whose predicted footprint exceeds the
    available headroom. Off by default — with the knob unset autotune
    decisions are bit-for-bit unchanged — and inert even when armed
    until a capacity source exists AND a traced flush has noted the
    parameter layout (a cold process prunes nothing)."""
    return os.environ.get(
        "HOROVOD_AUTOTUNE_MEMORY_GUARD", "").strip() == "1"


def candidate_footprint_bytes(sync_mode: str, num_segments: int = 1,
                              mesh_shape: tuple[int, int] | None = None,
                              world_size: int | None = None,
                              observatory: MemoryObservatory | None = None,
                              ) -> int | None:
    """Predicted per-rank peak bytes for one autotune candidate, priced
    from the noted parameter layout (pure and deterministic: the same
    layout + env yields the same number on every rank — the same
    rank-identity contract as ``comms_model.prune_candidates``). None
    when no layout was noted yet."""
    obs = observatory or get_observatory()
    layout = obs.layout()
    if not layout:
        return None
    if world_size is None:
        try:
            world_size = int(os.environ.get("HOROVOD_SIZE", "") or 0)
        except ValueError:
            world_size = 0
        if not world_size:
            basics = sys.modules.get(f"{__package__}.basics")
            if basics is None or not basics.is_initialized():
                return None  # the driver, or no world: unknown
            world_size = basics.size()
    fp = predict_footprint(layout, sync_mode=sync_mode,
                           world_size=world_size, mesh_shape=mesh_shape,
                           num_segments=num_segments)
    return int(fp["peak_total"])


def check_candidate(sync_mode: str, num_segments: int = 1,
                    mesh_shape: tuple[int, int] | None = None,
                    world_size: int | None = None) -> None:
    """Raise :class:`~horovod_tpu_torch.exceptions.MemoryBudgetExceededError`
    (a ``SyncModeIneligibleError`` — ``tune_step_sync_mode`` skips it
    rank-identically, like the fsdp guards) when the candidate's
    predicted footprint exceeds the device capacity. Inert — returns
    None — when the guard is off, no layout is noted, or no capacity
    source exists."""
    if not memory_guard_enabled():
        return
    cap = capacity_bytes()
    if not cap:
        return
    predicted = candidate_footprint_bytes(
        sync_mode, num_segments=num_segments, mesh_shape=mesh_shape,
        world_size=world_size)
    if predicted is None:
        return
    if predicted > cap:
        from .exceptions import MemoryBudgetExceededError

        raise MemoryBudgetExceededError(
            f"autotune memory guard: sync_mode={sync_mode!r} "
            f"segments={num_segments} mesh_shape={mesh_shape} predicts "
            f"{predicted} bytes/rank against {cap} bytes of device "
            "capacity (HOROVOD_HBM_BYTES_PER_DEVICE / the card's total); "
            "candidate skipped rank-identically")


def filter_candidates(candidates: Sequence[Any],
                      world_size: int | None = None) -> dict:
    """Memory-guard filter over an autotune grid (the model-guided
    pruning's second stage): drop candidates whose predicted peak
    exceeds capacity. Returns ``{"kept", "pruned", "bytes"}`` with
    ``bytes`` aligned to ``candidates`` (None = unpriced). Never
    prunes the whole grid; pure and deterministic like
    ``comms_model.prune_candidates`` (rank 0's kept list is broadcast
    by the caller)."""
    from .comms_model import candidate_axes

    if not memory_guard_enabled():
        return {"kept": list(candidates), "pruned": [], "bytes": []}
    cap = capacity_bytes()
    priced: list[int | None] = []
    for cand in candidates:
        _, segments, sync_mode, _ = candidate_axes(cand)
        priced.append(candidate_footprint_bytes(
            sync_mode, num_segments=segments, world_size=world_size))
    if not cap:
        return {"kept": list(candidates), "pruned": [], "bytes": priced}
    kept, pruned = [], []
    for cand, nbytes in zip(candidates, priced):
        if nbytes is not None and nbytes > cap:
            pruned.append(cand)
        else:
            kept.append(cand)
    if not kept:  # a budget below every candidate cannot rank anything
        return {"kept": list(candidates), "pruned": [], "bytes": priced}
    return {"kept": kept, "pruned": pruned, "bytes": priced}


# ---------------------------------------------------------------------------
# Scheduler consumer: the advisory admission check
# ---------------------------------------------------------------------------


def admission_check(predicted_bytes: int | None,
                    capacity: int | None) -> dict | None:
    """Advisory multi-tenant admission verdict: compare a job's
    predicted per-rank footprint against the host set's advertised
    per-device memory. Returns the ``admission_memory_risk`` journal
    fields when the prediction EXCEEDS capacity, None otherwise (or
    when either side is unknown). Never changes a scheduling decision
    — the scheduler journals and grants regardless."""
    try:
        predicted_bytes = (int(predicted_bytes)
                           if predicted_bytes is not None else None)
        capacity = int(capacity) if capacity is not None else None
    except (TypeError, ValueError):
        return None
    if not predicted_bytes or not capacity or predicted_bytes <= 0 \
            or capacity <= 0:
        return None
    if predicted_bytes <= capacity:
        return None
    return {
        "predicted_bytes": predicted_bytes,
        "capacity_bytes": capacity,
        "deficit_bytes": predicted_bytes - capacity,
        "ratio": round(predicted_bytes / capacity, 4),
    }


# ---------------------------------------------------------------------------
# Cluster merge (driver-side; the KV server's GET /memory)
# ---------------------------------------------------------------------------


def _clean_int(value, floor: int = 0) -> int:
    try:
        f = float(value)
        if not math.isfinite(f):
            return floor  # NaN/Infinity would poison the /memory JSON
        v = int(f)
    except (TypeError, ValueError, OverflowError):
        return floor
    return v if v >= floor else floor


def merge_payloads(payloads: Mapping[str, Mapping]) -> dict:
    """Cluster-merged view over per-rank
    :meth:`MemoryObservatory.payload` dicts (keyed by host, as the
    heartbeat scope stores them). Malformed payloads are skipped — one
    broken worker must not break the merge. Cluster section: per-kind
    byte SUMS (the pod's total resident footprint), per-phase watermark
    MAXES (the worst rank bounds the pod), the minimum headroom ratio
    (the rank closest to OOM is the one that matters), and the largest
    absolute residual (the worst model drift). A cluster where nothing
    measured yet reports ``status: insufficient_samples`` — never an
    error."""
    ranks: dict[str, dict] = {}
    kind_totals: dict[str, int] = {}
    watermark_max: dict[str, int] = {}
    headroom_min: float | None = None
    residual_worst: int | None = None
    for host, payload in (payloads or {}).items():
        if not isinstance(payload, Mapping):
            continue
        rank = str(payload.get("rank", "?"))
        hostname = str(payload.get("host", host))
        if rank in ranks:
            rank = f"{rank}@{hostname}"  # same collision rule as /comms
        resident_raw = payload.get("resident")
        resident = {}
        if isinstance(resident_raw, Mapping):
            resident = {str(k): _clean_int(v)
                        for k, v in resident_raw.items()}
        watermarks_raw = payload.get("watermarks")
        watermarks = {}
        if isinstance(watermarks_raw, Mapping):
            watermarks = {str(k): _clean_int(v)
                          for k, v in watermarks_raw.items()}
        try:
            ratio = payload.get("headroom_ratio")
            ratio = float(ratio) if ratio is not None else None
            if ratio is not None and not math.isfinite(ratio):
                ratio = None
        except (TypeError, ValueError):
            ratio = None
        residual = payload.get("residual_bytes")
        try:
            residual = int(residual) if residual is not None else None
        except (TypeError, ValueError):
            residual = None
        ranks[rank] = {
            "host": hostname,
            "status": str(payload.get("status", "insufficient_samples")),
            "resident": resident,
            "resident_total": _clean_int(payload.get("resident_total",
                                                     sum(resident.values()))),
            "watermarks": watermarks,
            "peak_bytes": _clean_int(payload.get("peak_bytes", 0)),
            "headroom_ratio": (round(ratio, 4)
                               if ratio is not None else None),
            "residual_bytes": residual,
            "capacity_bytes": (_clean_int(payload.get("capacity_bytes"))
                               or None),
        }
        for kind, nbytes in resident.items():
            kind_totals[kind] = kind_totals.get(kind, 0) + nbytes
        for phase, nbytes in watermarks.items():
            watermark_max[phase] = max(watermark_max.get(phase, 0), nbytes)
        if ratio is not None:
            headroom_min = (ratio if headroom_min is None
                            else min(headroom_min, ratio))
        if residual is not None and (
                residual_worst is None
                or abs(residual) > abs(residual_worst)):
            residual_worst = residual
    status = ("ok" if any(r["status"] == "ok" for r in ranks.values())
              else "insufficient_samples")
    return {
        "status": status,
        "ranks": ranks,
        "cluster": {
            "resident_bytes": kind_totals,
            "resident_total": sum(kind_totals.values()),
            "watermark_bytes": watermark_max,
            "headroom_ratio_min": (round(headroom_min, 4)
                                   if headroom_min is not None else None),
            "residual_bytes_worst": residual_worst,
        },
    }
