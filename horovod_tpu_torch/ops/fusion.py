"""Tensor fusion: bucketed allreduce of many small tensors, the sharded
halves of an allreduce, and the non-finite tripwire over the reduced
buckets.

Port of ``horovod_tpu/ops/fusion.py``: ``fusion_threshold_bytes`` (:28),
``overlap_segments`` (:44), ``fsdp_segments`` (:60), ``segment_leaves``
(:77), ``nonfinite_action`` (:123), ``all_finite`` (:136), ``psum_flag``
(:154), ``bucket_leaves`` (:206), ``fused_allreduce`` (:320),
``shard_ownership`` (:434), ``_pack_shard_rows`` (:480),
``_split_shard_row`` (:493), ``fused_reducescatter`` (:504) and
``fused_allgather_shards`` (:569, with ``start_fused_allgather_shards``,
which returns with its buckets in flight). Each collective has a fixed launch
cost, so tensors are packed in order into same-dtype buckets of at most
``HOROVOD_FUSION_THRESHOLD`` bytes, reduced with one collective per bucket,
and unpacked.

The sharded sync modes split a bucket's allreduce into its halves: one
``reduce_scatter_tensor`` of the bucket packed as ``(n, R)`` rows, row r
the concatenation of rank r's owned slice of every leaf (rank r owns
``[r*s, (r+1)*s)`` of each leaf's zero-padded flat view, ``s =
ceil(numel/n)``), and one ``all_gather_into_tensor`` of the owned slices
back to full tensors.

Each bucket's launch and finish run inside a ``hvd.<op>.bucket<k>`` range
(``profiler.annotate_collective``), :func:`segment_leaves` sets
``hvd_overlap_segments``, and each bucket plan notes its leaf layout on
the comms and memory observatories (:func:`note_leaf_layout`).

The threshold and the segment count read the autotuner's pins first
(``autotune.tuned_threshold``, ``tuned_segments``; reference :32, :52).
Each bucket's collective asks the comms planner for its schedule
(``comms_planner.dispatch_plan``, reference :282-320, :555, :607), which
answers None at once with ``HOROVOD_COMMS_PLANNER`` unset: the bucket
then launches the flat collective it launched before the planner.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import metrics
from ..profiler import annotate_collective
from ..utils import env
from .comms_planner import (_Done, apply_allgather_row,
                            apply_reducescatter_sum, dispatch_plan)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def fusion_threshold_bytes() -> int:
    """The pinned autotune threshold (``autotune.tuned_threshold``), else
    ``HOROVOD_FUSION_THRESHOLD`` (default 64 MiB)."""
    from ..autotune import tuned_threshold

    tuned = tuned_threshold()
    if tuned is not None:
        return tuned
    return env.get_int(env.FUSION_THRESHOLD, env.DEFAULT_FUSION_THRESHOLD)


def overlap_segments() -> int:
    """The pinned autotune segment count (``autotune.tuned_segments``),
    else ``HOROVOD_OVERLAP_SEGMENTS`` (default 4); at least 1: the number
    of contiguous leaf segments a step's parameters are split into."""
    from ..autotune import tuned_segments

    tuned = tuned_segments()
    if tuned is not None:
        return max(1, tuned)
    return max(1, env.get_int(env.OVERLAP_SEGMENTS, 4))


def fsdp_segments() -> int:
    """The fsdp mode's per-segment parameter gathers:
    ``HOROVOD_FSDP_SEGMENTS`` when positive, else :func:`overlap_segments`."""
    explicit = env.get_int(env.FSDP_SEGMENTS, 0)
    return explicit if explicit > 0 else overlap_segments()


def segment_leaves(leaves: Sequence[tuple[int, torch.dtype]],
                   num_segments: int) -> list[list[int]]:
    """Split leaf indices into at most ``num_segments`` contiguous runs of
    roughly equal bytes (each leaf goes to the segment of its byte
    midpoint). ``leaves`` are ``(numel, dtype)`` pairs; the map depends only
    on them, so every rank derives the same segments. Empty runs are
    dropped."""
    k = max(1, int(num_segments))
    sizes = [int(numel) * dtype.itemsize for numel, dtype in leaves]
    if not sizes:
        return []
    total = sum(sizes)
    if total <= 0 or k == 1:
        metrics.OVERLAP_SEGMENTS.set(1)
        return [list(range(len(sizes)))]
    segments: list[list[int]] = [[] for _ in range(k)]
    cum = 0
    for i, nbytes in enumerate(sizes):
        mid = cum + nbytes / 2.0
        segments[min(k - 1, int(mid * k / total))].append(i)
        cum += nbytes
    out = [seg for seg in segments if seg]
    metrics.OVERLAP_SEGMENTS.set(len(out))
    return out


def nonfinite_action() -> str | None:
    """The non-finite tripwire: ``HOROVOD_NONFINITE_ACTION`` = ``warn``
    (log and count), ``skip`` (drop the step's update on every rank) or
    ``abort`` (drop it and post the coordinated abort, so every rank
    enters the elastic ladder: ``integrity.note_nonfinite``). Unset or
    another value: None, and no check runs at all."""
    action = env.get_str(env.NONFINITE_ACTION).strip().lower()
    return action if action in ("warn", "skip", "abort") else None


def finite_flag(tensors: Sequence[torch.Tensor]) -> torch.Tensor | None:
    """A device bool scalar: every float tensor holds only finite values
    (one ``isfinite`` reduction per tensor; non-float ones are finite by
    definition). None when no tensor is a float."""
    flags = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    return torch.stack(flags).all() if flags else None


def all_finite(tensors: Sequence[torch.Tensor]) -> bool:
    """:func:`finite_flag` read on the host (one read)."""
    flag = finite_flag(tensors)
    return True if flag is None else bool(flag)


def psum_flag(flag: torch.Tensor | None, process_set) -> bool:
    """Make a per-rank finite flag identical on every rank: True only when
    every rank's flag is True, by one ``all_reduce`` of a float32 scalar
    (the sharded halves' reduced shards differ per rank; the allreduce
    path's buckets are already identical everywhere). Read on the host.
    None (no float tensor, alike on every rank) is True."""
    import torch.distributed as dist

    if flag is None:
        return True
    bad = (~flag).to(torch.float32).reshape(1)
    dist.all_reduce(bad, group=process_set.group)
    return bool(bad.item() == 0.0)


def bucket_leaves(leaves: Sequence[tuple[int, torch.dtype]],
                  threshold_bytes: int | None = None) -> list[list[int]]:
    """Group leaf indices into same-dtype buckets of <= threshold bytes.

    ``leaves`` are ``(numel, dtype)`` pairs. Order-preserving greedy
    packing; a leaf larger than the threshold gets its own bucket;
    threshold <= 0 disables fusion (one bucket per leaf).
    """
    if threshold_bytes is None:
        threshold_bytes = fusion_threshold_bytes()
    buckets: list[list[int]] = []
    bucket_dtype = None
    bucket_bytes = 0
    for i, (numel, dtype) in enumerate(leaves):
        nbytes = int(numel) * dtype.itemsize
        if (threshold_bytes <= 0 or not buckets or bucket_dtype != dtype
                or bucket_bytes + nbytes > threshold_bytes):
            buckets.append([i])
            bucket_dtype = dtype
            bucket_bytes = nbytes
        else:
            buckets[-1].append(i)
            bucket_bytes += nbytes
    return buckets


def note_leaf_layout(leaves: Sequence[tuple[int, torch.dtype]],
                     wire_dtypes: Sequence[torch.dtype] | None = None
                     ) -> None:
    """Note a bucket plan's leaf layout on the observatories, as the
    reference's fusion pass does (``horovod_tpu/ops/fusion.py:236-262``):
    the wire's ``[(nbytes, dtype)]`` on the comms model (the input of
    ``comms_model.predict_flush_cost``) and the parameters' ``[(numel,
    itemsize, dtype)]`` on the memory observatory (the autotune memory
    guard's). ``leaves`` are ``(numel, dtype)`` pairs, ``wire_dtypes``
    the dtype each crosses the wire in (default: its own). Called where a
    bucket plan is made (the optimizer's constructor, each grouped
    allreduce), never per step. Never raises."""
    try:
        wire_dtypes = list(wire_dtypes or [d for _, d in leaves])
        from .. import comms_model, memory

        comms_model.get_model().note_leaf_sizes([
            (int(m) * w.itemsize, memory.dtype_name(w))
            for (m, _), w in zip(leaves, wire_dtypes)])
        memory.get_observatory().note_layout([
            (int(m), d.itemsize, memory.dtype_name(d)) for m, d in leaves])
    except Exception:  # noqa: BLE001 — instrumentation is best-effort
        pass


def pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One new flat buffer holding the tensors back to back."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unpack(flat: torch.Tensor,
           shapes: Sequence[torch.Size]) -> list[torch.Tensor]:
    """Views of ``flat`` in the given shapes (inverse of :func:`pack`)."""
    out, offset = [], 0
    for shape in shapes:
        n = shape.numel()
        out.append(flat[offset:offset + n].view(shape))
        offset += n
    return out


def start_fused_allreduce(tensors: Sequence[torch.Tensor], op,
                          threshold_bytes: int | None = None,
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          issue_reversed: bool = False, process_set=None):
    """Launch :func:`fused_allreduce`'s buckets; return ``(works,
    finish)``: the collectives in flight, and the call that waits for them
    and returns the reduced tensors."""
    from .collective_ops import (_resolve_process_set, finish_allreduce,
                                 start_allreduce)

    ps = _resolve_process_set(process_set)
    leaves = [(t.numel(), t.dtype) for t in tensors]
    buckets = bucket_leaves(leaves, threshold_bytes)
    note_leaf_layout(leaves)
    order = list(reversed(buckets)) if issue_reversed else buckets
    launched = []
    for k, bucket in enumerate(order):
        with annotate_collective(f"allreduce.bucket{k}"):
            flat = pack([tensors[i].detach() for i in bucket])
            launched.append((bucket, flat, start_allreduce(
                flat, op, prescale_factor, ps.group,
                dispatch_plan("allreduce", _nbytes(flat), ps, op), ps)))

    def finish():
        out: list = [None] * len(tensors)
        for k, (bucket, flat, work) in enumerate(launched):
            with annotate_collective(f"allreduce.bucket{k}.finish"):
                finish_allreduce(flat, work, op, postscale_factor, ps)
            for i, piece in zip(
                    bucket, unpack(flat, [tensors[i].shape for i in bucket])):
                out[i] = piece
        return out

    return [work for _, _, work in launched], finish


def fused_allreduce(tensors: Sequence[torch.Tensor], op,
                    threshold_bytes: int | None = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    issue_reversed: bool = False,
                    process_set=None) -> list[torch.Tensor]:
    """Allreduce a list of tensors with bucketing; returns new tensors.

    Every bucket's collective is launched before the first is waited on.
    ``issue_reversed`` launches the buckets last-first (the order in which
    a backward pass produces gradients); results are the same either way.
    """
    return start_fused_allreduce(tensors, op, threshold_bytes,
                                 prescale_factor, postscale_factor,
                                 issue_reversed, process_set)[1]()


def shard_ownership(numels: Sequence[int], world_size: int) -> list[int]:
    """Per-leaf shard sizes: ``s = ceil(numel / n)`` (at least 1), rank r
    owning elements ``[r*s, (r+1)*s)`` of the leaf's flat view zero-padded
    to ``n*s``. A pure function of the sizes and the world size, per leaf
    (independent of the bucketing), so every rank derives the same map and
    an optimizer state sharded under one threshold stays valid under
    another."""
    n = max(1, int(world_size))
    return [max(1, -(-int(m) // n)) for m in numels]


def _pack_shard_rows(leaves: Sequence[torch.Tensor], shard_sizes,
                     world_size: int) -> torch.Tensor:
    """A new ``(n, R)`` tensor whose row r is the concatenation of rank r's
    owned slices of the leaves (one dtype): a reduce-scatter of its flat
    view hands each rank exactly its slices, contiguously."""
    n = int(world_size)
    rows = [torch.nn.functional.pad(t.reshape(-1),
                                    (0, n * s - t.numel())).view(n, s)
            for t, s in zip(leaves, shard_sizes)]
    return torch.cat(rows, dim=1)


def _split_shard_row(row: torch.Tensor, shard_sizes) -> list[torch.Tensor]:
    """Inverse of one row of :func:`_pack_shard_rows`: views of the per-leaf
    1-D shards."""
    out, offset = [], 0
    for s in shard_sizes:
        out.append(row[offset:offset + s])
        offset += s
    return out


def _issue_order(buckets, issue_reversed):
    order = list(enumerate(buckets))
    return list(reversed(order)) if issue_reversed else order


def start_shard_reducescatter(tensors: Sequence[torch.Tensor], shard_sizes,
                              prescale_factor: float, process_set):
    """Launch one bucket's reduce-scatter (a sum) over the set's group:
    returns ``(row, work)``, row the 1-D owned run this rank receives."""
    from .collective_ops import _TORCH_OPS, Sum, _reduce_scatter, _scale_

    n = process_set.size()
    flat = _pack_shard_rows([t.detach() for t in tensors], shard_sizes,
                            n).reshape(-1)
    _scale_(flat, prescale_factor)
    plan = dispatch_plan("reducescatter",
                         sum(_nbytes(t) for t in tensors), process_set)
    if plan is not None:
        return apply_reducescatter_sum(plan, flat, process_set), _Done()
    if flat.device.type == "cpu":
        import torch.distributed as dist

        # gloo's reduce-scatter work never reports completion, so an elastic
        # wait could not poll it (collective_ops.reducescatter): reduce the
        # whole row grid and keep this rank's row, the same values.
        work = dist.all_reduce(flat, op=_TORCH_OPS[Sum],
                               group=process_set.group, async_op=True)
        return flat.view(n, -1)[process_set.rank()], work
    row = flat.new_empty(flat.numel() // n)
    work = _reduce_scatter(row, flat, op=_TORCH_OPS[Sum],
                           group=process_set.group, async_op=True)
    return row, work


def finish_shard_reducescatter(row: torch.Tensor, work, op: str,
                               postscale_factor: float,
                               world_size: int) -> torch.Tensor:
    """Wait for a bucket's reduce-scatter and scale its row: for a float
    row one multiply by ``postscale / n`` for Average, ``postscale`` for
    Sum; an integer row rounds Average's ``1 / n`` and the postscale apart
    (``collective_ops._average_and_postscale_``)."""
    from .collective_ops import _average_and_postscale_, wait

    wait(work)
    _average_and_postscale_(row, op, postscale_factor, world_size)
    return row


def fused_reducescatter(tensors: Sequence[torch.Tensor], op,
                        threshold_bytes: int | None = None,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        issue_reversed: bool = False,
                        process_set=None) -> list[torch.Tensor]:
    """Reduce a tensor list across the set keeping only this rank's owned
    shard of each (:func:`shard_ownership`): one reduce-scatter per
    :func:`bucket_leaves` bucket over its ``(n, R)`` interleaved rows. Every
    bucket is launched before the first is waited on. Returns one 1-D shard
    per tensor. Sum and Average only."""
    from .collective_ops import Average, Sum, _resolve_process_set

    if op not in (Sum, Average):
        raise ValueError(
            f"fused_reducescatter supports Sum/Average, got {op!r}")
    ps = _resolve_process_set(process_set)
    n = ps.size()
    sizes = shard_ownership([t.numel() for t in tensors], n)
    buckets = bucket_leaves([(t.numel(), t.dtype) for t in tensors],
                            threshold_bytes)
    launched = []
    for k, bucket in _issue_order(buckets, issue_reversed):
        with annotate_collective(f"reducescatter.bucket{k}"):
            launched.append((k, bucket, start_shard_reducescatter(
                [tensors[i] for i in bucket], [sizes[i] for i in bucket],
                prescale_factor, ps)))
    out: list = [None] * len(tensors)
    for k, bucket, (row, work) in launched:
        with annotate_collective(f"reducescatter.bucket{k}.finish"):
            finish_shard_reducescatter(row, work, op, postscale_factor, n)
        for i, shard in zip(bucket, _split_shard_row(
                row, [sizes[i] for i in bucket])):
            out[i] = shard
    return out


def fused_allgather_shards(shards: Sequence[torch.Tensor],
                           templates: Sequence[torch.Tensor],
                           threshold_bytes: int | None = None,
                           issue_reversed: bool = False,
                           process_set=None) -> list[torch.Tensor]:
    """Inverse of :func:`fused_reducescatter`: every rank contributes its
    owned shards and receives the full tensors (the templates' shapes, the
    shards' dtype; callers cast). One allgather per bucket of
    ``bucket_leaves(templates)``, so the grouping comes from the same
    static facts on every rank. ``templates`` may be meta tensors."""
    return start_fused_allgather_shards(shards, templates, threshold_bytes,
                                        issue_reversed, process_set)[1]()


def start_fused_allgather_shards(shards: Sequence[torch.Tensor],
                                 templates: Sequence[torch.Tensor],
                                 threshold_bytes: int | None = None,
                                 issue_reversed: bool = False,
                                 process_set=None):
    """Launch :func:`fused_allgather_shards`' buckets; return ``(works,
    finish)``: the collectives in flight, and the call that waits for them
    and returns the full tensors."""
    from .collective_ops import _all_gather, _resolve_process_set, wait

    ps = _resolve_process_set(process_set)
    n = ps.size()
    sizes = shard_ownership([t.numel() for t in templates], n)
    buckets = bucket_leaves([(t.numel(), t.dtype) for t in templates],
                            threshold_bytes)
    launched = []
    for k, bucket in _issue_order(buckets, issue_reversed):
        with annotate_collective(f"allgather.bucket{k}"):
            row = torch.cat([shards[i].reshape(-1) for i in bucket])
            plan = dispatch_plan("allgather", n * _nbytes(row), ps)
            if plan is not None:
                launched.append((k, bucket, apply_allgather_row(
                    plan, row, ps), _Done()))
                continue
            full = row.new_empty(n * row.numel())
            launched.append((k, bucket, full, _all_gather(
                full, row, group=ps.group, async_op=True)))

    def finish() -> list[torch.Tensor]:
        out: list = [None] * len(templates)
        for k, bucket, full, work in launched:
            with annotate_collective(f"allgather.bucket{k}.finish"):
                wait(work)
            # Leaf i is column block i of the (n, R) grid of owned runs.
            grid, offset = full.view(n, -1), 0
            for i in bucket:
                t, s = templates[i], sizes[i]
                out[i] = grid[:, offset:offset + s].reshape(-1)[
                    :t.numel()].view(t.shape)
                offset += s
        return out

    return [work for _, _, _, work in launched], finish
