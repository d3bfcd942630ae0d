"""Tensor fusion: bucketed allreduce of many small tensors, and the
non-finite tripwire over the reduced buckets.

Port of ``horovod_tpu/ops/fusion.py``: ``fusion_threshold_bytes`` (:28),
``nonfinite_action`` (:123), ``all_finite`` (:136), ``bucket_leaves``
(:206) and ``fused_allreduce`` (:320). Each collective has a fixed launch
cost, so tensors are packed in order into same-dtype buckets of at most
``HOROVOD_FUSION_THRESHOLD`` bytes, reduced with one collective per bucket,
and unpacked.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils import env


def fusion_threshold_bytes() -> int:
    """``HOROVOD_FUSION_THRESHOLD`` (default 64 MiB)."""
    return env.get_int(env.FUSION_THRESHOLD, env.DEFAULT_FUSION_THRESHOLD)


def nonfinite_action() -> str | None:
    """The non-finite tripwire: ``HOROVOD_NONFINITE_ACTION`` = ``warn``
    (log and count), ``skip`` (drop the step's update on every rank) or
    ``abort`` (raise ``HorovodInternalError`` on every rank). Unset or
    another value: None, and no check runs at all."""
    action = env.get_str(env.NONFINITE_ACTION).strip().lower()
    return action if action in ("warn", "skip", "abort") else None


def all_finite(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether every float tensor holds only finite values (non-float ones
    are finite by definition): one ``isfinite`` reduction per tensor on its
    device, and one read on the host."""
    flags = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True


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
    buckets = bucket_leaves([(t.numel(), t.dtype) for t in tensors],
                            threshold_bytes)
    order = list(reversed(buckets)) if issue_reversed else buckets
    launched = []
    for bucket in order:
        flat = pack([tensors[i].detach() for i in bucket])
        launched.append((bucket, flat,
                         start_allreduce(flat, op, prescale_factor,
                                         ps.group)))

    def finish():
        out: list = [None] * len(tensors)
        for bucket, flat, work in launched:
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
