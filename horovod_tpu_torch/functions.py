"""State-sync helpers: push rank-root's state to every rank at (re)start,
gather objects, and average over the ranks that have data.

Port of ``horovod_tpu/functions.py``: ``broadcast_parameters`` (:30),
``broadcast_optimizer_state`` (:46), ``broadcast_object`` (:52),
``allgather_object`` (:99), ``join`` (:153) and ``masked_average`` (:180).
One-process worlds return at once from the broadcasts and from ``join``,
as in the JAX package.
"""

from __future__ import annotations

import pickle
from typing import Any

import torch
import torch.distributed as dist

from . import basics
from .ops.collective_ops import Sum, _resolve_process_set, allgather, allreduce


def _check_root(root_rank: int) -> None:
    n = basics.size()
    if not 0 <= root_rank < n:
        raise ValueError(
            f"root_rank {root_rank} out of range; expected one of "
            f"{list(range(n))}")


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Overwrite every rank's tensors, in place, with ``root_rank``'s.

    ``params``: a ``state_dict()``, ``named_parameters()`` or an iterable
    of tensors. A sharded optimizer's deferred parameter allgather in
    flight finishes first.
    """
    from .optimizer import wait_deferred_gathers

    _check_root(root_rank)
    wait_deferred_gathers()
    if basics.size() == 1:
        return
    items = params.values() if hasattr(params, "values") else params
    with torch.no_grad():
        for item in items:
            t = item[1] if isinstance(item, tuple) else item
            if torch.is_tensor(t):
                dist.broadcast(t.detach(), src=root_rank)


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: str | None = None) -> Any:
    """Broadcast a picklable object from ``root_rank`` to every rank."""
    del name
    _check_root(root_rank)
    if basics.size() == 1:
        return obj
    box = [obj if basics.rank() == root_rank else None]
    dist.broadcast_object_list(box, src=root_rank)
    return box[0]


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Load ``root_rank``'s full optimizer state on every rank (also right
    when the state is still empty before the first step)."""
    _check_root(root_rank)
    if basics.size() == 1:
        return
    optimizer.load_state_dict(
        broadcast_object(optimizer.state_dict(), root_rank))


def allgather_object(obj: Any, process_set=None,
                     name: str | None = None) -> list:
    """One picklable object per rank of the set, gathered into a list in
    set-rank order on every member: each rank's pickle is a byte tensor
    through the ragged :func:`allgather`, beside an allgather of the
    pickles' sizes."""
    del name
    ps = _resolve_process_set(process_set)
    dev = basics.device()
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8).to(dev)
    sizes = allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                   device=dev), process_set=ps).tolist()
    data = allgather(payload, process_set=ps).cpu()
    out, offset = [], 0
    for n in sizes:
        out.append(pickle.loads(data[offset:offset + n].numpy().tobytes()))
        offset += n
    return out


def join(timeout_s: float = 600.0) -> int:
    """Uneven-data termination: call when this rank has run out of data.

    In a world of more than one rank it blocks until every rank has
    joined, and meanwhile this rank serves its peers' negotiated
    allreduces with zeros (Average divides by the ranks that contributed;
    a subset gather or broadcast with a joined member raises). Returns the
    last rank to join. Outstanding async collectives must be synchronized
    first. At one rank it returns ``size() - 1`` at once. Parity:
    ``hvd.join()`` (the reference's JoinOp, through the negotiated
    runtime's controller).
    """
    world = basics._state.require_init().negotiated
    if world is None:
        return basics.size() - 1
    return world.join(timeout_s)


def masked_average(value, mask, process_set=None):
    """Mean of ``value`` over the ranks whose ``mask`` is nonzero:
    ``allreduce(value * mask, Sum) / max(allreduce(mask, Sum), 1)``.

    The per-process form of the reference's traced idiom: a rank that has
    run out of data passes ``mask=0`` and contributes nothing. ``value``
    is a tensor or a list, tuple or dict of tensors; each leaf keeps its
    dtype. The count sums in float32 (exact to 2^24 ranks), each leaf in
    float32 (float64 for float64 leaves), as the reference does.
    """
    ps = _resolve_process_set(process_set)
    mask = torch.as_tensor(mask, device=basics.device())
    count = allreduce(mask.to(torch.float32), op=Sum, process_set=ps)
    safe = torch.clamp(count, min=1.0)

    def one(v):
        acc = torch.float64 if v.dtype == torch.float64 else torch.float32
        num = allreduce((v * mask.to(v.dtype)).to(acc), op=Sum,
                        process_set=ps)
        return (num / safe.to(acc)).to(v.dtype)

    if isinstance(value, dict):
        return {k: one(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(one(v) for v in value)
    return one(value)
