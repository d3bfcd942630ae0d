"""Adasum: scaling-invariant gradient combination, on torch tensors.

Port of ``horovod_tpu/ops/adasum.py`` (``adasum_pair`` :30,
``adasum_tree`` :44, ``adasum_reduce`` :58) and of the control flow of
``horovod_tpu/process_world.py:290 pairwise_tree``. The pairwise rule for
two gradients a, b:

    adasum(a, b) = (1 - a.b / (2 a.a)) a  +  (1 - a.b / (2 b.b)) b

each side shrunk by half its projection onto the other. Reduction over N
ranks applies the rule along a binary tree; odd leftovers carry to the next
round.

``adasum_reduce`` is the reference torch surface's per-process form
(``horovod_tpu/process_world.py:309 adasum_allreduce_host``) moved from the
host onto the device: every member gathers each member's tensor over the
set's group (NCCL on the card, gloo on the CPU) and runs the tree locally
in set-rank order, so every member computes the same result, bit for bit.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def pairwise_tree(parts: Sequence, pair: Callable):
    """Binary-tree reduction of a list by ``pair`` (odd leftovers carry to
    the next round, the reference's non-power-of-two handling)."""
    parts = list(parts)
    while len(parts) > 1:
        nxt = [pair(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2 == 1:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two same-shaped gradient tensors by the Adasum rule: dot
    products in float32 over the flattened tensors, the result in ``a``'s
    dtype. Zero norms are guarded: adasum(0, b) = b, adasum(a, 0) = a."""
    af = a.reshape(-1).float()
    bf = b.reshape(-1).float()
    dot = torch.dot(af, bf)
    asq = torch.dot(af, af)
    bsq = torch.dot(bf, bf)
    a_scale = torch.where(asq > 0, 1.0 - dot / (2.0 * asq.clamp_min(1e-30)),
                          0.0)
    b_scale = torch.where(bsq > 0, 1.0 - dot / (2.0 * bsq.clamp_min(1e-30)),
                          0.0)
    out = a_scale * af + b_scale * bf
    return out.reshape(a.shape).to(a.dtype)


def adasum_tree(stack) -> torch.Tensor:
    """Reduce a stacked ``(N, ...)`` tensor (or a sequence of N tensors) of
    per-rank tensors pairwise, in index order."""
    return pairwise_tree([stack[i] for i in range(len(stack))], adasum_pair)


def gather_rows(flat: torch.Tensor, process_set):
    """Launch the gather of this member's 1-D ``flat`` from every member
    of ``process_set``: returns ``(rows, work)``, ``rows`` the
    ``(members, numel)`` tensor in set-rank order once ``work`` is
    waited on."""
    from .collective_ops import _all_gather

    n = process_set.size()
    out = flat.new_empty(n * flat.numel())
    work = _all_gather(out, flat, group=process_set.group, async_op=True)
    return out.view(n, flat.numel()), work


def adasum_reduce(t: torch.Tensor, process_set) -> torch.Tensor:
    """Adasum-allreduce ``t`` over the members of ``process_set``: one
    gather, then :func:`adasum_tree` over the members' tensors in set-rank
    order. A new tensor of ``t``'s shape and dtype; the same on every
    member."""
    from .collective_ops import wait

    rows, work = gather_rows(t.detach().reshape(-1).contiguous(),
                             process_set)
    wait(work)
    return adasum_tree(rows).view(t.shape)
