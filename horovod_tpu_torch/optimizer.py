"""DistributedOptimizer: wrap a ``torch.optim.Optimizer`` so gradients
arrive averaged across the process set.

Port of ``horovod_tpu/optimizer.py`` in allreduce mode: the semantics of
``DistributedOptimizer`` (:798) and ``_reduce_grads`` (:105) -- compress,
fused allreduce, decompress -- with ``op``, pre- and post-scale,
``backward_passes_per_step``, the fusion threshold and ``num_groups``
(:183-187), a process set, and the non-finite tripwire of
``_tripwire_flag`` (:43) and ``_tripwire_guard`` (:65). The mechanism is
the reference Horovod's, as ``horovod_tpu/torch/__init__.py:798`` has it:
a ``register_post_accumulate_grad_hook`` on each parameter counts its
backward passes; once every parameter of a bucket has its gradient for
the step, the bucket's compressed gradients are packed and its
``async_op=True`` allreduce is launched while the rest of the backward
runs; ``step()`` launches what is left, waits, unpacks into ``.grad`` and
runs the wrapped optimizer.

Buckets are ``fusion.bucket_leaves`` over the parameters in
``param_groups`` order and are launched last bucket first (the order a
backward pass completes them), always in that fixed order, so every rank
issues the same collectives in the same order.

The tripwire (``HOROVOD_NONFINITE_ACTION``, read when the optimizer is
built) checks the reduced gradients before the wrapped optimizer steps:
one ``isfinite`` reduction per bucket and one host read. The reduced
buckets are the same on every rank, so every rank decides alike with no
extra collective. ``warn`` logs and counts (``nonfinite_steps``) and
steps; ``skip`` also leaves the parameters and the wrapped optimizer's
state as they were; ``abort`` raises ``HorovodInternalError`` on every
rank. Unset, nothing is checked and the step launches what it did
without it.
"""

from __future__ import annotations

import torch

from .compression import Compression
from .exceptions import HorovodInternalError
from .ops.collective_ops import (Average, Sum, _resolve_op,
                                 _resolve_process_set, finish_allreduce,
                                 start_allreduce)
from .ops.fusion import (all_finite, bucket_leaves, nonfinite_action, pack,
                         unpack)
from .utils import env
from .utils.logging import get_logger

_VALID_SYNC_MODES = ("allreduce", "sharded", "fsdp")


def resolve_sync_mode(sync_mode: str | None = None) -> str:
    """Explicit argument > ``HOROVOD_SYNC_MODE`` > ``"allreduce"``.

    Only allreduce is ported; ``sharded`` and ``fsdp`` raise.
    """
    if sync_mode is None:
        sync_mode = env.get_str(env.SYNC_MODE).strip().lower() or "allreduce"
    if sync_mode not in _VALID_SYNC_MODES:
        raise ValueError(
            f"unknown sync_mode {sync_mode!r}; expected one of "
            f"{_VALID_SYNC_MODES}")
    if sync_mode != "allreduce":
        raise NotImplementedError(
            f"sync_mode={sync_mode!r} is not yet ported to "
            "horovod_tpu_torch; use sync_mode='allreduce'")
    return sync_mode


class _DistributedOptimizer:
    """Delegating wrapper around a ``torch.optim.Optimizer``: everything
    not overridden here (``zero_grad``, ``state_dict``, ``param_groups``,
    ...) goes to the wrapped optimizer."""

    def __init__(self, optimizer, op, compression, backward_passes_per_step,
                 prescale_factor, postscale_factor, process_set, num_groups,
                 fusion_threshold_bytes):
        self._opt = optimizer
        self._op = op
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._prescale = prescale_factor
        self._postscale = postscale_factor
        self._ps = process_set
        seen: set[int] = set()
        self._params: list[torch.Tensor] = []
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and id(p) not in seen:
                    seen.add(id(p))
                    self._params.append(p)
        # A one-member set reduces to the identity: skip the wire and apply
        # only the scale factors (optimizer.py:133-146), unless
        # HOROVOD_FORCE_WIRE_MACHINERY=1 asks for the full path.
        self._short_circuit = (
            process_set.size() == 1
            and env.get_str(env.FORCE_WIRE_MACHINERY) != "1"
            and op in (Average, Sum))
        wire_dtypes = [
            compression.compress(
                torch.empty(0, dtype=p.dtype, device=p.device))[0].dtype
            for p in self._params]
        if num_groups > 0:
            # The reference's num_groups: cap each bucket at total /
            # num_groups bytes of the wire.
            total = sum(p.numel() * d.itemsize
                        for p, d in zip(self._params, wire_dtypes))
            fusion_threshold_bytes = max(1, total // num_groups)
        self._buckets = [
            [self._params[i] for i in b]
            for b in bucket_leaves(
                [(p.numel(), d) for p, d in zip(self._params, wire_dtypes)],
                fusion_threshold_bytes)]
        self._bucket_of = {id(p): bi for bi, b in enumerate(self._buckets)
                           for p in b}
        self._hooks = []
        if not self._short_circuit:
            self._hooks = [p.register_post_accumulate_grad_hook(self._on_grad)
                           for p in self._params]
        self._nonfinite_action = nonfinite_action()
        self.nonfinite_steps = 0  # steps whose reduced gradients were not finite
        self._reset()

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def _reset(self) -> None:
        self._passes: dict[int, int] = {}
        self._ready = [0] * len(self._buckets)
        self._launched: dict[int, tuple] = {}
        self._next = len(self._buckets) - 1  # launch order: last bucket first

    def _on_grad(self, p: torch.Tensor) -> None:
        n = self._passes.get(id(p), 0) + 1
        if n > self.backward_passes_per_step:
            raise RuntimeError(
                f"a gradient was produced more than backward_passes_per_step="
                f"{self.backward_passes_per_step} time(s) before step(); "
                "increase backward_passes_per_step to accumulate locally")
        self._passes[id(p)] = n
        if n == self.backward_passes_per_step:
            bi = self._bucket_of[id(p)]
            self._ready[bi] += 1
            while (self._next >= 0 and self._ready[self._next]
                   == len(self._buckets[self._next])):
                self._launch(self._next)
                self._next -= 1

    def _launch(self, bi: int) -> None:
        k = self.backward_passes_per_step
        wires, ctxs = [], []
        for p in self._buckets[bi]:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if k > 1:
                # The mean over microbatches, taken before the wire cast so
                # an fp16 wire keeps its headroom.
                g = g / k
            wire, ctx = self._compression.compress(g)
            wires.append(wire)
            ctxs.append(ctx)
        flat = pack(wires)
        work = start_allreduce(flat, self._op, self._prescale, self._ps.group)
        self._launched[bi] = (flat, work, ctxs)

    def synchronize(self) -> list[torch.Tensor]:
        """Launch the buckets not launched yet, wait for all, and write the
        reduced gradients into ``.grad``; return the reduced buckets."""
        while self._next >= 0:
            self._launch(self._next)
            self._next -= 1
        reduced = []
        for bi in sorted(self._launched, reverse=True):
            flat, work, ctxs = self._launched[bi]
            reduced.append(finish_allreduce(flat, work, self._op,
                                            self._postscale, self._ps))
            params = self._buckets[bi]
            for p, piece, ctx in zip(params,
                                     unpack(flat, [p.shape for p in params]),
                                     ctxs):
                g = self._compression.decompress(piece, ctx)
                if p.grad is None:
                    p.grad = g.clone()
                else:
                    p.grad.copy_(g)
        self._reset()
        return reduced

    def _scale_local(self) -> None:
        k = self.backward_passes_per_step
        scale = self._prescale * self._postscale
        for p in self._params:
            if p.grad is None:
                continue
            if k > 1:
                p.grad.div_(k)
            if scale != 1.0:
                p.grad.mul_(torch.tensor(scale, dtype=p.grad.dtype,
                                         device=p.grad.device))

    def step(self, closure=None):
        if self._short_circuit:
            self._scale_local()
            reduced = [p.grad for p in self._params if p.grad is not None]
        else:
            reduced = self.synchronize()
        if self._nonfinite_action is not None and not all_finite(reduced):
            self.nonfinite_steps += 1
            action = self._nonfinite_action
            get_logger().warning(
                "non-finite reduced gradients (HOROVOD_NONFINITE_ACTION=%s, "
                "detection #%d)", action, self.nonfinite_steps)
            if action == "abort":
                raise HorovodInternalError(
                    "non-finite reduced gradients with "
                    "HOROVOD_NONFINITE_ACTION=abort")
            if action == "skip":
                return None
        return self._opt.step(closure)

    def remove_hooks(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


def DistributedOptimizer(optimizer, named_parameters=None,
                         op: str = Average,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0,
                         process_set=None,
                         num_groups: int = 0,
                         fusion_threshold_bytes: int | None = None,
                         sync_mode: str | None = None):
    """Wrap ``optimizer`` so ``step()`` applies gradients reduced across
    the process set (allreduce mode).

    With ``backward_passes_per_step=k`` the caller runs k backward passes
    (gradients accumulate in ``.grad``) and then ``step()``: the reduced
    gradient is the mean over the k microbatches. ``num_groups > 0`` caps
    each bucket at 1/num_groups of the wire's bytes, in place of the
    fusion threshold. With a ``process_set`` the buckets reduce over that
    set's group, and only its members build the optimizer and step.
    ``named_parameters`` exists for signature parity and is unused:
    collectives are matched by their fixed issue order. ``init()`` must
    have run.
    """
    del named_parameters
    resolve_sync_mode(sync_mode)
    op = _resolve_op(op, None)
    k = int(backward_passes_per_step)
    if k < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if num_groups < 0:
        raise ValueError(f"num_groups must be >= 0; got {num_groups}")
    ps = _resolve_process_set(process_set)
    return _DistributedOptimizer(optimizer, op, compression, k,
                                 prescale_factor, postscale_factor, ps,
                                 int(num_groups), fusion_threshold_bytes)

