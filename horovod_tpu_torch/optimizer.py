"""DistributedOptimizer: wrap a ``torch.optim.Optimizer`` so gradients
arrive averaged across the process set.

Port of ``horovod_tpu/optimizer.py`` in allreduce mode: the semantics of
``DistributedOptimizer`` (:798) and ``_reduce_grads`` (:105) -- compress,
fused allreduce, decompress -- with ``op`` (Adasum included), pre- and
post-scale,
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

``op=Adasum`` computes its dot products per tensor, never per bucket
(``horovod_tpu/ops/fusion.py:349-355``), but gathers per bucket: a
bucket's packed wire is gathered from every member with one
``all_gather_into_tensor`` launched from the hooks, and ``step()`` runs
``ops.adasum.adasum_tree`` on each leaf's view of the gathered rows. The
numbers are those of one gather per tensor, with one launch per bucket.

``Compression.int8`` changes the exchange itself (``_reduce_grads``
:148-180): the gradients go through ``ops.quantization`` in ``step()``,
salted by a count of updates as ``_SaltState`` (:518) counts them.

The sharded (ZeRO-1) and fsdp (ZeRO-3) sync modes (``sync_mode=`` or
``HOROVOD_SYNC_MODE``; guard table :856-905) keep each rank's optimizer
state for its own shard of every parameter only (rank r owns
``[r*s, (r+1)*s)`` of each parameter's zero-padded flat view, ``s =
ceil(numel/n)``, ``fusion.shard_ownership``): the wrapped optimizer is
rebuilt over per-rank flat shard ``Parameter``s, one shard group per
param group with the same hyperparameters. Sharded (``sharded_step_update``
:731): each bucket's reduce-scatter is launched from the gradient hooks
during backward, the wrapped optimizer steps on the owned shard, and one
allgather per bucket writes the updated parameters back. fsdp: the
parameters themselves live as shards (``parallel/param_sharding.py``);
``make_train_step``'s forward gathers each segment as it first reads it
and releases it after, the backward gathers it again where autograd saved
it and reduce-scatters its gradients into the shard domain, and the update
writes back to the resident shard with no trailing allgather.

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

import weakref

import torch

from . import abort, basics
from .compression import Compression
from .exceptions import HorovodInternalError, SyncModeIneligibleError
from .ops import fusion
from .ops.adasum import adasum_tree, gather_rows
from .ops.collective_ops import (Adasum, Average, Sum, _resolve_op,
                                 _resolve_process_set, _scale_,
                                 elastic_errors, finish_allreduce, guarded,
                                 start_allreduce, wait)
from .ops.fusion import (all_finite, bucket_leaves, nonfinite_action, pack,
                         unpack)
from .utils import env
from .utils.logging import get_logger

_VALID_SYNC_MODES = ("allreduce", "sharded", "fsdp")


def resolve_sync_mode(sync_mode: str | None = None) -> str:
    """Explicit argument > ``HOROVOD_SYNC_MODE`` > ``"allreduce"``; one
    of ``allreduce``, ``sharded`` and ``fsdp``."""
    if sync_mode is None:
        sync_mode = env.get_str(env.SYNC_MODE).strip().lower() or "allreduce"
    if sync_mode not in _VALID_SYNC_MODES:
        raise ValueError(
            f"unknown sync_mode {sync_mode!r}; expected one of "
            f"{_VALID_SYNC_MODES}")
    return sync_mode


def _is_int8(compression) -> bool:
    return getattr(compression, "marker", None) == "int8"


def _rebuild_over(optimizer, groups):
    """A new optimizer of ``optimizer``'s class over ``groups`` (dicts with
    ``params`` and the hyperparameters), with its defaults and no state."""
    new = type(optimizer).__new__(type(optimizer))
    torch.optim.Optimizer.__init__(new, groups, dict(optimizer.defaults))
    return new


def _own_slice(t: torch.Tensor, s: int, n: int, r: int) -> torch.Tensor:
    """Rank r's owned slice ``[r*s, (r+1)*s)`` of ``t``'s flat view
    zero-padded to ``n*s`` (a new tensor)."""
    flat = t.detach().reshape(-1)
    out = flat.new_zeros(s)
    hi = min((r + 1) * s, flat.numel())
    if hi > r * s:
        out[:hi - r * s] = flat[r * s:hi]
    return out


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
        self._num_groups = num_groups
        seen: set[int] = set()
        self._params: list[torch.Tensor] = []
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and id(p) not in seen:
                    seen.add(id(p))
                    self._params.append(p)
        self._index = {id(p): i for i, p in enumerate(self._params)}
        self._base_threshold = fusion_threshold_bytes
        self._int8 = _is_int8(compression)
        # Updates so far: the int8 wire's rounding salt.
        self._updates = 0
        # The int8 exchange buckets the float32 view of the gradients.
        wire_dtypes = [
            torch.float32 if self._int8 else compression.compress(
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
        self._threshold = fusion_threshold_bytes
        self._hooks = []
        self._detached = False  # remove_hooks() was called
        self._read_world()
        self._nonfinite_action = nonfinite_action()
        self.nonfinite_steps = 0  # steps whose reduced gradients were not finite
        self._reset()
        _live.add(self)

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def _skips_wire(self) -> bool:
        """A one-member set reduces to the identity: skip the wire and
        apply only the scale factors (optimizer.py:133-146), unless
        HOROVOD_FORCE_WIRE_MACHINERY=1 asks for the full path."""
        return (self._ps.size() == 1
                and env.get_str(env.FORCE_WIRE_MACHINERY) != "1"
                and self._op in (Average, Sum, Adasum))

    def _read_world(self) -> None:
        """Read what the world decides, once per world: at construction
        and at every later ``init()`` (an elastic world may re-form at
        another size). On the wire the buckets launch from the gradient
        hooks during backward; the int8 exchange runs whole in step(): it
        has a local sum between its two collectives."""
        self._elastic = basics.elastic()
        self._short_circuit = self._skips_wire()
        if self._short_circuit or self._int8:
            self._unhook()
        elif not (self._hooks or self._detached):
            self._hooks = [p.register_post_accumulate_grad_hook(self._on_grad)
                           for p in self._params]

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
                if self._elastic:
                    abort.raise_if_aborted()
                    with elastic_errors():
                        self._launch(self._next)
                else:
                    self._launch(self._next)
                self._next -= 1

    def _launch(self, bi: int) -> None:
        if self._ps.process_set_id < 0:
            raise ValueError(
                f"the optimizer's process set {self._ps.ranks} is not "
                "registered (removed, or the world was re-formed): build the "
                "optimizer again over a registered set")
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
        if self._op == Adasum:
            _scale_(flat, self._prescale)
            rows, work = gather_rows(flat, self._ps)
            self._launched[bi] = (rows, work, ctxs)
            return
        work = start_allreduce(flat, self._op, self._prescale, self._ps.group)
        self._launched[bi] = (flat, work, ctxs)

    def _adasum_leaves(self, rows, work, shapes) -> list[torch.Tensor]:
        """A gathered bucket's leaves, each the Adasum tree over its view in
        every member's row, postscaled."""
        wait(work)
        leaves = []
        for views in zip(*(unpack(row, shapes) for row in rows)):
            leaf = adasum_tree(views)
            _scale_(leaf, self._postscale)
            leaves.append(leaf)
        return leaves

    def _local_grads(self) -> list[torch.Tensor]:
        """Each parameter's gradient (zeros where none), averaged over the
        ``backward_passes_per_step`` microbatches."""
        k = self.backward_passes_per_step
        grads = []
        for p in self._params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads.append(g / k if k > 1 else g)
        return grads

    def _salt(self) -> int:
        """The int8 rounding salt of this update: the count of updates
        before it (one more with accumulation, as the reference salts with
        the microstep count over k)."""
        return self._updates + (1 if self.backward_passes_per_step > 1 else 0)

    def _int8_synchronize(self) -> list[torch.Tensor]:
        from .ops.quantization import int8_fused_allreduce

        reduced = int8_fused_allreduce(
            self._local_grads(), self._ps, self._op, self._threshold,
            self._prescale, self._postscale, salt=self._salt())
        for p, g in zip(self._params, reduced):
            if p.grad is None:
                p.grad = g
            else:
                p.grad.copy_(g)
        self._reset()
        return reduced

    @guarded
    def synchronize(self) -> list[torch.Tensor]:
        """Launch the buckets not launched yet, wait for all, and write the
        reduced gradients into ``.grad``; return the reduced buckets."""
        if self._int8:
            return self._int8_synchronize()
        while self._next >= 0:
            self._launch(self._next)
            self._next -= 1
        reduced = []
        for bi in sorted(self._launched, reverse=True):
            flat, work, ctxs = self._launched[bi]
            params = self._buckets[bi]
            shapes = [p.shape for p in params]
            if self._op == Adasum:
                pieces = self._adasum_leaves(flat, work, shapes)
                reduced.extend(pieces)
            else:
                reduced.append(finish_allreduce(flat, work, self._op,
                                                self._postscale, self._ps))
                pieces = unpack(flat, shapes)
            for p, piece, ctx in zip(params, pieces, ctxs):
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

    @guarded
    def step(self, closure=None):
        if self._short_circuit:
            self._scale_local()
            reduced = [p.grad for p in self._params if p.grad is not None]
        else:
            reduced = self.synchronize()
        self._updates += 1
        if (self._nonfinite_action is not None
                and not self._tripwire(all_finite(reduced))):
            return None
        return self._opt.step(closure)

    def _tripwire(self, finite: bool) -> bool:
        """Count, log, and raise or report what the step should do: False
        when it is to be skipped."""
        if finite:
            return True
        self.nonfinite_steps += 1
        action = self._nonfinite_action
        get_logger().warning(
            "non-finite reduced gradients (HOROVOD_NONFINITE_ACTION=%s, "
            "detection #%d)", action, self.nonfinite_steps)
        if action == "abort":
            raise HorovodInternalError(
                "non-finite reduced gradients with "
                "HOROVOD_NONFINITE_ACTION=abort")
        return action != "skip"

    def remove_hooks(self) -> None:
        """Detach the optimizer from the model's gradients for good: no
        later world hooks it again."""
        self._detached = True
        self._unhook()

    def _unhook(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


# The allreduce-mode optimizers alive: a re-formed world drops their
# buckets and in-flight work, which belong to the group it replaced, and
# each reads the new world.
_live: "weakref.WeakSet[_DistributedOptimizer]" = weakref.WeakSet()


def _drop_in_flight() -> None:
    for opt in list(_live):
        opt._reset()


def _read_worlds() -> None:
    for opt in list(_live):
        opt._read_world()


basics.on_shutdown(_drop_in_flight)
basics.on_init(_read_worlds)


class _ShardedOptimizer(_DistributedOptimizer):
    """``sync_mode="sharded"`` (ZeRO-1): full parameters on every rank,
    optimizer state for this rank's shards only. The buckets are the
    allreduce mode's; each one's reduce-scatter is launched from the
    gradient hooks during backward (int8: in ``step()``), the wrapped
    optimizer (rebuilt over the shards) steps on the owned shards, and one
    allgather per bucket of the parameters writes the updated parameters
    back into them."""

    def __init__(self, optimizer, op, compression, prescale_factor,
                 postscale_factor, process_set, num_groups,
                 fusion_threshold_bytes):
        super().__init__(optimizer, op, compression, 1, prescale_factor,
                         postscale_factor, process_set, num_groups,
                         fusion_threshold_bytes)
        # Each param group's parameters, by index (a parameter in two
        # groups counts in the first).
        seen: set[int] = set()
        self._groups: list[list[int]] = []
        for group in optimizer.param_groups:
            idx = [self._index[id(p)] for p in group["params"]
                   if id(p) in self._index and id(p) not in seen]
            seen.update(id(p) for p in group["params"])
            self._groups.append(idx)
        self._own_shards(optimizer)
        # Bucket caps: the reduce-scatter's over the leaves (int8: in their
        # own dtype, as the reference sizes its float32 exchange), the
        # allgather's over the parameters.
        self._rs_threshold = (self._capped([(p.numel(), p.dtype)
                                            for p in self._params])
                              if self._int8 else self._threshold)
        self._ag_threshold = self._capped([(p.numel(), p.dtype)
                                           for p in self._params])

    def _skips_wire(self) -> bool:
        # The sharded wire runs at every size, as the reference's does.
        return False

    def _own_shards(self, like) -> None:
        """Own this rank's shards in the process set's current world, with
        a new wrapped optimizer of ``like``'s class over them (the
        hyperparameters of ``like``'s groups, no state)."""
        n, r = self._ps.size(), self._ps.rank()
        self._n, self._r = n, r
        self._sizes = fusion.shard_ownership(
            [p.numel() for p in self._params], n)
        self._shards = [torch.nn.Parameter(_own_slice(p, s, n, r))
                        for p, s in zip(self._params, self._sizes)]
        self._opt = _rebuild_over(like, [
            {**{k: v for k, v in g.items() if k != "params"},
             "params": [self._shards[i] for i in idx]}
            for g, idx in zip(like.param_groups, self._groups)])

    def _reform(self) -> None:
        """Re-own the shards for the world the process set has now (an
        elastic world re-formed at another size), with empty state:
        ``load_sharded_state`` fills it. The parameters stay as they
        are."""
        self._reset()
        self._own_shards(self._opt)

    def _capped(self, leaves):
        if self._num_groups > 0:
            total = sum(m * d.itemsize for m, d in leaves)
            return max(1, total // self._num_groups)
        return self._base_threshold

    def _launch(self, bi: int) -> None:
        wires, ctxs = [], []
        for p in self._buckets[bi]:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            wire, ctx = self._compression.compress(g)
            wires.append(wire)
            ctxs.append(ctx)
        sizes = [self._sizes[self._index[id(p)]] for p in self._buckets[bi]]
        self._launched[bi] = (fusion.start_shard_reducescatter(
            wires, sizes, self._prescale, self._ps), ctxs)

    def _grad_shards(self) -> list[torch.Tensor]:
        """This rank's reduced gradient shard of every parameter."""
        if self._int8:
            from .ops.quantization import int8_fused_reducescatter

            shards = int8_fused_reducescatter(
                self._local_grads(), self._ps, self._op, self._rs_threshold,
                self._prescale, self._postscale, salt=self._updates)
            return [s.to(p.dtype) for s, p in zip(shards, self._params)]
        while self._next >= 0:
            self._launch(self._next)
            self._next -= 1
        out: list = [None] * len(self._params)
        for bi in sorted(self._launched, reverse=True):
            (row, work), ctxs = self._launched[bi]
            fusion.finish_shard_reducescatter(row, work, self._op,
                                              self._postscale, self._n)
            params = self._buckets[bi]
            sizes = [self._sizes[self._index[id(p)]] for p in params]
            for p, piece, ctx in zip(
                    params, fusion._split_shard_row(row, sizes), ctxs):
                out[self._index[id(p)]] = self._compression.decompress(
                    piece, ctx)
        return out

    def synchronize(self):
        """Finish the reduce-scatters; return the gradient shards."""
        shards = self._grad_shards()
        self._reset()
        return shards

    def step(self, closure=None):
        del closure
        grads = self.synchronize()
        salt = self._updates
        self._updates += 1
        if self._nonfinite_action is not None and not self._tripwire(
                fusion.psum_flag(fusion.finite_flag(grads), self._ps)):
            return None
        with torch.no_grad():
            for p, shard, g, s in zip(self._params, self._shards, grads,
                                      self._sizes):
                # The shard is taken from the parameter each step, so writes
                # to the parameters between steps (a broadcast) are seen.
                shard.copy_(_own_slice(p, s, self._n, self._r))
                shard.grad = g.to(shard.dtype).reshape(shard.shape)
        self._opt.step()
        with torch.no_grad():
            for p, full in zip(self._params, self._gather(salt)):
                p.copy_(full)
        return None

    def _gather(self, salt) -> list[torch.Tensor]:
        """The updated parameters from every rank's shards, through the
        wire (a cast wire gathers in its dtype; int8 the quantized
        allgather)."""
        templates = [p.detach() for p in self._params]
        if self._int8:
            from .ops.quantization import int8_fused_allgather_shards

            full = int8_fused_allgather_shards(
                [s.detach() for s in self._shards], templates, self._ps,
                self._ag_threshold, salt=salt)
            return [f.to(p.dtype) for f, p in zip(full, self._params)]
        compressed = [self._compression.compress(s.detach())
                      for s in self._shards]
        full = fusion.fused_allgather_shards(
            [c[0] for c in compressed], templates, self._ag_threshold,
            process_set=self._ps)
        return [self._compression.decompress(f, c[1]).to(p.dtype)
                for f, c, p in zip(full, compressed, self._params)]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self._params + self._shards:
            if p.grad is not None:
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.zero_()


class _FsdpOptimizer:
    """``sync_mode="fsdp"`` (ZeRO-3): each rank keeps only its shards of the
    parameters (``self.shards``) and the wrapped optimizer's state for
    them. Building it releases the parameters' full storage: the model's
    ``Parameter``s stay as names and shapes, holding no data.
    ``make_train_step`` runs the model on just-in-time gathers
    (``parallel.param_sharding.FsdpForward``), :func:`gather` on all of
    them at once; either way the backward reduce-scatters the gradients
    into the shards' ``.grad``, and ``step()`` then updates the shards in
    place, with no allgather."""

    def __init__(self, optimizer, op, compression, prescale_factor,
                 postscale_factor, process_set, fusion_threshold_bytes):
        from .parallel.param_sharding import shard_meta

        self._op = op
        self._compression = compression
        self._int8 = _is_int8(compression)
        self._prescale = prescale_factor
        self._postscale = postscale_factor
        self._ps = process_set
        self._threshold = fusion_threshold_bytes
        self.backward_passes_per_step = 1
        n, r = process_set.size(), process_set.rank()
        self._n, self._r = n, r
        seen: set[int] = set()
        self._params: list[torch.Tensor] = []
        groups = []
        for group in optimizer.param_groups:
            members = []
            for p in group["params"]:
                if p.requires_grad and id(p) not in seen:
                    seen.add(id(p))
                    self._params.append(p)
                    members.append(p)
            groups.append((group, members))
        self.meta = shard_meta(self._params, n)
        index = {id(p): i for i, p in enumerate(self._params)}
        self._groups = [[index[id(p)] for p in members]
                        for _, members in groups]
        self._own_shards([p.detach() for p in self._params], optimizer)
        with torch.no_grad():
            for p in self._params:
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self._nonfinite_action = nonfinite_action()
        self.nonfinite_steps = 0
        self._updates = 0

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def _own_shards(self, full, like) -> None:
        """Own this rank's shards of the ``full`` parameters in the
        process set's current world, on the parameters' device, with a new
        wrapped optimizer of ``like``'s class over them (the
        hyperparameters of ``like``'s groups, no state)."""
        n, r = self._ps.size(), self._ps.rank()
        self._n, self._r = n, r
        self.meta = self.meta._replace(world_size=n)
        self.shards = [
            torch.nn.Parameter(_own_slice(t, s, n, r).to(p.device))
            for t, s, p in zip(full, self.meta.shard_sizes, self._params)]
        self._opt = _rebuild_over(like, [
            {**{k: v for k, v in g.items() if k != "params"},
             "params": [self.shards[i] for i in idx]}
            for g, idx in zip(like.param_groups, self._groups)])

    def _reform(self, full_params) -> None:
        """Re-own the shards of ``full_params`` (the full tensors, in
        ``param_groups`` order) for the world the process set has now (an
        elastic world re-formed at another size), with empty state:
        ``load_sharded_state`` fills it."""
        self._own_shards(full_params, self._opt)

    @property
    def salt(self) -> int:
        """The int8 rounding salt of the coming update."""
        return self._updates

    def gather(self, num_segments: int | None = None):
        """Every full parameter (in ``param_groups`` order) at once, one
        gather per segment, differentiable into the shards
        (``param_sharding.gather_params``)."""
        from .parallel.param_sharding import gather_params

        return gather_params(self.shards, self.meta, self, num_segments)

    def full_parameters(self) -> list[torch.Tensor]:
        """Every parameter in full, gathered from every rank's shards
        (collective; no gradient)."""
        with torch.no_grad():
            return self.gather_shards(list(range(len(self.shards))),
                                      [s.detach() for s in self.shards],
                                      salt=None, wire=False)

    def gather_shards(self, idx, shards, salt, wire=True):
        """Full tensors of parameters ``idx`` from their shards, through the
        optimizer's wire (``wire=False``: exactly, uncompressed)."""
        templates = [self.meta.template(i) for i in idx]
        if wire and self._int8:
            from .ops.quantization import int8_fused_allgather_shards

            full = int8_fused_allgather_shards(
                list(shards), templates, self._ps, self._threshold,
                salt=salt)
            return [f.to(t.dtype) for f, t in zip(full, templates)]
        comp = self._compression if wire else Compression.none
        compressed = [comp.compress(s) for s in shards]
        full = fusion.fused_allgather_shards(
            [c[0] for c in compressed], templates, self._threshold,
            process_set=self._ps)
        return [comp.decompress(f, c[1]).to(t.dtype)
                for f, c, t in zip(full, compressed, templates)]

    def reduce_scatter(self, idx, grads, salt):
        """This rank's reduced shards of full gradients ``grads`` of
        parameters ``idx``, through the optimizer's wire, buckets issued
        last first."""
        grads = [g if g is not None else torch.zeros(
            self.meta.shapes[i], dtype=self.meta.dtypes[i],
            device=self.shards[i].device) for i, g in zip(idx, grads)]
        if self._int8:
            from .ops.quantization import int8_fused_reducescatter

            shards = int8_fused_reducescatter(
                grads, self._ps, self._op, self._threshold, self._prescale,
                self._postscale, salt=salt, issue_reversed=True)
        else:
            compressed = [self._compression.compress(g) for g in grads]
            shards = fusion.fused_reducescatter(
                [c[0] for c in compressed], self._op, self._threshold,
                self._prescale, self._postscale, issue_reversed=True,
                process_set=self._ps)
            shards = [self._compression.decompress(s, c[1])
                      for s, c in zip(shards, compressed)]
        return [s.to(self.shards[i].dtype) for i, s in zip(idx, shards)]

    def step(self, closure=None):
        del closure
        for s in self.shards:
            if s.grad is None:
                s.grad = torch.zeros_like(s)
        self._updates += 1
        if self._nonfinite_action is not None and not self._tripwire(
                fusion.psum_flag(fusion.finite_flag(
                    [s.grad for s in self.shards]), self._ps)):
            return None
        return self._opt.step()

    _tripwire = _DistributedOptimizer._tripwire

    def zero_grad(self, set_to_none: bool = True) -> None:
        self._opt.zero_grad(set_to_none=set_to_none)

    def remove_hooks(self) -> None:
        """No hooks: the gradients reach the shards through the gather's
        backward."""


def _check_sync_mode(sync_mode, op, k, num_groups) -> None:
    """The sharded and fsdp modes' guard table; every rejection names the
    fix."""
    if sync_mode == "allreduce":
        return
    # The reference's messages (horovod_tpu/optimizer.py:858, :870-875).
    if op not in (Average, Sum) and sync_mode == "sharded":
        raise SyncModeIneligibleError(
            f"sync_mode='sharded' supports op=Average/Sum, got {op!r}")
    if op not in (Average, Sum):
        raise SyncModeIneligibleError(
            f"sync_mode='fsdp' supports op=Average/Sum, got {op!r} "
            "(Adasum's whole-vector dot products need the full "
            "tensors resident on every rank — use "
            "sync_mode='allreduce' for Adasum)")
    if k != 1:
        raise SyncModeIneligibleError(
            f"sync_mode={sync_mode!r} does not compose with "
            "backward_passes_per_step > 1: accumulation defers the "
            "reduction, and the shard-local state would go stale between "
            "boundaries - accumulate outside the optimizer or use "
            "sync_mode='allreduce'")
    if sync_mode == "fsdp" and num_groups > 1:
        raise SyncModeIneligibleError(
            f"sync_mode='fsdp' does not compose with num_groups="
            f"{num_groups}: num_groups caps buckets at a share of the whole "
            "gradient, but the fsdp wire runs per segment - cap bucket sizes "
            "with fusion_threshold_bytes instead")


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
    the process set.

    With ``backward_passes_per_step=k`` the caller runs k backward passes
    (gradients accumulate in ``.grad``) and then ``step()``: the reduced
    gradient is the mean over the k microbatches. ``num_groups > 0`` caps
    each bucket at 1/num_groups of the wire's bytes, in place of the
    fusion threshold. With a ``process_set`` the buckets reduce over that
    set's group, and only its members build the optimizer and step.
    ``op=Adasum`` combines each gradient by the Adasum tree over the
    members (no ``num_groups``, no int8, allreduce mode only).
    ``compression=Compression.int8`` exchanges blockwise-quantized int8.
    ``sync_mode`` (argument > ``HOROVOD_SYNC_MODE`` > ``"allreduce"``)
    picks ``allreduce``, ``sharded`` (ZeRO-1) or ``fsdp`` (ZeRO-3; building
    it releases the parameters' full storage, see ``_FsdpOptimizer``); the
    latter two take op Average or Sum and ``backward_passes_per_step=1``,
    and fsdp no ``num_groups > 1``, raising ``SyncModeIneligibleError``
    otherwise. ``named_parameters`` exists for signature parity and is
    unused: collectives are matched by their fixed issue order. ``init()``
    must have run.
    """
    del named_parameters
    sync_mode = resolve_sync_mode(sync_mode)
    op = _resolve_op(op, None)
    k = int(backward_passes_per_step)
    if k < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if num_groups < 0:
        raise ValueError(f"num_groups must be >= 0; got {num_groups}")
    if num_groups and op == Adasum:
        # The reference torch surface's message
        # (horovod_tpu/torch/__init__.py:707-709).
        raise ValueError("num_groups/groups do not compose with "
                         "op=Adasum (no grouped Adasum form)")
    _check_sync_mode(sync_mode, op, k, num_groups)
    if _is_int8(compression) and op not in (Average, Sum):
        raise ValueError(
            f"Compression.int8 supports op=Average/Sum, got {op!r}")
    ps = _resolve_process_set(process_set)
    if sync_mode == "sharded":
        return _ShardedOptimizer(optimizer, op, compression, prescale_factor,
                                 postscale_factor, ps, int(num_groups),
                                 fusion_threshold_bytes)
    if sync_mode == "fsdp":
        return _FsdpOptimizer(optimizer, op, compression, prescale_factor,
                              postscale_factor, ps, fusion_threshold_bytes)
    return _DistributedOptimizer(optimizer, op, compression, k,
                                 prescale_factor, postscale_factor, ps,
                                 int(num_groups), fusion_threshold_bytes)



# ---------------------------------------------------------------------------
# The sharded optimizer state: rank-local state dicts, their stacked layout
# (every rank's shards as rows), and the monolithic layout (the state dict
# the wrapped optimizer over the full parameters would have).
# ---------------------------------------------------------------------------


def sync_mode_of(optimizer) -> str:
    """The sync mode a ``DistributedOptimizer`` was built with."""
    if isinstance(optimizer, _FsdpOptimizer):
        return "fsdp"
    if isinstance(optimizer, _ShardedOptimizer):
        return "sharded"
    return "allreduce"


def _map_state(state_dict, fn):
    """``state_dict`` with ``fn`` applied to every tensor of its per-
    parameter state (keyed by parameter index)."""
    return {
        "state": {i: {k: fn(i, v) if torch.is_tensor(v) else v
                      for k, v in st.items()}
                  for i, st in state_dict["state"].items()},
        "param_groups": state_dict["param_groups"],
    }


def init_sharded_state(optimizer) -> dict:
    """The stacked layout of a sharded or fsdp optimizer's state: each
    per-parameter tensor of every rank's shard-local state stacked on a
    leading world axis, ``(n, s)`` rows (row r is rank r's) and ``(n,)``
    for scalars, on the CPU. Collective: every member of the set calls it.
    ``salt_counter`` carries the int8 wire's update count."""
    from .functions import allgather_object

    local = _map_state(optimizer._opt.state_dict(),
                       lambda i, v: v.detach().cpu())
    rows = allgather_object(local, process_set=optimizer._ps)
    stacked = _map_state(rows[0], lambda i, v: v)
    for i, st in stacked["state"].items():
        for key, v in st.items():
            if torch.is_tensor(v):
                st[key] = torch.stack([r["state"][i][key] for r in rows])
    stacked["salt_counter"] = optimizer._updates
    return stacked


def _gather_rows(tensors, process_set) -> list:
    """Each of ``tensors`` from every member of ``process_set``, stacked on
    a leading axis (row r is member r's), on the set's first member only
    and on the CPU; None on the others. One gather per tensor, so no rank
    holds more than one tensor of the others' at a time. Collective."""
    import torch.distributed as dist

    from . import basics

    dev = basics.device()
    root = process_set.rank() == 0
    out = []
    for t in tensors:
        x = t.detach().to(dev).contiguous()
        rows = ([torch.empty_like(x) for _ in range(process_set.size())]
                if root else None)
        dist.gather(x, rows, dst=process_set.ranks[0],
                    group=process_set.group)
        out.append(torch.stack(rows).cpu() if root else None)
    return out


def gather_sharded_state(optimizer) -> dict | None:
    """:func:`init_sharded_state`'s layout on the first member of the
    optimizer's process set only (None on the others): what a rank-0
    checkpoint writes, without the full state on every rank. Collective."""
    local = optimizer._opt.state_dict()
    keys = [(i, k) for i, st in local["state"].items()
            for k, v in st.items() if torch.is_tensor(v)]
    rows = _gather_rows([local["state"][i][k] for i, k in keys],
                        optimizer._ps)
    if optimizer._ps.rank() != 0:
        return None
    stacked = _map_state(local, lambda i, v: v)
    for (i, k), row in zip(keys, rows):
        stacked["state"][i][k] = row
    stacked["salt_counter"] = optimizer._updates
    return stacked


def unshard_opt_state(optimizer, stacked: dict) -> dict:
    """The monolithic state dict from :func:`init_sharded_state`'s layout
    (host math): rows joined and cut to each parameter's shape, scalars
    from row 0."""
    shapes = [p.shape for p in optimizer._params] if not isinstance(
        optimizer, _FsdpOptimizer) else [torch.Size(s) for s in
                                         optimizer.meta.shapes]

    def un(i, v):
        if v.dim() == 1:
            return v[0].clone()
        return v.reshape(-1)[:shapes[i].numel()].view(shapes[i]).clone()

    full = _map_state(stacked, un)
    full["salt_counter"] = stacked.get("salt_counter", 0)
    return full


def reshard_opt_state(optimizer, full_state: dict, world_size: int) -> dict:
    """The stacked layout for ``world_size`` ranks of a monolithic state
    dict (host math): each per-parameter tensor as ``(n, ceil(m/n))`` rows
    of its zero-padded flat view, scalars repeated ``(n,)``."""
    del optimizer  # ownership follows from each state tensor's own size
    n = int(world_size)
    if n < 1:
        raise ValueError(f"reshard_opt_state needs a positive world size, "
                         f"got {world_size!r}")

    def re(i, v):
        if v.dim() == 0:
            return v.reshape(1).repeat(n)
        (s,) = fusion.shard_ownership([v.numel()], n)
        return torch.nn.functional.pad(v.reshape(-1),
                                       (0, n * s - v.numel())).view(n, s)

    stacked = _map_state(full_state, re)
    stacked["salt_counter"] = full_state.get("salt_counter", 0)
    return stacked


def load_sharded_state(optimizer, stacked: dict) -> None:
    """Load this rank's row of :func:`init_sharded_state`'s layout into a
    sharded or fsdp optimizer."""
    r = optimizer._ps.rank()
    optimizer._opt.load_state_dict(_map_state(stacked, lambda i, v: v[r]))
    optimizer._updates = int(stacked.get("salt_counter", 0))
