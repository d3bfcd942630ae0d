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
issues the same collectives in the same order. Without an explicit
``fusion_threshold_bytes`` or ``num_groups`` the threshold is the live
one (the autotune pin, else ``HOROVOD_FUSION_THRESHOLD``), and
``rebucket()`` re-derives the buckets from it at a step boundary: the
autotuner's counterpart of the JAX package's re-trace. The comms planner
(``ops/comms_planner.py``) schedules each bucket's collective when
``HOROVOD_COMMS_PLANNER`` is set; its exchange happens where the
optimizer reads its world, never inside a gradient hook.

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
state as they were; ``abort`` skips the update too and posts the
coordinated abort (``integrity.note_nonfinite``, which counts every
detection in ``hvd_nonfinite_steps_total`` and journals
``nonfinite_step``), so every blocking site of every rank then raises
``HorovodInternalError`` into the elastic ladder. Unset, nothing is
checked and the step launches what it did without it.

:class:`ReduceSpec` (:func:`reduce_spec_of`, reference :527, :554) names
an optimizer's wire and its wrapped optimizer, for schedulers that reduce
the gradients themselves: :func:`reduce_segment` launches one segment's
buckets on that wire (the direct path: ``start_allreduce`` with the comms
planner's schedule, the shard reduce-scatter, or the int8 exchange salted
by the caller) and returns the call that finishes them; the overlapped
step (``parallel.data_parallel.make_overlapped_train_step``) launches it
from the backward and updates a segment at a time
(``_apply_segment``). The sharded optimizer can leave its updated-parameter
allgather in flight (``make_train_step(..., deferred_param_gather=True)``):
:meth:`_ShardedOptimizer.settle` finishes it, and whatever reads the
parameters calls :func:`wait_deferred_gathers` first.

``step()`` is the collective half, :meth:`_reduce` (the reduced
gradients), in a ``collective`` phase, then the update, :meth:`_apply`, in
an ``optimizer_update`` phase (``tracing.phase``: the spans that step-time
attribution decomposes). Each update that crosses the wire counts one
flush in ``hvd_grad_sync_flushes_total`` and observes its wire bytes and
buckets (``hvd_grad_sync_bytes``, ``hvd_grad_sync_buckets``; the JAX
package counts one per trace, the port, which has no trace, one per
update). Each bucket's launch and finish run inside a
``hvd.<op>.bucket<k>`` range (``profiler.annotate_collective``). The
sharded and fsdp modes set ``hvd_resident_state_bytes``. Building the
buckets notes their leaf layout on the comms and memory observatories
(``fusion.note_leaf_layout``: once per bucket plan, not per step); every
mode notes the parameters it holds (sharded: with its shard copies; fsdp:
the shards) when it is built, and the wrapped optimizer's state on the
parameters' device after its first update, as ``params`` and
``opt_state`` (``memory.note_named`` and ``note_resident``).
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, NamedTuple

import torch

from . import abort, basics, memory, metrics
from .attribution import (CAT_COLLECTIVE, CAT_PHASE, SPAN_COLLECTIVE,
                          SPAN_OPTIMIZER_UPDATE)
from .compression import Compression
from .exceptions import HorovodInternalError, SyncModeIneligibleError
from .ops import fusion
from .ops.adasum import adasum_tree, gather_rows
from .ops.comms_planner import dispatch_plan
from .ops.collective_ops import (Adasum, Average, Sum, _resolve_op,
                                 _resolve_process_set, _scale_,
                                 elastic_errors, finish_allreduce, guarded,
                                 start_allreduce, wait)
from .ops.fusion import (all_finite, bucket_leaves, nonfinite_action, pack,
                         unpack)
from .profiler import annotate_collective
from .tracing import phase
from .utils import env
from .utils.logging import get_logger

_VALID_SYNC_MODES = ("allreduce", "sharded", "fsdp")


def resolve_sync_mode(sync_mode: str | None = None) -> str:
    """Explicit argument > the pinned autotune decision
    (``autotune.tuned_sync_mode``) > ``HOROVOD_SYNC_MODE`` >
    ``"allreduce"``; one of ``allreduce``, ``sharded`` and ``fsdp``. Read
    when an optimizer is built: the mode fixes the state's layout."""
    if sync_mode is None:
        from .autotune import tuned_sync_mode

        sync_mode = tuned_sync_mode()
    if sync_mode is None:
        sync_mode = env.get_str(env.SYNC_MODE).strip().lower() or "allreduce"
    if sync_mode not in _VALID_SYNC_MODES:
        raise ValueError(
            f"unknown sync_mode {sync_mode!r}; expected one of "
            f"{_VALID_SYNC_MODES}")
    return sync_mode


def _is_int8(compression) -> bool:
    return getattr(compression, "marker", None) == "int8"


def _phased_step(opt, closure=None):
    """:meth:`_reduce` and then :meth:`_apply` of a sync-mode optimizer,
    each in its step phase."""
    with phase(SPAN_COLLECTIVE, CAT_COLLECTIVE):
        reduced = opt._reduce()
    with phase(SPAN_OPTIMIZER_UPDATE, CAT_PHASE):
        return opt._apply(reduced, closure)


def _note_flush(sync_mode: str, nbytes: int, nbuckets: int) -> None:
    """One gradient flush: ``hvd_grad_sync_*`` by sync mode."""
    metrics.GRAD_SYNC_FLUSHES.inc(sync_mode=sync_mode)
    metrics.GRAD_SYNC_BYTES.observe(nbytes, sync_mode=sync_mode)
    metrics.GRAD_SYNC_BUCKETS.observe(nbuckets, sync_mode=sync_mode)


def _state_bytes(opt, device: torch.device | None = None) -> int:
    """Bytes of the tensors in a ``torch.optim.Optimizer``'s state; with
    ``device``, of those on it only (Adam's ``step`` scalars stay on the
    host unless ``capturable`` or ``fused``)."""
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for v in st.values() if torch.is_tensor(v)
               and (device is None or v.device == device))


def _note_opt_state(opt, params) -> None:
    """Note the wrapped optimizer's state (set by its first step) on its
    ``params``' device as this rank's resident ``opt_state``."""
    if params:
        memory.note_resident("opt_state",
                             _state_bytes(opt, params[0].device))


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


def _skips_wire(process_set, op) -> bool:
    """A one-member set reduces to the identity: skip the wire and apply
    only the scale factors (reference optimizer.py:133-146), unless
    HOROVOD_FORCE_WIRE_MACHINERY=1 asks for the full path."""
    return (process_set.size() == 1
            and env.get_str(env.FORCE_WIRE_MACHINERY) != "1"
            and op in (Average, Sum, Adasum))


def _launch_allreduce_bucket(grads, op, compression, prescale, ps):
    """Compress and pack one bucket's gradients and launch its collective
    on the direct path: the in-place allreduce (the comms planner's
    schedule where it has one), or Adasum's gather of every member's row.
    Returns what :func:`_finish_allreduce_bucket` takes."""
    wires, ctxs = [], []
    for g in grads:
        wire, ctx = compression.compress(g)
        wires.append(wire)
        ctxs.append(ctx)
    flat = pack(wires)
    if op == Adasum:
        _scale_(flat, prescale)
        rows, work = gather_rows(flat, ps)
        return rows, work, ctxs
    work = start_allreduce(
        flat, op, prescale, ps.group,
        dispatch_plan("allreduce", flat.numel() * flat.element_size(), ps,
                      op), ps)
    return flat, work, ctxs


def _adasum_leaves(rows, work, shapes, postscale) -> list[torch.Tensor]:
    """A gathered bucket's leaves, each the Adasum tree over its view in
    every member's row, postscaled."""
    wait(work)
    leaves = []
    for views in zip(*(unpack(row, shapes) for row in rows)):
        leaf = adasum_tree(views)
        _scale_(leaf, postscale)
        leaves.append(leaf)
    return leaves


def _finish_allreduce_bucket(launched, shapes, op, compression, postscale,
                             ps):
    """Wait for a bucket of :func:`_launch_allreduce_bucket`: (its reduced
    gradients, decompressed, in order; what the tripwire reads of it: the
    reduced flat bucket, or Adasum's leaves)."""
    flat, work, ctxs = launched
    if op == Adasum:
        pieces = _adasum_leaves(flat, work, shapes, postscale)
        checked = pieces
    else:
        checked = [finish_allreduce(flat, work, op, postscale, ps)]
        pieces = unpack(flat, shapes)
    return ([compression.decompress(piece, ctx)
             for piece, ctx in zip(pieces, ctxs)], checked)


def _launch_shard_bucket(grads, sizes, compression, prescale, ps):
    """Compress one bucket's gradients and launch its reduce-scatter of
    the owned slices (``fusion.start_shard_reducescatter``)."""
    wires, ctxs = [], []
    for g in grads:
        wire, ctx = compression.compress(g)
        wires.append(wire)
        ctxs.append(ctx)
    return fusion.start_shard_reducescatter(wires, sizes, prescale, ps), ctxs


def _finish_shard_bucket(launched, sizes, op, compression, postscale,
                         n) -> list[torch.Tensor]:
    """Wait for a bucket of :func:`_launch_shard_bucket`: this rank's
    reduced shard of each of its gradients, decompressed."""
    (row, work), ctxs = launched
    fusion.finish_shard_reducescatter(row, work, op, postscale, n)
    return [compression.decompress(piece, ctx) for piece, ctx in
            zip(fusion._split_shard_row(row, sizes), ctxs)]


class _DistributedOptimizer:
    """Delegating wrapper around a ``torch.optim.Optimizer``: everything
    not overridden here (``zero_grad``, ``state_dict``, ``param_groups``,
    ...) goes to the wrapped optimizer."""

    def __init__(self, optimizer, op, compression, backward_passes_per_step,
                 prescale_factor, postscale_factor, process_set, num_groups,
                 fusion_threshold_bytes, names=None):
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
        # Each parameter's name (named_parameters), for the memory
        # observatory's forensics.
        self._names = [(names or {}).get(id(p), f"param{i}")
                       for i, p in enumerate(self._params)]
        self._base_threshold = fusion_threshold_bytes
        self._int8 = _is_int8(compression)
        # Updates so far: the int8 wire's rounding salt.
        self._updates = 0
        # The int8 exchange buckets the float32 view of the gradients.
        self._wire_dtypes = [
            torch.float32 if self._int8 else compression.compress(
                torch.empty(0, dtype=p.dtype, device=p.device))[0].dtype
            for p in self._params]
        # A flush's wire bytes (int8: one byte an element).
        self._wire_bytes = sum(
            p.numel() * (1 if self._int8 else d.itemsize)
            for p, d in zip(self._params, self._wire_dtypes))
        self._plan_buckets()
        self._rebucket_due = False
        self._note_params()
        self._state_noted = False
        self._hooks = []
        self._detached = False  # remove_hooks() was called
        self._read_world()
        self._nonfinite_action = nonfinite_action()
        self.nonfinite_steps = 0  # steps whose reduced gradients were not finite
        self._reset()
        _live.add(self)

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def _plan_buckets(self) -> None:
        """The buckets: ``bucket_leaves`` of the wire layout under the
        threshold (``num_groups``' share of the wire, else an explicit
        ``fusion_threshold_bytes``, else ``fusion.fusion_threshold_bytes``:
        the autotune pin or ``HOROVOD_FUSION_THRESHOLD``), and the layout
        noted on the comms and memory observatories."""
        leaves = [(p.numel(), d)
                  for p, d in zip(self._params, self._wire_dtypes)]
        if self._num_groups > 0:
            # The reference's num_groups: cap each bucket at total /
            # num_groups bytes of the wire.
            threshold = max(1, sum(m * d.itemsize for m, d in leaves)
                            // self._num_groups)
        elif self._base_threshold is not None:
            threshold = self._base_threshold
        else:
            threshold = fusion.fusion_threshold_bytes()
        self._threshold = threshold
        self._buckets = [[self._params[i] for i in b]
                         for b in bucket_leaves(leaves, threshold)]
        self._bucket_of = {id(p): bi for bi, b in enumerate(self._buckets)
                           for p in b}
        fusion.note_leaf_layout(
            [(p.numel(), p.dtype) for p in self._params],
            [torch.int8] * len(self._params) if self._int8
            else self._wire_dtypes)

    def rebucket(self) -> None:
        """Re-derive the buckets from the live fusion threshold (the
        autotune pin): the port's counterpart of the JAX package's
        re-trace of the step (``autotune.AutotuneStep``). An optimizer
        built with ``num_groups`` or an explicit ``fusion_threshold_bytes``
        keeps its buckets. Applied at once at a step boundary; with a
        gradient counted or a bucket in flight, after that step's
        ``synchronize``, so no hook is left on a stale bucket."""
        if self._num_groups > 0 or self._base_threshold is not None:
            return
        if self._passes or self._launched:
            self._rebucket_due = True
            return
        self._plan_buckets()
        self._reset()

    def _note_params(self) -> None:
        """Note the parameters this rank holds on the memory
        observatory."""
        memory.note_named("params", zip(self._names, self._params))

    def _skips_wire(self) -> bool:
        return _skips_wire(self._ps, self._op)

    def _read_world(self) -> None:
        """Read what the world decides, once per world: at construction
        and at every later ``init()`` (an elastic world may re-form at
        another size). On the wire the buckets launch from the gradient
        hooks during backward; the int8 exchange runs whole in step(): it
        has a local sum between its two collectives."""
        self._elastic = basics.elastic()
        self._short_circuit = self._skips_wire()
        # The comms planner's exchange and subgroups for this world, here
        # where every rank builds and re-reads its optimizers in one order,
        # never inside the backward's hooks (it plans the global set only).
        if self._ps.process_set_id == 0:
            from .ops import comms_planner

            comms_planner.prepare()
        if self._short_circuit or self._int8:
            self._unhook()
        elif not (self._hooks or self._detached):
            self._hooks = [p.register_post_accumulate_grad_hook(self._on_grad)
                           for p in self._params]

    def _reset(self) -> None:
        if self._rebucket_due:
            self._rebucket_due = False
            self._plan_buckets()
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
        with annotate_collective(f"allreduce.bucket{bi}"):
            k = self.backward_passes_per_step
            grads = []
            for p in self._buckets[bi]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if k > 1:
                    # The mean over microbatches, taken before the wire
                    # cast so an fp16 wire keeps its headroom.
                    g = g / k
                grads.append(g)
            self._launched[bi] = _launch_allreduce_bucket(
                grads, self._op, self._compression, self._prescale, self._ps)

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
            params = self._buckets[bi]
            with annotate_collective(f"allreduce.bucket{bi}.finish"):
                grads, checked = _finish_allreduce_bucket(
                    self._launched[bi], [p.shape for p in params], self._op,
                    self._compression, self._postscale, self._ps)
            reduced.extend(checked)
            for p, g in zip(params, grads):
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
        return _phased_step(self, closure)

    def _reduce(self) -> list[torch.Tensor]:
        """The collective half of :meth:`step`: the reduced gradients,
        written into ``.grad`` (a one-member set short-circuits to the
        local gradients, scaled)."""
        if self._short_circuit:
            self._scale_local()
            return [p.grad for p in self._params if p.grad is not None]
        reduced = self.synchronize()
        _note_flush("allreduce", self._wire_bytes, len(self._buckets))
        return reduced

    def _apply(self, reduced, closure=None):
        """The update half of :meth:`step`: the tripwire over ``reduced``,
        then the wrapped optimizer's step."""
        self._updates += 1
        if (self._nonfinite_action is not None
                and not self._tripwire(all_finite(reduced))):
            return None
        out = self._opt.step(closure)
        if not self._state_noted:
            # The state's size is set by its first step.
            self._state_noted = True
            _note_opt_state(self._opt, self._params)
        return out

    def _apply_segment(self, idx, grads) -> None:
        """The overlapped step's update of parameters ``idx`` (indices into
        ``_params``) from their reduced gradients: only they carry a
        ``.grad``, so the wrapped optimizer steps them alone (``torch.optim``
        skips a parameter without one) and its state of the others stays
        as it is."""
        for i, g in zip(idx, grads):
            self._params[i].grad = g
        self._opt.step()
        for i in idx:
            self._params[i].grad = None

    def _end_segments(self, nbuckets: int) -> None:
        """After the overlapped step's last segment: one update counted
        (the int8 wire's salt) and one flush noted."""
        self._updates += 1
        _note_flush(sync_mode_of(self), self._wire_bytes, nbuckets)
        if not self._state_noted:
            self._state_noted = True
            _note_opt_state(self._opt, self._params)

    def _tripwire(self, finite: bool) -> bool:
        """Report the checked step to the integrity plane (which counts,
        journals and, under ``abort``, posts the coordinated abort) and
        say what the step should do: False when its update is to be
        skipped (``skip``, and ``abort``, whose rollback discards it)."""
        from . import integrity

        integrity.note_nonfinite(self._nonfinite_action, finite, 0)
        if finite:
            return True
        self.nonfinite_steps += 1
        return self._nonfinite_action == "warn"

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
        if getattr(opt, "_in_flight", None) is not None:
            opt._in_flight = None  # a gather on the group being left


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
                 fusion_threshold_bytes, names=None):
        super().__init__(optimizer, op, compression, 1, prescale_factor,
                         postscale_factor, process_set, num_groups,
                         fusion_threshold_bytes, names)
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
        # The deferred updated-parameter allgather (make_train_step's
        # deferred_param_gather): whether to leave it in flight, and the
        # call that finishes the one in flight.
        self._defer_gather = False
        self._in_flight: Callable[[], None] | None = None

    def _plan_buckets(self) -> None:
        super()._plan_buckets()
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

    def _note_params(self) -> None:
        """The full parameters and this rank's flat shard copies (the
        Parameters the wrapped optimizer steps), once both exist."""
        if hasattr(self, "_shards"):
            memory.note_named("params", zip(
                self._names + [f"{n} (shard)" for n in self._names],
                self._params + self._shards))

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
        self._note_params()
        self._state_noted = False
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
        return self._threshold

    def _launch(self, bi: int) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._buckets[bi]]
        sizes = [self._sizes[self._index[id(p)]] for p in self._buckets[bi]]
        with annotate_collective(f"reducescatter.bucket{bi}"):
            self._launched[bi] = _launch_shard_bucket(
                grads, sizes, self._compression, self._prescale, self._ps)

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
            params = self._buckets[bi]
            sizes = [self._sizes[self._index[id(p)]] for p in params]
            with annotate_collective(f"reducescatter.bucket{bi}.finish"):
                shards = _finish_shard_bucket(
                    self._launched[bi], sizes, self._op, self._compression,
                    self._postscale, self._n)
            for p, shard in zip(params, shards):
                out[self._index[id(p)]] = shard
        return out

    def synchronize(self):
        """Finish the reduce-scatters; return the gradient shards."""
        shards = self._grad_shards()
        self._reset()
        return shards

    def step(self, closure=None):
        return _phased_step(self, closure)

    def _reduce(self) -> list[torch.Tensor]:
        """The reduce-scatters' half of :meth:`step`: the gradient
        shards."""
        grads = self.synchronize()
        _note_flush("sharded", self._wire_bytes, len(self._buckets))
        return grads

    def _apply(self, grads, closure=None):
        """The update half of :meth:`step`: the tripwire, the wrapped
        optimizer's step on the owned shards, and the allgather of the
        updated parameters."""
        del closure
        self.settle()
        salt = self._updates
        self._updates += 1
        if self._nonfinite_action is not None and not self._tripwire(
                fusion.psum_flag(fusion.finite_flag(grads), self._ps)):
            return None
        self._step_shards(range(len(self._params)), grads)
        self._note_state()
        gather = self._start_gather(salt, range(len(self._params)))
        if self._defer_gather:
            # make_train_step(deferred_param_gather=True): the step returns
            # with the gather in flight; settle() finishes it.
            self._in_flight = gather
        else:
            gather()
        return None

    def _step_shards(self, idx, grads) -> None:
        """The wrapped optimizer's step on the shards of parameters
        ``idx`` (only they may carry a ``.grad``) from their reduced
        gradient shards."""
        with torch.no_grad():
            for i, g in zip(idx, grads):
                shard = self._shards[i]
                # The shard is taken from the parameter each step, so writes
                # to the parameters between steps (a broadcast) are seen.
                shard.copy_(_own_slice(self._params[i], self._sizes[i],
                                       self._n, self._r))
                shard.grad = g.to(shard.dtype).reshape(shard.shape)
        self._opt.step()

    def _note_state(self) -> None:
        if not self._state_noted:
            # The state's size is set by its first step.
            self._state_noted = True
            metrics.RESIDENT_BYTES.set(_state_bytes(self._opt),
                                       kind="opt_state", sync_mode="sharded")
            _note_opt_state(self._opt, self._shards)

    def _apply_segment(self, idx, grads) -> None:
        """The overlapped step's update of parameters ``idx`` from their
        reduced gradient shards, and the allgather of their updated
        parameters (salted, int8, by the update count before this
        update's)."""
        idx = list(idx)
        self._step_shards(idx, grads)
        for i in idx:
            # The next segment's step must not step these shards again.
            self._shards[i].grad = None
        self._start_gather(self._updates, idx)()

    def _end_segments(self, nbuckets: int) -> None:
        self._updates += 1
        _note_flush("sharded", self._wire_bytes, nbuckets)
        self._note_state()

    def _start_gather(self, salt, idx) -> Callable[[], None]:
        """Launch the allgather of the updated parameters ``idx`` from
        every rank's shards, through the wire (a cast wire gathers in its
        dtype; int8 the quantized allgather, salted by ``salt``); returns
        the call that waits for it and writes them into the parameters."""
        idx = list(idx)
        params = [self._params[i] for i in idx]
        shards = [self._shards[i].detach() for i in idx]
        templates = [p.detach() for p in params]
        if self._int8:
            from .ops.quantization import int8_fused_allgather_shards

            full = int8_fused_allgather_shards(
                shards, templates, self._ps, self._ag_threshold, salt=salt)

            def finish():
                return full
        else:
            compressed = [self._compression.compress(s) for s in shards]
            _, gathered = fusion.start_fused_allgather_shards(
                [c[0] for c in compressed], templates, self._ag_threshold,
                process_set=self._ps)

            def finish():
                return [self._compression.decompress(f, c[1])
                        for f, c in zip(gathered(), compressed)]

        def write() -> None:
            with torch.no_grad():
                for p, f in zip(params, finish()):
                    p.copy_(f)  # in the parameter's dtype

        return write

    def settle(self) -> None:
        """Finish the updated-parameter allgather that a deferred step left
        in flight, if any: the parameters then hold the last update."""
        gather, self._in_flight = self._in_flight, None
        if gather is not None:
            gather()

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
                 postscale_factor, process_set, fusion_threshold_bytes,
                 names=None):
        from .parallel.param_sharding import shard_meta

        self._op = op
        self._compression = compression
        self._int8 = _is_int8(compression)
        self._prescale = prescale_factor
        self._postscale = postscale_factor
        self._ps = process_set
        self._base_threshold = fusion_threshold_bytes
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
        self._itemsize: dict[torch.dtype, int] = {}
        self._wire_bytes = sum(p.numel() * self.wire_itemsize(p.dtype)
                               for p in self._params)
        self._plan_buckets()
        self._names = [(names or {}).get(id(p), f"param{i}")
                       for i, p in enumerate(self._params)]
        index = {id(p): i for i, p in enumerate(self._params)}
        self._groups = [[index[id(p)] for p in members]
                        for _, members in groups]
        self._own_shards([p.detach() for p in self._params], optimizer)
        with torch.no_grad():
            for p in self._params:
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self._prepare_planner()
        self._nonfinite_action = nonfinite_action()
        self.nonfinite_steps = 0
        self._updates = 0

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def _plan_buckets(self) -> None:
        """The threshold of the per-segment gathers and reduce-scatters
        (an explicit ``fusion_threshold_bytes``, else
        ``fusion.fusion_threshold_bytes``), their bucket count over all
        leaves, and the layout noted on the observatories."""
        self._threshold = (self._base_threshold
                           if self._base_threshold is not None
                           else fusion.fusion_threshold_bytes())
        # The full shapes (the parameters hold no data once built).
        leaves = [(torch.Size(s).numel(), d)
                  for s, d in zip(self.meta.shapes, self.meta.dtypes)]
        self._nbuckets = len(bucket_leaves(leaves, self._threshold))
        fusion.note_leaf_layout(leaves, [
            torch.int8 if self._int8 else self._compression.compress(
                torch.empty(0, dtype=d, device="meta"))[0].dtype
            for _, d in leaves])

    def rebucket(self) -> None:
        """Re-derive the threshold from the autotune pin (see
        ``_DistributedOptimizer.rebucket``); the gathers and
        reduce-scatters of the next step use it. An explicit
        ``fusion_threshold_bytes`` wins."""
        if self._base_threshold is None:
            self._plan_buckets()

    def wire_itemsize(self, dtype: torch.dtype) -> int:
        """Bytes an element of a ``dtype`` leaf takes on the wire."""
        if dtype not in self._itemsize:
            self._itemsize[dtype] = 1 if self._int8 else \
                self._compression.compress(
                    torch.empty(0, dtype=dtype))[0].element_size()
        return self._itemsize[dtype]

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
        metrics.RESIDENT_BYTES.set(
            sum(s.numel() * s.element_size() for s in self.shards),
            kind="params", sync_mode="fsdp")
        memory.note_named("params", zip(
            [f"{n} (shard)" for n in self._names], self.shards))
        self._state_noted = False

    def _reform(self, full_params) -> None:
        """Re-own the shards of ``full_params`` (the full tensors, in
        ``param_groups`` order) for the world the process set has now (an
        elastic world re-formed at another size), with empty state:
        ``load_sharded_state`` fills it."""
        self._own_shards(full_params, self._opt)
        self._prepare_planner()

    def _prepare_planner(self) -> None:
        """The comms planner's exchange and subgroups for this world (see
        ``_DistributedOptimizer._read_world``)."""
        if self._ps.process_set_id == 0:
            from .ops import comms_planner

            comms_planner.prepare()

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
        return _phased_step(self, closure)

    def _reduce(self) -> list[torch.Tensor]:
        """The shards' reduced gradients (the reduce-scatters ran in the
        backward; a shard without one gets zeros)."""
        for s in self.shards:
            if s.grad is None:
                s.grad = torch.zeros_like(s)
        _note_flush("fsdp", self._wire_bytes, self._nbuckets)
        return [s.grad for s in self.shards]

    def _apply(self, grads, closure=None):
        """The tripwire, then the wrapped optimizer's step on the shards."""
        del closure
        self._updates += 1
        if self._nonfinite_action is not None and not self._tripwire(
                fusion.psum_flag(fusion.finite_flag(grads), self._ps)):
            return None
        out = self._opt.step()
        if not self._state_noted:
            # The state's size is set by its first step.
            self._state_noted = True
            metrics.RESIDENT_BYTES.set(_state_bytes(self._opt),
                                       kind="opt_state", sync_mode="fsdp")
            _note_opt_state(self._opt, self.shards)
        return out

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
    otherwise. ``named_parameters`` names the parameters in the memory
    observatory's forensics only: collectives are matched by their fixed
    issue order. ``init()`` must have run.
    """
    names = ({id(p): n for n, p in named_parameters}
             if named_parameters is not None else None)
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
                                 fusion_threshold_bytes, names)
    if sync_mode == "fsdp":
        return _FsdpOptimizer(optimizer, op, compression, prescale_factor,
                              postscale_factor, ps, fusion_threshold_bytes,
                              names)
    return _DistributedOptimizer(optimizer, op, compression, k,
                                 prescale_factor, postscale_factor, ps,
                                 int(num_groups), fusion_threshold_bytes,
                                 names)


class ReduceSpec(NamedTuple):
    """The wire a ``DistributedOptimizer`` was built with, and its wrapped
    optimizer (reference ``horovod_tpu/optimizer.py:527``): what a scheduler
    that reduces the gradients itself -- the overlap scheduler, per segment
    inside the backward -- needs to issue the same collectives (op,
    compression, scaling, bucketing, process set) and to apply the bare
    update. Read it with :func:`reduce_spec_of`. ``inner`` is the wrapped
    ``torch.optim.Optimizer`` (sharded and fsdp: over this rank's shards);
    ``fusion_threshold_bytes`` None means the live threshold
    (``fusion.fusion_threshold_bytes``: the autotune pin or
    ``HOROVOD_FUSION_THRESHOLD``)."""

    inner: Any
    op: str
    compression: Any
    prescale_factor: float
    postscale_factor: float
    process_set: Any
    num_groups: int
    fusion_threshold_bytes: int | None
    backward_passes_per_step: int
    sync_mode: str = "allreduce"


def reduce_spec_of(optimizer) -> ReduceSpec | None:
    """The :class:`ReduceSpec` of a ``DistributedOptimizer``, or None for a
    bare optimizer."""
    if isinstance(optimizer, _FsdpOptimizer):
        groups = 0
    elif isinstance(optimizer, _DistributedOptimizer):
        groups = optimizer._num_groups
    else:
        return None
    return ReduceSpec(optimizer._opt, optimizer._op, optimizer._compression,
                      optimizer._prescale, optimizer._postscale,
                      optimizer._ps, groups, optimizer._base_threshold,
                      optimizer.backward_passes_per_step,
                      sync_mode_of(optimizer))


def _segment_threshold(spec: ReduceSpec, leaves) -> int:
    """The bucket cap of one segment's wire: ``num_groups``' share of the
    segment's ``(numel, dtype)`` leaves (as the reference caps each
    reduction it is handed), else the spec's threshold, else the live
    one."""
    if spec.num_groups > 0:
        return max(1, sum(m * d.itemsize for m, d in leaves)
                   // spec.num_groups)
    if spec.fusion_threshold_bytes is not None:
        return spec.fusion_threshold_bytes
    return fusion.fusion_threshold_bytes()


def reduce_segment(spec: ReduceSpec, grads, salt=None):
    """Launch the reduction of one segment's gradients on ``spec``'s wire
    and return ``(finish, buckets)``: ``finish()`` waits for it and returns,
    in allreduce mode, the reduced gradients (their shapes and dtypes) and,
    in sharded mode, this rank's reduced shard of each (1-D,
    ``fusion.shard_ownership``); ``buckets`` is how many collectives it
    launched. The buckets are ``bucket_leaves`` of the segment's wire,
    launched last first on the direct path (``start_allreduce`` with the
    comms planner's schedule, Adasum's gather, the shard reduce-scatter),
    never as negotiated requests. The int8 wire runs its exchange here,
    salted by ``salt`` (the update count). A one-member set in allreduce
    mode only scales, as the optimizer's step does."""
    grads = list(grads)
    ps, op, comp = spec.process_set, spec.op, spec.compression
    pre, post = spec.prescale_factor, spec.postscale_factor
    if spec.sync_mode not in ("allreduce", "sharded"):
        raise ValueError(
            f"reduce_segment reduces allreduce- and sharded-mode wires; "
            f"sync_mode={spec.sync_mode!r} reduces inside its gathers' "
            "backward")
    sharded = spec.sync_mode == "sharded"
    if not sharded and _skips_wire(ps, op):
        scale = pre * post
        out = [g if scale == 1.0 else g * torch.tensor(
            scale, dtype=g.dtype, device=g.device) for g in grads]
        return (lambda: out), 0
    if _is_int8(comp):
        from .ops.quantization import (int8_fused_allreduce,
                                       int8_fused_reducescatter)

        # Buckets over the float32 exchange view (allreduce) or the leaves'
        # own dtype (the sharded reduce-scatter), as the optimizer sizes
        # them.
        view = [(g.numel(), g.dtype if sharded else torch.float32)
                for g in grads]
        threshold = _segment_threshold(spec, view)
        exchange = int8_fused_reducescatter if sharded else \
            int8_fused_allreduce
        out = exchange(grads, ps, op, threshold, pre, post, salt=salt,
                       issue_reversed=True)
        if sharded:
            out = [t.to(g.dtype) for t, g in zip(out, grads)]
        return (lambda: out), len(bucket_leaves(view, threshold))
    wire: dict[torch.dtype, torch.dtype] = {}
    for g in grads:
        if g.dtype not in wire:
            wire[g.dtype] = comp.compress(torch.empty(
                0, dtype=g.dtype, device=g.device))[0].dtype
    leaves = [(g.numel(), wire[g.dtype]) for g in grads]
    buckets = bucket_leaves(leaves, _segment_threshold(spec, leaves))
    n = ps.size()
    sizes = fusion.shard_ownership([g.numel() for g in grads], n)
    launched = []
    for bucket in reversed(buckets):
        bgrads = [grads[i] for i in bucket]
        if sharded:
            launched.append((bucket, _launch_shard_bucket(
                bgrads, [sizes[i] for i in bucket], comp, pre, ps)))
        else:
            launched.append((bucket, _launch_allreduce_bucket(
                bgrads, op, comp, pre, ps)))
    shapes = [g.shape for g in grads]

    def finish() -> list[torch.Tensor]:
        out: list = [None] * len(grads)
        for bucket, bucket_launched in launched:
            if sharded:
                pieces = _finish_shard_bucket(
                    bucket_launched, [sizes[i] for i in bucket], op, comp,
                    post, n)
            else:
                pieces, _ = _finish_allreduce_bucket(
                    bucket_launched, [shapes[i] for i in bucket], op, comp,
                    post, ps)
            for i, piece in zip(bucket, pieces):
                out[i] = piece
        return out

    return finish, len(buckets)


def wait_deferred_gathers() -> None:
    """Finish every sharded optimizer's deferred updated-parameter
    allgather in flight (``make_train_step(..., deferred_param_gather=
    True)``), so the parameters hold the last update: what reads the
    parameters between steps (``broadcast_parameters``, the checkpoint
    functions, the elastic states' commits) calls it first."""
    for opt in list(_live):
        settle = getattr(opt, "settle", None)
        if settle is not None:
            settle()


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
