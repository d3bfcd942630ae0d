"""Full parameter sharding (ZeRO-3 / fsdp): parameters live as shards.

Port of ``horovod_tpu/parallel/param_sharding.py``: ``ShardedParams``
(:75), ``shard_params`` (:183), ``unshard_params`` (:228),
``reshard_params`` (:251), ``stack_param_rows`` (:259),
``resident_param_bytes`` (:274),
``reshard_after_forward`` (:279) and ``gather_params`` (:410) with its
per-segment boundary (``_gather_boundary`` :319), and :class:`FsdpForward`,
the just-in-time placement of those boundaries in an eager forward.

Under ``sync_mode="fsdp"`` each rank holds only its shard of every
parameter: rank r owns ``[r*s, (r+1)*s)`` of the leaf's zero-padded flat
view, ``s = ceil(numel/n)`` (``ops.fusion.shard_ownership``, the layout of
the sharded optimizer state too). Full parameters exist only during a
step, a segment of contiguous leaves (``ops.fusion.segment_leaves``) at a
time: :class:`FsdpForward` gathers a segment when the forward first reads
it and frees it two segments on, the backward gathers it again where
autograd saved one of its tensors, and the segment's reduce-scatter turns
its gradients into shard gradients inside backprop (a
``torch.autograd.Function``). The update then writes back to the resident
shards with no trailing allgather. Each segment's gather records a
``param_allgather`` span and one ``hvd_param_gather_bytes`` observation
(per gather, so per step: the port has no trace). The JAX package leaves the placement of
its per-segment gathers to XLA; eager PyTorch places them itself.

:class:`ShardedParams` is the global, host-math view of the layout (every
rank's row stacked, as the JAX package keeps it): the on-disk and resize
format that checkpoints convert to and from.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Sequence

import torch

from ..ops.fusion import fsdp_segments, segment_leaves, shard_ownership
from ..utils import env


class ShardMeta(NamedTuple):
    """Static facts of a sharded parameter list: names (None for a plain
    list), full shapes and dtypes, and the world size."""

    names: tuple | None
    shapes: tuple
    dtypes: tuple
    world_size: int

    @property
    def shard_sizes(self) -> list[int]:
        return shard_ownership([torch.Size(s).numel() for s in self.shapes],
                               self.world_size)

    def template(self, i: int) -> torch.Tensor:
        """Leaf ``i`` as a meta tensor (shape and dtype, no data)."""
        return torch.empty(self.shapes[i], dtype=self.dtypes[i],
                           device="meta")

    def structure(self, leaves: Sequence[Any]):
        """``leaves`` hung on the original structure: a dict by name, or
        the list."""
        leaves = list(leaves)
        return leaves if self.names is None else dict(zip(self.names, leaves))


def shard_meta(params, world_size: int) -> ShardMeta:
    """The :class:`ShardMeta` of a dict or list of tensors."""
    names = tuple(params) if isinstance(params, dict) else None
    leaves = list(params.values()) if isinstance(params, dict) else list(
        params)
    return ShardMeta(names, tuple(tuple(t.shape) for t in leaves),
                     tuple(t.dtype for t in leaves), int(world_size))


class ShardedParams:
    """The fsdp layout of a parameter dict or list: per leaf, every rank's
    shard stacked into ``(world, shard)`` rows (row r is rank r's), and the
    :class:`ShardMeta` that rebuilds the full tensors from rows alone."""

    def __init__(self, rows: Sequence[torch.Tensor], meta: ShardMeta):
        self.rows = list(rows)
        self.meta = meta

    @property
    def world_size(self) -> int:
        return self.meta.world_size

    def templates(self) -> list[torch.Tensor]:
        """Per-leaf full-shape meta tensors, in row order."""
        return [self.meta.template(i) for i in range(len(self.rows))]

    def row(self, r: int):
        """Rank r's shards (1-D, one per leaf) on the original structure."""
        return self.meta.structure([x[r] for x in self.rows])


def shard_params(params, world_size: int | None = None) -> ShardedParams:
    """Shard a dict or list of full tensors into the fsdp layout for
    ``world_size`` ranks (default: the world's size); an already-sharded
    input is re-sharded. Host math, no collective. Notes a rank's resident
    bytes (one row of each leaf) on the memory observatory."""
    if isinstance(params, ShardedParams):
        return shard_params(unshard_params(params), world_size)
    if world_size is None:
        from .. import basics

        world_size = basics.size()
    n = int(world_size)
    if n < 1:
        raise ValueError(
            f"shard_params needs a positive world size, got {world_size!r} "
            "(init() first, or pass world_size=)")
    meta = shard_meta(params, n)
    leaves = list(params.values()) if isinstance(params, dict) else list(
        params)
    rows = [torch.nn.functional.pad(t.detach().reshape(-1),
                                    (0, n * s - t.numel())).view(n, s)
            for t, s in zip(leaves, meta.shard_sizes)]
    _note_param_rows(meta)
    return ShardedParams(rows, meta)


def _note_param_rows(meta: ShardMeta) -> None:
    """Note the per-rank resident bytes of a sharded layout (one
    ``ceil(size/n)`` row of every leaf) on the memory observatory, each
    leaf named for its forensics table, as the reference's
    ``_note_param_leaves`` does."""
    from .. import memory

    names = meta.names or tuple(f"param{i}" for i in range(len(meta.shapes)))
    memory.note_named("params", (
        (name, s * dtype.itemsize)
        for name, s, dtype in zip(names, meta.shard_sizes, meta.dtypes)))


def unshard_params(sp: ShardedParams):
    """The full tensors of :func:`shard_params`' layout (padding cut,
    shapes and dtypes restored), on the original structure."""
    if not isinstance(sp, ShardedParams):
        raise TypeError(
            f"unshard_params expects a ShardedParams, got {type(sp).__name__}"
            " (a full parameter dict or list is already unsharded)")
    out = [row.reshape(-1)[:torch.Size(shape).numel()].view(shape).to(dtype)
           for row, shape, dtype in zip(sp.rows, sp.meta.shapes,
                                        sp.meta.dtypes)]
    return sp.meta.structure(out)


def reshard_params(params, world_size: int) -> ShardedParams:
    """Re-shard (a full dict or list, or a ShardedParams) for a possibly new
    world size: ownership follows from the size alone."""
    return shard_params(params, world_size)


def stack_param_rows(rows_by_rank: Sequence[Any],
                     meta: ShardMeta) -> ShardedParams:
    """A :class:`ShardedParams` from each rank's row (what
    :meth:`ShardedParams.row` gives: 1-D shards on the original structure)
    in rank order: the peer replica plane's way back to the layout. The
    stack must be whole, ``meta.world_size`` rows."""
    if len(rows_by_rank) != meta.world_size:
        raise ValueError(
            f"stack_param_rows needs {meta.world_size} rows (one per rank "
            f"of the recorded world), got {len(rows_by_rank)}")
    leaves = [list(r.values()) if isinstance(r, dict) else list(r)
              for r in rows_by_rank]
    return ShardedParams([torch.stack([row[i] for row in leaves])
                          for i in range(len(meta.shapes))], meta)


def resident_param_bytes(params) -> int:
    """Per-rank resident parameter bytes: one row of every leaf of a
    :class:`ShardedParams`, or the shards an fsdp optimizer holds."""
    if isinstance(params, ShardedParams):
        total = sum(r.numel() * r.element_size() for r in params.rows)
        return total // max(1, params.world_size)
    return sum(s.numel() * s.element_size() for s in params.shards)


def reshard_after_forward() -> bool:
    """``HOROVOD_FSDP_RESHARD_AFTER_FORWARD`` (default on): gather each
    segment when the forward first reads it, release it after, and gather
    it again for its backward; ``0``: one gather of every parameter up front,
    held until the backward is done."""
    return env.get_str(env.FSDP_RESHARD_AFTER_FORWARD, "1").strip() != "0"


# A gathered leaf of fewer elements than this (a LayerNorm's gain, a bias)
# stays until the backward when autograd saves it: gathering it again would
# cost more launches than its bytes are worth.
KEEP_SAVED_BELOW = 1 << 16


def _owned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when it shares its storage (a view of a
    gathered bucket), so that each gathered leaf can be freed alone."""
    whole = t.numel() * t.element_size()
    if t.storage_offset() == 0 and t.untyped_storage().nbytes() == whole:
        return t
    return t.clone()


class _Record:
    """One gather: the full tensors of leaves ``idx`` (salted by ``salt``)
    and the leaves autograd saved for the backward. :meth:`free` releases
    what it holds: the saved leaves' storage is resized to nothing (autograd
    keeps the tensor objects), the others are dropped. :meth:`restore`
    gathers the saved leaves again (int8: the whole record, whose blocks
    span its buckets), through the same wire with the same salt, so to the
    same values, and refills their storage in place."""

    def __init__(self, opt, idx: Sequence[int], salt):
        self.opt, self.idx, self.salt = opt, tuple(idx), salt
        self.full: dict[int, torch.Tensor] = {}
        self.saved: set[int] = set()
        self.freed = False

    def gather(self, shards) -> list[torch.Tensor]:
        from .. import metrics, tracing

        nbytes = sum(self.opt.meta.template(i).numel()
                     * self.opt.wire_itemsize(self.opt.meta.dtypes[i])
                     for i in self.idx)
        metrics.PARAM_GATHER_BYTES.observe(nbytes, axis="batch")
        with tracing.span("param_allgather", "collective",
                          args={"bytes": nbytes, "leaves": len(self.idx)}):
            full = [_owned(t) for t in self.opt.gather_shards(
                self.idx, shards, self.salt)]
        self.full = dict(zip(self.idx, full))
        return full

    def free(self) -> None:
        if not self.freed:
            for i in self.saved:
                self.full[i].untyped_storage().resize_(0)
        self.full = {i: self.full[i] for i in self.saved}
        self.freed = bool(self.saved)

    def restore(self) -> None:
        if not self.freed:
            return
        # A cast wire rounds each value alone, so the saved leaves can be
        # gathered alone; int8 quantizes blocks of the whole bucket.
        idx = (self.idx if self.opt._int8
               else [i for i in self.idx if i in self.saved])
        with torch.no_grad():
            new = self.opt.gather_shards(
                idx, [self.opt.shards[i].detach() for i in idx], self.salt)
            for i, t in zip(idx, new):
                if i in self.saved:
                    old = self.full[i]
                    storage = old.untyped_storage()
                    storage.resize_(old.numel() * old.element_size())
                    # Written through an alias: the saved tensor's version
                    # counter stays as autograd recorded it.
                    alias = torch.empty(0, dtype=old.dtype, device=old.device)
                    alias.set_(storage, 0, old.shape, old.stride())
                    alias.copy_(t)
        self.freed = False


class _GatherBoundary(torch.autograd.Function):
    """Shards in, full tensors out, for one :class:`_Record`. Forward: one
    allgather per bucket through the optimizer's wire. Backward: the full
    gradients reduce-scattered through the same wire (op, compression,
    scaling, buckets issued last first), landing as the shards' gradients;
    then the record is freed. The int8 rounding salt of the step rides in
    the record."""

    @staticmethod
    def forward(ctx, rec, *shards):
        ctx.rec = rec
        return tuple(rec.gather([s.detach() for s in shards]))

    @staticmethod
    def backward(ctx, *grads):
        rec = ctx.rec
        out = rec.opt.reduce_scatter(rec.idx, list(grads), rec.salt)
        rec.free()
        return (None, *out)


def _apply(rec: _Record, shards) -> list[torch.Tensor]:
    out = _GatherBoundary.apply(rec, *[shards[i] for i in rec.idx])
    return [out] if torch.is_tensor(out) else list(out)


def _segments(meta: ShardMeta, num_segments: int | None) -> list[list[int]]:
    if not reshard_after_forward():
        k = 1
    elif num_segments is not None:
        k = max(1, int(num_segments))
    else:
        k = fsdp_segments()
    return segment_leaves([(torch.Size(s).numel(), d)
                           for s, d in zip(meta.shapes, meta.dtypes)], k)


def gather_params(shards: Sequence[torch.Tensor], meta: ShardMeta, opt,
                  num_segments: int | None = None) -> list[torch.Tensor]:
    """Every full parameter from this rank's ``shards`` at once, one
    :class:`_GatherBoundary` per segment (``fusion.segment_leaves`` over
    the leaves' bytes: ``num_segments``, else ``fusion.fsdp_segments()``,
    or one segment when :func:`reshard_after_forward` is off), as the JAX
    package's ``gather_params`` does. Eagerly that holds every parameter
    in full until the backward; :class:`FsdpForward` gathers just in time
    instead. ``opt`` is the fsdp ``DistributedOptimizer`` whose wire both
    directions use. Differentiating through the result leaves reduced
    gradient shards in ``shards[i].grad``, segment by segment."""
    if len(shards) != len(meta.shapes):
        raise ValueError(
            f"gather_params: {len(shards)} shards vs {len(meta.shapes)} "
            "leaves: the shards must be the fsdp optimizer's")
    full: list = [None] * len(shards)
    for idx in _segments(meta, num_segments):
        for i, t in zip(idx, _apply(_Record(opt, idx, opt.salt), shards)):
            full[i] = t
    return full


class _Saved:
    """What the pack hook keeps of a saved gathered leaf."""

    __slots__ = ("rec", "t")

    def __init__(self, rec: _Record, t: torch.Tensor):
        self.rec, self.t = rec, t


class _Gathers:
    """One forward's just-in-time gathers (see :class:`FsdpForward`)."""

    def __init__(self, opt, segments: list[list[int]], reshard: bool,
                 held: set[int]):
        self.opt, self.salt, self.reshard = opt, opt.salt, reshard
        self.segments, self.held = segments, held
        self.reread: set[int] = set()
        self.seg_of = {i: k for k, idx in enumerate(segments) for i in idx}
        self.live: dict[int, torch.Tensor] = {}
        self.records: list[tuple[int | None, _Record]] = []
        self.by_storage: dict[int, tuple[_Record, int]] = {}
        self.started: set[int] = set()

    def get(self, i: int) -> torch.Tensor:
        t = self.live.get(i)
        if t is not None:
            return t
        k = self.seg_of[i]
        if i in self.held:
            idx, tag = [i], -1
        elif k in self.started:
            idx, tag = [i], None
            self.reread.add(i)
        else:
            self.started.add(k)
            for tk, rec in list(self.records):
                if tk is None or 0 <= tk < k - 1:
                    self._release(tk, rec)
            idx = [j for j in self.segments[k] if j not in self.held]
            tag = k
        rec = _Record(self.opt, idx, self.salt)
        for j, t in zip(idx, _apply(rec, self.opt.shards)):
            self.live[j] = t
            if self.reshard and t.numel() >= KEEP_SAVED_BELOW:
                self.by_storage[t.untyped_storage().data_ptr()] = (rec, j)
        self.records.append((tag, rec))
        return self.live[i]

    def _release(self, tag, rec: _Record) -> None:
        for j in rec.idx:
            t = self.live.pop(j, None)
            if t is not None and t.numel() >= KEEP_SAVED_BELOW:
                self.by_storage.pop(t.untyped_storage().data_ptr(), None)
        rec.free()
        self.records.remove((tag, rec))

    def close(self) -> None:
        for tag, rec in list(self.records):
            self._release(tag, rec)

    def pack(self, t: torch.Tensor):
        if t.layout is not torch.strided:
            return t
        hit = self.by_storage.get(t.untyped_storage().data_ptr())
        if hit is None:
            return t
        hit[0].saved.add(hit[1])
        return _Saved(hit[0], t)

    @staticmethod
    def unpack(x):
        if isinstance(x, _Saved):
            x.rec.restore()
            return x.t
        return x


class FsdpForward:
    """Runs a model's forward on just-in-time gathers of an fsdp
    optimizer's shards.

    Within :meth:`gathering`, each module that owns one of the optimizer's
    parameters reads it through a property (its class is swapped for a
    subclass, as ``torch.nn.utils.parametrize`` does), so any read of
    ``module.weight`` -- in the module's own forward or a parent's --
    reaches the gathers. A segment (``fusion.segment_leaves``; its count
    from ``num_segments``, else ``HOROVOD_FSDP_SEGMENTS`` or
    ``HOROVOD_OVERLAP_SEGMENTS``, read when this is built) is gathered when
    the forward first reads one of its parameters, through one
    :class:`_GatherBoundary`; a segment is released when the forward first
    reads a parameter two segments on, so at most two are held in full. A
    parameter read again after its segment was released (a tied embedding,
    read again by the output layer) is gathered alone, and its second
    reduce-scatter adds into the same shard gradient; from the next step on
    it leaves its segment, is gathered alone at its first read and is held
    to the end of the forward, so that its gradient is summed before one
    reduce-scatter, as in the JAX package. A saved-tensor hook
    marks the gathered tensors autograd keeps for the backward (those of at
    least ``KEEP_SAVED_BELOW`` elements); releasing a segment frees their
    storage, and the backward gathers them again (same wire, same salt, so
    the same values) when it first needs one, freeing them once the
    segment's reduce-scatter has run.

    Every rank's forward must read the parameters in the same order, and a
    parameter read must not be kept past its segment's release: a freed
    tensor raises when used. With ``HOROVOD_FSDP_RESHARD_AFTER_FORWARD=0``
    the first read gathers every parameter, and what autograd saved of
    them stays until the backward, with no hook and no second gather.
    """

    def __init__(self, model: torch.nn.Module, opt,
                 num_segments: int | None = None):
        index = {id(p): i for i, p in enumerate(opt._params)}
        owned: dict[int, tuple[torch.nn.Module, dict[str, int]]] = {}
        found: set[int] = set()
        for _, mod in model.named_modules():
            for name, p in mod._parameters.items():
                if p is not None and id(p) in index:
                    owned.setdefault(id(mod), (mod, {}))[1][name] = (
                        index[id(p)])
                    found.add(index[id(p)])
        if len(found) != len(index):
            raise ValueError(
                "the fsdp DistributedOptimizer holds parameters that are not "
                "the model's: build it over model.parameters()")
        self.opt = opt
        self.reshard = reshard_after_forward()
        self.segments = _segments(opt.meta, num_segments)
        self.held: set[int] = set()
        self._active: _Gathers | None = None
        self._swaps = []
        for mod, names in owned.values():
            cls = type(mod)
            props = {name: property(lambda _m, _i=i: self._active.get(_i))
                     for name, i in names.items()}
            self._swaps.append((mod, cls, type(cls.__name__, (cls,), props)))

    @contextlib.contextmanager
    def gathering(self):
        """Context manager: the model's parameter reads gather, until exit,
        which releases what the forward still holds."""
        gathers = _Gathers(self.opt, self.segments, self.reshard, self.held)
        hooks = (torch.autograd.graph.saved_tensors_hooks(
            gathers.pack, gathers.unpack) if self.reshard
            else contextlib.nullcontext())
        self._active = gathers
        for mod, _, sub in self._swaps:
            mod.__class__ = sub
        try:
            with hooks:
                yield
        finally:
            for mod, cls, _ in self._swaps:
                mod.__class__ = cls
            self._active = None
            gathers.close()
            self.held |= gathers.reread
