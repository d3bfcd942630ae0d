"""Int8 quantized exchanges for the gradient wire (EQuARX-style).

Port of ``horovod_tpu/ops/quantization.py``: ``BLOCK`` (:42), ``_sround``
(:45), ``_quantize_blocks`` (:84), ``int8_allreduce_flat`` (:120),
``_reduce_scattered_rows`` (:180), ``int8_two_level_allreduce_flat``
(:204), ``int8_alltoall_rows`` (:265),
``int8_fused_reducescatter`` (:318), ``int8_fused_allgather_shards``
(:383) and ``int8_fused_allreduce`` (:444). Summing int8 contributions on
the wire would overflow, so the exchange changes shape:

1. quantize each block of ``BLOCK`` values to int8 with one float32 scale
   (stochastic rounding);
2. ``all_to_all_single`` the int8 chunks and their scales: rank j receives
   every rank's contribution to chunk j, with no sum on the wire;
3. dequantize and sum in float32 locally (Average divides by n);
4. quantize the reduced chunk again and ``all_gather`` it with its scales;
5. dequantize.

The rounding offset comes from a hash of each value's own bits, salted by
a caller's step counter, so the port rounds bit for bit as the JAX package
does. These are plain torch ops and NCCL (gloo on the CPU) collectives, as
the JAX package computes them in ``jnp`` outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .collective_ops import _all_gather, wait
from .comms_planner import dispatch_plan
from .fusion import (_issue_order, _pack_shard_rows, _split_shard_row,
                     bucket_leaves, nonfinite_action, shard_ownership)

BLOCK = 1024  # elements per quantization scale

# Saturation bound for non-finite quantizer input (largest finite float32).
_F32_MAX = float(torch.finfo(torch.float32).max)
_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant
    ``c`` < 2**32, exactly: the product is taken in two 16-bit halves of x
    so no int64 intermediate overflows."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def _sround(x: torch.Tensor, salt=None) -> torch.Tensor:
    """Stochastically round float32 ``x`` to int8 in [-127, 127].

    The uniform offset is a multiplicative hash of the value's own bits
    (uint32 arithmetic, emulated exactly in int64), with ``salt`` (a step
    counter: an int or a one-element integer tensor) folded in as
    ``salt * 0x9E3779B9``, so a value that repeats across steps rounds
    differently from step to step."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    if salt is not None:
        bits = bits ^ ((int(salt) & _MASK32) * 0x9E3779B9 & _MASK32)
    h = _mul32(bits, 2654435761)
    h = h ^ (h >> 16)
    u = (h >> 8).to(torch.float32) * (2.0 ** -24)
    return torch.clamp(torch.floor(x + u), -127, 127).to(torch.int8)


def _tripwire_armed() -> bool:
    """Armed (``HOROVOD_NONFINITE_ACTION`` set), the quantizer passes
    non-finite input on detectably instead of saturating it away, so the
    tripwire's check after the reduction still fires."""
    return nonfinite_action() is not None


def _quantize_blocks(flat: torch.Tensor, salt=None):
    """[m] float32 -> (int8 [m], scales float32 [m / BLOCK]); m % BLOCK == 0.

    Unarmed tripwire: the input is saturated first (NaN -> 0, +-Inf ->
    +-float32 max). Armed: a block that holds a non-finite value gets scale
    = +Inf, so every value of it dequantizes non-finite on every rank."""
    rows = flat.reshape(-1, BLOCK)
    saturated = torch.clamp(
        torch.nan_to_num(rows, nan=0.0, posinf=_F32_MAX, neginf=-_F32_MAX),
        -_F32_MAX, _F32_MAX)
    scale = saturated.abs().amax(dim=1) / 127.0
    if _tripwire_armed():
        bad = ~torch.isfinite(rows).all(dim=1)
        scale = torch.where(bad, torch.full_like(scale, float("inf")), scale)
    safe = torch.where(torch.isfinite(scale) & (scale != 0.0), scale,
                       torch.ones_like(scale))
    q = _sround(saturated / safe[:, None], salt)
    return q.reshape(-1), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., r*BLOCK]`` with scales ``[..., r]`` -> float32."""
    blocks = q.reshape(*scale.shape, BLOCK).to(torch.float32)
    return (blocks * scale[..., None]).reshape(*scale.shape[:-1], -1)


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n)) if n else x


def _exchange_rows(q: torch.Tensor, scale: torch.Tensor, process_set):
    """All-to-all of ``(n, r*BLOCK)`` int8 rows and their ``(n, r)`` scales:
    row d goes to set rank d; returns what this rank received, in the same
    shapes (row s from set rank s)."""
    group = process_set.group
    recv_q = torch.empty_like(q)
    recv_s = torch.empty_like(scale)
    w1 = dist.all_to_all_single(recv_q, q.contiguous(), group=group,
                                async_op=True)
    w2 = dist.all_to_all_single(recv_s, scale.contiguous(), group=group,
                                async_op=True)
    wait(w1)
    wait(w2)
    return recv_q, recv_s


def _gather_rows(q: torch.Tensor, scale: torch.Tensor, process_set):
    """All-gather of this rank's int8 row and its scales: ``(n, R)`` and
    ``(n, r)``, row s from set rank s."""
    n = process_set.size()
    group = process_set.group
    gq = q.new_empty(n * q.numel())
    gs = scale.new_empty(n * scale.numel())
    w1 = _all_gather(gq, q.contiguous(), group=group,
                                     async_op=True)
    w2 = _all_gather(gs, scale.contiguous(), group=group,
                                     async_op=True)
    wait(w1)
    wait(w2)
    return gq.view(n, -1), gs.view(n, -1)


def int8_allreduce_flat(flat: torch.Tensor, process_set, op: str = "average",
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0, salt=None):
    """Quantized allreduce of a flat tensor over the set; returns float32
    of ``flat``'s shape (the caller casts back). A one-member set does only
    the quantize-dequantize round trip."""
    n = process_set.size()
    m = flat.numel()
    x = flat.reshape(-1).to(torch.float32)
    if prescale_factor != 1.0:
        x = x * prescale_factor
    if n <= 1:
        q, scale = _quantize_blocks(_pad(x, (-m) % BLOCK), salt)
        return _dequantize(q, scale)[:m] * postscale_factor
    chunk = -(-m // (n * BLOCK)) * BLOCK
    q, scale = _quantize_blocks(_pad(x, n * chunk - m), salt)
    total = _reduce_quantized(q.view(n, chunk), scale.view(n, -1), n, op,
                              process_set)
    q2, scale2 = _quantize_blocks(total, salt)
    gq, gs = _gather_rows(q2, scale2, process_set)
    out = _dequantize(gq, gs).reshape(-1)[:m]
    if postscale_factor != 1.0:
        out = out * postscale_factor
    return out


def _reduce_quantized(q, scale, n, op, process_set):
    """Exchange ``(n, R)`` int8 rows and ``(n, r)`` scales, then dequantize
    and sum in float32 what arrived: this rank's reduced row."""
    recv_q, recv_s = _exchange_rows(q, scale, process_set)
    total = _dequantize(recv_q, recv_s).sum(dim=0)
    if op == "average":
        total = total / n
    return total


def _reduce_scattered_rows(rows: torch.Tensor, process_set, n: int, op: str,
                           salt=None) -> torch.Tensor:
    """Quantized exchange of an ``(n, R')`` block (``R' % BLOCK == 0``):
    this rank ends with row r reduced (quantize, all-to-all, dequantize and
    sum; no second quantization). Returns the float32 row of length R'."""
    q, scale = _quantize_blocks(rows.reshape(-1), salt)
    return _reduce_quantized(q.view(n, -1), scale.view(n, -1), n, op,
                             process_set)


def int8_two_level_allreduce_flat(flat: torch.Tensor, process_set, islands,
                                  op: str = "average",
                                  prescale_factor: float = 1.0,
                                  postscale_factor: float = 1.0, salt=None):
    """Two-level int8 allreduce of a flat tensor, quantized per leg: the
    comms planner's ``two_level`` schedule for the int8 wire (reference
    ``horovod_tpu/ops/quantization.py:204``), on the planner's subgroups
    (``comms_planner._two_level_groups``).

    1. A quantized reduce-scatter within the island (int8 all-to-all over
       the island, dequantize and sum): each rank keeps 1/L of the
       payload.
    2. A quantized allreduce of that shard across islands
       (:func:`int8_allreduce_flat` over the ranks of its position).
    3. A quantized allgather within the island.

    Each leg quantizes its own input with its own block scales, so the
    wire is int8 end to end. Returns float32 of ``flat``'s shape."""
    from .comms_planner import _two_level_groups

    g = _two_level_groups(islands)
    local, cross = g.local[g.island], g.cross[g.position]
    L, G = local.size(), cross.size()
    m = flat.numel()
    x = flat.reshape(-1).to(torch.float32)
    if prescale_factor != 1.0:
        x = x * prescale_factor
    chunk = -(-m // (L * BLOCK)) * BLOCK
    shard = _reduce_scattered_rows(_pad(x, L * chunk - m).view(L, chunk),
                                   local, L, "sum", salt)
    shard = int8_allreduce_flat(shard, cross, op="sum", salt=salt)
    if op == "average":
        shard = shard / (L * G)
    q, scale = _quantize_blocks(shard, salt)
    gq, gs = _gather_rows(q, scale, local)
    out = _dequantize(gq, gs).reshape(-1)[:m]
    if postscale_factor != 1.0:
        out = out * postscale_factor
    return out


def int8_alltoall_rows(rows: torch.Tensor, process_set, salt=None,
                       extra: torch.Tensor | None = None):
    """Quantized all-to-all of per-destination rows: ``rows`` is ``(n, R)``
    float32, row d addressed to set rank d. Each row is quantized by
    blocks, the int8 payload and a float32 side channel (the scales, and
    ``extra``'s ``(n, k)`` values carried exactly) ride two all-to-alls.
    Returns ``(received rows (n, R) float32, received extra or None)``."""
    n, R = rows.shape
    rp = _pad(rows.to(torch.float32), (-R) % BLOCK)
    q, scale = _quantize_blocks(rp.reshape(-1), salt)
    r = rp.shape[1] // BLOCK
    scale = scale.view(n, r)
    side = scale if extra is None else torch.cat(
        [scale, extra.to(torch.float32)], dim=1)
    recv_q, recv_side = _exchange_rows(q.view(n, -1), side, process_set)
    out = _dequantize(recv_q, recv_side[:, :r].contiguous())[:, :R]
    return out, (None if extra is None else recv_side[:, r:])


def _own_row(full: torch.Tensor, s: int, process_set) -> torch.Tensor:
    n = process_set.size()
    padded = _pad(full.reshape(-1), n * s - full.numel())
    r = process_set.rank()
    return padded[r * s:(r + 1) * s]


def int8_fused_reducescatter(tensors, process_set, op: str = "average",
                             threshold_bytes: int | None = None,
                             prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0, salt=None,
                             issue_reversed: bool = False):
    """The int8 gradient half of the sharded modes: the buckets and
    ownership map of ``fusion.fused_reducescatter``, each bucket one
    quantized exchange. Returns this rank's owned 1-D shards as float32
    (callers cast); non-float leaves are allreduced and sliced."""
    from .collective_ops import allreduce, direct

    n = process_set.size()
    sizes = shard_ownership([t.numel() for t in tensors], n)
    out: list = [None] * len(tensors)
    float_idx = [i for i, t in enumerate(tensors) if t.is_floating_point()]
    for i, t in enumerate(tensors):
        if not t.is_floating_point():
            with direct():  # the optimizer's wire: never negotiated
                full = allreduce(t, op=op, prescale_factor=prescale_factor,
                                 postscale_factor=postscale_factor,
                                 process_set=process_set)
            out[i] = _own_row(full, sizes[i], process_set)
    floats = [tensors[i].detach().reshape(-1).to(torch.float32)
              for i in float_idx]
    fsizes = [sizes[i] for i in float_idx]
    buckets = bucket_leaves([(f.numel(), f.dtype) for f in floats],
                            threshold_bytes)
    for _, bucket in _issue_order(buckets, issue_reversed):
        bsizes = [fsizes[j] for j in bucket]
        rows = _pack_shard_rows([floats[j] for j in bucket], bsizes, n)
        if prescale_factor != 1.0:
            rows = rows * prescale_factor
        R = rows.shape[1]
        rows = torch.nn.functional.pad(rows, (0, (-R) % BLOCK))
        row = _reduce_scattered_rows(rows, process_set, n, op, salt)[:R]
        if postscale_factor != 1.0:
            row = row * postscale_factor
        for j, shard in zip(bucket, _split_shard_row(row, bsizes)):
            out[float_idx[j]] = shard
    return out


def int8_fused_allgather_shards(shards, templates, process_set,
                                threshold_bytes: int | None = None,
                                salt=None, issue_reversed: bool = False):
    """The int8 parameter half of the sharded modes: quantize this rank's
    owned shards (one row per bucket of ``bucket_leaves(templates)``),
    all-gather int8 and scales, dequantize and unpack to full tensors
    (the templates' shapes, float32; callers cast). Non-float templates are
    gathered as they are."""
    n = process_set.size()
    sizes = shard_ownership([t.numel() for t in templates], n)
    out: list = [None] * len(templates)
    float_idx = [i for i, t in enumerate(templates) if t.is_floating_point()]
    for i, t in enumerate(templates):
        if not t.is_floating_point():
            full = shards[i].new_empty(n * sizes[i])
            _all_gather(full, shards[i].contiguous(),
                                        group=process_set.group)
            out[i] = full[:t.numel()].view(t.shape)
    ftemplates = [templates[i] for i in float_idx]
    fsizes = [sizes[i] for i in float_idx]
    buckets = bucket_leaves([(t.numel(), t.dtype) for t in ftemplates],
                            threshold_bytes)
    for _, bucket in _issue_order(buckets, issue_reversed):
        row = torch.cat([shards[float_idx[j]].reshape(-1) for j in bucket]
                        ).to(torch.float32)
        R = row.numel()
        q, scale = _quantize_blocks(_pad(row, (-R) % BLOCK), salt)
        gq, gs = _gather_rows(q, scale, process_set)
        grid = _dequantize(gq, gs)[:, :R]
        offset = 0
        for j in bucket:
            s, t = fsizes[j], ftemplates[j]
            out[float_idx[j]] = (grid[:, offset:offset + s].reshape(-1)
                                 [:t.numel()].view(t.shape))
            offset += s
    return out


def int8_fused_allreduce(tensors, process_set, op: str = "average",
                         threshold_bytes: int | None = None,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0, salt=None,
                         issue_reversed: bool = False):
    """Bucketed int8 allreduce of a tensor list: the buckets of
    ``fusion.fused_allreduce`` over the float32 view of the float leaves,
    each one :func:`int8_allreduce_flat`; results in the leaves' dtypes.
    Non-float leaves ride an uncompressed allreduce."""
    from .collective_ops import allreduce, direct

    out: list = [None] * len(tensors)
    float_idx = [i for i, t in enumerate(tensors) if t.is_floating_point()]
    for i, t in enumerate(tensors):
        if not t.is_floating_point():
            with direct():  # the optimizer's wire: never negotiated
                out[i] = allreduce(t, op=op,
                                   prescale_factor=prescale_factor,
                                   postscale_factor=postscale_factor,
                                   process_set=process_set)
    floats = [tensors[i].detach().reshape(-1).to(torch.float32)
              for i in float_idx]
    buckets = bucket_leaves([(f.numel(), f.dtype) for f in floats],
                            threshold_bytes)
    for _, bucket in _issue_order(buckets, issue_reversed):
        packed = torch.cat([floats[j] for j in bucket])
        # The comms planner may take the two-level schedule (quantized per
        # leg) on a layout of several islands; rhd is no candidate: the
        # exchange is an all-to-all and an allgather, not a ring. The
        # bytes priced are the wire's, ~2 an element (int8 out and back).
        plan = dispatch_plan("allreduce", 2 * packed.numel(), process_set,
                             op, ("flat", "two_level"))
        if plan is not None:
            reduced = int8_two_level_allreduce_flat(
                packed, process_set, plan.islands, op, prescale_factor,
                postscale_factor, salt)
        else:
            reduced = int8_allreduce_flat(packed, process_set, op,
                                          prescale_factor, postscale_factor,
                                          salt)
        offset = 0
        for j in bucket:
            t = tensors[float_idx[j]]
            out[float_idx[j]] = (reduced[offset:offset + t.numel()]
                                 .view(t.shape).to(t.dtype))
            offset += t.numel()
    return out
