"""Gradient compression for the wire leg of allreduce.

Port of ``horovod_tpu/compression.py`` (:32-101): ``Compression.none``,
the fp16 / bf16 wire casts and the int8 wire. A cast compressor is a pair
of functions used around the collective: ``compress(tensor) ->
(wire_tensor, ctx)`` and ``decompress(wire_tensor, ctx) -> tensor``.
``Compression.int8`` changes the exchange itself (``ops/quantization.py``)
and is a marker for the ``DistributedOptimizer``'s paths only.
"""

from __future__ import annotations

import torch


class Compressor:
    """Base compressor: subclasses override compress/decompress."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        del ctx
        return tensor


class NoneCompressor(Compressor):
    """Identity (default)."""


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = None

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), ctx
        return tensor, ctx

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            return tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    """Cast float grads to float16 on the wire (reference parity)."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """Cast float grads to bfloat16 on the wire."""

    wire_dtype = torch.bfloat16


class Int8Compressor(Compressor):
    """Int8 wire: a blockwise-quantized exchange (all-to-all of int8 chunks
    and scales, a float32 sum on each rank, an int8 allgather) at about 2
    bytes per element on the wire against bf16's 4. int8 values cannot be
    summed on the wire, so the ``DistributedOptimizer`` routes this marker
    through ``ops.quantization`` (allreduce: ``int8_fused_allreduce``;
    sharded and fsdp: ``int8_fused_reducescatter`` and
    ``int8_fused_allgather_shards``). Used as a plain compressor it
    raises."""

    marker = "int8"

    @staticmethod
    def compress(tensor):
        raise ValueError(
            "Compression.int8 changes the exchange itself and only composes "
            "with the DistributedOptimizer (ops.quantization."
            "int8_fused_allreduce); use Compression.fp16/bf16 for plain wire "
            "casts")

    @staticmethod
    def decompress(tensor, ctx):
        del ctx
        return Int8Compressor.compress(tensor)


class Compression:
    """Namespace mirroring ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
