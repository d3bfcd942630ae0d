"""1x1 convolution whose filter gradient is a hand-written CUDA kernel.

Port of ``horovod_tpu/ops/conv_backward.py``. The public face keeps the JAX
package's layouts: ``x`` is NHWC and ``w`` is HWIO ``[1, 1, Cin, Cout]``,
so weights pass between the two packages as they are (no converter is
needed). As there, :func:`conv1x1` is an opt-in entry point: no model of
the port calls it.

- Forward: ``out = x_s @ w[0, 0]`` over the strided view ``x_s`` of ``x``,
  accumulated in fp32 and returned in ``x.dtype``.
- ``dx = dy @ w[0, 0]^T``, accumulated in fp32 and returned in
  ``x.dtype``, scattered into zeros for strided convolutions. The forward
  and dx are plain products that the JAX package left to XLA; here they
  are ``torch.matmul`` in float32.
- ``dw = x_s^T dy`` in fp32 is :func:`dw_1x1`, the kernel
  (``csrc/conv1x1_dw.cu``), cast to ``w.dtype``.

:func:`dw_1x1` launches the kernel for CUDA tensors and computes its plain
version, :func:`dw_1x1_plain`, for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import _kernels

_KERNEL_DTYPES = {torch.float32: _kernels.DTYPE_F32,
                  torch.bfloat16: _kernels.DTYPE_BF16}
# float32 kernel: channels of one output tile, and rows per step.
_TILE = 64
_BLOCKS_PER_SM = 4  # its split of K aims at this many blocks per SM
# bf16 kernel: a block tile's input and output channels, the most rows of a
# TMA box dimension, and wgmma's depth in rows.
_CI_TILE, _CO_TILE = 64, 256
_BOX_MAX = 256
_DEPTH = 16


def dw_1x1_plain(x2d, dy2d):
    """``x2d^T dy2d`` in fp32: ``x2d [K, Cin]`` (or an NHWC view whose rows
    are the K rows), ``dy2d [K, Cout]`` -> ``dw [Cin, Cout]`` float32."""
    x2d = x2d.reshape(-1, x2d.shape[-1])
    return torch.matmul(x2d.float().transpose(0, 1), dy2d.float())


@dataclasses.dataclass(frozen=True)
class RowGrid:
    """The rows of ``x`` as a grid ``(Nd, Hd, Wd)``, W fastest: row
    ``k = (n Hd + h) Wd + w`` starts ``n sn + h sh + w sw`` elements after
    ``x``'s first element. The kernels read ``x`` through it in place."""

    Wd: int
    Hd: int
    Nd: int
    sw: int
    sh: int
    sn: int


def row_grid(shape, strides):
    """The :class:`RowGrid` of an ``[K, C]`` or ``[N, H, W, C]`` tensor of
    this shape and these element strides: one grid row of K rows where the
    rows are evenly spaced, else ``(N H, W)`` where images follow each other
    evenly, else ``(N, H, W)``."""
    if len(shape) == 2:
        return RowGrid(1, shape[0], 1, strides[0], strides[0],
                       shape[0] * strides[0])
    N, H, W, _ = shape
    sn, sh, sw, _ = strides
    K = N * H * W
    dims = [(n, st) for n, st in ((N, sn), (H, sh), (W, sw)) if n > 1]
    if all(outer == n * st for (_, outer), (n, st) in zip(dims, dims[1:])):
        rs = dims[-1][1] if dims else sw
        return RowGrid(1, K, 1, rs, rs, K * rs)
    if H == 1:  # the images are the grid rows
        sh = sn
    if N == 1 or sn == H * sh:
        return RowGrid(W, N * H, 1, sw, sh, N * H * sh)
    return RowGrid(W, H, N, sw, sh, sn)


def box_rows(Wd):
    """``(hb, rows)`` of the bf16 kernel's boxes for grid rows of ``Wd``: a
    box of x is ``hb`` whole grid rows (``Wd hb`` rows of K), padded to
    ``rows``, a multiple of wgmma's depth of 16. The largest ``hb`` whose
    rows need no padding and number 64 to 112 (three stages of 112 rows
    kept the most bytes in flight on an H100); where there is none, about
    128 rows with padding (at most 256, the box limit)."""
    if not 1 <= Wd <= _BOX_MAX:
        raise ValueError(
            f"the bf16 dw_1x1 kernel reads at most {_BOX_MAX} rows of W at a "
            f"time; got W = {Wd}")
    for hb in range(112 // Wd, 0, -1):
        if Wd * hb % _DEPTH == 0 and Wd * hb >= 64:
            return hb, Wd * hb
    hb = max(1, 128 // Wd)
    return hb, -(-Wd * hb // _DEPTH) * _DEPTH


def split_boxes(nboxes, tiles, sms):
    """``(split, nsplit)``: the boxes of K go in ``nsplit`` ranges of
    ``split`` boxes (the last may be shorter), so that ``nsplit * tiles``
    work items come to about one per SM."""
    want = max(1, min(nboxes, sms // tiles))
    split = -(-nboxes // want)
    return split, -(-nboxes // split)


def dw_1x1(x2d, dy2d):
    """Filter gradient of a 1x1 conv: ``x2d [K, Cin]``, ``dy2d [K, Cout]``
    -> ``dw [Cin, Cout]`` float32.

    ``x2d`` may also be an NHWC view ``[N, H, W, Cin]`` with unit channel
    stride, such as the strided slice of a stride-2 convolution: the kernel
    reads its rows in place, with no copy.
    """
    if x2d.device.type == "cpu":
        return dw_1x1_plain(x2d, dy2d)
    if x2d.device.type != "cuda":
        raise ValueError(
            f"dw_1x1 takes CPU or CUDA tensors; got {x2d.device}")
    dtype = x2d.dtype
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"dw_1x1 takes bfloat16 or float32; got {dtype}")
    if x2d.dim() not in (2, 4) or dy2d.dim() != 2:
        raise ValueError(
            f"dw_1x1 takes x [K, Cin] or [N, H, W, Cin] and dy [K, Cout]; "
            f"got {tuple(x2d.shape)} and {tuple(dy2d.shape)}")
    ci, co = x2d.shape[-1], dy2d.shape[1]
    K = x2d.numel() // ci if ci else 0
    vec = 16 // x2d.element_size()
    if (dy2d.dtype != dtype or dy2d.device != x2d.device
            or dy2d.shape[0] != K):
        raise ValueError(
            f"dy must be [{K}, Cout] in {dtype} on {x2d.device}; got "
            f"{dy2d.dtype} {tuple(dy2d.shape)} on {dy2d.device}")
    grid = row_grid(tuple(x2d.shape), x2d.stride())
    if (K == 0 or ci % vec or co % vec or x2d.stride(-1) != 1
            or any(s % vec for s in (grid.sn, grid.sh, grid.sw))
            or x2d.data_ptr() % 16
            or not dy2d.is_contiguous() or dy2d.data_ptr() % 16):
        raise ValueError(
            f"dw_1x1 needs K > 0, Cin and Cout multiples of {vec}, unit "
            f"channel stride, row strides that are multiples of {vec}, a "
            "contiguous dy and 16-byte aligned operands; got "
            f"x {tuple(x2d.shape)} strides {x2d.stride()}, dy "
            f"{tuple(dy2d.shape)}")
    if K >= 2**31:
        raise ValueError(f"dw_1x1 takes fewer than 2**31 rows; got {K}")
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    if dtype == torch.bfloat16:
        hb, rows = box_rows(grid.Wd)
        tiles = math.ceil(ci / _CI_TILE) * math.ceil(co / _CO_TILE)
        split, nsplit = split_boxes(grid.Nd * math.ceil(grid.Hd / hb), tiles,
                                    sms)
    else:
        hb, rows = 0, 0
        tiles = math.ceil(ci / _TILE) * math.ceil(co / _TILE)
        nsplit = max(1, min(math.ceil(_BLOCKS_PER_SM * sms / tiles),
                            math.ceil(K / _TILE), 65535))
        split = math.ceil(math.ceil(K / nsplit) / _TILE) * _TILE
        nsplit = math.ceil(K / split)
    out = torch.empty(ci, co, dtype=torch.float32, device=x2d.device)
    part = (torch.empty(nsplit, ci, co, dtype=torch.float32,
                        device=x2d.device) if nsplit > 1 else out)
    with torch.cuda.device(x2d.device):
        _kernels.launch(
            _kernels.DW_1X1, x2d.data_ptr(), dy2d.data_ptr(),
            part.data_ptr(), out.data_ptr(), K, ci, co, nsplit, split, hb,
            rows, grid.Wd, grid.Hd, grid.Nd, grid.sw, grid.sh, grid.sn,
            _KERNEL_DTYPES[dtype],
            torch.cuda.current_stream(x2d.device).cuda_stream)
    return out


def _strided(x, strides):
    if tuple(strides) == (1, 1):
        return x
    return x[:, ::strides[0], ::strides[1], :]


def _conv1x1_forward(x, w, strides):
    out = torch.matmul(_strided(x, strides).float(), w[0, 0].float())
    return out.to(x.dtype)


def conv1x1_backward(x, w, dy, strides=(1, 1), dw_fn=dw_1x1):
    """``(dx, dw)`` of :func:`conv1x1` for the output cotangent ``dy``;
    ``dw_fn`` computes the filter gradient (the kernel by default,
    :func:`dw_1x1_plain` for the plain counterpart)."""
    xs = _strided(x, strides)
    co = dy.shape[-1]
    dy2 = dy.reshape(-1, co).contiguous()
    dxs = torch.matmul(dy2.float(), w[0, 0].float().transpose(0, 1))
    dxs = dxs.reshape(xs.shape).to(x.dtype)
    if tuple(strides) == (1, 1):
        dx = dxs
    else:
        dx = torch.zeros_like(x)
        dx[:, ::strides[0], ::strides[1], :] = dxs
    dw = dw_fn(xs, dy2)
    return dx, dw.to(w.dtype)[None, None]


class _Conv1x1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, strides):
        ctx.save_for_backward(x, w)
        ctx.strides = strides
        return _conv1x1_forward(x, w, strides)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = conv1x1_backward(x, w, dy, ctx.strides)
        return dx, dw, None


def conv1x1(x, w, strides=(1, 1)):
    """1x1 convolution, NHWC ``x [N, H, W, Cin]`` with HWIO
    ``w [1, 1, Cin, Cout]`` -> ``[N, H', W', Cout]``, differentiable, with
    the filter gradient computed by the :func:`dw_1x1` kernel."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (1, 1):
        raise ValueError(
            f"conv1x1 takes NHWC x and [1, 1, Cin, Cout] w; got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise ValueError(
            f"conv1x1 operands must share a dtype; got x={x.dtype}, "
            f"w={w.dtype}")
    return _Conv1x1.apply(x, w, tuple(int(s) for s in strides))
