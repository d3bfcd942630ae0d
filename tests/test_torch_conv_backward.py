"""The port's 1x1 convolution (horovod_tpu_torch.ops.conv_backward) against
the JAX package's ``conv1x1`` and its Pallas ``dw_1x1`` kernel.

On the CPU the port's ``dw_1x1`` computes its plain PyTorch version; the JAX
side runs its Pallas kernel in interpret mode. Inputs are made by numpy from
a seed and go through both in float32. Tolerances are those of
``tests/test_conv_backward.py``: 1e-4 for the forward, whose sums are short
(Cin terms); 1e-3 for dw and dx, whose sums over many rows are taken in
another order on each side.

The kernel against its plain version on the card is in
``tests/test_torch_cuda.py``; the kernel's plans (the row grid of a view,
its boxes, and the copies made for channel counts that are no whole
16-byte row and for rows wider than a TMA box) are held here.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import conv_backward as jax_conv
from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.ops import conv_backward as port


def _conv_inputs(seed, shape=(2, 8, 8, 12), cout=20):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(1, 1, shape[-1], cout) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("strides", [(1, 1), (2, 2)])
def test_conv1x1_output_and_grads_match_jax(strides):
    x, w = _conv_inputs(1)

    def jax_loss(x, w):
        return jnp.sum(jax_conv.conv1x1(x, w, strides) ** 2)

    want_out = np.asarray(jax_conv.conv1x1(jnp.asarray(x), jnp.asarray(w),
                                           strides))
    want_dx, want_dw = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x),
                                                          jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    out = port.conv1x1(xt, wt, strides)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               rtol=1e-3, atol=1e-3)
    if strides == (2, 2):  # the taps the stride skips get no gradient
        assert np.all(xt.grad.numpy()[:, 1::2] == 0.0)


def test_dw_plain_matches_pallas_kernel_with_a_ragged_k():
    rng = np.random.RandomState(0)
    x = rng.randn(3000, 16).astype(np.float32)  # K is no multiple of 1024
    dy = rng.randn(3000, 24).astype(np.float32)
    want = np.asarray(jax_conv.dw_1x1(jnp.asarray(x), jnp.asarray(dy),
                                      tile=1024, interpret=True))
    got = port.dw_1x1_plain(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.dtype == torch.float32 and got.shape == (16, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_dw_plain_reads_a_strided_nhwc_view_like_its_copy():
    x, _ = _conv_inputs(3, shape=(2, 6, 6, 8))
    dy = np.random.RandomState(4).randn(2 * 3 * 3, 16).astype(np.float32)
    xs = torch.from_numpy(x)[:, ::2, ::2, :]
    want = port.dw_1x1_plain(xs.contiguous().reshape(-1, 8),
                             torch.from_numpy(dy))
    assert torch.equal(port.dw_1x1(xs, torch.from_numpy(dy)), want)


def test_conv1x1_bf16_path():
    x, w = _conv_inputs(2, shape=(2, 4, 4, 8), cout=16)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    out = port.conv1x1(xt, wt)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 4, 16)
    assert wt.grad.dtype == torch.bfloat16 and wt.grad.shape == (1, 1, 8, 16)
    assert xt.grad.dtype == torch.bfloat16 and xt.grad.shape == x.shape


def test_conv1x1_rejects_mixed_dtypes_and_non_1x1_filters():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="share a dtype"):
        port.conv1x1(x, torch.zeros(1, 1, 8, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=r"\[1, 1, Cin, Cout\]"):
        port.conv1x1(x, torch.zeros(3, 3, 8, 4))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    x, w = _conv_inputs(5)
    before = _kernels.DW_1X1.launches
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    port.conv1x1(xt, wt, (2, 2)).sum().backward()
    x2d = torch.from_numpy(x).reshape(-1, 12)
    dy = torch.ones(x2d.shape[0], 20)
    assert torch.equal(port.dw_1x1(x2d, dy), port.dw_1x1_plain(x2d, dy))
    assert _kernels.DW_1X1.launches == before


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(64, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        port.dw_1x1(x, torch.empty(64, 32, device="meta"))


# The bf16 kernel's plan, held on the CPU: the tensor map's row grid must
# address exactly the view's elements, and the boxes of the K split must
# hold every row once, each beside its own row of dy.
_VIEWS = {
    "2d": ((300, 16), None),
    "contiguous_nhwc": ((2, 5, 7, 16), (1, 1)),
    "stride2_even_h": ((2, 8, 6, 16), (2, 2)),
    "stride2_odd_h": ((3, 7, 10, 8), (2, 2)),
    "stride2_odd_h_odd_w": ((2, 9, 11, 24), (2, 2)),
    "one_row_per_image": ((4, 1, 6, 8), (1, 2)),
    "wide_rows_stride2_h": ((2, 4, 150, 8), (2, 1)),
    "narrow_w_sliced": ((2, 6, 8, 16), (1, 3)),
}


# Views whose plans are held without their elements (meta tensors carry
# the shape and strides): ResNet-50's stage 1 and stride-2 shortcut, and a
# contiguous ragged K (5 * 37 * 41 rows).
_PLAN_VIEWS = {
    "resnet50_stage1": ((128, 56, 56, 64), (1, 1)),
    "resnet50_shortcut_s2": ((128, 56, 56, 256), (2, 2)),
    "ragged_k": ((5, 37, 41, 72), (1, 1)),
}


def _view(name):
    if name in _PLAN_VIEWS:
        shape, strides = _PLAN_VIEWS[name]
        x = torch.empty(shape, device="meta")[:, ::strides[0], ::strides[1]]
        return None, x
    shape, strides = _VIEWS[name]
    flat = torch.arange(2 * math.prod(shape), dtype=torch.float64)
    x = flat[3 * 8:3 * 8 + math.prod(shape)].view(shape)
    if strides is not None:
        x = x[:, ::strides[0], ::strides[1], :]
    return flat, x


@pytest.mark.parametrize("name", sorted(_VIEWS))
def test_row_grid_addresses_exactly_the_elements_of_the_view(name):
    flat, x = _view(name)
    C = x.shape[-1]
    rows = x.reshape(-1, C)  # row k of K, as the kernel must see it
    g = port.row_grid(tuple(x.shape), x.stride())
    assert g.Wd * g.Hd * g.Nd == rows.shape[0]
    n, h, w = torch.meshgrid(torch.arange(g.Nd), torch.arange(g.Hd),
                             torch.arange(g.Wd), indexing="ij")
    start = x.storage_offset() + n * g.sn + h * g.sh + w * g.sw
    got = flat[start.reshape(-1, 1) + torch.arange(C)]
    assert torch.equal(got, rows)
    # Every stride of the map is a whole number of 16-byte bf16 rows.
    assert all(s % 8 == 0 for s in (g.sw, g.sh, g.sn))


def _box_k_rows(grid, hb, rows, b):
    """The K rows that box ``b`` of the kernels holds, as their producers
    load them (``csrc/conv1x1_dw.cu``): grid rows [h0, h0 + hb) of image n
    (or, for a grid row wider than ``rows``, piece p of ``wb`` rows of grid
    row h0), beside dy's rows from (n Hd + h0) Wd + p wb on; grid rows past
    Hd and rows past the piece's W read as zeros."""
    pieces = port.box_pieces(grid.Wd, hb, rows)
    wb = -(-grid.Wd // pieces)
    hpb = -(-grid.Hd // hb)
    n, rem = divmod(b, hpb * pieces)
    h0, w0 = rem // pieces * hb, rem % pieces * wb
    return [(n * grid.Hd + h) * grid.Wd + w
            for h in range(h0, min(grid.Hd, h0 + hb))
            for w in range(w0, min(grid.Wd, w0 + wb))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(_VIEWS) + sorted(_PLAN_VIEWS))
def test_box_split_covers_every_row_once(name, dtype):
    """The split of the boxes holds every row of K once, each box within
    its rows, a multiple of the product's depth: wgmma's 16 (bf16) or
    mma.sync's 8 (float32, whose boxes hold at most 56 rows)."""
    _, x = _view(name)
    g = port.row_grid(tuple(x.shape), x.stride())
    K = g.Wd * g.Hd * g.Nd
    hb, rows = port.box_rows(g.Wd, dtype)
    pieces = port.box_pieces(g.Wd, hb, rows)
    depth, most = (8, 56) if dtype == torch.float32 else (16, 256)
    assert rows % depth == 0 and rows <= most
    assert (pieces == 1 and g.Wd * hb <= rows) or (
        hb == 1 and -(-g.Wd // pieces) <= rows < g.Wd)
    nboxes = g.Nd * math.ceil(g.Hd / hb) * pieces
    for tiles, sms in ((1, 132), (8, 132), (3, 7), (200, 132)):
        split, nsplit = port.split_boxes(nboxes, tiles, sms)
        assert (nsplit - 1) * split < nboxes <= nsplit * split
        seen = []
        for sp in range(nsplit):
            for b in range(sp * split, min(nboxes, (sp + 1) * split)):
                krows = _box_k_rows(g, hb, rows, b)
                assert len(krows) <= rows
                seen.extend(krows)
        assert sorted(seen) == list(range(K)), (tiles, sms)


@pytest.mark.parametrize("Wd", [1, 7, 14, 15, 28, 41, 56, 129, 256])
def test_box_rows_are_whole_wgmma_steps(Wd):
    hb, rows = port.box_rows(Wd)
    assert rows % 16 == 0 and Wd * hb <= rows <= 256
    if Wd in (1, 7, 14, 28, 56):  # the ResNet-50 widths need no padding
        assert rows == Wd * hb and 64 <= rows <= 128


@pytest.mark.parametrize("Wd", [1, 5, 7, 14, 15, 28, 41, 56, 57, 150, 256])
def test_float32_box_rows_are_whole_mma_steps(Wd):
    """float32 boxes: whole m16n8k8 steps of 8 rows, at most 56 rows (three
    stages of x's 64 and dy's 256 fp32 channels fill shared memory); the
    ResNet-50 widths need no padding; a grid row wider than 56 is read in
    pieces of at most 56 rows."""
    hb, rows = port.box_rows(Wd, torch.float32)
    pieces = port.box_pieces(Wd, hb, rows)
    assert rows % 8 == 0 and rows <= 56
    if Wd <= 56:
        assert pieces == 1 and Wd * hb <= rows
    else:
        assert hb == 1 and pieces == -(-Wd // 56)
        assert -(-Wd // pieces) <= rows < -(-Wd // pieces) + 8
    if Wd in (1, 7, 14, 28, 56):
        assert rows == Wd * hb == 56


def test_box_rows_refuse_rows_wider_than_a_box():
    with pytest.raises(ValueError, match="at most 256"):
        port.box_rows(257)


# Views the kernels cannot read in place: name -> (shape, strides, Cout).
# int16 stands for the 2-byte types and int32 for float32: their values
# address exactly. 12 channels are whole 16-byte rows in float32, so that
# view is read in place there.
_COPIED = {
    "cin3_cout12": ((4, 5, 6, 3), (1, 1), 12),
    "cin12_stride2": ((2, 6, 8, 12), (2, 2), 20),
    "w300_stride2": ((1, 4, 600, 8), (2, 2), 16),
    "w300_stride2_cin3": ((2, 4, 600, 3), (2, 2), 5),
}


@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in sorted(_COPIED)
    for dtype in (torch.int16, torch.int32)
    if (name, dtype) != ("cin12_stride2", torch.int32)])
def test_copy_plans_address_exactly_the_elements_of_the_view(name, dtype):
    shape, strides, cout = _COPIED[name]
    vec = 16 // dtype.itemsize
    flat = torch.arange(8 + math.prod(shape), dtype=dtype)
    x = flat[8:8 + math.prod(shape)].view(shape)[:, ::strides[0],
                                                 ::strides[1], :]
    C = x.shape[-1]
    rows = x.reshape(-1, C)
    dy = torch.arange(rows.shape[0] * cout, dtype=dtype).reshape(-1, cout)
    xk, dyk = port.dw_operands(x, dy)
    assert xk is not x and xk.is_contiguous()
    # The copies: every row of the view once, zero channels to a whole
    # 16-byte row, read by the kernel in place (one grid row of K rows).
    assert xk.shape[-1] % vec == 0 and dyk.shape[1] % vec == 0
    assert xk.shape[-1] - C < vec and dyk.shape[1] - cout < vec
    g = port.row_grid(tuple(xk.shape), xk.stride())
    assert g.Wd <= 256 and g.Wd * g.Hd * g.Nd == rows.shape[0]
    n, h, w = torch.meshgrid(torch.arange(g.Nd), torch.arange(g.Hd),
                             torch.arange(g.Wd), indexing="ij")
    start = xk.storage_offset() + n * g.sn + h * g.sh + w * g.sw
    got = xk.reshape(-1)[start.reshape(-1, 1) + torch.arange(xk.shape[-1])]
    assert torch.equal(got[:, :C], rows) and not got[:, C:].any()
    assert torch.equal(dyk[:, :cout], dy) and not dyk[:, cout:].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["contiguous_nhwc", "stride2_even_h",
                                  "stride2_odd_h", "wide_rows_stride2_h"])
def test_views_the_kernel_reads_in_place_are_not_copied(name, dtype):
    """Views within 256 grid rows (W = 150 in ``wide_rows_stride2_h``) are
    read where they lie, in bf16 and in float32."""
    shape, strides = _VIEWS[name]
    x = torch.zeros(shape, dtype=dtype)
    x = x[:, ::strides[0], ::strides[1], :]
    dy = torch.zeros(x.shape[:3].numel(), 64, dtype=dtype)
    xk, dyk = port.dw_operands(x, dy)
    assert xk is x and dyk is dy


@pytest.mark.parametrize("name,K,ci,co,bound,by,fma", [
    # Stage 1: 513.9 MB at 3.35 TB/s; 39.45 GFLOP of TF32 would take 0.0797.
    ("resnet50_stage1", 401408, 64, 256, 0.1534, "bytes", 0.1963),
    # The shortcut: 78.9 GFLOP of TF32 at 495 TFLOP/s; 308.8 MB 0.0922.
    ("resnet50_shortcut_s2", 100352, 256, 512, 0.1594, "operations",
     0.3926)])
def test_chip_smoke_bounds_the_float32_filter_gradient_in_3xtf32(
        name, K, ci, co, bound, by, fma):
    """chip_smoke.py holds the float32 filter gradient (3xTF32) to the
    larger of its bytes over 3.35 TB/s and three TF32 products at 495
    TFLOP/s, with its bound at the FMA peak beside it; bf16 has no second
    bound."""
    from test_torch_attention import _chip_smoke

    smoke = _chip_smoke()
    (ms, got_by, flops, moved), fma_ms = smoke._dw_bounds(K, ci, co,
                                                          "float32")
    assert round(ms, 4) == bound and got_by == by
    assert flops == 3 * 2 * K * ci * co
    assert moved == 4 * K * (ci + co) + 4 * ci * co
    assert round(fma_ms, 4) == fma
    assert smoke._dw_bounds(K, ci, co, "bfloat16")[1] is None
