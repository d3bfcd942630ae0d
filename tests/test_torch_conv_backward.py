"""The port's 1x1 convolution (horovod_tpu_torch.ops.conv_backward) against
the JAX package's ``conv1x1`` and its Pallas ``dw_1x1`` kernel.

On the CPU the port's ``dw_1x1`` computes its plain PyTorch version; the JAX
side runs its Pallas kernel in interpret mode. Inputs are made by numpy from
a seed and go through both in float32. Tolerances are those of
``tests/test_conv_backward.py``: 1e-4 for the forward, whose sums are short
(Cin terms); 1e-3 for dw and dx, whose sums over many rows are taken in
another order on each side.

The ``cuda`` tests hold the hand-written kernel against its plain version on
the card; they skip where there is no GPU.
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel is CUDA C++ for "
                    "sm_90a and has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,cout,strides", [
    (torch.bfloat16, (4, 14, 14, 64), 256, (1, 1)),
    (torch.bfloat16, (4, 14, 14, 256), 512, (2, 2)),
    (torch.float32, (3, 7, 11, 72), 40, (1, 1))])
def test_kernel_matches_plain_version_on_the_card(cuda_device, dtype, shape,
                                                  cout, strides):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(*shape, generator=gen, device=cuda_device).to(dtype)
    w = (0.1 * torch.randn(1, 1, shape[-1], cout, generator=gen,
                           device=cuda_device)).to(dtype)
    xs = x[:, ::strides[0], ::strides[1], :]
    dy = torch.randn(xs.shape[:3].numel(), cout, generator=gen,
                     device=cuda_device).to(dtype)
    before = _kernels.DW_1X1.launches
    got = port.dw_1x1(xs, dy)
    want = port.dw_1x1_plain(xs, dy)
    assert _kernels.DW_1X1.launches == before + 1
    # Both sum in fp32 over the same products, in another order.
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()
    xg = x.detach().requires_grad_()
    wg = w.detach().requires_grad_()
    out = port.conv1x1(xg, wg, strides)
    out.backward(dy.reshape(out.shape))
    dx, dw = port.conv1x1_backward(x, w, dy.reshape(out.shape), strides,
                                   port.dw_1x1_plain)
    assert torch.equal(xg.grad, dx)
    assert (wg.grad.float() - dw.float()).abs().max().item() <= (
        2e-2 if dtype == torch.bfloat16 else 1e-4) * dw.float().abs().max().item()


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


def _view(name):
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


def _box_k_rows(grid, hb, b):
    """The K rows that box ``b`` of the bf16 kernel holds, as its producer
    loads them (``csrc/conv1x1_dw.cu``): grid rows [h0, h0 + hb) of image n,
    beside dy's rows from (n Hd + h0) Wd on; grid rows past Hd read as
    zeros."""
    hpb = -(-grid.Hd // hb)
    n, h0 = divmod(b, hpb)
    h0 *= hb
    first = (n * grid.Hd + h0) * grid.Wd
    return range(first, (n * grid.Hd + min(grid.Hd, h0 + hb)) * grid.Wd)


@pytest.mark.parametrize("name", sorted(_VIEWS))
def test_box_split_covers_every_row_once(name):
    _, x = _view(name)
    g = port.row_grid(tuple(x.shape), x.stride())
    K = g.Wd * g.Hd * g.Nd
    hb, rows = port.box_rows(g.Wd)
    assert rows % 16 == 0 and g.Wd * hb <= rows <= 256
    nboxes = g.Nd * math.ceil(g.Hd / hb)
    for tiles, sms in ((1, 132), (8, 132), (3, 7), (200, 132)):
        split, nsplit = port.split_boxes(nboxes, tiles, sms)
        assert (nsplit - 1) * split < nboxes <= nsplit * split
        seen = []
        for sp in range(nsplit):
            for b in range(sp * split, min(nboxes, (sp + 1) * split)):
                krows = _box_k_rows(g, hb, b)
                assert len(krows) <= g.Wd * hb
                seen.extend(krows)
        assert sorted(seen) == list(range(K)), (tiles, sms)


@pytest.mark.parametrize("Wd", [1, 7, 14, 15, 28, 41, 56, 129, 256])
def test_box_rows_are_whole_wgmma_steps(Wd):
    hb, rows = port.box_rows(Wd)
    assert rows % 16 == 0 and Wd * hb <= rows <= 256
    if Wd in (1, 7, 14, 28, 56):  # the ResNet-50 widths need no padding
        assert rows == Wd * hb and 64 <= rows <= 128


def test_box_rows_refuse_rows_wider_than_a_box():
    with pytest.raises(ValueError, match="at most 256"):
        port.box_rows(257)
