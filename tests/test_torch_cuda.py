"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels are CUDA C++
for ``sm_90a`` and have no CPU mode): they carry the ``cuda`` marker and
skip where there is no card. The file imports neither jax nor the JAX
package, so it runs on a machine that has only PyTorch, without the
suite's ``conftest.py`` (which starts the JAX package's world):

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances, as a share of the largest plain value: bf16 2e-2 and float16
5e-3 for the attention kernels (outputs, P and dS are rounded to 8 or 11
significant bits at points that can differ by one ulp between the two
summation orders), float32 1e-4; lse 1e-3 absolute. The filter gradient
sums exact products in fp32 on both sides: 1e-3 for 2-byte operands, 1e-4
for float32.
"""

import importlib.util
import os
import time

import pytest
import torch

from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.ops import attention as port
from horovod_tpu_torch.ops import conv_backward as conv

TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for "
                    "sm_90a and have no CPU mode)")
    return torch.device("cuda")


def _hold(pairs, dtype):
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == want.dtype
        if want.numel() == 0:
            continue
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[dtype] * want.float().abs().max().item()


def _attention_operands(device, seed, BH, Sq, Sk, D, dtype):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device=device).to(dt)

    q, k, v, do = rnd(BH, Sq, D), rnd(BH, Sk, D), rnd(BH, Sk, D), rnd(BH, Sq, D)
    return q, k, v, do, rnd(BH, Sq, dt=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,Sq,Sk,causal,q_offset,k_offset", [
    (torch.bfloat16, 64, 130, 96, False, 0, 0),
    (torch.bfloat16, 64, 130, 96, True, 0, 24),
    (torch.float32, 64, 130, 96, True, 30, 0),
    # The Hopper kernels at every head dim, on lengths that are no multiple
    # of their 64- or 128-row tiles, causal with offsets.
    (torch.bfloat16, 16, 200, 264, True, 0, 40),
    (torch.bfloat16, 32, 200, 264, True, 0, 40),
    (torch.bfloat16, 64, 200, 264, True, 0, 40),
    (torch.bfloat16, 128, 200, 264, True, 0, 40),
    (torch.bfloat16, 128, 264, 200, True, 64, 0),
    (torch.bfloat16, 32, 300, 300, False, 0, 0),
    # chip_smoke.py's single-tile shapes through the multi-tile kernels.
    (torch.bfloat16, 16, 128, 128, True, 0, 0),
    (torch.bfloat16, 32, 112, 128, True, 16, 0),
    (torch.bfloat16, 64, 77, 100, True, 0, 23),
    # float16, float32 at D = 128, and head dims zero-padded to the next
    # instance.
    (torch.float16, 64, 200, 264, True, 0, 40),
    (torch.float16, 128, 264, 200, False, 0, 0),
    (torch.float32, 128, 200, 136, True, 70, 0),
    (torch.bfloat16, 96, 200, 264, True, 0, 40),
    (torch.bfloat16, 48, 130, 96, False, 0, 0),
    (torch.float32, 8, 130, 96, True, 30, 0),
    # The D = 256 instances (head dims 129 to 256): ragged and causal with
    # offsets, a short sequence, float16 and float32, and D = 200 padded.
    (torch.bfloat16, 256, 200, 264, True, 0, 40),
    (torch.bfloat16, 256, 264, 200, True, 64, 0),
    (torch.bfloat16, 256, 77, 100, True, 0, 23),
    (torch.float16, 256, 264, 200, False, 0, 0),
    (torch.float16, 256, 200, 264, True, 0, 40),
    (torch.float32, 256, 200, 136, True, 70, 0),
    (torch.bfloat16, 200, 130, 96, False, 0, 0),
    (torch.float16, 200, 130, 96, False, 0, 0),
    (torch.float32, 160, 77, 100, True, 0, 23),
    # The wide-head kernels (D > 256) in each dtype: ragged, causal with
    # offsets and rows that see no key, D = 300 zero-padded to 320, and a
    # D = 1024 launch.
    (torch.bfloat16, 320, 200, 264, True, 0, 40),
    (torch.float16, 512, 264, 200, True, 64, 0),
    (torch.float32, 512, 130, 96, False, 0, 0),
    (torch.bfloat16, 300, 77, 100, True, 0, 23),
    (torch.float16, 1024, 64, 64, True, 0, 0)])
def test_kernels_match_plain_versions_on_the_card(cuda_device, dtype, D, Sq,
                                                  Sk, causal, q_offset,
                                                  k_offset):
    q, k, v, do, glse = _attention_operands(cuda_device, 0, 6, Sq, Sk, D,
                                            dtype)
    o, lse = port.flash_fwd(q, k, v, causal, q_offset, k_offset)
    o_ref, lse_ref = port.flash_fwd_plain(q, k, v, causal, q_offset, k_offset)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, glse, causal, q_offset, k_offset)
    _hold([(o, o_ref), (port.flash_dq(*args), port.flash_dq_plain(*args)),
           *zip(port.flash_dkv(*args), port.flash_dkv_plain(*args))], dtype)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    assert torch.equal(lse == port.LSE_MASKED, lse_ref == port.LSE_MASKED)


@pytest.mark.cuda
def test_float32_dq_dkv_at_head_dim_256_and_the_gemma_shape(cuda_device):
    """The 3xTF32 dQ and dK/dV (float32, D = 256) at a Gemma-like layer's
    shape, B*H = 128, S = 512: every work tile of a full grid, held to the
    plain versions at float32's 1e-4."""
    q, k, v, do, glse = _attention_operands(cuda_device, 3, 128, 512, 512,
                                            256, torch.float32)
    o_ref, lse_ref = port.flash_fwd_plain(q, k, v)
    delta = (do * o_ref).sum(-1)
    args = (q, k, v, do, lse_ref, delta, glse, False, 0, 0)
    _hold([(port.flash_dq(*args), port.flash_dq_plain(*args)),
           *zip(port.flash_dkv(*args), port.flash_dkv_plain(*args))],
          torch.float32)


def _hold_forward(fwd, kernel, q, k, v, causal, q_offset, k_offset):
    """A forward wrapper against the plain version (float32's 1e-4, lse
    1e-3, the same rows masked), launching ``kernel`` once."""
    before = kernel.launches
    o, lse = fwd(q, k, v, causal, q_offset, k_offset)
    assert kernel.launches == before + 1
    o_ref, lse_ref = port.flash_fwd_plain(q, k, v, causal, q_offset, k_offset)
    _hold([(o, o_ref)], q.dtype)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    assert torch.equal(lse == port.LSE_MASKED, lse_ref == port.LSE_MASKED)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Sq,Sk,causal,q_offset,k_offset", [
    # Causal and ragged with offsets, rows 0..39 seeing no key; a query
    # offset; a second 64-row half of Q only part full; D = 16 zero-padded
    # to the D = 32 instance.
    (64, 200, 264, True, 0, 40),
    (128, 200, 264, True, 0, 40),
    (256, 200, 264, True, 0, 40),
    (256, 264, 200, True, 64, 0),
    (256, 77, 100, True, 0, 23),
    (64, 77, 100, True, 0, 23),
    (32, 300, 300, False, 0, 0),
    (16, 130, 96, True, 30, 0)])
def test_float32_forward_runs_the_3xtf32_kernel(cuda_device, D, Sq, Sk,
                                                causal, q_offset, k_offset):
    """The multi-tile float32 forward (3xTF32 on the tensor cores) against
    the plain version."""
    q, k, v, _, _ = _attention_operands(cuda_device, 8, 6, Sq, Sk, D,
                                        torch.float32)
    _hold_forward(port.flash_fwd, _kernels.FLASH_FWD, q, k, v, causal,
                  q_offset, k_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Sq,Sk,causal,q_offset,k_offset", [
    # One key tile of 128 (the direct softmax); ragged with rows seeing no
    # key; keys and rows within one 64-row half (its second half never
    # loaded); D = 16 zero-padded to 32.
    (64, 128, 128, True, 16, 0),
    (128, 128, 128, True, 16, 0),
    (64, 77, 100, True, 0, 23),
    (128, 77, 100, True, 0, 23),
    (128, 50, 60, False, 0, 0),
    (32, 40, 40, True, 0, 0),
    (16, 96, 128, True, 0, 40)])
def test_float32_single_tile_forward_runs_the_3xtf32_kernel(
        cuda_device, D, Sq, Sk, causal, q_offset, k_offset):
    """The single-tile float32 forward (3xTF32) against the plain
    version."""
    q, k, v, _, _ = _attention_operands(cuda_device, 9, 6, Sq, Sk, D,
                                        torch.float32)
    _hold_forward(port.flash_fwd_single, _kernels.FLASH_FWD_SINGLE, q, k, v,
                  causal, q_offset, k_offset)


def _chip_smoke():
    """chip_smoke.py as a module (its top-level imports are the standard
    library's)."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.cuda
def test_float32_forward_holds_float64_at_the_gemma_shape(cuda_device):
    """At the Gemma-like layer's shape (B*H = 128, S = 512, D = 256) on full
    float32 values, the 3xTF32 forward's O and lse are within
    chip_smoke.py's F64_ERR_RATIO of the float32 plain version's error
    against float64 (its _f64_check raises otherwise)."""
    smoke = _chip_smoke()
    q, k, v, _, _ = _attention_operands(cuda_device, 10, 128, 512, 512, 256,
                                        torch.float32)
    smoke._f64_check("gemma_d256", q, k, v, None, port.flash_fwd(q, k, v),
                     port.flash_fwd_plain(q, k, v), False, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("D,BH,Sq,Sk,causal,q_offset,k_offset", [
    # Causal and ragged with a query offset at every instance; D = 8 and 16
    # zero-padded to 32, 100 to 128.
    (8, 6, 200, 136, True, 70, 0),
    (16, 6, 200, 136, True, 70, 0),
    (32, 6, 200, 136, True, 70, 0),
    (64, 6, 200, 136, True, 70, 0),
    (100, 6, 200, 136, True, 70, 0),
    (128, 6, 200, 136, True, 70, 0),
    (256, 6, 200, 136, True, 70, 0),
    # A key offset: rows 0..39 see no key (dQ = 0, lse = LSE_MASKED), and
    # keys of the last tiles see no row of a Q tile.
    (32, 6, 200, 264, True, 0, 40),
    (64, 6, 200, 264, True, 0, 40),
    (128, 6, 200, 264, True, 0, 40),
    (64, 6, 77, 100, False, 0, 0),
    # A part-full last wave: B*H = 70 at S = 512 (280 work tiles of 128
    # rows, 560 of 64, over 132 SMs).
    (64, 70, 512, 512, True, 0, 0),
    (128, 70, 512, 512, False, 0, 0),
    # No key or no query: dQ, or dK and dV, are zeros of the padded D
    # (memsets, no kernel).
    (16, 6, 100, 0, False, 0, 0),
    (64, 6, 100, 0, False, 0, 0),
    (128, 6, 0, 100, False, 0, 0),
    (256, 6, 0, 100, False, 0, 0),
    # BERT-Large's S = 512 shape, where the errors against float64 are
    # held too.
    (64, 128, 512, 512, False, 0, 0)])
def test_float32_backward_runs_the_3xtf32_kernel(cuda_device, D, BH, Sq, Sk,
                                                 causal, q_offset, k_offset):
    """The float32 multi-tile dQ and dK/dV launch their 3xTF32 instance at
    the planned head dim (launch counters and the profile's kernel names)
    and hold the plain versions at float32's 1e-4; at BERT-Large's S = 512
    shape on full float32 values their errors against float64 are within
    chip_smoke.py's F64_ERR_RATIO of the float32 plain version's."""
    smoke = _chip_smoke()
    q, k, v, do, glse = _attention_operands(cuda_device, 11, BH, Sq, Sk, D,
                                            torch.float32)
    f64 = BH == 128
    if f64:  # the float64 reference takes no lse cotangent
        glse = torch.zeros_like(glse)
    if Sk:
        o_ref, lse = port.flash_fwd_plain(q, k, v, causal, q_offset, k_offset)
        delta = (do * o_ref).sum(-1)
    else:
        lse = torch.full((BH, Sq), port.LSE_MASKED, device=cuda_device)
        delta = torch.zeros(BH, Sq, device=cuda_device)
    args = (q, k, v, do, lse, delta, glse, causal, q_offset, k_offset)
    kernels = (_kernels.FLASH_DQ, _kernels.FLASH_DKV)
    before = [kern.launches for kern in kernels]
    got = []
    ran = smoke._attention_kernels_ms(
        lambda: got.extend((port.flash_dq(*args), *port.flash_dkv(*args))))
    # One launch of each a run (the profile runs it again if its session
    # recorded nothing).
    assert [kern.launches for kern in kernels] == [n + len(got) // 3
                                                   for n in before]
    want = (port.flash_dq_plain(*args), *port.flash_dkv_plain(*args))
    _hold(zip(got, want), torch.float32)
    Dk = port.kernel_head_dim(D, port.instance_head_dims(torch.float32))
    assert Dk == {8: 32, 16: 32, 100: 128}.get(D, D)
    assert set(ran) == (set() if Sq * Sk == 0 else {
        f"flash_dq_3xtf32_kernel<{Dk}>", f"flash_dkv_3xtf32_kernel<{Dk}>"})
    if f64:
        smoke._f64_check("bert_large_s512", q, k, v, do, got, want, causal,
                         q_offset, k_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,Sq,Sk,causal,q_offset,k_offset", [
    (torch.bfloat16, 64, 128, 128, False, 0, 0),
    (torch.bfloat16, 128, 128, 128, False, 0, 0),
    (torch.bfloat16, 16, 96, 128, True, 0, 40),
    (torch.float32, 64, 128, 128, True, 16, 0),
    (torch.float32, 32, 50, 70, False, 0, 0),
    # The Hopper forward at D = 16 and 32, causal; lengths that are no
    # multiple of 16, rows 0..22 seeing no key.
    (torch.bfloat16, 16, 128, 128, True, 0, 0),
    (torch.bfloat16, 32, 112, 128, True, 16, 0),
    (torch.bfloat16, 64, 77, 100, True, 0, 23),
    # float16, float32 at D = 128, and head dims zero-padded to the next
    # instance.
    (torch.float16, 64, 128, 128, False, 0, 0),
    (torch.float16, 128, 77, 100, True, 0, 23),
    (torch.float32, 128, 128, 128, True, 16, 0),
    (torch.bfloat16, 48, 77, 100, True, 0, 23),
    (torch.float16, 96, 128, 128, False, 0, 0)])
def test_single_tile_kernels_match_plain_versions_on_the_card(
        cuda_device, dtype, D, Sq, Sk, causal, q_offset, k_offset):
    q, k, v, do, glse = _attention_operands(cuda_device, 1, 6, Sq, Sk, D,
                                            dtype)
    o, lse = port.flash_fwd_single(q, k, v, causal, q_offset, k_offset)
    o_ref, lse_ref = port.flash_fwd_single_plain(q, k, v, causal, q_offset,
                                                 k_offset)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, glse, causal, q_offset, k_offset)
    _hold([(o, o_ref), *zip(port.flash_dqkv(*args),
                            port.flash_dqkv_plain(*args))], dtype)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    assert torch.equal(lse == port.LSE_MASKED, lse_ref == port.LSE_MASKED)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [16, 129])
def test_more_heads_than_a_grid_dimension_holds(cuda_device, dtype, S):
    """B*H = 65,600 heads, past the 65,535 blocks of grid.y, on each route
    (S = 16: single-tile; S = 129: multi-tile)."""
    BH, D = 65600, 16
    q, k, v, do, glse = _attention_operands(cuda_device, 2, BH, S, S, D,
                                            dtype)
    single = S <= port.SINGLE_TILE_MAX
    fwd = port.flash_fwd_single if single else port.flash_fwd
    o, lse = fwd(q, k, v)
    o_ref, lse_ref = port.flash_fwd_plain(q, k, v)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, glse)
    if single:
        grads = zip(port.flash_dqkv(*args), port.flash_dqkv_plain(*args))
    else:
        grads = [(port.flash_dq(*args), port.flash_dq_plain(*args)),
                 *zip(port.flash_dkv(*args), port.flash_dkv_plain(*args))]
    _hold([(o, o_ref), *grads], dtype)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def _hold_wide_hopper(cuda_device, seed, BH, Sq, Sk, D, dtype, causal,
                      q_offset, k_offset):
    """The wgmma wide-head forward, dQ and dK/dV (bf16, float16) against
    their plain versions, with a nonzero lse cotangent, each launched
    once."""
    q, k, v, do, glse = _attention_operands(cuda_device, seed, BH, Sq, Sk, D,
                                            dtype)
    wide = (_kernels.FLASH_FWD_WIDE, _kernels.FLASH_DQ_WIDE,
            _kernels.FLASH_DKV_WIDE)
    before = [kern.launches for kern in wide]
    o, lse = port.flash_fwd(q, k, v, causal, q_offset, k_offset)
    o_ref, lse_ref = port.flash_fwd_plain(q, k, v, causal, q_offset, k_offset)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, glse, causal, q_offset, k_offset)
    _hold([(o, o_ref), (port.flash_dq(*args), port.flash_dq_plain(*args)),
           *zip(port.flash_dkv(*args), port.flash_dkv_plain(*args))], dtype)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    assert torch.equal(lse == port.LSE_MASKED, lse_ref == port.LSE_MASKED)
    assert [kern.launches for kern in wide] == [n + 1 for n in before]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D,Sq,Sk,causal,q_offset,k_offset", [
    # D = 288: its last 64-column box half past D (zero-filled by TMA).
    (288, 77, 100, True, 0, 23),
    # Causal and ragged, rows 0..39 seeing no key; one pass with the second
    # warpgroup's columns mostly past D.
    (320, 200, 300, True, 0, 40),
    (512, 264, 200, False, 0, 0),
    (512, 130, 96, True, 64, 0),
    # Two forward passes and four dK/dV passes.
    (1024, 128, 128, True, 0, 0)])
def test_wide_hopper_kernels_match_plain_versions_on_the_card(
        cuda_device, dtype, D, Sq, Sk, causal, q_offset, k_offset):
    _hold_wide_hopper(cuda_device, 4, 6, Sq, Sk, D, dtype, causal, q_offset,
                      k_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wide_hopper_kernels_walk_more_heads_than_a_grid_dimension(
        cuda_device, dtype):
    """B*H = 65,600 at S = 24, D = 320: the persistent grid (one block per
    SM) loops over 65,600 work tiles of each kernel."""
    _hold_wide_hopper(cuda_device, 5, 65600, 24, 24, 320, dtype, True, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("D,BH,Sq,Sk,causal,q_offset,k_offset", [
    # D = 288: the second warpgroup's dQ output items past D but the first
    # box of the first; a query offset.
    (288, 6, 200, 136, True, 70, 0),
    # Causal and ragged with a key offset: rows 0..39 see no key (dQ = 0),
    # keys of the last tiles see no row of a Q tile; D = 300 zero-padded to
    # 320.
    (320, 6, 200, 300, True, 0, 40),
    (300, 6, 77, 100, True, 0, 23),
    (512, 6, 130, 96, False, 0, 0),
    # Two dQ passes and four dK/dV passes; D = 544: a second dQ pass whose
    # second warpgroup has no column.
    (1024, 4, 128, 128, True, 0, 0),
    (544, 3, 100, 70, False, 0, 0),
    # More heads than a grid dimension: the persistent grid walks them.
    (320, 65600, 24, 24, True, 0, 0),
    # More Q tiles than dK/dV's chunk of 32, so that a later chunk adds to
    # the sums the last stored: 35 causal ones (key tiles start at Q tiles
    # 0 to 4); 33 with a query offset, so that key tiles start at Q tiles 0
    # to 32; 35 over 133 key tiles, more work tiles than SMs.
    (320, 3, 2200, 300, True, 0, 0),
    (320, 2, 2100, 4300, True, 2200, 0),
    (512, 1, 2200, 8500, False, 0, 0),
    # No key or no query: dQ, or dK and dV, are zeros (memsets, no kernel).
    (512, 6, 100, 0, False, 0, 0),
    (512, 6, 0, 100, False, 0, 0),
    # The timed shape (B*H = 32, S = 512, D = 512), where the errors against
    # float64 are held too.
    (512, 32, 512, 512, False, 0, 0)])
def test_float32_wide_backward_runs_the_3xtf32_kernels(
        cuda_device, D, BH, Sq, Sk, causal, q_offset, k_offset):
    """The float32 wide-head dQ and dK/dV launch flash_dq_wide_3xtf32_kernel
    and flash_dkv_wide_3xtf32_kernel (launch counters and the profile's
    kernel names) and hold the plain versions at float32's 1e-4; at
    B*H = 32, S = 512, D = 512 on full float32 values their errors against
    float64 are within chip_smoke.py's F64_ERR_RATIO of the float32 plain
    version's."""
    smoke = _chip_smoke()
    q, k, v, do, glse = _attention_operands(cuda_device, 12, BH, Sq, Sk, D,
                                            torch.float32)
    f64 = BH == 32
    if f64:  # the float64 reference takes no lse cotangent
        glse = torch.zeros_like(glse)
    if Sk:
        o_ref, lse = port.flash_fwd_plain(q, k, v, causal, q_offset, k_offset)
        delta = (do * o_ref).sum(-1)
    else:
        lse = torch.full((BH, Sq), port.LSE_MASKED, device=cuda_device)
        delta = torch.zeros(BH, Sq, device=cuda_device)
    args = (q, k, v, do, lse, delta, glse, causal, q_offset, k_offset)
    kernels = (_kernels.FLASH_DQ_WIDE, _kernels.FLASH_DKV_WIDE)
    before = [kern.launches for kern in kernels]
    got = []
    ran = smoke._attention_kernels_ms(
        lambda: got.extend((port.flash_dq(*args), *port.flash_dkv(*args))))
    # One launch of each a run (the profile runs it again if its session
    # recorded nothing).
    assert [kern.launches for kern in kernels] == [n + len(got) // 3
                                                   for n in before]
    want = (port.flash_dq_plain(*args), *port.flash_dkv_plain(*args))
    _hold(zip(got, want), torch.float32)
    assert set(ran) == (set() if Sq * Sk == 0 else {
        "flash_dq_wide_3xtf32_kernel", "flash_dkv_wide_3xtf32_kernel"})
    if f64:
        smoke._f64_check("wide_d512", q, k, v, do, got, want, causal,
                         q_offset, k_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_d256_kernels_with_a_part_full_last_wave(cuda_device, dtype):
    """B*H = 70 at S = 512, D = 256: 280 work tiles of the forward and dQ,
    so the persistent grid's last of three rounds over 132 SMs is
    part-full."""
    q, k, v, do, glse = _attention_operands(cuda_device, 7, 70, 512, 512,
                                            256, dtype)
    o, lse = port.flash_fwd(q, k, v, True)
    o_ref, lse_ref = port.flash_fwd_plain(q, k, v, True)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, glse, True)
    _hold([(o, o_ref), (port.flash_dq(*args), port.flash_dq_plain(*args)),
           *zip(port.flash_dkv(*args), port.flash_dkv_plain(*args))], dtype)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_head_dims_above_128_raise_on_the_card(cuda_device):
    """The single-tile kernels refuse head dims above their widest instance
    on the card, naming 128; the multi-tile entry takes D = 257 on the
    wide-head kernels (zero-padded to 288) instead of raising."""
    q = torch.zeros(2, 16, 257, device=cuda_device, dtype=torch.bfloat16)
    before = _kernels.FLASH_FWD_WIDE.launches
    o, lse = port.flash_fwd(q, q, q)
    assert o.shape == q.shape and _kernels.FLASH_FWD_WIDE.launches == before + 1
    q = torch.zeros(2, 16, 160, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1 to 128"):
        port.flash_fwd_single(q, q, q)


def _launches_by_attention(cuda_device, S, D):
    """Kernel launches of one flash_attention_lse forward and backward."""
    q, k, v, do, glse = _attention_operands(cuda_device, 3, 2, S, S, D,
                                            torch.bfloat16)
    q, k, v = (t.view(1, 2, S, D).requires_grad_() for t in (q, k, v))
    before = {kern.name: kern.launches for kern in _kernels.KERNELS}
    out, lse = port.flash_attention_lse(q, k, v, causal=True)
    torch.autograd.backward([out, lse], [do.view(1, 2, S, D),
                                         glse.view(1, 2, S)])
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    return {kern.name: kern.launches - before[kern.name]
            for kern in _kernels.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 160])
def test_wide_heads_run_the_multi_tile_kernels_on_the_card(cuda_device, S):
    """flash_attention_lse at D = 256 launches the forward, dQ and dK/dV
    kernels once each, and no single-tile or wide-head kernel, at either
    length."""
    ran = _launches_by_attention(cuda_device, S, 256)
    assert ran == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1,
                   "flash_fwd_single": 0, "flash_dqkv": 0,
                   "flash_fwd_wide": 0, "flash_dq_wide": 0,
                   "flash_dkv_wide": 0, "dw_1x1": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("S,D", [(64, 320), (160, 512)])
def test_heads_above_256_run_the_wide_kernels_on_the_card(cuda_device, S, D):
    """flash_attention_lse at D > 256 launches the three wide-head kernels
    once each and no other kernel."""
    ran = _launches_by_attention(cuda_device, S, D)
    assert ran == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                   "flash_fwd_single": 0, "flash_dqkv": 0,
                   "flash_fwd_wide": 1, "flash_dq_wide": 1,
                   "flash_dkv_wide": 1, "dw_1x1": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,cout,strides", [
    (torch.bfloat16, (4, 14, 14, 64), 256, (1, 1)),
    (torch.bfloat16, (4, 14, 14, 256), 512, (2, 2)),
    (torch.float32, (3, 7, 11, 72), 40, (1, 1)),
    # float16; channel counts that are no whole 16-byte row (zero-padded
    # copies); a stride-2 view whose rows are 300 wide (copied).
    (torch.float16, (4, 14, 14, 64), 256, (1, 1)),
    (torch.bfloat16, (8, 32, 32, 3), 12, (1, 1)),
    (torch.float32, (3, 7, 11, 6), 10, (2, 2)),
    (torch.bfloat16, (2, 16, 600, 64), 128, (2, 2))])
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
    got = conv.dw_1x1(xs, dy)
    want = conv.dw_1x1_plain(xs, dy)
    assert _kernels.DW_1X1.launches == before + 1
    assert got.shape == (shape[-1], cout) and got.dtype == torch.float32
    # Both sum in fp32 over the same products, in another order.
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()
    xg = x.detach().requires_grad_()
    wg = w.detach().requires_grad_()
    out = conv.conv1x1(xg, wg, strides)
    out.backward(dy.reshape(out.shape))
    dx, dw = conv.conv1x1_backward(x, w, dy.reshape(out.shape), strides,
                                   conv.dw_1x1_plain)
    assert torch.equal(xg.grad, dx)
    assert (wg.grad.float() - dw.float()).abs().max().item() <= (
        TOL[dtype]) * dw.float().abs().max().item()


def _device_kernel_names(run):
    """The names of the device kernels one ``run()`` launched, from a
    chip_smoke.device_profile session."""
    smoke = _chip_smoke()
    with smoke.device_profile() as prof:
        run()
    return {name for name, _, _ in smoke.device_events(prof)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,strides", [
    # ResNet-50's stage 1 and its stride-2 shortcut view (read in place).
    ((128, 56, 56, 64), 256, (1, 1)),
    ((128, 56, 56, 256), 512, (2, 2)),
    # A ragged K with ragged channel tiles (72 -> 40); an odd-H stride-2
    # view; a 300-wide stride-2 view (copied); grid rows of 150, read in
    # three pieces each.
    ((5, 37, 41, 72), 40, (1, 1)),
    ((4, 37, 30, 64), 128, (2, 2)),
    ((2, 16, 600, 64), 128, (2, 2)),
    ((2, 8, 150, 64), 96, (2, 1))])
def test_float32_filter_gradient_runs_the_3xtf32_kernel(cuda_device, shape,
                                                        cout, strides):
    """The float32 dw_1x1 launches dw_1x1_3xtf32_kernel (launch counter and
    the profile's kernel names), holds the plain version at 1e-4, and two
    calls on the same inputs are equal bit for bit; at stage 1 its error
    against float64 is within chip_smoke.py's F64_ERR_RATIO of the float32
    plain version's."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(*shape, generator=gen, device=cuda_device)
    xs = x[:, ::strides[0], ::strides[1], :]
    K = xs.shape[:3].numel()
    dy = torch.randn(K, cout, generator=gen, device=cuda_device)
    before = _kernels.DW_1X1.launches
    got = []
    names = _device_kernel_names(lambda: got.append(conv.dw_1x1(xs, dy)))
    again = conv.dw_1x1(xs, dy)
    assert _kernels.DW_1X1.launches == before + 2
    assert any("dw_1x1_3xtf32_kernel" in n for n in names), names
    assert not any("dw_1x1_kernel" in n for n in names), names
    want = conv.dw_1x1_plain(xs, dy)
    _hold([(got[0], want)], torch.float32)
    assert torch.equal(got[0], again)
    if shape[0] == 128 and strides == (1, 1):
        _chip_smoke()._dw_f64_check("stage1", xs.reshape(K, -1), dy, got[0],
                                    want)


@pytest.mark.cuda
@pytest.mark.parametrize("D,BH,Sq,Sk,causal,q_offset,k_offset", [
    # Causal and ragged: 200 rows over 300 keys, rows 0..39 seeing none.
    (320, 6, 200, 300, True, 0, 40),
    # A query offset; two passes of 512 columns; more heads than a grid
    # dimension.
    (512, 6, 264, 200, True, 64, 0),
    (1024, 4, 128, 128, True, 0, 0),
    (320, 65600, 24, 24, True, 0, 0),
    # No key: O = 0 and lse = LSE_MASKED for every row, written by the
    # launcher (a memset and the lse fill kernel), as on every route.
    (512, 4, 64, 0, False, 0, 0),
    # The timed shape, where the error against float64 is held too.
    (512, 32, 512, 512, False, 0, 0)])
def test_float32_wide_forward_runs_the_3xtf32_kernel(
        cuda_device, D, BH, Sq, Sk, causal, q_offset, k_offset):
    """The float32 wide-head forward launches flash_fwd_wide_3xtf32_kernel
    (launch counter and the profile's kernel names; with no key the lse
    fill kernel alone) and holds the plain version at 1e-4 (lse 1e-3, the
    same rows masked); at B*H = 32, S = 512, D = 512 its error against
    float64 is within chip_smoke.py's F64_ERR_RATIO of the float32 plain
    version's."""
    smoke = _chip_smoke()
    q, k, v, _, _ = _attention_operands(cuda_device, 13, BH, Sq, Sk, D,
                                        torch.float32)
    ran = smoke._attention_kernels_ms(
        lambda: _hold_forward(port.flash_fwd, _kernels.FLASH_FWD_WIDE, q, k,
                              v, causal, q_offset, k_offset))
    assert set(ran) == {"flash_fwd_no_key_kernel" if Sk == 0
                        else "flash_fwd_wide_3xtf32_kernel"}
    if BH == 32:
        got = port.flash_fwd(q, k, v, causal, q_offset, k_offset)
        want = port.flash_fwd_plain(q, k, v, causal, q_offset, k_offset)
        smoke._f64_check("wide_d512", q, k, v, None, got, want, causal,
                         q_offset, k_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("D,BH,Sq,Sk,causal,q_offset,k_offset", [
    # Causal and ragged with an lse cotangent at every instance (D = 16
    # and 48 zero-padded to 32 and 64, 100 to 128): a query offset; a key
    # offset with rows 0..22 seeing no key; keys within one 64-key half;
    # rows within one Q tile; the first Q tile seeing no key at all.
    (16, 6, 128, 128, True, 16, 0),
    (32, 6, 112, 128, True, 16, 0),
    (48, 6, 77, 100, True, 0, 23),
    (64, 6, 77, 100, True, 0, 23),
    (64, 6, 128, 40, False, 0, 0),
    (64, 6, 5, 128, True, 0, 0),
    (64, 4, 128, 128, True, 0, 100),
    (100, 6, 128, 128, True, 16, 0),
    (128, 6, 77, 100, True, 0, 23),
    # More heads than a grid dimension (the persistent grid walks them).
    (16, 65600, 16, 16, False, 0, 0),
    # BERT-Large's S = 128 shape and the same at D = 128, where the errors
    # against float64 are held too.
    (64, 1024, 128, 128, False, 0, 0),
    (128, 64, 128, 128, True, 0, 0)])
def test_float32_fused_backward_runs_the_3xtf32_kernel(
        cuda_device, D, BH, Sq, Sk, causal, q_offset, k_offset):
    """The float32 fused single-tile backward launches
    flash_dqkv_3xtf32_kernel at the planned head dim (launch counter and
    the profile's kernel names), holds the plain version at float32's 1e-4,
    gives the same bits on a second call, and at BERT-Large's S = 128 shape
    and at D = 128 its errors against float64 (lse cotangent included) are
    within chip_smoke.py's F64_ERR_RATIO of the float32 plain version's."""
    smoke = _chip_smoke()
    q, k, v, do, glse = _attention_operands(cuda_device, 14, BH, Sq, Sk, D,
                                            torch.float32)
    o_ref, lse = port.flash_fwd_plain(q, k, v, causal, q_offset, k_offset)
    delta = (do * o_ref).sum(-1)
    args = (q, k, v, do, lse, delta, glse, causal, q_offset, k_offset)
    before = _kernels.FLASH_DQKV.launches
    got = []
    ran = smoke._attention_kernels_ms(
        lambda: got.extend(port.flash_dqkv(*args)))
    # One launch a run (the profile runs it again if its session recorded
    # nothing).
    assert _kernels.FLASH_DQKV.launches == before + len(got) // 3
    Dk = port.kernel_head_dim(
        D, port.instance_head_dims(torch.float32, port.SINGLE_TILE_HEAD_DIMS))
    assert Dk == {16: 32, 48: 64, 100: 128}.get(D, D)
    assert set(ran) == {f"flash_dqkv_3xtf32_kernel<{Dk}>"}
    want = port.flash_dqkv_plain(*args)
    _hold(zip(got, want), torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(got, port.flash_dqkv(*args)))
    if BH in (1024, 64):
        smoke._f64_check(f"dqkv_d{D}", q, k, v, do, got, want, causal,
                         q_offset, k_offset, glse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("route,D,S", [("single-tile", 64, 40),
                                       ("multi-tile", 64, 200),
                                       ("wide", 320, 200)])
@pytest.mark.parametrize("no", ["key", "query"])
def test_every_route_takes_no_key_and_no_query(cuda_device, dtype, route, D,
                                               S, no):
    """With no key (Sk = 0) or no query (Sq = 0) each kernel wrapper of each
    route gives exactly its plain version: O = 0 and lse = LSE_MASKED with
    no key, dQ = 0; dK = dV = 0 with no query; the rest empty."""
    Sq, Sk = (S, 0) if no == "key" else (0, S)
    q, k, v, do, glse = _attention_operands(cuda_device, 15, 3, Sq, Sk, D,
                                            dtype)
    lse = torch.full((3, Sq), port.LSE_MASKED, device=cuda_device)
    bwd = (q, k, v, do, lse, torch.zeros_like(lse), glse)
    if route == "single-tile":
        runs = ((port.flash_fwd_single, port.flash_fwd_single_plain, (q, k, v)),
                (port.flash_dqkv, port.flash_dqkv_plain, bwd))
    else:
        runs = ((port.flash_fwd, port.flash_fwd_plain, (q, k, v)),
                (port.flash_dq, port.flash_dq_plain, bwd),
                (port.flash_dkv, port.flash_dkv_plain, bwd))
    for kern, plain, args in runs:
        want = plain(*args)
        want = want if isinstance(want, tuple) else (want,)
        for t in [torch.full_like(w, float("nan")) for w in want]:
            del t  # the allocator hands these blocks to the kernel's outputs
        got = kern(*args)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [2, 3, 5, 8])
def test_adasum_tree_on_the_card_holds_float64(cuda_device, dtype, N):
    """``ops.adasum.adasum_tree`` on the card over N members (the second
    all zero) against chip_smoke.py's float64 numpy tree: float32 within
    1e-5 of the largest value, bf16 (each pair's result rounded to 8 bits,
    as the reference rounds it to its dtype) within 2e-2."""
    from horovod_tpu_torch.ops.adasum import adasum_tree

    smoke = _chip_smoke()
    gen = torch.Generator(device=cuda_device).manual_seed(N)
    shared = torch.randn(257, 33, generator=gen, device=cuda_device)
    stack = torch.stack([(r + 1) * (0.7 * shared + torch.randn(
        257, 33, generator=gen, device=cuda_device)) for r in range(N)])
    stack[1] = 0.0
    stack = stack.to(dtype)
    want = smoke.adasum_tree_np(list(stack.double().cpu().numpy()))
    got = adasum_tree(stack)
    assert got.dtype == dtype and got.device.type == "cuda"
    err = abs(got.double().cpu().numpy() - want).max()
    assert err <= smoke.ADASUM_TOL[str(dtype).split(".")[1]] * abs(want).max()


# SyncBatchNorm's card cases: dtype, layout, input shape, and the
# tolerances of y, dx, dweight, dbias and the two running statistics.
SYNCBN_CASES = {
    "float32": (torch.float32, torch.contiguous_format, (6, 8, 5, 7),
                (1e-5, 1e-5, 1e-4, 1e-4, 1e-6, 1e-6)),
    # ResNet's case: float32 weights, bf16 outputs.
    "bf16_channels_last": (torch.bfloat16, torch.channels_last,
                           (16, 32, 14, 14),
                           (2e-2, 2e-2, 1e-2, 1e-2, 1e-5, 1e-5)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", SYNCBN_CASES)
def test_sync_batch_norm_at_world_size_one_matches_batch_norm(
        cuda_device, monkeypatch, case):
    """SyncBatchNorm at world size 1 with the wire forced (one NCCL
    allreduce forward and one backward, ATen's sync-BatchNorm kernels)
    against torch's BatchNorm2d on the card, TF32 off: float32, and a bf16
    channels_last input with float32 weights, each within its
    ``SYNCBN_CASES`` tolerances of the largest value (at least 1)."""
    import horovod_tpu_torch as hvd

    dtype, layout, shape, tols = SYNCBN_CASES[case]
    c = shape[1]
    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    hvd.init()
    try:
        gen = torch.Generator(device=cuda_device).manual_seed(4)
        x = torch.randn(shape, generator=gen, device=cuda_device) * 3 + 1
        g = torch.randn(shape, generator=gen, device=cuda_device)
        x, g = (t.to(dtype).contiguous(memory_format=layout) for t in (x, g))
        outs = []
        for bn in (hvd.SyncBatchNorm(c).to(cuda_device),
                   torch.nn.BatchNorm2d(c).to(cuda_device)):
            with torch.no_grad():
                bn.weight.copy_(torch.linspace(0.5, 1.5, c))
                bn.bias.copy_(torch.linspace(-1, 1, c))
            xi = x.clone().requires_grad_()
            y = bn(xi)
            y.backward(g)
            assert y.dtype == xi.grad.dtype == dtype
            outs.append((y.float(), xi.grad.float(), bn.weight.grad,
                         bn.bias.grad, bn.running_mean, bn.running_var))
        for i, (a, b) in enumerate(zip(*outs)):
            assert (a - b).abs().max().item() <= tols[i] * max(
                1.0, b.abs().max().item()), i
    finally:
        hvd.shutdown()


@pytest.mark.cuda
def test_three_inits_on_the_card_give_the_same_step(cuda_device,
                                                    monkeypatch):
    """init -> collective -> shutdown, three times in one process on the
    card (a new NCCL group each time, as each elastic re-formation forms
    one), with the wire forced: every time the allreduce sums right and
    an optimizer built on that world steps the same parameters from the
    same weights and batch to the same values, bit for bit."""
    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    w0 = torch.randn(64, 32, generator=gen, device=cuda_device)
    x = torch.randn(16, 64, generator=gen, device=cuda_device)
    results = []
    for _ in range(3):
        hvd.init()
        try:
            t = torch.arange(8.0, device=cuda_device)
            assert torch.equal(hvd.allreduce(t, op=hvd.Sum), t)
            w = torch.nn.Parameter(w0.clone())
            opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1))
            (x @ w).square().mean().backward()
            opt.step()
            results.append(w.detach().clone())
        finally:
            hvd.shutdown()
    assert not torch.equal(results[0], w0)
    assert all(torch.equal(r, results[0]) for r in results[1:])


@pytest.mark.cuda
def test_peer_restore_of_a_card_resident_fsdp_state(cuda_device,
                                                    monkeypatch):
    """An fsdp state on the card (one rank, AdamW, two steps) committed
    through ``PeerShardedState`` into its replicator's pool: the commit's
    record holds host tensors only; the peer rung rebuilds the full
    parameters and optimizer state equal to what was gathered at the
    commit, and the next ``sync()`` installs them as card tensors, equal
    bit for bit."""
    import pickle

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import peercheck
    from horovod_tpu_torch.optimizer import unshard_opt_state

    for name in ("HOROVOD_RENDEZVOUS_ADDR", "HOROVOD_RENDEZVOUS_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    hvd.init()
    try:
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(64, 96), torch.nn.Tanh(),
                                    torch.nn.Linear(96, 8)).to(cuda_device)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-2), sync_mode="fsdp")
        step = hvd.make_train_step(model, lambda m, x: m(x).square().mean(),
                                   opt)
        state = hvd.elastic.PeerShardedState(
            model=model, optimizer=opt, replicator=peercheck.PeerReplicator(
                rank=0, world_size_fn=lambda: 1), epoch=0)
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        for _ in range(2):
            step(torch.randn(32, 64, generator=gen, device=cuda_device))
            state.epoch += 1
            state.commit()
        record = pickle.loads(state._replicator.pool.get(0).payload)
        tensors = [t for t in record["param_row"]] + [
            v for st in record["row"]["state"].values() for v in st.values()
            if torch.is_tensor(v)]
        assert tensors and all(t.device.type == "cpu" for t in tensors)
        flat = [t.cpu() for t in opt.full_parameters()]
        full_opt = unshard_opt_state(opt, hvd.gather_sharded_state(opt))
        state.restore()
        assert state.peer_restore_pending()
        assert state.restore_peer()
        assert all(torch.equal(a, b) for a, b in zip(state._full["flat"],
                                                     flat))
        state.sync()
        assert all(s.device.type == "cuda" for s in opt.shards)
        assert all(torch.equal(a.cpu(), b)
                   for a, b in zip(opt.full_parameters(), flat))
        installed = opt._opt.state_dict()["state"]
        for i, st in full_opt["state"].items():
            for k, v in st.items():
                got = installed[i][k]
                if got.dim() > 0:
                    assert got.device.type == "cuda"
                    assert torch.equal(got.cpu(), v.reshape(-1))
                else:
                    assert torch.equal(got.cpu(), v)
        assert state.epoch == 2
    finally:
        hvd.shutdown()


@pytest.mark.cuda
def test_nccl_allreduce_ticket_and_latency_close_after_the_card(
        cuda_device, monkeypatch):
    """An NCCL allreduce queued behind ~0.5 s of device work: the host
    returns from ``hvd.allreduce`` at once, with its stall ticket still
    open and no latency sample taken; once the card has run the
    collective, the reaper closes the ticket and the sample is the
    collective's device time. Neither the call nor the step made around
    it synchronizes the device."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, stall
    from horovod_tpu_torch.utils.spin import Spin

    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    hvd.init()
    synchronized = []
    real = torch.cuda.synchronize
    try:
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a: synchronized.append(a))
        t = torch.ones(1 << 20, device=cuda_device)
        # The communicator forms, and the allreduce's kernels load (under
        # CUDA's lazy loading a first launch behind the spin would wait for
        # it: C9), at the first collective.
        hvd.allreduce(t, op=hvd.Sum)
        real()
        count = metrics.COLLECTIVE_LATENCY.labels(kind="allreduce")
        ins = stall.get_inspector()
        ins.reap()
        before, seconds = count.count, count.sum
        spin = Spin(int(0.5 * 1.7e9))  # ~0.5 s at H100 clocks, timed
        t0 = time.perf_counter()
        out = hvd.allreduce(t, op=hvd.Sum)
        host_s = time.perf_counter() - t0
        ins.reap()
        assert host_s < 0.2
        assert len(ins._outstanding) == 1 and count.count == before
        assert synchronized == []
        monkeypatch.setattr(torch.cuda, "synchronize", real)
        real()
        ins.reap()
        assert len(ins._outstanding) == 0 and count.count == before + 1
        assert 0 < count.sum - seconds < 1.0
        assert torch.equal(out, t)
        # The spin held the stream (C9: a short one would let the
        # allreduce run before the host looked).
        assert not spin.short(), (spin.ms(), spin.least_ms())
    finally:
        monkeypatch.setattr(torch.cuda, "synchronize", real)
        hvd.shutdown()


@pytest.mark.cuda
def test_fetch_behind_a_spin_warns_by_name(cuda_device, monkeypatch):
    """``hvd.fetch`` of a tensor queued behind ~3 s of device work waits
    on the host inside its ticket, and an inspector whose warning time is
    1 s names ``fetch[spin]``."""
    import logging

    from horovod_tpu_torch import metrics, stall
    from horovod_tpu_torch.utils.logging import get_logger
    from horovod_tpu_torch.utils.spin import MAX_SM_HZ, Spin

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    keep = Keep()
    get_logger().addHandler(keep)
    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME", "1")
    stall.reset_for_testing()
    try:
        warned = metrics.STALL_WARNINGS.labels().get()
        x = torch.ones(4, device=cuda_device)
        # Load the kernel of the work queued behind the spin first: under
        # CUDA's lazy loading the first launch of a kernel waits until the
        # card is idle, so behind a spin it would return only after it
        # (C9).
        x * 2
        torch.cuda.synchronize()
        spin = Spin(int(3 * MAX_SM_HZ))  # ~3 s at the highest SM clock
        y = x * 2
        t0 = time.perf_counter()
        assert stall.fetch(y, name="spin") is y
        waited = time.perf_counter() - t0
        # The spin held the stream (C9), else the fetch had nothing to
        # wait for.
        assert not spin.short(), (spin.ms(), spin.least_ms(), waited)
        assert waited > 1.5, waited
        assert metrics.STALL_WARNINGS.labels().get() > warned, (
            waited, keep.lines)
        assert any("fetch[spin]" in line for line in keep.lines)
    finally:
        get_logger().removeHandler(keep)
        stall.reset_for_testing()


@pytest.mark.cuda
def test_allocator_reads_and_capacity_match_the_card(cuda_device,
                                                      monkeypatch):
    """``memory.device_memory_stats`` reads the caching allocator under the
    reference's keys and ``capacity_bytes`` is the card's total, unless
    ``HOROVOD_HBM_BYTES_PER_DEVICE`` declares a budget."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import memory

    monkeypatch.delenv("HOROVOD_HBM_BYTES_PER_DEVICE", raising=False)
    hvd.init()
    try:
        x = torch.empty(1 << 28, dtype=torch.uint8, device=cuda_device)
        stats = memory.device_memory_stats()
        assert stats == {
            "bytes_in_use": torch.cuda.memory_allocated(),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(),
            "bytes_reserved": torch.cuda.memory_reserved(),
            "bytes_limit": torch.cuda.mem_get_info()[1]}
        assert stats["bytes_in_use"] >= x.numel()
        assert memory.capacity_bytes() == torch.cuda.mem_get_info()[1]
        monkeypatch.setenv("HOROVOD_HBM_BYTES_PER_DEVICE", str(40 << 30))
        assert memory.capacity_bytes() == 40 << 30
        # A span close folds the bytes in use into its phase's watermark.
        memory.reset_for_testing()
        from horovod_tpu_torch import tracing

        with tracing.span("forward_backward"):
            pass
        assert memory.get_observatory().watermarks()["forward_backward"] \
            >= x.numel()
        del x
    finally:
        hvd.shutdown()


@pytest.mark.cuda
def test_an_oversized_allocation_at_the_step_boundary_dumps_the_record(
        cuda_device, tmp_path, monkeypatch):
    """A step that asks the card for more than it has raises torch's
    ``OutOfMemoryError`` out of ``make_train_step``'s step, unchanged,
    after the memory flight record (reason ``oom``) is written."""
    import dataclasses

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import bert

    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("HOROVOD_EVENT_LOG", str(log))
    metrics.reset_for_testing()
    hvd.init()
    try:
        cfg = dataclasses.replace(bert.BERT_TINY, dropout_rate=0.0)
        with torch.device(cuda_device):
            model = bert.Bert(cfg)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())

        def loss_fn(m, b):
            torch.empty(1 << 48, dtype=torch.uint8, device=cuda_device)
            return m.embeddings.word_embeddings.weight.sum()

        step = hvd.make_train_step(model, loss_fn, opt)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            step(None)
        opt.remove_hooks()
    finally:
        hvd.shutdown()
        metrics.reset_for_testing()
    import json

    records = [json.loads(line) for line in log.read_text().splitlines()]
    oom = [r for r in records if r.get("event") == "flight_record"
           and r.get("reason") == "oom"]
    assert len(oom) == 1 and "out of memory" in oom[0]["error"].lower()
    assert oom[0]["memory"]["resident"]["params"] > 0
    assert oom[0]["memory_top_leaves"]


@pytest.mark.cuda
def test_eager_allreduces_feed_the_fit_without_a_sync(cuda_device,
                                                      monkeypatch):
    """Eager NCCL allreduces at three payload sizes feed the alpha-beta
    fit from their CUDA events once the inspector reaps them; no call
    synchronizes the device."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import comms_model, stall

    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    hvd.init()
    comms_model.reset_for_testing()
    synchronized = []
    real = torch.cuda.synchronize
    try:
        tensors = [torch.ones(n, device=cuda_device)
                   for n in (1 << 10, 1 << 16, 1 << 22)]
        hvd.allreduce(tensors[0])  # the communicator forms
        real()
        stall.get_inspector().reap()
        comms_model.reset_for_testing()
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a: synchronized.append(a))
        for _ in range(3):
            for t in tensors:
                hvd.allreduce(t)
        assert synchronized == []
        monkeypatch.setattr(torch.cuda, "synchronize", real)
        real()
        stall.get_inspector().reap()
        fit = comms_model.get_model().payload()["fits"][
            "allreduce|flat|intra_host"]
        assert fit["samples"] == 9 and fit["ready"]
        assert comms_model.get_model().predict_exact(
            "allreduce", "flat", "intra_host", 1 << 24) is not None
    finally:
        monkeypatch.setattr(torch.cuda, "synchronize", real)
        hvd.shutdown()


@pytest.mark.cuda
def test_microprobe_times_the_card_behind_its_hold(cuda_device,
                                                   monkeypatch):
    """On the card a size's timed microprobe calls sit behind a spin of
    ``PROBE_HOLD_CYCLES`` (~10 ms): their events bracket the collectives'
    device time, far below the spin's, and the warm-up calls feed the
    model no sample."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import comms_model

    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    hvd.init()
    comms_model.reset_for_testing()
    try:
        out = hvd.run_comms_microprobe(sizes=(4096, 1 << 20), repeats=2)
        payload = comms_model.get_model().payload()
    finally:
        hvd.shutdown()
    for op, per_op in out.items():
        seconds = [s for v in per_op.values() for s in v]
        assert len(seconds) == 4 and 0 < max(seconds) < 2e-3, (op, seconds)
        assert payload["fits"][f"{op}|flat|intra_host"]["samples"] == 4


@pytest.mark.cuda
def test_first_spin_of_a_process_is_timed(cuda_device):
    """C9: the first ``torch.cuda._sleep`` of a fresh process, timed by
    CUDA events, holds the stream for its cycles (the child prints its
    milliseconds; a short one fails here and names itself). What looked
    like a spin that did not spin was the host: the first launch of a
    kernel behind a spin returns only when the spin ends."""
    import subprocess
    import sys

    code = ("import torch; from horovod_tpu_torch.utils.spin import Spin; "
            "s = Spin(20_000_000); print(s.ms(), s.least_ms(), s.short())")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    ms, least, short = out.stdout.split()
    assert short == "False", f"the first spin took {ms} ms of {least}"


@pytest.mark.cuda
def test_bayesian_optimizer_builds_with_gxx_here(cuda_device):
    """The autotuner's Bayesian optimizer (host C++) builds with g++ on
    the card's machine and suggests the same points for the same seed and
    scores."""
    from horovod_tpu_torch import autotune

    runs = []
    for _ in range(2):
        tuner = autotune.BayesianTuner([64 * 1024.0], [128.0 * 2**20],
                                       seed=3)
        points = []
        for r in range(8):
            (x,) = tuner.suggest()
            points.append(x)
            tuner.add_sample([x], 1.0 / (1.0 + abs(x - 2**23) / 2**20))
        runs.append((points, tuner.best()))
        tuner.close()
    assert runs[0] == runs[1]
    assert all(64 * 1024 <= x <= 128 * 2**20 for x in runs[0][0])


def _tiny_bert_step(hvd, cuda_device, seed=0):
    import dataclasses

    from horovod_tpu_torch.models import bert

    cfg = dataclasses.replace(bert.BERT_TINY, dropout_rate=0.0)
    torch.manual_seed(seed)
    with torch.device(cuda_device):
        model = bert.Bert(cfg, attention_fn=bert.flash_attention_fn)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.bf16)
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (4, 128), generator=g)
    positions = torch.stack([torch.randperm(128, generator=g)[:8]
                             for _ in range(4)])
    labels = torch.randint(0, cfg.vocab_size, (4, 8), generator=g)
    batch = tuple(t.to(cuda_device) for t in
                  (ids, positions, labels, torch.ones(4, 8)))

    def loss_fn(m, b):
        _, logits = m(b[0], masked_positions=b[1])
        return bert.mlm_loss(logits, b[2], b[3])

    return cfg, model, opt, hvd.make_train_step(model, loss_fn, opt), batch


@pytest.mark.cuda
def test_tiny_bert_autotunes_and_rebuckets_on_the_card(cuda_device,
                                                       tmp_path,
                                                       monkeypatch):
    """Under ``HOROVOD_AUTOTUNE=1`` a tiny BERT's step pins a threshold
    after three windows, re-buckets its optimizer to it, and every step
    still launches its attention kernels once a layer."""
    import json

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import autotune
    from horovod_tpu_torch.ops.fusion import bucket_leaves

    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    log = tmp_path / "autotune.jsonl"
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
    autotune.reset_for_testing()
    hvd.init()
    try:
        cfg, model, opt, step, batch = _tiny_bert_step(hvd, cuda_device)
        for k in _kernels.KERNELS:
            k.launches = 0
        steps = 3 * 4 + 2
        losses = [float(step(batch)) for _ in range(steps)]
        pin = autotune.tuned_threshold()
        assert pin in autotune.DEFAULT_THRESHOLDS
        assert json.loads(log.read_text())["decision"] == pin
        layout = [(p.numel(), torch.bfloat16) for p in model.parameters()]
        assert len(opt._buckets) == len(bucket_leaves(layout, pin))
        launched = {k.name: k.launches for k in _kernels.KERNELS
                    if k.launches}
        assert launched and all(n == cfg.num_layers * steps
                                for n in launched.values()), launched
        assert all(torch.isfinite(torch.tensor(losses)))
        opt.remove_hooks()
    finally:
        hvd.shutdown()
        autotune.reset_for_testing()


@pytest.mark.cuda
def test_planner_unset_leaves_the_flush_launches(cuda_device, monkeypatch):
    """With ``HOROVOD_COMMS_PLANNER`` unset a step launches one NCCL
    allreduce per bucket and one for the loss, and the planner never
    plans (``comms_planner.dispatch_plan`` answers before
    ``plan_bucket``); pinned flat, it plans and the launches are the
    same."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import comms_planner

    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    monkeypatch.delenv("HOROVOD_COMMS_PLANNER", raising=False)
    hvd.init()
    real_allreduce = dist.all_reduce
    launches, asked = [], []
    real_plan = comms_planner.plan_bucket
    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: (
        launches.append(1), real_allreduce(*a, **k))[1])
    monkeypatch.setattr(comms_planner, "plan_bucket", lambda *a, **k: (
        asked.append(1), real_plan(*a, **k))[1])
    try:
        counts = []
        for mode in (None, "flat"):
            if mode:
                monkeypatch.setenv("HOROVOD_COMMS_PLANNER", mode)
            _, _, opt, step, batch = _tiny_bert_step(hvd, cuda_device)
            step(batch)
            launches.clear()
            asked.clear()
            step(batch)
            counts.append((len(launches), len(asked)))
            assert len(launches) == len(opt._buckets) + 1
            opt.remove_hooks()
        # Unset: never planned. Pinned flat: planned, and the launches
        # equal (a one-rank world plans nothing but flat).
        assert counts[0][1] == 0 and counts[1][1] > 0
        assert counts[1][0] == counts[0][0]
    finally:
        hvd.shutdown()


def _negotiated_world(monkeypatch, cycle_ms=None):
    """A one-rank negotiated world on the card (``hvd.init()`` has run)."""
    from horovod_tpu_torch.runner.network import free_port
    from horovod_tpu_torch.runtime import NativeWorld

    if cycle_ms is not None:
        monkeypatch.setenv("HOROVOD_CYCLE_TIME", str(cycle_ms))
    return NativeWorld(0, 1, "127.0.0.1", free_port())


@pytest.mark.cuda
def test_negotiated_allreduce_behind_a_spin_reduces_the_value_after_it(
        cuda_device, monkeypatch):
    """A tensor written behind ~0.5 s of device work and enqueued at once:
    the executor's stream waits on the enqueuing stream's event, so the
    reduction sees the value written after the spin, and the host returns
    from the enqueue and the synchronize before the spin ends."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils.spin import Spin

    hvd.init()
    world = _negotiated_world(monkeypatch)
    try:
        x = torch.ones(1 << 20, device=cuda_device)
        # Load the fill and the collective's kernels before the spin (C9).
        x.fill_(1.0)
        world.synchronize(world.allreduce_async_(x, name="warm", op="sum"))
        torch.cuda.synchronize()
        spin = Spin(int(0.5 * 1.7e9))
        x.fill_(3.0)
        t0 = time.perf_counter()
        out = world.synchronize(world.allreduce_async_(x, name="spun",
                                                       op="sum"))
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        assert not spin.short(), (spin.ms(), spin.least_ms())
        assert host_s < 0.25, host_s
        assert out is x and torch.equal(x, torch.full_like(x, 3.0))
    finally:
        world.shutdown()
        hvd.shutdown()


@pytest.mark.cuda
def test_a_fused_response_is_one_nccl_launch_on_a_device_buffer(
        cuda_device, monkeypatch):
    """Eight tensors enqueued within one (200 ms) cycle: one fused
    response, one NCCL allreduce on the world's device fusion buffer, and
    every tensor's average back in place."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    hvd.init()
    world = _negotiated_world(monkeypatch, cycle_ms=200)
    launched = []
    real = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: (
        launched.append((t.device.type, t.numel())), real(t, *a, **k))[1])
    try:
        xs = [torch.full((1000 + i,), float(i), device=cuda_device)
              for i in range(8)]
        time.sleep(0.05)
        before = world.responses
        hs = [world.allreduce_async_(x, name=f"fused.{i}", op="average")
              for i, x in enumerate(xs)]
        outs = [world.synchronize(h) for h in hs]
        torch.cuda.synchronize()
        assert world.responses - before == 1
        assert launched == [("cuda", sum(x.numel() for x in xs))]
        assert world._fusion[torch.float32].device.type == "cuda"
        for i, (x, out) in enumerate(zip(xs, outs)):
            assert out is x and torch.equal(x, torch.full_like(x, float(i)))
    finally:
        world.shutdown()
        hvd.shutdown()


@pytest.mark.cuda
def test_a_failed_gxx_build_raises_rather_than_falling_back(cuda_device,
                                                            monkeypatch):
    """A control plane that does not build raises at the world's
    formation: there is no direct path to fall back to."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import runtime

    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "GXX", "false")
    monkeypatch.setattr(runtime, "GXX_FLAGS",
                        runtime.GXX_FLAGS + ("-DHVD_FAILED_BUILD_PROBE",))
    hvd.init()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            _negotiated_world(monkeypatch)
    finally:
        hvd.shutdown()


def _tiny_bert_run(hvd, cuda_device, mode, factory, steps=3, **kw):
    """A 2-layer tiny BERT from seed 0, SGD with momentum on the float32
    wire under ``sync_mode=mode``: ``steps`` steps of ``factory`` on one
    batch. Returns (losses, full parameters after them, step, model)."""
    import dataclasses

    from horovod_tpu_torch.models import bert

    cfg = dataclasses.replace(bert.BERT_TINY, dropout_rate=0.0, num_layers=2)
    torch.manual_seed(0)
    with torch.device(cuda_device):
        model = bert.Bert(cfg, attention_fn=bert.flash_attention_fn)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        sync_mode=mode)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (4, 128), generator=g)
    positions = torch.stack([torch.randperm(128, generator=g)[:8]
                             for _ in range(4)])
    labels = torch.randint(0, cfg.vocab_size, (4, 8), generator=g)
    batch = tuple(t.to(cuda_device) for t in
                  (ids, positions, labels, torch.ones(4, 8)))

    def loss_fn(m, b):
        _, logits = m(b[0], masked_positions=b[1])
        return bert.mlm_loss(logits, b[2], b[3])

    step = factory(model, loss_fn, opt, **kw)
    losses = [float(step(batch)) for _ in range(steps)]
    deferred = getattr(step, "deferred_params", None)
    if mode == "fsdp":
        params = opt.full_parameters()
    elif deferred is not None:
        params = [p.detach().clone() for p in deferred.block_until_ready()]
    else:
        params = [p.detach().clone() for p in model.parameters()]
    opt.remove_hooks()
    return losses, params, step, model


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["allreduce", "sharded", "fsdp"])
def test_overlapped_step_equals_make_train_step_on_the_card(
        cuda_device, monkeypatch, mode):
    """At world size 1 on the forced NCCL wire the overlapped step (4
    segments) computes make_train_step's numbers bit for bit: the wire is
    a copy and the update elementwise; deterministic algorithms make the
    embedding's backward repeat."""
    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    hvd.init()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = _tiny_bert_run(hvd, cuda_device, mode, hvd.make_train_step)
        got = _tiny_bert_run(hvd, cuda_device, mode,
                             hvd.make_overlapped_train_step, num_segments=4)
        assert got[0] == ref[0]
        assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
        assert ref[0][-1] < ref[0][0]
    finally:
        torch.use_deterministic_algorithms(False)
        hvd.shutdown()


@pytest.mark.cuda
def test_deferred_gather_on_the_card_settles_before_the_forward(
        cuda_device, monkeypatch):
    """The sharded step with its parameter allgather deferred equals the
    step without it; between steps the gather is in flight until the
    model's forward (a pre-hook) or the handle finishes it."""
    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    hvd.init()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = _tiny_bert_run(hvd, cuda_device, "sharded",
                             hvd.make_train_step)
        got = _tiny_bert_run(hvd, cuda_device, "sharded",
                             hvd.make_train_step, deferred_param_gather=True)
        assert got[0] == ref[0]
        assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
        assert isinstance(got[2].deferred_params, hvd.DeferredParams)
    finally:
        torch.use_deterministic_algorithms(False)
        hvd.shutdown()


@pytest.mark.cuda
def test_overlap_gradient_sync_leaves_the_reduced_grads_on_the_card(
        cuda_device, monkeypatch):
    """``overlap_gradient_sync`` through ``functional_call`` on the forced
    NCCL wire: after ``backward()`` each parameter's ``.grad`` is the plain
    backward's gradient bit for bit (a one-rank Average), and the
    optimizer's own hooks reduced nothing."""
    import dataclasses

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert

    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    hvd.init()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg = dataclasses.replace(bert.BERT_TINY, dropout_rate=0.0,
                                  num_layers=2)
        torch.manual_seed(0)
        with torch.device(cuda_device):
            model = bert.Bert(cfg, attention_fn=bert.flash_attention_fn)
        ids = torch.randint(0, cfg.vocab_size, (4, 128),
                            generator=torch.Generator().manual_seed(1))
        ids = ids.to(cuda_device)

        def loss_of(params):
            _, logits = torch.func.functional_call(model, params, (ids,))
            return logits.float().square().mean()

        loss_of(dict(model.named_parameters())).backward()
        want = [p.grad.clone() for p in model.parameters()]
        model.zero_grad(set_to_none=True)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1))
        synced = hvd.overlap_gradient_sync(
            dict(model.named_parameters()), hvd.reduce_spec_of(opt),
            num_segments=3)
        loss_of(synced).backward()
        assert opt._passes == {} and opt._launched == {}
        assert all(torch.equal(p.grad, w)
                   for p, w in zip(model.parameters(), want))
        opt.remove_hooks()
    finally:
        torch.use_deterministic_algorithms(False)
        hvd.shutdown()


@pytest.mark.cuda
def test_integrity_summaries_on_the_card_equal_the_host_sums(cuda_device):
    """A tree of card tensors (float32, bfloat16 with NaN and Inf, int64)
    digests as its host copy does, bit for bit, and summarizes on the
    card: the finite counts exact, the L2 within 1e-12 of the host's
    float64 numpy sums."""
    from horovod_tpu_torch import integrity

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"w": torch.randn(3000, 700, generator=gen, device=cuda_device),
            "b": torch.randn(5000, generator=gen,
                             device=cuda_device).to(torch.bfloat16),
            "n": torch.arange(17, device=cuda_device),
            "s": torch.tensor(2.5, device=cuda_device)}
    tree["b"][7] = float("nan")
    tree["b"][9] = float("inf")
    host = {k: v.cpu() for k, v in tree.items()}
    assert integrity.digest_tree(tree) == integrity.digest_tree(host)
    got = integrity.summarize_tree(tree, buckets=4)
    want = integrity.summarize_tree(host, buckets=4)
    assert [(b["n"], b["finite"]) for b in got] == \
        [(b["n"], b["finite"]) for b in want]
    for g, w in zip(got, want):
        assert abs(g["l2"] - w["l2"]) <= 1e-12 * w["l2"]


@pytest.mark.cuda
def test_integrity_corrupts_a_card_snapshot_not_the_live_tensor(
        cuda_device):
    """grad.corrupt on a snapshot of card tensors: the corrupted leaf is a
    new tensor on the card with the host path's bytes, and the tensor the
    snapshot was taken from is untouched."""
    from horovod_tpu_torch import faults, integrity

    live = torch.ones(4096, device=cuda_device)
    faults.reset()
    try:
        for tree in ({"w": live}, {"w": live.cpu()}):
            faults.reset()
            faults.inject(faults.GRAD_CORRUPT, "corrupt", arg=64, at=1,
                          count=1)
            out = integrity.maybe_corrupt_snapshot({"params": tree})
            if tree["w"].is_cuda:
                card = out["params"]["w"]
            else:
                host = out["params"]["w"]
    finally:
        faults.reset()
    assert card.is_cuda and card.data_ptr() != live.data_ptr()
    assert torch.equal(card.cpu(), host) and not torch.equal(host,
                                                             live.cpu())
    assert torch.equal(live, torch.ones(4096, device=cuda_device))


@pytest.mark.cuda
def test_the_abort_tripwire_on_the_card(cuda_device, monkeypatch):
    """HOROVOD_NONFINITE_ACTION=abort on the card, one rank, the wire
    forced: the NaN step's update is skipped, the detection counted, and
    the coordinated abort armed (the next guarded site raises)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import abort, integrity

    monkeypatch.setenv("HOROVOD_FORCE_WIRE_MACHINERY", "1")
    monkeypatch.setenv("HOROVOD_NONFINITE_ACTION", "abort")
    integrity.reset_for_testing()
    hvd.init()
    try:
        w = torch.nn.Parameter(torch.ones(1024, device=cuda_device))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0))
        (w * torch.full_like(w, float("nan"))).sum().backward()
        opt.step()
        assert torch.equal(w.detach(), torch.ones_like(w))
        assert opt.nonfinite_steps == 1
        assert integrity.summary()["nonfinite_detections"] == 1
        with pytest.raises(hvd.HorovodInternalError, match="non-finite"):
            abort.raise_if_aborted()
        opt.remove_hooks()
    finally:
        abort.reset()
        hvd.shutdown()
