"""Head dims above 256 (the port's wide-head route) against the JAX
package's flash attention.

The reference takes any head dim (``horovod_tpu/ops/attention.py:
_prepare_flash`` sets no limit). The port sends D > 256 to its wide-head
kernels (``csrc/flash_attention_wide.cu``), zero-padded to a multiple of
``WIDE_CHUNK`` with the scale of the true D; on the CPU the wrappers
compute the kernels' plain versions. Here forward (out, lse), dQ, dK, dV
and the lse cotangent's share of them are held to
``flash_attention_lse`` of the JAX package in interpret mode, on the same
seeded numpy inputs, at D = 320 and 512, S = 64 and 160, causal with
offsets (rows that see no key included) and not. Tolerance: float32,
1e-5 absolute and relative (the two sides sum in different orders over up
to 512 columns). The kernels against their plain versions on the card are
in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import attention as port
from test_torch_attention import _inputs, _jax_run, _port_run

TOL = dict(rtol=1e-5, atol=1e-5)

# name, (B, H, Sq, Sk, D), causal, q_offset, k_offset, JAX block (None: auto)
CASES = [
    ("d320_s64", (1, 2, 64, 64, 320), False, 0, 0, None),
    ("d512_s64_causal", (1, 2, 64, 64, 512), True, 0, 0, None),
    ("d320_s160_causal_offsets", (1, 2, 160, 160, 320), True, 0, 32, 32),
    ("d512_s160", (2, 1, 160, 160, 512), False, 0, 0, 32),
    # Rows 0..15 see no key.
    ("d512_causal_masked_rows", (1, 1, 64, 80, 512), True, 0, 16, 16),
    ("d320_causal_q_offset", (1, 2, 64, 160, 320), True, 96, 0, 32),
]


@pytest.mark.parametrize("name,shape,causal,q_offset,k_offset,block", CASES,
                         ids=[c[0] for c in CASES])
def test_wide_heads_match_pallas(name, shape, causal, q_offset, k_offset,
                                 block):
    assert port.wide_route(shape[-1])
    args = _inputs(shape, seed=len(name))
    want = _jax_run(*args, causal, q_offset, k_offset, block)
    got = _port_run(*args, causal, q_offset, k_offset)
    for label, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=f"{name}: {label}", **TOL)


@pytest.mark.parametrize("D", [257, 300, 320, 1000])
def test_wide_plan_pads_to_the_chunk_and_equals_the_plain_version(D):
    """The wide route's plan: D zero-padded to the next multiple of
    WIDE_CHUNK with the scale of the true D, outputs sliced back, equals
    the plain version at D (forward and the three gradients), to TOL: the
    padded zeros are exact, the order of the sums over D is not."""
    Dk = port.kernel_head_dim(D)
    assert Dk % port.WIDE_CHUNK == 0 and D <= Dk < D + port.WIDE_CHUNK
    rng = np.random.RandomState(D)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 24, D).astype(np.float32))
                   for _ in range(4))
    glse = torch.from_numpy(rng.randn(2, 24).astype(np.float32))
    o, lse = port.padded_heads(port.flash_fwd_plain, (q, k, v), (), True, 0,
                               0)
    o_ref, lse_ref = port.flash_fwd_plain(q, k, v, True)
    delta = (do * o_ref).sum(-1)
    rows = (lse_ref, delta, glse)
    dq = port.padded_heads(port.flash_dq_plain, (q, k, v, do), rows, True, 0,
                           0)
    dk, dv = port.padded_heads(port.flash_dkv_plain, (q, k, v, do), rows,
                               True, 0, 0)
    for got, want in ((o, o_ref), (lse, lse_ref),
                      (dq, port.flash_dq_plain(q, k, v, do, *rows, True)),
                      *zip((dk, dv), port.flash_dkv_plain(q, k, v, do, *rows,
                                                          True))):
        assert got.shape == want.shape and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_wide_operand_check_takes_chunk_multiples_above_256():
    """The wide kernels' operand check (run before a launch on the card):
    head dims above 256 that are multiples of WIDE_CHUNK, nothing else."""
    for D, ok in ((288, True), (1024, True), (300, False), (256, False)):
        t = torch.zeros(1, 4, D)
        if ok:
            assert port._check_kernel_operands((t, t, t), dims=None)[2] == D
        else:
            with pytest.raises(ValueError, match="wide-head kernels"):
                port._check_kernel_operands((t, t, t), dims=None)


def test_build_report_counts_wide_instances_and_spills():
    """chip_smoke.py's build checks of the wide-head instances, on ptxas
    lines shaped like nvcc's (mangled names as the card's build prints
    them): the 6 bf16 and float16 forward, dQ and dK/dV instances and the 3
    float32 ones on the tensor cores (flash_*_wide_3xtf32_kernel, not
    templated), with the float32 filter gradient (dw_1x1_3xtf32_kernel),
    are all in the Hopper report; none stays SIMT, and a spill in the
    float32 forward is named."""
    from test_torch_attention import _chip_smoke

    smoke = _chip_smoke()
    prefix = "_ZN56_GLOBAL__N__0aa40730_23_flash_attention_wide_cu_a3104e78"
    prefix3 = "_ZN58_GLOBAL__N__1bb51841_25_flash_attention_3xtf32_cu_b4215f89"
    prefix_dw = "_ZN46_GLOBAL__N__58d058b5_13_conv1x1_dw_cu_fb57b3b6"
    types = {"f": "f32", "6__half": "f16", "13__nv_bfloat16": "bf16"}
    params3 = {"flash_fwd_wide": "S0_S0_PfS1_iiiifiii",
               "flash_dq_wide": "S0_S0_S0_PfPKfS3_S3_iiiifiii",
               "flash_dkv_wide": "S0_S0_S0_PfS1_P6float4PKfS5_S5_iiiifiii"}
    hopper, symbols = [], {}
    for kern in ("flash_fwd_wide", "flash_dq_wide", "flash_dkv_wide"):
        for mangled, t in types.items():
            if t != "f32":
                name = kern + "_kernel"
                hopper.append(f"{name}<{t}>")
                symbols[hopper[-1]] = f"{prefix}{len(name)}{name}I{mangled}EEvPKT_"
            else:
                name = kern + "_3xtf32_kernel"
                hopper.append(name)
                symbols[name] = (f"{prefix3}{len(name)}{name}E14CUtensorMap_st"
                                 + params3[kern])
    hopper.append("dw_1x1_3xtf32_kernel")
    symbols["dw_1x1_3xtf32_kernel"] = (
        f"{prefix_dw}20dw_1x1_3xtf32_kernelE14CUtensorMap_stS0_Pfiiiiiiiiiiii")

    def log(spilling=None):
        lines = []
        for inst, symbol in symbols.items():
            spill = ("8 bytes spill stores, 8 bytes spill loads"
                     if inst == spilling
                     else "0 bytes spill stores, 0 bytes spill loads")
            lines += [f"ptxas info    : Compiling entry function "
                      f"'{symbol}' for 'sm_90a'",
                      f"    0 bytes stack frame, {spill}",
                      "ptxas info    : Used 168 registers, used 1 barriers"]
        return "\n".join(lines)

    hopper_regs, hopper_faults = smoke.hopper_build_report(log())
    assert sorted(hopper_regs) == sorted(hopper) and len(hopper) == 10
    assert {"flash_fwd_wide_3xtf32_kernel", "flash_dq_wide_3xtf32_kernel",
            "flash_dkv_wide_3xtf32_kernel",
            "dw_1x1_3xtf32_kernel"} <= set(smoke.HOPPER_INSTANCES)
    assert set(hopper_regs.values()) == {168} and hopper_faults == []
    assert not hasattr(smoke, "WIDE_SIMT_INSTANCES")
    _, faults = smoke.hopper_build_report(log("flash_fwd_wide_3xtf32_kernel"))
    assert len(faults) == 1 and faults[0].startswith(
        "flash_fwd_wide_3xtf32_kernel:")


@pytest.mark.parametrize("D", [288, 512, 1024])
def test_chip_smoke_bounds_the_wide_float32_backward_in_3xtf32(D):
    """chip_smoke.py holds the float32 wide-head forward, dQ and dK/dV
    (3xTF32, one instance each at every D above 256) to three TF32 products
    at 495 TFLOP/s with the FMA bound beside it: at B*H = 32, S = 512,
    D = 512 the forward 0.1041 ms, dQ 0.1562 ms and dK/dV 0.2082 ms, all
    bound by operations."""
    from test_torch_attention import _chip_smoke

    smoke = _chip_smoke()
    BH, S = 32, 512
    assert smoke._runs_3xtf32("flash_fwd", D)
    for name, products, at_512 in (("flash_fwd", 2, 0.1041),
                                   ("flash_dq", 3, 0.1562),
                                   ("flash_dkv", 4, 0.2082)):
        assert smoke._runs_3xtf32(name, D)
        ms, by, flops, moved = smoke._bounds_3xtf32(name, BH, S, S, D, False,
                                                    0, 0)
        assert by == "operations"
        assert flops == 3 * 2 * products * BH * S * S * D
        assert ms == pytest.approx(flops / smoke.PEAK_TF32 * 1e3)
        operands, rows = {"flash_fwd": (4, 1), "flash_dq": (5, 3),
                          "flash_dkv": (6, 3)}[name]
        assert moved == operands * BH * S * D * 4 + rows * BH * S * 4
        if D == 512:
            assert round(ms, 4) == at_512
        bounds, fma = smoke._kernel_bounds(name, BH, S, S, D, "float32", False,
                                           0, 0)
        assert bounds == (ms, by, flops, moved)
        assert fma == pytest.approx(flops / 3 / 67e12 * 1e3)


def test_kernels_line_has_the_wide_float32_backward_rows():
    """chip_smoke.py's kernels line has flash_fwd_wide_float32,
    flash_dq_wide_float32 and flash_dkv_wide_float32, from
    flash_attention_3xtf32.cu, and dw_1x1_float32 from conv1x1_dw.cu, each
    on its wrapper's launch counter; every row name is unique."""
    from horovod_tpu_torch.ops import _kernels
    from test_torch_attention import _chip_smoke

    rows = {name: (k, source) for name, k, source in
            _chip_smoke().kernel_rows()}
    assert len(rows) == len(_chip_smoke().kernel_rows())
    assert rows["flash_fwd_wide_float32"] == (_kernels.FLASH_FWD_WIDE,
                                              "flash_attention_3xtf32.cu")
    assert rows["flash_dq_wide_float32"] == (_kernels.FLASH_DQ_WIDE,
                                             "flash_attention_3xtf32.cu")
    assert rows["dw_1x1_float32"] == (_kernels.DW_1X1, "conv1x1_dw.cu")
    assert rows["flash_dkv_wide_float32"] == (_kernels.FLASH_DKV_WIDE,
                                              "flash_attention_3xtf32.cu")
    assert rows["flash_dq_wide"] == (_kernels.FLASH_DQ_WIDE,
                                     "flash_attention_wide.cu")
