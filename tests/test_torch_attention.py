"""The port's flash attention (horovod_tpu_torch.ops.attention) against the
JAX package's Pallas kernels.

On the CPU the port's wrappers compute the plain PyTorch version of each
kernel; the JAX side runs its Pallas kernels in interpret mode, so these
tests hold the port's arithmetic to the TPU kernels' function: explicit
small blocks reach JAX's multi-tile kernels (forward, dQ, dK/dV), default
blocks on a one-tile sequence reach the single-tile forward and the fused
backward (checked from the ``(BH,)`` grids in the jaxpr). The port routes
sequences of at most ``SINGLE_TILE_MAX`` rows to its single-tile kernels
and longer ones to its multi-tile kernels; both routes are held to JAX.
Inputs are made by numpy from a seed. Tolerance: float32, 1e-5 absolute
and relative (the two sides sum in different orders).

The ``cuda`` tests hold the hand-written kernels against the plain
versions on the card; they skip where there is no GPU.
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import attention as jax_attn
from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.ops import attention as port

TOL = dict(rtol=1e-5, atol=1e-5)

# name, (B, H, Sq, Sk, D), causal, q_offset, k_offset, JAX block (None: auto)
CASES = [
    ("multi_tile", (1, 2, 64, 64, 16), False, 0, 0, 16),
    ("single_tile", (1, 2, 64, 64, 16), False, 0, 0, None),
    ("causal_multi_tile", (2, 2, 64, 64, 16), True, 0, 0, 16),
    # Rows 0..15 see no key (q_offset + i < k_offset + j for every j).
    ("causal_offsets_masked_rows", (1, 2, 32, 48, 16), True, 0, 16, 16),
    ("causal_single_tile_offsets", (1, 1, 32, 48, 32), True, 16, 0, None),
    # Single-tile cases at the port's cap, through JAX's default blocks.
    ("single_tile_s128", (1, 2, 128, 128, 64), False, 0, 0, None),
    # Rows 0..39 see no key; g_lse is nonzero in every case.
    ("causal_single_tile_masked_rows", (1, 2, 96, 128, 16), True, 0, 40,
     None),
]
# Cases whose JAX side takes the single-tile kernels (Sq == block_q and
# Sk == block_k, horovod_tpu/ops/attention.py:399 and :469).
SINGLE_TILE_CASES = ("single_tile", "causal_single_tile_offsets",
                     "single_tile_s128", "causal_single_tile_masked_rows")


def _inputs(shape, seed):
    B, H, Sq, Sk, D = shape
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Sq, D).astype(np.float32)
    k = rng.randn(B, H, Sk, D).astype(np.float32)
    v = rng.randn(B, H, Sk, D).astype(np.float32)
    g = rng.randn(B, H, Sq, D).astype(np.float32)
    g_lse = rng.randn(B, H, Sq).astype(np.float32)
    return q, k, v, g, g_lse


def _jax_run(q, k, v, g, g_lse, causal, q_offset, k_offset, block):
    def f(q, k, v):
        return jax_attn.flash_attention_lse(
            q, k, v, causal=causal, block_q=block, block_k=block,
            q_offset=q_offset, k_offset=k_offset, interpret=True)

    (out, lse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v))
    dq, dk, dv = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    return [np.asarray(a) for a in (out, lse, dq, dk, dv)]


def _pallas_grids(q, k, v, g, g_lse, causal, q_offset, k_offset, block):
    """The grid of every pallas_call in JAX's forward and backward."""
    def fwd_bwd(q, k, v, g, g_lse):
        _, vjp = jax.vjp(lambda q, k, v: jax_attn.flash_attention_lse(
            q, k, v, causal=causal, block_q=block, block_k=block,
            q_offset=q_offset, k_offset=k_offset, interpret=True), q, k, v)
        return vjp((g, g_lse))

    def walk(jaxpr, grids):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                grids.append(tuple(eqn.params["grid_mapping"].grid))
            for param in eqn.params.values():
                for sub in (param if isinstance(param, (list, tuple))
                            else [param]):
                    inner = getattr(sub, "jaxpr", sub)
                    inner = getattr(inner, "jaxpr", inner)
                    if hasattr(inner, "eqns"):
                        walk(inner, grids)
        return grids

    args = [jnp.asarray(a) for a in (q, k, v, g, g_lse)]
    return walk(jax.make_jaxpr(fwd_bwd)(*args).jaxpr, [])


def _port_run(q, k, v, g, g_lse, causal, q_offset, k_offset):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = port.flash_attention_lse(qt, kt, vt, causal=causal,
                                        q_offset=q_offset, k_offset=k_offset)
    torch.autograd.backward([out, lse],
                            [torch.from_numpy(g), torch.from_numpy(g_lse)])
    return [t.detach().numpy() for t in (out, lse, qt.grad, kt.grad,
                                         vt.grad)]


@pytest.mark.parametrize("name,shape,causal,q_offset,k_offset,block", CASES,
                         ids=[c[0] for c in CASES])
def test_forward_lse_and_grads_match_pallas(name, shape, causal, q_offset,
                                            k_offset, block):
    args = _inputs(shape, seed=len(name))
    want = _jax_run(*args, causal, q_offset, k_offset, block)
    got = _port_run(*args, causal, q_offset, k_offset)
    for label, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=f"{name}: {label}", **TOL)
    if name in SINGLE_TILE_CASES:
        # One single-tile forward and one fused backward, grid (BH,).
        B, H = shape[:2]
        assert _pallas_grids(*args, causal, q_offset, k_offset, block) == [
            (B * H,), (B * H,)]


def test_port_multi_tile_route_matches_jax_single_tile_kernels():
    """S = 129 is one row past the port's cap: the port takes its
    multi-tile kernels, JAX (blocks of 129) its single-tile ones. Both
    compute one function."""
    args = _inputs((1, 2, 129, 129, 16), seed=11)
    assert _pallas_grids(*args, False, 0, 0, 129) == [(2,), (2,)]
    want = _jax_run(*args, False, 0, 0, 129)
    got = _port_run(*args, False, 0, 0)
    for label, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=label, **TOL)


@pytest.mark.parametrize("S,single", [(128, True), (129, False),
                                      (96, True)])
def test_route_follows_the_single_tile_cap(monkeypatch, S, single):
    calls = []
    for name in ("flash_fwd", "flash_dq", "flash_dkv", "flash_fwd_single",
                 "flash_dqkv"):
        def spy(*a, _name=name, _fn=getattr(port, name), **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(port, name, spy)
    q, k, v, g, g_lse = _inputs((1, 1, S, S, 8), seed=13)
    _port_run(q, k, v, g, g_lse, True, 0, 0)
    want = (["flash_fwd_single", "flash_dqkv"] if single
            else ["flash_fwd", "flash_dq", "flash_dkv"])
    assert calls == want


def test_single_tile_wrappers_refuse_longer_sequences():
    q = torch.zeros(1, port.SINGLE_TILE_MAX + 1, 8)
    k = torch.zeros(1, 16, 8)
    rows = torch.zeros(1, port.SINGLE_TILE_MAX + 1)
    with pytest.raises(ValueError, match="at most 128"):
        port.flash_fwd_single(q, k, k)
    with pytest.raises(ValueError, match="at most 128"):
        port.flash_dqkv(q, k, k, q, rows, rows, rows)


def test_fully_masked_rows_give_zero_output_and_sentinel():
    q, k, v, g, g_lse = _inputs((1, 2, 32, 48, 16), seed=3)
    out, lse, dq, _, _ = _port_run(q, k, v, g, g_lse, True, 0, 16)
    assert np.all(out[:, :, :16] == 0.0)
    assert np.all(lse[:, :, :16] == port.LSE_MASKED)
    assert np.all(dq[:, :, :16] == 0.0)
    assert np.all(np.isfinite(lse[:, :, 16:]))


def test_gradient_through_lse_only():
    """A zero output cotangent with a nonzero lse cotangent still moves
    dQ/dK (dS = P * g_lse) and leaves dV at zero."""
    q, k, v, _, g_lse = _inputs((1, 2, 32, 32, 16), seed=5)
    g = np.zeros_like(q)
    want = _jax_run(q, k, v, g, g_lse, False, 0, 0, 16)
    got = _port_run(q, k, v, g, g_lse, False, 0, 0)
    for g_arr, w_arr in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g_arr, w_arr, **TOL)
    assert np.abs(got[2]).max() > 0 and np.all(got[4] == 0.0)


def test_gradient_through_lse_only_single_tile():
    """The same through JAX's fused single-tile backward and the port's
    single-tile route."""
    q, k, v, _, g_lse = _inputs((1, 2, 64, 64, 16), seed=6)
    g = np.zeros_like(q)
    assert _pallas_grids(q, k, v, g, g_lse, False, 0, 0, None) == [(2,),
                                                                   (2,)]
    want = _jax_run(q, k, v, g, g_lse, False, 0, 0, None)
    got = _port_run(q, k, v, g, g_lse, False, 0, 0)
    for g_arr, w_arr in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g_arr, w_arr, **TOL)
    assert np.abs(got[2]).max() > 0 and np.all(got[4] == 0.0)


@pytest.mark.parametrize("causal,q_offset,k_offset", [
    (False, 0, 0), (True, 0, 0), (True, 8, 0)])
def test_blockwise_reference_matches_jax_reference(causal, q_offset,
                                                   k_offset):
    q, k, v, _, _ = _inputs((1, 2, 24, 24, 8), seed=7)
    want = np.asarray(jax_attn.blockwise_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_size=8, q_offset=q_offset, k_offset=k_offset))
    got = port.blockwise_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_size=8, q_offset=q_offset,
        k_offset=k_offset).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_mixed_dtypes_raise_like_jax():
    q = np.zeros((1, 1, 16, 8), np.float32)
    with pytest.raises(ValueError, match="share a dtype"):
        jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(q),
                                 jnp.asarray(q, jnp.bfloat16), interpret=True)
    t = torch.zeros(1, 1, 16, 8)
    with pytest.raises(ValueError, match="share a dtype"):
        port.flash_attention(t, t, t.to(torch.bfloat16))


def test_ambiguous_causal_alignment_raises_like_jax():
    q = np.zeros((1, 1, 16, 8), np.float32)
    kv = np.zeros((1, 1, 32, 8), np.float32)
    with pytest.raises(ValueError, match="ambiguous"):
        jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(kv),
                                 jnp.asarray(kv), causal=True,
                                 interpret=True)
    with pytest.raises(ValueError, match="ambiguous"):
        port.flash_attention(torch.from_numpy(q), torch.from_numpy(kv),
                             torch.from_numpy(kv), causal=True)
    # Explicit offsets make it unambiguous.
    port.flash_attention(torch.from_numpy(q), torch.from_numpy(kv),
                         torch.from_numpy(kv), causal=True, q_offset=16)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v, g, g_lse = (torch.from_numpy(a)
                         for a in _inputs((1, 2, 16, 16, 8), seed=9))
    before = [kern.launches for kern in _kernels.KERNELS]
    qr, kr, vr, do = (t.reshape(2, 16, 8) for t in (q, k, v, g))
    out, lse = port.flash_fwd(qr, kr, vr)
    want_out, want_lse = port.flash_fwd_plain(qr, kr, vr)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    delta = (do * out).sum(-1)
    glse = g_lse.reshape(2, 16)
    assert torch.equal(port.flash_dq(qr, kr, vr, do, lse, delta, glse),
                       port.flash_dq_plain(qr, kr, vr, do, lse, delta, glse))
    for a, b in zip(port.flash_dkv(qr, kr, vr, do, lse, delta, glse),
                    port.flash_dkv_plain(qr, kr, vr, do, lse, delta, glse)):
        assert torch.equal(a, b)
    single = port.flash_fwd_single(qr, kr, vr)
    for a, b in zip(single, port.flash_fwd_single_plain(qr, kr, vr)):
        assert torch.equal(a, b)
    for a, b in zip(port.flash_dqkv(qr, kr, vr, do, lse, delta, glse),
                    port.flash_dqkv_plain(qr, kr, vr, do, lse, delta, glse)):
        assert torch.equal(a, b)
    assert [kern.launches for kern in _kernels.KERNELS] == before


def test_other_devices_raise_instead_of_falling_back():
    t = torch.empty(2, 16, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        port.flash_fwd(t, t, t)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        port.flash_fwd_single(t, t, t)
    rows = torch.empty(2, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        port.flash_dqkv(t, t, t, t, rows, rows, rows)


def test_build_hash_covers_every_csrc_file():
    """Every source and header under csrc/ feeds the build's content hash,
    so an edit to any of them rebuilds the library on the card."""
    on_disk = {f for f in os.listdir(_kernels.CSRC_DIR)
               if f.endswith((".cu", ".cuh"))}
    assert on_disk == set(_kernels.SOURCES) | set(_kernels.HEADERS)
    assert not set(_kernels.SOURCES) & set(_kernels.HEADERS)


def _global_functions():
    """Names of the __global__ functions in csrc/*.cu."""
    names = set()
    for f in _kernels.SOURCES:
        with open(os.path.join(_kernels.CSRC_DIR, f)) as src:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*\(", src.read()))
    return names


def _chip_smoke():
    """chip_smoke.py as a module (its top-level imports are the standard
    library's)."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_profile_categories_name_kernels_in_the_sources():
    """chip_smoke.py attributes device time to the port's kernels by
    substrings of the kernel names: each of them must name a __global__
    function of the sources, or the profile would book that kernel's time
    as "other"."""
    smoke = _chip_smoke()
    kernels = _global_functions()
    assert {"flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
            "flash_fwd_single_kernel", "flash_dq_f32_kernel",
            "flash_fwd_single_f32_kernel"} <= kernels
    categories = dict(smoke._CATEGORIES)
    for kern in _kernels.KERNELS:
        for key in categories[kern.name]:
            assert key in kernels, (kern.name, key)
    # Every kernel of the library falls into some port category.
    for name in kernels:
        hits = [c for c, keys in smoke._CATEGORIES
                if any(k in name.lower() for k in keys)]
        assert hits and hits[0] in {k.name for k in _kernels.KERNELS}, name


def _ptxas_entry(mangled, spills="0 bytes spill stores, 0 bytes spill loads",
                 registers=168):
    """One kernel's lines in nvcc's -Xptxas -v output."""
    return (f"ptxas info    : Compiling entry function '{mangled}' for "
            f"'sm_90a'\nptxas info    : Function properties for {mangled}\n"
            f"    0 bytes stack frame, {spills}\nptxas info    : Used "
            f"{registers} registers, used 16 barriers, 400 bytes cmem[0]\n")


_HOPPER_INSTANCES = [(k, d) for k in ("flash_fwd_kernel", "flash_dq_kernel",
                                       "flash_dkv_kernel",
                                       "flash_fwd_single_kernel",
                                       "flash_dqkv_kernel")
                     for d in (16, 32, 64, 128)] + [("dw_1x1_kernel", None)]


def _hopper_mangled(kernel, d):
    """The mangled name nvcc gives a Hopper instance (d None: no template)."""
    if d is None:
        return (f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}E14CUtensorMap_stS0_"
                "Pfiiiiiiiiiii")
    name = f"{kernel}ILi{d}EEEv14CUtensorMap_stS1_S1_S1_Pfiiifiii"
    return f"_ZN12_GLOBAL__N_1{len(kernel)}{name}"


def _hopper_log():
    """A clean ptxas log of every Hopper instance, beside float32 kernels
    that spill (which do not count against the build)."""
    return (_ptxas_entry("_ZN12_GLOBAL__N_125dw_1x1_partial_f32_kernelEPKfS1"
                         "_Pfiiiiiixxx", "8 bytes spill stores, 8 bytes "
                         "spill loads", 255)
            + _ptxas_entry("_ZN12_GLOBAL__N_121flash_dqkv_f32_kernelILi64E"
                           "EEvPKfS2_S2_S2_S2_S2_S2_PfS3_S3_iifiii",
                           "4 bytes spill stores, 4 bytes spill loads", 128)
            + "".join(_ptxas_entry(_hopper_mangled(k, d))
                      for k, d in _HOPPER_INSTANCES))


@pytest.mark.parametrize("kernel,d,fault", [
    ("flash_dqkv_kernel", 16, "spill"),
    ("flash_dqkv_kernel", 64, "spill"),
    ("flash_dqkv_kernel", 128, "serialize"),
    ("flash_dqkv_kernel", 32, "serialize"),
    ("dw_1x1_kernel", None, "spill"),
    ("dw_1x1_kernel", None, "serialize")])
def test_build_report_names_the_redesigned_hopper_culprit(kernel, d, fault):
    """The fused backward's and the filter gradient's Hopper instances are
    in the build phase's list, and a spill or serialized wgmma in one of
    them fails it, naming that instance alone."""
    smoke = _chip_smoke()
    clean = _hopper_log()
    regs, faults = smoke.hopper_build_report(clean)
    assert sorted(regs) == sorted(smoke.HOPPER_INSTANCES) and faults == []
    mangled = _hopper_mangled(kernel, d)
    if fault == "spill":
        log = clean.replace(_ptxas_entry(mangled), _ptxas_entry(
            mangled, "240 bytes spill stores, 252 bytes spill loads"))
    else:
        log = clean + (
            "ptxas info    : (C7512) Potential Performance Loss: "
            "wgmma.mma_async instructions are serialized due to insufficient "
            f"register resources for the wgmma pipeline in the function "
            f"'{mangled}'\n")
    _, faults = smoke.hopper_build_report(log)
    culprit = kernel if d is None else f"{kernel}<{d}>"
    assert len(faults) == 1 and faults[0].startswith(culprit + ":"), faults


def test_build_report_flags_spills_and_serialized_wgmma_of_hopper_kernels():
    """chip_smoke.py's build phase fails when a Hopper (wgmma) instance
    spills or ptxas serializes its wgmma; other kernels' lines do not
    count against it."""
    smoke = _chip_smoke()

    hopper = _hopper_mangled
    instances = _HOPPER_INSTANCES
    others = (_ptxas_entry("_ZN12_GLOBAL__N_119flash_dq_f32_kernelILi64EEE"
                           "vPKfS2_S2_S2_S2_S2_S2_Pfiifiii", "8 bytes spill "
                           "stores, 8 bytes spill loads", 255)
              + _ptxas_entry("_ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi64"
                             "EEEvPKfS2_S2_PfS3_iiifiii", registers=96)
              + _ptxas_entry("_ZN12_GLOBAL__N_127flash_fwd_single_f32_kernel"
                             "ILi32EEEvPKfS2_S2_PfS3_iiifiii", "4 bytes spill "
                             "stores, 4 bytes spill loads", 128))
    clean = others + "".join(_ptxas_entry(hopper(k, d)) for k, d in instances)
    regs, faults = smoke.hopper_build_report(clean)
    assert sorted(regs) == sorted(smoke.HOPPER_INSTANCES)
    assert len(regs) == 21
    assert set(regs.values()) == {168} and faults == []

    def spill(log, kernel, d):
        return log.replace(
            _ptxas_entry(hopper(kernel, d)),
            _ptxas_entry(hopper(kernel, d), "240 bytes spill stores, 252 "
                         "bytes spill loads"))

    def serialize(log, kernel, d):
        return log + (
            "ptxas info    : (C7512) Potential Performance Loss: "
            "wgmma.mma_async instructions are serialized due to insufficient "
            "register resources for the wgmma pipeline in the function "
            f"'{hopper(kernel, d)}'\n")

    for log, culprit in (
            (spill(clean, "flash_dkv_kernel", 128), "flash_dkv_kernel<128>"),
            (spill(clean, "flash_dq_kernel", 64), "flash_dq_kernel<64>"),
            (serialize(clean, "flash_fwd_kernel", 32), "flash_fwd_kernel<32>"),
            (serialize(clean, "flash_fwd_single_kernel", 128),
             "flash_fwd_single_kernel<128>")):
        _, faults = smoke.hopper_build_report(log)
        assert len(faults) == 1 and faults[0].startswith(culprit), faults


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for "
                    "sm_90a and have no CPU mode)")
    return torch.device("cuda")


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
    (torch.bfloat16, 64, 77, 100, True, 0, 23)])
def test_kernels_match_plain_versions_on_the_card(cuda_device, dtype, D, Sq,
                                                  Sk, causal, q_offset,
                                                  k_offset):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    BH = 6

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dt)

    q, k, v, do = rnd(BH, Sq, D), rnd(BH, Sk, D), rnd(BH, Sk, D), rnd(BH, Sq, D)
    glse = rnd(BH, Sq, dt=torch.float32)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    o, lse = port.flash_fwd(q, k, v, causal, q_offset, k_offset)
    o_ref, lse_ref = port.flash_fwd_plain(q, k, v, causal, q_offset, k_offset)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, glse, causal, q_offset, k_offset)
    pairs = [(o, o_ref), (port.flash_dq(*args), port.flash_dq_plain(*args)),
             *zip(port.flash_dkv(*args), port.flash_dkv_plain(*args))]
    for got, want in pairs:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item()
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    assert torch.equal(lse == port.LSE_MASKED, lse_ref == port.LSE_MASKED)


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
    (torch.bfloat16, 64, 77, 100, True, 0, 23)])
def test_single_tile_kernels_match_plain_versions_on_the_card(
        cuda_device, dtype, D, Sq, Sk, causal, q_offset, k_offset):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    BH = 6

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dt)

    q, k, v, do = rnd(BH, Sq, D), rnd(BH, Sk, D), rnd(BH, Sk, D), rnd(BH, Sq, D)
    glse = rnd(BH, Sq, dt=torch.float32)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    o, lse = port.flash_fwd_single(q, k, v, causal, q_offset, k_offset)
    o_ref, lse_ref = port.flash_fwd_single_plain(q, k, v, causal, q_offset,
                                                 k_offset)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, glse, causal, q_offset, k_offset)
    pairs = [(o, o_ref), *zip(port.flash_dqkv(*args),
                              port.flash_dqkv_plain(*args))]
    for got, want in pairs:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item()
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    assert torch.equal(lse == port.LSE_MASKED, lse_ref == port.LSE_MASKED)
