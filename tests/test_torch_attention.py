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

Head dims without a kernel instance go to the next one, zero-padded
(``padded_heads``); the plan is held here on the plain versions, to 1e-6.
Head dims 129 to 256 take the port's multi-tile route at every sequence
length (the D = 256 instances); the JAX package runs them through its own
kernels by its blocks, single-tile at S = 64: the two agree in value.
The kernels against their plain versions on the card are in
``tests/test_torch_cuda.py``.
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
    # Head dims above 128 (the D = 256 instances; 200 is zero-padded to
    # 256) on both sequence regimes: the port's multi-tile route against
    # JAX's single-tile kernels (S = 64) and its multi-tile ones (S = 160).
    ("d256_s64", (1, 2, 64, 64, 256), False, 0, 0, None),
    ("d256_causal_s160", (1, 2, 160, 160, 256), True, 0, 0, 32),
    ("d200_causal_s64", (1, 2, 64, 64, 200), True, 0, 0, None),
    ("d200_s160", (1, 2, 160, 160, 200), False, 0, 0, 32),
]
# Cases whose JAX side takes the single-tile kernels (Sq == block_q and
# Sk == block_k, horovod_tpu/ops/attention.py:399 and :469).
SINGLE_TILE_CASES = ("single_tile", "causal_single_tile_offsets",
                     "single_tile_s128", "causal_single_tile_masked_rows",
                     "d256_s64", "d200_causal_s64")


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


@pytest.mark.parametrize("D", [129, 200, 256])
@pytest.mark.parametrize("S", [64, 160])
def test_head_dims_above_128_take_the_multi_tile_route(monkeypatch, S, D):
    """No single-tile kernel has a D = 256 instance: head dims 129 to 256
    plan the multi-tile kernels at every sequence length."""
    assert not port.single_tile_route(S, S, D)
    assert port.single_tile_route(64, 64, 128)
    calls = []
    for name in ("flash_fwd", "flash_dq", "flash_dkv", "flash_fwd_single",
                 "flash_dqkv"):
        def spy(*a, _name=name, _fn=getattr(port, name), **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(port, name, spy)
    _port_run(*_inputs((1, 1, S, S, D), seed=D), False, 0, 0)
    assert calls == ["flash_fwd", "flash_dq", "flash_dkv"]


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


@pytest.mark.parametrize("D,causal", [(64, False), (64, True), (512, False)])
def test_no_key_gives_zero_output_and_sentinel(D, causal):
    """With no key at all (Sk = 0) every row sees none: O = 0 and lse =
    LSE_MASKED, as the kernels write, and dQ = 0."""
    q = torch.randn(2, 40, D, generator=torch.Generator().manual_seed(0))
    k = q[:, :0]
    o, lse = port.flash_fwd(q, k, k, causal)
    assert o.shape == q.shape and torch.all(o == 0.0)
    assert lse.shape == q.shape[:2] and torch.all(lse == port.LSE_MASKED)
    dq = port.flash_dq(q, k, k, q, lse, lse, lse, causal)
    assert dq.shape == q.shape and torch.all(dq == 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_no_key_on_the_single_tile_route(causal):
    """The single-tile forward and fused backward with no key (Sk = 0): O = 0
    and lse = LSE_MASKED, dQ = 0, and dK, dV empty, as every route's kernels
    write."""
    q = torch.randn(2, 40, 64, generator=torch.Generator().manual_seed(1))
    k = q[:, :0]
    o, lse = port.flash_fwd_single(q, k, k, causal)
    assert o.shape == q.shape and torch.all(o == 0.0)
    assert lse.shape == q.shape[:2] and torch.all(lse == port.LSE_MASKED)
    dq, dk, dv = port.flash_dqkv(q, k, k, q, lse, lse, lse, causal)
    assert dq.shape == q.shape and torch.all(dq == 0.0)
    assert dk.shape == dv.shape == k.shape


@pytest.mark.parametrize("Sq,D", [(40, 64), (200, 64), (40, 512)])
def test_no_key_through_the_entry_point(Sq, D):
    """flash_attention_lse with no key, forward and backward, on each route
    (single-tile, multi-tile, wide): out = 0, lse = LSE_MASKED, and the
    gradients of q zero and of k, v empty."""
    gen = torch.Generator().manual_seed(Sq + D)
    q = torch.randn(1, 2, Sq, D, generator=gen).requires_grad_()
    k = torch.randn(1, 2, 0, D, generator=gen).requires_grad_()
    v = torch.randn(1, 2, 0, D, generator=gen).requires_grad_()
    out, lse = port.flash_attention_lse(q, k, v)
    assert torch.all(out == 0.0) and torch.all(lse == port.LSE_MASKED)
    (out.sum() + lse.sum()).backward()
    assert torch.all(q.grad == 0.0)
    assert k.grad.shape == k.shape and v.grad.shape == v.shape


@pytest.mark.parametrize("kernel,D", [("flash_dkv", 64), ("flash_dkv", 512),
                                      ("flash_dqkv", 64)])
def test_no_query_gives_zero_key_gradients(kernel, D):
    """With no query (Sq = 0) dK = dV = 0 (and the fused backward's dQ is
    empty), as every route's kernels write."""
    gen = torch.Generator().manual_seed(D)
    k = torch.randn(2, 40, D, generator=gen)
    q = k[:, :0]
    rows = torch.zeros(2, 0)
    out = getattr(port, kernel)(q, k, k, q, rows, rows, rows)
    dk, dv = out[-2:]
    assert dk.shape == dv.shape == k.shape
    assert torch.all(dk == 0.0) and torch.all(dv == 0.0)
    if kernel == "flash_dqkv":
        assert out[0].shape == q.shape


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
            "flash_fwd_single_kernel", "flash_dq_3xtf32_kernel",
            "flash_dkv_3xtf32_kernel", "flash_fwd_3xtf32_kernel",
            "flash_fwd_single_3xtf32_kernel"} <= kernels
    # The SIMT float32 dQ, dK/dV and fused backward are gone: every
    # float32 backward runs in 3xTF32.
    assert not {"flash_dq_f32_kernel", "flash_dkv_f32_kernel",
                "flash_dqkv_f32_kernel"} & kernels
    assert "flash_dqkv_3xtf32_kernel" in kernels
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


# nvcc's mangled names of the two element types.
_TYPES = {"bf16": "13__nv_bfloat16", "f16": "6__half"}
_HOPPER_INSTANCES = [(k, d, t) for k in ("flash_fwd_kernel", "flash_dq_kernel",
                                          "flash_dkv_kernel",
                                          "flash_fwd_single_kernel",
                                          "flash_dqkv_kernel")
                     for t in _TYPES for d in (16, 32, 64, 128)] + [
                         (k, 256, t) for k in ("flash_fwd_kernel",
                                               "flash_dq_kernel",
                                               "flash_dkv_kernel")
                         for t in _TYPES] + [
                         (k, None, t) for k in ("flash_fwd_wide_kernel",
                                                "flash_dq_wide_kernel",
                                                "flash_dkv_wide_kernel",
                                                "dw_1x1_kernel")
                         for t in _TYPES] + [
                         (k, d, None) for k in ("flash_fwd_3xtf32_kernel",
                                                "flash_dq_3xtf32_kernel",
                                                "flash_dkv_3xtf32_kernel")
                         for d in (32, 64, 128, 256)] + [
                         (k, d, None) for k in (
                             "flash_fwd_single_3xtf32_kernel",
                             "flash_dqkv_3xtf32_kernel")
                         for d in (32, 64, 128)] + [
                         (k, None, None) for k in (
                             "flash_fwd_wide_3xtf32_kernel",
                             "flash_dq_wide_3xtf32_kernel",
                             "flash_dkv_wide_3xtf32_kernel",
                             "dw_1x1_3xtf32_kernel")]


def _hopper_mangled(kernel, d, t="bf16"):
    """The mangled name nvcc gives a Hopper instance of element type t
    (d None: the filter gradient or a wide-head kernel, templated on the
    type alone; t None: the float32 3xTF32 kernels, templated on the head
    dim alone: the forwards, dQ, dK/dV and the fused backward, each with its
    parameters; both
    None: the float32 wide-head forward, dQ and dK/dV and the float32
    filter gradient, not templated)."""
    if t is None and d is None:
        params = {"flash_fwd_wide_3xtf32_kernel": "S0_S0_PfS1_iiiifiii",
                  "flash_dq_wide_3xtf32_kernel": "S0_S0_S0_PfPKfS3_S3_iiiifiii",
                  "flash_dkv_wide_3xtf32_kernel":
                      "S0_S0_S0_PfS2_PKfS3_S3_iiiifiii",
                  "dw_1x1_3xtf32_kernel": "S0_Pfiiiiiiiiiiii"}[kernel]
        return (f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}E14CUtensorMap_st"
                + params)
    if t is None:
        params = {"flash_dq_3xtf32_kernel": "S1_S1_S1_PfPKfS4_S4_iiifiii",
                  "flash_dkv_3xtf32_kernel": "S1_S1_S1_PfS2_PKfS4_S4_iiifiii",
                  "flash_dqkv_3xtf32_kernel":
                      "S1_S1_S1_PfS2_S2_PKfS4_S4_iiifiii"}
        return (f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}ILi{d}EEEv14"
                "CUtensorMap_st" + params.get(kernel, "S1_S1_PfS2_iiifiii"))
    if d is None:
        return (f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}I{_TYPES[t]}EEv14"
                "CUtensorMap_stS2_Pfiiiiiiiiiii")
    name = (f"{kernel}I{_TYPES[t]}Li{d}EEEv14CUtensorMap_stS2_S2_S2_"
            "Pfiiifiii")
    return f"_ZN12_GLOBAL__N_1{len(kernel)}{name}"


def _instance(kernel, d, t):
    if t is None:
        return kernel if d is None else f"{kernel}<{d}>"
    return f"{kernel}<{t}>" if d is None else f"{kernel}<{t}, {d}>"


# Kernels of the library that are no Hopper instance: the filter
# gradient's reduction and the forwards' fill of lse with no key.
_REDUCE = "_ZN12_GLOBAL__N_120dw_1x1_reduce_kernelEPKfPfim"
_NO_KEY = "_ZN12_GLOBAL__N_123flash_fwd_no_key_kernelEPfx"


def _hopper_log():
    """A clean ptxas log of every Hopper instance, beside other kernels
    that spill (which do not count against the build)."""
    return (_ptxas_entry(_NO_KEY, "8 bytes spill stores, 8 bytes spill loads",
                         255)
            + _ptxas_entry(_REDUCE, "4 bytes spill stores, 4 bytes spill loads",
                           128)
            + "".join(_ptxas_entry(_hopper_mangled(k, d, t))
                      for k, d, t in _HOPPER_INSTANCES))


@pytest.mark.parametrize("kernel,d,fault", [
    ("flash_dqkv_kernel", 16, "spill"),
    ("flash_dqkv_kernel", 64, "spill"),
    ("flash_dqkv_kernel", 128, "serialize"),
    ("flash_dqkv_kernel", 32, "serialize"),
    ("dw_1x1_kernel", None, "spill"),
    ("dw_1x1_kernel", None, "serialize"),
    ("flash_fwd_wide_kernel", None, "spill"),
    ("flash_fwd_wide_kernel", None, "serialize"),
    ("flash_dkv_wide_kernel", None, "spill"),
    ("flash_dkv_wide_kernel", None, "serialize"),
    ("flash_dq_wide_kernel", None, "spill"),
    ("flash_dq_wide_kernel", None, "serialize"),
    ("flash_dq_3xtf32_kernel", 32, "spill"),
    ("flash_dq_3xtf32_kernel", 64, "spill"),
    ("flash_dq_3xtf32_kernel", 128, "spill"),
    ("flash_dq_3xtf32_kernel", 256, "spill"),
    ("flash_dkv_3xtf32_kernel", 32, "spill"),
    ("flash_dkv_3xtf32_kernel", 64, "spill"),
    ("flash_dkv_3xtf32_kernel", 128, "spill"),
    ("flash_dkv_3xtf32_kernel", 256, "spill"),
    ("flash_fwd_3xtf32_kernel", 32, "spill"),
    ("flash_fwd_3xtf32_kernel", 64, "spill"),
    ("flash_fwd_3xtf32_kernel", 128, "spill"),
    ("flash_fwd_3xtf32_kernel", 256, "spill"),
    ("flash_fwd_single_3xtf32_kernel", 32, "spill"),
    ("flash_fwd_single_3xtf32_kernel", 64, "spill"),
    ("flash_fwd_single_3xtf32_kernel", 128, "spill"),
    ("flash_dqkv_3xtf32_kernel", 32, "spill"),
    ("flash_dqkv_3xtf32_kernel", 64, "spill"),
    ("flash_dqkv_3xtf32_kernel", 128, "spill"),
    ("flash_fwd_wide_3xtf32_kernel", None, "spill"),
    ("flash_dq_wide_3xtf32_kernel", None, "spill"),
    ("flash_dkv_wide_3xtf32_kernel", None, "spill"),
    ("dw_1x1_3xtf32_kernel", None, "spill")])
def test_build_report_names_the_redesigned_hopper_culprit(kernel, d, fault):
    """The fused backward's, the filter gradient's and the wide-head
    forward's, dQ's and dK/dV's bf16 Hopper instances, and the float32
    3xTF32 forwards, dQ, dK/dV and fused backward (each head dim alone, and
    the wide-head
    forward, dQ and dK/dV) and filter gradient, are in the build phase's
    list, and a spill or serialized wgmma in one of them fails it, naming
    that instance alone."""
    _check_culprit(kernel, d, None if "3xtf32" in kernel else "bf16", fault)


@pytest.mark.parametrize("kernel,d,fault", [
    ("flash_dqkv_kernel", 16, "spill"),
    ("flash_dqkv_kernel", 64, "spill"),
    ("flash_dqkv_kernel", 128, "serialize"),
    ("flash_fwd_kernel", 32, "serialize"),
    ("flash_dkv_kernel", 128, "spill"),
    ("dw_1x1_kernel", None, "spill"),
    ("dw_1x1_kernel", None, "serialize"),
    ("flash_fwd_kernel", 256, "spill"),
    ("flash_dq_kernel", 256, "serialize"),
    ("flash_dkv_kernel", 256, "spill"),
    ("flash_fwd_wide_kernel", None, "serialize"),
    ("flash_dkv_wide_kernel", None, "spill"),
    ("flash_dq_wide_kernel", None, "serialize")])
def test_build_report_names_the_float16_hopper_culprit(kernel, d, fault):
    """The same for the float16 instances: the culprit is named with its
    type, and its bf16 twin is not."""
    _check_culprit(kernel, d, "f16", fault)


def _check_culprit(kernel, d, t, fault):
    smoke = _chip_smoke()
    clean = _hopper_log()
    regs, faults = smoke.hopper_build_report(clean)
    assert sorted(regs) == sorted(smoke.HOPPER_INSTANCES) and faults == []
    mangled = _hopper_mangled(kernel, d, t)
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
    culprit = _instance(kernel, d, t)
    assert len(faults) == 1 and faults[0].startswith(culprit + ":"), faults


def test_build_report_flags_spills_and_serialized_wgmma_of_hopper_kernels():
    """chip_smoke.py's build phase fails when a Hopper (wgmma) instance
    spills or ptxas serializes its wgmma; other kernels' lines do not
    count against it."""
    smoke = _chip_smoke()

    hopper = _hopper_mangled
    instances = _HOPPER_INSTANCES
    others = (_ptxas_entry(_NO_KEY, "8 bytes spill stores, 8 bytes spill "
                           "loads", 255)
              + _ptxas_entry(_REDUCE, "4 bytes spill stores, 4 bytes spill "
                             "loads", 96))
    clean = others + "".join(_ptxas_entry(hopper(k, d, t))
                             for k, d, t in instances)
    regs, faults = smoke.hopper_build_report(clean)
    assert sorted(regs) == sorted(smoke.HOPPER_INSTANCES)
    assert len(regs) == 76
    assert set(regs.values()) == {168} and faults == []

    def spill(log, kernel, d, t):
        return log.replace(
            _ptxas_entry(hopper(kernel, d, t)),
            _ptxas_entry(hopper(kernel, d, t), "240 bytes spill stores, 252 "
                         "bytes spill loads"))

    def serialize(log, kernel, d, t):
        return log + (
            "ptxas info    : (C7512) Potential Performance Loss: "
            "wgmma.mma_async instructions are serialized due to insufficient "
            "register resources for the wgmma pipeline in the function "
            f"'{hopper(kernel, d, t)}'\n")

    for log, culprit in (
            (spill(clean, "flash_dkv_kernel", 128, "bf16"),
             "flash_dkv_kernel<bf16, 128>"),
            (spill(clean, "flash_dq_kernel", 64, "f16"),
             "flash_dq_kernel<f16, 64>"),
            (serialize(clean, "flash_fwd_kernel", 32, "bf16"),
             "flash_fwd_kernel<bf16, 32>"),
            (serialize(clean, "flash_fwd_single_kernel", 128, "f16"),
             "flash_fwd_single_kernel<f16, 128>"),
            (spill(clean, "flash_dkv_kernel", 256, "f16"),
             "flash_dkv_kernel<f16, 256>"),
            (serialize(clean, "flash_fwd_kernel", 256, "bf16"),
             "flash_fwd_kernel<bf16, 256>"),
            (spill(clean, "flash_fwd_3xtf32_kernel", 256, None),
             "flash_fwd_3xtf32_kernel<256>"),
            (spill(clean, "flash_fwd_single_3xtf32_kernel", 64, None),
             "flash_fwd_single_3xtf32_kernel<64>"),
            (spill(clean, "flash_dq_3xtf32_kernel", 64, None),
             "flash_dq_3xtf32_kernel<64>"),
            (spill(clean, "flash_dkv_3xtf32_kernel", 128, None),
             "flash_dkv_3xtf32_kernel<128>"),
            (spill(clean, "flash_dqkv_3xtf32_kernel", 64, None),
             "flash_dqkv_3xtf32_kernel<64>")):
        _, faults = smoke.hopper_build_report(log)
        assert len(faults) == 1 and faults[0].startswith(culprit), faults


@pytest.mark.parametrize("D,want", [(8, 16), (16, 16), (48, 64), (96, 128),
                                    (128, 128), (129, 256), (200, 256),
                                    (256, 256)])
def test_kernel_head_dim_is_the_next_instance(D, want):
    assert port.kernel_head_dim(D) == want


@pytest.mark.parametrize("D", [257, 512])
def test_head_dims_above_the_widest_instance_raise(D):
    """D > 256 no longer raises: it takes the wide-head route, zero-padded
    to a multiple of WIDE_CHUNK, and the public entry point on the CPU
    computes the plain version at D. Only D < 1 raises, naming the range."""
    assert port.wide_route(D)
    assert port.kernel_head_dim(D) == -(-D // port.WIDE_CHUNK) * port.WIDE_CHUNK
    t = torch.from_numpy(np.random.RandomState(D).randn(1, 2, 8, D).astype(
        np.float32))
    out = port.flash_attention(t, t, t)
    want, _ = port.flash_fwd_plain(*(x.reshape(2, 8, D) for x in (t, t, t)))
    assert torch.allclose(out.reshape(2, 8, D), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="1 to 256"):
        port.kernel_head_dim(0)


def test_single_tile_instances_stop_at_128():
    """The single-tile route's own plan has no D = 256 instance: its
    wrappers refuse D > 128 on the card, naming 128."""
    assert port.kernel_head_dim(100, port.SINGLE_TILE_HEAD_DIMS) == 128
    with pytest.raises(ValueError, match="1 to 128"):
        port.kernel_head_dim(129, port.SINGLE_TILE_HEAD_DIMS)


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("dtype,D,want", [
    (torch.float32, 8, 32), (torch.float32, 16, 32), (torch.float32, 48, 64),
    (torch.bfloat16, 16, 16)])
def test_float32_forwards_pad_head_dims_below_32(monkeypatch, single, dtype,
                                                 D, want):
    """The float32 forwards (3xTF32) read rows of 32 fp32 columns and have
    no D = 16 instance: both wrappers plan D <= 16 at 32 in float32 (and
    refuse a D = 16 operand at launch), where bf16 keeps 16. Shapes only,
    on the meta device, with the launch replaced by the plain version."""
    launched = []

    def fake_launch(kernel, dims):
        def run(q, k, v, causal, q_offset, k_offset, scale):
            launched.append((kernel.name, q.shape[-1], dims))
            return port.flash_fwd_plain(q, k, v, causal, q_offset, k_offset,
                                        scale)
        return run

    monkeypatch.setattr(port, "_fwd_launch", fake_launch)
    monkeypatch.setattr(port, "_check_device", lambda t: None)
    q = torch.empty(2, 40, D, device="meta", dtype=dtype)
    fwd = port.flash_fwd_single if single else port.flash_fwd
    o, lse = fwd(q, q, q)
    assert o.shape == q.shape and lse.shape == q.shape[:2]
    (name, planned, dims), = launched
    assert name == ("flash_fwd_single" if single else "flash_fwd")
    assert planned == want and want in dims
    assert (16 in dims) == (dtype != torch.float32)
    route = port.SINGLE_TILE_HEAD_DIMS if single else port.KERNEL_HEAD_DIMS
    assert dims == port.instance_head_dims(dtype, route)


@pytest.mark.parametrize("kernel", ["flash_dq", "flash_dkv", "flash_dqkv"])
@pytest.mark.parametrize("dtype,D,want", [
    (torch.float32, 8, 32), (torch.float32, 16, 32), (torch.float32, 100, 128),
    (torch.bfloat16, 16, 16)])
def test_float32_backward_pads_head_dims_below_32(monkeypatch, kernel, dtype,
                                                  D, want):
    """The float32 dQ, dK/dV and fused backward (3xTF32) have no D = 16
    instance either: their wrappers plan D <= 16 at 32 in float32, where
    bf16 keeps 16. Shapes only, on the meta device, with the launch
    replaced by the plain version."""
    launched = []
    plain = {"flash_dq": port.flash_dq_plain,
             "flash_dkv": port.flash_dkv_plain,
             "flash_dqkv": port.flash_dqkv_plain}

    def fake_launch(kern, dims):
        def run(*args):
            launched.append((kern.name, args[0].shape[-1], dims))
            return plain[kernel](*args)
        return run

    monkeypatch.setattr(port, "_dq_launch", fake_launch)
    monkeypatch.setattr(port, "_dkv_launch", fake_launch)
    monkeypatch.setattr(port, "_dqkv_launch",
                        lambda dims: fake_launch(_kernels.FLASH_DQKV, dims))
    monkeypatch.setattr(port, "_check_device", lambda t: None)
    q = torch.empty(2, 40, D, device="meta", dtype=dtype)
    rows = torch.empty(2, 40, device="meta")
    out = getattr(port, kernel)(q, q, q, q, rows, rows, rows)
    for t in out if isinstance(out, tuple) else (out,):
        assert t.shape == q.shape
    (name, planned, dims), = launched
    assert name == kernel and planned == want and want in dims
    route = (port.SINGLE_TILE_HEAD_DIMS if kernel == "flash_dqkv"
             else port.KERNEL_HEAD_DIMS)
    assert dims == port.instance_head_dims(dtype, route)


@pytest.mark.parametrize("D", [8, 16])
def test_float32_backward_padding_plan_holds_jax(D):
    """The plan of the float32 dQ and dK/dV (3xTF32, no instance below
    F32_MIN_HEAD_DIM): padded_heads at instance_head_dims(float32) pads
    D = 8 and 16 to 32; over the plain forward, dQ and dK/dV it gives the
    JAX package's flash attention gradients (its Pallas multi-tile kernels
    in interpret mode), causal with a query offset and a nonzero lse
    cotangent, to 1e-5."""
    shape = (1, 2, 64, 48, D)
    q, k, v, g, g_lse = _inputs(shape, seed=40 + D)
    causal = (True, 16, 0)
    _, _, *want = _jax_run(q, k, v, g, g_lse, *causal, 16)
    dims = port.instance_head_dims(torch.float32)
    assert port.kernel_head_dim(D, dims) == 32

    def flat(a):
        return torch.from_numpy(a).reshape(2, -1, D)

    qt, kt, vt, gt = (flat(a) for a in (q, k, v, g))
    o, lse = port.padded_heads(port.flash_fwd_plain, (qt, kt, vt), (),
                               *causal, dims)
    rows = (lse, (gt * o).sum(-1), torch.from_numpy(g_lse).reshape(2, -1))
    dq = port.padded_heads(port.flash_dq_plain, (qt, kt, vt, gt), rows,
                           *causal, dims)
    dk, dv = port.padded_heads(port.flash_dkv_plain, (qt, kt, vt, gt), rows,
                               *causal, dims)
    for got, w in zip((dq, dk, dv), want):
        assert got.shape[-1] == D
        np.testing.assert_allclose(got.numpy(), w.reshape(2, -1, D), **TOL)


@pytest.mark.parametrize("name,D", [
    (name, D) for name in ("flash_dq", "flash_dkv") for D in (16, 64, 100, 256)
] + [("flash_dqkv", D) for D in (16, 32, 64, 100, 128)])
def test_chip_smoke_knows_which_backward_runs_in_3xtf32(name, D):
    """chip_smoke.py bounds and checks a float32 kernel as 3xTF32 where it
    runs a TF32X3 instance: dQ and dK/dV at every head dim up to 256, the
    single-tile fused backward at every head dim up to 128 (D = 16 padded
    to 32, 100 to 128)."""
    smoke = _chip_smoke()
    assert smoke._runs_3xtf32(name, D) is True


@pytest.mark.parametrize("operands", ["plain", "tf32"])
def test_f64_check_of_the_forward_holds_the_plain_version_only(operands):
    """chip_smoke.py's float64 check of a forward: the float32 plain
    version's own O and lse pass it; O and lse computed from Q and K
    rounded to TF32 (the low 13 bits cleared: one TF32 product, as the
    tensor cores read an fp32 operand) fail it, far above F64_ERR_RATIO
    times the plain version's error."""
    smoke = _chip_smoke()
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.randn(4, 64, 64).astype(np.float32))
               for _ in range(3))
    plain = port.flash_fwd_plain(q, k, v, True, 0, 0)
    if operands == "plain":
        smoke._f64_check("plain", q, k, v, None, plain, plain, True, 0, 0)
        return

    def tf32(t):
        return (t.view(torch.int32) & -8192).view(torch.float32)

    got = port.flash_fwd_plain(tf32(q), tf32(k), v, True, 0, 0)
    with pytest.raises(AssertionError, match="error against float64"):
        smoke._f64_check("tf32", q, k, v, None, got, plain, True, 0, 0)


@pytest.mark.parametrize("D", [8, 48, 96, 200])
def test_padded_head_dim_plan_equals_the_plain_version(D):
    """Zero-padding q, k, v and dO from D to the instance's head dim, with
    the scale of the true D, and slicing back gives the plain version at D:
    forward (out, lse) and the three gradients, on both routes' plain
    versions."""
    args = _inputs((1, 2, 40, 56, D), seed=D)
    q, k, v, g = (torch.from_numpy(a).reshape(2, -1, D) for a in args[:4])
    glse = torch.from_numpy(args[4]).reshape(2, 40)
    causal = (True, 16, 0)
    tol = dict(rtol=1e-6, atol=1e-6)
    want = port.flash_fwd_plain(q, k, v, *causal)
    got = port.padded_heads(port.flash_fwd_plain, (q, k, v), (), *causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
    rows = (want[1], (g * want[0]).sum(-1), glse)
    for plain in (port.flash_dq_plain, port.flash_dkv_plain,
                  port.flash_dqkv_plain):
        want = plain(q, k, v, g, *rows, *causal)
        got = port.padded_heads(plain, (q, k, v, g), rows, *causal)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
