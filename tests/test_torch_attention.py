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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for "
                    "sm_90a and have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,q_offset,k_offset", [
    (torch.bfloat16, False, 0, 0), (torch.bfloat16, True, 0, 24),
    (torch.float32, True, 30, 0)])
def test_kernels_match_plain_versions_on_the_card(cuda_device, dtype, causal,
                                                  q_offset, k_offset):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    BH, Sq, Sk, D = 6, 130, 96, 64

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,Sq,Sk,causal,q_offset,k_offset", [
    (torch.bfloat16, 64, 128, 128, False, 0, 0),
    (torch.bfloat16, 128, 128, 128, False, 0, 0),
    (torch.bfloat16, 16, 96, 128, True, 0, 40),
    (torch.float32, 64, 128, 128, True, 16, 0),
    (torch.float32, 32, 50, 70, False, 0, 0)])
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
