"""Flash (blockwise, online-softmax) attention on PyTorch tensors.

Port of ``horovod_tpu/ops/attention.py``. Layout is ``[B, H, S, D]`` at
the public functions, as in the JAX package. Semantics are the same:

- ``flash_attention_lse`` returns ``(out, lse)``; a row that sees no key
  gives ``out = 0`` and ``lse = LSE_MASKED``; gradients flow through lse
  too (``dS += P * g_lse``), which logsumexp-merged schemes such as ring
  attention need.
- Causal masking uses global positions ``q_offset + i >= k_offset + j``;
  causal attention with ``Sq != Sk`` and both offsets 0 raises.

Two routes, chosen once per call from the sequence lengths:

- ``Sq <= SINGLE_TILE_MAX and Sk <= SINGLE_TILE_MAX``: the single-tile
  forward (direct softmax) and the fused backward that computes
  S -> P -> dP -> dS once and writes dQ, dK and dV
  (``csrc/flash_attention_single.cu``);
- otherwise the multi-tile forward (online softmax), dQ and dK/dV kernels
  (``csrc/flash_attention.cu``).

Both routes compute one function. Each kernel has a wrapper here that
launches the hand-written CUDA kernel for CUDA tensors and computes the
plain PyTorch version beside it for CPU tensors. The plain versions
(``*_plain``) are also what the kernels are held against on the card. Tile
sizes are the kernels' own choice, so any sequence length works; the TPU
kernels' block-divisibility rule does not apply.
"""

from __future__ import annotations

import math

import torch

from . import _kernels

NEG_INF = -1e30
# logsumexp sentinel for fully-masked rows: exp(s - BIG) == 0 for any
# representable s, so backward P/dq come out exactly 0 for those rows.
LSE_MASKED = 1e30
# Longest Q or K/V sequence the single-tile kernels take: the whole K and V
# of one head, and a 128 x 128 fp32 score tile, fit one block's shared
# memory on Hopper. The port's own Hopper rule, not the TPU's _auto_block.
SINGLE_TILE_MAX = 128

_KERNEL_DTYPES = {torch.float32: _kernels.DTYPE_F32,
                  torch.bfloat16: _kernels.DTYPE_BF16}
_KERNEL_HEAD_DIMS = {torch.float32: (16, 32, 64),
                     torch.bfloat16: (16, 32, 64, 128)}


def _attend_block(q, k, v, m, l, o, mask=None, scale=1.0):
    """One online-softmax step: fold K/V tile (k, v) into (m, l, o).

    q: [Sq, D]; k, v: [Sk, D]; m, l: [Sq]; o: [Sq, D] (fp32).
    """
    s = (q.float() @ k.float().T) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[:, None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[:, None] + p @ v.float()
    return m_new, l_new, o_new


def blockwise_attention_reference(q, k, v, causal=False, block_size=128,
                                  q_offset=0, k_offset=0):
    """Numerics oracle: [B, H, S, D] blockwise attention in plain torch,
    fp32 throughout (mirror of the JAX package's reference)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    scale = 1.0 / (D ** 0.5)
    out = torch.empty(B, H, Sq, D, dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(H):
            for qs in range(0, max(Sq, 1), block_size):
                qb = q[b, h, qs:qs + block_size]
                n = qb.shape[0]
                m = torch.full((n,), NEG_INF, device=q.device)
                l = torch.zeros(n, device=q.device)
                o = torch.zeros(n, D, device=q.device)
                for ks in range(0, max(Sk, 1), block_size):
                    kb = k[b, h, ks:ks + block_size]
                    vb = v[b, h, ks:ks + block_size]
                    mask = None
                    if causal:
                        qpos = q_offset + qs + torch.arange(n, device=q.device)
                        kpos = k_offset + ks + torch.arange(
                            kb.shape[0], device=q.device)
                        mask = qpos[:, None] >= kpos[None, :]
                    m, l, o = _attend_block(qb, kb, vb, m, l, o, mask, scale)
                safe_l = torch.where(l == 0.0, 1.0, l)
                out[b, h, qs:qs + n] = o / safe_l[:, None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Plain versions of the kernels ([BH, S, D] operands, fp32 math, P and
# dS rounded to the operand dtype before the products, as in the kernels).
# ---------------------------------------------------------------------------


def _visible(Sq, Sk, causal, q_offset, k_offset, device):
    if not causal:
        return None
    qpos = q_offset + torch.arange(Sq, device=device)
    kpos = k_offset + torch.arange(Sk, device=device)
    return qpos[:, None] >= kpos[None, :]


def _scores(q, k, causal, q_offset, k_offset):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = _visible(q.shape[1], k.shape[1], causal, q_offset, k_offset,
                    q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    return s, mask, scale


def flash_fwd_plain(q, k, v, causal=False, q_offset=0, k_offset=0):
    """Forward: ``(o [BH, Sq, D], lse [BH, Sq] fp32)``.

    A direct softmax over the whole row, which is the function of both
    forward kernels: it is the plain version of the multi-tile forward and,
    as ``flash_fwd_single_plain``, of the single-tile forward."""
    s, mask, _ = _scores(q, k, causal, q_offset, k_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    empty = l == 0.0
    safe_l = torch.where(empty, 1.0, l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / safe_l[..., None]
    lse = torch.where(empty, LSE_MASKED, m[..., 0] + torch.log(safe_l))
    return o.to(q.dtype), lse


flash_fwd_single_plain = flash_fwd_plain


def _probs_and_dscores(q, k, v, do, lse, delta, glse, causal, q_offset,
                       k_offset):
    s, mask, scale = _scores(q, k, causal, q_offset, k_offset)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None] + glse[..., None])
    return p, ds, scale


def flash_dq_plain(q, k, v, do, lse, delta, glse, causal=False, q_offset=0,
                   k_offset=0):
    """dQ = scale * dS K with dS = P * (dO V^T - delta + g_lse)."""
    _, ds, scale = _probs_and_dscores(q, k, v, do, lse, delta, glse, causal,
                                      q_offset, k_offset)
    dq = scale * torch.matmul(ds.to(q.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, glse, causal=False, q_offset=0,
                    k_offset=0):
    """dV = P^T dO and dK = scale * dS^T Q."""
    p, ds, scale = _probs_and_dscores(q, k, v, do, lse, delta, glse, causal,
                                      q_offset, k_offset)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = scale * torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                              q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dqkv_plain(q, k, v, do, lse, delta, glse, causal=False, q_offset=0,
                     k_offset=0):
    """The fused backward: the S -> P -> dP -> dS chain once, then
    ``(dq, dk, dv)``."""
    p, ds, scale = _probs_and_dscores(q, k, v, do, lse, delta, glse, causal,
                                      q_offset, k_offset)
    ds = ds.to(q.dtype).float()
    dq = scale * torch.matmul(ds, k.float())
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensors take the plain version, CUDA tensors launch
# the kernel or raise.
# ---------------------------------------------------------------------------


def _check_kernel_operands(seq_tensors, row_tensors=()):
    """Validate [BH, S, D] operands and [BH, S] fp32 row vectors for a
    kernel launch; return (dtype code, BH, D)."""
    q = seq_tensors[0]
    if q.device.type != "cuda":
        raise ValueError(
            f"flash attention kernels take CPU or CUDA tensors; got "
            f"{q.device}")
    dtype = q.dtype
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"flash attention kernels take bfloat16 or float32; got {dtype}")
    BH, _, D = q.shape
    if D not in _KERNEL_HEAD_DIMS[dtype]:
        raise ValueError(
            f"flash attention kernels take head dims "
            f"{_KERNEL_HEAD_DIMS[dtype]} for {dtype}; got {D}")
    if BH > 65535:
        raise ValueError(f"batch*heads={BH} exceeds the grid limit 65535")
    for t in seq_tensors:
        if t.dim() != 3 or t.shape[0] != BH or t.shape[2] != D:
            raise ValueError(
                f"expected [{BH}, S, {D}] operands; got {tuple(t.shape)}")
        if t.dtype != dtype or t.device != q.device:
            raise ValueError("flash attention operands must share dtype and "
                             "device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash attention operands must be contiguous "
                             "and 16-byte aligned")
    for t in row_tensors:
        if (t.shape != q.shape[:2] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"lse/delta/g_lse must be contiguous float32 [{BH}, "
                f"{q.shape[1]}] on the operands' device; got "
                f"{t.dtype} {tuple(t.shape)}")
    return _KERNEL_DTYPES[dtype], BH, D


def _launch(kernel, device, *args):
    """Launch on ``device``'s current stream (the operands' card, whatever
    the current device is)."""
    with torch.cuda.device(device):
        _kernels.launch(kernel, *args,
                        torch.cuda.current_stream(device).cuda_stream)


def _aligned(t):
    """Contiguous and 16-byte aligned, as the kernels' vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(kernel, plain, q, k, v, causal, q_offset, k_offset):
    """A forward kernel's wrapper: the plain version for CPU tensors, else
    one launch of ``kernel``."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal, q_offset, k_offset)
    code, BH, D = _check_kernel_operands((q, k, v))
    Sq, Sk = q.shape[1], k.shape[1]
    if Sk != v.shape[1]:
        raise ValueError("k and v must have the same sequence length")
    o = torch.empty_like(q)
    lse = torch.empty(BH, Sq, dtype=torch.float32, device=q.device)
    _launch(
        kernel, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), BH, Sq, Sk, D, code, int(causal),
        q_offset, k_offset, 1.0 / math.sqrt(D))
    return o, lse


def flash_fwd(q, k, v, causal=False, q_offset=0, k_offset=0):
    """Forward kernel: q [BH, Sq, D], k/v [BH, Sk, D] ->
    ``(o [BH, Sq, D], lse [BH, Sq] fp32)``."""
    return _forward(_kernels.FLASH_FWD, flash_fwd_plain, q, k, v, causal,
                    q_offset, k_offset)


def flash_dq(q, k, v, do, lse, delta, glse, causal=False, q_offset=0,
             k_offset=0):
    """dQ kernel; lse, delta, glse are [BH, Sq] fp32."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, glse, causal,
                              q_offset, k_offset)
    code, BH, D = _check_kernel_operands((q, k, v, do), (lse, delta, glse))
    Sq, Sk = q.shape[1], k.shape[1]
    dq = torch.empty_like(q)
    _launch(
        _kernels.FLASH_DQ, q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        glse.data_ptr(), dq.data_ptr(), BH, Sq, Sk, D, code, int(causal),
        q_offset, k_offset, 1.0 / math.sqrt(D))
    return dq


def flash_dkv(q, k, v, do, lse, delta, glse, causal=False, q_offset=0,
              k_offset=0):
    """dK/dV kernel; returns ``(dk, dv)`` shaped like k and v."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, glse, causal,
                               q_offset, k_offset)
    code, BH, D = _check_kernel_operands((q, k, v, do), (lse, delta, glse))
    Sq, Sk = q.shape[1], k.shape[1]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(
        _kernels.FLASH_DKV, q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        glse.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, Sq, Sk, D, code,
        int(causal), q_offset, k_offset, 1.0 / math.sqrt(D))
    return dk, dv


def _check_single_tile(Sq, Sk):
    if Sq > SINGLE_TILE_MAX or Sk > SINGLE_TILE_MAX:
        raise ValueError(
            f"the single-tile kernels take at most {SINGLE_TILE_MAX} rows of "
            f"Q and of K/V; got Sq={Sq}, Sk={Sk} (use flash_fwd / flash_dq / "
            "flash_dkv)")


def flash_fwd_single(q, k, v, causal=False, q_offset=0, k_offset=0):
    """Single-tile forward kernel (Sq, Sk <= SINGLE_TILE_MAX): q [BH, Sq, D],
    k/v [BH, Sk, D] -> ``(o [BH, Sq, D], lse [BH, Sq] fp32)``."""
    _check_single_tile(q.shape[1], k.shape[1])
    return _forward(_kernels.FLASH_FWD_SINGLE, flash_fwd_single_plain, q, k,
                    v, causal, q_offset, k_offset)


def flash_dqkv(q, k, v, do, lse, delta, glse, causal=False, q_offset=0,
               k_offset=0):
    """Fused single-tile backward kernel (Sq, Sk <= SINGLE_TILE_MAX); lse,
    delta, glse are [BH, Sq] fp32. Returns ``(dq, dk, dv)``."""
    Sq, Sk = q.shape[1], k.shape[1]
    _check_single_tile(Sq, Sk)
    if q.device.type == "cpu":
        return flash_dqkv_plain(q, k, v, do, lse, delta, glse, causal,
                                q_offset, k_offset)
    code, BH, D = _check_kernel_operands((q, k, v, do), (lse, delta, glse))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(
        _kernels.FLASH_DQKV, q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        glse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, Sq,
        Sk, D, code, int(causal), q_offset, k_offset, 1.0 / math.sqrt(D))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """(out, lse) over [BH, S, D] operands. The route is picked once in
    forward and kept for backward: the single-tile forward and fused
    backward, or the multi-tile forward and the dQ and dK/dV kernels, both
    run from the saved (out, lse) residuals."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        single = (q.shape[1] <= SINGLE_TILE_MAX
                  and k.shape[1] <= SINGLE_TILE_MAX)
        fwd = flash_fwd_single if single else flash_fwd
        out, lse = fwd(q, k, v, causal, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, k_offset)
        ctx.single = single
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g = torch.zeros_like(out) if g is None else _aligned(g)
        g_lse = (torch.zeros_like(lse) if g_lse is None
                 else g_lse.float().contiguous())
        # delta_i = rowsum(dO_i * O_i): a cheap elementwise reduce, left to
        # PyTorch as the JAX package leaves it to XLA.
        delta = (g.float() * out.float()).sum(dim=-1)
        if ctx.single:
            dq, dk, dv = flash_dqkv(q, k, v, g, lse, delta, g_lse, *ctx.args)
        else:
            dq = flash_dq(q, k, v, g, lse, delta, g_lse, *ctx.args)
            dk, dv = flash_dkv(q, k, v, g, lse, delta, g_lse, *ctx.args)
        return dq, dk, dv, None, None, None


def _prepare_flash(q, k, v, causal, q_offset, k_offset):
    """Shared validation for the flash entry points."""
    Sq, Sk = q.shape[2], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"flash attention operands must share a dtype; got "
            f"q={q.dtype}, k={k.dtype}, v={v.dtype} — cast them to one "
            "dtype")
    if causal and Sq != Sk and q_offset == 0 and k_offset == 0:
        raise ValueError(
            f"causal flash attention with Sq={Sq} != Sk={Sk} is ambiguous "
            "without explicit offsets: pass q_offset/k_offset (e.g. "
            f"q_offset={Sk - Sq} for bottom-right/decode alignment, or "
            "q_offset=0, k_offset=0 is top-left — use "
            "blockwise_attention_reference if that is what you want)"
        )


def flash_attention_lse(q, k, v, causal: bool = False, q_offset: int = 0,
                        k_offset: int = 0):
    """Flash attention that also returns the per-row logsumexp.

    q: [B, H, Sq, D]; k, v: [B, H, Sk, D] -> ``(out [B, H, Sq, D],
    lse [B, H, Sq] fp32)``. Differentiable through both outputs.
    """
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    _prepare_flash(q, k, v, causal, q_offset, k_offset)
    out, lse = _FlashAttention.apply(
        _aligned(q.reshape(B * H, Sq, D)), _aligned(k.reshape(B * H, Sk, D)),
        _aligned(v.reshape(B * H, Sk, D)), bool(causal), int(q_offset),
        int(k_offset))
    return out.reshape(B, H, Sq, D), lse.reshape(B, H, Sq)


def flash_attention(q, k, v, causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0):
    """Flash attention. q, k, v: [B, H, S, D] -> [B, H, Sq, D]."""
    return flash_attention_lse(q, k, v, causal, q_offset, k_offset)[0]
