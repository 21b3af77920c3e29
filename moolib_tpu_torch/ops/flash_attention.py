"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain versions.

The port of the JAX package's Pallas ``flash_attention``.  :class:`_Flash`
is one autograd node for both devices.  On CUDA tensors its forward launches
the kernel in ``csrc/flash_fwd.cu`` and its backward the two kernels in
``csrc/flash_bwd.cu`` (a dq pass and a dk/dv pass), each built on first use
by :mod:`._build`.  On CPU tensors the same node runs
:func:`_blockwise_attention_plain` and :func:`_flash_backward_plain`, the same
math in plain torch, so the CPU tests exercise the saved tensors, the
``delta`` row table and the lse cotangent exactly as the card does.  The
choice is made by the tensors' device alone: a CUDA tensor the kernels
cannot take raises, it is never rerouted.

Layout [B, T, H, D].  The kernels take any T >= 1 (tail tiles are masked)
and head dims 64 and 128, in float32 or bfloat16.  In bfloat16 all three
kernels (the forward, the dq pass and the dk/dv pass) run on the tensor
cores (wgmma); float32, whose tolerances TF32 would break, runs on the CUDA
cores.  The C entry points choose by dtype; nothing here reroutes a failed
launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ..parallel.ring_attention import _NEG_INF, online_softmax_update

SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each CUDA kernel since the last reset — proof that a run went
# through the kernels.  Bumped only where a kernel is launched.
_launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def flash_fwd_launches() -> int:
    """How many times the forward kernel has been launched (since reset)."""
    return _launches["flash_fwd"]


def flash_bwd_dq_launches() -> int:
    """How many times the backward dq kernel has been launched (since reset)."""
    return _launches["flash_bwd_dq"]


def flash_bwd_dkv_launches() -> int:
    """How many times the backward dk/dv kernel has been launched (since reset)."""
    return _launches["flash_bwd_dkv"]


def launch_counts() -> dict:
    """Every kernel's launches since the last reset, by name."""
    return dict(_launches)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in _launches:
        _launches[name] = 0


def _blockwise_attention_plain(q, k, v, causal: bool = True, block_q: int = 128,
                               block_k: int = 128):
    """Plain torch chunked streaming-softmax attention: (out, lse).

    The same math as the JAX package's ``_blockwise_attention``, folded
    through :func:`online_softmax_update`: q blocks of ``block_q`` rows
    sweep K/V blocks of ``block_k`` keys in f32, KV blocks entirely above
    the diagonal are skipped under ``causal``, and a short last block takes
    the tail of any T.  Returns ``out`` [B, Tq, H, D] in q's dtype and
    ``lse`` [B, Tq, H] in f32.
    """
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = D**-0.5
    qf, kf, vf = q.to(torch.float32), k.to(torch.float32), v.to(torch.float32)
    outs, lses = [], []
    for q0 in range(0, Tq, block_q):
        q_blk = qf[:, q0 : q0 + block_q]
        bq = q_blk.shape[1]
        acc = torch.zeros(B, H, bq, D, dtype=torch.float32, device=q.device)
        l = torch.zeros(B, H, bq, dtype=torch.float32, device=q.device)
        m = torch.full((B, H, bq), _NEG_INF, dtype=torch.float32, device=q.device)
        for k0 in range(0, Tk, block_k):
            if causal and k0 >= q0 + bq:
                break  # every key from here on is above the diagonal
            k_blk = kf[:, k0 : k0 + block_k]
            v_blk = vf[:, k0 : k0 + block_k]
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk) * scale
            if causal:
                q_pos = q0 + torch.arange(bq, device=q.device)
                k_pos = k0 + torch.arange(k_blk.shape[1], device=q.device)
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
            acc, l, m = online_softmax_update(s, v_blk, acc, l, m, zero_masked_rows=causal)
        outs.append((acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2))
        lses.append((m + torch.log(l.clamp_min(1e-30))).transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=1)


def _delta(g, out, g_lse):
    """The backward's row table [B, Tq, H] f32: ``rowsum(g * out) - g_lse``.
    An lse cotangent folds in here, so the kernels are the same with or
    without one (the JAX package computes it outside Pallas too)."""
    delta = (g.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.to(torch.float32)
    return delta


def _flash_backward_plain(q, k, v, out, lse, g, g_lse, causal: bool, block_k: int = 128):
    """Plain torch flash backward in f32: (dq, dk, dv) in the inputs' dtypes.

    The FlashAttention-2 math the two backward kernels run, blockwise over
    K/V blocks of ``block_k`` keys: ``p = exp(s - lse)`` (masked scores are
    -1e30, so their ``p`` is 0), ``dv += pᵀ g``, ``dp = g vᵀ``,
    ``ds = p (dp - delta) scale``, ``dq += ds k`` and ``dk += dsᵀ q``, with
    ``delta`` from :func:`_delta`.  Under ``causal`` a K/V block skips the
    queries before its first key.
    """
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = D**-0.5
    dev = q.device
    qf, kf, vf, gf = (x.to(torch.float32) for x in (q, k, v, g))
    lse_t = lse.to(torch.float32).transpose(1, 2)[..., None]  # [B, H, Tq, 1]
    delta_t = _delta(g, out, g_lse).transpose(1, 2)[..., None]
    dq = torch.zeros(B, H, Tq, D, dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for k0 in range(0, Tk, block_k):
        k_blk, v_blk = kf[:, k0 : k0 + block_k], vf[:, k0 : k0 + block_k]
        bk = k_blk.shape[1]
        q0 = min(k0, Tq) if causal else 0  # earlier queries see none of these keys
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, q0:], k_blk) * scale
        if causal:
            q_pos = q0 + torch.arange(Tq - q0, device=dev)
            k_pos = k0 + torch.arange(bk, device=dev)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, torch.full_like(s, _NEG_INF))
        p = torch.exp(s - lse_t[:, :, q0:])
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, gf[:, q0:]))
        dp = torch.einsum("bqhd,bkhd->bhqk", gf[:, q0:], v_blk)
        ds = p * (dp - delta_t[:, :, q0:]) * scale
        dq[:, :, q0:] += torch.einsum("bhqk,bkhd->bhqd", ds, k_blk)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf[:, q0:]))
    return (dq.transpose(1, 2).to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


def _check_inputs(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes q, k, v of shape [B, T, H, D]")
    B, Tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(
            f"flash_attention shape mismatch: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if Tq < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention needs T >= 1")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one device")


def _check_kernel_inputs(q, k, v):
    """Raise, before any build or launch, on what the kernels do not take."""
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel supports head dims {SUPPORTED_HEAD_DIMS}, "
            f"got {q.shape[-1]}"
        )


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel's vector loads need 16-byte rows
        x = x.clone()
    return x


@functools.lru_cache(maxsize=None)
def _kernel_lib(name: str) -> ctypes.CDLL:
    """The built kernel library ``name`` with its C signatures declared
    (built and loaded on first use, never at import)."""
    from . import _build

    lib = _build.load(name)
    tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    if name == "flash_fwd":
        lib.moolib_flash_fwd.restype = ctypes.c_int
        lib.moolib_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
    else:
        lib.moolib_flash_bwd_dq.restype = ctypes.c_int
        lib.moolib_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
        lib.moolib_flash_bwd_dkv.restype = ctypes.c_int
        lib.moolib_flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + tail
    lib.moolib_cuda_error_string.restype = ctypes.c_char_p
    lib.moolib_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.moolib_cuda_error_string(rc).decode())


def _flash_fwd_cuda(q, k, v, causal: bool):
    """Launch the forward kernel: (out [B, Tq, H, D] in q's dtype, lse
    [B, Tq, H] f32).  Raises on what the kernel does not take."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    _check_kernel_inputs(q, k, v)
    lib = _kernel_lib("flash_fwd")
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    out = torch.empty_like(q)
    lse = torch.empty(B, Tq, H, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.moolib_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Tq, Tk, H, D, int(causal), _DTYPE_CODES[q.dtype], D**-0.5, stream,
        )
    _raise_on(lib, rc, "flash_fwd")
    _launches["flash_fwd"] += 1
    return out, lse


def _bwd_operands(q, k, v, out, lse, g, g_lse):
    """What both backward kernels read: (q, k, v, g, lse, delta), each
    contiguous, g in q's dtype and lse/delta in f32.  ``delta`` is computed
    here in torch."""
    delta = _kernel_operand(_delta(g, out, g_lse))
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    return (q, k, v, _kernel_operand(g.to(q.dtype)),
            _kernel_operand(lse.to(torch.float32)), delta)


def _launch_bwd(name: str, q, k, v, g, lse, delta, grads, causal: bool) -> None:
    B, Tq, H, D = q.shape
    _check_kernel_inputs(q, k, v)
    lib = _kernel_lib("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, f"moolib_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(x.data_ptr() for x in grads),
            B, Tq, k.shape[1], H, D, int(causal), _DTYPE_CODES[q.dtype], D**-0.5, stream,
        )
    _raise_on(lib, rc, name)
    _launches[name] += 1


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal: bool):
    """Launch the dq pass on operands from :func:`_bwd_operands`: dq."""
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", q, k, v, g, lse, delta, (dq,), causal)
    return dq


def _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal: bool):
    """Launch the dk/dv pass on operands from :func:`_bwd_operands`: (dk, dv)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", q, k, v, g, lse, delta, (dk, dv), causal)
    return dk, dv


def _flash_bwd_cuda(q, k, v, out, lse, g, g_lse, causal: bool):
    """The backward on the card: the dq pass, then the dk/dv pass.
    Returns (dq, dk, dv) in the inputs' dtypes; raises on what the kernels
    do not take."""
    ops = _bwd_operands(q, k, v, out, lse, g, g_lse)
    return (_flash_bwd_dq_cuda(*ops, causal), *_flash_bwd_dkv_cuda(*ops, causal))


class _Flash(torch.autograd.Function):
    """Flash attention as one autograd node: ``(out, lse)`` forward, both
    differentiable.  The kernels on CUDA tensors, the plain versions on CPU
    tensors; the saved tensors and the backward's inputs are the same."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cuda":
            out, lse = _flash_fwd_cuda(q, k, v, causal)
        else:
            out, lse = _blockwise_attention_plain(q, k, v, causal)
        ctx.causal = causal
        # An unused lse arrives in backward as None: no zero cotangent is
        # made (the JAX package's split into _flash and _flash_lse).
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, out, lse)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        bwd = _flash_bwd_cuda if q.device.type == "cuda" else _flash_backward_plain
        dq, dk, dv = bwd(q, k, v, out, lse, g_out, g_lse, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True, return_lse: bool = False):
    """Blockwise attention; q/k/v: [B, T, H, D] → [B, T, H, D].

    Differentiable: on CUDA tensors the forward kernel runs, and the dq and
    dk/dv kernels in the backward; on CPU tensors the plain versions.
    ``return_lse=True`` also returns the per-row logsumexp ([B, T, H], f32,
    differentiable: its cotangent folds into the backward's delta).
    """
    _check_inputs(q, k, v)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device.type}")
    out, lse = _Flash.apply(q, k, v, causal)
    return (out, lse) if return_lse else out
