"""Flash attention forward: a hand-written Hopper kernel and its plain version.

The port of the JAX package's Pallas ``flash_attention``.  On a CUDA tensor
:func:`flash_attention` launches the CUDA kernel in ``csrc/flash_fwd.cu``
(built on first use by :mod:`._build`); on a CPU tensor it runs
:func:`_blockwise_attention_plain`, the same streaming-softmax math in plain
torch.  The choice is made by the tensors' device alone: a CUDA tensor the
kernel cannot take raises, it is never rerouted.

Layout [B, T, H, D].  The kernel takes any T >= 1 (the tail tile is masked)
and head dims 64 and 128, in float32 or bfloat16.

The backward kernels are not ported yet: the autograd function around the
kernel raises in ``backward``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..parallel.ring_attention import _NEG_INF, online_softmax_update

SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel since the last reset — proof that a run went
# through the kernel.  Bumped only where the kernel is launched.
_launches = 0


def flash_fwd_launches() -> int:
    """How many times the forward kernel has been launched (since reset)."""
    return _launches


def reset_flash_fwd_launches() -> None:
    global _launches
    _launches = 0


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


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel's vector loads need 16-byte rows
        x = x.clone()
    return x


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built and
    loaded on first use, never at import)."""
    from . import _build

    lib = _build.load("flash_fwd")
    lib.moolib_flash_fwd.restype = ctypes.c_int
    lib.moolib_flash_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.moolib_cuda_error_string.restype = ctypes.c_char_p
    lib.moolib_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _flash_fwd_cuda(q, k, v, causal: bool):
    """Launch the CUDA kernel: (out [B, Tq, H, D] in q's dtype, lse
    [B, Tq, H] f32).  Raises on what the kernel does not take."""
    global _launches
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel supports head dims {SUPPORTED_HEAD_DIMS}, got {D}"
        )
    lib = _kernel_lib()
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    out = torch.empty_like(q)
    lse = torch.empty(B, Tq, H, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.moolib_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Tq, Tk, H, D, int(causal), _DTYPE_CODES[q.dtype], D**-0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(
            "flash_fwd kernel launch failed: "
            + lib.moolib_cuda_error_string(rc).decode()
        )
    _launches += 1
    return out, lse


class _FlashFwd(torch.autograd.Function):
    """The kernel as an autograd node; its backward kernels are not ported
    yet, so ``backward`` raises rather than falling back to a plain VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_fwd_cuda(q, k, v, causal)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        raise NotImplementedError("flash backward kernels: slice 2")


def flash_attention(q, k, v, causal: bool = True, return_lse: bool = False):
    """Blockwise attention; q/k/v: [B, T, H, D] → [B, T, H, D].

    On CUDA tensors the hand-written kernel runs; on CPU tensors the plain
    version.  ``return_lse=True`` also returns the per-row logsumexp
    ([B, T, H], f32).
    """
    _check_inputs(q, k, v)
    if q.device.type == "cuda":
        out, lse = _FlashFwd.apply(q, k, v, causal)
    elif q.device.type == "cpu":
        out, lse = _blockwise_attention_plain(q, k, v, causal)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device.type}")
    return (out, lse) if return_lse else out
