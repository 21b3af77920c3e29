"""Ring attention: sequence-parallel attention over an ``sp`` group of
ranks, and its single-device math.

The port of the JAX package's ``parallel/ring_attention.py``.  The
sequence axis is sharded over the ``sp`` mesh axis: each rank keeps its
local Q block and the K/V chunks travel round the ring, one hop per step,
while the chunk results merge by logsumexp weight.  Each hop runs the flash
kernels on the chunk (``ops.flash_attention``: the hand-written CUDA
kernels on the card, their plain versions on the CPU) with
``return_lse``; under a causal mask the diagonal chunk is causal, past
chunks are not, and future chunks launch nothing (JAX's ``lax.switch``
skips them).

:class:`_Ring` is one autograd node around the whole ring.  Its backward
rotates K/V again and calls the kernels' backward on each chunk with the
*merged* out and lse, so each chunk's dq, dk and dv are exactly its share of
the true gradient; the dK/dV accumulators (f32) travel round the ring with
their chunk and arrive home after n hops.  Memory stays O(T/sp) a rank, and
rank r launches r + 1 forward kernels per layer (the same number of each
backward kernel) under a causal mask: n(n+1)/2 over the group.

Each hop's exchange is posted before the chunk's kernels are enqueued and
waited for after (``collectives.RingExchange``); the host time of each
wait is ``ring_hop_seconds``.  Where ranks share a card over gloo, every
hop crosses host memory (``collectives_host_staged_bytes_total``).

Layout: [B, T, H, D] ("BTHD").
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import telemetry

_NEG_INF = -1e30

_M_HOP = telemetry.get_registry().histogram(
    "ring_hop_seconds",
    "host wall time a ring-attention hop waited for its exchange (K/V in the "
    "forward; K/V, then the dK/dV accumulators, in the backward) after the "
    "hop's chunk kernels were enqueued: the hop time the kernels did not hide",
)


def online_softmax_update(scores, v_blk, acc, l, m, zero_masked_rows: bool):
    """Fold one K/V block into streaming-softmax accumulators.

    ``scores`` [B, H, Q, K] f32, already masked with ``_NEG_INF``; ``v_blk``
    [B, K, H, D]; accumulators ``acc`` [B, H, Q, D], ``l``/``m`` [B, H, Q].
    ``zero_masked_rows`` keeps fully-masked rows at zero weight (avoid
    exp(-inf - (-inf))).  Returns the new ``(acc, l, m)``.
    """
    m_new = torch.maximum(m, scores.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    if zero_masked_rows:
        p = torch.where(scores <= _NEG_INF / 2, torch.zeros_like(p), p)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p, v_blk.to(torch.float32)
    )
    return acc, l, m_new


def full_attention(q, k, v, causal: bool = True):
    """Reference dense attention (single device)."""
    return dense_attention_lse(q, k, v, causal=causal)[0]


def dense_attention_lse(q, k, v, causal: bool = True):
    """Dense attention that also returns the row logsumexp ([B, Tq, H], f32)
    — the combinable form (chunk results merge by lse weights)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)
    ) * scale
    if causal:
        Tq, Tk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1).detach()  # shift only; grad via p
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)  # [B, H, Tq]
    l_rows = l.clamp_min(1e-30).transpose(1, 2)  # [B, Tq, H]
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32)) / l_rows[..., None]
    lse = m + torch.log(l.clamp_min(1e-30))  # [B, H, Tq]
    return out.to(q.dtype), lse.transpose(1, 2)


def _chunk_forward(q, k, v, causal: bool):
    from ..ops.flash_attention import _blockwise_attention_plain, _flash_fwd_cuda

    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal)
    return _blockwise_attention_plain(q, k, v, causal)


def _chunk_backward(q, k, v, out, lse, g, causal: bool):
    from ..ops.flash_attention import _flash_backward_plain, _flash_bwd_cuda

    if q.device.type == "cuda":
        return _flash_bwd_cuda(q, k, v, out, lse, g, None, causal)
    return _flash_backward_plain(q, k, v, out, lse, g, None, causal)


def _timed_wait(hop, device):
    with _M_HOP.time():
        return hop.wait(device)


def _hops(my: int, n: int, causal: bool):
    """``(hop, chunk causal)`` of each hop; None: a future chunk, skipped.
    At hop i a rank holds the chunk of the rank i steps back."""
    for i in range(n):
        src = (my - i) % n
        yield i, (src == my if causal and src <= my else None if causal else False)


class _Ring(torch.autograd.Function):
    """The whole ring as one autograd node (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, axis_name, mesh, causal):
        from .collectives import RingExchange

        n = mesh.size(mesh.mesh_dim_names.index(axis_name))
        my = mesh.get_local_rank(axis_name)
        hop = RingExchange(axis_name, mesh)
        B, Tq, H, D = q.shape
        acc = torch.zeros(B, Tq, H, D, dtype=torch.float32, device=q.device)
        s = torch.zeros(B, Tq, H, dtype=torch.float32, device=q.device)
        mx = torch.full((B, Tq, H), _NEG_INF, dtype=torch.float32, device=q.device)
        kc, vc = k, v
        wire = hop.stage(torch.stack([k, v]))
        for i, chunk_causal in _hops(my, n, causal):
            last = i == n - 1
            if not last:
                hop.start(wire)
            if chunk_causal is not None:
                o_i, lse_i = _chunk_forward(q, kc, vc, chunk_causal)
                # Merge by logsumexp weight (each chunk's output is
                # normalised): out = sum_i o_i exp(lse_i - lse).
                m_new = torch.maximum(mx, lse_i)
                w_acc = torch.exp(mx - m_new)
                w_i = torch.exp(lse_i - m_new)
                acc = acc * w_acc[..., None] + o_i.to(torch.float32) * w_i[..., None]
                s = s * w_acc + w_i
                mx = m_new
            if not last:
                kv, wire = _timed_wait(hop, q.device)
                kc, vc = kv[0], kv[1]
        out = (acc / s.clamp_min(1e-30)[..., None]).to(q.dtype)
        lse = mx + torch.log(s.clamp_min(1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (axis_name, mesh, causal, n, my)
        return out

    @staticmethod
    def backward(ctx, g):
        from .collectives import RingExchange

        q, k, v, out, lse = ctx.saved_tensors
        axis_name, mesh, causal, n, my = ctx.args
        g = g.contiguous()
        hop = RingExchange(axis_name, mesh)
        back = RingExchange(axis_name, mesh)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32, device=k.device)
        kc, vc = k, v
        wire = hop.stage(torch.stack([k, v]))
        for i, chunk_causal in _hops(my, n, causal):
            last = i == n - 1
            if not last:
                hop.start(wire)
            if chunk_causal is not None:
                # With the merged out and lse, p = exp(s - lse) is the
                # global softmax and delta = rowsum(g * out) the global
                # row term: this chunk's share of the true gradient.
                dq_i, dk_i, dv_i = _chunk_backward(q, kc, vc, out, lse, g, chunk_causal)
                dq += dq_i
                dkv[0] += dk_i
                dkv[1] += dv_i
            if not last:
                kv, wire = _timed_wait(hop, q.device)
                kc, vc = kv[0], kv[1]
            # The accumulators travel on with their chunk; after n hops
            # each is home.
            back.start(back.stage(dkv))
            dkv = _timed_wait(back, k.device)[0]
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None, None


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "sp", causal: bool = True):
    """Ring attention on this rank's block: q/k/v are [B, T/sp, H, D], the
    rank's part of the sequence (its index along ``axis_name`` is its
    chunk).  Returns this rank's [B, T/sp, H, D] block of the output of
    attention over the whole sequence.  Every rank of the ``axis_name``
    group calls it (and its backward) in the same order.  One rank on the
    axis: plain flash attention."""
    from ..ops.flash_attention import _check_inputs, flash_attention

    _check_inputs(q, k, v)
    if mesh is None or mesh.size(mesh.mesh_dim_names.index(axis_name)) == 1:
        return flash_attention(q, k, v, causal=causal)
    return _Ring.apply(q, k, v, axis_name, mesh, causal)


class _AllGather(torch.autograd.Function):
    """Differentiable tiled all-gather: the backward of a replicated
    output's partial gradients is their sum, cut to this rank's block
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axis_name, mesh, dim):
        from .collectives import all_gather_axis

        ctx.args = (axis_name, mesh, dim)
        return all_gather_axis(x, axis_name, mesh, axis=dim)

    @staticmethod
    def backward(ctx, g):
        from .collectives import reduce_scatter_axis

        axis_name, mesh, dim = ctx.args
        return reduce_scatter_axis(g, axis_name, mesh, axis=dim), None, None, None


def ring_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = True,
                   batch_axis: Optional[str] = "auto"):
    """Global form: q/k/v are the whole [B, T, H, D] tensors, the same on
    every rank; each rank takes its block (T over ``axis_name``, and B over
    ``batch_axis``), runs the ring and gathers the output back, so every
    rank returns the whole output (JAX's global entry point).
    ``batch_axis="auto"`` shards B over ``dp`` when the mesh has one that
    divides B, as JAX's does; without it every ``dp`` rank computes the
    whole batch.  Differentiable under the package's gradient convention
    (``parallel.collectives``)."""
    from .mesh import axis_sizes

    sizes = axis_sizes(mesh)
    if batch_axis == "auto":
        ok = "dp" in sizes and axis_name != "dp" and q.shape[0] % sizes["dp"] == 0
        batch_axis = "dp" if ok else None
    n = sizes[axis_name]
    me = mesh.get_local_rank(axis_name)
    blocks = []
    for x in (q, k, v):
        x = x.chunk(n, dim=1)[me]
        if batch_axis is not None:
            x = x.chunk(sizes[batch_axis], dim=0)[mesh.get_local_rank(batch_axis)]
        blocks.append(x.contiguous())
    out = ring_attention_sharded(*blocks, mesh, axis_name=axis_name, causal=causal)
    out = _AllGather.apply(out, axis_name, mesh, 1)
    if batch_axis is not None:
        out = _AllGather.apply(out, batch_axis, mesh, 0)
    return out
