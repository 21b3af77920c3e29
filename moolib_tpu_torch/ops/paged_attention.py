"""Paged KV-cache decode attention (block-table gather): the port of the
JAX package's ``ops/paged_attention.py``.

The serving engine's KV layout: instead of one dense ``[B, max_len, Hk,
hd]`` cache per sequence, K/V live in a shared device-resident pool of
fixed-size token blocks ``[num_blocks, block_size, Hk, hd]`` and each decode
*slot* owns a row of block ids (its block table).  Attention gathers the
slot's blocks back into a contiguous context and runs the exact same
grouped-query math as the dense decode path of ``models.transformer.Block``
— :func:`gathered_decode_attention` is called by BOTH paths, so paged decode
is bit-identical to the dense cache whenever the gathered context length
equals the dense ``max_len``.

The JAX package computes all of this as XLA gathers and scatters outside
any Pallas kernel (decode attention at serving batch sizes is bound by the
pool read either way), so it stays plain torch here, on every device.

Block id 0 is the *null block*: never handed out by the allocator, and the
write path redirects inactive slots' writes at it, so a fixed-shape step
over all S slots never branches on occupancy.  Only the null block ever
receives duplicate indices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_NEG_INF = -1e30


class PagedState(NamedTuple):
    """Per-slot decode state threaded through a paged decode step.

    block_tables: integer [S, max_blocks_per_seq] — pool block ids per slot
        (unused tail entries hold 0, the null block).
    lengths: integer [S] — tokens already in the cache for each slot; the
        current step writes at position ``lengths`` and attends over
        ``<= lengths`` (the just-written token included).
    active: bool [S] — occupied slots.  Inactive slots still run the step
        (fixed shape); their writes land in the null block and their outputs
        are ignored by the engine.
    """

    block_tables: torch.Tensor
    lengths: torch.Tensor
    active: torch.Tensor


def gathered_decode_attention(q, k_ctx, v_ctx, t):
    """Single-position grouped-query attention over a gathered context.

    q: [B, 1, H, hd]; k_ctx/v_ctx: [B, T_ctx, Hk, hd] (any dtype — cast to
    f32 here); t: int, 0-d or [B] integer tensor — attend over positions
    ``<= t`` (everything past t contributes exactly 0: the -1e30 masked
    scores underflow to 0 in the f32 softmax).  This is the one definition
    of the decode-attention math: the dense cache path and the paged path
    both call it, which is what makes the two layouts bit-exact against
    each other.
    """
    B, T, H, hd = q.shape
    Hk = k_ctx.shape[2]
    group = H // Hk
    T_ctx = k_ctx.shape[1]
    scale = hd**-0.5
    qg = q.reshape(B, T, Hk, group, hd)
    scores = (
        torch.einsum(
            "bqhgd,bkhd->bhgqk",
            qg.to(torch.float32),
            k_ctx.to(torch.float32),
        )
        * scale
    )
    pos = torch.arange(T_ctx, device=q.device)
    if isinstance(t, torch.Tensor) and t.ndim == 1:
        mask = pos[None, None, None, None, :] <= t.to(q.device)[:, None, None, None, None]
    else:
        # A python int stays a kernel argument (no host-to-device copy).
        mask = pos[None, None, None, None, :] <= t
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    p_att = torch.softmax(scores, dim=-1)
    att = torch.einsum("bhgqk,bkhd->bqhgd", p_att, v_ctx.to(torch.float32))
    return att.reshape(B, T, H, hd).to(q.dtype)


def paged_kv_write(pool, x, block_tables, lengths, active):
    """Write one new K (or V) row per slot into the block pool, in place.

    pool: [num_blocks, block_size, Hk, hd]; x: [S, Hk, hd] (this step's K or
    V at position ``lengths``); block_tables/lengths/active as in
    :class:`PagedState`.  Inactive slots write to the null block 0 — the
    allocator never hands it out, so the garbage is harmless and the op keeps
    a fixed shape.  ``index_put_`` on the pool itself: no copy.  Returns
    ``pool``.
    """
    bs = pool.shape[1]
    # An inactive slot may sit one past its table (a sequence that filled its
    # capacity); its write goes to the null block, so clamping its lookup
    # changes nothing and keeps the gather in range (XLA clamps it).
    col = (lengths // bs).clamp(max=block_tables.shape[1] - 1)
    blk = torch.gather(block_tables, 1, col.long()[:, None])[:, 0]
    blk = torch.where(active, blk, torch.zeros_like(blk))
    off = lengths % bs
    pool.index_put_((blk.long(), off.long()), x.to(pool.dtype))
    return pool


def paged_gather(pool, block_tables):
    """Gather each slot's blocks into a contiguous [S, T_ctx, Hk, hd] context
    (T_ctx = max_blocks_per_seq * block_size).  Positions past a slot's
    length are stale pool contents; the attention mask zeroes them."""
    S, nb = block_tables.shape
    ctx = pool[block_tables.long()]  # [S, nb, bs, Hk, hd]
    return ctx.reshape(S, nb * pool.shape[1], *pool.shape[2:])


def paged_attention(q, pool_k, pool_v, block_tables, lengths):
    """Decode attention against a paged KV pool: gather, then the shared
    grouped-query math.  q: [S, 1, H, hd]; returns [S, 1, H, hd]."""
    k_ctx = paged_gather(pool_k, block_tables)
    v_ctx = paged_gather(pool_v, block_tables)
    return gathered_decode_attention(q, k_ctx, v_ctx, lengths)
