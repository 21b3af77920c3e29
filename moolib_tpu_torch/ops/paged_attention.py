"""Decode attention over a gathered KV context.

Only :func:`gathered_decode_attention` of the JAX package's
``paged_attention`` module in this slice: the decode math of the dense KV
cache (``models.transformer.Block`` in decode mode).  The paged pool, its
writes and gathers come with the serving-engine slice.  It was an XLA einsum
in the JAX package, not a Pallas kernel, so it stays plain torch here.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def gathered_decode_attention(q, k_ctx, v_ctx, t):
    """Single-position grouped-query attention over a gathered context.

    q: [B, 1, H, hd]; k_ctx/v_ctx: [B, T_ctx, Hk, hd] (any dtype — cast to
    f32 here); t: int, 0-d or [B] integer tensor — attend over positions
    ``<= t`` (everything past t contributes exactly 0: the -1e30 masked
    scores underflow to 0 in the f32 softmax).
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
