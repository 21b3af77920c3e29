"""The plain attention math of ring attention.

Only the single-device pieces of the JAX package's ``ring_attention``
module in this slice: the online-softmax fold shared by the blockwise paths,
and dense attention with and without the row logsumexp.  The ring over a
device mesh comes with a later slice.

Layout: [B, T, H, D] ("BTHD").
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


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
