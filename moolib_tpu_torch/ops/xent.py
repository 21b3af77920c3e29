"""Chunked softmax cross-entropy: the LM head without materialized logits.

The port of the JAX package's ``ops/xent.py``.  At the bench scale (B=16,
T=1024, V=32768) the f32 logits tensor alone is ~2 GB; this op runs the
head projection blockwise over the vocab axis, each block under
``torch.utils.checkpoint``, so the forward keeps only three [N] f32 row
statistics (running max, rescaled sum of exps, label logit) and the
backward recomputes each block's logits on the fly.  JAX writes it as a
``lax.scan`` over ``jax.checkpoint``ed chunks; here it is a Python loop, and
the blocked matmul stays a plain ``torch.matmul`` (XLA computes it on the
TPU, no Pallas kernel is involved).

Numerics: logits are f32 computed from the inputs in their stored dtype (or
``compute_dtype``), the running statistics are f32, and the result equals
the naive ``log_softmax`` loss to f32 roundoff.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

_NEG = -1e30


def _logits_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` as f32 — jax's ``dot(..., preferred_element_type=f32)``.
    Two bf16 operands give the f32 products of the bf16-rounded inputs, not
    bf16-rounded logits (which ``torch.matmul`` of bf16 tensors returns)."""
    return torch.matmul(h.to(torch.float32), w.to(torch.float32))


def _fold_chunk(m, s, lab, h, wc, bc, labels, base: int, compute_dtype):
    """Fold one [N, width] logits block into the running statistics."""
    if compute_dtype is not None:
        wc = wc.to(compute_dtype)  # per chunk: no full-w copy
    width = wc.shape[1]
    logits = _logits_f32(h, wc) + bc.to(torch.float32)[None, :]  # the only live block
    m_new = torch.maximum(m, logits.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
    off = labels - base
    hit = (off >= 0) & (off < width)
    picked = logits.gather(1, off.clamp(0, width - 1)[:, None])[:, 0]
    return m_new, s, lab + torch.where(hit, picked, torch.zeros_like(picked))


def chunked_softmax_xent(
    h: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    labels: torch.Tensor,
    chunk_size: int = 4096,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``softmax(h @ w + b)``.

    h: [N, D], w: [D, V], b: [V] or None, labels: [N] int.  Returns an f32
    scalar.  ``chunk_size`` bounds the live logits block to
    [N, chunk_size]; a vocab the chunk doesn't divide gets one narrower last
    block (never a padded copy of w).  ``compute_dtype`` (e.g.
    ``torch.bfloat16``) casts the matmul inputs; the logits and the
    statistics stay f32.
    """
    n = h.shape[0]
    v = w.shape[1]
    chunk = int(min(chunk_size, v))
    if b is None:
        b = torch.zeros(v, dtype=torch.float32, device=h.device)
    labels = labels.long()
    if compute_dtype is not None:
        h = h.to(compute_dtype)
    m = torch.full((n,), _NEG, dtype=torch.float32, device=h.device)
    s = torch.zeros(n, dtype=torch.float32, device=h.device)
    lab = torch.zeros(n, dtype=torch.float32, device=h.device)
    # Each block is checkpointed: autograd would otherwise keep every
    # block's [N, chunk] logits for the backward — re-materializing exactly
    # the tensor this op exists to avoid.
    for base in range(0, v, chunk):
        m, s, lab = checkpoint(
            _fold_chunk, m, s, lab, h, w[:, base : base + chunk], b[base : base + chunk],
            labels, base, compute_dtype, use_reentrant=False,
        )
    return ((m + torch.log(s)) - lab).mean()


def lm_head_xent(
    model,
    tokens: torch.Tensor,
    chunk_size: int = 4096,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Next-token NLL for a ``TransformerLM`` without materialized logits.

    Runs the backbone (``return_features=True``), then the chunked head on
    the flattened [B*(T-1), D] features against the shifted tokens, reading
    the same ``lm_head`` parameters the model's own head uses.
    """
    feats = model(tokens, return_features=True)
    bsz, t, dm = feats.shape
    head = model.lm_head
    return chunked_softmax_xent(
        feats[:, :-1].reshape(bsz * (t - 1), dm).to(torch.float32),
        head.kernel.to(torch.float32),
        head.bias.to(torch.float32),
        tokens[:, 1:].reshape(-1),
        chunk_size=chunk_size,
        compute_dtype=compute_dtype,
    )


def naive_softmax_xent(h, w, b, labels) -> torch.Tensor:
    """The materialized-logits loss the chunked op replaces (test oracle)."""
    logits = _logits_f32(h, w)
    if b is not None:
        logits = logits + b.to(torch.float32)[None, :]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()
