"""Causal Transformer LM with pluggable attention: dense or flash.

The port of the JAX package's ``models/transformer.py``: pre-LN blocks,
learned or rotary positions, grouped-query attention, a training forward
(logits, or the pre-head features for ``ops.xent.lm_head_xent``) with
optional per-block rematerialisation, a one-pass prefill that collects every
block's K/V, KV-cache decoding (:func:`generate`), and the paged decode step
of the serving engine (:meth:`TransformerLM.decode_step_paged`: per-slot
positions against a shared KV block pool, ``ops.paged_attention``).

- ``attention="dense"`` — plain torch dense attention;
- ``attention="flash"`` — :func:`..ops.flash_attention.flash_attention`,
  the hand-written CUDA kernels on the card (forward, and the dq and dk/dv
  passes in the backward; their plain versions on the CPU).

Ring attention and MoE blocks come with a later slice; asking for them
raises ``NotImplementedError``.

Numerics follow the flax model exactly: every parameter is stored in f32
(flax's ``param_dtype``), and the Dense layers and embeddings cast their
parameters and inputs to ``dtype`` (bfloat16 by default) at use, so an
optimizer updates f32 master weights; LayerNorm with epsilon 1e-6 computed
in f32; the tanh-approximate GELU; rotary embedding in rotate-half form
computed in f32; ``ln_f`` and ``lm_head`` run in f32, so the logits are f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from .._device import resolve

LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)

# What a rematerialised block saves for the backward (``remat_policy``):
#   "full"          — nothing: the whole block is recomputed;
#   "dots"          — every matmul output (jax's ``checkpoint_dots``);
#   "dots_no_batch" — only weight @ activation products, the matmuls with
#                     no batch dimension (``checkpoint_dots_with_no_batch_dims``).
REMAT_POLICIES = ("full", "dots", "dots_no_batch")
_SAVED_OPS = {
    "dots": [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default],
    "dots_no_batch": [torch.ops.aten.mm.default, torch.ops.aten.addmm.default],
}


def apply_rotary(x: torch.Tensor, base: float = 10000.0, offset=0) -> torch.Tensor:
    """Rotary position embedding (RoPE) on [B, T, H, D], rotate-half form.

    The two halves of each head's features form the rotated pairs (not
    interleaved neighbours).  Computed in float32 and cast back.  ``offset``
    shifts the positions: an int or a 0-d tensor (the cache index during
    decoding), or a [B] tensor when each row sits at its own position.
    """
    B, T, H, D = x.shape
    half = D // 2
    if D % 2:
        raise ValueError(f"rotary needs an even head dim, got {D}")
    dev = x.device
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=dev) / half)
    steps = torch.arange(T, dtype=torch.float32, device=dev)
    if isinstance(offset, torch.Tensor) and offset.ndim == 1:
        positions = offset.to(device=dev, dtype=torch.float32)[:, None] + steps[None, :]
        angles = positions[..., None] * freqs  # [B, T, half]
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
    else:
        # A python int stays a kernel argument: no host-to-device copy (and
        # no stream sync) per call on the decode path.
        angles = (steps + offset)[:, None] * freqs[None, :]  # [T, half]
        cos = torch.cos(angles)[None, :, None, :]
        sin = torch.sin(angles)[None, :, None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation (torch's default is exact)."""
    return F.gelu(x, approximate="tanh")


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 compute, epsilon 1e-6."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return F.layer_norm(x.to(torch.float32), (x.shape[-1],), self.scale, self.bias, LN_EPS)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=dtype)``: f32 parameters; input, kernel and
    bias are cast to ``dtype`` at use and the output is in ``dtype``.
    ``kernel`` is [in, out] as in flax."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))
        self.cast = None  # (kernel, bias) in dtype, set by cast_weights_once

    def forward(self, x):
        kernel, bias = self.cast or (self.kernel.to(self.dtype), self.bias.to(self.dtype))
        return F.linear(x.to(self.dtype), kernel.t(), bias)


class Embed(nn.Module):
    """flax ``nn.Embed(dtype=dtype)``: an f32 table, cast to ``dtype``
    before the lookup."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, dim, device=device))
        self.cast = None  # the table in dtype, set by cast_weights_once

    def forward(self, idx):
        table = self.embedding.to(self.dtype) if self.cast is None else self.cast
        return F.embedding(idx.long(), table)


def weight_casts(model: nn.Module) -> dict:
    """One cast of every Dense and Embed parameter of ``model`` to the
    layer's ``dtype``: ``{module: cast}`` for :func:`use_weight_casts`."""
    with torch.no_grad():
        return {m: ((m.kernel.to(m.dtype), m.bias.to(m.dtype)) if isinstance(m, Dense)
                    else m.embedding.to(m.dtype))
                for m in model.modules() if isinstance(m, (Dense, Embed))}


@contextlib.contextmanager
def use_weight_casts(casts: dict):
    """Inside the block, the layers of ``casts`` use those casts instead of
    casting their f32 parameters at each call; the casts in place before are
    back afterwards, so the blocks nest."""
    before = {m: m.cast for m in casts}
    for m, cast in casts.items():
        m.cast = cast
    try:
        yield
    finally:
        for m, cast in before.items():
            m.cast = cast


@contextlib.contextmanager
def cast_weights_once(model: nn.Module):
    """Inside the block, every Dense and Embed of ``model`` uses one cast of
    its f32 parameters to its ``dtype`` instead of casting at each call:
    generation calls each layer once per token, and the per-call casts
    (~100 extra launches per decode step) slow the host-bound decode.  The
    same rounding, so the same numbers.  For inference only: the casts do
    not follow parameter updates made inside the block."""
    with use_weight_casts(weight_casts(model)):
        yield model


class Block(nn.Module):
    """Pre-LN transformer block: attention, then a tanh-GELU MLP."""

    def __init__(self, d_model: int, num_heads: int, attention: str, dtype: torch.dtype,
                 rotary: bool = False, num_kv_heads: Optional[int] = None, device=None):
        super().__init__()
        self.d_model, self.num_heads, self.attention = d_model, num_heads, attention
        self.dtype, self.rotary = dtype, rotary
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads={num_heads} must be divisible by num_kv_heads={self.num_kv_heads}"
            )
        hd = d_model // num_heads
        self.LayerNorm_0 = LayerNorm(d_model, device)
        self.qkv = Dense(d_model, (num_heads + 2 * self.num_kv_heads) * hd, dtype, device)
        self.proj = Dense(d_model, d_model, dtype, device)
        self.LayerNorm_1 = LayerNorm(d_model, device)
        self.Dense_0 = Dense(d_model, 4 * d_model, dtype, device)
        self.Dense_1 = Dense(4 * d_model, d_model, dtype, device)

    def _qkv(self, x):
        B, T, D = x.shape
        H, Hk = self.num_heads, self.num_kv_heads
        qkv = self.qkv(self.LayerNorm_0(x)).reshape(B, T, H + 2 * Hk, D // H)
        # Head-major columns: [H q heads, Hk k heads, Hk v heads].
        return qkv[:, :, :H], qkv[:, :, H : H + Hk], qkv[:, :, H + Hk :]

    def _finish(self, x, att):
        B, T, D = x.shape
        x = x + self.proj(att.reshape(B, T, D))
        y = self.Dense_0(self.LayerNorm_1(x))
        y = self.Dense_1(gelu(y))
        return x + y

    def _attend(self, x, q, k, v):
        group = self.num_heads // self.num_kv_heads
        if group > 1:
            # The attention paths take equal head counts: repeat each KV
            # head across its query group (transient; the cache keeps Hk).
            # Autograd sums the repeated heads' gradients back.
            k = torch.repeat_interleave(k, group, dim=2)
            v = torch.repeat_interleave(v, group, dim=2)
        if self.attention == "flash":
            from ..ops.flash_attention import flash_attention

            att = flash_attention(q, k, v, causal=True)
        else:
            from ..parallel.ring_attention import full_attention

            att = full_attention(q, k, v, causal=True)
        return self._finish(x, att)

    def _qkv_positions(self, x):
        q, k, v = self._qkv(x)
        if self.rotary:
            q, k = apply_rotary(q), apply_rotary(k)
        return q, k, v

    def forward(self, x):
        """Full-sequence (training) pass: the block's output only."""
        return self._attend(x, *self._qkv_positions(x))

    def prefill(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full-sequence pass that also returns ``(x, k, v)`` with the
        block's K/V in ``dtype`` at Hk heads — what seeds the decode cache."""
        q, k, v = self._qkv_positions(x)
        return self._attend(x, q, k, v), k.to(self.dtype), v.to(self.dtype)

    def decode(self, x, cache_k, cache_v, t: int):
        """One-token step against the dense KV cache: writes this position's
        K/V into ``cache_k``/``cache_v`` ([B, max_len, Hk, hd]) at ``t`` in
        place, then attends over positions ``<= t``."""
        from ..ops.paged_attention import gathered_decode_attention

        if x.shape[1] != 1:
            raise ValueError(f"decode mode steps one token at a time, got T={x.shape[1]}")
        q, k, v = self._qkv(x)
        if self.rotary:
            q, k = apply_rotary(q, offset=t), apply_rotary(k, offset=t)
        cache_k[:, t] = k[:, 0].to(cache_k.dtype)
        cache_v[:, t] = v[:, 0].to(cache_v.dtype)
        att = gathered_decode_attention(q, cache_k, cache_v, t).to(x.dtype)
        return self._finish(x, att)

    def decode_paged(self, x, pool_k, pool_v, paged):
        """One-token step of every slot against the shared KV block pool:
        writes each slot's K/V at its own position ``paged.lengths`` into
        ``pool_k``/``pool_v`` ([num_blocks, block_size, Hk, hd]) in place,
        then attends over positions ``<= paged.lengths`` through the slot's
        block table (``ops.paged_attention``; the same math as
        :meth:`decode`)."""
        from ..ops.paged_attention import paged_attention, paged_kv_write

        if x.shape[1] != 1:
            raise ValueError(f"decode mode steps one token at a time, got T={x.shape[1]}")
        q, k, v = self._qkv(x)
        t = paged.lengths
        if self.rotary:
            q, k = apply_rotary(q, offset=t), apply_rotary(k, offset=t)
        paged_kv_write(pool_k, k[:, 0], paged.block_tables, t, paged.active)
        paged_kv_write(pool_v, v[:, 0], paged.block_tables, t, paged.active)
        att = paged_attention(q, pool_k, pool_v, paged.block_tables, t).to(x.dtype)
        return self._finish(x, att)


class TransformerLM(nn.Module):
    """Causal LM: embeddings, ``num_layers`` blocks, ``ln_f`` and the f32
    ``lm_head``.  Weights are drawn from ``generator`` (a fresh CPU
    generator seeded 0 when None) and placed on ``device`` (CUDA by
    default; pass ``device="cpu"`` to run on the CPU)."""

    def __init__(
        self,
        vocab_size: int,
        d_model: int = 256,
        num_heads: int = 4,
        num_kv_heads: Optional[int] = None,
        num_layers: int = 4,
        max_len: int = 8192,
        attention: str = "flash",
        dtype: torch.dtype = torch.bfloat16,
        moe_num_experts: int = 0,
        pos_embedding: str = "learned",
        kv_num_blocks: int = 0,
        kv_block_size: int = 16,
        remat: bool = False,
        remat_policy: str = "full",
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if attention == "ring":
            raise NotImplementedError("attention='ring': ring attention is not yet ported (slice 9)")
        if attention not in ("dense", "flash"):
            raise ValueError(f"unknown attention {attention!r}")
        if moe_num_experts:
            raise NotImplementedError("MoE blocks are not yet ported (slice 9)")
        # Validated even when remat is off, as the flax model does: bench
        # rows are keyed by this string, so a typo must never run silently.
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be one of {'|'.join(REMAT_POLICIES)}, got {remat_policy!r}"
            )
        if pos_embedding not in ("learned", "rotary"):
            raise ValueError(f"unknown pos_embedding {pos_embedding!r}")
        dev = resolve(device)
        self.vocab_size, self.d_model, self.num_heads = vocab_size, d_model, num_heads
        self.num_kv_heads = num_kv_heads
        self.num_layers, self.max_len, self.attention = num_layers, max_len, attention
        self.dtype, self.pos_embedding = dtype, pos_embedding
        self.remat, self.remat_policy = remat, remat_policy
        # The paged cache's geometry (the flax model's fields).  With
        # kv_num_blocks > 0 the model decodes only through decode_step_paged;
        # the pools belong to the serving engine, which sizes them from these
        # two fields unless it is told otherwise.
        self.kv_num_blocks, self.kv_block_size = kv_num_blocks, kv_block_size
        self.embed = Embed(vocab_size, d_model, dtype, dev)
        self.pos = Embed(max_len, d_model, dtype, dev) if pos_embedding == "learned" else None
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, attention, dtype, rotary=pos_embedding == "rotary",
                  num_kv_heads=num_kv_heads, device=dev)
            for _ in range(num_layers)
        )
        self.ln_f = LayerNorm(d_model, dev)
        self.lm_head = Dense(d_model, vocab_size, torch.float32, dev)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's default initialisers, drawn on the CPU from ``generator``:
        embeddings N(0, 1/d) (variance scaling over the feature axis), Dense
        kernels truncated-normal with variance 1/fan_in (lecun normal),
        biases 0, LayerNorm scale 1 and bias 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, Embed):
                w = torch.randn(mod.embedding.shape, generator=generator)
                mod.embedding.copy_(w / math.sqrt(mod.embedding.shape[1]))
            elif isinstance(mod, Dense):
                fan_in = mod.kernel.shape[0]
                # lecun_normal: truncated at 2 sigma, sigma corrected for the cut.
                std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                w = torch.empty(mod.kernel.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                mod.kernel.copy_(w)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()

    def _embed(self, tokens, start=0):
        """Token (and learned position) embeddings; ``start`` is the first
        position: an int, or a [B] tensor when each row sits at its own."""
        x = self.embed(tokens)
        if self.pos is not None:
            T = tokens.shape[1]
            if isinstance(start, torch.Tensor):
                steps = torch.arange(T, device=tokens.device, dtype=start.dtype)
                idx = start.to(tokens.device)[:, None] + steps[None, :]
            else:
                idx = torch.arange(start, start + T, device=tokens.device)[None, :]
            x = x + self.pos(idx)
        return x

    def _head(self, x):
        return self.lm_head(self.ln_f(x))

    def _block(self, block: Block, x):
        """One block of the training forward, rematerialised in the
        backward when ``remat`` is on and gradients are being recorded."""
        if not (self.remat and torch.is_grad_enabled()):
            return block(x)
        if self.remat_policy == "full":
            return checkpoint(block, x, use_reentrant=False)
        # Selective: the matmul outputs the policy names are saved, the
        # rest (norms, activations, and the flash node, which is no matmul)
        # is recomputed in the backward.
        ops = _SAVED_OPS[self.remat_policy]
        return checkpoint(block, x, use_reentrant=False,
                          context_fn=lambda: create_selective_checkpoint_contexts(ops))

    def forward(self, tokens, return_features: bool = False):
        """Logits [B, T, V] f32 — or, with ``return_features=True``, the f32
        ``ln_f`` output [B, T, D] that ``ops.xent.lm_head_xent`` feeds its
        chunked head.  Builds no K/V cache."""
        x = self._embed(tokens)
        for block in self.blocks:
            x = self._block(block, x)
        x = self.ln_f(x)
        return x if return_features else self.lm_head(x)

    def prefill(self, tokens):
        """One teacher-forced pass over ``tokens`` [B, T]: ``(logits,
        kvs)`` where ``kvs`` holds each block's ``(k, v)`` [B, T, Hk, hd] in
        ``dtype`` (the flax model's ``collect_kv`` prefill)."""
        x = self._embed(tokens)
        kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for block in self.blocks:
            x, k, v = block.prefill(x)
            kvs.append((k, v))
        return self._head(x), kvs

    def decode_step(self, tokens, cache_k, cache_v, t: int):
        """One-token step at position ``t``: ``tokens`` [B, 1]; ``cache_k``
        / ``cache_v`` are [L, B, max_len, Hk, hd] and get this position's
        K/V written in place.  Returns logits [B, 1, V].  A model with
        ``kv_num_blocks > 0`` has no dense cache and refuses, as the flax
        model refuses a paged decode without ``paged=``."""
        if self.kv_num_blocks:
            raise ValueError(
                "kv_num_blocks > 0 decodes through a paged pool: use "
                "decode_step_paged (engine.ContinuousBatchingEngine)"
            )
        x = self._embed(tokens, start=t)
        for i, block in enumerate(self.blocks):
            x = block.decode(x, cache_k[i], cache_v[i], t)
        return self._head(x)

    def decode_step_paged(self, tokens, pools_k, pools_v, paged):
        """One-token step of every decode slot, each at its own position:
        ``tokens`` [S, 1]; ``pools_k``/``pools_v`` hold one [num_blocks,
        block_size, Hk, hd] pool per layer and get each active slot's K/V
        written in place (inactive slots write the null block 0);
        ``paged`` is an ``ops.paged_attention.PagedState``.  Returns logits
        [S, 1, V].  The flax model's ``decode=True`` path with
        ``kv_num_blocks > 0``."""
        x = self._embed(tokens, start=paged.lengths)
        for i, block in enumerate(self.blocks):
            x = block.decode_paged(x, pools_k[i], pools_v[i], paged)
        return self._head(x)


def generate(
    model: TransformerLM,
    prompt: torch.Tensor,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Autoregressive sampling with a per-block KV cache.

    ``prompt`` is [B, Tp] integer; returns [B, Tp + max_new_tokens] on the
    model's device, in the prompt's dtype, with the continuation appended.
    Prefill is ONE teacher-forced pass over the prompt through the model's
    own attention kind (the flash kernel on the card); its K/V seed a dense
    cache of ``max_len`` positions, and each new token is a single-position
    step against it.  ``temperature=0`` is greedy argmax (first index on
    ties); otherwise softmax sampling from ``generator``, which must live on
    the model's device.
    """
    B, Tp = prompt.shape
    if Tp + max_new_tokens > model.max_len:
        raise ValueError(
            f"prompt + max_new_tokens = {Tp + max_new_tokens} exceeds the "
            f"cache capacity max_len={model.max_len}"
        )
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 needs an explicit torch.Generator")
    # Checked where the prompt lies (the host, for served requests): on the
    # card an out-of-range index is a device-side assert that poisons the
    # context for every later request, where XLA would have clamped it.
    if prompt.numel() and (int(prompt.min()) < 0 or int(prompt.max()) >= model.vocab_size):
        raise ValueError(f"prompt tokens must lie in [0, {model.vocab_size})")
    # One cast of the f32 weights serves the prefill and every decode step.
    with cast_weights_once(model):
        dev = model.device
        tokens = prompt.to(dev)
        logits, kvs = model.prefill(tokens)
        last = logits[:, -1]
        L = model.num_layers
        Hk = model.num_kv_heads or model.num_heads
        hd = model.d_model // model.num_heads
        cache_k = torch.zeros(L, B, model.max_len, Hk, hd, dtype=model.dtype, device=dev)
        cache_v = torch.zeros_like(cache_k)
        for i, (k, v) in enumerate(kvs):
            cache_k[i, :, :Tp] = k
            cache_v[i, :, :Tp] = v
        del kvs
        new = []
        for step in range(max_new_tokens):
            if temperature == 0.0:
                tok = torch.argmax(last, dim=-1)
            else:
                probs = torch.softmax(last / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            new.append(tok)
            if step + 1 < max_new_tokens:  # the last token's logits go unused
                last = model.decode_step(tok[:, None], cache_k, cache_v, Tp + step)[:, 0]
        if not new:
            return tokens
        return torch.cat([tokens, torch.stack(new, dim=1).to(tokens.dtype)], dim=1)


def sharded_generator(*args, **kwargs):
    raise NotImplementedError("tensor-parallel generation is not yet ported (slice 9)")


def pipeline_lm_apply(*args, **kwargs):
    raise NotImplementedError("pipeline-parallel apply is not yet ported (slice 9)")
