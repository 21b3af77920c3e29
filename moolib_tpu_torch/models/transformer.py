"""Causal Transformer LM with pluggable attention: dense, flash or ring.

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
  passes in the backward; their plain versions on the CPU);
- ``attention="ring"`` — :func:`..parallel.ring_attention.ring_attention_sharded`
  over the ``sp`` axis of a mesh passed at call time (``model(tokens,
  mesh=mesh)`` on this rank's ``[B/dp, T/sp]`` token block): each hop runs
  the same flash kernels on a chunk.  Positions (the learned table and
  rotary alike) start at ``sp_rank * T/sp``.

Tensor parallelism over a ``tp`` mesh axis: ``parallel.tensor_parallel.
shard_model`` cuts the model to a rank's blocks of the ``auto_shardings``
layout; ``forward``, ``prefill`` and ``decode_step`` then run sharded (each
cut layer computes its output features and gathers them, attention splits
by heads), and :func:`sharded_generator` serves through them.

Sparse capacity via ``moe_num_experts > 0``: every ``moe_every``-th block
swaps its dense FFN for a :class:`..parallel.moe.SwitchMoE` (``ffn_dim``
4·d, no residual inside), whose experts shard over an ``ep`` mesh axis
(``parallel.moe.shard_experts``).  The router's load-balancing aux losses of
the last forward are ``model.aux_losses`` (flax sows them into ``losses``).
:func:`pipeline_lm_apply` runs the blocks through
``parallel.pipeline.pipeline_apply`` over a ``pp`` axis.

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
    ``kernel`` is [in, out] as in flax.  Cut over ``tp``
    (``parallel.tensor_parallel.shard_model``) it holds its block of output
    features: :meth:`forward_local` computes them, :meth:`forward` gathers
    them."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))
        self.cast = None  # (kernel, bias) in dtype, set by cast_weights_once
        self.tp = None  # parallel.tensor_parallel.TPShard once cut

    def forward_local(self, x):
        """This rank's output features (all of them when not cut)."""
        kernel, bias = self.cast or (self.kernel.to(self.dtype), self.bias.to(self.dtype))
        if self.tp is not None:
            bias = self.tp.local(bias)
        return F.linear(x.to(self.dtype), kernel.t(), bias)

    def forward(self, x):
        y = self.forward_local(x)
        return y if self.tp is None else self.tp.gather(y)


class Embed(nn.Module):
    """flax ``nn.Embed(dtype=dtype)``: an f32 table, cast to ``dtype``
    before the lookup."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, dim, device=device))
        self.cast = None  # the table in dtype, set by cast_weights_once
        self.tp = None  # cut over tp: the table's block of features

    def forward(self, idx):
        table = self.embedding.to(self.dtype) if self.cast is None else self.cast
        out = F.embedding(idx.long(), table)
        return out if self.tp is None else self.tp.gather(out)


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
    """Pre-LN transformer block: attention, then a tanh-GELU MLP (or, with
    ``moe_num_experts``, a Switch MoE FFN)."""

    def __init__(self, d_model: int, num_heads: int, attention: str, dtype: torch.dtype,
                 rotary: bool = False, num_kv_heads: Optional[int] = None, device=None,
                 moe_num_experts: int = 0, moe_capacity_factor: float = 1.25):
        super().__init__()
        self.d_model, self.num_heads, self.attention = d_model, num_heads, attention
        self.dtype, self.rotary = dtype, rotary
        self.num_kv_heads = num_kv_heads or num_heads
        self.tp = None  # parallel.tensor_parallel.TPShard of a cut model
        if num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads={num_heads} must be divisible by num_kv_heads={self.num_kv_heads}"
            )
        hd = d_model // num_heads
        self.LayerNorm_0 = LayerNorm(d_model, device)
        self.qkv = Dense(d_model, (num_heads + 2 * self.num_kv_heads) * hd, dtype, device)
        self.proj = Dense(d_model, d_model, dtype, device)
        self.LayerNorm_1 = LayerNorm(d_model, device)
        if moe_num_experts:
            from ..parallel.moe import SwitchMoE

            self.moe = SwitchMoE(d_model, moe_num_experts, 4 * d_model,
                                 capacity_factor=moe_capacity_factor, dtype=dtype,
                                 residual=False, device=device)
        else:
            self.moe = None
            self.Dense_0 = Dense(d_model, 4 * d_model, dtype, device)
            self.Dense_1 = Dense(4 * d_model, d_model, dtype, device)

    def _qkv(self, x):
        B, T, D = x.shape
        H, Hk = self.num_heads, self.num_kv_heads
        qkv = self.qkv(self.LayerNorm_0(x)).reshape(B, T, H + 2 * Hk, D // H)
        # Head-major columns: [H q heads, Hk k heads, Hk v heads].
        return qkv[:, :, :H], qkv[:, :, H : H + Hk], qkv[:, :, H + Hk :]

    def _finish(self, x, att, mesh=None):
        """The projection and the FFN: ``(x, moe aux loss or None)``.
        ``att`` is this rank's heads' output (every head's unless the heads
        split over ``tp``)."""
        B, T, D = x.shape
        att = att.reshape(B, T, -1)
        if self.head_split() is not None:
            att = self.tp.gather(att)
        x = x + self.proj(att)
        y = self.LayerNorm_1(x)
        if self.moe is not None:
            y, aux = self.moe(y, mesh)
            return x + y, aux
        # GELU on the local features of a cut Dense_0, then one gather.
        y = gelu(self.Dense_0.forward_local(y))
        if self.Dense_0.tp is not None:
            y = self.Dense_0.tp.gather(y)
        y = self.Dense_1(y)
        return x + y, None

    def head_split(self) -> Optional[Tuple[slice, slice]]:
        """This rank's ``(query heads, KV heads)`` where the heads split over
        ``tp`` (both counts multiples of its size), else None."""
        tp = self.tp
        if tp is None or self.num_heads % tp.n or self.num_kv_heads % tp.n:
            return None
        hq, hk = self.num_heads // tp.n, self.num_kv_heads // tp.n
        return slice(tp.rank * hq, (tp.rank + 1) * hq), slice(tp.rank * hk, (tp.rank + 1) * hk)

    def _local_heads(self, q, k, v):
        split = self.head_split()
        if split is None:
            return q, k, v
        return q[:, :, split[0]], k[:, :, split[1]], v[:, :, split[1]]

    def _attend(self, x, q, k, v, mesh=None, prefill: bool = False):
        group = self.num_heads // self.num_kv_heads
        if group > 1:
            # The attention paths take equal head counts: repeat each KV
            # head across its query group (transient; the cache keeps Hk).
            # Autograd sums the repeated heads' gradients back.
            k = torch.repeat_interleave(k, group, dim=2)
            v = torch.repeat_interleave(v, group, dim=2)
        if self.attention == "ring" and not prefill:
            from ..parallel.ring_attention import ring_attention_sharded

            if mesh is None:
                raise ValueError("attention='ring' needs mesh= at call time")
            att = ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=True)
        elif self.attention in ("flash", "ring"):
            # A ring model prefills one sequence on one device: its
            # single-device equivalent is flash (the JAX package's rule).
            from ..ops.flash_attention import flash_attention

            att = flash_attention(q, k, v, causal=True)
        else:
            from ..parallel.ring_attention import full_attention

            att = full_attention(q, k, v, causal=True)
        return self._finish(x, att, mesh)

    def _qkv_positions(self, x, offset=0):
        q, k, v = self._local_heads(*self._qkv(x))
        if self.rotary:
            q, k = apply_rotary(q, offset=offset), apply_rotary(k, offset=offset)
        return q, k, v

    def forward_aux(self, x, mesh=None, offset: int = 0):
        """Full-sequence (training) pass: ``(output, MoE aux loss or
        None)``.  ``offset`` is the position of the first token (a ring
        rank's sequence chunk starts at ``sp_rank * T/sp``)."""
        return self._attend(x, *self._qkv_positions(x, offset), mesh=mesh)

    def forward(self, x, mesh=None, offset: int = 0):
        """Full-sequence (training) pass: the block's output only."""
        return self.forward_aux(x, mesh, offset)[0]

    def prefill(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full-sequence pass that also returns ``(x, k, v)`` with the
        block's K/V in ``dtype`` at Hk heads (this rank's Hk/tp where the
        heads split over ``tp``) — what seeds the decode cache."""
        q, k, v = self._qkv_positions(x)
        return self._attend(x, q, k, v, prefill=True)[0], k.to(self.dtype), v.to(self.dtype)

    def decode(self, x, cache_k, cache_v, t: int):
        """One-token step against the dense KV cache: writes this position's
        K/V into ``cache_k``/``cache_v`` ([B, max_len, Hk, hd], this rank's
        heads under a ``tp`` split) at ``t`` in place, then attends over
        positions ``<= t``."""
        from ..ops.paged_attention import gathered_decode_attention

        if x.shape[1] != 1:
            raise ValueError(f"decode mode steps one token at a time, got T={x.shape[1]}")
        q, k, v = self._local_heads(*self._qkv(x))
        if self.rotary:
            q, k = apply_rotary(q, offset=t), apply_rotary(k, offset=t)
        cache_k[:, t] = k[:, 0].to(cache_k.dtype)
        cache_v[:, t] = v[:, 0].to(cache_v.dtype)
        att = gathered_decode_attention(q, cache_k, cache_v, t).to(x.dtype)
        return self._finish(x, att)[0]

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
        return self._finish(x, att)[0]


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
        moe_every: int = 2,
        moe_capacity_factor: float = 1.25,
        pos_embedding: str = "learned",
        kv_num_blocks: int = 0,
        kv_block_size: int = 16,
        remat: bool = False,
        remat_policy: str = "full",
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if attention not in ("dense", "flash", "ring"):
            raise ValueError(f"unknown attention {attention!r}")
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
        self.moe_num_experts, self.moe_every = moe_num_experts, moe_every
        self.moe_capacity_factor = moe_capacity_factor
        self.aux_losses: List[torch.Tensor] = []  # the MoE blocks' of the last forward
        # The paged cache's geometry (the flax model's fields).  With
        # kv_num_blocks > 0 the model decodes only through decode_step_paged;
        # the pools belong to the serving engine, which sizes them from these
        # two fields unless it is told otherwise.
        self.kv_num_blocks, self.kv_block_size = kv_num_blocks, kv_block_size
        self.tp = None  # set when parallel.tensor_parallel.shard_model cuts the model
        self.embed = Embed(vocab_size, d_model, dtype, dev)
        self.pos = Embed(max_len, d_model, dtype, dev) if pos_embedding == "learned" else None
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, attention, dtype, rotary=pos_embedding == "rotary",
                  num_kv_heads=num_kv_heads, device=dev,
                  moe_num_experts=moe_num_experts if self._is_moe(i) else 0,
                  moe_capacity_factor=moe_capacity_factor)
            for i in range(num_layers)
        )
        self.ln_f = LayerNorm(d_model, dev)
        self.lm_head = Dense(d_model, vocab_size, torch.float32, dev)
        self.reset_parameters(generator)

    def _is_moe(self, i: int) -> bool:
        """Blocks i with i % moe_every == moe_every - 1 use MoE (flax's rule)."""
        return bool(self.moe_num_experts) and i % self.moe_every == self.moe_every - 1

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def cache_kv_heads(self) -> int:
        """KV heads of this rank's decode cache: Hk, or Hk/tp where a cut
        model's heads split over ``tp``."""
        hk = self.num_kv_heads or self.num_heads
        split = self.blocks[0].head_split() if len(self.blocks) else None
        return hk if split is None else split[1].stop - split[1].start

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
            elif hasattr(mod, "w_in") and hasattr(mod, "w_out"):  # SwitchMoE
                for w in (mod.w_in, mod.w_out):
                    # lecun_normal over [E, in, out]: flax counts the expert
                    # axis as receptive field, fan_in = E * in.
                    std = 1.0 / math.sqrt(w.shape[0] * w.shape[1]) / 0.87962566103423978
                    t = torch.empty(w.shape)
                    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
                    w.copy_(t)

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

    def _block(self, block: Block, x, mesh=None, offset: int = 0):
        """One block of the training forward, rematerialised in the
        backward when ``remat`` is on and gradients are being recorded:
        ``(output, MoE aux loss or None)``."""
        return remat_call(block.forward_aux, (x, mesh, offset),
                          self.remat and torch.is_grad_enabled(), self.remat_policy)

    def forward(self, tokens, return_features: bool = False, mesh=None):
        """Logits [B, T, V] f32 — or, with ``return_features=True``, the f32
        ``ln_f`` output [B, T, D] that ``ops.xent.lm_head_xent`` feeds its
        chunked head.  Builds no K/V cache.  ``mesh``: the mesh a ring
        model's ``sp`` axis and an MoE model's ``ep`` axis live on;
        ``tokens`` is then this rank's block.  The MoE blocks' aux losses
        land in ``self.aux_losses``."""
        offset = 0
        if self.attention == "ring":
            if mesh is None:
                raise ValueError("attention='ring' needs mesh= at call time")
            offset = mesh.get_local_rank("sp") * tokens.shape[1]
        x = self._embed(tokens, start=offset)
        aux_losses = []
        for block in self.blocks:
            x, aux = self._block(block, x, mesh, offset)
            if aux is not None:
                aux_losses.append(aux)
        self.aux_losses = aux_losses
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
    if model.moe_num_experts:
        # Per-step Switch capacity is computed over B tokens, not B*T, so
        # cached decoding would drop different tokens than the training
        # forward: refuse rather than silently diverge (the JAX rule).
        raise ValueError("generate() does not support MoE models yet")
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
        Hk = model.cache_kv_heads()
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


def sharded_generator(
    model: TransformerLM,
    max_new_tokens: int,
    mesh,
    params_sharding=None,
    temperature: float = 0.0,
    sample: bool = False,
):
    """A reusable tensor-parallel :func:`generate` over ``mesh`` (the JAX
    package's ``sharded_generator``, per rank): the model is cut to this
    rank's ``tp`` blocks (``parallel.tensor_parallel.shard_model``, once;
    its weights come in whole, from ``models.convert.from_flax`` or a
    checkpoint), so a rank holds ~1/tp of the big kernels and a model
    larger than one card's memory serves.  ``params_sharding`` defaults to
    ``parallel.auto_shardings``, the layout the training step uses.  Each
    block's prefill attends this rank's heads through the flash kernel
    and the decode cache holds them (the JAX package's "heads follow the
    attention kernels' TP axis").  The prompt and the output are
    replicated: every rank of the mesh calls the returned function with
    the same prompt, in the same order.

    Returns ``fn(prompt)`` (greedy) or, with ``sample=True``, ``fn(prompt,
    generator)`` (softmax sampling at ``temperature``; every rank passes a
    generator in the same state, so each draws the same tokens from the
    same gathered logits)."""
    from ..parallel.tensor_parallel import shard_model

    shard_model(model, mesh, params_sharding)
    if sample:
        return lambda prompt, generator: generate(model, prompt, max_new_tokens,
                                                  temperature, generator)
    return lambda prompt: generate(model, prompt, max_new_tokens, temperature)


def generate_sharded(
    model: TransformerLM,
    prompt: torch.Tensor,
    max_new_tokens: int,
    mesh,
    params_sharding=None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """One-shot form of :func:`sharded_generator`."""
    fn = sharded_generator(model, max_new_tokens, mesh, params_sharding, temperature,
                           sample=generator is not None)
    return fn(prompt, generator) if generator is not None else fn(prompt)


def pipeline_lm_apply(
    model: TransformerLM,
    tokens: torch.Tensor,
    mesh,
    num_microbatches: int,
    axis_name: str = "pp",
    data_axis: Optional[str] = None,
    circular_repeats: int = 1,
    remat: bool = False,
    remat_policy: str = "full",
) -> torch.Tensor:
    """Apply ``model`` with its blocks run through
    :func:`..parallel.pipeline.pipeline_apply` over the mesh's ``pp`` axis
    (the JAX package's ``pipeline_lm_apply``, per rank).

    ``tokens`` is this rank's batch (its ``data_axis`` block, the same on
    every ``pp`` rank).  Embeddings, ``ln_f`` and the f32 ``lm_head`` run
    outside the pipeline, replicated over ``pp``; under the package's
    gradient convention (``parallel.collectives``) their gradients count
    once: only the first stage consumes the embeddings, and the head's
    gradient is each ``pp`` rank's share.  Block ``j`` runs on ``pp`` rank
    ``j % S`` during lap ``j // S``; gradients land in the per-block
    parameters (every rank holds every block and uses its own), so one
    optimizer serves both this and the plain path.  Attention must be
    "dense" or "flash".  Returns logits [B, T, V] f32.
    """
    from ..parallel.pipeline import pipeline_apply

    if model.attention == "ring":
        raise ValueError("pipeline_lm_apply supports dense/flash attention only")
    if model.moe_num_experts:
        raise ValueError("pipeline_lm_apply needs structurally identical blocks (no MoE)")
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"remat_policy must be one of {'|'.join(REMAT_POLICIES)}, got {remat_policy!r}"
        )
    B, T = tokens.shape
    if B % num_microbatches:
        raise ValueError(f"batch {B} not divisible by microbatches {num_microbatches}")
    x = model._embed(tokens)
    mb = x.reshape(num_microbatches, B // num_microbatches, T, model.d_model)
    out = pipeline_apply(lambda block, h: block(h), list(model.blocks), mb, mesh,
                         axis_name=axis_name, data_axis=data_axis,
                         circular_repeats=circular_repeats, remat=remat,
                         remat_policy=remat_policy)
    return model._head(out.reshape(B, T, model.d_model))


def remat_call(fn, args: tuple, remat: bool, policy: str = "full"):
    """``fn(*args)``, rematerialised in the backward when ``remat``: the
    policy ("full", "dots" or "dots_no_batch", :data:`REMAT_POLICIES`)
    names what is saved."""
    if not remat:
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    # Selective: the matmul outputs the policy names are saved, the rest
    # (norms, activations, and the flash node, which is no matmul) is
    # recomputed in the backward.
    ops = _SAVED_OPS[policy]
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(ops))
