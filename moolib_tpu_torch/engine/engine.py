"""Continuous-batching decode engine over a paged KV block pool: the port of
the JAX package's ``engine/engine.py``, on the model's device.

The batch-synchronous baseline (``serving.ServeService`` + ``generate``)
decodes every request in a batch until the LONGEST one finishes, in a dense
per-sequence cache sized for the worst case.  This engine removes both
wastes:

- **Slots, not batches.**  Decode is ONE fixed-shape step over ``S`` slots.
  A sequence joins a free slot the moment its prefill lands and retires the
  moment it emits EOS or exhausts its token budget — no convoy behind a long
  neighbour.  Slot occupancy, lengths and block tables are device tensors
  updated in place, so a join or a retire never reallocates anything.
- **Blocks, not max_len rows.**  K/V live in a shared device pool of
  fixed-size token blocks per layer (``ops.paged_attention``); a sequence
  holds only the blocks its length needs (``engine.kv_pool.BlockPool``).

Prefill runs the model's own ``prefill`` (the flash kernel on the card) over
the prompt padded to its ``serving.bucket``; its K/V rows are copied
straight into the slot's pool blocks.  The pools are allocated once and
never rebound: their ``data_ptr()``s are stable for the engine's lifetime,
the port's form of "one decode compile, no cache reshuffle".

Greedy decoding only, as the serving plane is.  ``mesh=`` and
``prefill_devices=`` keep the JAX engine's meaning: only the two together
shard (disaggregated prefill on a ``split_mesh`` submesh), and that comes
with the Sebulba split (slice 9c).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..models.convert import as_state_dict
from ..models.transformer import TransformerLM, use_weight_casts, weight_casts
from ..ops.paged_attention import PagedState
from ..serving import bucket, bucket_shapes
from .kv_pool import BlockPool, PoolExhausted

_REG = telemetry.get_registry()
# Registration is idempotent: serving.py declares the same counter for the
# batch-synchronous arm — both arms feed one series.
_M_PAD_TOKENS = _REG.counter(
    "serve_pad_tokens_total",
    "tokens of padding waste: bucket pad rows and decode overrun in the "
    "batch-synchronous arm, prompt-bucket padding in the engine arm — "
    "subtract from gross throughput to get REAL tokens/s",
)
_M_TOKENS = _REG.counter(
    "serve_engine_tokens_total", "tokens emitted by engine decode steps"
)
_M_PREFILL_TOKENS = _REG.counter(
    "serve_engine_prefill_tokens_total", "prompt tokens prefilled (unpadded)"
)
_M_JOINS = _REG.counter(
    "serve_engine_joins_total", "sequences joined to a decode slot"
)
_M_RETIRES = _REG.counter(
    "serve_engine_retires_total", "sequences retired (EOS or budget)"
)
_M_SLOTS = _REG.gauge(
    "serve_engine_slots_active", "decode slots currently occupied"
)
_M_OCC = _REG.gauge(
    "serve_engine_slot_occupancy", "occupied fraction of decode slots (0..1)"
)
_M_BLOCKS_FREE = _REG.gauge(
    "serve_engine_blocks_free", "KV pool blocks on the free list"
)


class NoFreeSlot(RuntimeError):
    """Every decode slot is occupied — the request should stay queued."""


class ContinuousBatchingEngine:
    """See module docstring.  The host side, owning the device state (the
    per-layer KV pools, block tables, per-slot lengths/tokens/budgets) and
    the three paths: bucketed prefill, in-place join, fixed-shape decode
    step.

    ``model`` is a :class:`~..models.transformer.TransformerLM` on the device
    the engine serves from; ``params`` (optional) are loaded into it first,
    as :meth:`set_params` loads them.  ``block_size`` and ``num_blocks``
    default to the model's ``kv_block_size`` and ``kv_num_blocks`` (the
    latter when it is set), as the JAX engine's decode model carries them.

    Single-threaded by contract: one loop (``EngineService``) calls
    ``submit``/``step``/``retire``/``set_params``; only the read-only stats
    are safe from other threads.
    """

    def __init__(self, model: TransformerLM, params=None, *, slots: int = 8,
                 block_size: Optional[int] = None, num_blocks: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 max_prompt_len: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 mesh=None, prefill_devices: int = 0):
        if mesh is not None and prefill_devices:
            # The JAX engine shards nothing but this split: a mesh alone, or
            # prefill_devices alone, is accepted and unused there too.
            raise NotImplementedError(
                "ContinuousBatchingEngine(mesh=, prefill_devices=): disaggregated "
                "prefill over the Sebulba mesh split is not yet ported (slice 9c)"
            )
        self.model = model
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("need at least one decode slot")
        self.block_size = int(block_size or model.kv_block_size)
        self.seq_capacity = int(max_seq_len or model.max_len)
        if self.seq_capacity > model.max_len:
            raise ValueError(
                f"max_seq_len={self.seq_capacity} exceeds the model's "
                f"max_len={model.max_len} (learned-pos table / rotary cap)"
            )
        self.max_blocks_per_seq = -(-self.seq_capacity // self.block_size)
        num_blocks = num_blocks or model.kv_num_blocks or None
        if num_blocks is None:
            # Worst case: every slot at full capacity, plus the null block.
            num_blocks = 1 + self.slots * self.max_blocks_per_seq
        self.pool = BlockPool(num_blocks, self.block_size)
        self.max_prompt_len = int(max_prompt_len or self.seq_capacity)
        self.eos_id = eos_id
        self.device = model.device
        self._L = model.num_layers
        self._Hk = model.num_kv_heads or model.num_heads
        self._hd = model.d_model // model.num_heads
        if params is not None:
            self.set_params(params)  # takes the casts
        else:
            self._casts = weight_casts(model)

        S, MB, dev = self.slots, self.max_blocks_per_seq, self.device
        shape = (num_blocks, self.block_size, self._Hk, self._hd)
        # Allocated once, in the compute dtype; every later write is in place.
        self.pools_k = [torch.zeros(shape, dtype=model.dtype, device=dev)
                        for _ in range(self._L)]
        self.pools_v = [torch.zeros(shape, dtype=model.dtype, device=dev)
                        for _ in range(self._L)]
        self._tables = torch.zeros((S, MB), dtype=torch.int64, device=dev)
        self._lengths = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._active = torch.zeros((S,), dtype=torch.bool, device=dev)
        self._tokens = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._remaining = torch.zeros((S,), dtype=torch.int64, device=dev)

        # Host mirrors (slot bookkeeping never round-trips device state).
        self._free_slots: List[int] = list(range(S - 1, -1, -1))
        self._slot_blocks: List[List[int]] = [[] for _ in range(S)]
        self._emitted: List[List[int]] = [[] for _ in range(S)]
        self._remaining_host = np.zeros(S, np.int64)
        self._active_host = np.zeros(S, bool)
        self._stats = {
            "joins": 0, "retires": 0, "decode_tokens": 0,
            "prefill_tokens": 0, "prefill_pad_tokens": 0, "steps": 0,
        }

    def set_params(self, params) -> None:
        """Load new weights into the model in place: a flax-layout tree of
        numpy leaves (what ``ModelPublisher`` carries) or a ``state_dict``.
        Called between iterations by the service's hot-swap hook — the KV
        pools and slot state are untouched, so in-flight sequences continue
        under the new weights.  The layers' ``dtype`` casts are taken once
        here, for every step of this version."""
        with torch.no_grad():
            self.model.load_state_dict(as_state_dict(params))
        self._casts = weight_casts(self.model)

    # ---------------------------------------------------------- device paths
    def _prefill(self, toks: torch.Tensor, tp: int) -> Tuple[list, int]:
        """toks [1, Lb] (bucket-padded prompt, on the device), tp the true
        length.  Returns each block's ``(k, v)`` [1, Lb, Hk, hd] and the
        first greedy token: the argmax of the logits at tp-1 (causal masking
        makes it ``generate()``'s)."""
        logits, kvs = self.model.prefill(toks)
        # The host needs the first token: it answers a budget-1 request.
        tok0 = int(torch.argmax(logits[0, tp - 1], dim=-1))
        return kvs, tok0

    def _join(self, slot: int, row: np.ndarray, tp: int, tok0: int, rem0: int,
              kvs: list, block_ids: List[int]) -> None:
        """Copy the prefilled K/V into the slot's first pool blocks in place
        and light the slot's row of the device state."""
        bs = self.block_size
        Lb = kvs[0][0].shape[1]
        nbw = -(-Lb // bs)
        ids = torch.as_tensor(block_ids[:nbw], dtype=torch.int64).to(self.device)
        for (k, v), pk, pv in zip(kvs, self.pools_k, self.pools_v):
            for x, pool in ((k, pk), (v, pv)):
                x = x[0]
                if nbw * bs != Lb:
                    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, nbw * bs - Lb))
                pool.index_copy_(0, ids, x.reshape(nbw, bs, self._Hk, self._hd).to(pool.dtype))
        self._tables[slot].copy_(torch.from_numpy(row))
        self._lengths[slot] = tp
        self._active[slot] = True
        self._tokens[slot] = tok0
        self._remaining[slot] = rem0

    def _step_device(self) -> torch.Tensor:
        """One fixed-shape decode step over all S slots, state updated in
        place.  Returns next-tokens and done flags stacked [2, S] on the
        device."""
        paged = PagedState(self._tables, self._lengths, self._active)
        logits = self.model.decode_step_paged(
            self._tokens[:, None], self.pools_k, self.pools_v, paged
        )
        active = self._active
        nxt = torch.argmax(logits[:, 0], dim=-1)
        nxt = torch.where(active, nxt, self._tokens)
        act = active.to(torch.int64)
        self._lengths.add_(act)
        self._remaining.sub_(act)
        done = active & (self._remaining <= 0)
        if self.eos_id is not None:
            done |= active & (nxt == self.eos_id)
        self._active.logical_and_(~done)
        self._tokens.copy_(nxt)
        return torch.stack((nxt, done.to(torch.int64)))

    # --------------------------------------------------------------- serving
    def can_accept(self, prompt_len: int, max_new: int) -> bool:
        """A free slot AND enough free blocks for the worst case of this
        request (its bucket-padded prompt or its full budget)."""
        if not self._free_slots:
            return False
        lb = bucket(int(prompt_len), self.max_prompt_len)
        need = self.pool.blocks_for(max(lb, int(prompt_len) + int(max_new)))
        return self.pool.available() >= need

    def pending_decode_tokens(self) -> int:
        """Budgeted-but-unemitted tokens across active slots (the admission
        controller's per-token wait estimate numerator)."""
        return int(self._remaining_host[self._active_host].sum())

    def active_count(self) -> int:
        return int(self._active_host.sum())

    def submit(self, prompt, max_new: int) -> Tuple[Optional[int], List[int]]:
        """Prefill ``prompt`` (1-D int tokens) and join a decode slot.

        Returns ``(slot, emitted)``: ``emitted`` always carries the first
        greedy token; ``slot`` is None when the request finished at prefill
        (budget of 1, or immediate EOS) and never occupied a slot.  Raises
        :class:`NoFreeSlot` / :class:`~.kv_pool.PoolExhausted` when full (the
        caller keeps the request queued) and ``ValueError`` for oversized
        prompts or tokens outside the vocabulary — checked here on the host:
        on the card an out-of-range index is a device-side assert that would
        poison the context for every later request.
        """
        prompt = np.asarray(prompt).reshape(-1)
        tp = prompt.shape[0]
        max_new = max(1, int(max_new))
        if tp < 1:
            raise ValueError("empty prompt")
        if tp > self.max_prompt_len:
            raise ValueError(
                f"prompt length {tp} exceeds max_prompt_len={self.max_prompt_len}"
            )
        total = tp + max_new
        if total > self.seq_capacity:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds the engine's "
                f"sequence capacity {self.seq_capacity}"
            )
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(f"prompt tokens must be integers, got {prompt.dtype}")
        if prompt.min() < 0 or prompt.max() >= self.model.vocab_size:
            raise ValueError(f"prompt tokens must lie in [0, {self.model.vocab_size})")
        lb = bucket(tp, self.max_prompt_len)
        n_alloc = self.pool.blocks_for(max(lb, total))
        # A request that needs a slot is refused before any device work, so
        # one that stays queued is prefilled once, when it joins.
        if max_new > 1:
            if not self._free_slots:
                raise NoFreeSlot(f"all {self.slots} slots occupied")
            if self.pool.available() < n_alloc:
                raise PoolExhausted(
                    f"need {n_alloc} blocks, {self.pool.available()} free "
                    f"(pool {self.pool.num_blocks}, block_size {self.block_size})"
                )
        pad = lb - tp
        toks = np.pad(prompt.astype(np.int64), (0, pad))[None]
        if pad:
            self._stats["prefill_pad_tokens"] += pad
            _M_PAD_TOKENS.inc(pad)
        with torch.no_grad(), use_weight_casts(self._casts):
            kvs, tok0 = self._prefill(torch.from_numpy(toks).to(self.device), tp)
            self._stats["prefill_tokens"] += tp
            _M_PREFILL_TOKENS.inc(tp)
            emitted = [tok0]
            if max_new == 1 or (self.eos_id is not None and tok0 == self.eos_id):
                return None, emitted
            block_ids = self.pool.alloc(n_alloc)
            slot = self._free_slots.pop()
            row = np.zeros(self.max_blocks_per_seq, np.int64)
            row[:n_alloc] = block_ids
            self._join(slot, row, tp, tok0, max_new - 1, kvs, block_ids)
        self._slot_blocks[slot] = block_ids
        self._emitted[slot] = emitted
        self._remaining_host[slot] = max_new - 1
        self._active_host[slot] = True
        self._stats["joins"] += 1
        _M_JOINS.inc()
        self._update_gauges()
        return slot, emitted

    def step(self) -> Tuple[Dict[int, int], List[int]]:
        """One fixed-shape decode step over every slot.  Returns the tokens
        emitted this step (slot -> token) and the slots that finished."""
        if not self._active_host.any():
            return {}, []
        with torch.no_grad(), use_weight_casts(self._casts):
            packed = self._step_device()
        # The decode loop's one D2H: next-tokens and done flags together.
        # host_span marks it host-blocked for any open timeline window.
        with telemetry.span("engine.decode_fetch"), \
                telemetry.timeline.host_span("engine.decode_fetch"):
            nxt, done = packed.cpu().numpy()
        emissions: Dict[int, int] = {}
        finished: List[int] = []
        for s in np.nonzero(self._active_host)[0]:
            tok = int(nxt[s])
            emissions[int(s)] = tok
            self._emitted[s].append(tok)
            self._remaining_host[s] -= 1
            if done[s]:
                finished.append(int(s))
                self._active_host[s] = False
        self._stats["steps"] += 1
        self._stats["decode_tokens"] += len(emissions)
        _M_TOKENS.inc(len(emissions))
        return emissions, finished

    def retire(self, slot: int) -> List[int]:
        """Free the slot's blocks and return its emitted tokens.  Pure host
        bookkeeping: the step that finished the slot already cleared its
        device ``active`` flag, nothing round-trips."""
        toks = self._emitted[slot]
        self.pool.free(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self._emitted[slot] = []
        self._remaining_host[slot] = 0
        self._free_slots.append(slot)
        self._stats["retires"] += 1
        _M_RETIRES.inc()
        self._update_gauges()
        return toks

    def _update_gauges(self) -> None:
        n = self.active_count()
        _M_SLOTS.set(n)
        _M_OCC.set(n / self.slots)
        _M_BLOCKS_FREE.set(self.pool.available())

    # ---------------------------------------------------------------- warmup
    def warmup(self) -> int:
        """Run every shape serving can hit before the first request: one
        prefill per prompt bucket and one decode step over the (all
        inactive) slots, whose writes land in the null block.  Returns the
        number of distinct shapes run."""
        shapes = sorted(set(bucket_shapes(self.max_prompt_len)))
        with torch.no_grad(), use_weight_casts(self._casts):
            for lb in shapes:
                self._prefill(torch.zeros((1, lb), dtype=torch.int64, device=self.device), lb)
            self._step_device()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(shapes) + 1

    # ----------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        out = dict(self._stats)
        out.update(self.pool.stats())
        out["slots"] = self.slots
        out["slots_active"] = self.active_count()
        out["slot_occupancy"] = self.active_count() / self.slots
        return out
