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

Greedy decoding only, as the serving plane is.

Disaggregated prefill: ``mesh=`` (a ``DeviceMesh`` over ranks, one process
each) and ``prefill_devices=N`` together split the mesh
(``parallel.split_mesh``), as in the JAX engine: the first N ranks prefill,
the rest decode; either alone shards nothing.  Every rank constructs the
engine.  The first decode rank owns it: the slot bookkeeping, the KV pools
and every decode step stay in that process, so only prefill crosses
processes.  Each request's prompt goes to a prefill rank (round-robin over
N: JAX replicates prefill over its submesh, one process per rank would only
repeat it), which runs ``prefill`` on the flash kernel and answers with the
first token and, when the request needs a slot, its K/V rows ``[L, 2, Lb,
Hk, hd]`` through ``parallel.collectives.Handoff`` (counted on the owner:
``batcher_d2d_bytes_total`` card to card, ``batcher_staged_bytes_total``
through host memory).  The other ranks call :meth:`follow` and serve
prefill commands (the other decode ranks none: JAX replicates decode over
its submesh, which one process per rank would only repeat) until the
owner's :meth:`close`.  ``set_params`` installs the weights on both halves.
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
_M_KV_HANDOFF = _REG.histogram(
    "serve_engine_kv_handoff_seconds",
    "split engine: host wall time the owner waits for a request's K/V rows "
    "after its first token arrived (the prefill-to-decode crossing)",
)


class NoFreeSlot(RuntimeError):
    """Every decode slot is occupied — the request should stay queued."""


class _PrefillSplit:
    """The ranks of a disaggregated engine (see the module docstring) and
    its two channels: commands, tokens, first tokens and weights on a gloo
    control channel, the K/V rows on the data handoff (the plane's route).
    Every rank of ``mesh`` constructs it, collectively."""

    PREFILL, PARAMS, STOP = 1, 2, 3
    COMMAND, TOKENS, TOKEN0, WEIGHTS, KV = 1, 2, 3, 4, 5

    def __init__(self, model, mesh, prefill_devices: int):
        import torch.distributed as dist

        from ..parallel.collectives import Handoff
        from ..parallel.mesh import check_disjoint, mesh_ranks, split_mesh

        pmesh, dmesh = split_mesh(mesh, prefill_devices)
        if isinstance(mesh, dict):
            raise TypeError("disaggregated prefill needs a DeviceMesh over the serving "
                            "ranks (one process each), not axis sizes")
        check_disjoint(dmesh, pmesh, what_a="decode mesh", what_b="--prefill_devices")
        self.model = model
        self.prefill_ranks = mesh_ranks(pmesh)
        self.decode_ranks = mesh_ranks(dmesh)
        self.owner = dist.get_rank() == self.decode_ranks[0]
        self.rank = dist.get_rank()
        self.prefill = self.rank in self.prefill_ranks
        self.control = Handoff(model.device, backend="gloo", counted=False)
        self.data = Handoff(model.device)
        self._turn = 0
        self._specs = [(tuple(t.shape), t.dtype) for t in model.state_dict().values()]

    @property
    def owner_rank(self) -> int:
        return self.decode_ranks[0]

    def next_rank(self) -> int:
        r = self.prefill_ranks[self._turn % len(self.prefill_ranks)]
        self._turn += 1
        return r

    def _send_command(self, r: int, cmd: int, *args: int) -> None:
        args = (list(args) + [0, 0, 0])[:3]
        self.control.send([torch.tensor([cmd, *args], dtype=torch.int64)], r, self.COMMAND)

    def call(self, r: int, cmd: int, tp: int, lb: int, want_kv: int, toks) -> int:
        """Owner: one prefill on rank ``r``; returns its first token."""
        self._send_command(r, cmd, tp, lb, want_kv)
        self.control.send([toks], r, self.TOKENS)
        return int(self.control.recv([((1,), torch.int64)], r, self.TOKEN0, on_host=True)[0])

    def command(self) -> list:
        got = self.control.recv([((4,), torch.int64)], self.owner_rank, self.COMMAND,
                                on_host=True)[0]
        return got.tolist()  # mtlint: allow-host-sync(a host tensor: the command landed in host memory)

    def send_params(self) -> None:
        leaves = [t.detach() for t in self.model.state_dict().values()]
        for r in self.prefill_ranks:
            self._send_command(r, self.PARAMS)
            self.control.send(leaves, r, self.WEIGHTS)

    def recv_params(self) -> None:
        got = self.control.recv(self._specs, self.owner_rank, self.WEIGHTS)
        with torch.no_grad():
            for t, x in zip(self.model.state_dict().values(), got):
                t.copy_(x)

    def stop(self) -> None:
        for r in self.prefill_ranks + self.decode_ranks[1:]:
            self._send_command(r, self.STOP)
        self.close()

    def close(self) -> None:
        self.control.close()
        self.data.close()


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
        self._split = None
        if mesh is not None and prefill_devices:
            # The JAX engine shards nothing but this split: a mesh alone, or
            # prefill_devices alone, is accepted and unused there too.
            self._split = _PrefillSplit(model, mesh, prefill_devices)
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
            self._load(params)  # every rank loads its own: nothing crosses
        self._casts = weight_casts(model)
        self._stats = {
            "joins": 0, "retires": 0, "decode_tokens": 0,
            "prefill_tokens": 0, "prefill_pad_tokens": 0, "steps": 0,
        }
        if self._split is not None:
            self._stats.update(kv_handoff_bytes=0, remote_prefills=0)
            if not self._split.owner:
                return  # a prefill (or idle decode) rank: no pools, no slots

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

    def _load(self, params) -> None:
        with torch.no_grad():
            self.model.load_state_dict(as_state_dict(params))

    def set_params(self, params) -> None:
        """Load new weights into the model in place: a flax-layout tree of
        numpy leaves (what ``ModelPublisher`` carries) or a ``state_dict``.
        Called between iterations by the service's hot-swap hook — the KV
        pools and slot state are untouched, so in-flight sequences continue
        under the new weights.  The layers' ``dtype`` casts are taken once
        here, for every step of this version.  Split, the owner sends the
        weights to every prefill rank too."""
        self._load(params)
        self._casts = weight_casts(self.model)
        if self._split is not None:
            self._split.send_params()

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

    def _remote_prefill(self, toks: np.ndarray, tp: int, want_kv: bool,
                        rank: Optional[int] = None, warm: bool = False) -> Tuple[list, int]:
        """:meth:`_prefill` on a prefill rank (the next in turn, or
        ``rank``): the first token comes back, and the K/V rows too when
        ``want_kv`` and the token does not end the request."""
        sp = self._split
        r = sp.next_rank() if rank is None else rank
        lb = toks.shape[1]
        tok0 = sp.call(r, sp.PREFILL, tp, lb, int(want_kv), torch.from_numpy(toks))
        kvs = None
        if want_kv and not (self.eos_id is not None and tok0 == self.eos_id):
            spec = [((self._L, 2, lb, self._Hk, self._hd), self.model.dtype)]
            if warm:
                kv = sp.data.recv(spec, r, sp.KV)[0]
            else:
                with _M_KV_HANDOFF.time():
                    kv = sp.data.recv(spec, r, sp.KV)[0]
                self._stats["kv_handoff_bytes"] += kv.numel() * kv.element_size()
            kvs = [(kv[i, 0][None], kv[i, 1][None]) for i in range(self._L)]
        if not warm:
            self._stats["remote_prefills"] += 1
        return kvs, tok0

    def follow(self) -> Dict[str, Any]:
        """A rank other than the owner of a split engine: serve the owner's
        prefill commands (and weights) until it closes.  Returns this rank's
        counts."""
        sp = self._split
        prefills = 0
        while True:
            cmd, tp, lb, want_kv = sp.command()
            if cmd == sp.STOP:
                break
            if cmd == sp.PARAMS:
                sp.recv_params()
                self._casts = weight_casts(self.model)
                continue
            toks = sp.control.recv([((1, lb), torch.int64)], sp.owner_rank, sp.TOKENS)[0]
            with torch.no_grad(), use_weight_casts(self._casts):
                kvs, tok0 = self._prefill(toks.to(self.device), tp)
                sp.control.send([torch.tensor([tok0], dtype=torch.int64)], sp.owner_rank, sp.TOKEN0)
                if want_kv and not (self.eos_id is not None and tok0 == self.eos_id):
                    sp.data.send([torch.stack([torch.stack((k[0], v[0])) for k, v in kvs])],
                                 sp.owner_rank, sp.KV)
            prefills += 1
        sp.close()
        return {"rank": sp.rank, "role": "prefill" if sp.prefill else "decode",
                "prefills": prefills}

    def close(self) -> None:
        """The owner of a split engine: release the other ranks (each
        leaves :meth:`follow`).  A no-op otherwise."""
        if self._split is not None and self._split.owner:
            self._split.stop()

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
            if self._split is not None:
                kvs, tok0 = self._remote_prefill(toks, tp, max_new > 1)
            else:
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
        inactive) slots, whose writes land in the null block.  Split, each
        prefill rank runs every bucket and the K/V cross once per block
        count, as in the JAX engine.  Returns the number of distinct shapes
        run."""
        shapes = sorted(set(bucket_shapes(self.max_prompt_len)))
        crossed = set()  # block counts whose K/V have crossed
        with torch.no_grad(), use_weight_casts(self._casts):
            for lb in shapes:
                toks = np.zeros((1, lb), np.int64)
                if self._split is None:
                    self._prefill(torch.from_numpy(toks).to(self.device), lb)
                    continue
                nbw = -(-lb // self.block_size)
                for r in self._split.prefill_ranks:
                    self._remote_prefill(toks, lb, nbw not in crossed, rank=r, warm=True)
                    crossed.add(nbw)
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
