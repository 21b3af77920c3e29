"""The port's continuous-batching engine (``moolib_tpu_torch/engine/``)
against the JAX package's engine and ``generate()``, on weights converted
from the flax init; with ``tests/test_torch_paged_attention.py`` the mirror
of ``tests/test_paged_attention.py``.

The engine's replies equal the JAX engine's and JAX ``generate()``'s token
for token (f32, GQA, mixed prompt lengths and budgets, budget-1 requests
that finish at prefill, an EOS case), its KV pools never move, and the
``EngineService`` round trip and a hot swap between decode steps hold over
loopback Rpc.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moolib_tpu.engine import ContinuousBatchingEngine as JaxEngine
from moolib_tpu.models.transformer import TransformerLM as JaxLM
from moolib_tpu.models.transformer import generate as jax_generate
from moolib_tpu_torch.engine import (ContinuousBatchingEngine, EngineService, NoFreeSlot,
                                     PoolExhausted)
from moolib_tpu_torch.models.convert import from_flax
from moolib_tpu_torch.models.transformer import TransformerLM
from moolib_tpu_torch.rpc import Rpc, RpcError
from moolib_tpu_torch.serving import ServeClient

torch.set_num_threads(1)


LM = dict(vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2, num_layers=2,
          max_len=64, attention="dense", pos_embedding="rotary")
# Two prompt lengths (buckets 4 and 16), budgets from 1 to 12, a budget-1
# request that finishes at prefill: the schedule the engine and the service
# are held to.
_rng = np.random.default_rng(3)
REQS = [(_rng.integers(1, 64, size=n).astype(np.int32), mn)
        for n, mn in ((3, 1), (11, 3), (11, 8), (3, 5), (3, 12), (11, 2))]


@pytest.fixture(scope="module")
def lm():
    """The flax LM (GQA, rotary) and its params as numpy."""
    jmodel = JaxLM(dtype=jnp.float32, **LM)
    return jmodel, jax.device_get(jmodel.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))


@pytest.fixture(scope="module")
def refs(lm):
    """JAX generate()'s replies to REQS."""
    return jax_refs(*lm, REQS)


def port_model(params, **kw):
    """The port's LM with the flax weights (its own copy: tests swap them)."""
    model = TransformerLM(dtype=torch.float32, device="cpu", **{**LM, **kw})
    model.load_state_dict(from_flax(params))
    return model


def jax_refs(jmodel, params, reqs):
    """JAX generate()'s reply to each (prompt, budget): one batched call per
    prompt length at the group's largest budget, cut to each budget (greedy
    rows are independent, and a shorter budget is a prefix)."""
    out = [None] * len(reqs)
    for n in sorted({len(p) for p, _ in reqs}):
        idx = [i for i, (p, _) in enumerate(reqs) if len(p) == n]
        batch = np.stack([reqs[i][0] for i in idx])
        mn = max(reqs[i][1] for i in idx)
        rows = np.asarray(jax_generate(jmodel, params, jnp.asarray(batch), mn))
        for row, i in zip(rows, idx):
            out[i] = row[:n + reqs[i][1]]
    return out


def pool_ptrs(eng):
    return [p.data_ptr() for p in eng.pools_k + eng.pools_v]


def drive(eng, reqs, max_steps=200):
    """Serve ``reqs`` [(prompt, budget)] FIFO through submit/step/retire;
    returns (replies, decode steps)."""
    outs, slot_of = {}, {}
    pending = list(enumerate(reqs))
    steps = 0
    while len(outs) < len(reqs):
        while pending:
            i, (p, mn) = pending[0]
            if not eng.can_accept(len(p), mn):
                break
            pending.pop(0)
            slot, em = eng.submit(p, mn)
            if slot is None:  # finished at prefill (budget 1)
                outs[i] = np.concatenate([p, np.asarray(em, np.int32)])
            else:
                slot_of[slot] = (i, p)
        _, fin = eng.step()
        steps += 1
        assert steps < max_steps, "engine never drained"
        for s in fin:
            i, p = slot_of.pop(s)
            outs[i] = np.concatenate([p, np.asarray(eng.retire(s), np.int32)])
    return [outs[i] for i in range(len(reqs))], steps


# ------------------------------------------------- engine vs generate()
ENGINE = dict(slots=3, block_size=4, max_seq_len=64, max_prompt_len=16)


def test_engine_matches_jax_engine_and_generate_under_seeded_schedule(lm, refs):
    """Mixed prompt lengths and budgets (GQA, a budget-1 request that
    finishes at prefill) through slot join/retire: the port engine's replies
    equal the JAX engine's and JAX generate()'s token for token; the decode
    steps track the longest request, not the sum of budgets; the pool
    drains; and the pools never move."""
    jmodel, params = lm
    eng = ContinuousBatchingEngine(port_model(params), **ENGINE)
    ptrs = pool_ptrs(eng)
    assert eng.warmup() == 6  # buckets 1, 2, 4, 8, 16 and the decode step
    outs, steps = drive(eng, REQS)
    jouts, jsteps = drive(JaxEngine(jmodel, params, **ENGINE), REQS)
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(outs[i], jouts[i], err_msg=f"request {i}")
        np.testing.assert_array_equal(outs[i], ref, err_msg=f"request {i}")
    assert steps == jsteps < sum(mn for _, mn in REQS)
    eng.pool.check_invariants()
    assert eng.pool.available() == eng.pool.num_blocks - 1
    assert eng.active_count() == 0
    st = eng.stats()
    assert st["joins"] == st["retires"] == 5  # the budget-1 request never joined
    assert pool_ptrs(eng) == ptrs


def test_pool_data_ptrs_stable_through_churn(lm):
    """Many joins and retires, with a hot swap of the weights in between:
    the KV pools and slot-state tensors are written in place, never
    rebound or reallocated."""
    params = lm[1]
    model = port_model(params)
    eng = ContinuousBatchingEngine(model, slots=2, block_size=4, max_seq_len=32,
                                   max_prompt_len=8)
    state = [eng._tables, eng._lengths, eng._active, eng._tokens, eng._remaining]
    before = pool_ptrs(eng) + [t.data_ptr() for t in state]
    param_ptrs = [p.data_ptr() for p in model.parameters()]
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, 64, size=rng.integers(1, 9)).astype(np.int32), int(mn))
            for mn in rng.integers(1, 20, size=12)]
    drive(eng, reqs[:6])
    eng.set_params(jax.tree.map(lambda x: x * 1.5, params))
    drive(eng, reqs[6:])
    after = pool_ptrs(eng) + [t.data_ptr() for t in state]
    assert after == before
    assert [p.data_ptr() for p in model.parameters()] == param_ptrs
    assert eng.stats()["joins"] == eng.stats()["retires"]


def test_engine_rejects_oversized_and_reports_capacity():
    model = TransformerLM(vocab_size=32, d_model=32, num_heads=2, num_layers=1, max_len=32,
                          attention="dense", dtype=torch.float32, pos_embedding="rotary",
                          device="cpu")
    eng = ContinuousBatchingEngine(model, slots=2, block_size=4, max_seq_len=16,
                                   max_prompt_len=8, num_blocks=3)  # null + 2 usable
    with pytest.raises(ValueError):
        eng.submit(np.ones(9, np.int32), 2)  # prompt > max_prompt_len
    with pytest.raises(ValueError):
        eng.submit(np.ones(8, np.int32), 9)  # prompt + budget > capacity
    with pytest.raises(ValueError):
        eng.submit(np.zeros(0, np.int32), 2)  # empty prompt
    # Out of the vocabulary: refused on the host, before any device work.
    with pytest.raises(ValueError, match=r"must lie in \[0, 32\)"):
        eng.submit(np.array([1, 32], np.int32), 2)
    with pytest.raises(ValueError, match=r"must lie in \[0, 32\)"):
        eng.submit(np.array([-1, 3], np.int32), 2)
    assert eng.can_accept(4, 2)       # 6 tokens -> 2 blocks: fits
    assert not eng.can_accept(4, 8)   # 12 tokens -> 3 blocks: pool-bound
    assert eng.active_count() == 0 and eng.stats()["prefill_tokens"] == 0
    # The JAX engine's rule: a mesh, or prefill_devices, alone shards
    # nothing; the two together split the mesh, and JAX's split refuses a
    # prefill count that leaves no decode device.
    with pytest.raises(ValueError, match="actor_devices must be in"):
        ContinuousBatchingEngine(model, mesh={"tp": 2}, prefill_devices=2)
    assert ContinuousBatchingEngine(model, slots=2, block_size=4, max_seq_len=16,
                                    mesh={"tp": 2}).slots == 2


def test_full_engine_refuses_before_prefill():
    """A request that needs a slot or blocks the engine lacks is refused
    before its prefill runs, so a caller that keeps it queued prefills it
    once; a budget-1 request needs neither and is answered at prefill."""
    model = TransformerLM(vocab_size=32, d_model=32, num_heads=2, num_layers=1, max_len=32,
                          attention="dense", dtype=torch.float32, pos_embedding="rotary",
                          device="cpu")
    eng = ContinuousBatchingEngine(model, slots=2, block_size=4, max_seq_len=16,
                                   max_prompt_len=8, num_blocks=4)  # null + 3 usable
    prompt = np.arange(1, 5, dtype=np.int32)
    assert eng.submit(prompt, 4)[0] is not None            # 8 tokens -> 2 blocks
    before = eng.stats()["prefill_tokens"]
    with pytest.raises(PoolExhausted, match="need 2 blocks, 1 free"):
        eng.submit(prompt, 4)
    assert eng.stats()["prefill_tokens"] == before
    assert eng.submit(prompt[:2], 2)[0] is not None        # 4 tokens -> 1 block
    with pytest.raises(NoFreeSlot):
        eng.submit(prompt[:2], 2)
    assert eng.stats()["prefill_tokens"] == before + 2
    slot, em = eng.submit(prompt, 1)
    assert slot is None and len(em) == 1
    eng.pool.check_invariants()


def test_engine_eos_retires_early(lm, refs):
    """A sequence that argmax-emits the EOS id retires before its budget,
    exactly where the JAX engine retires it."""
    jmodel, params = lm
    prompt, budget = REQS[4]
    eos = int(refs[4][len(prompt) + 2])  # the third token generate() emits
    kw = dict(slots=2, block_size=4, max_seq_len=16, max_prompt_len=8, eos_id=eos)
    ems = []
    for eng in (ContinuousBatchingEngine(port_model(params), **kw),
                JaxEngine(jmodel, params, **kw)):
        slot, em = eng.submit(prompt, budget)
        if slot is not None:
            for _ in range(20):
                _, fin = eng.step()
                if fin:
                    em = eng.retire(fin[0])
                    break
        ems.append(list(em))
    assert ems[0] == ems[1]
    assert ems[0][-1] == eos and len(ems[0]) <= 3  # retired at EOS, not at its budget


# --------------------------------------------------- EngineService over RPC
def _addr_of(rpc: Rpc) -> str:
    return next(a for a in rpc._listen_addrs if a.startswith("tcp://127")).replace("tcp://", "")


class EngineHarness:
    """EngineService fronting a real ContinuousBatchingEngine on loopback,
    its loop on a daemon thread (all the engine's torch work runs there)."""

    def __init__(self, params):
        self.engine = ContinuousBatchingEngine(port_model(params), **ENGINE)
        self.rpc = Rpc()
        self.rpc.set_name("server")
        self.rpc.listen("127.0.0.1:0")
        self.service = EngineService(self.rpc, self.engine, default_max_new=4)
        self.addr = _addr_of(self.rpc)
        self._thread = None

    def start(self, total=None):
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self.service.loop(total=total)), daemon=True)
        self._thread.start()
        return self

    def close(self):
        self.service.close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            assert not self._thread.is_alive()
        self.rpc.close()


def test_engine_service_roundtrip_mixed_budgets(lm, refs):
    """Concurrent requests with DIFFERENT budgets through the full RPC stack
    each match JAX ``generate()`` — including a budget-1 prefill-finish and
    the server's default budget (4) for a request that names none."""
    h = EngineHarness(lm[1])
    client = Rpc()
    client.set_name("cli")
    client.connect(h.addr)
    try:
        h.start()
        cl = ServeClient(client, fn="generate", replicas=["server"], deadline_s=60.0)
        futs = [cl.submit(p, mn) for p, mn in REQS]
        default = cl.submit(REQS[4][0])
        outs = [np.asarray(f.result(60.0)) for f in futs]
        for i, (out, ref) in enumerate(zip(outs, refs)):
            assert out.dtype == np.int32
            np.testing.assert_array_equal(out, ref, err_msg=f"request {i}")
        np.testing.assert_array_equal(np.asarray(default.result(60.0)),
                                      refs[4][:len(REQS[4][0]) + 4])
        st = h.service.stats()
        assert st["served"] == 7
        assert st["engine"]["retires"] == st["engine"]["joins"]
        assert st["ema_token_seconds"] is not None  # per-token EMA primed
        cl.close()
    finally:
        client.close()
        h.close()


def test_engine_service_hot_swap_between_decode_steps(lm):
    """A weight swap staged mid-decode installs between steps with zero
    errors: every in-flight future completes, the version bumps, and the
    engine then answers under the new weights — a flax-layout numpy tree,
    as a JAX or port ModelPublisher carries it."""
    jmodel, params = lm
    h = EngineHarness(params)
    params2 = jax.tree.map(lambda x: x * 1.5, params)
    client = Rpc()
    client.set_name("cli")
    client.connect(h.addr)
    try:
        h.start()
        cl = ServeClient(client, fn="generate", replicas=["server"], deadline_s=60.0)
        rng = np.random.default_rng(9)
        futs = [cl.submit(rng.integers(1, 64, size=6).astype(np.int32), 12)
                for _ in range(4)]
        time.sleep(0.05)
        assert h.service.stage(5, params2, time.monotonic())
        for f in futs:
            np.asarray(f.result(60.0))  # zero errors across the swap
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and h.service.model_version() != 5:
            time.sleep(0.02)
        assert h.service.model_version() == 5
        assert h.service.stats()["hot_swaps"] == 1
        prompt = rng.integers(1, 64, size=6).astype(np.int32)
        np.testing.assert_array_equal(np.asarray(cl.call(prompt, 5)),
                                      jax_refs(jmodel, params2, [(prompt, 5)])[0])
        cl.close()
    finally:
        client.close()
        h.close()


def test_engine_service_fails_a_poisoned_request_alone(lm, refs):
    """A prompt with a token outside the vocabulary is refused on the host
    (on the card it would be a device-side assert poisoning every later
    request): its caller alone gets the error, the others their replies."""
    h = EngineHarness(lm[1])
    client = Rpc()
    client.set_name("cli")
    client.connect(h.addr)
    try:
        bad = np.array([1, 2, 64], np.int32)
        futs = [client.async_("server", "generate", p, mn) for p, mn in REQS[:2]]
        f_bad = client.async_("server", "generate", bad, 3)
        h.start()
        with pytest.raises(RpcError, match=r"generate failed: prompt tokens must lie in \[0, 64\)"):
            f_bad.result(60.0)
        for f, ref in zip(futs, refs[:2]):
            np.testing.assert_array_equal(np.asarray(f.result(60.0)), ref)
        assert h.service.stats()["engine"]["joins"] == 1  # REQS[0] finished at prefill
    finally:
        client.close()
        h.close()
