"""The port's paged KV decode (``moolib_tpu_torch/ops/paged_attention.py``)
and continuous-batching engine (``moolib_tpu_torch/engine/``) against the
JAX package's, on the same numpy inputs and on weights converted from the
flax init.

The mirror of ``tests/test_paged_attention.py``: paged decode is bit-exact
against the port's own dense decode (both call ``gathered_decode_attention``),
the block pool keeps its free-list invariants, and the engine's replies
equal ``generate()`` token for token.  On top of that: the paged write and
gather equal the JAX functions bitwise and the attention to f32 rounding
(1e-6), both packages' ``BlockPool``s hand out the same ids under one schedule, the port engine
answers exactly as the JAX engine does, and its KV pools never move.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moolib_tpu.engine import BlockPool as JaxBlockPool
from moolib_tpu.models.transformer import TransformerLM as JaxLM
from moolib_tpu.ops import paged_attention as jpa
from moolib_tpu_torch.engine import BlockPool, PoolExhausted
from moolib_tpu_torch.models.convert import from_flax
from moolib_tpu_torch.models.transformer import TransformerLM
from moolib_tpu_torch.ops import paged_attention as pa
from moolib_tpu_torch.ops.paged_attention import PagedState
from moolib_tpu_torch.serving import AdmissionController

torch.set_num_threads(1)


def make_pair(vocab=64, d_model=32, heads=4, kv_heads=2, layers=2, max_len=64,
              pos="rotary", seed=0):
    """The flax LM, its params (numpy), and the port's LM with those weights."""
    kw = dict(vocab_size=vocab, d_model=d_model, num_heads=heads, num_kv_heads=kv_heads,
              num_layers=layers, max_len=max_len, attention="dense", pos_embedding=pos)
    jmodel = JaxLM(dtype=jnp.float32, **kw)
    params = jax.device_get(jmodel.init(jax.random.key(seed), jnp.zeros((1, 4), jnp.int32)))
    model = TransformerLM(dtype=torch.float32, device="cpu", **kw)
    model.load_state_dict(from_flax(params))
    return jmodel, params, model


# ------------------------------------------------------------ bit-exactness
@pytest.mark.parametrize(
    "kv_heads,block_size,pos",
    [
        (4, 4, "rotary"),    # MHA, tiny blocks (many blocks per sequence)
        (4, 16, "rotary"),   # MHA, one block = max_len (degenerate paging)
        (2, 4, "rotary"),    # GQA
        (2, 8, "rotary"),    # GQA, mid-size blocks
        (2, 4, "learned"),   # GQA + learned positions (per-slot offsets)
    ],
)
def test_paged_decode_bit_exact_vs_dense(kv_heads, block_size, pos):
    """Step-by-step decode through a SHUFFLED block table gives logits
    bitwise equal to the dense per-sequence cache path."""
    S, M, V = 3, 16, 50
    nb_per = M // block_size
    num_blocks = 1 + S * nb_per
    _, _, model = make_pair(vocab=V, kv_heads=kv_heads, max_len=M, pos=pos)
    Hk, hd = kv_heads, 32 // 4
    cache_k = torch.zeros(2, S, M, Hk, hd)
    cache_v = torch.zeros_like(cache_k)
    pools_k = [torch.zeros(num_blocks, block_size, Hk, hd) for _ in range(2)]
    pools_v = [torch.zeros_like(p) for p in pools_k]
    ids = np.arange(1, num_blocks)
    np.random.default_rng(0).shuffle(ids)
    tables = torch.from_numpy(ids.reshape(S, nb_per))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, V, size=(S, 10)))
    active = torch.ones(S, dtype=torch.bool)
    with torch.no_grad():
        for s in range(10):
            t = toks[:, s:s + 1]
            ld = model.decode_step(t, cache_k, cache_v, s)
            lp = model.decode_step_paged(
                t, pools_k, pools_v, PagedState(tables, torch.full((S,), s), active))
            assert torch.equal(ld, lp), f"step {s}: max |diff| = {(ld - lp).abs().max()}"


def test_paged_decode_inactive_slots_write_null_block():
    """Inactive slots write into the reserved null block (id 0): their
    presence does not perturb active slots' logits, and no real block is
    written by an inactive lane."""
    S, M, V, bs = 4, 16, 50, 4
    num_blocks = 1 + S * (M // bs)
    _, _, model = make_pair(vocab=V, max_len=M)
    pools_k = [torch.zeros(num_blocks, bs, 2, 8) for _ in range(2)]
    pools_v = [torch.zeros_like(p) for p in pools_k]
    tables = torch.arange(1, num_blocks).reshape(S, M // bs)
    active = torch.tensor([True, False, True, False])
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, V, (S, 1)))
    lengths = torch.zeros(S, dtype=torch.int64)
    with torch.no_grad():
        out = model.decode_step_paged(toks, pools_k, pools_v,
                                      PagedState(tables, lengths, active))
        alone = model.decode_step_paged(
            toks[[0, 2]], [torch.zeros_like(p) for p in pools_k],
            [torch.zeros_like(p) for p in pools_v],
            PagedState(tables[[0, 2]], lengths[[0, 2]], active[[0, 2]]))
    assert torch.equal(out[[0, 2]], alone)
    for pool in pools_k + pools_v:
        for slot in (1, 3):
            for blk in tables[slot].tolist():
                assert not pool[blk].any(), (slot, blk)
        assert pool[0].any()  # the inactive lanes wrote the null block


ATT_TOL = {"float32": 1e-6, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_ops_match_jax(dtype):
    """paged_kv_write, paged_gather and paged_attention against the JAX
    functions on the same pools, tables, lengths and activity (inactive
    slots, one of them one past its table): the write and the gather are
    copies, bitwise equal in either dtype; the attention agrees to the
    rounding of its dtype."""
    S, nb, bs, Hk, hd, H = 4, 3, 4, 2, 8, 4
    num_blocks = 1 + S * nb
    rng = np.random.default_rng(5)
    pool = rng.standard_normal((num_blocks, bs, Hk, hd)).astype(np.float32)
    x = rng.standard_normal((S, Hk, hd)).astype(np.float32)
    q = rng.standard_normal((S, 1, H, hd)).astype(np.float32)
    ids = np.arange(1, num_blocks)
    rng.shuffle(ids)
    tables = ids.reshape(S, nb).astype(np.int32)
    lengths = np.array([0, 5, 11, 12], np.int32)
    active = np.array([True, True, True, False])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    want = jpa.paged_kv_write(jnp.asarray(pool, jdt), jnp.asarray(x, jdt), jnp.asarray(tables),
                              jnp.asarray(lengths), jnp.asarray(active))
    tpool = torch.from_numpy(pool).to(tdt)
    ptr = tpool.data_ptr()
    got = pa.paged_kv_write(tpool, torch.from_numpy(x).to(tdt), torch.from_numpy(tables),
                            torch.from_numpy(lengths), torch.from_numpy(active))
    assert got.data_ptr() == ptr  # in place
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))

    gw = jpa.paged_gather(want, jnp.asarray(tables))
    gg = pa.paged_gather(got, torch.from_numpy(tables))
    np.testing.assert_array_equal(gg.float().numpy(), np.asarray(gw, np.float32))

    aw = np.asarray(jpa.paged_attention(jnp.asarray(q, jdt), want, want, jnp.asarray(tables),
                                        jnp.asarray(lengths)), np.float32)
    ag = pa.paged_attention(torch.from_numpy(q).to(tdt), got, got, torch.from_numpy(tables),
                            torch.from_numpy(lengths)).float().numpy()
    # XLA's and torch's einsums sum in their own orders: f32 rounding apart.
    np.testing.assert_allclose(ag, aw, rtol=0, atol=ATT_TOL[dtype])


# ----------------------------------------------------------------- BlockPool
def test_block_pool_invariants_random_schedule():
    pool = BlockPool(num_blocks=33, block_size=4)
    rng = np.random.default_rng(42)
    held = []
    for _ in range(300):
        if held and rng.random() < 0.45:
            pool.free(held.pop(rng.integers(len(held))))
        else:
            want = int(rng.integers(1, 5))
            if pool.available() < want:
                with pytest.raises(PoolExhausted):
                    pool.alloc(pool.available() + 1)
            else:
                blocks = pool.alloc(want)
                assert 0 not in blocks  # null block never escapes
                held.append(blocks)
        pool.check_invariants()
    for b in held:
        pool.free(b)
    pool.check_invariants()
    assert pool.available() == 32
    assert pool.stats()["utilization"] == 0.0


def test_block_pool_free_lists_match_jax():
    """One seeded alloc/free schedule through both packages' pools: the same
    ids at every alloc, the same free list and stats at every point."""
    ours, theirs = BlockPool(num_blocks=41, block_size=8), JaxBlockPool(41, 8)
    rng = np.random.default_rng(7)
    held = []
    for _ in range(400):
        if held and rng.random() < 0.45:
            blocks = held.pop(rng.integers(len(held)))
            ours.free(blocks)
            theirs.free(blocks)
        else:
            want = int(rng.integers(1, 6))
            if ours.available() < want:
                for pool in (ours, theirs):
                    with pytest.raises(RuntimeError):
                        pool.alloc(want)
            else:
                got = ours.alloc(want)
                assert got == theirs.alloc(want)
                held.append(got)
        assert ours._free == theirs._free and ours.stats() == theirs.stats()
    assert ours.blocks_for(17) == theirs.blocks_for(17) == 3


def test_block_pool_failed_alloc_is_atomic_and_double_free_raises():
    pool = BlockPool(num_blocks=5, block_size=4)  # 4 usable
    a = pool.alloc(3)
    before = pool.available()
    with pytest.raises(PoolExhausted):
        pool.alloc(2)  # only 1 free: must not half-allocate
    assert pool.available() == before
    pool.free(a)
    with pytest.raises(ValueError):
        pool.free(a)  # double free
    with pytest.raises(ValueError):
        pool.free([0])  # the null block is never owned by anyone
    pool.check_invariants()


def test_block_pool_blocks_for():
    pool = BlockPool(num_blocks=9, block_size=4)
    assert [pool.blocks_for(n) for n in (0, 1, 4, 5, 8, 9)] == [1, 1, 1, 2, 2, 3]


# --------------------------------------------- per-token admission control
def test_admission_controller_per_token_mode():
    pending = {"tokens": 0}
    ac = AdmissionController(max_queue=8, per_token=True,
                             pending_tokens=lambda: pending["tokens"])
    assert ac.admit(0, deadline_s=0.001) is None  # no EMA yet
    ac.note_service(0.5, tokens=5)  # 0.1 s/token
    assert ac.ema_batch_seconds() == pytest.approx(0.1)
    pending["tokens"] = 100
    assert ac.estimate_wait(3) == pytest.approx(10.0)  # depth is irrelevant
    assert ac.admit(3, deadline_s=5.0) == "deadline"
    assert ac.admit(3, deadline_s=20.0) is None
    ac.note_service(0.0, tokens=0)  # zero-token step never poisons the EMA
    assert ac.ema_batch_seconds() == pytest.approx(0.1)
    assert ac.admit(8, deadline_s=None) == "queue_full"


