"""The PyTorch port's CUDA kernels, and the RL plane's card paths, on the
card.

These tests need a CUDA card and skip without one.  They import neither jax
nor the JAX package, so on the machine with the card they run without the
repo's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from moolib_tpu_torch.batcher import Batcher
from moolib_tpu_torch.envpool import EnvPool
from moolib_tpu_torch.envs import CatchEnv
from moolib_tpu_torch.models.impala import ImpalaNet
from moolib_tpu_torch.models.transformer import TransformerLM, generate
from moolib_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}  # (out, lse) atol


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,D", [(1, 64), (77, 128), (200, 64), (513, 128)])
def test_flash_kernel_matches_plain_version(card, T, D, causal, dtype):
    g = torch.Generator(device=card).manual_seed(T * D + causal)
    q, k, v = (torch.randn(2, T, 3, D, generator=g, device=card).to(dtype) for _ in range(3))
    before = fa.flash_fwd_launches()
    out, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_fwd_launches() == before + 1
    p_out, p_lse = fa._blockwise_attention_plain(q.float(), k.float(), v.float(), causal)
    tol_out, tol_lse = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (2, T, 3)
    assert (out.float() - p_out).abs().max().item() <= tol_out
    assert (lse - p_lse).abs().max().item() <= tol_lse


def test_flash_kernel_takes_strided_views(card):
    qkv = torch.randn(1, 130, 6, 64, device=card)
    q, k, v = qkv[:, :, :2], qkv[:, :, 2:4], qkv[:, :, 4:]
    out = fa.flash_attention(q, k, v)
    want, _ = fa._blockwise_attention_plain(q, k, v, True)
    assert (out - want).abs().max().item() <= 1e-4


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # x max(1, max|ref|)


def _backward_case(card, B, T, H, D, causal, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, device=card).to(dtype)
                   for _ in range(4))
    g_lse = torch.randn(B, T, H, generator=g, device=card)
    out, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
    return q, k, v, out, lse, do, g_lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", [1, 77, 200, 513])
def test_flash_backward_kernels_match_plain_version(card, T, D, causal, dtype):
    q, k, v, out, lse, do, g_lse = _backward_case(card, 2, T, 3, D, causal, dtype, T + D)
    fa.reset_launches()
    got = fa._flash_bwd_cuda(q, k, v, out, lse, do, g_lse, causal)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq_launches(), fa.flash_bwd_dkv_launches()) == (1, 1)
    want = fa._flash_backward_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                    do.float(), g_lse, causal)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == b.shape
        err = (a.float() - b).abs().max().item()
        assert err <= BWD_TOL[dtype] * max(1.0, b.abs().max().item()), (name, err)


# The bfloat16 tensor-core kernels' tiles: the forward takes 128 query rows
# against 128-key K/V tiles, the dq pass 64 query rows against 64-key
# tiles, the dk/dv pass 64 keys against 64-query tiles.  T = 1 and each
# tile size - 1, + 0, + 1.
EDGE_T = [1, 63, 64, 65, 127, 128, 129]


def _check_forward(card, B, Tq, Tk, H, D, causal, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, Tq, H, D, generator=g, device=card).to(dtype)
    k, v = (torch.randn(B, Tk, H, D, generator=g, device=card).to(dtype) for _ in range(2))
    out, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
    p_out, p_lse = fa._blockwise_attention_plain(q.float(), k.float(), v.float(), causal)
    tol_out, tol_lse = TOL[dtype]
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == (B, Tq, H)
    assert (out.float() - p_out).abs().max().item() <= tol_out
    assert (lse - p_lse).abs().max().item() <= tol_lse


def _check_backward(card, B, Tq, Tk, H, D, causal, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q, do = (torch.randn(B, Tq, H, D, generator=g, device=card).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, Tk, H, D, generator=g, device=card).to(dtype) for _ in range(2))
    g_lse = torch.randn(B, Tq, H, generator=g, device=card)
    out, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
    got = fa._flash_bwd_cuda(q, k, v, out, lse, do, g_lse, causal)
    want = fa._flash_backward_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                    do.float(), g_lse, causal)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == b.shape
        err = (a.float() - b).abs().max().item()
        assert err <= BWD_TOL[dtype] * max(1.0, b.abs().max().item()), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", EDGE_T)
def test_flash_forward_at_tile_edges(card, T, D, causal, dtype):
    _check_forward(card, 2, T, T, 3, D, causal, dtype, 11 * T + D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", EDGE_T)
def test_flash_backward_at_tile_edges(card, T, D, causal, dtype):
    _check_backward(card, 2, T, T, 3, D, causal, dtype, 13 * T + D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Tq,Tk", [(130, 257), (257, 130)])
def test_flash_kernels_with_other_key_length(card, Tq, Tk, causal, dtype):
    _check_forward(card, 2, Tq, Tk, 3, 128, causal, dtype, Tq + Tk)
    _check_backward(card, 2, Tq, Tk, 3, 128, causal, dtype, Tq + Tk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_long_sequence(card, dtype):
    _check_forward(card, 1, 4096, 4096, 2, 128, True, dtype, 4096)
    _check_backward(card, 1, 4096, 4096, 2, 128, True, dtype, 4097)


def test_flash_dq_kernel_stops_early_on_ragged_tiles(card):
    # Causal with Tq = 65 < Tk = 1000: the dq sweep stops after 2 of 16 key
    # tiles, the second query tile holds one row and the last key tile 40.
    _check_backward(card, 2, 65, 1000, 3, 64, True, torch.bfloat16, 65)


@pytest.mark.parametrize("pass_", ["dq", "dkv"])
def test_flash_bwd_kernel_is_bitwise_reproducible_at_training_heads(card, pass_):
    q, k, v, out, lse, do, _ = _backward_case(card, 2, 1024, 8, 128, True, torch.bfloat16, 5)
    ops = fa._bwd_operands(q, k, v, out, lse, do, None)
    run = getattr(fa, f"_flash_bwd_{pass_}_cuda")
    first, second = run(*ops, True), run(*ops, True)
    if pass_ == "dq":
        first, second = (first,), (second,)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_backward_through_autograd_launches_both_kernels(card):
    q, k, v = (torch.randn(1, 130, 2, 64, device=card, requires_grad=True) for _ in range(3))
    fa.reset_launches()
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    (out.square().sum() + lse.sum()).backward()
    assert (fa.flash_fwd_launches(), fa.flash_bwd_dq_launches(),
            fa.flash_bwd_dkv_launches()) == (1, 1, 1)
    qd, kd, vd = (x.detach().cpu().requires_grad_() for x in (q, k, v))
    o2, l2 = fa.flash_attention(qd, kd, vd, return_lse=True)  # the plain versions
    (o2.square().sum() + l2.sum()).backward()
    for a, b in zip((q, k, v), (qd, kd, vd)):
        assert (a.grad.cpu() - b.grad).abs().max().item() <= 1e-4


def test_flash_backward_is_bitwise_reproducible(card):
    case = _backward_case(card, 2, 300, 4, 128, True, torch.bfloat16, 7)
    first = fa._flash_bwd_cuda(*case, True)
    second = fa._flash_bwd_cuda(*case, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_model_gradients_match_dense_model_on_card(card):
    cfg = dict(vocab_size=128, d_model=128, num_heads=2, num_kv_heads=1, num_layers=2,
               max_len=160, dtype=torch.float32, pos_embedding="rotary", device=card)
    tokens = torch.randint(0, 128, (2, 150), generator=torch.Generator().manual_seed(2))
    tokens = tokens.to(card)
    grads = []
    for attention in ("flash", "dense"):
        m = TransformerLM(attention=attention, generator=torch.Generator().manual_seed(0), **cfg)
        logp = torch.log_softmax(m(tokens)[:, :-1], -1)
        loss = -logp.gather(-1, tokens[:, 1:, None]).mean()
        loss.backward()
        grads.append((loss.item(), {n: p.grad for n, p in m.named_parameters()}))
    (lf, gf), (ld, gd) = grads
    assert abs(lf - ld) <= 1e-5 * abs(ld)
    for name in gd:
        assert (gf[name] - gd[name]).abs().max().item() <= 1e-3 * gd[name].abs().max().item(), name


def test_flash_model_matches_dense_model_on_card(card):
    cfg = dict(vocab_size=128, d_model=128, num_heads=2, num_kv_heads=1, num_layers=2,
               max_len=160, dtype=torch.float32, pos_embedding="rotary", device=card)
    flash = TransformerLM(attention="flash", generator=torch.Generator().manual_seed(0), **cfg)
    dense = TransformerLM(attention="dense", generator=torch.Generator().manual_seed(0), **cfg)
    tokens = torch.randint(0, 128, (2, 150), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        tokens = tokens.to(card)
        assert (flash(tokens) - dense(tokens)).abs().max().item() <= 1e-3
        assert torch.equal(generate(flash, tokens[:, :100], 8), generate(dense, tokens[:, :100], 8))


def test_batcher_uploads_host_batches_to_the_card(card):
    b = Batcher(3, device="cuda")
    items = [{"x": np.full((2, 4), i, np.uint8), "r": np.float32(i)} for i in range(3)]
    for item in items:
        b.stack(item)
    out = b.get()
    assert out["x"].device.type == "cuda" and out["x"].dtype == torch.uint8
    np.testing.assert_array_equal(out["x"].cpu().numpy(), np.stack([i["x"] for i in items]))
    c = Batcher(4, device="cuda")
    c.cat(np.arange(6, dtype=np.float32))  # one batch from one item, two rows carried
    np.testing.assert_array_equal(c.get().cpu().numpy(), np.arange(4, dtype=np.float32))


def test_batcher_device_path_keeps_cuda_items_on_the_card(card):
    b = Batcher(2, device="cuda")
    b.stack(torch.ones(3, device=card))
    b.stack(torch.zeros(3, device=card))
    out = b.get()
    assert out.device.type == "cuda" and out.shape == (2, 3)


def test_envpool_takes_cuda_actions(card):
    pool = EnvPool(CatchEnv, num_processes=1, batch_size=4, num_batches=1)
    try:
        out = pool.step(0, torch.full((4,), 2, dtype=torch.int64, device=card)).result()
        assert out["state"].shape == (4, 10, 5, 1)
        np.testing.assert_array_equal(pool._act_views[0], 2)
        assert pool._stepper._pinned[0].is_pinned()
    finally:
        pool.close()


@pytest.mark.parametrize("use_lstm", [False, True])
def test_impala_on_card_matches_cpu(card, use_lstm):
    torch.backends.cudnn.allow_tf32 = False
    host = ImpalaNet(6, (84, 84, 4), use_lstm=use_lstm, dtype=torch.float32, device="cpu")
    dev = ImpalaNet(6, (84, 84, 4), use_lstm=use_lstm, dtype=torch.float32, device=card)
    dev.load_state_dict(host.state_dict())
    rng = np.random.default_rng(0)
    batch = {"state": rng.integers(0, 256, (3, 2, 84, 84, 4), dtype=np.uint8),
             "reward": rng.normal(size=(3, 2)).astype(np.float32),
             "done": rng.random((3, 2)) < 0.3,
             "prev_action": rng.integers(0, 6, (3, 2))}
    with torch.no_grad():
        want, _ = host({k: torch.from_numpy(v) for k, v in batch.items()}, host.initial_state(2))
        got, _ = dev({k: torch.from_numpy(v).to(card) for k, v in batch.items()},
                     dev.initial_state(2))
    for key in ("policy_logits", "baseline"):
        torch.testing.assert_close(got[key].cpu(), want[key], atol=1e-4, rtol=0)


def test_buckets_stage_card_leaves_through_pinned_memory(card):
    """The cohort plane's card seam: BucketLayout.fill copies CUDA leaves
    into a pinned lease with non-blocking copies and one event, stage()
    does so per leaf, and a Group round of CUDA leaves returns host arrays
    equal to the sum."""
    from moolib_tpu_torch import buckets, telemetry

    reg = telemetry.get_registry()
    g = torch.Generator(device=card).manual_seed(5)
    leaves = [torch.randn(300, 70, generator=g, device=card),
              torch.randn(1000, generator=g, device=card)]
    layout = buckets.BucketLayout([tuple(x.shape) for x in leaves], np.float32, 1 << 16)
    flat = buckets.lease(layout.total, np.float32, pinned=True)
    assert flat.base is not None and flat.base.is_pinned()
    before = reg.counter_values().get("buckets_d2h_events_total", 0.0)
    event = layout.fill(flat, leaves)
    assert isinstance(event, torch.cuda.Event)
    event.synchronize()
    assert reg.counter_values()["buckets_d2h_events_total"] == before + 1
    want = torch.cat([x.reshape(-1) for x in leaves]).cpu().numpy()
    assert flat.tobytes() == want.tobytes()
    staged, ev = buckets.stage(leaves)
    ev.synchronize()
    assert all(s.device.type == "cpu" and s.is_pinned() for s in staged)
    assert all(torch.equal(s, x.cpu()) for s, x in zip(staged, leaves))
    buckets.release(flat)


def test_group_reduces_cuda_leaves(card):
    import socket
    import time

    from moolib_tpu_torch import Broker, Group, Rpc

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = "127.0.0.1:%d" % s.getsockname()[1]
    broker = Broker()
    broker.set_name("broker")
    broker.listen(addr)
    peers = []
    try:
        for i in range(3):
            rpc = Rpc()
            rpc.set_name(f"p{i}")
            rpc.listen("127.0.0.1:0")
            rpc.connect(addr)
            grp = Group(rpc, "cuda")
            grp.set_timeout(30)
            peers.append((rpc, grp))
        groups = [grp for _, grp in peers]

        def pump(until):
            deadline = time.time() + 60
            while not until():
                assert time.time() < deadline
                broker.update()
                for grp in groups:
                    grp.update()
                time.sleep(0.002)

        pump(lambda: all(grp.active() and len(grp.members()) == 3 for grp in groups))
        vals = [{"w": torch.full((700, 900), float(i + 1), device=card),
                 "b": torch.arange(33, dtype=torch.float32, device=card)} for i in range(3)]
        for kw in ({}, dict(bucketed=True), dict(chunked=True),
                   dict(bucketed=False, chunked=False)):
            futs = [grp.all_reduce(f"x{sorted(kw.items())}", v, **kw)
                    for grp, v in zip(groups, vals)]
            pump(lambda: all(f.done() for f in futs))
            for f in futs:
                out = f.result(0)
                assert isinstance(out["w"], np.ndarray)
                assert (out["w"] == 6.0).all()
                assert (out["b"] == 3 * np.arange(33)).all()
    finally:
        for rpc, _ in peers:
            rpc.close()
        broker.close()


def _serving_lm(card, dtype=torch.float32, attention="dense", **kw):
    cfg = dict(vocab_size=64, d_model=64, num_heads=4, num_kv_heads=2, num_layers=2,
               max_len=64, pos_embedding="rotary")
    cfg.update(kw)
    return TransformerLM(attention=attention, dtype=dtype, device=card,
                         generator=torch.Generator().manual_seed(5), **cfg).eval()


@pytest.mark.parametrize("pos", ["rotary", "learned"])
def test_paged_decode_bit_exact_vs_dense_on_card(card, pos):
    """The paged decode step through a shuffled block table gives logits
    bitwise equal to the dense cache's on the card, as on the CPU."""
    from moolib_tpu_torch.ops.paged_attention import PagedState

    S, M, bs = 3, 16, 4
    model = _serving_lm(card, max_len=M, pos_embedding=pos)
    nb = 1 + S * (M // bs)
    cache_k = torch.zeros(2, S, M, 2, 16, device=card)
    cache_v = torch.zeros_like(cache_k)
    pools_k = [torch.zeros(nb, bs, 2, 16, device=card) for _ in range(2)]
    pools_v = [torch.zeros_like(p) for p in pools_k]
    ids = np.arange(1, nb)
    np.random.default_rng(0).shuffle(ids)
    tables = torch.from_numpy(ids.reshape(S, M // bs)).to(card)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (S, 10))).to(card)
    active = torch.ones(S, dtype=torch.bool, device=card)
    with torch.no_grad():
        for s in range(10):
            ld = model.decode_step(toks[:, s:s + 1], cache_k, cache_v, s)
            lp = model.decode_step_paged(toks[:, s:s + 1], pools_k, pools_v, PagedState(
                tables, torch.full((S,), s, device=card), active))
            assert torch.equal(ld, lp), s


class _DeviceAudit(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every op that takes or makes a tensor off ``device``."""

    def __init__(self, device):
        super().__init__()
        self.device_type = device.type
        self.off_card = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        tensors = [t for t in torch.utils._pytree.tree_leaves((args, kwargs, out))
                   if isinstance(t, torch.Tensor)]
        if any(t.device.type != self.device_type for t in tensors):
            self.off_card.append(str(func))
        return out


def test_engine_state_and_step_path_stay_on_the_card(card):
    """The engine's KV pools and slot state live on the card, and its decode
    step touches no CPU tensor until the one D2H of tokens and done flags;
    replies equal generate()'s."""
    from moolib_tpu_torch.engine import ContinuousBatchingEngine

    model = _serving_lm(card)
    eng = ContinuousBatchingEngine(model, slots=3, block_size=4, max_prompt_len=16)
    eng.warmup()
    state = eng.pools_k + eng.pools_v + [eng._tables, eng._lengths, eng._active,
                                         eng._tokens, eng._remaining]
    assert all(t.device.type == card.type for t in state)
    prompts = [np.arange(2, 2 + n, dtype=np.int32) for n in (5, 9, 16)]
    for p in prompts:
        eng.submit(p, 6)
    audit = _DeviceAudit(card)
    with torch.no_grad(), audit:
        packed = eng._step_device()
    assert packed.device.type == card.type and not audit.off_card, audit.off_card
    eng._active_host[:] = False  # the audited step's tokens are not tracked
    for s in range(3):
        eng.retire(s)
    outs = {}
    for i, p in enumerate(prompts):
        slot, _ = eng.submit(p, 6)
        outs[slot] = (i, p)
    done = {}
    while len(done) < 3:
        _, fin = eng.step()
        for s in fin:
            i, p = outs[s]
            done[i] = np.concatenate([p, np.asarray(eng.retire(s), np.int32)])
    with torch.no_grad():
        for i, p in enumerate(prompts):
            want = generate(model, torch.from_numpy(p[None]), 6)[0].cpu().numpy()
            np.testing.assert_array_equal(done[i], want)
    eng.pool.check_invariants()


def test_engine_prefill_launches_the_flash_kernel(card):
    """With flash attention the engine's prefill runs the hand-written
    forward kernel: once per layer per request, and never in decode."""
    from moolib_tpu_torch.engine import ContinuousBatchingEngine

    model = _serving_lm(card, dtype=torch.bfloat16, attention="flash", num_kv_heads=None,
                        d_model=256, num_heads=2, max_len=96, vocab_size=128)
    eng = ContinuousBatchingEngine(model, slots=2, block_size=16, max_prompt_len=64)
    eng.warmup()
    fa.reset_launches()
    for n in (7, 64):
        slot, _ = eng.submit(np.arange(1, 1 + n, dtype=np.int32), 4)
        while eng.active_count():
            _, fin = eng.step()
            for s in fin:
                eng.retire(s)
    torch.cuda.synchronize()
    assert fa.flash_fwd_launches() == 2 * model.num_layers
    assert fa.flash_bwd_dq_launches() == fa.flash_bwd_dkv_launches() == 0


# ------------------------------------------------------------- replay, R2D2


def _replay_schedule(shard, rng, ops=200):
    for op in range(ops):
        if op % 3 == 0:
            items = [{"x": rng.normal(size=4).astype(np.float32),
                      "d": rng.random(3) < 0.5} for _ in range(8)]
            shard.add(items, (rng.random(8) * 4).astype(np.float32))
        elif len(shard) >= 16:
            idx = rng.choice(len(shard), size=16, replace=False)
            shard.update_priorities(idx.astype(np.int32), (rng.random(16) * 3).astype(np.float32))


def test_replay_shard_on_card_matches_cpu(card):
    """The same schedule on a card shard and a CPU shard: the tree bitwise
    (alpha 1: the transform is exact on both), the ring equal, and the draw
    equal given the same uniforms (weights within 2 ulps: CUDA's pow)."""
    from moolib_tpu_torch.replay import DeviceReplayShard
    from moolib_tpu_torch.replay.device import _draw

    shards = [DeviceReplayShard(128, alpha=1.0, seed=3, device=d) for d in ("cpu", card)]
    for s in shards:
        _replay_schedule(s, np.random.default_rng(0))
    cpu, gpu = shards
    assert gpu.tree.device.type == "cuda" and all(t.is_cuda for t in gpu._ring)
    assert torch.equal(gpu.tree.cpu(), cpu.tree)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(gpu._ring, cpu._ring))
    u = torch.rand(64, generator=torch.Generator().manual_seed(1))
    for so, to in ((0, 0.0), (4096, 512.0)):
        i_c, w_c = _draw(u, cpu.tree, 128, len(cpu), so, to, cpu.beta)
        i_g, w_g = _draw(u.to(card), gpu.tree, 128, len(gpu), so, to, gpu.beta)
        assert torch.equal(i_g.cpu(), i_c)
        ulps = (w_g.cpu().view(torch.int32).long() - w_c.view(torch.int32).long()).abs().max()
        assert ulps.item() <= 2
    # Default alpha: the card's transform within 1 ulp of the CPU's.
    p = torch.rand(4096) * 5
    a = DeviceReplayShard(8, device=card).priority_transform(p.to(card)).cpu()
    b = DeviceReplayShard(8, device="cpu").priority_transform(p)
    assert (a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max().item() <= 1


def test_replay_shard_duplicates_short_batches_and_storage_on_card(card):
    from moolib_tpu_torch.replay import DeviceReplayShard, SumTree

    shard = DeviceReplayShard(32, seed=9, device=card)
    ref = SumTree(32, dtype=np.float32)

    def tf(p):
        return shard.priority_transform(np.asarray(p, np.float32)).cpu().numpy()

    idxs = shard.add([{"x": np.full(2, i, np.float32)} for i in range(8)], np.ones(8, np.float32))
    ref.set(np.asarray(idxs), tf(np.ones(8)))
    ptrs = [shard.tree.data_ptr(), shard._ring[0].data_ptr(), shard._maxp.data_ptr()]
    dup = torch.tensor([3, 5, 3, 3, 7, 5, 0, 3], device=card)
    prios = torch.tensor([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8], device=card)
    shard.update_priorities(dup, prios)
    ref.set(dup.cpu().numpy(), tf(prios.cpu().numpy()))
    assert np.array_equal(shard.tree.cpu().numpy(), ref.tree)
    shard.add([{"x": np.full(2, 50.0, np.float32)} for _ in range(3)])  # short, default prio
    torch.cuda.synchronize()
    assert torch.equal(shard._ring[0][8:11].cpu(), torch.full((3, 2), 50.0))
    assert shard._ring[0][11:].abs().sum().item() == 0
    assert shard.leaf_priorities()[11:].abs().sum().item() == 0
    # Many more adds cycle the two pinned staging sets: the ring holds what went in.
    for k in range(20):
        shard.add([{"x": np.full(2, 100 + k * 8 + j, np.float32)} for j in range(8)])
    want = {float(100 + k * 8 + j) for k in range(16, 20) for j in range(8)}
    assert {float(v) for v in shard._ring[0][:, 0].cpu()} == want
    assert ptrs == [shard.tree.data_ptr(), shard._ring[0].data_ptr(), shard._maxp.data_ptr()]
    with pytest.raises(IndexError):
        shard.update_priorities(np.asarray([32]), np.ones(1, np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_width_qnet_forward_backward_on_card(card, dtype):
    """The R2D2 network at the JAX package's pixel geometry (18 actions,
    (16, 32, 32), 512/512): td_loss and its backward on the card against
    the CPU, values within 1e-5 (f32) or 2e-2 (bf16) of max(1, max|CPU|),
    gradients within 1e-4 (f32) or 5e-2 (bf16) of the largest |CPU
    gradient|.  TF32 is off in the convs too, and the CPU's max-pools take
    the inputs the card's took (``chip_smoke.PoolRoute``: a near-tie may
    pick another input on each device)."""
    import chip_smoke
    from moolib_tpu_torch.examples.r2d2 import td_loss
    from moolib_tpu_torch.models import RecurrentQNet

    kw = dict(num_actions=18, encoder="impala", hidden_size=512, core_size=512, dtype=dtype)
    host = RecurrentQNet(device="cpu", generator=torch.Generator().manual_seed(0), **kw)
    dev = RecurrentQNet(device=card, **kw)
    dev.load_state_dict(host.state_dict())
    rng = np.random.default_rng(0)
    batch = {"state": torch.from_numpy(rng.integers(0, 256, (3, 2, 84, 84, 4), dtype=np.uint8)),
             "done": torch.from_numpy(rng.random((3, 2)) < 0.3),
             "action": torch.from_numpy(rng.integers(0, 18, (3, 2))),
             "reward": torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32)),
             "core": tuple(torch.zeros(2, 512) for _ in range(2))}

    def run(model, d):
        b = {k: v.to(d) for k, v in batch.items() if k != "core"}
        b["core"] = tuple(c.to(d) for c in batch["core"])
        loss, prio = td_loss(model, model, b, 0.997)
        loss.backward()
        return (torch.cat([loss.detach().reshape(1), prio]).cpu(),
                {n: p.grad.float().cpu() for n, p in model.named_parameters()})

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        (v_dev, g_dev), (v_host, g_host) = chip_smoke.PoolRoute().compare(
            lambda: run(dev, card), lambda: run(host, "cpu"))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert torch.isfinite(v_dev).all()
    vtol, gtol = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 5e-2)}[dtype]
    assert (v_dev - v_host).abs().max().item() <= vtol * max(1.0, v_host.abs().max().item())
    scale = max(g.abs().max().item() for g in g_host.values())
    assert max((g_dev[n] - g).abs().max().item() for n, g in g_host.items()) <= gtol * scale


# ------------------------------------------------------ fleet and durability
def test_begin_capture_of_cuda_leaves_stalls_less_than_it_writes(card, tmp_path):
    """begin_capture snapshots CUDA leaves into pinned memory behind one
    event before it returns: an in-place write right after it cannot reach
    the shard, and the caller's stall is below the background write."""
    import hashlib
    import pickle
    import time

    from moolib_tpu_torch import checkpoint

    g = torch.Generator(device=card).manual_seed(0)
    params = {f"w{i}": torch.randn(1 << 20, generator=g, device=card) for i in range(16)}
    want = pickle.dumps(checkpoint.canonical_tree(
        {k: v.cpu().numpy() for k, v in params.items()}), protocol=pickle.HIGHEST_PROTOCOL)
    ck = checkpoint.DistributedCheckpointer(str(tmp_path))
    done = []
    assert ck.begin_capture(step=1, rank=0, world=1, state=params, on_done=done.append)
    for v in params.values():
        v.mul_(-1.0)  # the next optimizer step, in place, on the card
    deadline = time.time() + 60
    while not done and time.time() < deadline:
        time.sleep(0.01)
    assert done[0]["blob_sha256"] == hashlib.sha256(want).hexdigest()
    st = ck.stats()
    assert st["stall_s"] < st["write_s"]
    ck.close()


def test_checkpointer_round_trip_lands_on_the_callers_card(card, tmp_path):
    from moolib_tpu_torch.checkpoint import Checkpointer

    model = torch.nn.Linear(64, 64, device=card)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.randn(8, 64, device=card)).square().mean().backward()
    opt.step()
    state = {"params": model.state_dict(), "opt_state": opt.state_dict(), "steps": 1}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    got = ck.restore(map_location=card)
    assert got["params"]["weight"].device.type == "cuda"
    assert torch.equal(got["params"]["weight"], state["params"]["weight"])
    for i, s in state["opt_state"]["state"].items():
        assert torch.equal(got["opt_state"]["state"][i]["exp_avg"], s["exp_avg"])
    by_target = ck.restore(target={"params": model.state_dict()})
    assert by_target["params"]["bias"].device.type == "cuda"


def test_profiler_window_names_a_port_kernel(card, tmp_path):
    import json

    from moolib_tpu_torch.telemetry import profiling, timeline

    q, k, v = (torch.randn(2, 256, 4, 128, device=card).to(torch.bfloat16) for _ in range(3))
    fa.flash_attention(q, k, v)  # built and warm
    torch.cuda.synchronize()
    res = profiling.start_device_trace(str(tmp_path))
    assert res["ok"]
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    out = profiling.stop_device_trace()
    assert out["ok"]
    with open(out["trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" and "flash_fwd_wgmma_kernel" in e.get("name", "")
               for e in events)
    slices = timeline.load_profiler_trace(str(tmp_path))
    assert any("flash_fwd_wgmma_kernel" in s["name"] and s["bucket"] == "compute"
               for s in slices)


def test_find_batch_size_on_full_width_impala_stops_before_oom(card):
    from moolib_tpu_torch.utils.batchsize import find_batch_size

    model = ImpalaNet(6, (84, 84, 4), dtype=torch.bfloat16, device=card)

    def make_batch(n):
        obs = torch.zeros((1, n, 84, 84, 4), dtype=torch.uint8, device=card)
        return ({"state": obs, "reward": torch.zeros((1, n), device=card),
                 "done": torch.zeros((1, n), dtype=torch.bool, device=card),
                 "prev_action": torch.zeros((1, n), dtype=torch.int64, device=card)},)

    @torch.no_grad()
    def fwd(inputs):
        return model(inputs, ())

    # Up to 64Ki frames a call: the search runs into the card's memory and
    # must stop there, not raise.
    best = find_batch_size(make_batch, fwd, start=32, max_batch=1 << 16, iters=3)
    assert 32 <= best <= 1 << 16
    torch.cuda.empty_cache()


def test_capture_slots_reuse_their_pinned_buffers(card, tmp_path):
    """Captures alternate over two staging slots whose pinned buffers are
    allocated once: later captures stage into the same memory, and each
    capture still holds its own step's values."""
    import hashlib
    import pickle
    import time

    from moolib_tpu_torch import checkpoint

    params = {"w": torch.zeros(1 << 20, device=card), "b": torch.zeros(7, device=card)}
    ck = checkpoint.DistributedCheckpointer(str(tmp_path))
    ptrs, shas = [], []
    for step in range(1, 5):
        for v in params.values():
            v.fill_(float(step))
        want = pickle.dumps(checkpoint.canonical_tree({k: v.cpu().numpy() for k, v in
                                                       params.items()}),
                            protocol=pickle.HIGHEST_PROTOCOL)
        done = []
        assert ck.begin_capture(step=step, rank=0, world=1, state=params, on_done=done.append)
        deadline = time.time() + 60
        while not done and time.time() < deadline:
            time.sleep(0.005)
        shas.append(done[0]["blob_sha256"] == hashlib.sha256(want).hexdigest())
        ptrs.append(sorted(b[torch.float32].data_ptr() for b in ck._staging if b))
    assert all(shas)
    assert ptrs[1] == ptrs[2] == ptrs[3] and len(ptrs[3]) == 1  # one slot, reused
    ck.close()


def test_threefry_draws_on_card_match_cpu(card):
    """The seeding contract's draws in int64 on the card, bit for bit the
    CPU's (which the tier-1 tests hold to jax.random)."""
    from moolib_tpu_torch.envs import _threefry

    keys = _threefry.fold_in(_threefry.seed(7), torch.arange(4096))
    data = torch.arange(4096) * 7919 % 100_003
    for fn in (lambda k, d: _threefry.fold_in(k, d), lambda k, d: _threefry.split(k, 3),
               lambda k, d: _threefry.random_bits(k), lambda k, d: _threefry.randint(k, -1, 2),
               lambda k, d: _threefry.randint(k, -1000, 123456789)):
        assert torch.equal(fn(keys.to(card), data.to(card)).cpu(), fn(keys, data))


@pytest.mark.parametrize("name", ["catch_flat", "catch_proc"])
def test_jax_envs_on_card_match_cpu(card, name):
    """64 envs for 300 steps (33 auto-resets each) under one action stream:
    obs, reward and done on the card equal the CPU's bit for bit."""
    from moolib_tpu_torch.envs import _threefry, jax_envs

    env = jax_envs.make_jax_env(name)
    actions = torch.randint(0, 3, (300, 64), generator=torch.Generator().manual_seed(1))
    states = {dev: jax_envs.batch_init(env, _threefry.seed(3).to(dev), 64)
              for dev in ("cpu", card)}
    for a in actions:
        (states["cpu"], want), (states[card], got) = (
            jax_envs.batch_step(env, states["cpu"], a),
            jax_envs.batch_step(env, states[card], a.to(card)))
        for k in ("state", "reward", "done"):
            assert torch.equal(got[k].cpu(), want[k]), k


def test_anakin_rollout_on_card(card):
    """AnakinRollout on the card: unroll() equals step() bitwise, the unroll
    stays on the card, no boundary counter moves, and stats() moves one
    pinned snapshot, counted."""
    from moolib_tpu_torch import rollout, telemetry
    from moolib_tpu_torch.envs import _threefry, jax_envs
    from moolib_tpu_torch.models.actor_critic import ActorCriticNet

    def make():
        model = ActorCriticNet(3, obs_size=50, use_lstm=True, device=card,
                               generator=torch.Generator().manual_seed(0))
        return rollout.AnakinRollout(model, jax_envs.JaxProcCatch(), 32, 10,
                                     env_key=_threefry.seed(5), act_seed=6)

    def counters():
        return dict(telemetry.get_registry().counter_values())

    whole, stepped = make(), make()
    before = counters()
    for n in (11, 10):
        got = whole.unroll()
        for _ in range(n):
            stepped.step()
        want = stepped.take_unroll()
        for k in want:
            assert got[k].device.type == "cuda" and torch.equal(got[k], want[k]), k
    after = counters()
    for name in ("actor_h2d_bytes_total", "actor_d2h_bytes_total",
                 "batcher_h2d_bytes_total", "batcher_d2h_bytes_total"):
        assert after.get(name, 0.0) == before.get(name, 0.0), name
    snap = whole.stats()
    assert snap["episodes"] == 32 * (21 // 9) and snap["len_sum"] == 9 * snap["episodes"]
    assert (counters()["actor_stats_d2h_bytes_total"]
            - after.get("actor_stats_d2h_bytes_total", 0.0)) == 8 * (2 * 32 + 3)
