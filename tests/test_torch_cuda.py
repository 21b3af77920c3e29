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
