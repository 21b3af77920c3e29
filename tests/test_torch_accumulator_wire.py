"""Gradient wire compression on the port (bf16 / int8+error-feedback
allreduce payloads): the port of ``tests/test_accumulator_wire.py`` with
torch CPU tensors, plus the EF-q8 and bf16 hop functions held bit for bit
against the JAX package's."""

import time

import numpy as np
import pytest
import torch

from moolib_tpu_torch import Accumulator, Broker
from moolib_tpu_torch.accumulator import _dequantize_q8, _q8_add, _quantize_q8

torch.set_num_threads(1)


def _pump(broker, accs, seconds, until):
    deadline = time.time() + seconds
    while time.time() < deadline:
        broker.update()
        for a in accs:
            a.update()
            if a.wants_state():
                a.set_state({})
        if until():
            return True
        time.sleep(0.02)
    return until()


def test_bf16_wire_gradients(free_port):
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.listen(addr)
    accs = []
    for i in range(2):
        acc = Accumulator("m", {"w": torch.zeros(4)})
        acc.set_name(f"p{i}")
        acc.listen()
        acc.set_wire_dtype(torch.bfloat16)
        acc.connect(addr)
        accs.append(acc)
    try:
        assert _pump(broker, accs, 30, lambda: all(a.connected() for a in accs))
        g = {"w": torch.tensor([1.0, 2.0, 3.0, 4.0])}
        for a in accs:
            a.reduce_gradients(1, g)
        assert _pump(broker, accs, 15, lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            out = a.gradients()["w"]
            assert out.dtype == torch.float32
            # bf16 carries ~3 decimal digits: mean of identical grads = grads.
            np.testing.assert_allclose(out, [1, 2, 3, 4], rtol=0.01)
    finally:
        for a in accs:
            a.close()
        broker.close()


def test_q8_quantize_roundtrip_and_error_feedback():
    rng = np.random.default_rng(0)
    g = {"w": rng.normal(size=(64,)).astype(np.float32), "b": np.zeros(3, np.float32)}
    q, res = _quantize_q8(g, None)
    deq = _dequantize_q8(q)
    # <1% relative error on the large leaf; zeros stay exactly zero.
    np.testing.assert_allclose(deq["w"], g["w"], atol=np.abs(g["w"]).max() / 100)
    np.testing.assert_array_equal(deq["b"], 0.0)
    # Error feedback: residual equals the quantization error and joins the
    # next round, so two identical contributions average to (nearly) exact.
    np.testing.assert_allclose(res["w"], g["w"] - deq["w"], atol=1e-6)
    q2, _ = _quantize_q8(g, res)
    two_round_mean = (_dequantize_q8(q)["w"] + _dequantize_q8(q2)["w"]) / 2
    err0 = np.abs(deq["w"] - g["w"]).mean()
    err2 = np.abs(two_round_mean - g["w"]).mean()
    assert err2 < err0 * 0.75, (err0, err2)
    # Hop-combining matches f32 addition within one quantization step.
    both = _q8_add(q, q)
    np.testing.assert_allclose(
        _dequantize_q8(both)["w"], 2 * deq["w"], atol=2 * np.abs(g["w"]).max() / 127
    )


def test_int8_wire_gradients_cohort(free_port):
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.listen(addr)
    accs = []
    for i in range(3):
        acc = Accumulator("m", {"w": torch.zeros(8)})
        acc.set_name(f"p{i}")
        acc.listen()
        acc.set_wire_dtype("int8")
        acc.connect(addr)
        accs.append(acc)
    try:
        assert _pump(broker, accs, 30, lambda: all(a.connected() for a in accs))
        rng = np.random.default_rng(1)
        gs = [
            {"w": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32) * (i + 1))}
            for i in range(3)
        ]
        for a, g in zip(accs, gs):
            a.reduce_gradients(1, g)
        assert _pump(broker, accs, 15, lambda: all(a.has_gradients() for a in accs))
        expected = np.mean([g["w"].numpy() for g in gs], axis=0)
        tol = max(np.abs(g["w"].numpy()).max() for g in gs) / 127 * 3
        for a in accs:
            out = a.gradients()["w"]
            assert out.dtype == torch.float32
            np.testing.assert_allclose(out, expected, atol=tol)
            a.zero_gradients()
    finally:
        for a in accs:
            a.close()
        broker.close()


def test_two_phase_virtual_batch_one_grad_allreduce(free_port):
    """With a virtual batch size set, only counts ride
    the wire per contribution; the gradient payload goes out in exactly ONE
    allreduce per virtual batch (reference src/accumulator.cc:1005-1078)."""
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.listen(addr)
    accs = []
    for i in range(2):
        acc = Accumulator("m", {"w": torch.zeros(4)})
        acc.set_name(f"p{i}")
        acc.listen()
        acc.set_virtual_batch_size(16)
        acc.connect(addr)
        accs.append(acc)
    try:
        assert _pump(broker, accs, 30, lambda: all(a.connected() for a in accs))
        # Count every gradient-bearing payload that leaves each peer, and the
        # distinct allreduce op keys they belong to (tree sends ride
        # __group_reduce, chunked-ring sends ride __group_ring; args[1] is the
        # epoch-keyed op key on both protocols).
        grad_sends = {i: 0 for i in range(len(accs))}
        grad_keys = set()
        for i, a in enumerate(accs):
            orig = a._rpc.async_callback

            def spy(peer, fn, cb, *args, _orig=orig, _i=i):
                if fn in ("__group_reduce", "__group_ring") and "__accum_grad" in str(args[1]):
                    grad_sends[_i] += 1
                    grad_keys.add(tuple(args[1]))
                return _orig(peer, fn, cb, *args)

            a._rpc.async_callback = spy
        # 4 contribution rounds of global batch 4 each -> fires at round 4.
        for round_i in range(4):
            for a in accs:
                a.reduce_gradients(2, {"w": torch.full((4,), float(round_i + 1))})
            assert _pump(
                broker, accs, 15, lambda: all(not a._inflight or a.has_gradients() for a in accs)
            )
            if round_i < 3:
                assert not any(a.has_gradients() for a in accs), round_i
        assert _pump(broker, accs, 15, lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            stats = a.get_gradient_stats()
            assert stats == {"num_gradients": 8, "num_skipped": 0, "batch_size": 16}
            # mean over 8 contributions of (1+2+3+4) pairs = (1+2+3+4)*2/8
            np.testing.assert_allclose(np.asarray(a.gradients()["w"]), 2.5)
        # Wire-level assertion: all gradient traffic this virtual batch
        # belonged to exactly ONE allreduce op.  On the tree that is one
        # up-the-tree send total (the root only shares down); on the chunked
        # ring it is 2(n-1) frames per peer, all under the same op key.
        assert len(grad_keys) == 1, grad_keys
        ring = accs[0]._use_ring_locked()
        expected_sends = 2 * (len(accs) - 1) * len(accs) if ring else 1
        assert sum(grad_sends.values()) == expected_sends, (grad_sends, ring)
        # And the op-sequence bookkeeping agrees: 4 count rounds, 1 grad round.
        sid = accs[0]._group.sync_id()
        assert accs[0]._group._seq[(sid, "__accum_count:m")] == 4
        assert accs[0]._group._seq[(sid, "__accum_grad:m")] == 1
    finally:
        for a in accs:
            a.close()
        broker.close()


def test_bf16_hop_accumulates_in_f32():
    """A bf16 leaf (a torch.bfloat16 tensor in the port) must take the
    f32-accumulate path and only re-round via finalize."""
    from moolib_tpu_torch.accumulator import _grad_reduce_op, _wire_finalize

    mk = lambda v: {
        "grads": {"w": torch.tensor([v], dtype=torch.bfloat16)},
        "num_gradients": 1,
        "num_skipped": 0,
        "batch_size": 1,
        "wire": "bfloat16",
    }
    # 256 + 1 + 1: chained bf16 rounding absorbs both 1s (ulp at 256 is 2);
    # f32 accumulation inside one hop keeps them until the single re-round.
    partial = _grad_reduce_op(_grad_reduce_op(mk(256.0), mk(1.0)), mk(1.0))
    assert partial["fmt"] == "f32"
    assert partial["grads"]["w"].dtype == np.float32
    np.testing.assert_allclose(partial["grads"]["w"], [258.0])
    out = _wire_finalize("bfloat16")(partial)
    assert "fmt" not in out
    assert out["grads"]["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(out["grads"]["w"].float().numpy(), [258.0])
    assert out["num_gradients"] == 3 and out["batch_size"] == 3
    # Leaf pass-through: finalize leaves raw (non-partial) payloads alone.
    raw = mk(7.0)
    assert _wire_finalize("bfloat16")(raw) is raw


def test_debug_checksums_verify_and_detect_divergence(free_port):
    """CRC32 gradient checksums (reference src/accumulator.cc:324-370): a
    healthy cohort verifies every round; a peer whose applied result is
    tampered with gets flagged as a divergence on every peer."""
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.listen(addr)
    accs = []
    for i in range(2):
        acc = Accumulator("m", {"w": torch.zeros(8)})
        acc.set_name(f"p{i}")
        acc.listen()
        acc.set_debug_checksums(True)
        acc.connect(addr)
        accs.append(acc)
    try:
        assert _pump(broker, accs, 30, lambda: all(a.connected() for a in accs))
        gs = [{"w": torch.full((8,), float(i + 1))} for i in range(2)]
        for a, g in zip(accs, gs):
            a.reduce_gradients(2, g)
        assert _pump(broker, accs, 15, lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            a.zero_gradients()
        # The verify allreduce is asynchronous; give it a pump cycle.
        _pump(broker, accs, 2, lambda: False)
        assert all(a.debug_info()["checksum_divergences"] == 0 for a in accs)

        # Tamper with peer 1's applied result: wrap _maybe_checksum_locked's
        # input by corrupting _result_grads right as the round completes.
        orig = accs[1]._maybe_checksum_locked

        def corrupt():
            if accs[1]._result_grads is not None:
                accs[1]._result_grads = {
                    "w": np.asarray(accs[1]._result_grads["w"]) + 1.0
                }
            orig()

        accs[1]._maybe_checksum_locked = corrupt
        for a, g in zip(accs, gs):
            a.reduce_gradients(2, g)
        assert _pump(broker, accs, 15, lambda: all(a.has_gradients() for a in accs))
        assert _pump(
            broker, accs, 15,
            lambda: all(a.debug_info()["checksum_divergences"] == 1 for a in accs),
        )
    finally:
        for a in accs:
            a.close()
        broker.close()


def test_q8_ring_preserves_error_feedback(free_port):
    """The q8 wire over the chunked ring keeps error feedback: the
    contributor EF-quantizes (residual carried) and the ring accumulates in
    f32 with bf16 hop transport, never per-hop int8 re-quantization of
    partial sums, which would drop the residual."""
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.listen(addr)
    accs = []
    for i in range(2):
        acc = Accumulator("m", {"w": torch.zeros(64)})
        acc.set_name(f"p{i}")
        acc.listen()
        acc.set_wire_dtype("int8")
        acc.set_chunked_allreduce(True)  # force the ring below the 1 MiB auto cut
        acc.connect(addr)
        accs.append(acc)
    try:
        assert _pump(broker, accs, 30, lambda: all(a.connected() for a in accs))
        # The ring must not ride the per-hop q8 codec anymore.
        for a in accs:
            assert a._ring_wire_locked() == "bfloat16"
            assert a.debug_info()["ring_q8_mode"] == "contributor_ef_bf16_hops"
        rng = np.random.default_rng(7)
        g0 = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
        g1 = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
        means = []
        for _ in range(2):  # two rounds: EF residual must carry across them
            for a, g in zip(accs, (g0, g1)):
                a.reduce_gradients(1, g)
            assert _pump(broker, accs, 15, lambda: all(a.has_gradients() for a in accs))
            outs = [a.gradients()["w"].numpy() for a in accs]
            np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-7)
            means.append(outs[0])
            for a in accs:
                a.zero_gradients()
        expected = (g0["w"] + g1["w"]).numpy() / 2
        tol1 = max(np.abs(g0["w"].numpy()).max(), np.abs(g1["w"].numpy()).max()) / 127 * 2
        np.testing.assert_allclose(means[0], expected, atol=tol1)
        # EF engaged: the residual exists, and averaging the two rounds is
        # closer to the true mean than round 1 alone (the EF signature).
        for a in accs:
            assert a._q_residual is not None
        err1 = np.abs(means[0] - expected).mean()
        err2 = np.abs((means[0] + means[1]) / 2 - expected).mean()
        assert err2 < err1 * 0.9, (err1, err2)
    finally:
        for a in accs:
            a.close()
        broker.close()


# ------------------------------------------------ bit parity of the codecs
def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((5, 3)) * scale).astype(np.float32),
            "b": (rng.standard_normal(4) * scale).astype(np.float32),
            "z": np.zeros(2, np.float32)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_q8_functions_are_bit_equal_to_the_jax_package(seed):
    """EF-q8 stays numpy in the port: the ints, scales and residuals of
    three rounds with the residual carried, the dequantized values and one
    hop combine equal the JAX package's bit for bit (torch inputs on the
    port side)."""
    from moolib_tpu import accumulator as ref

    rng = np.random.default_rng(seed)
    res_p = res_r = None
    for _ in range(3):
        g = _tree(rng, scale=10.0 ** rng.integers(-3, 3))
        qp, res_p = _quantize_q8({k: torch.from_numpy(v) for k, v in g.items()}, res_p)
        qr, res_r = ref._quantize_q8(g, res_r)
        for k in g:
            assert qp["q"][k].tobytes() == np.asarray(qr["q"][k]).tobytes()
            assert np.float32(qp["s"][k]).tobytes() == np.float32(qr["s"][k]).tobytes()
            assert res_p[k].tobytes() == np.asarray(res_r[k]).tobytes()
            assert _dequantize_q8(qp)[k].tobytes() == np.asarray(ref._dequantize_q8(qr)[k]).tobytes()
    hop_p, hop_r = _q8_add(qp, qp), ref._q8_add(qr, qr)
    for k in g:
        assert hop_p["q"][k].tobytes() == np.asarray(hop_r["q"][k]).tobytes()


def test_bf16_wire_rounding_equals_ml_dtypes():
    """The port rounds to the bf16 wire through torch.bfloat16; the bytes
    equal ml_dtypes' (the JAX package's) on ties, subnormals and infs."""
    import ml_dtypes

    from moolib_tpu_torch.accumulator import _to_wire

    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 1e3,
        np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 1e-40, -1e-41,
                  np.inf, -np.inf, 0.0, -0.0, 3.4e38], np.float32),
    ])
    port = _to_wire(x, "bfloat16").view(torch.int16).numpy()
    ref = x.astype(ml_dtypes.bfloat16).view(np.int16)
    assert port.tobytes() == ref.tobytes()
