"""Combined elastic stress on the port: pipelined reductions x int8 wire
compression x peer churn — the feature interactions (epoch cancel of
in-flight pipelined rounds, EF residuals across cancels, rejoin model sync)
all at once (the port of ``tests/test_accumulator_churn.py``)."""

import time

import numpy as np
import torch

from moolib_tpu_torch import Accumulator, Broker, RpcError

torch.set_num_threads(1)


def pump_all(broker, accs):
    broker.update()
    for a in accs:
        a.update()
        if a.wants_state():
            a.set_state({"tag": a._rpc.get_name()})


LR = 0.1


def apply_step(a):
    """Consume a finished reduction: one SGD step + version bump."""
    g = a.gradients()
    p = a.parameters()
    a.set_parameters({"w": p["w"] - LR * g["w"]})
    a.zero_gradients()


def wait_until(broker, accs, seconds, cond):
    deadline = time.time() + seconds
    while time.time() < deadline:
        pump_all(broker, accs)
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def make_acc(name, addr, w0):
    a = Accumulator("m", {"w": torch.from_numpy(w0.copy())})
    a._rpc.set_name(name)
    a._rpc.set_timeout(10)
    a._rpc.listen("127.0.0.1:0")
    a.set_parallel_gradients(2)
    a.set_wire_dtype("int8")
    # A pipelined round whose peers stopped contributing resolves via the
    # group op timeout (elastic semantics — same as the reference's
    # allreduce timeouts). Default is 60 s; keep the test snappy.
    a._group.set_timeout(8.0)
    a.connect(addr)
    return a


def test_pipelined_int8_with_churn(free_port):
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    # Loaded single-core machines can starve ping pumps for seconds; a
    # short eviction timeout causes spurious epochs that stall the phases.
    broker.set_timeout(5.0)
    broker.listen(addr)
    w0 = np.full((16,), 5.0, np.float32)
    accs = [make_acc(f"p{i}", addr, w0) for i in range(3)]
    try:
        assert wait_until(broker, accs, 40, lambda: all(a.connected() for a in accs))

        # Drive a training-ish loop; after enough steps, kill one peer, keep
        # looping, then add a fresh one. Gradient = current params (so the
        # quadratic shrinks and any wire corruption shows up as divergence).
        steps = {id(a): 0 for a in accs}
        killed = rejoined = False
        deadline = time.time() + 240
        while time.time() < deadline:
            pump_all(broker, accs)
            for a in list(accs):
                if a.has_gradients():
                    apply_step(a)
                    steps[id(a)] = steps.get(id(a), 0) + 1
                elif a.wants_gradients():
                    try:
                        a.reduce_gradients(1, {"w": a.parameters()["w"].clone()})
                    except RpcError:
                        # A pipelined round completed on the RPC thread
                        # between has_gradients() and this call ("unconsumed
                        # gradients") — apply it on the next loop pass.
                        pass
            smin = min(steps.get(id(a), 0) for a in accs)
            if not killed and smin >= 4:
                victim = accs.pop()  # not necessarily the leader
                victim.close()
                killed = True
            elif killed and not rejoined and smin >= 8:
                fresh = make_acc("fresh", addr, np.zeros(16, np.float32))
                accs.append(fresh)
                steps[id(fresh)] = 0
                rejoined = True
            elif rejoined and min(steps.get(id(a), 0) for a in accs) >= 4:
                break
            time.sleep(0.005)
        assert killed and rejoined, (
            f"churn phases never completed: killed={killed} rejoined={rejoined} "
            f"steps={[steps.get(id(a), 0) for a in accs]} "
            f"connected={[a.connected() for a in accs]}"
        )
        # Settle: connected() is transiently false mid-epoch, and a peer may
        # still hold an unapplied in-flight/pending round — drain everything
        # (applying results, contributing nothing new) so every peer has
        # applied the same round sequence before comparing parameters.
        settle_deadline = time.time() + 60
        def fully_settled():
            return (
                all(a.connected() for a in accs)
                and not any(a._inflight for a in accs)
                and not any(a.has_gradients() for a in accs)
            )
        while time.time() < settle_deadline and not fully_settled():
            pump_all(broker, accs)
            for a in accs:
                if a.has_gradients():
                    apply_step(a)
            time.sleep(0.01)
        assert fully_settled(), (
            f"cohort never settled: connected={[a.connected() for a in accs]} "
            f"inflight={[len(a._inflight) for a in accs]}"
        )
        # Everyone (including the late joiner, which synced the model) holds
        # identical parameters, and the quadratic went DOWN from the start.
        w_ref = np.asarray(accs[0].parameters()["w"])
        for a in accs[1:]:
            np.testing.assert_allclose(np.asarray(a.parameters()["w"]), w_ref, rtol=1e-5)
        assert float(np.abs(w_ref).max()) < 4.0, f"no descent: {w_ref[:4]}"
    finally:
        for a in accs:
            a.close()
        broker.close()
