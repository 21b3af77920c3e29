"""Port of ``tests/test_stats_accumulator.py`` to ``moolib_tpu_torch``,
plus the port's GlobalStatsAccumulator against the JAX package's on the
same deltas.

GlobalStatsAccumulator delta protocol: values must track the true global
sum, not amplify.

Regression for a real bug a soak exposed: remote deltas were
applied to the stat value but not to the delta baseline, so every peer
re-broadcast everyone else's contributions as its own next delta —
(n-1)x amplification per reduce round.  steps_done inflated ~1000x and
agents quit early against their total_steps budget.
"""

import time

import numpy as np

from moolib_tpu_torch.examples.common import GlobalStatsAccumulator, _delta_reduce_op
from moolib_tpu_torch.utils.stats import StatMean, StatSum


class _Fut:
    def __init__(self, result=None, exc=None):
        self._r, self._e = result, exc

    def done(self):
        return True

    def exception(self):
        return self._e

    def result(self, timeout=None):
        if self._e is not None:
            raise self._e
        return self._r

    def add_done_callback(self, cb):
        cb(self)


class _SyncCohortGroup:
    """Completes each peer's allreduce synchronously once all N peers of a
    round have contributed — the lockstep the real Group provides."""

    def __init__(self):
        self.pending = []

    @staticmethod
    def wire(n):
        groups = [_SyncCohortGroup() for _ in range(n)]
        for g in groups:
            g.cohort = groups
        return groups

    def all_reduce(self, name, value, op):
        self.calls = getattr(self, "calls", [])
        self.calls.append(value)
        self._value = value

        class _Deferred:
            # Like the real AllReduce: a callback added after completion
            # fires immediately (the last contributor registers its
            # callback after its own call completed the round).
            def __init__(s):
                s.cbs = []
                s.fired = None

            def add_done_callback(s, cb):
                if s.fired is not None:
                    cb(s.fired)
                else:
                    s.cbs.append(cb)

            def fire(s, fut):
                s.fired = fut
                for cb in s.cbs:
                    cb(fut)

        d = _Deferred()
        self.pending.append((value, d))
        # Complete the round once every cohort member contributed.
        if all(g.pending for g in self.cohort):
            contribs = [g.pending[0][0] for g in self.cohort]
            total = contribs[0]
            for c in contribs[1:]:
                total = op(total, c)
            fut = _Fut(result=total)
            for dd in [g.pending.pop(0)[1] for g in self.cohort]:
                dd.fire(fut)
        return d


def test_no_amplification_over_rounds():
    n, rounds, inc = 4, 12, 100.0
    groups = _SyncCohortGroup.wire(n)
    stats = [{"steps": StatSum(), "loss": StatMean()} for _ in range(n)]
    accs = [GlobalStatsAccumulator(g, s) for g, s in zip(groups, stats)]
    for r in range(rounds):
        for s in stats:
            s["steps"] += inc
            s["loss"] += 0.5
        for a, s in zip(accs, stats):
            a.reduce(s)
        true_total = inc * n * (r + 1)
        for s in stats:
            assert s["steps"].value == true_total, (r, s["steps"].value, true_total)
    # Mean stats also track the global (sum, count) exactly.
    for s in stats:
        assert s["loss"].count == n * rounds
        np.testing.assert_allclose(s["loss"].result(), 0.5)


def test_failed_round_requeues_delta():
    class _FailGroup:
        def all_reduce(self, name, value, op):
            return _Fut(exc=RuntimeError("group changed"))

    stats = {"steps": StatSum()}
    acc = GlobalStatsAccumulator(_FailGroup(), stats)
    stats["steps"] += 7
    acc.reduce(stats)
    assert acc._pending_delta == {"steps": 7.0}
    assert acc._inflight is None  # a failed round must not wedge reduce()
    # The re-queued delta joins the next (successful) round.
    class _OkGroup:
        def all_reduce(self, name, value, op):
            self.sent = value
            return _Fut(result=value)

    ok = _OkGroup()
    acc._group = ok
    stats["steps"] += 3
    acc.reduce(stats)
    assert ok.sent == {"steps": 10.0}
    assert stats["steps"].value == 10.0


def test_local_reset_windowing_stays_synced():
    groups = _SyncCohortGroup.wire(2)
    stats = [{"w": StatMean()} for _ in range(2)]
    accs = [GlobalStatsAccumulator(g, s) for g, s in zip(groups, stats)]
    for s in stats:
        s["w"] += 1.0
    for a, s in zip(accs, stats):
        a.reduce(s)
    assert stats[0]["w"].count == 2
    accs[0].local_reset("w")
    assert stats[0]["w"].count == 0
    # The reset peer's next delta is zero-based: no negative delta storm.
    for a, s in zip(accs, stats):
        a.reduce(s)
    assert stats[1]["w"].count == 2  # unchanged by peer 0's local windowing


# ------------------------------------------- over real cohorts, both packages
def _cohort(pkg, n, port):
    """A broker and n loopback peers of one package, converged."""
    addr = f"127.0.0.1:{port}"
    broker = pkg.Broker()
    broker.set_name("broker")
    broker.listen(addr)
    peers = []
    for i in range(n):
        rpc = pkg.Rpc()
        rpc.set_name(f"peer{i}")
        rpc.listen("127.0.0.1:0")
        rpc.connect(addr)
        g = pkg.Group(rpc, "stats")
        g.set_timeout(20)
        peers.append((rpc, g))
    return broker, peers


def _pump(broker, groups, until, seconds=30):
    deadline = time.time() + seconds
    while time.time() < deadline:
        broker.update()
        for g in groups:
            g.update()
        if until():
            return True
        time.sleep(0.01)
    return until()


def _reduced_stats(pkg, common, stats_mod, telemetry, port):
    """Three peers reduce three rounds of the same deltas; returns each
    peer's stats after every round (values, and the CohortCounters'
    fleet-wide totals)."""
    n = 3
    broker, peers = _cohort(pkg, n, port)
    groups = [g for _, g in peers]
    try:
        assert _pump(broker, groups, lambda: all(g.active() and len(g.members()) == n
                                                 for g in groups))
        regs = [telemetry.Registry() for _ in range(n)]
        ctrs = [r.counter("frames_total", "frames") for r in regs]
        stats = [{"steps": stats_mod.StatSum(), "ret": stats_mod.StatMean(),
                  "tel": telemetry.CohortCounters(registry=r)} for r in regs]
        accs = [common.GlobalStatsAccumulator(g, s) for g, s in zip(groups, stats)]
        rng = np.random.default_rng(17)
        history = []
        for _ in range(3):
            for s, c in zip(stats, ctrs):
                s["steps"] += float(rng.integers(1, 100))
                # Quarter steps: exact sums, so the bytes cannot depend on
                # the order the tree meets the contributions in.
                s["ret"] += float(rng.integers(-40, 40)) / 4
                c.inc(float(rng.integers(1, 9)))
            for a, s in zip(accs, stats):
                a.reduce(s)
            assert _pump(broker, groups, lambda: all(a._inflight is None for a in accs))
            history.append([(s["steps"].value, s["ret"].sum, s["ret"].count,
                             s["tel"].value("frames_total")) for s in stats])
        return history
    finally:
        for rpc, _ in peers:
            rpc.close()
        broker.close()


def test_global_stats_over_port_cohort_match_jax(free_port):
    """GlobalStatsAccumulator over a port cohort (callable _delta_reduce_op
    through Group.all_reduce, CohortCounters deltas riding in it) gives the
    JAX package's reduced stats, bit for bit, on the same deltas."""
    import moolib_tpu
    import moolib_tpu_torch
    from moolib_tpu import telemetry as jax_telemetry
    from moolib_tpu.examples import common as jax_common
    from moolib_tpu.utils import stats as jax_stats
    from moolib_tpu_torch import telemetry
    from moolib_tpu_torch.examples import common
    from moolib_tpu_torch.utils import stats as port_stats

    from conftest import grab_port

    want = _reduced_stats(moolib_tpu, jax_common, jax_stats, jax_telemetry, free_port)
    got = _reduced_stats(moolib_tpu_torch, common, port_stats, telemetry, grab_port())
    assert got == want
    # Every peer saw the fleet-wide totals.
    for rnd in got:
        assert len({(steps, count, frames) for steps, _, count, frames in rnd}) == 1


def test_tsv_logger_writes_the_jax_format(tmp_path):
    """Header once, one row a call (time first, then the first call's
    fields in order), a latest.tsv link and metadata.json — as the JAX
    package's TsvLogger writes them."""
    import json

    from moolib_tpu.examples.common import TsvLogger as JaxTsvLogger
    from moolib_tpu_torch.examples.common import TsvLogger

    rows = {}
    for name, cls in (("jax", JaxTsvLogger), ("port", TsvLogger)):
        d = tmp_path / name
        log = cls(str(d / "logs.tsv"), metadata={"seed": 3})
        log.log(step=1, loss=0.5)
        log.log(loss=0.25, step=2, extra="ignored")
        lines = (d / "logs.tsv").read_text().splitlines()
        rows[name] = [ln.split("\t")[1:] for ln in lines]
        assert lines[0].split("\t")[0] == "time"
        assert (d / "latest.tsv").resolve() == (d / "logs.tsv").resolve()
        meta = json.loads((d / "metadata.json").read_text())
        assert meta["seed"] == 3 and meta["log"] == "logs.tsv"
    assert rows["port"] == rows["jax"] == [["step", "loss"], ["1", "0.5"], ["2", "0.25"]]
