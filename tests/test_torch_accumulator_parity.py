"""Mixed Accumulator cohorts: JAX and port peers reduce gradients, elect
leaders and sync models together, bit for bit.

Four peers ``peer0..peer3`` alternate between the JAX package (numpy
gradients) and the port (torch CPU tensors), under a JAX broker with a JAX
leader and under a port broker with a port leader, so the model sync runs
in both directions.  ``{"w", "b"}`` trees exercise the sorted-key flatten
(insertion order puts ``w`` first; the wire layout puts ``b`` first).  On
every path — the count and grad rounds of a virtual batch with uneven
contributions, the legacy tree, the flat buckets, the chunked ring, the
bf16 wire on all three, the int8 wire with its EF residual carried over
three rounds (tree, buckets, ring) and a skipping peer — each peer's
averaged gradients must be bitwise equal to an all-JAX cohort's with the
same names and inputs.

Tree-family rounds fold in arrival order, so their inputs are exact in any
order: integers, and for q8 half-integers with a 127 anchor at the head of
every leaf and bucket (each hop's scale is then the exact count of its
contributors).  The ring folds in a fixed order, so its inputs are random
floats.  Then one run under churn: a port peer leaves mid-stream and
rejoins under the same name; every round a peer completes equals the exact
sum of its epoch's members.
"""

import time

import numpy as np
import pytest
import torch

import moolib_tpu
import moolib_tpu_torch
from moolib_tpu import buckets as jax_buckets
from moolib_tpu_torch import buckets as port_buckets

torch.set_num_threads(1)

PKG = {"jax": moolib_tpu, "port": moolib_tpu_torch}
N = 4
KINDS = ["jax", "port", "jax", "port"]
BUCKET_BYTES = 4096  # 1024 float32 per bucket: every bucketed round has several
SHAPES = {"w": (1300, 2), "b": (7,)}


def _set_bucket_bytes(n):
    jax_buckets.set_bucket_bytes(n)
    port_buckets.set_bucket_bytes(n)


@pytest.fixture(autouse=True)
def _small_buckets():
    _set_bucket_bytes(BUCKET_BYTES)
    yield
    _set_bucket_bytes(jax_buckets._DEFAULT_BUCKET_BYTES)


def _ints(rng, lo, hi):
    return {k: rng.integers(lo, hi, s).astype(np.float32) for k, s in SHAPES.items()}


def _floats(rng):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _anchored(rng):
    """Half-integers in [-30, 30] with 127 at the head of every leaf and of
    every flat bucket: q8 rounds to a scale of 1 at the source (ties give a
    residual of ±0.5, carried to the next round) and to the exact
    contributor count at every hop."""
    out = {k: (rng.integers(-60, 61, s) / 2).astype(np.float32) for k, s in SHAPES.items()}
    flat = np.concatenate([out["b"].ravel(), out["w"].ravel()])  # sorted-key layout
    flat[::BUCKET_BYTES // 4] = 127.0
    out["b"][:] = flat[:7]
    out["w"][:] = flat[7:].reshape(SHAPES["w"])
    out["w"].flat[0] = 127.0
    return out


def _paths():
    """(name, setup kwargs, rounds): each round is every peer's (batch size,
    gradients or None for a skip)."""
    rng = np.random.default_rng(0)

    def rounds(n, make, sizes=None):
        return [[((sizes[r][i] if sizes else 8), make(rng)) for i in range(N)]
                for r in range(n)]

    skip = [[(8, _ints(rng, -1000, 1000)) for _ in range(N)]]
    skip[0][1] = (0, None)
    return [
        ("tree", dict(bucketed=False), rounds(1, lambda r: _ints(r, -1000, 1000))),
        ("bucketed", dict(), rounds(1, lambda r: _ints(r, -1000, 1000))),
        ("ring", dict(chunked=True), rounds(1, _floats)),
        ("tree_bf16", dict(bucketed=False, wire=torch.bfloat16), rounds(1, lambda r: _ints(r, -30, 31))),
        ("bucketed_bf16", dict(wire=torch.bfloat16), rounds(1, lambda r: _ints(r, -30, 31))),
        ("ring_bf16", dict(chunked=True, wire=torch.bfloat16), rounds(1, _floats)),
        ("tree_q8_ef", dict(bucketed=False, wire="int8"), rounds(3, _anchored)),
        ("bucketed_q8_ef", dict(wire="int8"), rounds(3, _anchored)),
        ("ring_q8_ef", dict(chunked=True, wire="int8"), rounds(3, _floats)),
        ("skip", dict(), skip),
        ("virtual_batch", dict(vbatch=16),
         rounds(2, lambda r: _ints(r, -1000, 1000), sizes=[[2, 3, 1, 4], [1, 2, 5, 3]])),
    ]


PATHS = [p[0] for p in _paths()]


class _Cohort:
    def __init__(self, kinds, broker_kind, port, versions):
        self.addr = f"127.0.0.1:{port}"
        self.broker = PKG[broker_kind].Broker()
        self.broker.set_name("broker")
        self.broker.set_timeout(5.0)
        self.broker.listen(self.addr)
        self.peers = []
        # Diagnostics for the assertion messages: each peer's membership
        # epochs (sync_id) in the order it saw them, and the longest stretch
        # between two pump iterations (nobody pings the broker meanwhile).
        self.epochs = {}
        self.max_gap = 0.0
        for i, kind in enumerate(kinds):
            self.peers.append(self.join(f"peer{i}", kind, versions[i], marker=float(i + 1)))

    def join(self, name, kind, version=0, marker=0.0):
        params = {k: np.full(s, marker, np.float32) for k, s in SHAPES.items()}
        if kind == "port":
            params = {k: torch.from_numpy(v) for k, v in params.items()}
        acc = PKG[kind].Accumulator("model", params)
        acc._rpc.set_name(name)
        acc._rpc.set_timeout(10)
        acc._rpc.listen("127.0.0.1:0")
        acc._group.set_timeout(20)
        acc.set_model_version(version)
        acc.connect(self.addr)
        acc.kind = kind
        return acc

    def pump(self, until, seconds=30):
        deadline = time.time() + seconds
        last = time.monotonic()
        while time.time() < deadline:
            now = time.monotonic()
            self.max_gap = max(self.max_gap, now - last)
            last = now
            self.broker.update()
            for a in self.peers:
                a.update()
                seen = self.epochs.setdefault(a._rpc.get_name(), [])
                if not seen or seen[-1] != a._group.sync_id():
                    seen.append(a._group.sync_id())
                if a.wants_state():
                    nu = np.arange(3, dtype=np.float32)
                    a.set_state({"nu": torch.from_numpy(nu) if a.kind == "port" else nu,
                                 "step": a.model_version()})
            if until():
                return True
            time.sleep(0.005)
        return until()

    def describe(self):
        def peer(a):
            with a._lock:
                return (f"{a._rpc.get_name()}: has_gradients={a.has_gradients()} "
                        f"inflight={len(a._inflight)} "
                        f"epochs={self.epochs.get(a._rpc.get_name())}")

        peers = ", ".join(peer(a) for a in self.peers)
        # Process-wide counts (every session so far) of rounds that errored.
        errors = {k: m.accumulator._M_ROUND_ERRORS._default().get() for k, m in PKG.items()}
        return f"longest pump gap {self.max_gap:.2f} s; round errors {errors}; {peers}"

    def close(self):
        for a in self.peers:
            a.close()
        self.broker.close()


def _configure(a, kw):
    a.set_bucketed_allreduce(kw.get("bucketed", True))
    a.set_chunked_allreduce(kw.get("chunked", False))
    wire = kw.get("wire")
    if a.kind == "jax" and wire is torch.bfloat16:
        import jax.numpy as jnp

        wire = jnp.bfloat16
    a.set_wire_dtype(wire)
    a._virtual_batch_size = kw.get("vbatch")


def _canon(g):
    return [(k, np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v).tobytes())
            for k, v in sorted(g.items())]


def _settled(a):
    """Whether peer ``a`` holds its result or has no round in flight, read
    under its lock.  The thread that completes a round takes it off
    ``_inflight`` and then sets ``has_gradients()``, both inside one locked
    drain; an unlocked read can land between the two and take a peer still
    applying its result for one with nothing pending."""
    with a._lock:
        return a.has_gradients() or not a._inflight


def _session(kinds, broker_kind, versions):
    from conftest import grab_port

    c = _Cohort(kinds, broker_kind, grab_port(), versions)
    try:
        assert c.pump(lambda: all(a.connected() for a in c.peers), 60), "cohort never synced"
        out = {"leader": [a.get_leader() for a in c.peers],
               "version": [a.model_version() for a in c.peers],
               "params": [_canon(a.parameters()) for a in c.peers],
               "state": [],
               "sha": [getattr(a, "_last_sync_sha", None) for a in c.peers]}
        for a in c.peers:
            st = a.state() if a.has_new_state() else None
            out["state"].append(None if st is None else np.asarray(st["nu"]).tobytes())
        leader = next(a for a in c.peers if a.is_leader())
        nu = np.arange(3, dtype=np.float32)
        v = leader.model_version()
        # The sha the leader advertised, recomputed from the same values.
        out["leader_sha"] = leader._sync_chunks(
            v, leader.parameters(), None,
            {"nu": torch.from_numpy(nu) if leader.kind == "port" else nu, "step": v})[1]
        out["leader_kind"] = leader.kind
        for name, kw, rounds in _paths():
            for a in c.peers:
                _configure(a, kw)
            res = []
            partial = 0  # rounds that ended with some peer holding no result
            for r, contribs in enumerate(rounds):
                for a, (bs, g) in zip(c.peers, contribs):
                    if g is None:
                        a.skip_gradients()
                    else:
                        if a.kind == "port":
                            g = {k: torch.from_numpy(x.copy()) for k, x in g.items()}
                        a.reduce_gradients(bs, g)
                done = lambda: all(_settled(a) for a in c.peers)
                assert c.pump(done, 30), f"{name} round {r} hung; {c.describe()}"
                if not all(a.has_gradients() for a in c.peers):
                    partial += 1
                    continue  # a virtual batch still filling
                res.append([(a.get_gradient_stats(), _canon(a.gradients())) for a in c.peers])
                for a in c.peers:
                    a.zero_gradients()
            assert res, (f"{name}: no result after {len(rounds)} round(s), "
                         f"{partial} without every peer's result; {c.describe()}")
            out[name] = res
        return out
    finally:
        c.close()


VERSIONS = {"jax": [0, 0, 5, 0], "port": [0, 0, 0, 5]}  # the leader: peer2 / peer3


@pytest.fixture(scope="module", params=["jax", "port"])
def runs(request):
    """(mixed cohort under this broker with a leader of the same package,
    all-JAX cohort with the same names and versions)."""
    _set_bucket_bytes(BUCKET_BYTES)
    try:
        mixed = _session(KINDS, request.param, VERSIONS[request.param])
        ref = _session(["jax"] * N, "jax", VERSIONS[request.param])
    finally:
        _set_bucket_bytes(jax_buckets._DEFAULT_BUCKET_BYTES)
    return request.param, mixed, ref


def test_election_picks_the_all_jax_leader(runs):
    broker, mixed, ref = runs
    want = "peer2" if broker == "jax" else "peer3"
    assert mixed["leader"] == ref["leader"] == [want] * N
    assert mixed["leader_kind"] == broker  # a JAX leader, then a port leader
    assert mixed["version"] == ref["version"] == [5] * N


def test_model_sync_both_directions(runs):
    """Every peer holds the leader's arrays after the sync, with the same
    bytes as in the all-JAX cohort; port receivers committed the blob under
    the sha the leader advertises (a JAX leader's and a port leader's blob
    of the same values hash the same)."""
    broker, mixed, ref = runs
    assert mixed["params"] == ref["params"]
    lead = mixed["params"][2 if broker == "jax" else 3]
    assert all(p == lead for p in mixed["params"])
    assert [s for s in mixed["state"] if s is not None], "no peer received the state"
    assert mixed["state"] == ref["state"]
    assert mixed["leader_sha"] == ref["leader_sha"]
    got = [s for a, s in zip(KINDS, mixed["sha"]) if a == "port" and s is not None]
    assert got and all(s == mixed["leader_sha"] for s in got)


@pytest.mark.parametrize("path", PATHS)
def test_gradients_bitwise_equal_to_all_jax(runs, path):
    _, mixed, ref = runs
    assert len(mixed[path]) == len(ref[path])
    for r, (got, want) in enumerate(zip(mixed[path], ref[path])):
        assert got == want, f"{path} round {r}"
        assert all(peer == got[0] for peer in got), f"{path} round {r}: peers differ"


def test_churn_rounds_are_exact_sums_of_their_epoch():
    """A port peer leaves mid-stream and a fresh port peer rejoins under the
    same name: every result a peer applies in its own epoch is the exact
    mean of that epoch's members' contributions (peer i sends 2**i)."""
    from conftest import grab_port

    c = _Cohort(KINDS, "port", grab_port(), [0] * N)
    try:
        assert c.pump(lambda: all(a.connected() for a in c.peers), 60)
        checked = {"n": 0}
        applied = {a._rpc.get_name(): 0 for a in c.peers}

        def step():
            for a in list(c.peers):
                name = a._rpc.get_name()
                if a.has_gradients():
                    stats = a.get_gradient_stats()
                    g = a.gradients()["w"]
                    g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
                    if a._result_epoch == a._group.sync_id():
                        members = a._group.members()
                        want = sum(2.0 ** int(m[4:]) for m in members) / len(members)
                        assert stats["num_gradients"] == len(members), (stats, members)
                        assert np.all(g == np.float32(want)), (name, g.ravel()[:3], want)
                        checked["n"] += 1
                    a.zero_gradients()
                    applied[name] += 1
                elif a.wants_gradients():
                    v = np.full(SHAPES["w"], 2.0 ** int(name[4:]), np.float32)
                    g = {"w": v, "b": np.zeros(SHAPES["b"], np.float32)}
                    if a.kind == "port":
                        g = {k: torch.from_numpy(x) for k, x in g.items()}
                    try:
                        a.reduce_gradients(1, g)
                    except Exception as e:  # a result landed between the checks
                        assert "unconsumed" in str(e) or "in flight" in str(e), e
            return False

        def run_until(cond, seconds):
            deadline = time.time() + seconds
            while time.time() < deadline and not cond():
                c.pump(step, 0.05)
            assert cond()

        run_until(lambda: min(applied.values()) >= 3, 60)
        leaver = c.peers.pop()  # peer3, a port peer
        leaver.close()
        survivors = {a._rpc.get_name() for a in c.peers}
        base = dict(applied)
        run_until(lambda: all(applied[n] - base[n] >= 3 for n in survivors), 90)
        c.peers.append(c.join("peer3", "port"))
        applied["peer3"] = 0
        run_until(lambda: applied["peer3"] >= 3, 90)
        assert checked["n"] >= 12
    finally:
        c.close()
