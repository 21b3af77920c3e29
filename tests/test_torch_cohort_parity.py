"""Mixed cohorts: JAX and port peers allreduce together, bit for bit.

Four peers ``peer0..peer3`` alternate between the JAX package and the port
(port peers hand in torch CPU tensors, JAX peers numpy arrays) under a JAX
broker and under a port broker.  On every path — the legacy tree, the flat
buckets, the chunked ring, the bf16 and q8 wires on both, ``meta`` with a
skipping peer, and a user-callable op — each peer's result must be bitwise
equal to an all-JAX cohort's with the same names and inputs.

Tree-family rounds fold children in arrival order, so their inputs are
chosen for exact arithmetic in any order (integers; for q8, one anchor of
127 at the head of every bucket keeps each hop's scale a power of two), and
the comparison pins the protocol rather than a race.  The ring folds in a
fixed order, so its inputs are random floats.  Then one run under epoch
churn: a port peer leaves mid-round and rejoins under the same name; every
round that completes equals the exact numpy sum of its epoch's members.
"""

import time

import numpy as np
import pytest
import torch

import moolib_tpu
import moolib_tpu_torch
from moolib_tpu import buckets as jax_buckets
from moolib_tpu_torch import buckets as port_buckets
from moolib_tpu_torch.utils import nest

torch.set_num_threads(1)

PKG = {"jax": moolib_tpu, "port": moolib_tpu_torch}
N = 4
BUCKET_BYTES = 4096  # 1024 float32 per bucket: every bucketed round has several
ELEMS = 2600


def _max_and_count(a, b):
    """A user-callable op over whole values (not leaf-wise)."""
    return {"w": np.maximum(a["w"], b["w"]), "n": a["n"] + b["n"]}


def _meta_op(a, b):
    return {"n": a["n"] + b["n"], "bs": a["bs"] + b["bs"]}


def _anchored(rng, n):
    """Even integers in [-60, 60] with 127 at each bucket head: every q8 hop
    of a four-peer tree then has a power-of-two scale and exact values."""
    x = (2 * rng.integers(-30, 31, n)).astype(np.float32)
    x[::BUCKET_BYTES // 4] = 127.0
    return x


def _rounds(seed=0):
    """Per path: (name, kwargs, [input of peer i]) — every peer's inputs,
    and which peers skip (value None) on the meta round."""
    rng = np.random.default_rng(seed)

    def ints(lo, hi):
        return [{"w": rng.integers(lo, hi, (ELEMS // 2, 2)).astype(np.float32),
                 "b": rng.integers(lo, hi, 7).astype(np.float32)} for _ in range(N)]

    floats = [{"w": rng.standard_normal((ELEMS // 2, 2)).astype(np.float32),
               "b": rng.standard_normal(7).astype(np.float32)} for _ in range(N)]
    tmpl = {"w": np.zeros((ELEMS // 2, 2), np.float32), "b": np.zeros(7, np.float32)}
    return [
        ("tree", dict(bucketed=False, chunked=False), ints(-1000, 1000)),
        ("bucketed", dict(bucketed=True), ints(-1000, 1000)),
        ("bucketed_bf16", dict(bucketed=True, wire="bfloat16"), ints(-30, 31)),
        ("bucketed_q8", dict(bucketed=True, wire="q8"),
         [{"w": _anchored(rng, ELEMS)} for _ in range(N)]),
        ("ring", dict(chunked=True), floats),
        ("ring_bf16", dict(chunked=True, wire="bfloat16"), floats),
        ("ring_q8", dict(chunked=True, wire="q8"), floats),
        ("bucketed_meta_skip", dict(bucketed=True, meta_op=_meta_op, template=tmpl),
         ints(-1000, 1000)[:3] + [None]),
        ("ring_meta_skip", dict(chunked=True, meta_op=_meta_op, template=tmpl),
         [None] + ints(-1000, 1000)[1:]),
        ("callable", dict(op=_max_and_count),
         [{"w": rng.standard_normal(300).astype(np.float32), "n": i + 1}
          for i in range(N)]),
    ]


def _as_port(value):
    return nest.map(lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x, value)


def _canon(result):
    """A result as comparable bytes: (dtype, shape, bytes) per array leaf."""
    out = []
    for leaf in nest.flatten(result):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.numpy()
        if isinstance(leaf, np.ndarray):
            out.append((leaf.dtype.str, leaf.shape, leaf.tobytes()))
        else:
            out.append(leaf)
    return out


class _Cohort:
    def __init__(self, kinds, broker_kind, port):
        self.addr = f"127.0.0.1:{port}"
        self.broker = PKG[broker_kind].Broker()
        self.broker.set_name("broker")
        self.broker.set_timeout(3.0)
        self.broker.listen(self.addr)
        self.peers = {}
        for i, kind in enumerate(kinds):
            self.join(f"peer{i}", kind)

    def join(self, name, kind):
        pkg = PKG[kind]
        rpc = pkg.Rpc()
        rpc.set_name(name)
        rpc.set_timeout(10)
        rpc.listen("127.0.0.1:0")
        rpc.connect(self.addr)
        g = pkg.Group(rpc, "parity")
        g.set_timeout(20)
        self.peers[name] = (kind, rpc, g)

    def drop(self, name):
        _, rpc, g = self.peers.pop(name)
        g.leave()
        rpc.close()

    def groups(self):
        return [g for _, _, g in self.peers.values()]

    def pump(self, until, seconds=30):
        deadline = time.time() + seconds
        while time.time() < deadline:
            self.broker.update()
            for g in self.groups():
                g.update()
            if until():
                return True
            time.sleep(0.005)
        return until()

    def settled(self):
        gs = self.groups()
        return all(g.active() and g.members() == sorted(self.peers) for g in gs) and \
            len({g.sync_id() for g in gs}) == 1

    def close(self):
        for _, rpc, _g in self.peers.values():
            rpc.close()
        self.broker.close()


def _set_bucket_bytes(n):
    jax_buckets.set_bucket_bytes(n)
    port_buckets.set_bucket_bytes(n)


@pytest.fixture(autouse=True)
def _small_buckets():
    _set_bucket_bytes(BUCKET_BYTES)
    yield
    _set_bucket_bytes(jax_buckets._DEFAULT_BUCKET_BYTES)


def _run(kinds, broker_kind, port):
    """Every path once; returns {path: [canonical result of peer i]}."""
    c = _Cohort(kinds, broker_kind, port)
    try:
        assert c.pump(c.settled), "cohort never converged"
        out = {}
        for name, kw, inputs in _rounds():
            futs = []
            for i, (kind, _, g) in enumerate(c.peers.values()):
                value = inputs[i]
                if kind == "port" and value is not None:
                    value = _as_port(value)
                extra = {}
                if "meta_op" in kw:
                    extra["meta"] = {"n": 1, "bs": i + 1}
                futs.append(g.all_reduce(name, value, **kw, **extra))
            assert c.pump(lambda: all(f.done() for f in futs)), f"{name} hung"
            out[name] = [_canon(f.result(0)) for f in futs]
        return out
    finally:
        c.close()


@pytest.fixture(scope="module")
def all_jax():
    from conftest import grab_port

    _set_bucket_bytes(BUCKET_BYTES)
    try:
        return _run(["jax"] * N, "jax", grab_port())
    finally:
        _set_bucket_bytes(jax_buckets._DEFAULT_BUCKET_BYTES)


@pytest.mark.parametrize("broker", ["jax", "port"])
@pytest.mark.parametrize("cohort", ["mixed", "port"])
def test_cohort_bitwise_equals_all_jax(all_jax, free_port, broker, cohort):
    kinds = ["jax", "port"] * (N // 2) if cohort == "mixed" else ["port"] * N
    got = _run(kinds, broker, free_port)
    assert list(got) == list(all_jax)
    for path, results in all_jax.items():
        # The reference is self-consistent: every JAX peer got the same bytes.
        assert all(r == results[0] for r in results), path
        for i, r in enumerate(got[path]):
            assert r == results[i], f"{path}: peer{i} ({kinds[i]}) differs from all-JAX"


def test_reference_results_are_the_sums():
    """What the all-JAX reference computes, checked against numpy once (so
    the bitwise comparisons above hold the port to sums, not to noise)."""
    for name, kw, inputs in _rounds():
        if name in ("tree", "bucketed", "bucketed_bf16"):
            want = {k: np.sum([x[k] for x in inputs], axis=0, dtype=np.float64)
                    for k in inputs[0]}
            assert all(np.abs(v).max() < 2 ** 24 for v in want.values())
            if name == "bucketed_bf16":
                assert all(np.abs(v).max() <= 256 for v in want.values())


def _contribution(peer_idx, rnd):
    """Peer ``peer_idx``'s round-``rnd`` payload: integers, so a round's
    result is exactly the numpy sum of its members' payloads."""
    base = np.arange(ELEMS, dtype=np.float32) % 7
    return {"w": base + np.float32(peer_idx * 10 + rnd % 5)}


@pytest.mark.parametrize("broker", ["jax", "port"])
def test_mixed_cohort_churn_sum_exact(free_port, broker):
    """A port peer leaves mid-round and rejoins under its name, twice;
    rounds on the bucketed tree, the ring and the ring with the bf16 wire
    keep going.  Every completed round on every peer is bitwise the numpy
    sum of the payloads of the epoch's members; a round cut by the leave
    fails loudly ("group changed") on the peers that stay."""
    paths = [("b", dict(bucketed=True)), ("r", dict(chunked=True)),
             ("h", dict(chunked=True, wire="bfloat16"))]
    c = _Cohort(["jax", "port", "jax", "port"], broker, free_port)
    completed = cancelled = 0
    try:
        assert c.pump(c.settled), "cohort never converged"
        churn = {3: "leave", 5: "join", 8: "leave", 10: "join"}
        for rnd in range(13):
            action = churn.get(rnd)
            if action == "join":
                c.join("peer1", "port")
                assert c.pump(c.settled), "rejoin never converged"
            members = sorted(c.peers)
            tag, kw = paths[rnd % len(paths)]
            futs = {}
            for name, (kind, _, g) in c.peers.items():
                value = _contribution(int(name[4:]), rnd)
                futs[name] = g.all_reduce(f"{tag}{rnd}", _as_port(value)
                                          if kind == "port" else value, **kw)
            if action == "leave":
                c.drop("peer1")  # mid-round: its own op dies with the leave
                futs.pop("peer1")
            assert c.pump(lambda: all(f.done() for f in futs.values())), f"round {rnd} hung"
            want = np.sum([_contribution(int(m[4:]), rnd)["w"] for m in members],
                          axis=0, dtype=np.float64).astype(np.float32)
            for name, f in futs.items():
                if f.exception() is not None:
                    assert "group changed" in str(f.exception()), f.exception()
                    cancelled += 1
                    continue
                got = np.asarray(f.result(0)["w"])
                assert got.tobytes() == want.tobytes(), (rnd, name)
                completed += 1
            if action == "leave":
                assert c.pump(c.settled), "cohort never re-formed after the leave"
        assert completed >= 30 and cancelled > 0, (completed, cancelled)
    finally:
        c.close()
