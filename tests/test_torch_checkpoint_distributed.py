"""Pod-consistent sharded checkpoints on the port (the cases of
``tests/test_checkpoint_distributed.py``, with tensor state and port
Accumulators), and the cross-package contract:

- a cohort's shard files + committed cohort manifest restore bit-exact,
  identical whatever cohort size reads them (M<N and M>N re-cuts); torn
  artifacts are never eligible; replicas rebuild a lost range; the sharded
  spec names what is lost; async capture never stalls and declines past
  two staging slots;
- the capture is a snapshot: params mutated in place right after
  ``begin_capture`` returns do not reach the shard;
- the blob is the JAX package's: a checkpoint committed by JAX writers
  restores in the port to the same blob (and the reverse), re-cut from 2
  hosts onto 1 and 3 with either package's ``restore_slice``;
- a restored blob may carry bf16 leaves as ml_dtypes arrays or as CPU
  tensors (a writer without ml_dtypes); restore takes both;
- the leader-coordinated protocol commits with port peers whose dict
  insertion orders differ, and a mixed JAX/port two-member cohort commits
  one checkpoint with one digest;
- a restored slice prefills the resumable model-sync stream.

Tolerance: none — every comparison is bitwise (blob bytes, sha256, array
equality).
"""

import hashlib
import os
import pickle
import time

import numpy as np
import pytest
import torch

from moolib_tpu_torch import Accumulator, Broker, buckets, checkpoint, telemetry
from moolib_tpu_torch.checkpoint import DistributedCheckpointer, MissingShardError
from moolib_tpu_torch.testing import FaultPlan

torch.set_num_threads(1)

STATE = {"opt": "shared-state"}
LR = 0.1


def _counter(name):
    return telemetry.get_registry().counter_values().get(name, 0.0)


def _state(seed, n=4096):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(n, generator=g), "b": torch.randn(8, generator=g)}
    return (params, {}, {"opt_state": torch.randn(16, generator=g)})


def _blob(state):
    return pickle.dumps(checkpoint.canonical_tree(checkpoint.host_tree(checkpoint.snapshot(state))),
                        protocol=pickle.HIGHEST_PROTOCOL)


def _write_cohort(ckpt, step, state, world, epoch=0):
    """Every rank writes its shard of the SAME state; leader commits."""
    blob = _blob(state)
    reports = [ckpt.write_shard(step, blob, rank, world, epoch=epoch) for rank in range(world)]
    return blob, reports


def _leaves(tree):
    return checkpoint.nest.tree_leaves(tree)


def _assert_tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# --------------------------------------------------------------- file plane


@pytest.mark.parametrize("world", [2, 3])
def test_cohort_roundtrip_bit_exact(tmp_path, world):
    state = _state(0)
    ck = DistributedCheckpointer(str(tmp_path / "a"))
    blob, reports = _write_cohort(ck, 7, state, world=world)
    ck.commit_cohort(7, reports)
    assert ck.committed_steps() == [7]
    step, got = ck.restore()
    assert step == 7
    _assert_tree_equal(got, state)
    assert ck.last_restored[0] == 7 and ck.last_restored[2] == blob
    ref = DistributedCheckpointer(str(tmp_path / "b"))
    ref_blob, ref_reports = _write_cohort(ref, 7, state, world=1)
    assert ref_blob == blob
    ref.commit_cohort(7, ref_reports)
    assert ref.restore()[0] == 7
    # map_location: the restored leaves as tensors on the caller's device.
    _, on_cpu = ck.restore(map_location="cpu")
    assert all(isinstance(x, torch.Tensor) for x in _leaves(on_cpu))
    _assert_tree_equal(on_cpu, state)


def test_canonical_tree_makes_dict_order_irrelevant():
    a = {"w": np.arange(4.0), "b": {"y": 1, "x": 2}}
    b = {"b": {"x": 2, "y": 1}, "w": np.arange(4.0)}
    pa = pickle.dumps(checkpoint.canonical_tree(a), protocol=pickle.HIGHEST_PROTOCOL)
    pb = pickle.dumps(checkpoint.canonical_tree(b), protocol=pickle.HIGHEST_PROTOCOL)
    assert pa == pb
    assert pickle.dumps(a) != pickle.dumps(b)


def test_torn_manifest_never_eligible(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path))
    s1 = _state(1)
    _, reports = _write_cohort(ck, 1, s1, world=2)
    ck.commit_cohort(1, reports)
    _, reports2 = _write_cohort(ck, 2, _state(2), world=2)
    ck.prepare_commit(2, reports2)
    assert ck.committed_steps() == [1]
    step, got = ck.restore()
    assert step == 1
    _assert_tree_equal(got, s1)
    _, reports3 = _write_cohort(ck, 3, _state(3), world=2)
    ck.commit_cohort(3, reports3)
    assert ck.latest_committed_step() == 3
    torn = FaultPlan(seed=0).tear_cohort_manifest(str(tmp_path), step=3)
    assert torn and torn.endswith("step_3")
    assert ck.committed_steps() == [1]
    assert ck.restore()[0] == 1


def test_truncated_shard_rebuilt_from_replica(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path))
    state = _state(4)
    _, reports = _write_cohort(ck, 5, state, world=2)
    ck.commit_cohort(5, reports)
    victim = FaultPlan(seed=0).truncate_shard(str(tmp_path), step=5, rank=0, range_index=0)
    assert victim is not None and victim.endswith("shard_0_0.bin")
    before = _counter("checkpoint_shard_reconstructions_total")
    step, got = ck.restore()
    assert step == 5
    _assert_tree_equal(got, state)
    assert _counter("checkpoint_shard_reconstructions_total") > before


def test_both_copies_lost_falls_back(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path))
    old = _state(5)
    _, r1 = _write_cohort(ck, 1, old, world=2)
    ck.commit_cohort(1, r1)
    _, r2 = _write_cohort(ck, 2, _state(6), world=2)
    ck.commit_cohort(2, r2)
    sdir = tmp_path / "step_2"
    os.remove(sdir / "shard_0_0.bin")
    os.remove(sdir / "shard_1_0.bin")
    step, got = ck.restore()
    assert step == 1
    _assert_tree_equal(got, old)


def test_sharded_spec_missing_shard_error(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path), spec="sharded")
    blob, reports = _write_cohort(ck, 9, _state(7), world=2)
    ck.commit_cohort(9, reports)
    os.remove(tmp_path / "step_9" / "shard_1_1.bin")
    with pytest.raises(MissingShardError) as ei:
        ck.restore()
    (j, a, b), = ei.value.missing
    assert j == 1 and (a, b) == tuple(buckets.shard_ranges(len(blob), 2, 1)[1])


def test_elastic_recut_m_less_and_more(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path))
    state = _state(8, n=32768)
    blob, reports = _write_cohort(ck, 11, state, world=4)
    ck.commit_cohort(11, reports)
    for new_world in (3, 8):
        reader = DistributedCheckpointer(str(tmp_path))
        step, got = reader.restore()
        assert step == 11
        _assert_tree_equal(got, state)
        slices = []
        for rank in range(new_world):
            step, sha16, start, data, total = reader.restore_slice(rank, new_world)
            assert step == 11 and total == len(blob)
            assert sha16 == hashlib.sha256(blob).hexdigest()[:16]
            a, b = buckets.shard_ranges(len(blob), new_world, 1)[rank]
            assert start == a and data == blob[a:b]
            slices.append(data)
        assert b"".join(slices) == blob


def test_quorum_validation(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path))
    _, reports = _write_cohort(ck, 3, _state(9), world=2)
    with pytest.raises(ValueError, match="quorum incomplete"):
        ck.prepare_commit(3, reports[:1])
    bad = dict(reports[1], blob_sha256="0" * 64)
    with pytest.raises(ValueError, match="not version-consistent"):
        ck.prepare_commit(3, [reports[0], bad])
    assert ck.committed_steps() == []


def test_async_capture_nonstalling_and_bounded(tmp_path, monkeypatch):
    monkeypatch.setenv("MOOLIB_CKPT_WRITE_DELAY", "0.3")
    ck = DistributedCheckpointer(str(tmp_path))
    state = _state(10)
    done = []
    assert ck.begin_capture(step=1, rank=0, world=1, state=state, on_done=done.append)
    assert ck.begin_capture(step=2, rank=0, world=1, state=state, on_done=done.append)
    declined_before = _counter("checkpoint_captures_declined_total")
    assert not ck.begin_capture(step=3, rank=0, world=1, state=state, on_done=done.append)
    assert _counter("checkpoint_captures_declined_total") > declined_before
    deadline = time.time() + 30
    while len(done) < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert [r["step"] for r in done if r] == [1, 2]
    st = ck.stats()
    assert st["captures"] == 2
    assert st["write_s"] >= 0.3
    assert st["stall_s"] < 0.1
    ck.close()


def test_capture_survives_in_place_mutation(tmp_path, monkeypatch):
    """Torch parameters change in place: the optimizer step right after
    begin_capture returns must not reach the shard.  The write is held back
    (chaos delay) so the mutation lands before the worker pickles."""
    monkeypatch.setenv("MOOLIB_CKPT_WRITE_DELAY", "0.2")
    params = {"w": torch.arange(64, dtype=torch.float32), "b": torch.ones(3)}
    opt = {"exp_avg": torch.full((64,), 0.5)}
    want = _blob(({k: v.clone() for k, v in params.items()}, None,
                  {"exp_avg": opt["exp_avg"].clone()}))
    ck = DistributedCheckpointer(str(tmp_path))
    done = []
    assert ck.begin_capture(step=1, rank=0, world=1, state=(params, None, opt),
                            on_done=done.append)
    with torch.no_grad():  # the next "optimizer step", in place
        params["w"].add_(1.0)
        params["b"].mul_(-3.0)
        opt["exp_avg"].zero_()
    deadline = time.time() + 30
    while not done and time.time() < deadline:
        time.sleep(0.01)
    (report,) = done
    assert report["blob_sha256"] == hashlib.sha256(want).hexdigest()
    ck.commit_cohort(1, [report])
    assert ck.restore()[0] == 1 and ck.last_restored[2] == want
    ck.close()


def test_failed_capture_is_reported_not_swallowed(tmp_path):
    """A capture that cannot be written reaches on_done as an error report
    (which aborts the checkpoint epoch), never as a silent None."""
    ck = DistributedCheckpointer(str(tmp_path))
    done = []
    assert ck.begin_capture(step=1, rank=3, world=2, state={"w": torch.zeros(2)},
                            on_done=done.append)
    deadline = time.time() + 30
    while not done and time.time() < deadline:
        time.sleep(0.01)
    assert "error" in done[0] and "outside cohort" in done[0]["error"]
    ck.close()


# ------------------------------------------------------------ cross-package


def _jax_pkg():
    import moolib_tpu.checkpoint as jax_checkpoint

    return jax_checkpoint


def _numpy_state(seed, n=5000):
    rng = np.random.RandomState(seed)
    return ({"w": rng.randn(n).astype(np.float32), "b": rng.randn(8).astype(np.float32)},
            {}, {"opt_state": rng.randn(16).astype(np.float32), "steps": 3})


@pytest.mark.parametrize("new_world", [1, 3])
def test_jax_checkpoint_restores_in_the_port(tmp_path, new_world):
    jc = _jax_pkg()
    state = _numpy_state(1)
    jck = jc.DistributedCheckpointer(str(tmp_path))
    jblob = pickle.dumps(jc.canonical_tree(state), protocol=pickle.HIGHEST_PROTOCOL)
    jck.commit_cohort(4, [jck.write_shard(4, jblob, r, 2) for r in range(2)])
    # The port's blob for the same values, from tensors, is the same bytes.
    tstate = ({k: torch.from_numpy(v) for k, v in state[0].items()}, {},
              {"opt_state": torch.from_numpy(state[2]["opt_state"]), "steps": 3})
    assert _blob(tstate) == jblob
    pck = DistributedCheckpointer(str(tmp_path))
    assert pck.verify(4)
    step, got = pck.restore()
    assert step == 4 and pck.last_restored[2] == jblob
    assert pck.last_restored[1] == hashlib.sha256(jblob).hexdigest()[:16]
    _assert_tree_equal(got, state)
    parts = [pck.restore_slice(r, new_world)[3] for r in range(new_world)]
    assert b"".join(parts) == jblob


@pytest.mark.parametrize("new_world", [1, 3])
def test_port_checkpoint_restores_in_the_jax_package(tmp_path, new_world):
    jc = _jax_pkg()
    state = _state(12)
    pck = DistributedCheckpointer(str(tmp_path))
    pblob, reports = _write_cohort(pck, 6, state, world=2)
    pck.commit_cohort(6, reports)
    jck = jc.DistributedCheckpointer(str(tmp_path))
    assert jck.verify(6)
    step, got = jck.restore()
    assert step == 6 and jck.last_restored[2] == pblob
    _assert_tree_equal(got, state)
    parts = [jck.restore_slice(r, new_world)[3] for r in range(new_world)]
    assert b"".join(parts) == pblob
    # Both packages reject the same truncation.
    FaultPlan(seed=0).truncate_shard(str(tmp_path), step=6, rank=0, range_index=0)
    FaultPlan(seed=0).truncate_shard(str(tmp_path), step=6, rank=1, range_index=0)
    assert not jck.verify(6) and not pck.verify(6)


def test_restore_takes_bf16_as_ml_dtypes_or_as_cpu_tensors(tmp_path):
    """A writer with ml_dtypes pickles bf16 leaves as ml_dtypes arrays, one
    without as CPU tensors; restore reads both (through the restricted
    unpickler) and lands both as torch.bfloat16 on request."""
    import ml_dtypes

    w = torch.linspace(-2, 2, 32).to(torch.bfloat16)
    as_np = {"w": np.array(w.view(torch.int16).numpy().view(ml_dtypes.bfloat16))}
    as_tensor = {"w": w.clone()}
    for i, tree in enumerate((as_np, as_tensor)):
        ck = DistributedCheckpointer(str(tmp_path / str(i)))
        blob = pickle.dumps(checkpoint.canonical_tree(tree), protocol=pickle.HIGHEST_PROTOCOL)
        ck.commit_cohort(1, [ck.write_shard(1, blob, 0, 1)])
        step, got = ck.restore(map_location="cpu")
        assert step == 1 and got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], w)
    # A peer-supplied blob holding any other object is refused.
    ck = DistributedCheckpointer(str(tmp_path / "evil"))
    blob = pickle.dumps({"w": time.sleep})
    ck.commit_cohort(1, [ck.write_shard(1, blob, 0, 1)])
    assert ck.restore() is None


# ------------------------------------------------------ coordination plane


def pump_all(broker, accs):
    broker.update()
    for a in accs:
        a.update()
        if a.wants_state():
            a.set_state(dict(STATE))
        a.checkpoint_tick(state_fn=lambda: dict(STATE))


def wait_until(broker, accs, seconds, cond):
    deadline = time.time() + seconds
    while time.time() < deadline:
        pump_all(broker, accs)
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def make_acc(name, addr, params, pkg=None):
    a = (pkg.Accumulator if pkg is not None else Accumulator)("m", params)
    a._rpc.set_name(name)
    a._rpc.set_timeout(10)
    a._rpc.listen("127.0.0.1:0")
    a._group.set_timeout(8.0)
    a.connect(addr)
    return a


def _copy(v):
    return v.clone() if isinstance(v, torch.Tensor) else v.copy()


def apply_step(a):
    g = a.gradients()
    p = a.parameters()
    a.set_parameters({k: p[k] - LR * g[k] for k in p})
    a.zero_gradients()


def run_rounds(broker, accs, n, seconds=60, history=None):
    start = {id(a): a.model_version() for a in accs}

    def all_done():
        done = True
        for a in accs:
            if a.has_gradients():
                apply_step(a)
                if history is not None and a is accs[0]:
                    history[a.model_version()] = {k: _copy(v) for k, v in a.parameters().items()}
            elif a.model_version() - start[id(a)] < n and a.wants_gradients():
                a.reduce_gradients(1, {k: _copy(v) for k, v in a.parameters().items()})
            if a.model_version() - start[id(a)] < n:
                done = False
        return done

    assert wait_until(broker, accs, seconds, all_done), (
        f"rounds stalled at versions {[a.model_version() for a in accs]}")


def _make_broker(port, pkg=None):
    addr = f"127.0.0.1:{port}"
    broker = (pkg.Broker if pkg is not None else Broker)()
    broker.set_name("broker")
    broker.set_timeout(4.0)
    broker.listen(addr)
    return broker, addr


def _commit_and_check(broker, accs, cks, tmp_path, readers):
    assert wait_until(broker, accs, 40, lambda: all(a.connected() for a in accs))
    for a, c in zip(accs, cks):
        a.enable_distributed_checkpoint(c, interval=0.05, lead_steps=1, timeout=20.0)
    aborts0 = _counter("checkpoint_aborts_total")
    history = {}
    deadline = time.time() + 60
    while all(c.latest_committed_step() is None for c in cks) and time.time() < deadline:
        run_rounds(broker, accs, 1, history=history)
    step = max((c.latest_committed_step() or -1) for c in cks)
    assert step >= 0, "no cohort checkpoint committed"
    assert _counter("checkpoint_aborts_total") == aborts0
    shas = set()
    for reader in readers:
        got_step, (params, _buffers, st) = reader.restore(step=step)
        assert got_step == step and st == STATE
        assert step in history
        _assert_tree_equal(params, history[step])
        shas.add(reader.last_restored[1])
    assert len(shas) == 1
    return step


def test_two_peer_cohort_commits_and_restores(free_port, tmp_path):
    """Two port peers with divergent dict insertion order: the leader opens
    epochs, both capture at the target step, the leader commits, and the
    snapshot restores the cohort's parameters bit-exact."""
    broker, addr = _make_broker(free_port)
    w = torch.arange(256, dtype=torch.float32) / 7
    b = torch.ones(8)
    a0 = make_acc("pA", addr, {"w": w.clone(), "b": b.clone()})
    a1 = make_acc("pB", addr, {"b": b.clone(), "w": w.clone()})
    accs = [a0, a1]
    cks = [DistributedCheckpointer(str(tmp_path)) for _ in accs]
    try:
        _commit_and_check(broker, accs, cks, tmp_path, [DistributedCheckpointer(str(tmp_path))])
    finally:
        broker.close()
        for a in accs:
            a.close()
        for c in cks:
            c.close()


@pytest.mark.parametrize("leader", ["jax", "port"])
def test_mixed_cohort_commits_one_checkpoint(free_port, tmp_path, leader):
    """A JAX peer and a port peer under one broker: whichever leads, the two
    shard reports carry one blob digest, the leader commits the cohort
    manifest, and both packages restore it to the same bytes."""
    import moolib_tpu

    jc = _jax_pkg()
    broker, addr = _make_broker(free_port, moolib_tpu if leader == "jax" else None)
    w = np.arange(512, dtype=np.float32) / 3
    b = np.ones(8, np.float32)
    # The higher model version leads the election.
    ja = make_acc("pJ", addr, {"w": w.copy(), "b": b.copy()}, moolib_tpu)
    pa = make_acc("pP", addr, {"b": torch.from_numpy(b.copy()), "w": torch.from_numpy(w.copy())})
    (ja if leader == "jax" else pa).set_model_version(1)
    accs = [ja, pa]
    cks = [jc.DistributedCheckpointer(str(tmp_path)), DistributedCheckpointer(str(tmp_path))]
    try:
        step = _commit_and_check(broker, accs, cks, tmp_path,
                                 [jc.DistributedCheckpointer(str(tmp_path)),
                                  DistributedCheckpointer(str(tmp_path))])
        import json

        with open(tmp_path / f"step_{step}" / "cohort_manifest.json") as f:
            cohort = json.load(f)
        assert cohort["world"] == 2 and sorted(cohort["shards"]) == ["0", "1"]
        shas = set()
        for r in range(2):
            with open(tmp_path / f"step_{step}" / f"manifest_{r}.json") as f:
                shas.add(json.load(f)["blob_sha256"])
        assert shas == {cohort["blob_sha256"]}
    finally:
        broker.close()
        for a in accs:
            a.close()
        for c in cks:
            c.close()


def test_restored_slice_prefills_model_sync(free_port, tmp_path):
    """A joiner that preloads its re-cut byte slice of the leader's sync
    blob receives those chunks from LOCAL bytes
    (accum_sync_slice_chunks_total) and still converges bit-exact."""
    broker, addr = _make_broker(free_port)
    w = torch.arange(16384, dtype=torch.float32) / 3
    leader = make_acc("pL", addr, {"w": w.clone()})
    leader.set_model_chunk_bytes(1024)
    accs = [leader]
    try:
        assert wait_until(broker, accs, 40, lambda: leader.connected())
        run_rounds(broker, accs, 3)
        version = leader.model_version()
        blob = _blob((leader.parameters(), leader.buffers(), dict(STATE)))
        sha16 = hashlib.sha256(blob).hexdigest()[:16]
        half = len(blob) // 2
        before = _counter("accum_sync_slice_chunks_total")
        joiner = make_acc("pJ", addr, {"w": torch.zeros_like(w)})
        joiner.preload_sync_slice(version, sha16, 0, blob[:half], len(blob))
        accs.append(joiner)
        assert wait_until(broker, accs, 60, lambda: joiner.model_version() >= version), \
            "joiner never synced"
        assert _counter("accum_sync_slice_chunks_total") > before
        _assert_tree_equal(joiner.parameters(), leader.parameters())
    finally:
        broker.close()
        for a in accs:
            a.close()
