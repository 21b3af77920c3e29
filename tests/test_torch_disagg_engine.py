"""Disaggregated prefill: ``ContinuousBatchingEngine(mesh=, prefill_devices=)``
in the port, against the JAX engine, on the CPU.

Two gloo ranks (subprocesses, one spawn for the module) split a ``dp=2``
mesh: rank 0 prefills, rank 1 owns the engine and decodes.  On weights
converted from the flax init (f32, GQA, prompts across bucket boundaries,
a budget-1 request that finishes at prefill):

- the split engine's greedy tokens equal the JAX engine's with ``mesh=``
  over 2 CPU devices and ``prefill_devices=1``, and the port's unsplit
  engine's; after ``set_params`` they equal the unsplit engine's on the
  new weights (the weights reach both halves);
- the K/V bytes that crossed equal the sum of each joined request's
  ``[L, 2, Lb, Hk, hd]`` rows, counted on the owner as staged bytes, none
  as d2d; the prefill rank ran every request's prefill and the owner none.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moolib_tpu import parallel as jpar
from moolib_tpu.engine import ContinuousBatchingEngine as JaxEngine
from moolib_tpu.models.transformer import TransformerLM as JaxLM
from moolib_tpu_torch.models.convert import from_flax
from moolib_tpu_torch.serving import bucket

from conftest import grab_port, subprocess_env

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2, num_layers=2,
          max_len=64, attention="dense", pos_embedding="rotary")
ENGINE = dict(slots=3, block_size=4, max_seq_len=64, max_prompt_len=16)
_rng = np.random.default_rng(5)
# Prompts in buckets 4, 8 and 16; a budget-1 request finishes at prefill.
REQS = [(_rng.integers(1, 64, size=n).astype(np.int32), mn)
        for n, mn in ((3, 1), (6, 4), (11, 3), (3, 7), (16, 2), (9, 5))]

CHILD = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from moolib_tpu_torch import parallel as par
from moolib_tpu_torch.engine import ContinuousBatchingEngine
from moolib_tpu_torch.examples.vtrace.experiment import counters
from moolib_tpu_torch.models.transformer import TransformerLM
from moolib_tpu_torch.ops import flash_attention as fa
rank, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cfg = json.load(open(os.path.join(work, "cfg.json")))
par.initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
mesh = par.make_mesh({"dp": 2}, device_type="cpu")
sd = torch.load(os.path.join(work, "lm.pt"))
calls = []
def model():
    m = TransformerLM(dtype=torch.float32, device="cpu", **cfg["LM"])
    m.load_state_dict(sd)
    orig = m.prefill
    m.prefill = lambda toks: (calls.append(tuple(toks.shape)), orig(toks))[1]
    return m
eng = ContinuousBatchingEngine(model(), mesh=mesh, prefill_devices=1, **cfg["ENGINE"])
reqs = [(np.array(p, np.int32), b) for p, b in cfg["REQS"]]
def drive(e):
    outs, slot_of, pending = {}, {}, list(enumerate(reqs))
    while len(outs) < len(reqs):
        while pending and e.can_accept(len(pending[0][1][0]), pending[0][1][1]):
            i, (p, mn) = pending.pop(0)
            slot, em = e.submit(p, mn)
            if slot is None:
                outs[i] = list(p) + list(em)
            else:
                slot_of[slot] = (i, p)
        for s in e.step()[1]:
            i, p = slot_of.pop(s)
            outs[i] = list(p) + list(e.retire(s))
    return [[int(x) for x in outs[i]] for i in range(len(reqs))]
out = {}
if rank == 0:
    out["follow"] = eng.follow()
else:
    eng.warmup()
    names = ("batcher_d2d_bytes_total", "batcher_staged_bytes_total")
    before = counters(names)
    out["split"] = drive(eng)
    after = counters(names)
    out["bytes"] = {k: after[k] - before[k] for k in names}
    out["stats"] = {k: v for k, v in eng.stats().items() if not isinstance(v, float)}
    out["stats"]["kv_handoff_bytes"] = eng.stats()["kv_handoff_bytes"]
    out["owner_prefills"] = len(calls)
    out["plain"] = drive(ContinuousBatchingEngine(model(), **cfg["ENGINE"]))
    scaled = {k: v * 1.5 for k, v in sd.items()}
    eng.set_params(scaled)
    out["split_scaled"] = drive(eng)
    plain = ContinuousBatchingEngine(model(), **cfg["ENGINE"])
    plain.set_params(scaled)
    out["plain_scaled"] = drive(plain)
    eng.close()
if rank == 0:
    out["prefills"] = len(calls)
json.dump(out, open(os.path.join(work, f"out{rank}.json"), "w"))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def lm():
    jmodel = JaxLM(dtype=jnp.float32, **LM)
    return jmodel, jax.device_get(jmodel.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))


@pytest.fixture(scope="module")
def split_ranks(lm, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("disagg"))
    torch.save(from_flax(lm[1]), os.path.join(work, "lm.pt"))
    json.dump({"LM": LM, "ENGINE": ENGINE, "REQS": [(p.tolist(), b) for p, b in REQS]},
              open(os.path.join(work, "cfg.json"), "w"))
    port = grab_port()
    env = subprocess_env(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(port), work], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        for p in procs:
            o, _ = p.communicate(timeout=180)
            assert p.returncode == 0, o.decode()[-3000:]
    finally:
        for p in procs:
            p.kill()
    return [json.load(open(os.path.join(work, f"out{r}.json"))) for r in range(2)]


def test_split_engine_tokens_match_the_jax_split_engine(lm, split_ranks):
    jmodel, params = lm
    jmesh = jpar.make_mesh({"dp": 2}, devices=jax.devices()[:2])
    jeng = JaxEngine(jmodel, params, mesh=jmesh, prefill_devices=1, **ENGINE)
    outs, slot_of, pending = {}, {}, list(enumerate(REQS))
    while len(outs) < len(REQS):
        while pending and jeng.can_accept(len(pending[0][1][0]), pending[0][1][1]):
            i, (p, mn) = pending.pop(0)
            slot, em = jeng.submit(p, mn)
            if slot is None:
                outs[i] = list(p) + list(em)
            else:
                slot_of[slot] = (i, p)
        for s in jeng.step()[1]:
            i, p = slot_of.pop(s)
            outs[i] = list(p) + list(jeng.retire(s))
    want = [[int(x) for x in outs[i]] for i in range(len(REQS))]
    owner = split_ranks[1]
    assert owner["split"] == want
    assert owner["split"] == owner["plain"]
    # The new weights reached the prefill rank as well as the owner.
    assert owner["split_scaled"] == owner["plain_scaled"] != owner["split"]


def test_split_engine_kv_crossing_is_counted_by_route(split_ranks):
    follower, owner = split_ranks
    L, Hk, hd = LM["num_layers"], LM["num_kv_heads"], LM["d_model"] // LM["num_heads"]
    rows = sum(L * 2 * bucket(len(p), ENGINE["max_prompt_len"]) * Hk * hd * 4
               for p, mn in REQS if mn > 1)
    assert owner["stats"]["kv_handoff_bytes"] == rows
    assert owner["bytes"] == {"batcher_d2d_bytes_total": 0, "batcher_staged_bytes_total": rows}
    assert owner["stats"]["remote_prefills"] == len(REQS)
    assert owner["stats"]["joins"] == sum(mn > 1 for _, mn in REQS)
    # Every prefill ran on the prefill rank: the warm-up's buckets, both
    # passes over REQS (the second after set_params), none on the owner.
    assert owner["owner_prefills"] == 0
    assert follower["follow"] == {"rank": 0, "role": "prefill",
                                  "prefills": follower["prefills"]}
    assert follower["prefills"] == 5 + 2 * len(REQS)  # buckets 1, 2, 4, 8, 16
