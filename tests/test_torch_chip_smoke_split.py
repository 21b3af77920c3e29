"""Rehearsals of chip_smoke.py's slice-9c phases on the CPU, at small
widths: ``sebulba`` (the Sebulba split through the vtrace experiment, four
rank processes) and ``disagg_engine`` (the engine split into a prefill
rank and a decode rank).  Every check of the phases runs; the CPU stands
in for the card, so the kernels' launch counts are 0 and every handoff
byte is staged."""

import json

import numpy as np
import torch

import chip_smoke

torch.set_num_threads(1)


def test_sebulba_phase_rehearsal(capsys, monkeypatch):
    """8 envs over 2 actor ranks, T 5, learner batches of 4 over dp=2."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = {"actor_batch_size": 4, "num_actor_batches": 2, "batch_size": 4,
           "virtual_batch_size": 4, "unroll_length": 5, "mesh": "dp=4", "actor_mesh": 2}
    anakin = {"unroll": {"ms_median": 1.0, "acting_frames_per_s": 2.0},
              "train": {"sps": 3.0, "steady_sps": 4.0}}
    res = chip_smoke.phase_sebulba(0, device="cpu", cfg=cfg, frames=3000, anakin=anakin)
    assert res["route"] == "host" and res["frames"] >= 3000 and res["sgd_steps"] > 0
    assert res["handoff_bytes"] == {"batcher_d2d_bytes_total": 0,
                                    "batcher_staged_bytes_total": res["unrolls"] *
                                    res["unroll_bytes"]}
    assert [a["rank"] for a in res["actors"]] == [0, 1]
    for a in res["actors"]:
        assert a["envs"] == 4 and a["unroll_ms"] > 0 and a["handoff_ms"] >= 0
        assert a["param_refreshes"] == res["param_refreshes"] >= 1
    assert res["acting_frames_per_s"] > 0 and res["learn_step_ms"] > 0
    assert res["anakin"]["unroll_ms"] == 1.0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] == "sebulba"


LM = dict(vocab_size=256, d_model=64, num_heads=2, num_layers=2, max_len=96)
ENGINE = dict(slots=4, block_size=8, max_prompt_len=32, max_seq_len=96)
TRAFFIC = dict(requests=6, prompt=(4, 32), budgets=(1, 4, 8))


def _one_process_replies(seed):
    """Traffic (a) through the unsplit engine on the phase's model."""
    from moolib_tpu_torch.engine import ContinuousBatchingEngine

    lm_cfg = dict(chip_smoke.ENGINE_LM, **LM)
    model = chip_smoke.TransformerLM(dtype=torch.bfloat16, device="cpu",
                                     generator=torch.Generator().manual_seed(seed),
                                     **lm_cfg).eval()
    eng = ContinuousBatchingEngine(model, **dict(chip_smoke.ENGINE, **ENGINE))
    reqs = chip_smoke._engine_requests(np.random.default_rng(seed), lm_cfg["vocab_size"],
                                       dict(chip_smoke.ENGINE_TRAFFIC, **TRAFFIC))
    outs = []
    for prompt, budget in reqs:  # one at a time: a slot's row is independent of the others
        slot, emitted = eng.submit(prompt, budget)
        while slot is not None and eng.active_count():
            if slot in eng.step()[1]:
                emitted = eng.retire(slot)
                break
        outs.append(np.concatenate([prompt, np.asarray(emitted, np.int32)]))
    return outs


def test_disagg_engine_phase_rehearsal(capsys, monkeypatch):
    """6 requests, prompts to 32 tokens (buckets 4 to 32), budgets 1 to 8,
    held to the unsplit engine's replies."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    a = {"latency_ms_p50": 1.0, "latency_ms_p99": 2.0, "tokens_per_s": 3.0,
         "decode_ms_per_step": 4.0}
    engine = {"a_replies": _one_process_replies(0), "arms": {"a_engine": a}}
    res = chip_smoke.phase_disagg_engine(0, device="cpu", engine=engine, lm_cfg=LM,
                                         engine_cfg=ENGINE, traffic=TRAFFIC, timeout=300)
    zero = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert res["launches"] == {"prefill_rank": zero, "decode_rank": zero}
    assert res["replies_equal_one_process"] and res["one_process"] == a
    assert res["kv_bytes"] > 0 and res["handoff_counted"]["batcher_d2d_bytes_total"] == 0
    assert res["handoff_counted"]["batcher_staged_bytes_total"] == res["kv_bytes"]
    assert res["handoffs"] > 0 and res["handoff_ms_per_request"] > 0
    assert res["latency_ms_p99"] >= res["latency_ms_p50"] > 0 and res["tokens_per_s"] > 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] == "disagg_engine"
