"""chip_smoke.py's checks that need no card: kernel names from the
machine code, the tensor-core check of the build phase, and the bounds
the kernel line reports; a CPU rehearsal of the IMPALA phases at 20x20
frames, T=3, B=2 with the CUDA calls monkeypatched; a CPU rehearsal of the
cohort phases (ImpalaNet at 20x20 frames over four in-process peers and a
broker process, and two spawned learner processes reducing an LM of
d_model 64 with 2 layers); a CPU rehearsal of the Accumulator phases (two
spawned learner processes each through the examples' own loops: the
IMPALA loop on Catch's 10x5 frames, and the elastic LM of d_model 64 with
2 layers); and the CPU smoke of ``python -m moolib_tpu_torch.bench``."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# Mangled names as cuobjdump prints them (nvcc's name for the anonymous
# namespace, then the kernel): the float32 forward keeps its dtype template
# argument, the other float32 kernels take float pointers.
NS = "_ZN45_GLOBAL__N__6dea7cfa_12_flash_bwd_cu_8cda65cb"
MANGLED = {
    "flash_fwd_wgmma_kernel<bf16,128,causal>":
        NS + "22flash_fwd_wgmma_kernelILi128ELb1EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiif",
    "flash_fwd_kernel<f32,64,full>":
        NS + "16flash_fwd_kernelIfLi64ELb0EEEvPKT_S3_S3_PS1_Pfiiif",
    "flash_bwd_dq_wgmma_kernel<bf16,64,full>":
        NS + "25flash_bwd_dq_wgmma_kernelILi64ELb0EEEvPK13__nv_bfloat16S3_S3_S3_"
        "PKfS5_PS1_iiif",
    "flash_bwd_dq_kernel<f32,128,causal>":
        NS + "19flash_bwd_dq_kernelILi128ELb1EEEvPKfS2_S2_S2_S2_S2_Pfiiif",
    "flash_bwd_dkv_wgmma_kernel<bf16,128,full>":
        NS + "26flash_bwd_dkv_wgmma_kernelILi128ELb0EEEvPK13__nv_bfloat16S3_S3_S3_"
        "PKfS5_PS1_S6_iiif",
    "flash_bwd_dkv_kernel<f32,64,causal>":
        NS + "20flash_bwd_dkv_kernelILi64ELb1EEEvPKfS2_S2_S2_S2_S2_PfS3_iiif",
}

WGMMA = [f"{kernel}<bf16,{d},{mode}>"
         for kernel in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                        "flash_bwd_dkv_wgmma_kernel")
         for d in (64, 128) for mode in ("causal", "full")]


def _complete_report() -> dict:
    """What the build phase reads from a good build: HGMMA in every bf16
    wgmma kernel, the float32 CUDA-core kernels without tensor-core code."""
    report = {name: {"HGMMA": 16, "HMMA": 0} for name in WGMMA}
    for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        for d in (64, 128):
            for mode in ("causal", "full"):
                report[f"{kernel}<f32,{d},{mode}>"] = {"HGMMA": 0, "HMMA": 0}
    return report


@pytest.mark.parametrize("label", sorted(MANGLED))
def test_kernel_label_reads_mangled_names(label):
    assert chip_smoke.kernel_label(MANGLED[label]) == label


def test_check_tensor_cores_passes_on_a_complete_report():
    chip_smoke.check_tensor_cores(_complete_report())


@pytest.mark.parametrize("name", WGMMA)
def test_check_tensor_cores_fails_without_hgmma(name):
    report = _complete_report()
    report[name]["HGMMA"] = 0
    with pytest.raises(AssertionError, match="no HGMMA"):
        chip_smoke.check_tensor_cores(report)


@pytest.mark.parametrize("kernel", ["flash_fwd_kernel", "flash_bwd_dq_kernel",
                                    "flash_bwd_dkv_kernel"])
def test_check_tensor_cores_fails_on_a_bf16_cuda_core_kernel(kernel):
    report = _complete_report()
    report[f"{kernel}<bf16,128,causal>"] = {"HGMMA": 0, "HMMA": 0}
    with pytest.raises(AssertionError, match="CUDA-core"):
        chip_smoke.check_tensor_cores(report)


# At the training shape (16, 1024, 8, 128) bf16 causal: 524,800 attended
# pairs per head, 128 heads; GFLOP, bound ms and what bounds it.
TRAIN_BOUNDS = {"flash_fwd": (34.4, 0.0402, "bytes"),
                "flash_bwd_dq": (51.6, 0.0522, "operations"),
                "flash_bwd_dkv": (68.8, 0.0696, "operations")}


@pytest.mark.parametrize("name", sorted(TRAIN_BOUNDS))
def test_flash_bounds_at_training_shape(name):
    ms, by, ops = chip_smoke.flash_bounds(16, 1024, 8, 128, torch.bfloat16, True)[name]
    gflop, want_ms, want_by = TRAIN_BOUNDS[name]
    assert round(ops / 1e9, 1) == gflop
    assert round(ms, 4) == want_ms
    assert by == want_by


class _FakeEvent:
    """torch.cuda.Event on the host clock, for the CPU rehearsal."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = chip_smoke.time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3

    def synchronize(self):
        pass


class _NumpyToTensorBatcher(chip_smoke.Batcher):
    """On the CPU the Batcher keeps host numpy; the phase reads tensors."""

    def get(self):
        return {k: torch.from_numpy(v) for k, v in super().get().items()}


@pytest.fixture
def cpu_rehearsal(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "Batcher", _NumpyToTensorBatcher)

    def fake_profile(fn, top=10):
        fn()
        return {"wall_ms": 1.0, "device_busy_ms": 0.0, "idle_share": 1.0,
                "kernel_launches": 0, "top": [], "flash": []}

    monkeypatch.setattr(chip_smoke, "device_profile", fake_profile)
    monkeypatch.setattr(chip_smoke, "enqueue_ms", lambda fn, reps: fn() and 0.0)


def test_impala_parity_phase_rehearsal(cpu_rehearsal, capsys):
    res = chip_smoke.phase_impala_parity(0, device="cpu", obs=(20, 20, 4), T1=3, B=2)
    assert set(res["cases"]) == {"impala_ff", "impala_lstm", "actor_critic_lstm",
                                 "impala_ff_bf16"}
    for case in res["cases"].values():
        assert max(case["errors"].values()) == 0.0  # CPU against CPU
        assert np.isfinite(case["loss"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] == "impala_parity"


def test_impala_learner_phase_rehearsal(cpu_rehearsal, capsys):
    pool = chip_smoke.EnvPool(functools.partial(chip_smoke.SyntheticAtariEnv, height=20,
                                                width=20), num_processes=2, batch_size=2,
                              num_batches=2)
    try:
        res = chip_smoke.phase_impala_learner(pool, 0, device="cpu", obs=(20, 20, 4), T=3,
                                              B=2, steps=3, profile_steps=1, learn_steps=3)
    finally:
        pool.close()
    assert res["metric"] == "impala_learner_sps_smoke" and res["steps"] == 3
    assert np.isfinite(res["last_loss"]) and res["frames_per_s"] > 0
    data = res["data_path"]
    assert data["learner_steps"] == 3 and data["frames_equal_shm"]
    assert data["env_steps"] >= 3 * 4 * 2  # three 4-step unrolls of 2 envs
    assert res["flash_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    phases = [json.loads(ln)["phase"] for ln in capsys.readouterr().out.splitlines()]
    assert phases == ["impala_learner", "impala_learner_profile", "impala_learner_data_path"]


def test_bench_cli_smoke_on_the_cpu():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, MOOLIB_BENCH_T="2", MOOLIB_BENCH_B="2")
    proc = subprocess.run([sys.executable, "-m", "moolib_tpu_torch.bench", "--device", "cpu",
                           "--steps", "2", "--warmup", "1"], env=env, cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["metric"] == "impala_learner_sps_smoke" and (row["T"], row["B"]) == (2, 2)
    assert row["platform"] == "cpu" and row["mfu"] is None and row["value"] > 0


def test_max_pool_bytes_at_the_reference_shape():
    """84 -> 42 -> 21 -> 11 at 16, 32, 32 channels over 21 x 32 frames, bf16."""
    frames = 21 * 32
    sizes = [(84 * 84 * 16, 42 * 42 * 16), (42 * 42 * 32, 21 * 21 * 32), (21 * 21 * 32, 11 * 11 * 32)]
    want = sum(2 * (3 * n_in + 2 * n_out) * frames for n_in, n_out in sizes)
    assert chip_smoke.max_pool_bytes((84, 84, 4), (16, 32, 32), frames) == want


def test_cohort_impala_phase_rehearsal(cpu_rehearsal, capsys):
    res = chip_smoke.phase_cohort_impala(0, device="cpu", obs=(20, 20, 4), T1=3, B=2,
                                         rounds=2)
    assert set(res["paths"]) == set(chip_smoke.COHORT_PATHS)
    assert res["leaves"] == 36 and res["peers"] == 4
    for path, row in res["paths"].items():
        assert row["round_ms_median"] > 0 and row["rpc_tx_bytes_per_round"] > 0, path
        if path in chip_smoke.COHORT_WIRE_TOL:
            assert row["max_abs_err"] <= chip_smoke.COHORT_WIRE_TOL[path] * res["max_abs_sum"]
    assert res["stats"]["frames"] == 4 * 3 * 2 and np.isfinite(res["stats"]["mean_loss"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] == "cohort_impala"


def test_cohort_lm_phase_rehearsal(monkeypatch, capsys):
    """Two spawned learner processes on the CPU; a 64 KiB bucket threshold
    puts the small model's gradient on the flat-bucket path the card's
    full-width one takes."""
    monkeypatch.setenv("MOOLIB_BUCKET_THRESHOLD", str(1 << 16))
    cfg = dict(vocab_size=256, d_model=64, num_heads=2, num_layers=2, max_len=64)
    res = chip_smoke.phase_cohort_lm(0, device="cpu", lm_cfg=cfg, batch=(2, 32), rounds=2,
                                     timeout=240)
    assert [r["rank"] for r in res["learners"]] == [0, 1]
    assert all(r["equal_grad_a_plus_grad_b"] for r in res["learners"])
    assert res["payload_bytes"] == 4 * res["gradient_elements"] > (1 << 16)
    assert res["round_s_median"] > 0 and res["algbw_GB_per_s"] > 0
    assert res["learners"][0]["loss"] != res["learners"][1]["loss"]  # own batches
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] == "cohort_lm"


def test_accumulator_impala_phase_rehearsal(capsys, monkeypatch):
    """Two experiment.train() learners on Catch (ImpalaNet (16, 32) on 10x5
    frames), virtual batch 8, to model version 6: equal parameters, zero
    checksum divergences, the joiner synced through the chunked transfer."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned learners share the cores
    res = chip_smoke.phase_accumulator_impala(
        0, device="cpu", sgd_steps=6, timeout=300,
        args=["--env", "catch", "--unroll_length", "5", "--batch_size", "4",
              "--actor_batch_size", "4", "--num_actor_batches", "2",
              "--num_env_processes", "1", "--virtual_batch_size", "8"])
    assert res["model_version"] == 6 and res["params_sha256_equal"]
    assert res["checksum_divergences"] == 0 and res["model_sync"]["bytes"] > 0
    assert res["sgd_steps_per_s"] > 0 and len(res["learners"]) == 2
    for row in res["learners"]:
        assert row["elections"] >= 1 and row["grad_round_ms"] > 0
        assert row["d2h_events"] == row["d2h_staged_calls"] == 0  # no card
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] == "accumulator_impala"


def test_accumulator_lm_phase_rehearsal(capsys, monkeypatch):
    """Two elastic lm.train() learners (d_model 64, 2 layers): learner 0
    steps alone, learner 1 joins and syncs model and AdamW state under the
    leader's sha, then both step together to equal parameters."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = chip_smoke.phase_accumulator_lm(
        0, device="cpu", steps=3, timeout=300,
        args=["--vocab", "64", "--d_model", "64", "--layers", "2", "--heads", "2",
              "--seq_len", "32", "--batch_size", "4", "--virtual_batch_size", "8",
              "--attention", "flash", "--mesh", "", "--learning_rate", "1e-3"])
    assert res["model_version"] == 3 and res["params_sha256_equal"]
    assert res["model_sync"]["bytes"] > 0 and res["model_sync"]["sha"]
    assert all(s > 0 for s in res["step_s"]) and all(m > 0 for m in res["mfu"])
    # the plain attention on the CPU: no kernel launches
    assert all(v == 0 for per in res["launches"].values() for v in per.values())
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] == "accumulator_lm"
