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


def test_engine_phase_rehearsal(cpu_rehearsal, capsys):
    """The engine phase at d_model 64 with 2 layers on the CPU: traffic (a)
    through an engine replica found through a broker process, parity with
    generate() under the margin rule, traffic (b) through the batch
    replica and the engine replica, the f32 exactness run, the pool drained
    and unmoved, and the profiled windows."""
    res = chip_smoke.phase_engine(
        0, device="cpu",
        lm_cfg=dict(vocab_size=256, d_model=64, num_heads=2, num_layers=2, max_len=96),
        engine_cfg=dict(slots=4, block_size=8, max_prompt_len=32, max_seq_len=96),
        traffic=dict(requests=8, prompt=(4, 32), budgets=(1, 4, 8), b_requests=6,
                     b_prompt=16, b_budgets=(2, 4, 8), b_batch=4, exact_requests=3,
                     window_steps=3))
    assert res["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert res["num_blocks"] == 1 + 4 * 12 and res["pools_data_ptr_stable"]
    # layers x (K, V) x blocks x block_size x heads x head dim x bf16
    assert res["pool_bytes"] == 2 * 2 * 49 * 8 * 2 * 32 * 2
    parity = res["parity"]
    assert parity["replies_equal_generate"] + len(parity["divergences"]) == 8
    assert all(d["gap"] < d["limit"] for d in parity["divergences"])
    assert res["exact_f32"]["replies_equal_generate"] == 3
    assert set(res["arms"]) == {"a_engine", "b_batch", "b_engine"}
    for arm in res["arms"].values():
        assert arm["latency_ms_p99"] >= arm["latency_ms_p50"] > 0 and arm["tokens_per_s"] > 0
        assert arm["decode_ms_per_step"] > 0 and 0 < arm["mean_slot_occupancy"] <= 1
        assert arm["prefill_ms_by_bucket"]
    assert res["arms"]["a_engine"]["decode_steps"] > 0  # and below the budgets' sum (checked)
    phases = [json.loads(ln)["phase"] for ln in capsys.readouterr().out.splitlines()]
    assert phases == ["engine", "engine_profile", "batch_decode_profile"]


def test_serve_timer_times_only_inside_its_block(cpu_rehearsal):
    """The serving clocks wrap ``model.prefill`` and ``engine.step`` inside
    the ``with`` block only: leaving it restores the class methods, so later
    passes over the same objects are untimed."""
    from moolib_tpu_torch.engine import ContinuousBatchingEngine
    from moolib_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(vocab_size=32, d_model=16, num_heads=2, num_layers=1, max_len=16,
                          attention="dense", dtype=torch.float32, device="cpu")
    eng = ContinuousBatchingEngine(model, slots=1, block_size=4, max_prompt_len=8)
    with chip_smoke._ServeTimer(model, eng) as timer:
        eng.submit(np.arange(1, 4, dtype=np.int32), 3)
        eng.step()
    assert [shape for shape, _, _ in timer.prefills] == [(1, 4)] and len(timer.steps) == 1
    assert "prefill" not in vars(model) and "step" not in vars(eng)
    eng.step()
    assert len(timer.prefills) == 1 and len(timer.steps) == 1


# ------------------------------------------------------------------ r2d2

SMALL_QNET = dict(num_actions=3, encoder="impala", channels=(4, 8), hidden_size=16,
                  core_size=8)


def test_r2d2_item_bytes_at_the_full_width_geometry():
    """state [81, 84, 84, 4] uint8 2,286,144 B + done, action, reward 729 B +
    core 2 x [512] f32 4,096 B: 2,290,969 B an item, 9.38 GB for 4096."""
    assert chip_smoke.r2d2_item_bytes() == 2_290_969
    assert chip_smoke.r2d2_item_bytes() * 4096 == 9_383_809_024
    items = chip_smoke.r2d2_items(np.random.default_rng(0), 2, (84, 84, 4), 80, 18, 512)
    assert chip_smoke.payload_bytes(items) == 2 * 2_290_969


def test_r2d2_update_flops_at_the_full_width_geometry():
    """Per frame: the encoder's convs 106,463,232 (bench's count less its
    FC layer and heads), Dense_0 3,964,928, Dense_1 524,288, the LSTM's two
    projections 4,194,304, the heads 19,456; the update is 4 x the forward
    over 81 x 64 frames."""
    from moolib_tpu_torch import bench

    convs = bench.analytic_forward_flops(t1=1, b=1) - 2 * 3872 * 256 - 2 * (256 + 1 + 6) * 7
    assert convs == 106_463_232
    per_frame = chip_smoke.qnet_forward_flops((84, 84, 4), (16, 32, 32), 512, 512, 18, 1)
    assert per_frame == convs + 3_964_928 + 524_288 + 4_194_304 + 19_456
    assert chip_smoke.r2d2_update_flops((84, 84, 4), (16, 32, 32), 512, 512, 18,
                                        81 * 64) == 4 * per_frame * 81 * 64


def test_r2d2_full_width_net_has_the_reference_parameter_count():
    model = chip_smoke.RecurrentQNet(obs_shape=chip_smoke.R2D2_OBS, device="cpu",
                                     **chip_smoke.R2D2_NET)
    assert sum(p.numel() for p in model.parameters()) == 4_452_323
    tree = chip_smoke.qnet_flax_tree(model)["params"]
    assert tree["Dense_0"]["kernel"].shape == (3872, 512)
    assert tree["ImpalaEncoder_0"]["Conv_0"]["kernel"].shape == (3, 3, 4, 16)
    assert tree["Scan_Core_0"]["OptimizedLSTMCell_0"]["hf"]["bias"].shape == (512,)


def test_r2d2_parity_phase_rehearsal(cpu_rehearsal, capsys):
    res = chip_smoke.phase_r2d2_parity(0, device="cpu", obs=(20, 20, 4), T1=3, B=2,
                                       net=SMALL_QNET)
    assert set(res["cases"]) == {"f32", "bf16"}
    for name, case in res["cases"].items():
        errs = dict(case["errors"])
        assert set(errs) == {"q", "core_c", "core_h", "loss", "prio", "grads"}
        assert case["pool_windows_chosen_differently"] == 0  # CPU against CPU
        assert case["pool_largest_gap"] == 0.0 and case["grads_with_own_pool_choices"] >= 0
        # The replayed pools add the overlapping windows' gradients in f32;
        # the CPU's own bf16 pool backward adds them in bf16.
        grads = errs.pop("grads")
        assert max(errs.values()) == 0.0
        assert grads == 0.0 if name == "f32" else grads <= case["tol"]["grads"]
    phases = [json.loads(ln)["phase"] for ln in capsys.readouterr().out.splitlines()]
    assert phases == ["r2d2_parity_case", "r2d2_parity_case", "r2d2_parity"]


def test_r2d2_learner_phase_rehearsal(cpu_rehearsal, monkeypatch, capsys):
    def fake_profile(cycle, cycles):
        for _ in range(cycles):
            cycle()
        return {"parts_device_ms": dict.fromkeys(("add", "sample", "update", "write_back"), 0.0),
                "wall_ms": 1.0, "device_busy_ms": 0.0, "idle_share": 1.0,
                "kernel_launches": 0, "top": [], "flash": []}

    monkeypatch.setattr(chip_smoke, "_r2d2_profile", fake_profile)
    res = chip_smoke.phase_r2d2_learner(0, device="cpu", obs=(20, 20, 4), net=SMALL_QNET,
                                        capacity=32, T=3, B=4, insert=4, pool=8, warmup=2,
                                        cycles=3, profile_cycles=1, target_update_interval=2)
    assert res["ring_bytes"] == 32 * chip_smoke.r2d2_item_bytes((20, 20, 4), 3, 8)
    assert res["step_ms_median"] > 0 and np.isfinite(res["last_loss"])
    assert res["priority_bitexact_200_ops"] and res["duplicates_last_wins"]
    assert res["short_insert_in_bounds"]
    phases = [json.loads(ln)["phase"] for ln in capsys.readouterr().out.splitlines()]
    assert phases == ["r2d2_learner", "r2d2_learner_profile"]


def test_r2d2_replay_phase_rehearsal(capsys):
    res = chip_smoke.phase_r2d2_replay(0, device="cpu", agent_steps=1200)
    cohort = res["cohort"]
    assert cohort["write_once"] and cohort["multicast_ready"]
    assert cohort["ingest_out_bytes"] == 4 * cohort["payload_bytes_per_publish"]
    assert cohort["shard_sizes"] == [64, 64]
    assert res["agent"]["sgd_steps"] > 0 and res["agent"]["replay_device"] == "cpu"


def test_pool_route_replays_the_first_runs_choices():
    """The second run's pools take the inputs the first run's took, and a
    window where they would choose differently is counted: here the second
    run's input is perturbed so one window's maximum moves."""
    x = torch.randn(2, 3, 20, 20, generator=torch.Generator().manual_seed(0))  # pads (0, 1)
    y = x.clone()
    y[0, 0, 0, 0] = y[0, 0, :3, :3].max() + 1.0  # a new maximum in the first window
    route = chip_smoke.PoolRoute()

    def run(t):
        t = t.clone().requires_grad_(True)
        out = chip_smoke.impala_model.max_pool_same(t)
        out.sum().backward()
        return out.detach(), t.grad

    (a, ga), (b, gb) = route.compare(lambda: run(x), lambda: run(y))
    assert chip_smoke.impala_model.max_pool_same is route.pool  # restored
    assert route.flips == 1
    assert route.gap == pytest.approx(1.0)  # the new maximum over the replayed input
    assert torch.equal(ga, gb)  # the same routes
    assert torch.equal(a, chip_smoke.impala_model.max_pool_same(x))
    assert b[0, 0, 0, 0] == x[0, 0, :3, :3].max()  # the first run's input, at y's value


# ------------------------------------------------------ fleet and durability
SMALL_LM_WIDTHS = ["--vocab", "64", "--d_model", "64", "--layers", "2", "--heads", "2"]
SMALL_LM = dict(vocab_size=64, d_model=64, num_heads=2, num_layers=2, max_len=32)


def test_durable_lm_phase_rehearsal(capsys):
    """Three lm.train() runs over one --checkpoint_dir at d_model 64: save at
    10, a bit-exact resume(), resume to 20, fall back past a truncation."""
    res = chip_smoke.phase_durable_lm(0, device="cpu", widths=SMALL_LM_WIDTHS, batch=(4, 32))
    assert res["bit_exact_resume"] and res["corrupt_skipped"] == 1
    assert [r["steps"] for r in res["runs"]] == ["0->10", "10->20", "10->10"]
    assert res["gb_written"] > 0 and all(ms > 0 for ms in res["save_ms"] + res["restore_ms"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] == "durable_lm"


def test_dckpt_lm_phase_rehearsal(capsys, monkeypatch):
    """Two spawned learners at d_model 64 commit a distributed checkpoint;
    the parent restores it as a cohort of one and matches the learners'
    parameters and probe loss."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = chip_smoke.phase_dckpt_lm(0, device="cpu", lm_cfg=SMALL_LM, batch=(4, 32), steps=3,
                                    timeout=300)
    assert res["shard_reports_one_sha"] and res["restored_params_sha_equal"]
    assert res["probe_loss_equal"] and res["committed_step"] >= 1
    assert res["checkpoint_stall_seconds"] and res["checkpoint_write_seconds_mean"] > 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] == "dckpt_lm"


def test_timeline_lm_phase_rehearsal(capsys, monkeypatch, tmp_path):
    """The timeline window over 5 steps and the loopback __telemetry_profile
    window, on the CPU (no kernels: the trace holds CPU operators)."""
    monkeypatch.setenv("MOOLIB_PROFILE_DIR", str(tmp_path))
    res = chip_smoke.phase_timeline_lm(0, device="cpu", widths=SMALL_LM_WIDTHS, batch=(4, 32))
    assert res["steps"] == 5 and res["device_slices"] > 0
    assert sum(res["seconds"].values()) == pytest.approx(res["total_seconds"], rel=0.01)
    assert res["rpc_window"]["trace_bytes"] > 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] == "timeline_lm"


def test_compile_cache_phase_rehearsal(capsys, monkeypatch, tmp_path):
    """Both children against a stand-in nvcc (there is none here): the
    first builds every kernel source, the second loads them all from the
    cache directory.  ctypes cannot load the stand-in's output, so the
    children's load() is replaced by a marker."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text('#!/bin/sh\nout=""\nwhile [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then '
                    'out="$2"; shift; fi; shift; done\nsleep 0.1\necho lib > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(chip_smoke, "_CACHE_CHILD",
                        chip_smoke._CACHE_CHILD.replace("_build.load(n)", "n"))
    res = chip_smoke.phase_compile_cache(timeout=120)
    assert all(s > 0 for s in res["first"]["nvcc_s"].values())
    assert set(res["restart"]["nvcc_s"].values()) == {0.0}
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] == "compile_cache"


def test_anakin_phase_rehearsal(cpu_rehearsal, capsys):
    """The anakin phase at B 8 (4 x 2 actor envs), T 5 on the CPU: every
    check runs (the 'card' is the CPU, so the parity checks compare the CPU
    with itself), and a 20k-frame train() through --env_backend jax, whose
    return is held only to be a number (the bar needs the full budget)."""
    cfg = {"actor_batch_size": 4, "num_actor_batches": 2, "batch_size": 4,
           "virtual_batch_size": 8, "unroll_length": 5}
    res = chip_smoke.phase_anakin(0, device="cpu", cfg=cfg, keys=64, env_steps=30,
                                  frames=20_000, lr=0.01, bar=-1.01)
    assert res["envs"] == 8 and res["unroll_length"] == 5 and res["unroll_equals_step"]
    assert res["threefry_equal"] == ["bits", "fold_in", "randint_-1_2", "randint_0_5", "split_3"]
    assert res["envs_equal"]["catch_flat"]["episodes"] == 8 * (30 // 9)
    unroll = res["unroll"]
    assert unroll["stats_d2h_bytes"] == 8 * (2 * 8 + 3) and unroll["stats_episodes"] > 0
    assert unroll["ms_median"] > 0 and unroll["acting_frames_per_s"] > 0
    assert unroll["boundary_bytes"] == {k: 0 for k in chip_smoke.BOUNDARY}
    train = res["train"]
    assert train["boundary_bytes"] == {k: 0 for k in chip_smoke.BOUNDARY}
    assert train["frames"] >= 20_000 and train["sgd_steps"] > 0 and res["wall_s"] > 0
    assert np.isfinite(train["mean_episode_return"])
    phases = [json.loads(ln)["phase"] for ln in capsys.readouterr().out.splitlines()]
    assert phases == ["anakin", "anakin_profile"]
