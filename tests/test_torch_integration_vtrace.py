"""The port's IMPALA loop learns Catch on the CPU: the bar of
``tests/test_integration_vtrace.py::test_impala_runs_and_improves`` with
its flags (EnvPool actors, the device rollout — the default —, Batcher
assembly, the Accumulator, V-trace), run with ``--device cpu``."""

from moolib_tpu_torch.examples.vtrace.experiment import make_flags, train


def test_impala_runs_and_improves(free_port):
    flags = make_flags(
        [
            "--env", "catch",
            "--total_steps", "60000",
            "--actor_batch_size", "16",
            "--batch_size", "4",
            "--virtual_batch_size", "4",
            "--num_env_processes", "2",
            "--address", f"127.0.0.1:{free_port}",
            "--entropy_cost", "0.005",
            "--device", "cpu",
            "--quiet",
        ]
    )
    assert flags.device_rollout  # the reference's default path
    out = train(flags)
    assert out["steps"] >= 60000
    assert out["sgd_steps"] > 100
    assert out["episodes"] > 500
    # Catch random policy is ~-0.6; require clear improvement over random.
    assert out["mean_episode_return"] is not None
    assert out["mean_episode_return"] > -0.45, f"no learning: {out}"
