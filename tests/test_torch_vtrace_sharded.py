"""The port's IMPALA loop on the sharded planes, on the CPU: the Catch
bar of ``tests/test_torch_integration_vtrace.py`` with the sharded
inter-host rounds, the hook-streamed backward and the distributed
checkpoint plane on; and a ``--mesh dp=2`` learner whose two gloo rank
processes end with one set of parameters."""

from moolib_tpu_torch.examples.vtrace.experiment import make_flags, train


def test_impala_sharded_streamed_and_checkpointed_improves(free_port, tmp_path):
    """The same bar with the sharded rounds, the hook-streamed backward and
    the distributed checkpoint plane on (the virtual batch materializes
    the stream, as in the JAX package)."""
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
            "--shard_grads", "--overlap_grads",
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--checkpoint_interval", "2",
        ]
    )
    out = train(flags)
    assert out["accumulator"]["sharded"] is True
    assert out["steps"] >= 60000
    assert out["sgd_steps"] > 100
    assert out["mean_episode_return"] is not None
    assert out["mean_episode_return"] > -0.45, f"no learning: {out}"
    from moolib_tpu_torch.checkpoint import DistributedCheckpointer

    assert DistributedCheckpointer(str(tmp_path / "ckpt")).latest_committed_step() is not None


def test_impala_dp2_mesh_learner_keeps_its_ranks_equal(free_port):
    """``--mesh dp=2``: this process is rank 0 (actors, Batcher,
    Accumulator) and spawns rank 1; every learn broadcasts the batch, each
    rank reduces its dp block's gradients into the mesh, and both ranks
    apply the cohort mean, ending with one parameter sha."""
    flags = make_flags(
        [
            "--env", "catch",
            "--total_steps", "2000",
            "--actor_batch_size", "16",
            "--batch_size", "4",
            "--virtual_batch_size", "4",
            "--num_env_processes", "2",
            "--address", f"127.0.0.1:{free_port}",
            "--device", "cpu",
            "--quiet",
            "--mesh", "dp=2", "--shard_grads",
        ]
    )
    out = train(flags)
    assert out["steps"] >= 2000 and out["sgd_steps"] > 5
    assert [r["params_sha256"] for r in out["ranks"]] == [out["params_sha256"]] * 2
