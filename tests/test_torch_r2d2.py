"""The port's R2D2 example on the CPU: it learns CartPole to the JAX
package's own bar (``tests/test_integration_r2d2.py``: 30,000 steps, more
than 500 SGD steps, mean return above 100) on the device shard, its other
stores (the host buffer, a replay server over Rpc) train, and its entry
points run on CUDA unless the CPU is asked for."""

import numpy as np
import pytest
import torch

from moolib_tpu_torch._device import NoCudaError
from moolib_tpu_torch.examples import r2d2

torch.set_num_threads(1)


def test_r2d2_learns_cartpole():
    stats = r2d2.train(r2d2.make_flags(["--total_steps", "30000", "--quiet",
                                        "--device", "cpu"]))
    assert stats["replay_device"] == "cpu"
    assert stats["sgd_steps"] > 500
    assert stats["mean_episode_return"] > 100, stats["mean_episode_return"]


def test_host_buffer_store_trains():
    stats = r2d2.train(r2d2.make_flags(["--total_steps", "1600", "--min_replay", "32",
                                        "--quiet", "--device", "cpu",
                                        "--device_replay", "false"]))
    assert stats["sgd_steps"] > 0 and np.isfinite(stats["loss"])
    assert "replay_device" not in stats


@pytest.mark.parametrize("device_shard", [False, True])
def test_replay_server_and_peer_store(free_port, device_shard):
    """``serve`` (the host buffer, or ``--device true --shard_device cpu``)
    and a learner whose store is that server (``--replay_peer``)."""
    addr = f"127.0.0.1:{free_port}"
    argv = ["--address", addr, "--capacity", "512"]
    if device_shard:
        argv += ["--device", "true", "--shard_device", "cpu"]
    server = r2d2.start_replay_server(r2d2.make_serve_flags(argv))
    try:
        if device_shard:
            # The shard service answers the cohort endpoints.
            from moolib_tpu_torch import Rpc

            cli = Rpc()
            try:
                cli.set_timeout(10)
                cli.connect(addr)
                assert cli.sync("replay-server", "replay.stats") == {"size": 0, "total": 0.0}
            finally:
                cli.close()
            return
        stats = r2d2.train(r2d2.make_flags(["--total_steps", "1600", "--min_replay", "32",
                                            "--quiet", "--device", "cpu",
                                            "--replay_peer", addr]))
        assert stats["sgd_steps"] > 0 and np.isfinite(stats["loss"])
    finally:
        server.close()


def test_entry_points_raise_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA behaviour cannot show")
    from moolib_tpu_torch.models import RecurrentQNet
    from moolib_tpu_torch.replay import DeviceReplayShard

    for call in (lambda: r2d2.train(r2d2.make_flags(["--total_steps", "16"])),
                 lambda: DeviceReplayShard(8),
                 lambda: RecurrentQNet(2, obs_shape=(4,)),
                 lambda: r2d2.start_replay_server(r2d2.make_serve_flags(
                     ["--address", "127.0.0.1:0", "--device", "true"])),
                 lambda: r2d2.main(["serve", "--address", "127.0.0.1:0", "--device", "true"])):
        with pytest.raises(NoCudaError):
            call()
