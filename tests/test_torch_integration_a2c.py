"""The port's A2C loop learns CartPole on the CPU: the bar of
``tests/test_integration_a2c.py`` (the reference's
test/integration/test_a2c.py:15-35) with its flags and ``--device cpu``:
after 40k steps most trailing 40-episode windows average >= 100 and the
entropy loss stays in (-1, 0)."""

import numpy as np

from moolib_tpu_torch.examples.a2c import make_flags, train


def test_a2c_learns_cartpole(free_port):
    flags = make_flags(
        ["--total_steps", "40000", "--address", f"127.0.0.1:{free_port}", "--quiet",
         "--device", "cpu"]
    )
    stats = train(flags)
    returns = np.asarray(stats["window_returns"])
    assert len(returns) > 50, "too few episodes"
    windows = [returns[i : i + 40].mean() for i in range(len(returns) - 40, len(returns) - 4, 4)]
    good = sum(w >= 100 for w in windows)
    assert good > len(windows) // 2, f"did not learn: windows={windows}"
    assert -1.0 < stats["entropy_loss"] < 0.0
