"""The port's A2C loop learns CartPole on the CPU: the bar of
``tests/test_integration_a2c.py`` (the reference's
test/integration/test_a2c.py:15-35) with its flags and ``--device cpu``:
after 40k steps most trailing 40-episode windows average >= 100 and the
entropy loss stays in (-1, 0).

Outcome under load: the envs draw their seeds from OS entropy (the JAX
loop's design, kept on purpose: a fixed seed would correlate the batch), so
each run is a different draw and a few fall below the bar.  With 8 runs at
once on this 8-core CPU the port failed 2 of 25 and the JAX package's own
``tests/test_integration_a2c.py`` 1 of 24, every run of both at 312 SGD
steps (40,000 env steps in unrolls of 8 x 16): load does not cut the
learning budget.  The failure message reports the SGD steps."""

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
    assert good > len(windows) // 2, (
        f"did not learn: windows={windows}, sgd_steps={stats['sgd_steps']}")
    assert -1.0 < stats["entropy_loss"] < 0.0
