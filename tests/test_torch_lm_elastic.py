"""Elastic data-parallel LM training in the port: two ``examples.lm``
processes form an Accumulator cohort (leader election, model sync, virtual
batches) and train the TransformerLM together on the CPU — the port of
``tests/test_lm_elastic.py`` with the same sizes and assertions.
"""

import os
import subprocess
import sys
import time

from conftest import grab_port, subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_peer_elastic_lm_cohort(tmp_path):
    port = grab_port()
    env = subprocess_env(ROOT)
    # One torch thread per peer: the two peers share this machine's cores.
    env["OMP_NUM_THREADS"] = "1"
    common = [
        sys.executable, "-m", "moolib_tpu_torch.examples.lm",
        "--steps", "250",
        "--d_model", "32", "--seq_len", "32", "--batch_size", "8",
        "--layers", "2", "--heads", "2",
        "--attention", "dense", "--mesh", "", "--device", "cpu",
        # Global batch = both peers' contributions: one optimizer step per
        # cohort-wide virtual batch, identical on every peer.
        "--virtual_batch_size", "16",
        "--log_interval", "50",
    ]
    logs = [open(tmp_path / f"p{r}.log", "w") for r in range(2)]
    procs = [
        subprocess.Popen(
            common + (
                ["--address", f"127.0.0.1:{port}", "--local_name", "lm0"]
                if r == 0
                else ["--connect", f"127.0.0.1:{port}", "--local_name", "lm1"]
            ),
            stdout=logs[r], stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT,
        )
        for r in range(2)
    ]
    try:
        deadline = time.time() + 420
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    outs = [(tmp_path / f"p{r}.log").read_text() for r in range(2)]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"peer {r} failed:\n{out[-3000:]}"
    # The cohort genuinely formed: step logs report 2 members.
    assert any("cohort=2" in o for o in outs), outs[0][-1000:]
    # Both peers trained: final summary line shows progress over the ~4.13
    # random-chance loss and a nonzero reduction count.
    for r, out in enumerate(outs):
        final = out.strip().splitlines()[-1]
        assert "'steps': 250" in final, (r, final)
        loss = float(final.split("'loss': ")[1].split(",")[0])
        reduces = int(final.split("'reduces': ")[1].split(",")[0])
        assert loss < 3.6, (r, final)  # clearly below the 4.13 chance floor
        assert reduces >= 100, (r, final)
        # devmon's counted step cost gives the elastic step an MFU.
        mfu = final.split("'mfu': ")[1].split(",")[0]
        assert mfu != "None" and float(mfu) > 0, (r, final)


def test_single_device_train_returns_mfu_on_cpu():
    """lm.train() fills ``mfu`` from the ported devmon: the warm-up pass is
    counted once with FlopCounterMode and set against the step time (on the
    CPU against devmon's nominal peak, so only the number's presence and
    sign are checked)."""
    from moolib_tpu_torch.examples import lm
    from moolib_tpu_torch.telemetry import devmon

    devmon.reset_for_tests()
    out = lm.train(lm.make_flags([
        "--mesh", "", "--attention", "dense", "--seq_len", "16", "--batch_size", "4",
        "--d_model", "32", "--layers", "1", "--steps", "6", "--log_interval", "3",
        "--quiet", "--device", "cpu"]))
    assert isinstance(out["mfu"], float) and out["mfu"] > 0, out
    cost = devmon._COST_CACHE
    assert any(k[0] == "lm.step" and v.flops > 0 for k, v in cost.items())
