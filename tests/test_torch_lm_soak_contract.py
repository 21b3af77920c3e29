"""The two soak contracts of the elastic LM entry point, held against the
JAX package's ``examples/lm.py``:

- with ``MOOLIB_FAULTS`` set, ``train()`` installs the seeded RPC frame
  faults for the process (the chaos soak's phase 2 relies on it), as the
  JAX entry point does under the same spec;
- a distributed-checkpoint run prints the JAX ``ckpt_async:`` exit line,
  which the JAX chaos soak's own parser reads, with the counts ``train()``
  returns.
"""

import json
import os
import subprocess
import sys

import torch

from conftest import grab_port, subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import chaos_soak  # noqa: E402  (the JAX package's soak script: its parser)

torch.set_num_threads(1)

FAULTS = "seed=3,rpc_drop=0.05,rpc_dup=0.05"

# One elastic peer hosting its own broker: its Accumulator's frames cross
# the Rpc transport, so the frame seam sees them.  Prints the installed
# injector's probabilities and counts as one JSON line.
_CHILD = r"""
import json, sys
pkg = sys.argv[1]
argv = ["--address", "127.0.0.1:" + sys.argv[2], "--local_name", "solo", "--steps", "30",
        "--seq_len", "16", "--batch_size", "2", "--d_model", "16", "--layers", "1",
        "--heads", "1", "--vocab", "16", "--log_interval", "10", "--quiet"]
if pkg == "torch":
    from moolib_tpu_torch.examples import lm
    from moolib_tpu_torch.testing import faults
    lm.train(lm.make_flags(argv + ["--device", "cpu", "--attention", "dense"]))
else:
    from moolib_tpu.examples import lm
    from moolib_tpu.testing import faults
    lm.train(lm.make_flags(argv))
# A lone peer's cohort sends few frames: send 200 more through the seam
# the entry point hooked (a dropped call just never answers).
import time
Rpc = __import__(("moolib_tpu_torch" if pkg == "torch" else "moolib_tpu") + ".rpc",
                 fromlist=["Rpc"]).Rpc
a, b = Rpc(), Rpc()
a.set_name("a"); b.set_name("b")
a.define("echo", lambda x: x)
a.listen("127.0.0.1:" + sys.argv[3]); b.connect("127.0.0.1:" + sys.argv[3])
b.sync("a", "echo", 0)
futs = [b.async_("a", "echo", i) for i in range(200)]
time.sleep(1.0)
a.close(); b.close()
f = faults._env_installed
print("INSTALLED " + json.dumps(None if f is None else
      {"drop": f.drop, "dup": f.dup, "hold": f.hold, "counts": f.counts}))
"""


def _installed(pkg: str, tmp_path) -> dict:
    env = subprocess_env(ROOT)
    env.update(MOOLIB_FAULTS=FAULTS, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _CHILD, pkg, str(grab_port()),
                          str(grab_port())], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("INSTALLED ")][-1]
    return json.loads(line[len("INSTALLED "):]), out.stdout


def test_moolib_faults_installs_seeded_frame_faults_like_the_jax_entry_point(tmp_path):
    port, port_out = _installed("torch", tmp_path)
    jax, _ = _installed("jax", tmp_path)
    assert port is not None, "the port's train() installed no frame faults"
    assert jax is not None
    # The same spec gives the same injector, and its counters move in both.
    assert (port["drop"], port["dup"], port["hold"]) == (jax["drop"], jax["dup"], jax["hold"])
    assert (port["drop"], port["dup"], port["hold"]) == (0.05, 0.05, 0.0)
    for counts in (port["counts"], jax["counts"]):
        assert counts["drop"] > 0 and counts["dup"] > 0, counts
    # The port's peer also prints its injector's counts at exit (before the
    # extra frames above), for the soaks that read its log.
    line = [ln for ln in port_out.splitlines() if ln.startswith("frame_faults: ")]
    assert line, port_out[-2000:]
    at_exit = json.loads(line[-1][len("frame_faults: "):])
    assert set(at_exit) == set(port["counts"]) and at_exit["pass"] > 0, at_exit


def test_ckpt_async_line_reads_with_the_jax_parser(tmp_path, capsys, free_port):
    from moolib_tpu_torch.examples import lm

    out = lm.train(lm.make_flags([
        "--address", f"127.0.0.1:{free_port}", "--local_name", "solo", "--shard_grads",
        "--checkpoint_dir", str(tmp_path / "dckpt"), "--checkpoint_interval", "0.05",
        "--steps", "24", "--seq_len", "16", "--batch_size", "2", "--d_model", "16",
        "--layers", "1", "--heads", "1", "--vocab", "16", "--log_interval", "8",
        "--attention", "dense", "--device", "cpu"]))
    log = tmp_path / "peer.log"
    log.write_text(capsys.readouterr().out)
    parsed = chaos_soak._ckpt_async_stats(str(log))
    assert parsed is not None, log.read_text()[-2000:]
    stats = out["checkpoint_stats"]
    assert stats["captures"] >= 1 and stats["commits"] >= 1, stats
    assert parsed["captures"] == stats["captures"] and parsed["commits"] == stats["commits"]
    assert abs(parsed["stall_s"] - stats["stall_s"]) <= 5e-5, (parsed, stats)
    assert parsed["steps"] == out["steps"] - out["start_step"]
    assert parsed["train_s"] > 0
