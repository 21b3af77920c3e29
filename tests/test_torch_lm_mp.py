"""The LM example over model-parallel meshes: the JAX example's learning
bars (``tests/test_lm_example.py``), with the same flags and bars, on the
port's rank processes, and the JAX example's own default command line.

Each run is ``python -m moolib_tpu_torch.examples.lm ... --device cpu`` in
a fresh process (rank 0; it spawns the other ranks itself), one thread a
rank; the summary is its last line of output.
"""

import ast
import os
import subprocess
import sys

import pytest

from conftest import subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_lm(argv, timeout=420) -> dict:
    env = dict(subprocess_env(ROOT), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "moolib_tpu_torch.examples.lm", *argv,
                        "--device", "cpu"], env=env, capture_output=True, text=True,
                       timeout=timeout, cwd=ROOT)
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-4000:])
    return ast.literal_eval(p.stdout.strip().splitlines()[-1])


RING = ["--mesh", "dp=2,sp=4", "--seq_len", "32", "--batch_size", "16", "--steps", "150",
        "--quiet"]


@pytest.mark.parametrize("extra", [[], ["--remat"]], ids=["ring", "remat_ring"])
def test_lm_trains_ring_over_dp_sp_mesh(extra):
    """Ring attention over sp=4 with the batch over dp=2 (8 ranks), with and
    without per-block remat; every rank ends with the same parameters."""
    out = run_lm(RING + extra)
    assert out["acc"] > 0.9, out
    assert out["loss"] < 0.5, out
    assert len({r["params_sha256"] for r in out["ranks"]}) == 1
    assert all(r["ring_hop_seconds"] > 0 for r in out["ranks"])


def test_lm_trains_moe_over_dp_ep_mesh():
    """Expert parallelism end to end: SwitchMoE blocks, experts sharded over
    ep=4, the router's aux loss in the objective, and the model learns."""
    out = run_lm(["--mesh", "dp=2,ep=4", "--attention", "dense", "--moe_experts", "4",
                  "--seq_len", "32", "--batch_size", "16", "--steps", "200", "--quiet"])
    assert out["acc"] > 0.8, out
    ranks = out["ranks"]
    assert len({r["params_sha256"] for r in ranks}) == 1  # the replicated leaves
    for e in range(4):  # each ep block equal across dp
        assert len({r["experts_sha256"] for r in ranks if r["coords"]["ep"] == e}) == 1
    assert len({r["experts_sha256"] for r in ranks}) == 4


def test_lm_trains_pipelined_over_dp_pp_mesh():
    """The circular schedule (pp=2, v=2) with the batch over dp=2."""
    out = run_lm(["--mesh", "dp=2,pp=2", "--attention", "dense", "--layers", "4",
                  "--pp_repeats", "2", "--microbatches", "4", "--seq_len", "32",
                  "--batch_size", "16", "--steps", "150", "--quiet"])
    assert out["acc"] > 0.9, out
    assert len({r["params_sha256"] for r in out["ranks"]}) == 1


def test_jax_default_command_line_runs():
    """No mesh flags: the JAX example's defaults, --mesh dp=2,sp=4
    --attention ring, spawn 8 ranks and train."""
    out = run_lm(["--steps", "3"])
    assert out["steps"] == 3 and len(out["ranks"]) == 8
    assert {tuple(sorted(r["coords"].items())) for r in out["ranks"]} == {
        (("dp", d), ("sp", s)) for d in range(2) for s in range(4)}


def test_ep_mesh_checkpoint_loads_into_the_plain_model(tmp_path):
    """Rank 0 of a dp=2 x ep=2 MoE mesh gathers the experts (and their
    AdamW moments) and writes the whole state in the single-device layout:
    the plain one-process model resumes from it, and so does the mesh."""
    d = str(tmp_path / "ckpt")
    common = ["--attention", "dense", "--moe_experts", "4", "--seq_len", "16",
              "--batch_size", "8", "--quiet", "--checkpoint_dir", d]
    first = run_lm(["--mesh", "dp=2,ep=2", "--steps", "3", *common])
    assert first["checkpoint"]["saves"] >= 1
    plain = run_lm(["--mesh", "", "--steps", "4", *common])
    assert plain["start_step"] == 3 and plain["steps"] == 4
    again = run_lm(["--mesh", "dp=2,ep=2", "--steps", "5", *common])
    assert again["start_step"] == 4 and again["steps"] == 5
    ranks = again["ranks"]
    assert len({r["params_sha256"] for r in ranks}) == 1
    assert len({r["experts_sha256"] for r in ranks}) == 2  # one per ep block
