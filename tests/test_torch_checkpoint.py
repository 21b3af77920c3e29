"""Single-host checkpoints on the port: manifest validation and
newest-intact fallback (the cases of ``tests/test_checkpoint_corrupt.py``),
resume through the examples (``tests/test_checkpoint_resume.py``'s
lifecycle, in process), and the cross-package contract:

- a port checkpoint is ``torch.save`` of CPU tensors and loads with
  ``torch.load``'s default ``weights_only=True``; restored tensors land on
  the caller's device;
- each package's ``verify()`` accepts the other's manifest, and both reject
  the same truncation;
- the JAX package's ``"pickle"`` checkpoint of a small LM's flax params
  restores in the port and, through ``models.convert.from_flax``, gives the
  JAX logits within 1e-5 (f32, dense attention);
- a JAX checkpoint holding optax state is refused with an error naming
  optax, not a failure inside pickle;
- ``examples.lm`` resumes from ``--checkpoint_dir`` with the params and
  AdamW state bit for bit, and falls back past a truncated checkpoint;
  ``examples.vtrace.experiment`` resumes from ``--checkpoint`` (a ``.pkl``
  file or a Checkpointer directory).
"""

import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch

from moolib_tpu_torch import telemetry
from moolib_tpu_torch.checkpoint import Checkpointer, UnsupportedCheckpointError
from moolib_tpu_torch.testing import FaultPlan

torch.set_num_threads(1)


def _counter(name):
    return telemetry.get_registry().counter_values().get(name, 0.0)


def _save3(tmp_path):
    ck = Checkpointer(str(tmp_path / "ckpt"), max_to_keep=5)
    for s in (1, 2, 3):
        ck.save(s, {"x": torch.full((500,), float(s)), "steps": s})
    return ck


def test_manifest_written_and_validates(tmp_path):
    ck = _save3(tmp_path)
    with open(os.path.join(ck.directory, "step_3", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 3 and manifest["format"] == "torch"
    assert "state.pt" in manifest["files"]
    assert all(ck.verify(s) for s in (1, 2, 3))
    assert ck.restore()["steps"] == 3


def test_truncated_payload_falls_back_to_newest_intact(tmp_path):
    ck = _save3(tmp_path)
    before = _counter("checkpoint_corrupt_skipped")
    FaultPlan(0).truncate_checkpoint(ck.directory)  # newest = step 3
    assert not ck.verify(3) and ck.verify(2)
    assert ck.latest_intact_step() == 2
    out = ck.restore()
    assert out is not None and out["steps"] == 2, "did not fall back"
    assert torch.equal(out["x"], torch.full((500,), 2.0))
    assert _counter("checkpoint_corrupt_skipped") == before + 1


def test_manifest_less_partial_dir_is_ignored(tmp_path):
    ck = _save3(tmp_path)
    os.makedirs(os.path.join(ck.directory, "step_9"))
    os.remove(os.path.join(ck.directory, "step_3", "manifest.json"))
    assert ck.all_steps() == [1, 2]
    assert ck.latest_step() == 2
    assert ck.restore()["steps"] == 2


def test_explicit_step_corrupt_falls_back_older(tmp_path):
    ck = _save3(tmp_path)
    FaultPlan(1).truncate_checkpoint(ck.directory, step=3)
    out = ck.restore(step=3)
    assert out is not None and out["steps"] == 2


def test_all_corrupt_returns_none(tmp_path):
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(1, {"x": torch.zeros(100)})
    shutil.rmtree(os.path.join(ck.directory, "step_1"))
    assert ck.restore() is None


def test_keeps_the_last_max_to_keep(tmp_path):
    ck = Checkpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"steps": s})
    assert ck.all_steps() == [3, 4]
    assert os.readlink(os.path.join(ck.directory, "latest")) == "step_4"


def test_adamw_state_round_trips_bit_exact_with_weights_only(tmp_path):
    """The state the LM example saves: a model's state_dict and AdamW's,
    bf16 leaves included; torch.load's default (weights_only) reads it, and
    a target tree (or map_location) names the device the leaves land on."""
    model = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Linear(8, 2))
    model[1].to(torch.bfloat16)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    for _ in range(2):
        opt.zero_grad()
        loss = model[1](model[0](torch.randn(4, 8)).to(torch.bfloat16)).float().square().mean()
        loss.backward()
        opt.step()
    state = {"params": model.state_dict(), "opt_state": opt.state_dict(), "steps": 2}
    ck = Checkpointer(str(tmp_path / "ckpt"))
    path = ck.save(2, state)
    raw = torch.load(os.path.join(path, "state.pt"))  # weights_only by default
    got = ck.restore(target={"params": model.state_dict()})
    for tree in (raw, got):
        for k, v in state["params"].items():
            assert tree["params"][k].dtype == v.dtype and torch.equal(tree["params"][k], v)
        for i, s in state["opt_state"]["state"].items():
            for k, v in s.items():
                assert torch.equal(tree["opt_state"]["state"][i][k], v)
        assert tree["opt_state"]["param_groups"] == state["opt_state"]["param_groups"]
    assert got["params"]["1.weight"].device == torch.device("cpu")


def test_each_package_verifies_the_other(tmp_path):
    from moolib_tpu import checkpoint as jax_checkpoint

    port = Checkpointer(str(tmp_path / "port"))
    port.save(5, {"x": torch.arange(100.0)})
    jax_ck = jax_checkpoint.Checkpointer(str(tmp_path / "jax"), use_orbax=False)
    jax_ck.save(5, {"x": np.arange(100.0)})
    assert jax_checkpoint.Checkpointer(port.directory, use_orbax=False).verify(5)
    assert Checkpointer(jax_ck.directory).verify(5)
    for d in (port.directory, jax_ck.directory):
        FaultPlan(0).truncate_checkpoint(d)
        assert not Checkpointer(d).verify(5)
        assert not jax_checkpoint.Checkpointer(d, use_orbax=False).verify(5)


def test_jax_params_checkpoint_gives_the_jax_logits(tmp_path):
    import jax
    import jax.numpy as jnp

    from moolib_tpu import checkpoint as jax_checkpoint
    from moolib_tpu.models import transformer as jtf
    from moolib_tpu_torch.models import transformer as ttf
    from moolib_tpu_torch.models.convert import from_flax

    cfg = dict(vocab_size=32, d_model=32, num_heads=2, num_layers=2, max_len=16,
               attention="dense")
    tokens = np.random.default_rng(3).integers(0, 32, (2, 16)).astype(np.int32)
    jm = jtf.TransformerLM(dtype=jnp.float32, **cfg)
    params = jm.init(jax.random.key(3), jnp.asarray(tokens))
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    jax_checkpoint.Checkpointer(str(tmp_path), use_orbax=False).save(
        7, {"params": jax.device_get(params), "steps": 7})
    st = Checkpointer(str(tmp_path)).restore()
    assert st["steps"] == 7
    assert all(isinstance(x, np.ndarray) for x in jax.tree_util.tree_leaves(st["params"]))
    tm = ttf.TransformerLM(dtype=torch.float32, device="cpu", **cfg)
    tm.load_state_dict(from_flax(st["params"]))
    with torch.inference_mode():
        got = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # map_location lands the numpy leaves as tensors on that device.
    on_cpu = Checkpointer(str(tmp_path)).restore(map_location="cpu")
    assert all(isinstance(x, torch.Tensor) for x in jax.tree_util.tree_leaves(on_cpu["params"]))


def test_optax_state_is_refused_by_name(tmp_path):
    import optax

    from moolib_tpu import checkpoint as jax_checkpoint

    opt_state = optax.adamw(1e-3).init({"w": np.zeros(4, np.float32)})
    jax_checkpoint.Checkpointer(str(tmp_path), use_orbax=False).save(
        1, {"params": {"w": np.zeros(4, np.float32)}, "opt_state": opt_state, "steps": 1})
    before = _counter("checkpoint_corrupt_skipped")
    with pytest.raises(UnsupportedCheckpointError, match="optax"):
        Checkpointer(str(tmp_path)).restore()
    assert _counter("checkpoint_corrupt_skipped") == before  # refused, not "corrupt"


# ---------------------------------------------------------------- examples


def test_lm_resumes_from_checkpoint_dir(tmp_path):
    """Train 4 steps and save; the next train() restores the params and
    AdamW state bit for bit and runs on to 6; a truncated newest checkpoint
    costs one interval (the third run resumes from step 4)."""
    from moolib_tpu_torch.examples import lm

    ck_dir = str(tmp_path / "ck")
    base = ["--mesh", "", "--attention", "dense", "--device", "cpu", "--seq_len", "16",
            "--batch_size", "4", "--quiet", "--checkpoint_dir", ck_dir,
            "--checkpoint_interval", "1e9"]
    out1 = lm.train(lm.make_flags(base + ["--steps", "4"]))
    assert out1["steps"] == 4 and out1["checkpoint"]["saves"] == 1
    saved = Checkpointer(ck_dir).restore()
    # The resume helper the example uses, into a fresh model and AdamW.
    flags = lm.make_flags(base + ["--steps", "6"])
    model = lm.make_model(flags, torch.device("cpu"))
    opt = lm.make_optimizer(model.parameters(), flags.learning_rate)
    assert lm.resume(Checkpointer(ck_dir), model, opt, torch.device("cpu")) == 4
    again = lm.checkpoint_state(model, opt, 4)
    for k, v in saved["params"].items():
        assert torch.equal(again["params"][k], v)
    for i, s in saved["opt_state"]["state"].items():
        for k, v in s.items():
            assert torch.equal(again["opt_state"]["state"][i][k].cpu(), v)
    out2 = lm.train(flags)
    assert (out2["start_step"], out2["steps"]) == (4, 6)
    assert out2["checkpoint"]["restored_step"] == 4
    assert Checkpointer(ck_dir).all_steps() == [4, 6]
    FaultPlan(0).truncate_checkpoint(ck_dir)
    before = _counter("checkpoint_corrupt_skipped")
    out3 = lm.train(lm.make_flags(base + ["--steps", "5"]))
    assert (out3["start_step"], out3["steps"]) == (4, 5)
    assert _counter("checkpoint_corrupt_skipped") == before + 1


def _tsv_steps(localdir):
    with open(os.path.join(localdir, "logs.tsv")) as f:
        return [float(r["steps_done"]) for r in csv.DictReader(f, delimiter="\t")]


@pytest.mark.parametrize("kind", ["pkl", "dir"])
def test_experiment_checkpoint_then_resume(tmp_path, free_port, kind):
    """The IMPALA example's leader checkpoint: written on the way out, and a
    restart continues the step count (and model version) from it."""
    from moolib_tpu_torch.examples.vtrace import experiment

    ckpt = str(tmp_path / ("agent.pkl" if kind == "pkl" else "agent"))
    common = ["--env", "catch", "--device", "cpu", "--checkpoint", ckpt,
              "--actor_batch_size", "8", "--batch_size", "2", "--virtual_batch_size", "2",
              "--num_env_processes", "1", "--stats_interval", "0.2", "--log_interval", "0.2",
              "--quiet"]
    dir1 = tmp_path / "run1"
    dir1.mkdir()
    out1 = experiment.train(experiment.make_flags(
        common + ["--address", f"127.0.0.1:{free_port}", "--total_steps", "1500",
                  "--localdir", str(dir1)]))
    saved = experiment.load_checkpoint(ckpt, "cpu")
    assert saved["steps"] >= 1500 and saved["model_version"] == out1["model_version"] > 0
    dir2 = tmp_path / "run2"
    dir2.mkdir()
    from conftest import grab_port

    out2 = experiment.train(experiment.make_flags(
        common + ["--address", f"127.0.0.1:{grab_port()}",
                  "--total_steps", str(int(saved["steps"]) + 800), "--localdir", str(dir2)]))
    rows = _tsv_steps(dir2)
    assert rows and rows[0] >= saved["steps"], (rows[:3], saved["steps"])
    assert out2["steps"] > saved["steps"]
    assert out2["model_version"] > saved["model_version"]


def test_lm_elastic_leader_saves_and_a_restart_advertises_the_step(tmp_path):
    """The elastic path: the cohort's leader saves in its finally block; a
    restarted peer restores the newest intact checkpoint and advertises
    its step as the model version (election prefers it)."""
    from conftest import grab_port

    from moolib_tpu_torch.examples import lm

    ck_dir = str(tmp_path / "ck")
    base = ["--mesh", "", "--attention", "dense", "--device", "cpu", "--seq_len", "16",
            "--batch_size", "4", "--quiet", "--checkpoint_dir", ck_dir,
            "--checkpoint_interval", "1e9", "--local_name", "solo"]
    out1 = lm.train(lm.make_flags(base + ["--steps", "3", "--address",
                                          f"127.0.0.1:{grab_port()}"]))
    assert out1["steps"] == 3 and out1["is_leader"] and out1["checkpoint"]["saves"] == 1
    assert Checkpointer(ck_dir).all_steps() == [3]
    out2 = lm.train(lm.make_flags(base + ["--steps", "5", "--address",
                                          f"127.0.0.1:{grab_port()}"]))
    assert out2["start_step"] == 3 and out2["steps"] == 5
    assert out2["model_version"] >= 3 + 2  # advertised the restored step, then applied 2
    assert Checkpointer(ck_dir).all_steps() == [3, 5]
