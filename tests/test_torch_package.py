"""The PyTorch port stands alone: no JAX in its imports, CUDA by default.

``moolib_tpu_torch`` must import neither ``jax``/``flax``/``optax`` nor
anything of ``moolib_tpu`` (whose ``import`` alone pulls in jax), and its
entry points must refuse to run on a machine without CUDA unless the caller
asks for the CPU.
"""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "moolib_tpu_torch")
FORBIDDEN = ("jax", "flax", "optax", "moolib_tpu")


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _port_modules():
    for path in _port_sources():
        rel = os.path.relpath(path, ROOT)
        if rel == "chip_smoke.py":
            continue
        mod = rel[: -len(".py")].replace(os.sep, ".")
        yield mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


def test_import_every_module_leaves_jax_out():
    mods = list(_port_modules())
    for mod in ("moolib_tpu_torch.ops.flash_attention", "moolib_tpu_torch.bench",
                "moolib_tpu_torch.batcher", "moolib_tpu_torch.envpool",
                "moolib_tpu_torch.envs", "moolib_tpu_torch.envs.atari",
                "moolib_tpu_torch.examples.a2c", "moolib_tpu_torch.examples.vtrace.experiment",
                "moolib_tpu_torch.models.impala", "moolib_tpu_torch.models.actor_critic",
                "moolib_tpu_torch.ops.returns", "moolib_tpu_torch.ops.vtrace",
                "moolib_tpu_torch.telemetry.recovery", "moolib_tpu_torch.broker",
                "moolib_tpu_torch.group", "moolib_tpu_torch.buckets",
                "moolib_tpu_torch.telemetry.flightrec", "moolib_tpu_torch.telemetry.cohort",
                "moolib_tpu_torch.testing", "moolib_tpu_torch.testing.lockgraph",
                "moolib_tpu_torch.testing.faults", "moolib_tpu_torch.utils.stats",
                "moolib_tpu_torch.accumulator", "moolib_tpu_torch.checkpoint",
                "moolib_tpu_torch.rollout", "moolib_tpu_torch.telemetry.devmon",
                "moolib_tpu_torch.examples.launch", "moolib_tpu_torch.examples.plot",
                "moolib_tpu_torch.serving", "moolib_tpu_torch.telemetry.aggregator",
                "moolib_tpu_torch.engine", "moolib_tpu_torch.engine.engine",
                "moolib_tpu_torch.engine.kv_pool", "moolib_tpu_torch.engine.service",
                "moolib_tpu_torch.ops.paged_attention", "moolib_tpu_torch.models.convert",
                "moolib_tpu_torch.examples.lm_serve", "moolib_tpu_torch.examples.lm",
                "moolib_tpu_torch.replay", "moolib_tpu_torch.replay._metrics",
                "moolib_tpu_torch.replay.host", "moolib_tpu_torch.replay.device",
                "moolib_tpu_torch.replay.ingest", "moolib_tpu_torch.replay.distributed",
                "moolib_tpu_torch.models.qnet", "moolib_tpu_torch.examples.r2d2",
                "moolib_tpu_torch.autoscaler", "moolib_tpu_torch.telemetry.profiling",
                "moolib_tpu_torch.telemetry.timeline", "moolib_tpu_torch.utils.compile_cache",
                "moolib_tpu_torch.utils.batchsize", "moolib_tpu_torch.envs.jax_envs",
                "moolib_tpu_torch.envs._threefry", "moolib_tpu_torch.analysis",
                "moolib_tpu_torch.analysis.core", "moolib_tpu_torch.analysis.checks",
                "moolib_tpu_torch.analysis.cli", "moolib_tpu_torch.analysis.__main__"):
        assert mod in mods, mod
    code = "import sys\n" + "".join(f"import {m}\n" for m in mods) + (
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "assert not bad, bad\n" % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} {name}")
    assert not offenders, offenders


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA behaviour cannot show")


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    from moolib_tpu_torch._device import NoCudaError, resolve
    from moolib_tpu_torch.examples import lm, lm_serve
    from moolib_tpu_torch.models.transformer import TransformerLM

    with pytest.raises(NoCudaError, match="device='cpu'"):
        resolve()
    with pytest.raises(NoCudaError):
        resolve("cuda")
    with pytest.raises(NoCudaError):
        TransformerLM(vocab_size=8, d_model=8, num_heads=2, num_layers=1)
    with pytest.raises(NoCudaError):
        lm_serve.main(["--listen", "127.0.0.1:0"])
    with pytest.raises(NoCudaError):
        lm.train(lm.make_flags(["--mesh", "", "--attention", "flash"]))
    assert resolve("cpu") == torch.device("cpu")
    model = TransformerLM(vocab_size=8, d_model=8, num_heads=2, num_layers=1, device="cpu")
    assert model.device == torch.device("cpu")


def test_rl_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    from moolib_tpu_torch import bench
    from moolib_tpu_torch._device import NoCudaError
    from moolib_tpu_torch.batcher import Batcher
    from moolib_tpu_torch.examples.vtrace import experiment

    flags = experiment.make_flags([])
    for call in (lambda: bench.main([]), bench.build_step, bench.build_learner,
                 lambda: experiment.make_model(flags, 6, (84, 84, 4)),
                 lambda: experiment.make_model(flags, 2, (4,)),
                 lambda: Batcher(2, device="cuda"), lambda: Batcher(2, device="cuda:0")):
        with pytest.raises(NoCudaError):
            call()
    assert experiment.make_model(flags, 2, (4,), device="cpu").device == torch.device("cpu")
    assert Batcher(2)._device is None and Batcher(2, device="cpu")._device is None


def test_unported_paths_say_so(monkeypatch):
    from moolib_tpu_torch.examples import lm_serve
    from moolib_tpu_torch.models import transformer

    # Tensor-parallel serving and disaggregated prefill (--engine --mesh
    # --prefill_devices) are ported: their flags meet the JAX package's
    # errors (a prefill count that leaves no decode rank), before any rank
    # is spawned.
    with pytest.raises(SystemExit, match="--listen and --connect are mutually exclusive"):
        lm_serve.main(["--listen", "x", "--connect", "y", "--localdir", "x", "--mesh", "tp=2"])
    with pytest.raises(ValueError, match=re.escape("actor_devices must be in (0, 2)")):
        lm_serve.main(["--listen", "x", "--engine", "--mesh", "dp=2", "--prefill_devices", "2"])
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="8 devices not divisible by 3"):
        lm_serve.main(["--listen", "x", "--mesh", "dp=3,tp=-1"])
    monkeypatch.delenv("WORLD_SIZE")
    # Ring attention and MoE blocks are ported: a ring model needs its mesh
    # to train and serves through flash; a MoE model refuses generate() and
    # the pipeline, as the JAX package's do.
    ring = transformer.TransformerLM(vocab_size=8, d_model=8, num_heads=2, num_layers=2,
                                     max_len=8, device="cpu", attention="ring")
    flash = transformer.TransformerLM(vocab_size=8, d_model=8, num_heads=2, num_layers=2,
                                      max_len=8, device="cpu", attention="flash")
    flash.load_state_dict(ring.state_dict())
    prompt = torch.tensor([[1, 2, 3]])
    with pytest.raises(ValueError, match="needs mesh= at call time"):
        ring(prompt)
    assert torch.equal(transformer.generate(ring, prompt, 3), transformer.generate(flash, prompt, 3))
    moe = transformer.TransformerLM(vocab_size=8, d_model=8, num_heads=2, num_layers=2,
                                    device="cpu", moe_num_experts=4)
    with pytest.raises(ValueError, match="does not support MoE"):
        transformer.generate(moe, prompt, 2)
    with pytest.raises(ValueError, match="dense/flash attention only"):
        transformer.pipeline_lm_apply(ring, prompt, {"pp": 2}, 1)
    with pytest.raises(ValueError, match="structurally identical blocks"):
        transformer.pipeline_lm_apply(moe, prompt, {"pp": 2}, 1)
    # sharded_generator keeps generate()'s rules (JAX: an explicit rng key
    # for temperature > 0); a tp axis of 1 cuts nothing.
    with pytest.raises(ValueError, match="temperature > 0 needs an explicit torch.Generator"):
        transformer.sharded_generator(flash, 3, {"tp": 1}, temperature=1.0)(prompt)
    # The paged cache's geometry sizes the engine's pools, and a paged model
    # has no dense decode.
    from moolib_tpu_torch.engine import ContinuousBatchingEngine

    model = transformer.TransformerLM(vocab_size=8, d_model=8, num_heads=2, num_layers=1,
                                      max_len=16, device="cpu", kv_num_blocks=8,
                                      kv_block_size=4)
    eng = ContinuousBatchingEngine(model, slots=2)
    assert (eng.pool.num_blocks, eng.block_size) == (8, 4)
    assert tuple(eng.pools_k[0].shape[:2]) == (8, 4)
    with pytest.raises(ValueError, match="decode_step_paged"):
        model.decode_step(torch.zeros((1, 1), dtype=torch.int64), None, None, 0)
    with pytest.raises(ValueError, match="decode_step_paged"):
        transformer.generate(model, torch.zeros((1, 2), dtype=torch.int64), 2)


@pytest.mark.parametrize("argv,exc,named", [
    # --mesh dp=N,tp=M is ported: the JAX example's flag errors.
    (["--mesh", "dp=3,tp=2"], ValueError, "the dp mesh axis size must divide --batch_size"),
    # The Sebulba split is ported: the JAX example's flag rule.
    (["--actor_mesh", "1"], ValueError, "--actor_mesh is the Sebulba split: it needs --mesh"),
    # --mesh dp=N, tp=M, sp=S, --shard_grads, --overlap_grads and
    # --actor_mesh are ported.
    (["--mesh", "tp=2", "--overlap_grads"], ValueError,
     "--overlap_grads is the unmeshed learner's overlap plane"),
    (["--actor_mesh", "1", "--mesh", "dp=2", "--shard_grads"], ValueError,
     "and --env_backend jax (the actor submesh runs on-device envs)"),
    # --checkpoint_dir is the distributed plane of --shard_grads cohorts;
    # the sp axis cuts the unroll's T+1 steps (the JAX example's rule).
    (["--checkpoint_dir", "d", "--shard_grads", "--mesh", "dp=2,sp=2"], ValueError,
     "the sp mesh axis size must divide unroll_length+1"),
])
def test_unported_rl_paths_say_so(argv, exc, named):
    from moolib_tpu_torch.examples.vtrace import experiment

    with pytest.raises(exc, match=re.escape(named)):
        experiment.train(experiment.make_flags(argv))
    if "--checkpoint_dir" in argv:
        # Without --shard_grads it is the JAX example's ValueError.
        with pytest.raises(ValueError, match="requires --shard_grads"):
            experiment.train(experiment.make_flags(["--checkpoint_dir", "d"]))


def test_env_backend_jax_runs_and_actor_mesh_still_says_so(free_port):
    """``--env_backend jax`` is ported: the Anakin loop runs on the CPU (no
    EnvPool workers) and counts every frame; the Sebulba split on top of it
    (``--actor_mesh``, ported) needs ``--mesh``, as in the JAX example."""
    from moolib_tpu_torch.examples.vtrace import experiment

    flags = experiment.make_flags([
        "--env", "catch_proc", "--env_backend", "jax", "--device", "cpu", "--quiet",
        "--total_steps", "2000", "--actor_batch_size", "8", "--unroll_length", "5",
        "--batch_size", "4", "--virtual_batch_size", "4", "--address", f"127.0.0.1:{free_port}"])
    out = experiment.train(flags)
    assert out["steps"] >= 2000 and out["sgd_steps"] > 0 and out["episodes"] > 0
    with pytest.raises(ValueError, match=re.escape("it needs --mesh (devices to split)")):
        experiment.train(experiment.make_flags(["--env_backend", "jax", "--actor_mesh", "1"]))


def test_unported_a2c_train_says_so(no_cuda, tmp_path, monkeypatch):
    """a2c's last JAX-only flag, --compile_cache_dir, is ported: it wires the
    shared kernel build directory before the entry point asks for the card
    (which it then refuses without one)."""
    from moolib_tpu_torch._device import NoCudaError
    from moolib_tpu_torch.examples import a2c
    from moolib_tpu_torch.ops import _build
    from moolib_tpu_torch.utils import compile_cache

    monkeypatch.setattr(compile_cache, "_initialized_dir", None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(NoCudaError):
        a2c.train(a2c.make_flags(["--compile_cache_dir", str(tmp_path / "kc")]))
    assert compile_cache.compile_cache_dir() == str(tmp_path / "kc")
    assert _build.BUILD_DIR == str(tmp_path / "kc")


def test_lockgraph_installs_before_any_other_import():
    """moolib_tpu_torch/__init__.py installs the lock-order graph before it
    imports anything else, so no module-level lock escapes it."""
    with open(os.path.join(PKG, "__init__.py")) as f:
        body = ast.parse(f.read()).body
    stmts = [n for n in body if not isinstance(n, ast.Expr) or not isinstance(
        n.value, ast.Constant)]
    first, second = stmts[0], stmts[1]
    assert isinstance(first, ast.ImportFrom) and first.module == "testing" and first.level == 1
    assert [a.name for a in first.names] == ["lockgraph"]
    assert isinstance(second, ast.Expr) and ast.unparse(second) == "_lockgraph.install_from_env()"


def test_lazy_cohort_exports():
    import moolib_tpu_torch
    from moolib_tpu_torch import buckets, group
    from moolib_tpu_torch.broker import Broker

    assert moolib_tpu_torch.Broker is Broker
    assert moolib_tpu_torch.Group is group.Group
    assert moolib_tpu_torch.AllReduce is group.AllReduce
    assert moolib_tpu_torch.buckets is buckets
    from moolib_tpu_torch import accumulator, rollout

    assert moolib_tpu_torch.Accumulator is accumulator.Accumulator
    assert moolib_tpu_torch.rollout is rollout
    from moolib_tpu_torch import engine, serving

    assert moolib_tpu_torch.engine is engine and moolib_tpu_torch.serving is serving
    with pytest.raises(AttributeError):
        moolib_tpu_torch.AnakinRollout  # noqa: B018 - rollout.AnakinRollout, as in JAX


def test_experiment_mesh_flag_rules_follow_the_jax_example():
    """--overlap_grads is the unmeshed learner's plane, and the dp axis must
    divide the batch (the JAX example's messages); --mesh and the --ici
    plane's --coordinator would both join a process group."""
    from moolib_tpu_torch.examples.vtrace import experiment

    for argv, msg in ((["--mesh", "dp=2", "--overlap_grads"], "unmeshed learner's overlap"),
                      (["--mesh", "dp=3", "--batch_size", "4"], "must divide --batch_size"),
                      (["--mesh", "dp=2", "--coordinator", "tcp://127.0.0.1:1"],
                       "both join a torch.distributed")):
        with pytest.raises(ValueError, match=msg):
            experiment.train(experiment.make_flags(argv + ["--device", "cpu"]))
