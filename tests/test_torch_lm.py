"""The port's LM trainer (examples/lm.py) against the JAX package's.

The optimizer is held to ``optax.adamw`` on identical gradients (after a
loss, gradients differ by roundoff and AdamW's sign-like first step would
amplify it), the batches to the JAX ``make_batch`` for the same seed, and
the whole trainer to the JAX example's learning bar on the copy task.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from moolib_tpu.examples import lm as jlm
from moolib_tpu_torch.examples import lm

torch.set_num_threads(1)


def test_adamw_matches_optax_on_identical_gradients():
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 5), "b": (5,), "scale": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    opt = optax.adamw(3e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = lm.make_optimizer(tp.values(), 3e-3)
    for g in grads:
        up, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, up)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                   rtol=0, err_msg=k)
    assert topt.defaults["weight_decay"] == 1e-4 and len(topt.param_groups) == 1


def test_make_batch_equals_jax_make_batch():
    argv = ["--vocab", "40", "--seq_len", "18", "--batch_size", "5"]
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        np.testing.assert_array_equal(lm.make_batch(a, lm.make_flags(argv)),
                                      jlm.make_batch(b, jlm.make_flags(argv)))


def test_copy_task_loss_matches_jax_loss():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 16, 11)).astype(np.float32)
    tokens = rng.integers(0, 11, (3, 16)).astype(np.int32)
    half = 8
    pred = jnp.asarray(logits)[:, half - 1 : -1]
    tgt = jnp.asarray(tokens)[:, half:]
    logp = jax.nn.log_softmax(pred, axis=-1)
    want = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0].mean()
    want_acc = (pred.argmax(-1) == tgt).mean()
    loss, acc = lm.copy_task_loss(torch.from_numpy(logits), torch.from_numpy(tokens), half)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    assert float(acc) == float(want_acc)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_lm_trains_single_device_on_cpu(attention):
    # The bar of tests/test_lm_example.py::test_lm_trains_dense_single_device.
    stats = []
    out = lm.train(lm.make_flags([
        "--mesh", "", "--attention", attention, "--seq_len", "32", "--batch_size", "16",
        "--steps", "120", "--quiet", "--device", "cpu",
    ]), on_stats=stats.append)
    assert out["acc"] > 0.9, out
    # devmon counts the step's FLOPs once, so the run reports an MFU (on
    # the CPU against the nominal peak: a relative number only).
    assert out["steps"] == 120 and out["mfu"] > 0 and out["tokens_per_s"] > 0
    assert [s["step"] for s in stats] == [50, 100]


def test_lm_trains_with_remat_on_cpu():
    out = lm.train(lm.make_flags([
        "--mesh", "", "--attention", "flash", "--seq_len", "16", "--batch_size", "4",
        "--steps", "4", "--remat", "--remat_policy", "dots", "--quiet", "--device", "cpu",
    ]))
    assert out["steps"] == 4 and np.isfinite(out["loss"])


@pytest.mark.parametrize("argv,exc,match", [
    # Ring, MoE and the pipeline are ported: their flags now meet the JAX
    # example's rules, word for word.
    (["--mesh", "", "--attention", "ring"], ValueError,
     "attention='ring' needs --mesh with an sp axis"),
    (["--mesh", "dp=2", "--attention", "ring"], ValueError,
     "attention='ring' needs an sp axis in --mesh"),
    (["--mesh", "sp=3", "--attention", "ring"], ValueError,
     "the sp axis size must divide --seq_len"),
    (["--mesh", "", "--attention", "dense", "--moe_experts", "4", "--layers", "1"], ValueError,
     "--moe_experts needs --layers >= 2"),
    (["--mesh", "sp=2,pp=2", "--attention", "ring"], ValueError,
     "pipeline (pp) composes with dense/flash, not ring"),
    (["--mesh", "pp=2", "--attention", "dense", "--moe_experts", "2"], ValueError,
     "pipeline (pp) needs identical blocks (no --moe_experts)"),
    (["--mesh", "pp=2", "--attention", "dense", "--layers", "3"], ValueError,
     "--layers must be pp_repeats*pp = 2"),
    # A tp axis is ported (the JAX example's rules), and so are the
    # model-parallel axes inside the elastic cohort: a --shard_grads host
    # keeps the same rules and wording, before it spawns a rank.
    (["--mesh", "dp=3,tp=2", "--attention", "dense"], ValueError,
     "the dp axis size must divide --batch_size"),
    (["--mesh", "dp=2,tp=2", "--attention", "dense", "--checkpoint_dir", "x",
      "--shard_grads", "--connect", "127.0.0.1:1", "--batch_size", "3"], ValueError,
     "the dp axis size must divide --batch_size"),
    (["--mesh", "sp=2,pp=2", "--attention", "ring", "--shard_grads", "--connect",
      "127.0.0.1:1"], ValueError, "pipeline (pp) composes with dense/flash, not ring"),
])
def test_unported_flags_exit_with_a_message(argv, exc, match):
    with pytest.raises(exc, match=re.escape(match)):
        lm.train(lm.make_flags(argv + ["--device", "cpu"]))


def test_flag_rules_follow_the_jax_example():
    """--shard_grads needs the elastic cohort; an elastic run drops the JAX
    mesh and ring defaults, and refuses an explicit mesh without
    --shard_grads (the JAX example's messages)."""
    with pytest.raises(ValueError, match="requires the elastic cohort"):
        lm.train(lm.make_flags(["--mesh", "dp=2", "--shard_grads", "--device", "cpu"]))
    with pytest.raises(ValueError, match="pass --shard_grads for the hierarchical plane"):
        lm.train(lm.make_flags(["--mesh", "dp=2", "--connect", "127.0.0.1:1",
                                "--device", "cpu"]))
    with pytest.raises(ValueError, match="the dp axis size must divide --batch_size"):
        lm.train(lm.make_flags(["--mesh", "dp=3", "--attention", "dense", "--device", "cpu"]))


def test_static_dp_mesh_spawns_its_ranks_and_trains(monkeypatch):
    """``--mesh dp=2`` without a cohort: this process is rank 0 and spawns
    rank 1; both run the same loop (the gradients averaged over dp) and
    learn the copy task."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned rank shares the cores
    out = lm.train(lm.make_flags([
        "--mesh", "dp=2", "--attention", "dense", "--seq_len", "32", "--batch_size", "16",
        "--steps", "60", "--quiet", "--device", "cpu", "--learning_rate", "3e-3"]))
    assert out["steps"] == 60 and out["rank"] == 0 and out["acc"] > 0.9, out


def test_publish_every_feeds_a_jax_model_subscriber(free_port):
    """An elastic learner with --publish_every 2: its leader publishes the
    weights at step 2 on the Accumulator's Rpc, a JAX ModelSubscriber pulls
    them through the broker, and from_flax loads them back into exactly the
    learner's final weights (the run ends at that step)."""
    import hashlib
    import threading

    import moolib_tpu
    from moolib_tpu.serving import ModelSubscriber
    from moolib_tpu_torch.models.convert import from_flax

    addr = f"127.0.0.1:{free_port}"
    got, ready = [], threading.Event()
    sub_rpc = moolib_tpu.Rpc()
    sub_rpc.set_name("replica")
    sub = ModelSubscriber(sub_rpc, "lm0", poll_interval=0.05,
                          on_update=lambda v, payload, t: (got.append((v, payload)), ready.set()))

    def on_stats(s):
        if s["step"] == 2:  # published just before this callback
            sub_rpc.connect(addr)
            sub.start()
            assert ready.wait(60), "the subscriber never pulled a version"

    try:
        out = lm.train(lm.make_flags([
            "--mesh", "", "--attention", "dense", "--seq_len", "16", "--batch_size", "4",
            "--steps", "2", "--log_interval", "2", "--quiet", "--device", "cpu",
            "--address", addr, "--local_name", "lm0", "--publish_every", "2",
        ]), on_stats=on_stats)
    finally:
        sub.stop()
        sub_rpc.close()
    version, payload = got[0]
    assert out["steps"] == 2 and version >= 1 and set(payload) == {"params"}
    sd = from_flax(payload)
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(sd[k].numpy().tobytes())
    assert h.hexdigest() == out["params_sha256"]
    with pytest.raises(SystemExit, match="--publish_every: the leader of an elastic cohort"):
        lm.train(lm.make_flags(["--mesh", "", "--attention", "dense", "--publish_every", "2",
                                "--device", "cpu"]))
