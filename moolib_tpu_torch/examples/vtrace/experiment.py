"""IMPALA (V-trace) agent: the parts of the JAX package's flagship example
(``examples/vtrace/experiment.py``) that do not need the cohort.

Ported: :func:`make_flags` (the same names and defaults),
:func:`make_env_factory`, :func:`make_model`, :func:`compute_loss` and the
optimizer (:func:`make_optimizer`: ``clip_by_global_norm`` then optax's
``rmsprop(lr, 0.99, 0.01)``).  The learner step on the card is
forward + :func:`compute_loss` + backward + ``make_optimizer(...).step()``;
``moolib_tpu_torch.bench`` times it at the reference Atari shape.

Not yet ported: :func:`train`, whose loop drives the Broker, Group and
Accumulator (the cohort plane, slice 4); it exits with that message, and
so do the flags of planes the port does not have yet (:func:`unported`).
"""

from __future__ import annotations

import argparse
import math
from functools import partial

import torch

from ...envs import CartPoleEnv, CatchEnv, SyntheticAtariEnv
from ...models.actor_critic import ActorCriticNet
from ...models.impala import ImpalaNet
from ...ops import vtrace
from ...ops.returns import entropy_loss, softmax_cross_entropy
from .. import common


def make_flags(argv=None):
    p = argparse.ArgumentParser(description="moolib_tpu_torch IMPALA (vtrace)")
    p.add_argument(
        "--env",
        default="catch",
        help="catch | catch_flat | pixel_catch | cartpole | synthetic | "
        "atari:<Game> (needs ale_py) | gym:<gymnasium id> (Discrete actions)",
    )
    p.add_argument("--total_steps", type=int, default=500_000)
    p.add_argument("--actor_batch_size", type=int, default=32)
    p.add_argument("--num_actor_batches", type=int, default=2)
    p.add_argument("--unroll_length", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=8, help="learner batch (unrolls)")
    p.add_argument("--virtual_batch_size", type=int, default=8)
    p.add_argument("--num_env_processes", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--discounting", type=float, default=0.99)
    p.add_argument("--entropy_cost", type=float, default=0.01)
    p.add_argument("--baseline_cost", type=float, default=0.5)
    p.add_argument("--grad_norm_clipping", type=float, default=40.0)
    p.add_argument("--use_lstm", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device, e.g. 'cuda:0' (default cuda; 'cpu' runs on the CPU)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--batcher_max_outstanding", type=int, default=None,
                   help="bound the learn batcher's ready queue (default unbounded)")
    # Flags of the JAX example whose planes the port has not yet, with the
    # JAX defaults; unported() names the ones set and their slice.
    for flag, default in (("address", "127.0.0.1:4431"), ("connect", None),
                          ("broker_addrs", None), ("local_name", None), ("train_id", "impala"),
                          ("checkpoint", None), ("checkpoint_dir", None), ("coordinator", None),
                          ("mesh", None), ("wire_dtype", None), ("trace_dir", None),
                          ("localdir", None), ("compile_cache_dir", None)):
        p.add_argument(f"--{flag}", default=default, help="not yet ported")
    for flag in ("ici", "shard_grads", "chunked", "overlap_grads", "wandb", "autoscale"):
        p.add_argument(f"--{flag}", action="store_true", help="not yet ported")
    for flag, default in (("checkpoint_interval", 600.0), ("stats_interval", 2.0),
                          ("log_interval", 5.0), ("autoscale_interval", 2.0),
                          ("watchdog", 0.0)):
        p.add_argument(f"--{flag}", type=float, default=default, help="not yet ported")
    for flag, default in (("num_processes", None), ("process_id", None), ("actor_mesh", 0),
                          ("autoscale_min", 1), ("autoscale_max", 4)):
        p.add_argument(f"--{flag}", type=int, default=default, help="not yet ported")
    p.add_argument("--device_rollout", type=_bool_flag, default=True,
                   help="device-resident actor pipeline (not yet ported: pass "
                   "--device_rollout false for the host EnvPool + Batcher path)")
    p.add_argument("--env_backend", default="envpool", choices=["envpool", "jax"],
                   help="envpool: host envs in worker processes; jax: on-device "
                   "envs (not yet ported)")
    return common.finalize_flags(p, argv)


def _bool_flag(v) -> bool:
    """argparse-friendly bool: ``--device_rollout false`` works (store_true
    can't express an =false override)."""
    return str(v).strip().lower() not in ("0", "false", "no", "off", "")


def make_env_factory(flags):
    # Envs use OS-entropy seeding (seed=None): a fixed seed here would make
    # every env in every worker replay identical trajectories, silently
    # correlating the whole actor batch. flags.seed still seeds the model.
    if flags.env == "catch":
        return CatchEnv, CatchEnv().num_actions, (10, 5, 1)
    if flags.env == "catch_flat":
        # Board flattened to a (50,) uint8 vector -> ActorCriticNet MLP:
        # per-frame model compute is negligible, so whole-agent SPS measures
        # the actor data plane itself (agent_bench --scale small).
        from ...envs import FlatCatchEnv

        return FlatCatchEnv, FlatCatchEnv.num_actions, (50,)
    if flags.env == "pixel_catch":
        # Catch rendered as a frame: the optimal policy requires *reading the
        # pixels* (ball position only exists in the image), so this is the
        # learnable-from-pixels bar for the ImpalaNet ResNet encoder
        # (VERDICT round-1 ask #7; intent of the reference's Atari flagship).
        factory = partial(CatchEnv, frame_shape=(42, 42))
        return factory, CatchEnv.num_actions, (42, 42, 1)
    if flags.env == "pixel_catch84":
        # The reference's full observation scale: (84, 84, 4) stacked frames
        # (examples/atari/environment.py) through the complete 16/32/32
        # ImpalaNet — the pixel bar at Atari geometry, without ALE.
        factory = _pixel_catch84_factory
        return factory, CatchEnv.num_actions, (84, 84, 4)
    if flags.env == "cartpole":
        return CartPoleEnv, 2, (4,)
    if flags.env.startswith("atari:"):
        # Real ALE (reference examples/atari/environment.py), e.g.
        # --env atari:Pong.  Probe once in the parent for a clear error and
        # for the action count; workers build their own instances.
        from ...envs.atari import create_env

        game = flags.env.split(":", 1)[1]
        probe = create_env(game)
        n, shape = probe.num_actions, probe.observation_shape
        probe.close()
        return partial(create_env, game), n, shape
    if flags.env.startswith("gym:"):
        # Any gymnasium env id with a Discrete action space, e.g.
        # --env gym:CartPole-v1, through the GymEnv protocol adapter.
        from ...envs.atari import GymEnv

        env_id = flags.env.split(":", 1)[1]
        probe = GymEnv(env_id)
        n, shape = probe.num_actions, probe.reset().shape
        probe.close()
        return partial(GymEnv, env_id), n, tuple(shape)
    if flags.env != "synthetic":
        raise ValueError(
            f"unknown --env {flags.env!r} (catch | catch_flat | pixel_catch "
            "| pixel_catch84 | cartpole | synthetic | atari:<Game> | gym:<id>)"
        )
    return SyntheticAtariEnv, 6, (84, 84, 4)


def _pixel_catch84_factory():
    # Module-level (picklable) for EnvPool's forkserver path.
    from ...envs import FrameStack

    return FrameStack(CatchEnv(frame_shape=(84, 84)), num_stack=4)


def make_model(flags, num_actions, obs_shape, device=None, generator=None):
    """ImpalaNet for frames (channels (16, 32, 32), or (16, 32) below 32
    rows), ActorCriticNet for vectors; on ``device`` (CUDA by default)."""
    if len(obs_shape) == 3:
        channels = (16, 32, 32) if obs_shape[0] >= 32 else (16, 32)
        return ImpalaNet(
            num_actions=num_actions, obs_shape=obs_shape, channels=channels,
            use_lstm=flags.use_lstm, device=device, generator=generator,
        )
    return ActorCriticNet(
        num_actions=num_actions, obs_size=math.prod(obs_shape), use_lstm=flags.use_lstm,
        device=device, generator=generator,
    )


def compute_loss(batch, initial_core_state, model, flags):
    """V-trace actor-critic loss over a [T+1, B] learner batch (reference
    ``experiment.py:103-155``).  Returns ``(total, {"pg_loss",
    "baseline_loss", "entropy_loss"})``, all 0-d tensors on the batch's
    device (no host sync)."""
    learner_outputs, _ = model(batch, initial_core_state)
    target_logits = learner_outputs["policy_logits"][:-1]
    baseline = learner_outputs["baseline"]
    bootstrap_value = baseline[-1]

    behavior_logits = batch["policy_logits"][:-1]
    actions = batch["action"][:-1]
    rewards = torch.clamp(batch["reward"][1:], -1, 1)
    done = batch["done"][1:]
    discounts = (~done).to(torch.float32) * flags.discounting

    vt = vtrace.from_logits(
        behavior_logits,
        target_logits,
        actions,
        discounts,
        rewards,
        baseline[:-1],
        bootstrap_value.detach(),
    )
    pg_loss = torch.mean(softmax_cross_entropy(target_logits, actions) * vt.pg_advantages)
    baseline_loss = 0.5 * torch.mean((vt.vs - baseline[:-1]) ** 2)
    ent_loss = entropy_loss(target_logits)
    total = (
        pg_loss
        + flags.baseline_cost * baseline_loss
        + flags.entropy_cost * ent_loss
    )
    return total, {
        "pg_loss": pg_loss,
        "baseline_loss": baseline_loss,
        "entropy_loss": ent_loss,
    }


def make_optimizer(params, flags) -> common.OptaxOptimizer:
    """The JAX example's ``optax.chain(clip_by_global_norm(grad_norm_clipping),
    rmsprop(learning_rate, decay=0.99, eps=0.01))`` (``experiment.py:480-483``)."""
    return common.OptaxOptimizer(
        params,
        common.clip_by_global_norm(flags.grad_norm_clipping),
        common.rmsprop(flags.learning_rate, decay=0.99, eps=0.01),
    )


def unported(flags) -> list:
    """(flag, slice) for every flag set to a plane the port does not have
    yet."""
    out = []
    for flag, slice_ in (("mesh", 9), ("actor_mesh", 9), ("shard_grads", 9),
                         ("overlap_grads", 4), ("ici", 4), ("coordinator", 4),
                         ("wire_dtype", 4), ("checkpoint", 7), ("checkpoint_dir", 7),
                         ("autoscale", 7), ("compile_cache_dir", 7)):
        if flags.get(flag):
            out.append((f"--{flag}", slice_))
    if flags.env_backend == "jax":
        out.append(("--env_backend jax", 10))
    if flags.device_rollout:
        out.append(("--device_rollout", 10))
    return out


def train(flags, on_stats=None) -> dict:
    """Not yet ported: the loop drives the cohort plane (Broker, Group,
    Accumulator), which comes with slice 4."""
    missing = [("train()", 4)] + unported(flags)
    raise SystemExit("; ".join(f"{f}: not yet ported (slice {n})" for f, n in missing))


def main(argv=None):
    train(make_flags(argv))


if __name__ == "__main__":
    main()
