"""A2C on CartPole: the parts of the JAX package's ``examples/a2c.py`` that
do not need the cohort.

Ported: :func:`a2c_loss` (n-step returns, policy gradient + baseline +
entropy), :func:`make_flags` (the same names and defaults) and the
optimizer (:func:`make_optimizer`: ``clip_by_global_norm(100)`` then
``adam(lr, b1=0, b2=0.99, eps=3e-7)``, ``a2c.py:130-133``).

Not yet ported: :func:`train`, whose loop drives an in-process Broker and a
standalone Accumulator (the cohort plane, slice 4); it exits with that
message.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.returns import discounted_returns, entropy_loss, softmax_cross_entropy
from .common import OptaxOptimizer, adam, clip_by_global_norm, finalize_flags


def a2c_loss(model, batch, initial_core_state, discounting):
    """Policy-gradient + baseline + entropy loss over a [T+1, B] unroll
    (reference loss structure, ``examples/a2c.py:121-164``)."""
    outputs, _ = model(batch, initial_core_state)
    logits = outputs["policy_logits"][:-1]  # [T, B, A]
    values = outputs["baseline"]  # [T+1, B]
    actions = batch["action"][:-1]  # action[t] is taken *from* state t
    rewards = batch["reward"][1:]  # reward[t+1] results from action[t]
    done = batch["done"][1:]
    discounts = (~done).to(torch.float32) * discounting
    returns = discounted_returns(rewards, discounts, values[-1].detach())
    adv = returns - values[:-1]
    pg_loss = torch.mean(softmax_cross_entropy(logits, actions) * adv.detach())
    baseline_loss = 0.5 * torch.mean(adv**2)
    ent_loss = entropy_loss(logits)
    # Reference cost weighting (examples/a2c.py:24-25).
    total = pg_loss + 0.005 * baseline_loss + 0.0006 * ent_loss
    return total, {
        "pg_loss": pg_loss,
        "baseline_loss": baseline_loss,
        "entropy_loss": ent_loss,
    }


def make_optimizer(params, learning_rate: float) -> OptaxOptimizer:
    """Reference optimizer settings (examples/a2c.py:22-27,182-184)."""
    return OptaxOptimizer(
        params, clip_by_global_norm(100.0), adam(learning_rate, b1=0.0, b2=0.99, eps=3e-7)
    )


def make_flags(argv=None):
    p = argparse.ArgumentParser(description="moolib_tpu_torch A2C on CartPole")
    p.add_argument("--total_steps", type=int, default=100_000)
    p.add_argument("--batch_size", type=int, default=2, help="envs per peer")
    p.add_argument("--rollout_length", type=int, default=64)
    p.add_argument("--num_processes", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--discounting", type=float, default=0.99)
    p.add_argument("--virtual_batch_size", type=int, default=None)
    p.add_argument("--address", default="127.0.0.1:4431", help="not yet ported")
    p.add_argument("--connect", default=None, help="not yet ported")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_interval", type=float, default=2.0)
    p.add_argument("--no_lstm", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--watchdog", type=float, default=0.0, help="not yet ported")
    p.add_argument("--compile_cache_dir", default=None, help="not yet ported")
    return finalize_flags(p, argv)


def train(flags, on_stats=None) -> dict:
    """Not yet ported: the loop drives an in-process Broker and a
    standalone Accumulator (the cohort plane, slice 4)."""
    raise SystemExit("train(): not yet ported (slice 4)")


if __name__ == "__main__":
    train(make_flags())
