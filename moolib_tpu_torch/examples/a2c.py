"""A2C on CartPole: the port of the JAX package's ``examples/a2c.py``.

An EnvPool of CartPole environments, an in-process Broker and a standalone
Accumulator drive the full wants/has protocol — n-step returns, policy
gradient + baseline + entropy loss (:func:`a2c_loss`) — with the
reference's optimizer (:func:`make_optimizer`: ``clip_by_global_norm(100)``
then ``adam(lr, b1=0, b2=0.99, eps=3e-7)``, ``a2c.py:130-133``).

Run: ``python -m moolib_tpu_torch.examples.a2c --total_steps 100000``
(``--device cpu`` without a card).  Multi-peer: start a broker
(``python -m moolib_tpu_torch.broker``), then several ``--connect
host:port`` processes.
"""

from __future__ import annotations

import argparse
import time
from functools import partial
from typing import Optional

import numpy as np
import torch

from .. import Accumulator, Broker, telemetry
from .._device import resolve
from ..envpool import EnvPool
from ..envs import CartPoleEnv
from ..models.actor_critic import ActorCriticNet
from ..ops.returns import discounted_returns, entropy_loss, softmax_cross_entropy
from ..utils.profiling import StepTimer
from ..watchdog import Watchdog
from .common import (OptaxOptimizer, adam, clip_by_global_norm, copy_into,
                     finalize_flags)


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
    p.add_argument("--address", default="127.0.0.1:4431")
    p.add_argument("--connect", default=None, help="broker address (no in-process broker)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_interval", type=float, default=2.0)
    p.add_argument("--no_lstm", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--watchdog", type=float, default=0.0,
                   help="deadman seconds per loop section (0 = off)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs on the CPU)")
    p.add_argument("--compile_cache_dir", default=None,
                   help="shared kernel build directory (also MOOLIB_COMPILE_CACHE)")
    return finalize_flags(p, argv)


def train(flags, on_stats=None) -> dict:
    """Full training loop; returns final stats (for the integration test)."""
    from ..utils import init_compile_cache

    # Before the first kernel load (no-op when neither knob is set).
    init_compile_cache(flags.compile_cache_dir)
    device = resolve(flags.device)
    telemetry.init_from_env()  # opt-in exporters (docs/TELEMETRY.md)
    from ..testing import faults as _faults

    _faults.install_from_env()  # opt-in chaos (MOOLIB_FAULTS; no-op unset)
    # EnvPool forks before this process touches the card (the reference's
    # early fork server, src/env.cc:149-169).
    envs = EnvPool(
        # 200-step cap = CartPole-v0, the reference's task (examples/a2c.py:117).
        # seed=None: OS entropy per env — a fixed seed would correlate the
        # whole batch. flags.seed still seeds the model/policy.
        partial(CartPoleEnv, max_episode_steps=200),
        num_processes=flags.num_processes,
        batch_size=flags.batch_size,
        num_batches=1,
    )

    model = ActorCriticNet(num_actions=2, obs_size=4, use_lstm=not flags.no_lstm,
                           device=device, generator=torch.Generator().manual_seed(flags.seed))
    named = dict(model.named_parameters())
    opt = make_optimizer(named.values(), flags.learning_rate)
    act_gen = torch.Generator(device=device).manual_seed(flags.seed + 1)
    B, T = flags.batch_size, flags.rollout_length

    broker: Optional[Broker] = None
    if flags.connect is None:
        broker = Broker()
        broker.set_name("broker")
        broker.listen(flags.address)
        broker_addr = flags.address
    else:
        broker_addr = flags.connect

    accumulator = Accumulator("a2c", named, buffers=None)
    accumulator.listen("127.0.0.1:0")
    if flags.virtual_batch_size:
        accumulator.set_virtual_batch_size(flags.virtual_batch_size)
    accumulator.connect(broker_addr)

    stats = {
        "mean_episode_return": 0.0,
        "episodes": 0,
        "steps": 0,
        "sgd_steps": 0,
        "pg_loss": 0.0,
        "entropy_loss": 0.0,
    }
    window_returns: list = []
    episode_return = np.zeros(B, np.float64)

    core_state = model.initial_state(B)
    action = torch.zeros((B,), dtype=torch.int64, device=device)
    action_np = np.zeros((B,), np.int64)
    prev_action = action
    steps_collected = []
    # Latest learn-step aux, kept on the card: fetched at the log tick
    # instead of a float() sync on every SGD step.
    pending_aux = None
    last_log = time.time()
    start = time.time()
    timer = StepTimer()
    wd = Watchdog(timeout=flags.watchdog, name="a2c")

    def _fetch_aux():
        pg_v, ent_v = torch.stack(pending_aux).tolist()
        stats["pg_loss"] = float(pg_v)
        stats["entropy_loss"] = float(ent_v)

    try:
        while stats["steps"] < flags.total_steps:
            if broker is not None:
                broker.update()
            accumulator.update()

            if not accumulator.connected():
                time.sleep(0.05)
                continue

            if accumulator.wants_state():
                accumulator.set_state({"opt_state": opt.state, "steps": stats["steps"]})
            if accumulator.has_new_state():
                st = accumulator.state()
                if st is not None:
                    copy_into(named, accumulator.parameters())
                    copy_into(opt.state, st["opt_state"])
                    accumulator.set_parameters(named)
                    if not flags.quiet:
                        print(
                            f"received model version={accumulator.model_version()} "
                            f"from leader {accumulator.get_leader()}",
                            flush=True,
                        )

            # --- act -----------------------------------------------------
            with timer.section("env_step"), wd.section("env_step"):
                obs = envs.step(0, action_np).result()
            reward = np.asarray(obs["reward"])
            done = np.asarray(obs["done"])
            episode_return += reward
            for i in np.nonzero(done)[0]:
                window_returns.append(episode_return[i])
                stats["episodes"] += 1
                episode_return[i] = 0.0
            stats["steps"] += B

            # result() returns zero-copy shm views valid only until the next
            # step on this batch index — copy anything kept for the unroll.
            step_row = {
                "state": torch.from_numpy(np.array(obs["state"], np.float32)).to(device),
                "reward": torch.from_numpy(np.array(reward, np.float32)).to(device),
                "done": torch.from_numpy(np.array(done, bool)).to(device),
            }
            inputs = {k: v[None] for k, v in step_row.items()}
            inputs["prev_action"] = prev_action[None]
            core_before = core_state  # LSTM state *entering* this step
            with timer.section("act"), wd.section("act"), torch.no_grad():
                out, new_core = model(inputs, core_state, sample_generator=act_gen)
            new_action = out["action"][0]
            # Each step also records the LSTM state *entering* it so the
            # buffer can be trimmed at any boundary.
            steps_collected.append(
                dict(step_row, prev_action=prev_action, action=new_action, core=core_before)
            )
            # While a reduction is in flight the learn branch can't consume;
            # keep only the freshest T+1 steps so the unroll length stays
            # fixed.
            if len(steps_collected) > T + 1:
                steps_collected = steps_collected[-(T + 1):]
            prev_action = new_action
            action_np = new_action.cpu().numpy()
            core_state = new_core

            # --- learn ---------------------------------------------------
            if accumulator.has_gradients():
                with timer.section("apply"), wd.section("apply"), \
                        telemetry.devmon.dispatch_span("a2c.opt_apply"):
                    grads = accumulator.gradients()
                    for k, p in named.items():
                        p.grad = grads[k]
                    opt.step()
                    accumulator.set_parameters(named)
                    accumulator.zero_gradients()
                stats["sgd_steps"] += 1
            elif len(steps_collected) >= T + 1 and accumulator.wants_gradients():
                with timer.section("learn"), wd.section("learn"), \
                        telemetry.devmon.dispatch_span("a2c.grad"):
                    batch = {
                        k: torch.stack([s[k] for s in steps_collected])
                        for k in steps_collected[0]
                        if k != "core"
                    }
                    opt.zero_grad()
                    loss, aux = a2c_loss(model, batch, steps_collected[0]["core"],
                                         flags.discounting)
                    loss.backward()
                    pending_aux = (aux["pg_loss"].detach(), aux["entropy_loss"].detach())
                    # Gradients straight in: the Accumulator stages CUDA
                    # leaves into pinned memory with one event.
                    accumulator.reduce_gradients(B, {k: p.grad for k, p in named.items()})
                # Carry the last step into the next unroll (overlap of 1);
                # it still records the LSTM state that entered it.
                steps_collected = steps_collected[-1:]

            if time.time() - last_log > flags.log_interval:
                last_log = time.time()
                if pending_aux is not None:
                    _fetch_aux()
                    pending_aux = None
                if window_returns:
                    stats["mean_episode_return"] = float(np.mean(window_returns[-100:]))
                sps = stats["steps"] / max(time.time() - start, 1e-6)
                if not flags.quiet:
                    print(
                        f"steps={stats['steps']} sps={sps:.0f} "
                        f"return={stats['mean_episode_return']:.1f} "
                        f"episodes={stats['episodes']} sgd={stats['sgd_steps']} "
                        f"pg={stats['pg_loss']:.3f} ent={stats['entropy_loss']:.3f} "
                        f"[{timer.report()}]",
                        flush=True,
                    )
                if on_stats is not None:
                    on_stats(dict(stats))
        if pending_aux is not None:  # tail flush so the returned stats are fresh
            _fetch_aux()
            pending_aux = None
    finally:
        wd.close()
        envs.close()
        accumulator.close()
        if broker is not None:
            broker.close()
        telemetry.flush()  # final JSONL snapshot + host trace, if enabled
    if window_returns:
        stats["mean_episode_return"] = float(np.mean(window_returns[-100:]))
    stats["window_returns"] = window_returns
    return stats


def main(argv=None):
    train(make_flags(argv))


if __name__ == "__main__":
    main()
