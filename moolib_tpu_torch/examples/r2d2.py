"""R2D2-style recurrent Q-learning with distributed prioritized replay: the
port of the JAX package's ``examples/r2d2.py``.

EnvPool actors collect fixed-length sequences with stored initial LSTM
states and push them into a replay store — the device-resident
:class:`moolib_tpu_torch.replay.DeviceReplayShard` by default
(``--device_replay false`` for the host
:class:`~moolib_tpu_torch.replay.ReplayBuffer`), or a store served over RPC
with ``--replay_peer`` — and the learner samples prioritized sequence
batches, replays them through the recurrent Q-network (double-Q with a
target network refreshed every ``--target_update_interval`` SGD steps) and
writes the new priorities back; on the device path the TD errors never
visit the host.  The optimizer is the JAX example's
``optax.chain(clip_by_global_norm(40), adam(lr))``.

Run: ``python -m moolib_tpu_torch.examples.r2d2 --total_steps 60000``
(``--device cpu`` without a card).  A standalone replay server:
``python -m moolib_tpu_torch.examples.r2d2 serve --address HOST:PORT``
(``--device true`` serves a device shard, on the card unless
``--shard_device cpu``).
"""

from __future__ import annotations

import argparse
import time
from functools import partial

import numpy as np
import torch

from .._device import resolve
from ..envpool import EnvPool
from ..envs import CartPoleEnv
from ..models.qnet import RecurrentQNet
from ..replay import ReplayBuffer, ReplayClient, ReplayServer
from .common import OptaxOptimizer, adam, clip_by_global_norm, finalize_flags

_SEQ_KEYS = ("state", "done", "action", "reward")


def make_flags(argv=None):
    p = argparse.ArgumentParser(description="moolib_tpu_torch R2D2 (recurrent DQN + PER)")
    p.add_argument("--total_steps", type=int, default=100_000)
    p.add_argument("--batch_size", type=int, default=16, help="envs")
    p.add_argument("--seq_length", type=int, default=20)
    p.add_argument("--learn_batch", type=int, default=32, help="sequences per update")
    p.add_argument("--replay_capacity", type=int, default=4096)
    p.add_argument("--min_replay", type=int, default=200)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--discounting", type=float, default=0.997)
    p.add_argument("--target_update_interval", type=int, default=100)
    p.add_argument("--eps_start", type=float, default=1.0)
    p.add_argument("--eps_end", type=float, default=0.05)
    p.add_argument("--eps_decay_steps", type=int, default=30_000)
    p.add_argument("--num_processes", type=int, default=2)
    p.add_argument("--replay_peer", default=None, help="remote replay server peer name")
    p.add_argument(
        "--device_replay",
        type=_bool_flag,
        default=True,
        help="device-resident replay shard (sum-tree + ring on the learner's "
        "device); `--device_replay false` keeps the host ReplayBuffer",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_interval", type=float, default=5.0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs on the CPU)")
    return finalize_flags(p, argv)


def _bool_flag(v) -> bool:
    """argparse-friendly bool: ``--device_replay false`` works (store_true
    can't express an =false override)."""
    return str(v).strip().lower() not in ("0", "false", "no", "off", "")


def td_loss(model, target_model, batch, discounting):
    """Sequence double-Q loss over a time-major [T+1, B] batch; returns
    (loss, per-sequence priorities), the priorities detached.  The JAX
    example's ``td_loss`` with the online and target networks as modules:
    the target forward runs without a graph."""
    init = tuple(batch["core"]) if "core" in batch else ()
    out, _ = model(batch, init)
    q = out["q"][:-1]  # [T, B, A]
    with torch.no_grad():
        target_q = target_model(batch, init)[0]["q"]  # [T+1, B, A]
    online_next = out["q"][1:].detach()

    actions = batch["action"][:-1].long()
    rewards = batch["reward"][1:]
    notdone = (~batch["done"][1:]).to(torch.float32)
    q_taken = q.gather(-1, actions[..., None]).squeeze(-1)
    # Double-Q: argmax online, evaluate target.
    next_action = online_next.argmax(dim=-1)
    next_q = target_q[1:].gather(-1, next_action[..., None]).squeeze(-1)
    targets = rewards + discounting * notdone * next_q
    td = targets - q_taken
    per_elem = 0.5 * td**2
    weights = batch.get("is_weight")
    if weights is not None:
        per_elem = per_elem * weights[None, :]
    loss = per_elem.mean()
    # R2D2 priority: eta*max + (1-eta)*mean of |td| over the sequence.
    abs_td = td.detach().abs()
    prio = 0.9 * abs_td.amax(dim=0) + 0.1 * abs_td.mean(dim=0)
    return loss, prio


def time_major(batch_items, weights, device) -> dict:
    """A sampled [N, T+1, ...] batch as the learner's time-major [T+1, N, ...]
    batch on ``device``: device tensors are transposed in place (no host
    hop); host arrays (the host store, a remote store) are moved there."""
    def dev(x):
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))

    batch = {k: dev(batch_items[k]).to(device).transpose(0, 1) for k in _SEQ_KEYS}
    # core was stacked per leaf: already a tuple of [N, H] arrays.
    batch["core"] = tuple(dev(c).to(device) for c in batch_items["core"])
    batch["is_weight"] = dev(weights).to(device)
    return batch


def make_replay(flags, device):
    """The learner's store (and the Rpc it needs, or None): a client of
    ``--replay_peer``, the device shard, or the host buffer."""
    if flags.replay_peer:
        from .. import Rpc

        rpc = Rpc()
        rpc.set_name(f"r2d2-actor-{flags.seed}")
        rpc.connect(flags.replay_peer)
        return ReplayClient(rpc, "replay-server", "replay"), rpc
    if flags.device_replay:
        from ..replay import DeviceReplayShard

        return DeviceReplayShard(flags.replay_capacity, seed=flags.seed, name="r2d2_replay",
                                 device=device), None
    return ReplayBuffer(flags.replay_capacity, seed=flags.seed), None


def train(flags, on_stats=None) -> dict:
    device = resolve(flags.device)
    envs = EnvPool(
        partial(CartPoleEnv, max_episode_steps=200),
        num_processes=flags.num_processes,
        batch_size=flags.batch_size,
        num_batches=1,
    )
    make = partial(RecurrentQNet, num_actions=2, obs_shape=(4,), device=device)
    model = make(generator=torch.Generator().manual_seed(flags.seed))
    target_model = make().requires_grad_(False)
    target_params = list(target_model.parameters())
    params = list(model.parameters())
    torch._foreach_copy_(target_params, params)
    opt = OptaxOptimizer(params, clip_by_global_norm(40.0), adam(flags.learning_rate))
    act_gen = torch.Generator(device=device).manual_seed(flags.seed + 1)
    B, T = flags.batch_size, flags.seq_length

    device_store = bool(flags.device_replay) and not flags.replay_peer
    replay, rpc = None, None
    stats = {"steps": 0, "episodes": 0, "sgd_steps": 0, "loss": 0.0, "eps": 1.0}
    replay_warm = False
    window_returns: list = []
    episode_return = np.zeros(B)

    core_state = model.initial_state(B)
    action = np.zeros(B, np.int64)
    seq: list = []
    loss = None  # the last SGD step's loss, on the device until a log tick
    start = time.time()
    last_log = time.time()

    def epsilon():
        f = min(1.0, stats["steps"] / flags.eps_decay_steps)
        return flags.eps_start + f * (flags.eps_end - flags.eps_start)

    try:
        replay, rpc = make_replay(flags, device)
        while stats["steps"] < flags.total_steps:
            obs = envs.step(0, action).result()
            reward = np.array(obs["reward"], np.float32, copy=True)
            done = np.array(obs["done"], copy=True)
            state = np.array(obs["state"], np.float32, copy=True)
            episode_return += reward
            for i in np.nonzero(done)[0]:
                window_returns.append(episode_return[i])
                stats["episodes"] += 1
                episode_return[i] = 0.0
            stats["steps"] += B

            inputs = {"state": torch.from_numpy(state).to(device)[None],
                      "done": torch.from_numpy(done).to(device)[None]}
            core_before = core_state
            with torch.no_grad():
                out, core_state = model(inputs, core_state)
                greedy = out["q"][0].argmax(dim=-1)
                rand = torch.randint(0, model.num_actions, greedy.shape, generator=act_gen,
                                     device=device)
                explore = torch.rand(greedy.shape, generator=act_gen, device=device) < epsilon()
                new_action = torch.where(explore, rand, greedy).to(torch.int32)
            action = new_action.cpu().numpy()
            seq.append({"state": state, "done": done, "action": action, "reward": reward,
                        "core": core_before})
            action = action.astype(np.int64)

            if len(seq) >= T + 1:
                # Split the [T+1, B] window into B per-env sequences.
                stacked = {k: np.stack([s[k] for s in seq]) for k in _SEQ_KEYS}
                core0 = tuple(c.cpu().numpy() for c in seq[0]["core"])
                items = []
                for b in range(B):
                    item = {k: v[:, b] for k, v in stacked.items()}
                    item["core"] = tuple(c[b] for c in core0)
                    items.append(item)
                replay.add(items)
                seq = seq[-1:]

            # Latch once past min_replay: the ring never shrinks, and in
            # remote mode size() is a blocking RPC we must not pay per step.
            if not replay_warm:
                replay_warm = replay.size() >= flags.min_replay
            if replay_warm:
                batch_items, idxs, weights = replay.sample(flags.learn_batch)
                batch = time_major(batch_items, weights, device)
                opt.zero_grad()
                loss, prio = td_loss(model, target_model, batch, flags.discounting)
                loss.backward()
                opt.step()
                loss = loss.detach()
                # Priority write-back: the device store consumes the device
                # TD errors without a host read; the others take numpy.
                if device_store:
                    replay.update_priorities(idxs, prio)
                else:
                    replay.update_priorities(np.asarray(idxs), prio.cpu().numpy())
                stats["sgd_steps"] += 1
                if stats["sgd_steps"] % flags.target_update_interval == 0:
                    torch._foreach_copy_(target_params, params)

            if time.time() - last_log > flags.log_interval:
                last_log = time.time()
                stats["eps"] = epsilon()
                if loss is not None:
                    stats["loss"] = float(loss)
                ret = float(np.mean(window_returns[-50:])) if window_returns else 0.0
                sps = stats["steps"] / max(time.time() - start, 1e-6)
                if not flags.quiet:
                    print(
                        f"steps={stats['steps']} sps={sps:.0f} return={ret:.1f} "
                        f"sgd={stats['sgd_steps']} loss={stats['loss']:.4f} "
                        f"eps={stats['eps']:.2f}",
                        flush=True,
                    )
                if on_stats is not None:
                    on_stats(dict(stats))
        if loss is not None:
            stats["loss"] = float(loss)
    finally:
        envs.close()
        if rpc is not None:
            rpc.close()
    stats["mean_episode_return"] = (
        float(np.mean(window_returns[-50:])) if window_returns else 0.0
    )
    stats["window_returns"] = window_returns
    if device_store:
        stats["replay_device"] = str(replay.tree.device)
    return stats


def make_serve_flags(argv=None):
    p = argparse.ArgumentParser(description="moolib_tpu_torch R2D2 replay server")
    p.add_argument("--address", default="0.0.0.0:4441")
    p.add_argument("--capacity", type=int, default=100_000)
    p.add_argument("--device", type=_bool_flag, default=False,
                   help="serve a device-resident shard (memfd ingest + "
                   "cohort sampling endpoints) instead of the host buffer")
    p.add_argument("--shard_device", default=None,
                   help="torch device of the --device shard (default cuda; "
                   "'cpu' runs it on the CPU)")
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    return p.parse_args(argv)


def start_replay_server(args):
    """The server of :func:`serve_replay`, listening; returns its Rpc."""
    from .. import Rpc

    if args.device:
        from ..replay import DeviceReplayShard, ReplayShardService

        shard = DeviceReplayShard(args.capacity, name="replay_srv", device=args.shard_device)
    rpc = Rpc()
    rpc.set_name("replay-server")
    if args.device:
        ReplayShardService(rpc, "replay", shard, shard_index=args.shard_index,
                           num_shards=args.num_shards)
    else:
        ReplayServer(rpc, "replay", ReplayBuffer(args.capacity))
    rpc.listen(args.address)
    return rpc


def serve_replay(argv=None):
    """Run a standalone replay server:
    ``python -m moolib_tpu_torch.examples.r2d2 serve``."""
    args = make_serve_flags(argv)
    start_replay_server(args)
    print(f"replay server on {args.address}", flush=True)
    while True:
        time.sleep(1)


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "serve":
        serve_replay(argv[1:])
    else:
        train(make_flags(argv))


if __name__ == "__main__":
    main()
