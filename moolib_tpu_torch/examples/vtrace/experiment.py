"""IMPALA (V-trace) distributed agent — the port of the JAX package's
flagship example (``examples/vtrace/experiment.py``), with the same loop
priority order (reference ``experiment.py:364-529``):

1. pump group/accumulator; serve/consume state sync
2. stats allreduce on an interval
3. if gradients are ready: optimizer step + ``zero_gradients``
4. elif a learner batch is ready and the cohort wants gradients:
   forward + V-trace loss + backward → ``reduce_gradients``
5. else act: round-robin over double-buffered actor batches — EnvPool step,
   the T=1 act forward writing the [T+1, B] rollout buffer on the card
   (``rollout.DeviceRollout``), learner batches assembled by the Batcher;
   with ``--env_backend jax``, one ``rollout.AnakinRollout`` over every
   actor env instead: the batched env steps on the card inside the act
   step, and a whole unroll goes to the Batcher with no host crossing

The learner step on the card is forward + :func:`compute_loss` + backward +
``make_optimizer(...).step()``; ``moolib_tpu_torch.bench`` times it at the
reference Atari shape.

Durability and the fleet: ``--checkpoint PATH`` saves the leader's
``{"params", "opt_state", "steps", "model_version"}`` every
``--checkpoint_interval`` seconds and on the way out, and a start resumes
from it — a ``.pkl`` path is one ``torch.save`` file (tmp + rename), any
other path a ``checkpoint.Checkpointer`` directory.  ``--trace_dir`` opens
a ``torch.profiler`` window over the first 30 s of training;
``--autoscale`` / ``--localdir`` supervise and drain worker peers
(``autoscaler``); ``--compile_cache_dir`` shares the kernel build
directory.  ``--checkpoint_dir`` is the distributed checkpoint plane of
``--shard_grads`` cohorts, as in the JAX package.  Flags of planes the
port does not have yet exit with their slice (:func:`unported`).

Run: ``python -m moolib_tpu_torch.examples.vtrace.experiment --env catch``
(``--device cpu`` without a card).
"""

from __future__ import annotations

import argparse
import math
import os
import threading
import time
from functools import partial
from typing import Optional

import numpy as np
import torch

from ... import Accumulator, Broker, Group, Rpc, rollout, telemetry, utils
from ..._device import resolve
from ...batcher import Batcher
from ...envpool import EnvPool
from ...envs import CartPoleEnv, CatchEnv, SyntheticAtariEnv, _threefry
from ...models.actor_critic import ActorCriticNet
from ...models.impala import ImpalaNet
from ...ops import vtrace
from ...ops.returns import entropy_loss, softmax_cross_entropy
from ...utils import nest
from ...utils.profiling import StepTimer
from ...watchdog import Watchdog
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
    p.add_argument("--total_sgd_steps", type=int, default=0,
                   help="also stop once the cohort's model version reaches this "
                   "many applied SGD steps (0 = off): every peer stops at the "
                   "same version, so their parameters can be compared")
    p.add_argument("--min_cohort", type=int, default=1,
                   help="after this peer's first applied SGD step, idle while "
                   "the cohort has fewer members (a peer that seeded the "
                   "model waits for the peers that sync it)")
    p.add_argument("--debug_checksums", action="store_true",
                   help="CRC-verify every applied gradient result cohort-wide "
                   "(Accumulator.set_debug_checksums; set on every peer)")
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
    p.add_argument("--address", default="127.0.0.1:4431")
    p.add_argument("--connect", default=None, help="external broker address")
    p.add_argument(
        "--broker_addrs", default=None,
        help="comma-separated broker addresses (primary + hot standbys): when "
        "the list contains --address this peer hosts the primary and "
        "replicates to the others; otherwise it joins with failover across "
        "the list (--connect stays the single-address alias)")
    p.add_argument("--local_name", default=None)
    p.add_argument("--train_id", default="impala")
    p.add_argument("--stats_interval", type=float, default=2.0)
    p.add_argument("--log_interval", type=float, default=5.0)
    p.add_argument("--device", default=None,
                   help="torch device, e.g. 'cuda:0' (default cuda; 'cpu' runs on the CPU)")
    p.add_argument(
        "--ici", action="store_true",
        help="reduce gradients with torch.distributed (NCCL on cards, gloo on "
        "the CPU) across the process group instead of the RPC tree; the RPC "
        "stack still handles election/model sync/elasticity")
    p.add_argument(
        "--coordinator", default=None,
        help="torch.distributed rendezvous address (tcp://host:port); "
        "requires --num_processes and --process_id")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--wire_dtype", default=None, choices=[None, "bf16", "int8"],
                   help="compress gradient allreduce payloads (bf16: 2x, int8+EF: 4x)")
    p.add_argument("--chunked", action="store_true",
                   help="force gradient rounds over the chunked ring allreduce")
    p.add_argument("--localdir", default=None,
                   help="write stats rows to <localdir>/logs.tsv with latest "
                   "symlink + metadata.json")
    p.add_argument("--wandb", action="store_true",
                   help="log stats to wandb when the package is installed")
    p.add_argument("--watchdog", type=float, default=0.0,
                   help="deadman seconds per loop section (0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--batcher_max_outstanding", type=int, default=None,
                   help="bound the learn batcher's ready queue (default unbounded); "
                   "with --actor_mesh, the unrolls the actor ranks may run ahead "
                   "of the learner (default 2)")
    p.add_argument(
        "--device_rollout", type=_bool_flag, default=True,
        help="device-resident actor pipeline: [T+1, B] rollout buffers on the "
        "card written in place by the act step, uint8 single-crossing obs "
        "upload, async action fetch, learner batches assembled on the card.  "
        "--device_rollout false keeps the host-batcher path")
    p.add_argument("--checkpoint", default=None,
                   help="leader checkpoint: a .pkl file (one torch.save) or a "
                   "Checkpointer directory; a start resumes from it")
    p.add_argument("--checkpoint_interval", type=float, default=600.0)
    p.add_argument("--checkpoint_dir", default=None,
                   help="distributed checkpoint plane for --shard_grads cohorts: "
                   "each peer writes its shard, the leader two-phase-commits, "
                   "a start restores the newest committed checkpoint")
    p.add_argument("--trace_dir", default=None,
                   help="torch.profiler window over the first 30 s of training")
    p.add_argument("--compile_cache_dir", default=None,
                   help="shared kernel build directory (also MOOLIB_COMPILE_CACHE)")
    p.add_argument("--autoscale", action="store_true",
                   help="broker-hosting peer only: keep between --autoscale_min "
                   "and --autoscale_max supervised workers "
                   "(moolib_tpu_torch.autoscaler; this peer is not counted)")
    p.add_argument("--autoscale_min", type=int, default=1,
                   help="minimum supervised workers under --autoscale")
    p.add_argument("--autoscale_max", type=int, default=4,
                   help="maximum supervised workers under --autoscale")
    p.add_argument("--autoscale_interval", type=float, default=2.0,
                   help="supervision poll cadence seconds under --autoscale")
    p.add_argument("--shard_grads", action="store_true",
                   help="sharded inter-host rounds: each peer ships (N-1)/N of the "
                   "flat gradient payload (wire protocol: set on every peer)")
    p.add_argument("--overlap_grads", action="store_true",
                   help="stream the gradients from the backward's hooks into the "
                   "allreduce bucket by bucket; bit-identical results")
    p.add_argument("--mesh", default=None,
                   help='learner mesh axes, e.g. "dp=2" or "dp=2,tp=2": one rank '
                   "process each (spawned by this process, or started by torchrun)")
    p.add_argument("--actor_mesh", type=int, default=0,
                   help="Sebulba split (needs --mesh and --env_backend jax): the first N "
                   "ranks of the mesh run the on-device rollout as a dp actor mesh, the "
                   "rest are the learner mesh; each completed unroll goes from the actor "
                   "ranks to the learner ranks, each receiving its columns "
                   "(batcher_d2d_bytes_total card to card, batcher_staged_bytes_total "
                   "through host memory)")
    p.add_argument("--env_backend", default="envpool", choices=["envpool", "jax"],
                   help="envpool: host envs in worker processes; jax: batched "
                   "envs on the device inside the act step (envs.jax_envs: "
                   "catch_flat | catch_proc), zero host-boundary bytes per frame")
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
    from ... import parallel

    other = [k for k, v in parallel.mesh.parse_axes(flags.get("mesh") or "").items()
             if k not in ("dp", "tp") and v != 1]
    if other:
        out.append((f"--mesh axes {other}", "9e"))
    return out


class _MeshLearner:
    """The rank processes of a ``--mesh dp=N[,tp=M]`` learner.  Rank 0 runs
    the whole loop (actors, Batcher, Accumulator); before each learn, apply
    or model sync it broadcasts one command, and the other ranks, in
    :meth:`follow`, take the same step with it.  A learn broadcasts the
    learner batch and every rank takes its ``dp`` block; the step reduces
    the gradients over the mesh into the ``auto_shardings`` layout (fsdp
    over ``dp`` for big leaves, and ``tp`` on the output features of big
    kernels) as ``DTensor``s, which the Accumulator gathers onto rank 0.
    The apply broadcasts the cohort mean and every rank runs the same
    optimizer update (the optimizer's global-norm clip needs the whole
    gradient: every rank takes its norm from the broadcast).

    With a ``tp`` axis the learner's network is cut to each rank's ``tp``
    blocks (``parallel.tensor_parallel``): its convs and ``Dense_0`` compute
    their own output features.  Ranks 1.. hold only those blocks, and their
    optimizer state takes the same layout; rank 0 also keeps the whole
    network and its optimizer state, which its actors, the Accumulator's
    model sync and the checkpoints read, and refreshes its blocks from it
    after every update (an elementwise update of a block is the block of
    the whole update, bit for bit).

    Under ``--actor_mesh`` this is the learner mesh of the split and rank 0
    is its first rank; the batch is not broadcast: each rank takes its
    ``dp`` block straight from the actor ranks (``feed``, the
    ``parallel.collectives.UnrollHandoff``)."""

    LEARN, APPLY, STATE_IN, STOP = range(1, 5)

    def __init__(self, flags, mesh, model, opt, named, device):
        from ... import parallel
        from ...parallel import tensor_parallel

        self.flags, self.mesh, self.model, self.opt = flags, mesh, model, opt
        self.named, self.device = named, device
        self.control = common.MeshControl(mesh, device, axes=tuple(mesh.mesh_dim_names))
        self.rank = self.control.rank
        sizes = parallel.mesh.axis_sizes(mesh)
        self._n = sizes.get("dp", 1)
        self._dp_rank = mesh.get_local_rank("dp") if "dp" in sizes else 0
        layout = parallel.auto_shardings(named, mesh)
        self.learner, self.held = model, {}
        if sizes.get("tp", 1) > 1:
            import copy

            # Rank 0's actors and Accumulator keep the whole network; the
            # other ranks keep only their blocks.
            self.learner = copy.deepcopy(model) if self.rank == 0 else model
            self.held = tensor_parallel.shard_model(self.learner, mesh, layout)
            if self.rank != 0:
                self.named = dict(model.named_parameters())
                self.opt = make_optimizer(model.parameters(), flags)
        self.lnamed = dict(self.learner.named_parameters())
        self.feed = None
        self.step = parallel.make_train_step(
            lambda p, b, r: compute_loss(b[0], b[1], self.learner, flags), mesh=mesh,
            grad_spec=layout, batch_spec=parallel.PartitionSpec())

    def command(self, cmd: int) -> None:
        self.control.send(cmd)

    def _block(self, x, dim: int):
        return x.chunk(self._n, dim=dim)[self._dp_rank].contiguous()

    def _cut(self, k: str, t):
        """Leaf ``k`` of a whole tree as this rank's network holds it."""
        from ...parallel import shard_of

        return shard_of(t, self.held[k]) if k in self.held else t

    def learn(self, batch=None, initial_core=None):
        """Returns (loss, aux, grads): this rank's loss on its block and the
        DTensor gradients.  ``batch`` is [T+1, B, ...] (B over dp), the
        core state [B, ...]."""
        from ...parallel import broadcast_tree

        axes = tuple(self.mesh.mesh_dim_names)
        batch, initial_core = broadcast_tree(
            (batch, initial_core) if self.rank == 0 else None, self.mesh, self.device,
            axis_name=axes)
        local = (nest.tree_map(lambda x: self._block(x, 1), batch),
                 nest.tree_map(lambda x: self._block(x, 0), initial_core))
        return self.step(self.lnamed, local, None)

    def learn_local(self, batch, initial_core):
        """:meth:`learn` on this rank's own block (``[T+1, B/dp, ...]``)."""
        return self.step(self.lnamed, (batch, initial_core), None)

    def apply(self, grads=None) -> None:
        from ...parallel import broadcast_tree

        grads = broadcast_tree(grads if self.rank == 0 else None, self.mesh, self.device,
                               axis_name=tuple(self.mesh.mesh_dim_names))
        norm = common.global_norm(list(grads.values()))
        for k, p in self.named.items():
            p.grad = self._cut(k, grads[k]) if self.rank != 0 else grads[k]
        self.opt.step(global_norm=norm)
        self._refresh()

    def _refresh(self) -> None:
        """Rank 0: its learner blocks from the whole network."""
        if self.learner is self.model:
            return
        with torch.no_grad():
            for k, p in self.lnamed.items():
                p.copy_(self._cut(k, self.named[k]))

    def load_state(self) -> None:
        """Every rank takes rank 0's parameters and optimizer state (its
        blocks of them where its network is cut)."""
        from ...parallel import broadcast_tree

        got = broadcast_tree((self.named, self.opt.state) if self.rank == 0 else None,
                             self.mesh, self.device, axis_name=tuple(self.mesh.mesh_dim_names))
        if self.rank != 0:
            params = {k: self._cut(k, v) for k, v in got[0].items()}
            # Same-shaped leaves take the same layout (auto_shardings is
            # shape-driven): each moment is cut as its parameter is.
            shape_to_key = {self.learner.tp_full_shapes[k]: k for k in self.held}
            state = nest.tree_map(
                lambda t: self._cut(shape_to_key[tuple(t.shape)], t)
                if isinstance(t, torch.Tensor) and tuple(t.shape) in shape_to_key else t,
                got[1])
            common.copy_into(self.named, params)
            common.copy_into(self.opt.state, state)
        self._refresh()

    def follow(self) -> dict:
        from ...parallel import gather_full

        while True:
            cmd, arg = self.control.receive()
            if cmd == self.LEARN and self.feed is not None:
                gather_full(self.learn_local(*self.feed.take())[2], dst=0)
            elif cmd == self.LEARN:
                gather_full(self.learn()[2], dst=0)
            elif cmd == self.APPLY:
                self.apply()
            elif cmd == self.STATE_IN:
                self.load_state()
            elif cmd == self.STOP:
                if self.feed is not None:
                    self.feed.drain(arg)
                break
            else:
                raise RuntimeError(f"vtrace mesh rank {self.rank}: unknown command {cmd}")
        return self._summaries()[self.rank]

    def _summaries(self) -> list:
        """Every rank's summary: the sha256 of its network's parameters (its
        learner's, blocks included) and of the replicated ones alone."""
        import hashlib

        def sha(keys):
            h = hashlib.sha256()
            for k in sorted(keys):
                h.update(self.lnamed[k].detach().float().cpu().numpy().tobytes())
            return h.hexdigest()

        coords = {a: self.mesh.get_local_rank(a) for a in self.mesh.mesh_dim_names}
        return self.control.gather_objects({
            "rank": self.rank, "coords": coords, "params_sha256": sha(self.lnamed),
            "replicated_sha256": sha([k for k in self.lnamed if k not in self.held])})

    def stop(self, unrolls: int = 0) -> list:
        """Rank 0: release the other ranks (under ``--actor_mesh`` each first
        drains its pieces of the first ``unrolls`` unrolls); returns every
        rank's summary."""
        self.control.send(self.STOP, unrolls)
        return self._summaries()


# Sebulba control-plane traffic: the bytes of parameters the actor ranks
# take per learner version change (docs/TELEMETRY.md).
_M_PARAM_SYNC = telemetry.get_registry().counter(
    "actor_param_sync_bytes_total",
    "Sebulba actor-submesh param refreshes (learner -> actor devices)",
)
# The boundary an actor rank must not cross per frame (the Anakin plane's
# contract; the handoff counts its own bytes).
BOUNDARY = ("actor_h2d_bytes_total", "actor_d2h_bytes_total", "batcher_h2d_bytes_total",
            "batcher_d2h_bytes_total")
HANDOFF_COUNTERS = ("batcher_d2d_bytes_total", "batcher_staged_bytes_total")


def counters(names) -> dict:
    """This process's totals of the counters ``names``."""
    values = telemetry.get_registry().counter_values()
    return {n: sum(v for k, v in values.items() if k.split("{")[0] == n) for n in names}


def handoff_counted(since: dict) -> dict:
    """The handoff bytes this rank received since the counters read
    ``since``, by route."""
    now = counters(HANDOFF_COUNTERS)
    return {k: now[k] - since[k] for k in HANDOFF_COUNTERS}


class _SebulbaFeed:
    """The loop owner's side of ``--actor_mesh`` (learner rank 0).  Each
    unroll an actor rank makes needs a ticket: ``(GO, version, refresh)``,
    the parameters after it when the learner's version changed since the
    last refresh (``actor_param_sync_bytes_total``, one replica each).  The
    owner issues ticket ``u`` only once the learner has consumed unroll
    ``u - window``, so the actors run at most ``window`` unrolls ahead
    (``--batcher_max_outstanding``, default 2; at least the unrolls one
    learner batch spans, plus one).  Actor rank 0 answers each unroll with
    the mesh's cumulative frame and episode counts.  Tickets, parameters
    and counts ride a gloo control channel; the unrolls ride the data
    handoff."""

    GO, STOP = 1, 2
    TICKET, PARAMS, STATS = 1, 2, 4

    def __init__(self, flags, handoff, control, actor_ranks, named):
        self.uh, self.control, self.actors, self.named = handoff, control, actor_ranks, named
        self.window = max(flags.batcher_max_outstanding or 2, -(-handoff.bs // handoff.Bt) + 1)
        self.issued, self.sent_version, self.refreshes = 0, -1, 0
        self.param_bytes = sum(p.numel() * p.element_size() for p in named.values())
        self._sent: list = []
        self._stats: list = []
        self.frames = 0
        self.snap = {"episodes": 0, "return_sum": 0.0, "len_sum": 0}
        self.learn_s: list = []  # each learn section's seconds

    def _ticket(self, cmd: int, version: int, refresh: bool) -> None:
        t = torch.tensor([cmd, version, int(refresh)], dtype=torch.int64)
        params = [p.detach() for p in self.named.values()]
        sends = []
        for r in self.actors:
            sends.append(self.control.isend([t], r, self.TICKET))
            if refresh:
                sends.append(self.control.isend(params, r, self.PARAMS))
        self._sent.append(sends)

    def _read_stats(self, leaves) -> None:
        frames, episodes, return_sum, len_sum = leaves[0].tolist()
        self.frames = int(frames)
        self.snap = {"episodes": int(episodes), "return_sum": return_sum,
                     "len_sum": int(len_sum)}
        # The actors acted on the oldest ticket: its sends have landed.
        for w in self._sent.pop(0):
            w.wait()

    def pump(self, version: int) -> None:
        """Issue the tickets the window allows, post the next batch's
        receives once its unrolls are ticketed, and read the counts that
        arrived."""
        uh = self.uh
        consumed = uh.taken * uh.bs // uh.Bt
        while self.issued < consumed + self.window:
            refresh = version != self.sent_version
            self._ticket(self.GO, version, refresh)
            if refresh:
                self.sent_version = version
                self.refreshes += 1
                _M_PARAM_SYNC.inc(self.param_bytes)
            self._stats.append(self.control.irecv([((4,), torch.float64)], self.actors[0],
                                                  self.STATS, on_host=True))
            self.issued += 1
        if -(-(uh.taken + 1) * uh.bs // uh.Bt) <= self.issued:
            uh.post()
        while self._stats and self._stats[0].done():
            self._read_stats(self._stats.pop(0).wait())

    def ready(self) -> bool:
        return self.uh.ready()

    def take(self) -> tuple:
        return self.uh.take()

    def stop(self) -> None:
        """Stop the actor ranks and receive what they were still sending."""
        self._ticket(self.STOP, 0, False)
        self.uh.drain(self.issued)
        while self._stats:
            self._read_stats(self._stats.pop(0).wait())
        for sends in self._sent:
            for w in sends:
                w.wait()
        self.control.close()
        self.uh.handoff.close()


def _sebulba_setup(flags, mesh, model, jax_env, device) -> tuple:
    """Every rank of an ``--actor_mesh`` run, collectively: split ``mesh``,
    check the halves disjoint, make the learner mesh's groups over several
    axes (a rank outside a mesh takes part in making its groups) and the
    two handoffs.  Returns ``(actor mesh, learner mesh, unroll handoff,
    control)``."""
    from ... import parallel
    from ...parallel.collectives import Handoff, UnrollHandoff, axes_group

    actor_mesh, learner = parallel.split_mesh(mesh, flags.actor_mesh)
    parallel.check_disjoint(learner, actor_mesh, what_a="--mesh (learner remainder)",
                            what_b="--actor_mesh")
    sizes = parallel.mesh.axis_sizes(learner)
    names = tuple(sizes)
    live = tuple(a for a in names if sizes[a] > 1)
    for axes in (names,) + ((live,) if live != names else ()):
        if len(axes) > 1:
            axes_group(learner, axes)
    B = flags.actor_batch_size * flags.num_actor_batches
    uh = UnrollHandoff(actor_mesh, learner, B // flags.actor_mesh, flags.batch_size,
                       rollout.anakin_column_specs(jax_env, model, flags.unroll_length), device)
    control = Handoff(device, backend="gloo", counted=False)
    return actor_mesh, learner, uh, control


def _sebulba_actor(flags, model, jax_env, actor_mesh, uh, control, owner: int,
                   device) -> dict:
    """An actor rank of an ``--actor_mesh`` run: its ``dp`` block of the
    envs on the device (``AnakinRollout(mesh=)``, the JAX loop's keys),
    one unroll per ticket from the owner, each sent to the learner ranks
    as it completes.  Returns its summary."""
    import torch.distributed as dist

    rng = _threefry.split(_threefry.seed(flags.seed), 2)[0]
    rng, env_rng, act_key = _threefry.split(rng, 3)
    words = act_key.tolist()
    roll = rollout.AnakinRollout(
        model, jax_env, flags.actor_batch_size * flags.num_actor_batches,
        flags.unroll_length, env_key=env_rng, act_seed=(words[0] << 32) | words[1],
        mesh=actor_mesh)
    named = dict(model.named_parameters())
    pspecs = [(tuple(p.shape), p.dtype) for p in named.values()]
    timer = StepTimer()
    before = counters(BOUNDARY)
    sync = uh.handoff.route == "staged"
    sent, u, refreshes = [], 0, 0
    seconds = {"act": [], "handoff": []}  # per unroll
    while True:
        cmd, _, refresh = control.recv([((3,), torch.int64)], owner, _SebulbaFeed.TICKET,
                                       on_host=True)[0].tolist()
        if cmd == _SebulbaFeed.STOP:
            break
        if refresh:
            with timer.section("param_sync"):
                got = control.recv(pspecs, owner, _SebulbaFeed.PARAMS)
                with torch.no_grad():
                    for p, x in zip(named.values(), got):
                        p.copy_(x)
            refreshes += 1
        with timer.section("act"):
            unroll = roll.unroll()
            if sync:
                # The staged send waits for the unroll anyway; waiting here
                # gives the act section the unroll's own time.
                torch.cuda.synchronize(device)
        with timer.section("handoff"):
            uh.send(u, unroll, roll.completed_initial_core)
        for k, v in seconds.items():
            v.append(timer.last[k])
        snap = roll.stats()
        if uh.actor_index == 0:
            t = torch.tensor([roll.frames_done, snap["episodes"], snap["return_sum"],
                              snap["len_sum"]], dtype=torch.float64)
            sent.append(control.isend([t], owner, _SebulbaFeed.STATS))
        u += 1
    uh.wait_sent()
    for w in sent:
        w.wait()
    control.close()
    after = counters(BOUNDARY)
    return {"role": "actor", "rank": dist.get_rank(), "unrolls": u,
            "envs": roll.local_batch_size, "frames": roll.local_batch_size * (
                u * flags.unroll_length + (1 if u else 0)),
            "param_refreshes": refreshes, "sections": timer.summary(), "seconds": seconds,
            "boundary_bytes": {k: after[k] - before[k] for k in BOUNDARY},
            "digests": uh.handoff.digests()}


def _gather_world(summary: dict) -> list:
    """Every rank's summary, in rank order, on every rank."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, summary)
    return out


def _mesh_world(flags) -> int:
    """Ranks of the learner's ``--mesh`` (0: no mesh), after the JAX
    example's flag rules."""
    from ... import parallel

    axes = parallel.mesh.parse_axes(flags.mesh or "")
    if not axes:
        return 0
    if flags.overlap_grads:
        raise ValueError(
            "--overlap_grads is the unmeshed learner's overlap plane; with "
            "--mesh the step already reduces gradients over the mesh inside "
            "the step (drop one of the two flags)")
    if flags.coordinator:
        raise ValueError("--mesh and --coordinator both join a torch.distributed "
                         "process group; pass one")
    if flags.actor_mesh:
        # Sebulba: the learner is what the split leaves (the JAX example
        # splits, then checks the learner mesh).
        if any(v == -1 for v in axes.values()):
            raise ValueError("--actor_mesh needs every --mesh axis's size")
        B = flags.actor_batch_size * flags.num_actor_batches
        if B % flags.actor_mesh:
            raise ValueError(f"actor-mesh dp={flags.actor_mesh} must divide batch_size={B}")
        axes = parallel.split_mesh(axes, flags.actor_mesh)[1]
    if flags.batch_size % axes.get("dp", 1):
        raise ValueError("the dp mesh axis size must divide --batch_size")
    if flags.actor_mesh:
        return flags.actor_mesh + math.prod(axes.values())
    if any(v == -1 for v in axes.values()):
        if "WORLD_SIZE" not in os.environ:
            raise ValueError("--mesh with a -1 axis needs the world size: start the "
                             "ranks with torchrun, or give every axis its size")
        return int(os.environ["WORLD_SIZE"])
    return math.prod(axes.values())


def _use_checkpointer(path: str) -> bool:
    """A ``.pkl`` path keeps the reference-style single file; any other
    path is a :class:`~moolib_tpu_torch.checkpoint.Checkpointer`
    directory (manifest-checked, retains history)."""
    return not path.endswith(".pkl")


def save_checkpoint(path, model, opt, steps, model_version) -> None:
    state = {
        "params": model.state_dict(),
        "opt_state": opt.state,
        "steps": steps,
        "model_version": model_version,
    }
    if _use_checkpointer(path):
        from ...checkpoint import Checkpointer

        Checkpointer(path).save(int(steps), state)
        return
    from ...checkpoint import to_cpu

    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(to_cpu(state), tmp)
    os.replace(tmp, path)  # atomic tmp+rename like the reference (:186-204)


def load_checkpoint(path, device):
    """The saved state with its tensors on ``device`` (None when a
    Checkpointer directory holds nothing intact)."""
    if _use_checkpointer(path):
        from ...checkpoint import Checkpointer

        return Checkpointer(path).restore(map_location=device)
    return torch.load(path, map_location=device)


def train(flags, on_stats=None, _dist_args=()) -> dict:
    """The JAX package's IMPALA loop, step for step (``experiment.py:401``):
    EnvPool actors, the device rollout (or the host batcher), the learn
    Batcher, the Accumulator cohort (leader election, model sync, virtual
    batches, wire compression), V-trace on the card, the optax-form
    optimizer, the cohort stats reduce, the watchdog and the TSV log.
    Returns the run's summary (steps, episodes, sgd_steps, the mean episode
    return, sps, mfu).

    ``--mesh dp=N[,tp=M]``: the learner is N x M rank processes
    (``_MeshLearner``); started without ``RANK`` this process is rank 0
    and spawns the others (``_dist_args``: this rank's ``(coordinator,
    world, rank)``)."""
    missing = unported(flags)
    if missing:
        raise SystemExit("; ".join(f"{f}: not yet ported (slice {n})" for f, n in missing))
    if flags.actor_mesh and (not flags.mesh or flags.env_backend != "jax"):
        raise ValueError(
            "--actor_mesh is the Sebulba split: it needs --mesh (devices to "
            "split) and --env_backend jax (the actor submesh runs on-device "
            "envs)"
        )
    if flags.checkpoint_dir and not flags.shard_grads:
        raise ValueError(
            "--checkpoint_dir is the distributed checkpoint plane and "
            "requires --shard_grads (use --checkpoint for single-host "
            "snapshots)"
        )
    if _dist_args == ():
        world = _mesh_world(flags)
        if world and "RANK" not in os.environ:
            return common.run_mesh_host(train, "moolib_tpu_torch.examples.vtrace.experiment",
                                        flags, on_stats, world, host_rank=flags.actor_mesh)
        _dist_args = (None, world, None) if world else None
    # The loop's owner is the learner mesh's rank 0: global rank 0 without
    # --actor_mesh, the first rank after the actor ranks with it.
    rank = None if _dist_args is None else int(
        _dist_args[2] if _dist_args[2] is not None else os.environ["RANK"])
    actor = rank is not None and rank < flags.actor_mesh
    follower = rank is not None and not actor and rank != flags.actor_mesh
    # Before the first kernel load (--compile_cache_dir /
    # MOOLIB_COMPILE_CACHE; no-op when neither is set).
    utils.init_compile_cache(flags.compile_cache_dir)
    device = resolve(flags.device)
    tele = telemetry.init_from_env()
    # kill -USR2 toggles an on-demand torch.profiler window.
    telemetry.profiling.install_signal_toggle()
    if tele["http_port"]:
        print(f"telemetry: http://127.0.0.1:{tele['http_port']}/metrics", flush=True)
    from ...testing import faults as _faults

    _faults.install_from_env()  # opt-in chaos (MOOLIB_FAULTS; no-op unset)

    jax_env = None
    if follower or actor or (flags.actor_mesh and flags.env_backend == "jax"):
        # A learner rank other than the owner runs no actors: the owner (or,
        # with --actor_mesh, the actor ranks) sends its batches.  Every rank
        # of a split knows the env, for the columns the handoff carries.
        if flags.env_backend == "jax":
            from ...envs import make_jax_env

            jax_env = make_jax_env(flags.env)
            num_actions, obs_shape = jax_env.num_actions, tuple(jax_env.obs_spec[0])
            if not flags.actor_mesh:
                jax_env = None
        else:
            _, num_actions, obs_shape = make_env_factory(flags)
        envs = []
    elif flags.env_backend == "jax":
        # Anakin: the env lives on the device; no worker processes at all.
        from ...envs import make_jax_env

        jax_env = make_jax_env(flags.env)
        num_actions = jax_env.num_actions
        obs_shape = tuple(jax_env.obs_spec[0])
        envs = []
    else:
        env_factory, num_actions, obs_shape = make_env_factory(flags)
        # Fork env workers before this process touches the card or joins a
        # process group (EnvPool forks only then; forkserver after).
        envs = [
            EnvPool(
                env_factory,
                num_processes=flags.num_env_processes,
                batch_size=flags.actor_batch_size,
                num_batches=1,
            )
            for _ in range(flags.num_actor_batches)
        ]
    if flags.coordinator:
        # Multi-process collective plane (--ici): join the process group
        # after the pools forked.
        import torch.distributed as dist

        dist.init_process_group(
            backend="nccl" if device.type == "cuda" else "gloo",
            init_method=flags.coordinator,
            world_size=flags.num_processes,
            rank=flags.process_id,
        )

    mesh = host = feed = None
    if _dist_args is not None:
        # After the pools forked: a CUDA rank binds its card here.
        from ... import parallel

        coordinator, world, _rank = _dist_args
        parallel.initialize_distributed(coordinator, world if coordinator else None, _rank,
                                        device=device)
        mesh = parallel.parse_mesh_spec(flags.mesh, device_type=device.type)
        device = resolve(flags.device)

    gen = torch.Generator().manual_seed(flags.seed)
    model = make_model(flags, num_actions, obs_shape, device=device, generator=gen)
    opt = make_optimizer(model.parameters(), flags)
    named = dict(model.named_parameters())
    if mesh is not None and flags.actor_mesh:
        actor_mesh, mesh, uh, control = _sebulba_setup(flags, mesh, model, jax_env, device)
        handoff0 = counters(HANDOFF_COUNTERS)
        owner = flags.actor_mesh
        if actor:
            summary = _sebulba_actor(flags, model, jax_env, actor_mesh, uh, control,
                                     owner, device)
            _gather_world(summary)
            return summary
        jax_env = None  # the learner ranks run no envs
    if mesh is not None:
        host = _MeshLearner(flags, mesh, model, opt, named, device)
        if flags.actor_mesh:
            host.feed = uh
            if not follower:
                feed = _SebulbaFeed(flags, uh, control, list(range(flags.actor_mesh)), named)
        if follower:
            summary = host.follow()
            if flags.actor_mesh:
                uh.handoff.close()
                summary = dict(summary, digests=uh.handoff.digests(),
                               handoff_bytes=handoff_counted(handoff0))
                _gather_world(summary)
            return summary
    B = flags.actor_batch_size
    T = flags.unroll_length

    def learn_step(batch, initial_core):
        """Forward, V-trace loss and backward; the gradients are fresh
        tensors (``.grad`` set to None first), returned as a name tree."""
        opt.zero_grad()
        loss, aux = compute_loss(batch, initial_core, model, flags)
        loss.backward()
        return loss.detach(), aux, {k: p.grad for k, p in named.items()}

    if flags.overlap_grads:
        # One backward whose hooks stream the gradients into the round
        # (bit-identical to learn_step's tree).
        from ... import parallel

        _ostep = parallel.make_train_step(
            lambda p, b, r: compute_loss(b[0], b[1], model, flags), overlap_grads=True)

        def learn_step(batch, initial_core):  # noqa: F811 — the streaming form
            loss, aux, stream = _ostep(named, (batch, initial_core), None)
            return loss.detach(), aux, stream

    steps_done = 0
    model_version = 0
    if flags.checkpoint and os.path.exists(flags.checkpoint):
        ck = load_checkpoint(flags.checkpoint, device)
        if ck is not None:
            model.load_state_dict(ck["params"])
            common.copy_into(opt.state, ck["opt_state"])
            steps_done, model_version = ck["steps"], ck["model_version"]
            if not flags.quiet:
                print(f"resumed from checkpoint steps={steps_done} "
                      f"model_version={model_version}", flush=True)
    dckpt = None
    if flags.checkpoint_dir:
        from ...checkpoint import DistributedCheckpointer

        dckpt = DistributedCheckpointer(flags.checkpoint_dir)
        r = dckpt.restore(map_location=device)
        if r is not None:
            # The committed step IS the model version the cohort agreed on
            # at capture; election then prefers this restored peer.
            model_version, (params, _buffers, st) = r
            common.copy_into(named, params)
            common.copy_into(opt.state, st["opt_state"])
            print(f"resumed from checkpoint step {model_version}", flush=True)

    # --- cohort wiring ---------------------------------------------------
    broker: Optional[Broker] = None
    broker_list = [a.strip() for a in (flags.broker_addrs or "").split(",")
                   if a.strip()]
    # Host when no external broker was named: --connect, or a --broker_addrs
    # list that does NOT include our own --address, means join-only.
    hosting = flags.connect is None and (
        not broker_list or flags.address in broker_list)
    if hosting:
        broker = Broker()
        broker.set_name("broker")
        broker.listen(flags.address)
        standbys = [a for a in broker_list if a != flags.address]
        if standbys:
            broker.set_peer_brokers(standbys)
    connect_addrs = broker_list or [flags.connect or flags.address]
    # Comma-joined for the autoscaler: example_spawn re-emits a multi-address
    # plane as --broker_addrs so supervised workers inherit the failover list.
    broker_addr = ",".join(connect_addrs)

    # Elastic fleet supervision: the broker-hosting peer can run the
    # telemetry-driven autoscaler, spawning/decommissioning worker
    # subprocesses that join this same cohort.
    scaler = None
    if flags.autoscale:
        if broker is None:
            raise ValueError("--autoscale requires hosting the broker "
                             "(omit --connect)")
        from ... import autoscaler as autoscaler_mod

        fleet_dir = os.path.join(flags.localdir or ".", "fleet")
        worker_args = [
            "--env", flags.env,
            "--total_steps", str(flags.total_steps),
            "--batch_size", str(flags.batch_size),
            "--virtual_batch_size", str(flags.virtual_batch_size),
            "--actor_batch_size", str(flags.actor_batch_size),
            "--unroll_length", str(flags.unroll_length),
            "--num_env_processes", str(flags.num_env_processes),
            "--train_id", flags.train_id,
            "--quiet",
        ]
        if flags.device:
            worker_args += ["--device", flags.device]
        scaler = autoscaler_mod.Autoscaler(
            autoscaler_mod.AutoscalePolicy(flags.autoscale_min, flags.autoscale_max),
            autoscaler_mod.SubprocessFleet(
                autoscaler_mod.example_spawn(
                    broker_addr, fleet_dir,
                    "moolib_tpu_torch.examples.vtrace.experiment", worker_args,
                ),
                fleet_dir,
            ),
            poll_interval=flags.autoscale_interval,
        )

    rpc = Rpc()
    rpc.set_name(flags.local_name or f"impala-{os.getpid()}")
    rpc.listen("127.0.0.1:0")
    for a in connect_addrs:
        rpc.connect(a)
    rpc_group = Group(rpc, name=flags.train_id)
    if len(connect_addrs) > 1:
        rpc_group.set_brokers(connect_addrs)
    accumulator = Accumulator("model", named, buffers=None, group=rpc_group)
    accumulator.set_virtual_batch_size(flags.virtual_batch_size)
    if flags.shard_grads:
        # Sharded inter-host rounds.  Wire protocol: identical on every
        # cohort peer.
        accumulator.set_sharded_allreduce(True)
    accumulator.set_model_version(model_version)
    if flags.ici:
        accumulator.set_ici_backend(True)
    if flags.wire_dtype == "bf16":
        accumulator.set_wire_dtype(torch.bfloat16)
    elif flags.wire_dtype == "int8":
        accumulator.set_wire_dtype("int8")
    if flags.chunked:
        accumulator.set_chunked_allreduce(True)
    if flags.debug_checksums:
        accumulator.set_debug_checksums(True)
    trace_stop_at = None
    if flags.trace_dir:
        # Trace the first seconds of training through the profiler slot.
        res = telemetry.profiling.start_device_trace(flags.trace_dir)
        if not res.get("ok"):
            raise RuntimeError(f"--trace_dir: {res.get('error')}")
        trace_stop_at = time.monotonic() + 30.0

    stats = {
        "mean_episode_return": common.StatMean(),
        "mean_episode_step": common.StatMean(),
        "episodes_done": common.StatSum(),
        "steps_done": common.StatSum(),
        "sgd_steps": common.StatSum(),
        "loss": common.StatMean(),
        "pg_loss": common.StatMean(),
        "entropy_loss": common.StatMean(),
    }
    # Resume: continue the step count from the checkpoint.
    stats["steps_done"] += steps_done
    # Registry counter deltas piggyback on the same periodic stats reduce:
    # leader logs can show fleet-wide env/wire rates with no extra protocol.
    stats["telemetry"] = telemetry.CohortCounters()
    global_stats = common.GlobalStatsAccumulator(rpc_group, stats)
    timer = StepTimer()  # registry-backed loop-phase breakdown
    # Device performance plane: the counted FLOPs of the learn step (once
    # per geometry), combined with the StepTimer "learn" EMA into step_mfu.
    devmon_cost: dict = {}
    wd = Watchdog(timeout=flags.watchdog, name="impala")
    if dckpt is not None:
        # Distributed snapshots ride the accumulator's model-version
        # lockstep; a hung shard write fires the watchdog.  The env-step
        # total is host-local, so it rides the leader-broadcast aux dict;
        # state_fn returns only lockstep-replicated values.
        dckpt.set_watchdog(wd)
        accumulator.enable_distributed_checkpoint(
            dckpt, interval=flags.checkpoint_interval,
            aux_fn=lambda: {"steps": int(stats["steps_done"].value)})

    tsv = None
    if flags.localdir:
        tsv = common.TsvLogger(
            os.path.join(flags.localdir, "logs.tsv"),
            metadata={"train_id": flags.train_id, "env": flags.env},
        )
    recovery_written = False
    wandb_run = None
    if flags.wandb:
        try:
            import wandb

            wandb_run = wandb.init(project=flags.train_id, config=flags.to_dict())
        except Exception as e:  # noqa: BLE001 — gated: package absent or offline
            utils.log_error("wandb requested but unavailable: %s", e)

    anakin = None
    anakin_frames_seen = 0
    anakin_prev = {"episodes": 0, "return_sum": 0.0, "len_sum": 0.0}
    if jax_env is not None:
        # Anakin: ONE rollout over all the envs the EnvPool configuration
        # would spread across actor batches (double buffering hides host
        # env latency, and there is none to hide).  The keys follow the JAX
        # loop's chain: key(seed), split off its init key, then split
        # (rng, env key, act key); the act key seeds the torch generator.
        rng = _threefry.split(_threefry.seed(flags.seed), 2)[0]
        rng, env_rng, act_key = _threefry.split(rng, 3)
        act_words = act_key.tolist()
        anakin = rollout.AnakinRollout(
            model, jax_env, B * flags.num_actor_batches, T,
            env_key=env_rng, act_seed=(act_words[0] << 32) | act_words[1],
        )
    env_states = [] if anakin is not None or feed is not None else [
        common.EnvBatchState(B, T, model) for _ in range(flags.num_actor_batches)]
    act_gen = torch.Generator(device=device).manual_seed(flags.seed + 1)
    if flags.device_rollout and env_states:
        # Rollout buffers on the card, sized from the pool's discovered spec
        # so the env's own dtype — uint8 for frames — is what crosses.
        env_obs_shape, env_obs_dtype = envs[0].obs_spec["state"]
        for i, st in enumerate(env_states):
            st.rollout = rollout.DeviceRollout(
                model, B, T, env_obs_shape, env_obs_dtype, num_actions,
                seed=flags.seed + 1 + i,
            )
    # Learner batches on the card ([T+1, B] along dim 1); unrolls from the
    # device rollout are assembled there without a crossing.
    learn_batcher = Batcher(
        flags.batch_size, device=device if device.type != "cpu" else None, dim=1,
        max_outstanding=flags.batcher_max_outstanding, name="learn",
    )
    core_batcher = (
        Batcher(flags.batch_size, device=device if device.type != "cpu" else None, dim=0)
        if flags.use_lstm
        else None
    )

    def _sync_anakin_stats() -> None:
        """Fold the device-side episode aggregates into the stats (the
        deltas since the last snapshot): the Anakin plane's only D2H, per
        stats/log tick, not per frame."""
        if anakin is None and feed is None:
            return
        snap = anakin.stats() if anakin is not None else feed.snap
        de = snap["episodes"] - anakin_prev["episodes"]
        stats["mean_episode_return"] += common.StatMean(
            snap["return_sum"] - anakin_prev["return_sum"], de
        )
        stats["mean_episode_step"] += common.StatMean(
            snap["len_sum"] - anakin_prev["len_sum"], de
        )
        stats["episodes_done"] += de
        anakin_prev.update(
            episodes=snap["episodes"],
            return_sum=snap["return_sum"],
            len_sum=snap["len_sum"],
        )

    # Learner scalars stay on the card until the stats/log tick: one fetch
    # per tick instead of a float(loss) sync every SGD step.
    pending_learn_stats: list = []

    def _flush_learn_stats() -> None:
        if not pending_learn_stats:
            return
        rows = torch.stack([torch.stack(r) for r in pending_learn_stats]).tolist()
        for loss_v, pg_v, ent_v in rows:
            stats["loss"] += float(loss_v)
            stats["pg_loss"] += float(pg_v)
            stats["entropy_loss"] += float(ent_v)
        pending_learn_stats.clear()

    last_stats = time.monotonic()
    last_log = time.monotonic()
    last_checkpoint = time.monotonic()
    final_return = None
    start = time.time()
    sgd_times = []  # (wall time, this peer's env steps) at each applied SGD step
    sps_samples = [(start, 0.0)]
    cur = 0
    # Graceful shutdown: SIGTERM stops the loop so the finally block runs
    # (the leader checkpoints on the way out).
    stop_requested = False
    # Graceful scale-down: the autoscaler drops a flag file in --localdir;
    # the loop drains + __broker_leave's instead of waiting to be evicted.
    from ...autoscaler import decommission_requested

    decommissioning = False

    def _on_sigterm(signum, frame):
        nonlocal stop_requested
        stop_requested = True

    import signal as _signal

    prev_sigterm = None
    if threading.current_thread() is threading.main_thread():
        prev_sigterm = _signal.signal(_signal.SIGTERM, _on_sigterm)

    # Kick off the first step of every actor batch (double buffering).
    for i, st in enumerate(env_states):
        st.future = envs[i].step(0, np.zeros(B, np.int64))

    try:
        while stats["steps_done"].value < flags.total_steps and not stop_requested and not (
                flags.total_sgd_steps and accumulator.model_version() >= flags.total_sgd_steps):
            if broker is not None:
                broker.update()
            rpc_group.update()
            accumulator.update()
            if dckpt is not None:
                accumulator.checkpoint_tick(state_fn=lambda: {"opt_state": opt.state})
            if scaler is not None:
                scaler.step()  # self-rate-limited supervision tick
            if not decommissioning and decommission_requested(flags.localdir):
                # Drain and leave gracefully, then exit through the normal
                # checkpoint/teardown path.
                decommissioning = True
                stop_requested = True

            if accumulator.wants_state():
                accumulator.set_state(
                    {"opt_state": opt.state, "steps": stats["steps_done"].value}
                )
            if accumulator.has_new_state():
                st = accumulator.state()
                if st is not None:
                    # The leader's model and optimizer state, into the live
                    # tensors (the accumulator keeps the live tree).
                    common.copy_into(named, accumulator.parameters())
                    common.copy_into(opt.state, st["opt_state"])
                    if host is not None:
                        host.command(host.STATE_IN)
                        host.load_state()
                    accumulator.set_parameters(named)

            if feed is not None:
                # Sebulba: tickets out, the actor ranks' counts in.
                feed.pump(accumulator.model_version())
                stats["steps_done"] += feed.frames - anakin_frames_seen
                anakin_frames_seen = feed.frames
            if not accumulator.connected() or (
                    sgd_times and accumulator.cohort_size() < flags.min_cohort):
                time.sleep(0.05)
                continue

            now = time.monotonic()
            if trace_stop_at is not None and now > trace_stop_at:
                trace_stop_at = None
                res = telemetry.profiling.stop_device_trace()
                if not flags.quiet:
                    print(f"profiler trace written to {res.get('trace')}", flush=True)
            if now - last_stats > flags.stats_interval:
                last_stats = now
                _flush_learn_stats()  # one fetch; cohort sees fresh loss
                _sync_anakin_stats()
                global_stats.reduce(stats)
            if (
                flags.checkpoint
                and accumulator.is_leader()
                and now - last_checkpoint > flags.checkpoint_interval
            ):
                last_checkpoint = now
                save_checkpoint(flags.checkpoint, model, opt,
                                stats["steps_done"].value, accumulator.model_version())

            if accumulator.has_gradients():
                with timer.section("apply"), wd.section("apply"), \
                        telemetry.devmon.dispatch_span("vtrace.opt_apply"):
                    grads = accumulator.gradients()
                    if host is not None:
                        host.command(host.APPLY)
                        host.apply(grads)
                    else:
                        for k, p in named.items():
                            p.grad = grads[k]
                        opt.step()
                    accumulator.set_parameters(named)
                    accumulator.zero_gradients()
                stats["sgd_steps"] += 1
                sgd_times.append((time.time(), anakin.frames_done if anakin is not None
                                  else feed.frames if feed is not None
                                  else sum(e.step_count for e in env_states)))
            elif (feed.ready() if feed is not None else not learn_batcher.empty()) \
                    and accumulator.wants_gradients():
                with timer.section("learn"), wd.section("learn"):
                    if feed is not None:
                        # This rank's block, straight from the actor ranks.
                        batch, initial_core = feed.take()
                    else:
                        batch = _as_tensors(learn_batcher.get(), device)
                        initial_core = (
                            _as_tensors(core_batcher.get(), device)
                            if core_batcher is not None else ()
                        )
                    with telemetry.devmon.dispatch_span("vtrace.grad"):
                        if feed is not None:
                            host.command(host.LEARN)
                            loss, aux, grads = host.learn_local(batch, initial_core)
                        elif host is not None:
                            host.command(host.LEARN)
                            loss, aux, grads = host.learn(batch, initial_core)
                        else:
                            loss, aux, grads = learn_step(batch, initial_core)
                    pending_learn_stats.append(
                        (loss, aux["pg_loss"].detach(), aux["entropy_loss"].detach())
                    )
                    # CUDA gradients go straight in: the Accumulator stages
                    # them into pinned memory with one event.
                    accumulator.reduce_gradients(flags.batch_size, grads)
                if feed is not None:
                    feed.learn_s.append(timer.last["learn"])
                if "cost" not in devmon_cost:
                    # One count per geometry, outside the learn clock (a
                    # second forward+backward under FlopCounterMode; its
                    # gradients are dropped).
                    devmon_cost["cost"] = telemetry.devmon.step_cost(
                        "vtrace.grad", learn_step, batch, initial_core
                    )
            elif feed is not None:
                # Sebulba: the actor ranks act; wait for their next unroll.
                time.sleep(0.001)
            elif anakin is not None:
                # --- act: Anakin -----------------------------------------
                # One whole [T+1, B] unroll: env, model, auto-reset and the
                # episode accounting all run on the device.
                with timer.section("act"), wd.section("act"):
                    unroll = anakin.unroll()
                learn_batcher.cat(unroll)
                if core_batcher is not None:
                    core_batcher.cat(anakin.completed_initial_core)
                stats["steps_done"] += anakin.frames_done - anakin_frames_seen
                anakin_frames_seen = anakin.frames_done
            else:
                # --- act ------------------------------------------------
                st = env_states[cur]
                with timer.section("env_wait"), wd.section("env_wait"):
                    obs = st.future.result()
                st.update(obs, stats)
                if flags.device_rollout:
                    # Device-resident path: obs cross once (own dtype), the
                    # act step writes row t of the [T+1, B] buffer in place,
                    # and the action comes back asynchronously.
                    with timer.section("act"), wd.section("act"):
                        pending = st.rollout.step(obs)
                    unroll = st.rollout.take_unroll()  # tensors or None
                    if unroll is not None:
                        learn_batcher.cat(unroll)
                        if core_batcher is not None:
                            core_batcher.cat(st.rollout.completed_initial_core)
                    with timer.section("act_fetch"), wd.section("act_fetch"):
                        action_np = pending.realize()
                    st.future = envs[cur].step(0, action_np)
                else:
                    _act_host(st, obs, model, act_gen, device, envs[cur], learn_batcher,
                              core_batcher, timer, wd)
                cur = (cur + 1) % flags.num_actor_batches

            if not recovery_written and flags.localdir:
                rec = accumulator.recovery_info()
                if rec["complete"]:
                    recovery_written = True
                    import json as _json

                    with open(os.path.join(flags.localdir, "recovery.json"), "w") as f:
                        _json.dump(rec, f, indent=1)
                    if not flags.quiet:
                        print(f"recovered: {_json.dumps(rec)}", flush=True)

            if now - last_log > flags.log_interval:
                last_log = now
                _flush_learn_stats()
                _sync_anakin_stats()
                sps = stats["steps_done"].value / max(time.time() - start, 1e-6)
                sps_samples.append((time.time(), stats["steps_done"].value))
                ret = stats["mean_episode_return"].result()
                telemetry.devmon.sample_memory()
                mfu_info = None
                learn_s = timer.summary().get("learn")
                if devmon_cost.get("cost") is not None and learn_s:
                    mfu_info = telemetry.devmon.publish_step(
                        "vtrace.grad", devmon_cost["cost"], learn_s
                    )
                if mfu_info is not None:
                    devmon_cost["mfu"] = mfu_info["mfu"]
                if not flags.quiet:
                    fleet_env = stats["telemetry"].value("envpool_steps_total")
                    mfu_s = (
                        f" mfu={mfu_info['mfu']:.3%} bound={mfu_info['bound']}"
                        if mfu_info is not None
                        else ""
                    )
                    # Overlap attribution, when periodic timeline windows
                    # are on (MOOLIB_TIMELINE_INTERVAL): exposed comm
                    # seconds from the last ingested window.
                    tl = telemetry.timeline.status()
                    tl_s = ""
                    if tl["windows"] and tl["last_report"] is not None:
                        tl_s = (f" exposed_comm="
                                f"{tl['last_report']['exposed_comm_seconds']:.4f}s")
                    print(
                        f"steps={int(stats['steps_done'].value)} sps={sps:.0f} "
                        f"return={ret if ret is None else round(ret, 2)} "
                        f"sgd={int(stats['sgd_steps'].value)} "
                        f"loss={stats['loss'].result()} "
                        f"fleet_env_steps={int(fleet_env)}{mfu_s}{tl_s} "
                        f"[{timer.report()}]",
                        flush=True,
                    )
                if on_stats is not None or tsv is not None or wandb_run is not None:
                    row = {
                        k: v.result() if hasattr(v, "result") else v
                        for k, v in stats.items()
                        if not isinstance(v, telemetry.CohortCounters)
                    }
                    if on_stats is not None:
                        on_stats(row)
                    adbg = accumulator.debug_info()
                    row = dict(
                        row,
                        sps=round(sps, 1),
                        reduce_plane=adbg["last_plane"],
                        ici_reduces=adbg["ici_reduces"],
                        rpc_reduces=adbg["rpc_reduces"],
                        model_version=accumulator.model_version(),
                    )
                    if tsv is not None:
                        tsv.log(**row)
                    if wandb_run is not None:
                        wandb_run.log(row)
                last_return = stats["mean_episode_return"].result()
                if last_return is not None:
                    final_return = last_return
                # Windowed stats reset through the accumulator so the delta
                # allreduce stays in sync.
                global_stats.local_reset(
                    "loss", "pg_loss", "entropy_loss",
                    "mean_episode_return", "mean_episode_step",
                )
        _flush_learn_stats()
        _sync_anakin_stats()
        sps_samples.append((time.time(), stats["steps_done"].value))
        if flags.total_sgd_steps:
            # Every peer stops at the same version: leave together, so the
            # peer that applied the last result first (and may host the
            # broker) cannot take that result's delivery down with it.
            common.finish_together(rpc_group, [b for b in (broker,) if b] + [rpc_group, accumulator])
        # The cohort's end state, for runs that compare their peers: the
        # sha256 of the parameters (sorted names, f32 bytes), the
        # Accumulator's planes and recovery phases, the loop's sections.
        import hashlib

        h = hashlib.sha256()
        for k in sorted(named):
            h.update(named[k].detach().float().cpu().numpy().tobytes())
        sebulba = None
        if feed is not None:
            feed.stop()
            learners = host.stop(feed.issued)
            world = _gather_world(dict(learners[0], digests=uh.handoff.digests(),
                                       handoff_bytes=handoff_counted(handoff0)))
            sebulba = {"actors": world[:flags.actor_mesh], "learners": world[flags.actor_mesh:],
                       "unrolls": feed.issued, "param_refreshes": feed.refreshes,
                       "learn_s": feed.learn_s,
                       "param_bytes": feed.param_bytes, "window": feed.window,
                       "route": uh.handoff.route, "unroll_bytes": uh.unroll_bytes(uh.Bt)}
        cohort_end = {
            "ranks": (sebulba["learners"] if sebulba is not None
                      else host.stop() if host is not None else None),
            "sebulba": sebulba,
            "model_version": accumulator.model_version(),
            "is_leader": accumulator.is_leader(),
            "params_sha256": h.hexdigest(),
            "accumulator": accumulator.debug_info(),
            "recovery": accumulator.recovery_info(),
            "sections": timer.summary(),
        }
    finally:
        wd.close()
        if dckpt is not None:
            dckpt.close()
        if trace_stop_at is not None:
            telemetry.profiling.stop_device_trace()
        if prev_sigterm is not None:
            _signal.signal(_signal.SIGTERM, prev_sigterm)
        if flags.checkpoint and accumulator.is_leader():
            save_checkpoint(flags.checkpoint, model, opt,
                            stats["steps_done"].value, accumulator.model_version())
        if decommissioning:
            # Drain in-flight contributions, then tell the broker we're gone
            # so the cohort's epoch bumps now (not after the ping timeout).
            accumulator.decommission(timeout=15.0)
        for e in envs:
            e.close()
        if scaler is not None:
            scaler.fleet.terminate_all()
        accumulator.close()
        rpc.close()
        if broker is not None:
            broker.close()
        if wandb_run is not None:
            try:
                wandb_run.finish()
            except Exception:  # noqa: BLE001
                pass
        telemetry.flush()  # final JSONL snapshot + host trace, if enabled

    if "mfu" not in devmon_cost and devmon_cost.get("cost") is not None:
        learn_s = timer.summary().get("learn")
        if learn_s:
            fin = telemetry.devmon.publish_step("vtrace.grad", devmon_cost["cost"], learn_s)
            if fin is not None:
                devmon_cost["mfu"] = fin["mfu"]

    recent = stats["mean_episode_return"].result()
    final_steps = stats["steps_done"].value
    if sps_samples[-1][1] < final_steps:  # loop left via an exception path
        sps_samples.append((time.time(), final_steps))
    mid = next((s for s in sps_samples if s[1] >= final_steps / 2), sps_samples[0])
    end = sps_samples[-1]
    steady = (
        (end[1] - mid[1]) / (end[0] - mid[0])
        if end[0] > mid[0] and end[1] > mid[1]
        else None
    )
    return {
        "steps": final_steps,
        "episodes": stats["episodes_done"].value,
        "sgd_steps": stats["sgd_steps"].value,
        "mean_episode_return": recent if recent is not None else final_return,
        "sps": final_steps / max(time.time() - start, 1e-6),
        "steady_sps": None if steady is None else round(steady, 1),
        "mfu": devmon_cost.get("mfu"),
        "sgd_times": sgd_times,
        **cohort_end,
    }


def _as_tensors(tree, device):
    """A learner batch from the Batcher as tensors on ``device`` (the host
    path without a card yields numpy)."""
    return utils.nest.map(
        lambda x: torch.from_numpy(x).to(device) if isinstance(x, np.ndarray) else x, tree)


@torch.no_grad()
def _act_host(st, obs, model, generator, device, env, learn_batcher, core_batcher, timer, wd):
    """One act step of the host-batcher path (``--device_rollout false``):
    float32 staging on the host and three boundary crossings per frame,
    counted on the same telemetry as the device path."""
    # np.array (copy=True): obs are zero-copy shm views the env workers
    # overwrite on the next step — the unroll rows must own their memory.
    state_f32 = np.array(obs["state"], np.float32)
    reward_np = np.array(obs["reward"], np.float32)
    done_np = np.array(obs["done"], bool)
    inputs = {
        "state": torch.from_numpy(state_f32).to(device)[None],
        "reward": torch.from_numpy(reward_np).to(device)[None],
        "done": torch.from_numpy(done_np).to(device)[None],
        "prev_action": st.prev_action[None],
    }
    rollout.count_h2d(state_f32.nbytes + reward_np.nbytes + done_np.nbytes)
    rollout.count_frames(st.batch_size)
    core_before = st.core_state  # LSTM state entering this step
    with timer.section("act"), wd.section("act"):
        out, new_core = model(inputs, st.core_state, sample_generator=generator)
    action = out["action"][0]
    action_np = action.cpu().numpy()
    logits_np = out["policy_logits"][0].cpu().numpy()
    rollout.count_d2h(action_np.nbytes + logits_np.nbytes)
    st.future = env.step(0, action_np)
    st.time_batcher.stack(
        {
            "state": state_f32,
            "reward": reward_np,
            "done": done_np,
            "prev_action": st.prev_action_host,
            "action": action_np,
            "policy_logits": logits_np,
        }
    )
    st.prev_action = action
    st.prev_action_host = action_np
    st.core_state = new_core
    if not st.time_batcher.empty():
        unroll = st.time_batcher.get()  # [T+1, B, ...] host
        learn_batcher.cat(unroll)
        if core_batcher is not None:
            core_batcher.cat(st.initial_core_state)
        # Carry the last timestep into the next unroll; its initial LSTM
        # state is the state *before* that step.
        st.initial_core_state = core_before
        st.time_batcher.stack({k: v[-1] for k, v in unroll.items()})


def main(argv=None):
    flags = common.mesh_flags_from_env()  # a mesh rank spawned by rank 0
    train(flags if flags is not None else make_flags(argv))


if __name__ == "__main__":
    main()
