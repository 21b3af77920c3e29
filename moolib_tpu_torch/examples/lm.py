"""LM training: the port of the JAX package's ``examples/lm.py`` — the
single-device path, the static mesh (data, sequence, expert and pipeline
parallel) and the elastic data-parallel path.

The task makes long-range attention load-bearing: each sequence is a random
prefix followed by its own repetition; the loss counts only the repeated
half, so predicting token ``t`` requires attending ``T/2`` positions back.
A model whose attention is broken cannot beat chance.

With ``--attention flash`` on the card every layer runs the hand-written
flash kernels: the forward, and the dq and dk/dv passes in the backward.

With ``--address`` (host the broker) or ``--connect`` / ``--broker_addrs``
(join one) the loop is elastic data parallelism over the Accumulator
cohort (:func:`_train_elastic`): leader election, the model and AdamW
state synced to joiners, virtual batches, wire compression.

Run (the JAX defaults: a dp=2 x sp=4 mesh of 8 rank processes, ring
attention):
    python -m moolib_tpu_torch.examples.lm --device cpu
    python -m moolib_tpu_torch.examples.lm --mesh "" --attention flash --steps 400
    python -m moolib_tpu_torch.examples.lm --mesh "" --attention dense --device cpu
    python -m moolib_tpu_torch.examples.lm --mesh "" --attention dense --device cpu \
        --address 127.0.0.1:4431 --local_name lm0 --virtual_batch_size 16   # + a
        second process with --connect 127.0.0.1:4431 --local_name lm1

The mesh (``--mesh dp=N``): a port host is N rank processes joined by
``torch.distributed`` (gloo on the CPU and where ranks share a card, NCCL
only with a card per rank; ``parallel.initialize_distributed``).  Started
without ``RANK`` in the environment, this example spawns ranks 1..N-1 of
its host itself and is rank 0, so the JAX command line works unchanged;
under ``torchrun`` every rank is started for it.  ``--batch_size`` is the
host's batch; each rank takes its ``dp`` block.

- Without a cohort, every rank runs the same loop (:class:`_StaticMesh`):
  the train step reduces the gradients over the mesh and every rank
  applies the same AdamW update.
- ``--shard_grads`` in an elastic cohort (``--address``/``--connect``) is
  the hierarchical plane: the step reduce-scatters the gradients over the
  mesh (fsdp layout), mesh rank 0 is the host's one Accumulator peer and
  gathers them in full, and the Accumulator's sharded rounds ship (N-1)/N
  of the flat payload between hosts.  The apply is ZeRO-style: rank 0
  scatters the cohort mean, every rank runs AdamW on its shard, and
  ``parallel.redistribute`` gathers the params.  The other ranks follow
  rank 0's decisions (learn, apply, send or load state, stop) through one
  small broadcast each; they open no RPC.  ``--overlap_grads`` streams the
  gradients from the backward's hooks into the sharded rounds
  (``parallel.make_train_step``).  With ``--checkpoint_dir`` the cohort
  writes distributed checkpoints (``checkpoint.DistributedCheckpointer``).
  The host runs every model axis below (``_MeshHost``): each rank holds
  its ``ep`` experts and ``tp`` blocks, mesh rank 0 also the whole model
  for its Accumulator peer.
- ``--shard_grads`` and ``--overlap_grads`` work without a mesh too.

Model parallelism on the static mesh (each rank holds ``[B/dp, T/sp]``
tokens):

- ``--attention ring`` with an ``sp`` axis: ring attention over ``sp``
  (``parallel.ring_attention``), positions offset by the rank's chunk;
- ``--moe_experts E``: every second block is a Switch MoE; with an ``ep``
  axis each rank holds ``E/ep`` experts (``parallel.moe``) and the tokens
  are replicated over ``ep``;
- ``--mesh ...,pp=S`` with ``--microbatches``/``--pp_repeats``: the blocks
  run through the GPipe/circular pipeline (``pipeline_lm_apply``).

Every rank runs the same loop; the step (``parallel.make_train_step``)
reports the global loss and accuracy.  Mesh rank 0 logs and, with
``--checkpoint_dir``, writes the whole state: ``ep``-sharded experts (and
their AdamW moments) are gathered (``parallel.gather_full``) and saved in
the single-device layout, so the checkpoint loads into the plain model.

With ``--publish_every N`` on the elastic path the leader publishes its
weights every N optimizer steps through a ``serving.ModelPublisher`` on the
Accumulator's Rpc (as the flax tree of numpy leaves, ``models.convert.
to_flax``): serving replicas of either package subscribed to this peer
hot-swap to them.

Durability and the fleet (docs/RESILIENCE.md):

- ``--checkpoint_dir D``: a ``checkpoint.Checkpointer`` under ``D`` holding
  ``{"params": model.state_dict(), "opt_state": opt.state_dict(),
  "steps"}``.  A start restores the newest intact checkpoint onto the
  model's device and continues from its step count; the single-device
  loop (and the leader of an elastic cohort) saves every
  ``--checkpoint_interval`` seconds and once more when the loop ends.  An
  elastic peer that restored advertises the step as its model version,
  so leader election prefers it.
- ``--compile_cache_dir`` (or ``MOOLIB_COMPILE_CACHE``): the shared kernel
  build directory (``utils.compile_cache``).
- ``--autoscale`` (broker-hosting peer): supervise ``--autoscale_min`` ..
  ``--autoscale_max`` worker processes of this example from their
  telemetry (``autoscaler``); ``--localdir``: the directory whose
  decommission flag drains this peer and leaves the cohort.

- ``--mesh ...,tp=M``: on the static mesh the JAX example's meaning,
  parameters replicated over ``tp`` (``lm.py``'s static mesh places them
  so): the ``tp`` ranks hold replicas of the tokens and the step reduces
  over them.  A ``--shard_grads`` host cuts its model to the ``tp`` blocks
  of ``parallel.tensor_parallel.shard_model``.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from .. import parallel, telemetry
from .._device import resolve
from ..checkpoint import Checkpointer
from ..models.transformer import REMAT_POLICIES, TransformerLM
from ..utils import nest
from ..utils.profiling import StepTimer
from ..watchdog import Watchdog
from . import common

def make_flags(argv=None):
    p = argparse.ArgumentParser(description="moolib_tpu_torch LM example")
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--seq_len", type=int, default=64, help="T (even; half is the prefix)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--d_model", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--kv_heads", type=int, default=0,
                   help="grouped-query attention: KV heads shared by groups of "
                   "heads/kv_heads query heads (0 = heads, plain MHA)")
    p.add_argument("--attention", default="ring", choices=["dense", "flash", "ring"],
                   help="ring = sequence-parallel over the sp mesh axis")
    p.add_argument("--mesh", default="dp=2,sp=4",
                   help='mesh axes of the host, e.g. "dp=2" (one rank process each); '
                   '"" for the single-device step')
    p.add_argument("--pos", default="learned", choices=["learned", "rotary"],
                   help="position encoding: learned table (capped at seq_len) or rotary")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="if >0, every other block uses a SwitchMoE FFN with this many "
                   "experts; add an ep axis to --mesh to shard them (expert parallelism)")
    p.add_argument("--moe_aux_weight", type=float, default=0.01)
    p.add_argument("--microbatches", type=int, default=0,
                   help="pipeline microbatches when --mesh has a pp axis (0 = 2*pp)")
    p.add_argument("--pp_repeats", type=int, default=1,
                   help="circular-schedule virtual stages per pp rank "
                   "(--layers must equal pp_repeats * pp)")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint each transformer block (recompute activations "
                   "in the backward)")
    p.add_argument("--remat_policy", default="full", choices=list(REMAT_POLICIES),
                   help="what the per-block checkpoint saves (with --remat)")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--learning_rate", type=float, default=3e-3)
    p.add_argument("--log_interval", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--watchdog", type=float, default=0.0,
                   help="deadman seconds per loop section (0 = off)")
    # Elastic data parallelism over the Accumulator cohort.
    p.add_argument("--address", default=None,
                   help="host the cohort's broker here and join it (host:port)")
    p.add_argument("--connect", default=None, help="join the broker at host:port")
    p.add_argument("--broker_addrs", default=None,
                   help="comma-separated broker list (primary + hot standbys); "
                   "with --address the list's other entries are its standbys")
    p.add_argument("--local_name", default=None)
    p.add_argument("--wire_dtype", default=None, choices=[None, "bf16", "int8"],
                   help="compress gradient allreduce payloads (bf16: 2x, int8+EF: 4x)")
    p.add_argument("--virtual_batch_size", type=int, default=0)
    p.add_argument("--min_cohort", type=int, default=1,
                   help="elastic: after this peer's first applied step, idle "
                   "while the cohort has fewer members (a peer that seeded the "
                   "model and AdamW state waits for the peers that sync it)")
    p.add_argument("--form_cohort", type=int, default=1,
                   help="elastic: after this peer's first applied step, idle "
                   "until the cohort has had this many members once (then "
                   "step on alone if they leave)")
    p.add_argument("--shard_grads", action="store_true",
                   help="hierarchical reduce plane: the step reduces the grads over "
                   "the in-mesh dp axis and returns them fsdp-sharded; the "
                   "Accumulator then reduce-scatters only (N-1)/N of the flat "
                   "payload between hosts.  Requires the elastic cohort")
    p.add_argument("--overlap_grads", action="store_true",
                   help="stream the gradients from the backward's hooks into the "
                   "inter-host allreduce bucket by bucket; bit-identical results")
    p.add_argument("--localdir", default=None,
                   help="per-peer scratch dir: the autoscaler's decommission "
                   "flag is polled here (and MOOLIB_TELEMETRY_DIR usually "
                   "points at it)")
    p.add_argument("--autoscale", action="store_true",
                   help="broker-hosting peer only: supervise an elastic lm "
                   "worker fleet from the workers' telemetry snapshots "
                   "(moolib_tpu_torch.autoscaler; this peer is not counted)")
    p.add_argument("--autoscale_min", type=int, default=1,
                   help="minimum supervised workers under --autoscale")
    p.add_argument("--autoscale_max", type=int, default=4,
                   help="maximum supervised workers under --autoscale")
    p.add_argument("--autoscale_interval", type=float, default=2.0,
                   help="supervision poll cadence seconds under --autoscale")
    p.add_argument("--checkpoint_dir", default=None,
                   help="Checkpointer directory (manifest-validated step_<N>/ "
                   "dirs); the run resumes from the newest intact checkpoint "
                   "on restart.  With --shard_grads in an elastic cohort: the "
                   "distributed checkpoint plane (two-phase committed)")
    p.add_argument("--checkpoint_interval", type=float, default=30.0,
                   help="seconds between checkpoint saves (leader-only in "
                   "elastic runs)")
    p.add_argument("--compile_cache_dir", default=None,
                   help="shared kernel build directory (also "
                   "MOOLIB_COMPILE_CACHE): restarts load the kernels built there")
    p.add_argument("--publish_every", type=int, default=0,
                   help="elastic: the leader publishes its weights as a new model "
                   "version every N optimizer steps (0 = off); serving replicas "
                   "subscribed to this peer hot-swap (serving.ModelPublisher)")
    p.add_argument("--publish_channel", default="model",
                   help="publisher endpoint prefix under --publish_every")
    p.add_argument("--probe_dir", default=None,
                   help="model-parallel mesh: mesh rank 0 writes the warm-up step's "
                   "global loss and reduced gradients (single-device layout) to "
                   "DIR/step0.pt, to hold against a one-process run")
    return common.finalize_flags(p, argv)


def make_batch(rng: np.random.Generator, flags):
    """[B, T] int32: random prefix + its repetition (tokens 2.. so 0/1 can
    serve as pad/sep if anyone extends this)."""
    half = flags.seq_len // 2
    prefix = rng.integers(2, flags.vocab, size=(flags.batch_size, half))
    return np.concatenate([prefix, prefix], axis=1).astype(np.int32)


def make_optimizer(params, learning_rate: float) -> torch.optim.Optimizer:
    """``optax.adamw(learning_rate)`` with its defaults spelled out: b1 0.9,
    b2 0.999, eps 1e-8 outside the square root, decoupled weight decay 1e-4
    on every parameter (biases, LayerNorm and embeddings included).  torch's
    own default decay is 1e-2; the update math is otherwise the same."""
    return torch.optim.AdamW(list(params), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def make_model(flags, device) -> TransformerLM:
    """The run's TransformerLM, its weights made from ``--seed``."""
    return TransformerLM(
        vocab_size=flags.vocab,
        d_model=flags.d_model,
        num_layers=flags.layers,
        num_heads=flags.heads,
        max_len=flags.seq_len,
        attention=flags.attention,
        moe_num_experts=flags.moe_experts,
        pos_embedding=flags.pos,
        remat=flags.remat,
        remat_policy=flags.remat_policy,
        num_kv_heads=flags.kv_heads or None,
        device=device,
        generator=torch.Generator().manual_seed(flags.seed),
    )


def checkpoint_state(model, opt, steps: int) -> dict:
    """The state ``--checkpoint_dir`` saves (``Checkpointer.save`` copies
    its tensors to the CPU)."""
    return {"params": model.state_dict(), "opt_state": opt.state_dict(), "steps": int(steps)}


def resume(ckpt: Checkpointer, model, opt, device) -> int:
    """Restore the newest intact checkpoint into ``model`` and ``opt`` (its
    tensors land on ``device``); returns its step count, 0 when there is
    none."""
    st = ckpt.restore(map_location=device)
    if st is None:
        return 0
    model.load_state_dict(st["params"])
    _load_adamw_state(opt, st["opt_state"])
    return int(st["steps"])


def copy_task_loss(logits, tokens, half: int):
    """Next-token loss and accuracy where the answer is half a sequence
    away: positions half-1 .. T-2 predict the repeated half (log-softmax in
    f32)."""
    pred = logits[:, half - 1 : -1]
    tgt = tokens[:, half:].long()
    logp = torch.log_softmax(pred.to(torch.float32), dim=-1)
    ll = logp.gather(-1, tgt[..., None])[..., 0]
    acc = (pred.argmax(-1) == tgt).to(torch.float32).mean()
    return -ll.mean(), acc


def _mesh_world(flags) -> int:
    """Ranks of the host's mesh (0: no mesh)."""
    axes = parallel.mesh.parse_axes(flags.mesh)
    if not axes:
        return 0
    if any(v == -1 for v in axes.values()):
        if "WORLD_SIZE" not in os.environ:
            raise ValueError("--mesh with a -1 axis needs the world size: start the "
                             "ranks with torchrun, or give every axis its size")
        return int(os.environ["WORLD_SIZE"])
    return math.prod(axes.values())


def _check_flags(flags) -> None:
    """The JAX example's flag rules."""
    elastic = bool(flags.address or flags.connect or flags.broker_addrs)
    if flags.shard_grads and not elastic:
        raise ValueError(
            "--shard_grads is the hierarchical (inter-host) reduce plane; "
            "it requires the elastic cohort (--address/--connect).  A "
            "standalone mesh run already reduces over the mesh inside the step."
        )
    if elastic:
        # Elastic DP rides the plain single-device step: drop the PARSER
        # DEFAULTS that only make sense in-mesh so `--connect HOST` works
        # as documented; an explicitly-requested mesh is a real conflict —
        # unless --shard_grads composes the two planes hierarchically.
        if flags.mesh == "dp=2,sp=4":
            flags["mesh"] = ""
        if flags.attention == "ring" and not flags.mesh:
            flags["attention"] = "dense"
        if flags.mesh and not flags.shard_grads:
            raise ValueError(
                "elastic DP (--address/--connect) composes with the plain "
                "single-device step; in-mesh parallelism belongs inside a "
                "static cohort (use the vtrace agent's --mesh for that "
                "shape, or pass --shard_grads for the hierarchical plane)"
            )
    _check_model_parallel_flags(flags)
    if flags.publish_every and not elastic:
        raise SystemExit("--publish_every: the leader of an elastic cohort publishes; "
                         "pass --address, --connect or --broker_addrs")
    if flags.seq_len % 2:
        raise ValueError("--seq_len must be even")
    world = _mesh_world(flags)
    if world and flags.batch_size % parallel.mesh.parse_axes(flags.mesh).get("dp", 1):
        raise ValueError("the dp axis size must divide --batch_size")


def _check_model_parallel_flags(flags) -> None:
    """The JAX example's rules for ring, MoE and the pipeline, word for word."""
    axes = parallel.mesh.parse_axes(flags.mesh)
    if axes:
        if flags.attention == "ring":
            if "sp" not in axes:
                raise ValueError("attention='ring' needs an sp axis in --mesh")
            if axes["sp"] > 0 and flags.seq_len % axes["sp"]:
                raise ValueError("the sp axis size must divide --seq_len")
    elif flags.attention == "ring":
        raise ValueError("attention='ring' needs --mesh with an sp axis")
    if flags.moe_experts and flags.layers < 2:
        # MoE lands on every 2nd block; with a single layer no expert would
        # ever be created.
        raise ValueError("--moe_experts needs --layers >= 2")
    pp = axes.get("pp", 1)
    if pp > 1:
        if flags.attention == "ring":
            raise ValueError("pipeline (pp) composes with dense/flash, not ring")
        if flags.moe_experts:
            raise ValueError("pipeline (pp) needs identical blocks (no --moe_experts)")
        if flags.layers != flags.pp_repeats * pp:
            raise ValueError(f"--layers must be pp_repeats*pp = {flags.pp_repeats * pp}")
        microbatches = flags.microbatches or 2 * pp
        if flags.batch_size % microbatches:
            raise ValueError("--batch_size must be divisible by --microbatches")
        if (flags.batch_size // microbatches) % axes.get("dp", 1):
            raise ValueError(
                "the per-microbatch batch (batch_size/microbatches) must be "
                "divisible by the dp axis size"
            )


def train(flags, on_stats=None, _dist_args=()) -> dict:
    """Train; returns the run's summary (on a mesh host, rank 0's).  A
    ``--mesh`` run started without ``RANK`` spawns its other ranks and
    joins them when it ends (``_dist_args``: this rank's
    ``(coordinator, world, rank)``, or None off a mesh)."""
    if _dist_args == ():
        _check_flags(flags)
        world = _mesh_world(flags)
        if world and "RANK" not in os.environ:
            return common.run_mesh_host(train, "moolib_tpu_torch.examples.lm", flags,
                                        on_stats, world)
        _dist_args = (None, world, None) if world else None
    from ..utils import init_compile_cache

    # Before the first kernel load: a restart loads the kernels its fleet
    # built (--compile_cache_dir / MOOLIB_COMPILE_CACHE; no-op when unset).
    init_compile_cache(flags.compile_cache_dir)
    device = resolve(flags.device)
    telemetry.init_from_env()  # opt-in exporters (docs/TELEMETRY.md)
    # kill -USR2 toggles an on-demand torch.profiler window.
    telemetry.profiling.install_signal_toggle()
    from ..testing import faults as _faults

    _faults.install_from_env()  # opt-in chaos (MOOLIB_FAULTS; no-op unset)
    mesh = None
    if _dist_args is not None:
        coordinator, world, rank = _dist_args
        parallel.initialize_distributed(coordinator, world if coordinator else None, rank,
                                        device=device)
        mesh = parallel.parse_mesh_spec(flags.mesh, device_type=device.type)
        device = resolve(flags.device)  # the card the rank was bound to

    model = make_model(flags, device)
    elastic = bool(flags.address or flags.connect or flags.broker_addrs)
    # A static mesh (dp, sp, ep, pp axes); the elastic cohort's mesh host
    # is _MeshHost.
    mp = _StaticMesh(flags, mesh, model) if mesh is not None and not elastic else None
    rng = np.random.default_rng(flags.seed)
    tokens0 = torch.from_numpy(make_batch(rng, flags)).to(device)
    opt = make_optimizer(model.parameters(), flags.learning_rate)
    half = flags.seq_len // 2

    def fwd_bwd(tokens):
        opt.zero_grad(set_to_none=True)
        loss, acc = copy_task_loss(model(tokens), tokens, half)
        loss.backward()
        return loss.detach(), acc

    if mp is not None:
        step = mp.make_step(opt)
    else:
        def step(tokens):
            with telemetry.devmon.dispatch_span("lm.step"):
                loss, acc = fwd_bwd(tokens)
                opt.step()
            return loss, acc

    # Durable state: manifest-validated checkpoints; resume picks the
    # newest INTACT one (corruption costs one interval).  Not restored: the
    # numpy data rng — the resumed stream replays from the seed, immaterial
    # for this synthetic i.i.d. copy task.
    ckpt = None
    start_step = 0
    ckpt_info = {"restored_step": None, "restore_s": None, "saves": 0,
                 "save_s": None, "bytes": None}
    dckpt = restored_opt = None
    rank0 = mesh is None or int(mesh.mesh.flatten()[0]) == torch.distributed.get_rank()
    if flags.checkpoint_dir and elastic and flags.shard_grads:
        # Sharded cohorts checkpoint as a DISTRIBUTED artifact: every host
        # writes its shard of the state blob, the leader two-phase-commits
        # the cohort manifest, and restore re-cuts onto whatever cohort
        # size shows up.  Every rank of a mesh host restores the same
        # committed blob (the files are shared).
        from ..checkpoint import DistributedCheckpointer
        from .common import copy_into

        dckpt = DistributedCheckpointer(flags.checkpoint_dir)

    def restore() -> int:
        if mp is not None:
            return mp.restore(ckpt, opt, device)
        if dckpt is None:
            return resume(ckpt, model, opt, device)
        r = dckpt.restore(map_location=device)
        if r is None:
            return 0
        nonlocal restored_opt
        committed, (params, _buffers, st) = r
        with torch.no_grad():
            copy_into(dict(model.named_parameters()), params)
        restored_opt = st["opt_state"]
        if mesh is None:
            _load_adamw_state(opt, restored_opt)
        return committed

    if flags.checkpoint_dir and dckpt is None:
        ckpt = Checkpointer(flags.checkpoint_dir)
    if flags.checkpoint_dir:
        t0 = time.perf_counter()
        start_step = restore()
        if start_step:
            ckpt_info["restored_step"] = start_step
            ckpt_info["restore_s"] = time.perf_counter() - t0
            if not flags.quiet and rank0:
                print(f"resumed from checkpoint step {start_step}", flush=True)

    def save_checkpoint(steps):
        t0 = time.perf_counter()
        # A model-parallel mesh gathers its ep-sharded experts first (every
        # rank takes part); rank 0 writes one copy of the whole state.
        state = (mp.checkpoint_state(opt, steps) if mp is not None
                 else checkpoint_state(model, opt, steps) if rank0 else None)
        if not rank0:
            return
        path = ckpt.save(steps, state)
        ckpt_info["save_s"] = time.perf_counter() - t0
        ckpt_info["saves"] += 1
        ckpt_info["bytes"] = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))

    # Outside the clock: the warm-up pass builds the kernels on first use
    # and warms the GEMM heuristics; its gradients are dropped and the
    # optimizer never sees them (the JAX example's discarded compile step).
    # It runs under devmon's FLOP counter: the step cost for the MFU (the
    # flash kernels are not aten ops, so attention is not counted on the
    # card — comparable to the 6·N·tokens count).  A mesh with a pp axis
    # reports no MFU (_StaticMesh.warmup).
    host = None
    if mp is not None:
        step_cost = mp.warmup(tokens0)
        if flags.probe_dir:
            mp.probe(flags.probe_dir, rank0)
    elif elastic and mesh is not None:
        host = _MeshHost(flags, mesh, model, rng, device)
        if restored_opt is not None:
            host.load_opt_local(restored_opt)
        step_cost = host.warmup(tokens0)
    else:
        step_cost = telemetry.devmon.step_cost("lm.step", fwd_bwd, tokens0)
    opt.zero_grad(set_to_none=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    if elastic:
        if host is not None and host.rank != 0:
            return host.follow()
        # A failing rank 0 leaves its other ranks waiting on a command: the
        # host that spawned them kills them (torchrun tears its group down).
        return _train_elastic(flags, model, opt, rng, fwd_bwd, step_cost, device,
                              on_stats=on_stats, start_step=start_step,
                              save_checkpoint=save_checkpoint if ckpt else None,
                              ckpt_info=ckpt_info, host=host, dckpt=dckpt)

    start = time.time()
    last_ckpt = start
    loss = acc = None
    steps_done = start_step
    timer = StepTimer()  # registry-backed section breakdown (docs/TELEMETRY.md)
    wd = Watchdog(timeout=flags.watchdog, name="lm")
    step_seconds = []  # host time of each step (a mesh step ends in its loss's collective)
    try:
        for i in range(start_step, flags.steps):
            with timer.section("make_batch"), wd.section("make_batch"):
                tokens = torch.from_numpy(make_batch(rng, flags)).to(device)
            with timer.section("train_step"), wd.section("train_step"):
                loss, acc = step(tokens)
            step_seconds.append(timer.last["train_step"])
            steps_done = i + 1
            if steps_done % flags.log_interval == 0:
                loss_v, acc_v = float(loss), float(acc)
                telemetry.devmon.sample_memory()
                mfu_info = None
                step_s = timer.summary().get("train_step")
                if step_cost is not None and step_s:
                    mfu_info = telemetry.devmon.publish_step("lm.step", step_cost, step_s)
                if not flags.quiet and rank0:
                    mfu_s = (f" mfu={mfu_info['mfu']:.3%} bound={mfu_info['bound']}"
                             if mfu_info is not None else "")
                    # Overlap attribution from the last timeline window,
                    # when MOOLIB_TIMELINE_INTERVAL enabled the plane.
                    tl = telemetry.timeline.status()
                    tl_s = ""
                    if tl["windows"] and tl["last_report"] is not None:
                        tl_s = (f" exposed_comm="
                                f"{tl['last_report']['exposed_comm_seconds']:.4f}s")
                    print(f"step={steps_done} loss={loss_v:.4f} acc={acc_v:.3f}{mfu_s}{tl_s}",
                          flush=True)
                if on_stats is not None:
                    on_stats({"step": steps_done, "loss": loss_v, "acc": acc_v})
            due = ckpt is not None and time.time() - last_ckpt > flags.checkpoint_interval
            if mp is not None and ckpt is not None:
                due = mp.agree(due)  # rank 0's clock decides for the whole mesh
            if due:
                last_ckpt = time.time()
                save_checkpoint(steps_done)
    finally:
        wd.close()
        # A watchdog expiry / interrupt still leaves a resumable checkpoint.
        if ckpt is not None and steps_done > start_step:
            save_checkpoint(steps_done)
        telemetry.flush()  # final JSONL snapshot + host trace, if enabled
    loss_v = None if loss is None else float(loss)  # waits for the last step
    acc_v = None if acc is None else float(acc)
    elapsed = time.time() - start
    # Final MFU: short runs can end between log ticks; computed from the
    # train_step EMA so out["mfu"] is set whenever steps ran.
    mfu_v = None
    step_s = timer.summary().get("train_step")
    if step_cost is not None and step_s:
        fin = telemetry.devmon.publish_step("lm.step", step_cost, step_s)
        if fin is not None:
            mfu_v = fin["mfu"]
    return {
        "steps": steps_done,
        "start_step": start_step,
        "loss": loss_v,
        "acc": acc_v,
        "mfu": mfu_v,
        "tokens_per_s": (steps_done - start_step) * flags.batch_size * flags.seq_len
        / max(elapsed, 1e-6),
        "checkpoint": ckpt_info,
        "rank": 0 if mesh is None else torch.distributed.get_rank(),
        "params_sha256": params_sha256(dict(model.named_parameters())),
        "step_s": step_seconds,
        **({} if mp is None else {"ranks": mp.rank_summaries()}),
    }


class _StaticMesh:
    """The static mesh: ``dp``, and the model axes ``tp``, ``sp``, ``ep``
    and ``pp`` (the JAX example's ``jit`` over its mesh, per rank).  The
    tokens shard over ``dp``, and over ``sp`` under ring attention; ``tp``,
    ``ep`` and ``pp`` ranks hold replicas of them (the parameters are
    replicated over ``tp``, as the JAX example places them).  Built on every rank, right after the
    model: it cuts the model's experts to this rank's ``ep`` block.  Its
    methods with collectives are entered by every rank in the same order."""

    def __init__(self, flags, mesh, model: TransformerLM):
        sizes = parallel.mesh.axis_sizes(mesh)
        self.flags, self.mesh, self.model = flags, mesh, model
        self.dp, self.sp, self.ep, self.pp = (sizes.get(a, 1) for a in ("dp", "sp", "ep", "pp"))
        self.ring = flags.attention == "ring"
        self.n_tok = self.dp * (self.sp if self.ring else 1)
        self.half = flags.seq_len // 2
        self.n_scored = flags.batch_size * (flags.seq_len - self.half)
        self.microbatches = flags.microbatches or 2 * self.pp
        self.shardings = None
        self.experts: list = []
        if flags.moe_experts and self.ep > 1:
            from ..parallel.moe import shard_experts

            self.shardings = parallel.moe_shardings(dict(model.named_parameters()), mesh, "ep")
            self.experts = [k for k, sh in self.shardings.items() if "ep" in tuple(sh.spec)]
            self.full_shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
            shard_experts(model, mesh)
        self.named = dict(model.named_parameters())
        self.warm = None

    def batch(self, tokens) -> dict:
        """The step's batch: tokens, next-token targets and the scored
        positions' weights, all [B, T] (the step cuts each rank's block)."""
        weight = torch.zeros(tokens.shape, dtype=torch.float32, device=tokens.device)
        weight[:, self.half - 1: -1] = 1.0
        return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1), "weight": weight}

    def loss_fn(self, params, b, rng):
        """This rank's local loss and accuracy: its scored positions' sum
        over the global count, times the token shards (their mean is the
        global value; the JAX example's mean over the repeated half), plus
        the MoE aux losses."""
        flags = self.flags
        aux = 0.0
        if self.pp > 1:
            from ..models.transformer import pipeline_lm_apply

            logits = pipeline_lm_apply(
                self.model, b["tokens"], self.mesh, num_microbatches=self.microbatches,
                data_axis="dp" if self.dp > 1 else None, circular_repeats=flags.pp_repeats,
                remat=flags.remat, remat_policy=flags.remat_policy)
        else:
            logits = self.model(b["tokens"], mesh=self.mesh)
            if self.model.aux_losses:
                aux = sum(self.model.aux_losses)
        tgt, w = b["targets"].long(), b["weight"]
        scale = self.n_tok / self.n_scored
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = logp.gather(-1, tgt[..., None])[..., 0]
        acc = ((logits.argmax(-1) == tgt).to(torch.float32) * w).sum() * scale
        return -(ll * w).sum() * scale + flags.moe_aux_weight * aux, acc

    def make_step(self, opt):
        spec = parallel.PartitionSpec("dp", "sp" if self.ring else None)
        self.mstep = parallel.make_train_step(self.loss_fn, optimizer=opt, mesh=self.mesh,
                                              params_sharding=self.shardings, batch_spec=spec)

        def step(tokens):
            _, _, loss, acc = self.mstep(self.named, None, self.batch(tokens), None)
            return loss, acc

        return step

    def warmup(self, tokens, run=None):
        """Forward, backward and the in-mesh reduction without the update
        (``run(tokens)``, by default the step's ``grads``): the reduced
        gradients stay in ``.grad`` (the probe reads them).  Without a
        ``pp`` axis it runs under devmon's FLOP counter and returns this
        rank's step cost (the MFU's); the counter's module hooks break the
        pipeline's per-tick ``autograd.grad``.  The counter swallows
        errors, so a failure is raised here: a rank that went on would
        leave its collectives out of step with the others'."""
        if run is None:
            def run(t):
                return self.mstep.grads(self.named, self.batch(t), None)
        if self.pp > 1:
            self.warm = run(tokens)
            return None
        failed = []

        def counted(t):
            try:
                self.warm = run(t)
            except BaseException as e:
                failed.append(e)
                raise

        cost = telemetry.devmon.step_cost("lm.step", counted, tokens)
        if failed:
            raise failed[0]
        if self.warm is None:  # the count was cached: the warm-up still runs
            self.warm = run(tokens)
        return cost

    def _full(self, tree: dict) -> dict:
        """Every rank's ``{name: tensor}`` with the expert leaves gathered
        to their ``ep`` group's rank 0 (None on the others)."""
        from ..parallel.collectives import _dtensor

        ex = {k: _dtensor(v, self.shardings[k.split("/", 1)[1]],
                          self.full_shapes[k.split("/", 1)[1]])
              for k, v in tree.items() if k.split("/", 1)[1] in self.experts}
        got = parallel.gather_full(ex) if ex else {}
        if got is None:
            return None
        return {**tree, **got}

    def probe(self, directory: str, rank0: bool) -> None:
        """Rank 0 writes the warm-up's global loss and accuracy and every
        reduced gradient in the single-device layout to
        ``directory/step0.pt``."""
        grads = {f"g/{k}": (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.named.items()}
        full = self._full(grads)
        if not rank0:
            return
        os.makedirs(directory, exist_ok=True)
        torch.save({"loss": float(self.warm[0]), "acc": float(self.warm[1]),
                    "grads": {k[2:]: v.detach().cpu() for k, v in full.items()}},
                   os.path.join(directory, "step0.pt"))

    def checkpoint_state(self, opt, steps: int):
        """The whole state in the single-device layout on mesh rank 0
        (None elsewhere): the experts and their AdamW moments gathered."""
        sd = self.model.state_dict()
        osd = opt.state_dict()
        if not self.experts:
            return {"params": sd, "opt_state": osd, "steps": int(steps)}
        order = list(self.named)
        tree = {f"p/{k}": sd[k] for k in self.experts}
        for k in self.experts:
            for m in ("exp_avg", "exp_avg_sq"):
                st = osd["state"].get(order.index(k))
                if st is not None:
                    tree[f"{m}/{k}"] = st[m]
        full = self._full(tree)
        if full is None:
            return None
        for key, v in full.items():
            kind, name = key.split("/", 1)
            if kind == "p":
                sd[name] = v
            else:
                osd["state"][order.index(name)] = {**osd["state"][order.index(name)], kind: v}
        return {"params": sd, "opt_state": osd, "steps": int(steps)}

    def restore(self, ckpt, opt, device) -> int:
        """Restore a whole-state checkpoint (either layout's writer), cutting
        the experts and their moments to this rank's block."""
        from ..parallel.collectives import shard_of

        st = ckpt.restore(map_location=device)
        if st is None:
            return 0
        cut = (lambda k, t: shard_of(t, self.shardings[k]).clone()
               if k in self.experts else t)
        with torch.no_grad():
            for k, p in self.named.items():
                p.copy_(cut(k, st["params"][k]))
        order = list(self.named)
        osd = st["opt_state"]
        for i, s in osd["state"].items():
            for m in ("exp_avg", "exp_avg_sq"):
                if m in s:
                    s[m] = cut(order[int(i)], s[m])
        _load_adamw_state(opt, osd)
        return int(st["steps"])

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (a decision with collectives in it)."""
        t = torch.tensor([int(flag)])
        torch.distributed.broadcast(t, int(self.mesh.mesh.flatten()[0]))
        return bool(t.item())

    def rank_summaries(self) -> list:
        """Every rank's summary (an all-gather): replicated-leaf and expert
        sha256, peak memory, host-staged bytes, the ring's exposed hop
        seconds, the flash launches, and the MoE tokens over capacity in
        the last step."""
        from ..ops import flash_attention as fa
        from ..parallel.moe import SwitchMoE

        reg = telemetry.get_registry()
        dev = self.model.device
        dropped = [m.last_dropped for m in self.model.modules()
                   if isinstance(m, SwitchMoE) and hasattr(m, "last_dropped")]
        info = {
            "rank": torch.distributed.get_rank(),
            "coords": {a: self.mesh.get_local_rank(a) for a in self.mesh.mesh_dim_names},
            "params_sha256": params_sha256({k: v for k, v in self.named.items()
                                            if k not in self.experts}),
            "experts_sha256": params_sha256({k: self.named[k] for k in self.experts})
            if self.experts else None,
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None),
            "host_staged_bytes": _counter(reg, "collectives_host_staged_bytes_total"),
            "ring_hop_seconds": _hist_sum(reg, "ring_hop_seconds"),
            "launches": {"flash_fwd": fa.flash_fwd_launches(),
                         "flash_bwd_dq": fa.flash_bwd_dq_launches(),
                         "flash_bwd_dkv": fa.flash_bwd_dkv_launches()},
            "moe_dropped_last_step": int(sum(int(d) for d in dropped)) if dropped else None,
        }
        out = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(out, info)
        return out


def params_sha256(named) -> str:
    """sha256 of the f32 parameters in name order (the cohort-equality
    check)."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(named):
        h.update(named[k].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _load_adamw_state(opt, state) -> None:
    """A leader's AdamW ``state_dict`` (arrived as tensors on this device)
    into ``opt``: the step counts go back to the host, where a
    non-capturable AdamW keeps them."""
    for s in state["state"].values():
        if isinstance(s.get("step"), torch.Tensor):
            s["step"] = s["step"].cpu()
    opt.load_state_dict(state)


class _MeshHost:
    """The ranks of one mesh host in an elastic cohort.  Rank 0 holds the
    host's Accumulator peer and decides; before each piece of work it
    broadcasts one command (and an argument) over the mesh, and the other
    ranks, in :meth:`follow`, run the same method.  Every method below is
    entered by every rank in the same order (its collectives are matched).

    The ranks run the static mesh's model (:class:`_StaticMesh`: ring
    attention over ``sp``, experts cut over ``ep``, the pipeline over
    ``pp``) and its loss, with the ``tp`` blocks of
    ``parallel.tensor_parallel.shard_model`` over ``tp``.  A rank holds its
    ``ep`` and ``tp`` blocks and the other parameters whole; rank 0 also
    keeps the whole model (``model``), which its Accumulator peer, model
    sync, checkpoints and publisher read, and refreshes it after every
    update.  The gradients and the AdamW moments are laid out in
    :func:`host_layout`: the held axes, and FSDP over ``dp``.  The
    optimizer runs over this rank's blocks of that layout (views into its
    parameters), ZeRO-style, and ``parallel.redistribute`` brings the
    updated blocks back to the layout the ranks hold."""

    LEARN, APPLY, OPT_OUT, STATE_IN, STOP = range(1, 6)

    def __init__(self, flags, mesh, model, rng, device):
        import copy

        from ..parallel import tensor_parallel

        self.flags, self.mesh, self.model, self.rng, self.device = flags, mesh, model, rng, device
        self.control = common.MeshControl(mesh, device, axes=tuple(mesh.mesh_dim_names))
        self.rank = self.control.rank
        sizes = parallel.mesh.axis_sizes(mesh)
        cut = sizes.get("tp", 1) > 1 or (flags.moe_experts and sizes.get("ep", 1) > 1)
        # Rank 0's Accumulator keeps the whole model; the ranks' learners hold blocks.
        learner = copy.deepcopy(model) if cut and self.rank == 0 else model
        self.full_shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        if sizes.get("tp", 1) > 1:
            tensor_parallel.shard_model(learner, mesh)
        self.mp = _StaticMesh(flags, mesh, learner)
        self.named = self.mp.named  # model order: AdamW's indices
        self.shardings = host_layout(self.named, self.full_shapes, mesh, self.mp.shardings)
        # The layout the ranks hold each cut parameter in (its ep or tp axis).
        self.held = {k: _only(sh, ("ep", "tp")) for k, sh in self.shardings.items()
                     if {"ep", "tp"} & set(sh.spec)}
        self._flat_sh = nest.tree_leaves(self.shardings)
        self._template = {k: p.new_empty(()).expand(self.full_shapes[k])
                          for k, p in self.named.items()}
        with torch.no_grad():
            self.blocks = {k: self._block(k, p.detach()) for k, p in self.named.items()}
        self.opt = make_optimizer(self.blocks.values(), flags.learning_rate)
        ring = self.mp.ring
        self.step = parallel.make_train_step(
            self.mp.loss_fn, mesh=mesh, params_sharding=self.shardings, grad_spec="params",
            batch_spec=parallel.PartitionSpec("dp", "sp" if ring else None),
            overlap_grads=flags.overlap_grads)

    def _block(self, k: str, p):
        """This rank's block of leaf ``k`` in the layout, from the part of
        it the rank holds (a view)."""
        return parallel.shard_of(p, _only(self.shardings[k], ("dp",)))

    def command(self, cmd: int, arg: int = 0) -> None:
        """Rank 0: tell the other ranks what comes next."""
        self.control.send(cmd, arg)

    # -------------------------------------------------------------- work
    def _run(self, tokens):
        return self.step(self.named, self.mp.batch(tokens), None)

    def warmup(self, tokens):
        """The first forward/backward and in-mesh reduction, outside the
        clock, on every rank (its gradients are dropped); returns the step
        cost (:meth:`_StaticMesh.warmup`)."""
        cost = self.mp.warmup(tokens, run=self._run)
        for p in self.named.values():
            p.grad = None
        return cost

    def learn(self):
        """One forward/backward on this rank's block of the host batch (every
        rank draws the same host batch from the same seeded stream).
        Returns (loss, acc, grads): the host's loss and accuracy, ``grads``
        a tree of DTensors, or the GradientStream on rank 0 under
        ``--overlap_grads`` (None on the others, whose part ended inside the
        backward's hooks)."""
        return self._run(torch.from_numpy(make_batch(self.rng, self.flags)).to(self.device))

    def apply(self, grads) -> None:
        """ZeRO-style apply of the cohort mean ``grads`` (full, on rank 0;
        None elsewhere): rank 0 scatters each rank its blocks, every rank
        runs AdamW on them, the updated blocks go back to the layout the
        ranks hold, and rank 0 refreshes its whole model."""
        blocks = parallel.scatter_shards(grads, self._template, self._flat_sh, self.mesh)
        for k, g in zip(sorted(self.named), blocks):
            self.blocks[k].grad = g
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        whole = parallel.replicated(self.mesh)
        # The leaves cut over dp gather back; the others were updated in place.
        sharded = {k: parallel.collectives._dtensor(self.blocks[k], sh, self.full_shapes[k])
                   for k, sh in self.shardings.items() if "dp" in sh.spec}
        got = parallel.redistribute(sharded, {k: self.held.get(k, whole) for k in sharded})
        with torch.no_grad():
            for k, t in got.items():
                self.named[k].copy_(t.to_local())
        self._refresh()

    def _refresh(self) -> None:
        """Rank 0's whole model from the blocks the ranks hold (a gather of
        the held leaves; the rest are whole on rank 0)."""
        if not self.held:
            return
        wholes = parallel.gather_full({k: parallel.collectives._dtensor(
            self.named[k].detach(), sh, self.full_shapes[k]) for k, sh in self.held.items()})
        if self.rank != 0:
            return
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(wholes[k] if k in wholes else self.named[k])

    def _dtensor_moments(self):
        """This rank's AdamW moments as DTensors, per param index."""
        names = list(self.named)
        out = {}
        for i, st in self.opt.state_dict()["state"].items():
            k = names[i]
            out[i] = {m: parallel.collectives._dtensor(st[m], self.shardings[k],
                                                       self.full_shapes[k])
                      for m in ("exp_avg", "exp_avg_sq")}
        return out

    def opt_full(self):
        """The host's AdamW state as one whole-parameter ``state_dict`` on
        rank 0 (None elsewhere): the shape a one-device peer sends."""
        sd = self.opt.state_dict()
        moments = parallel.gather_full(self._dtensor_moments(), dst=0)
        if moments is None or self.rank != 0:
            return None
        for i, m in moments.items():
            sd["state"][i] = dict(sd["state"][i], **m)
        return sd

    def load_opt_local(self, sd) -> None:
        """Load a whole-parameter AdamW ``state_dict`` that every rank holds
        (a restored checkpoint): each rank keeps its blocks."""
        names = list(self.named)
        local = {"param_groups": sd["param_groups"], "state": {}}
        for i, st in sd["state"].items():
            k = names[int(i)]
            local["state"][int(i)] = {
                m: (parallel.shard_of(v.to(self.device), self.shardings[k])
                    if m in ("exp_avg", "exp_avg_sq") else v) for m, v in st.items()}
        _load_adamw_state(self.opt, local)

    def load_state(self, params, sd, n_state: int) -> None:
        """Rank 0 received the leader's model and AdamW state (``params``,
        ``sd``; None elsewhere): rank 0 takes the whole model, every rank
        the parts of the parameters it holds and its blocks of the moments."""
        if self.rank == 0 and self.held:
            common.copy_into(dict(self.model.named_parameters()), params)
        got = parallel.scatter_shards(params, self._template,
                                      [self.held.get(k) for k in sorted(self.named)], self.mesh)
        with torch.no_grad():
            for k, t in zip(sorted(self.named), got):
                self.named[k].copy_(t)
        names = list(self.named)
        state = {}
        for i in range(n_state):
            k = names[i]
            src = sd["state"][i] if sd is not None else None
            got = parallel.scatter_shards(
                None if src is None else {"a": src["exp_avg"], "b": src["exp_avg_sq"]},
                {"a": self._template[k], "b": self._template[k]}, [self.shardings[k]] * 2,
                self.mesh)
            steps = parallel.scatter_shards(
                None if src is None else {"s": torch.as_tensor(src["step"], dtype=torch.float32)
                                          .reshape(1).to(self.device)},
                {"s": torch.zeros(1, device=self.device)}, [None], self.mesh)[0]
            state[i] = {"step": steps.reshape(()).cpu(), "exp_avg": got[0],
                        "exp_avg_sq": got[1]}
        groups = self.opt.state_dict()["param_groups"]
        _load_adamw_state(self.opt, {"param_groups": groups, "state": state})

    # ----------------------------------------------------------- control
    def follow(self) -> dict:
        """The loop of ranks other than 0: run what rank 0 commands until it
        says stop.  Returns this rank's summary."""
        while True:
            cmd, arg = self.control.receive()
            if cmd == self.LEARN:
                _, _, grads = self.learn()
                if not self.flags.overlap_grads:
                    parallel.gather_full(grads, dst=0)
            elif cmd == self.APPLY:
                self.apply(None)
            elif cmd == self.OPT_OUT:
                self.opt_full()
            elif cmd == self.STATE_IN:
                self.load_state(None, None, arg)
            elif cmd == self.STOP:
                break
            else:
                raise RuntimeError(f"lm mesh rank {self.rank}: unknown command {cmd}")
        return self.stop(summary=self.summary())

    def summary(self) -> dict:
        """This rank's launches, memory, staged bytes, psum seconds, the
        sha256 of the parameters it holds whole (``params_sha256``, equal on
        every rank and host) and of its blocks (``held_sha256``)."""
        from ..ops import flash_attention as fa

        reg = telemetry.get_registry()
        return {
            "rank": self.rank,
            "coords": {a: self.mesh.get_local_rank(a) for a in self.mesh.mesh_dim_names},
            "launches": {"flash_fwd": fa.flash_fwd_launches(),
                         "flash_bwd_dq": fa.flash_bwd_dq_launches(),
                         "flash_bwd_dkv": fa.flash_bwd_dkv_launches()},
            "max_memory_allocated": (torch.cuda.max_memory_allocated(self.device)
                                     if self.device.type == "cuda" else 0),
            "host_staged_bytes": _counter(reg, "collectives_host_staged_bytes_total"),
            "psum_seconds": _hist_sum(reg, "accum_psum_seconds"),
            "params_sha256": params_sha256({k: v for k, v in self.named.items()
                                            if k not in self.held}),
            "held_sha256": params_sha256({k: self.named[k] for k in self.held})
            if self.held else None,
        }

    def stop(self, summary=None):
        """Rank 0: release the other ranks and gather every rank's summary
        (returned on rank 0).  The others: send theirs."""
        if self.rank == 0:
            self.command(self.STOP)
        out = self.control.gather_objects(summary if summary is not None else self.summary())
        return out if self.rank == 0 else out[self.rank]


def _only(sh, axes):
    """``sh`` with only the mesh axes ``axes`` left in its spec."""
    return parallel.mesh.NamedSharding(sh.mesh, parallel.PartitionSpec(
        *(a if a in axes else None for a in sh.spec)), sh.dims)


def host_layout(named: dict, full_shapes: dict, mesh, shardings=None) -> dict:
    """The layout of a mesh host's gradients and AdamW moments, per
    parameter name: the axes the parameter is held over (its ``tp`` tag
    from ``shard_model``, ``ep`` for experts from ``shardings``), and FSDP
    over ``dp`` on a dim they leave free (``parallel.param_shardings``).
    Decided on the whole shapes, so it is the same on every rank."""
    from ..parallel.tensor_parallel import held_sharding

    held = {}
    for k, p in named.items():
        tag = held_sharding(p)
        base = tag if tag is not None else (shardings or {}).get(k)
        spec = [s if s in ("ep", "tp") else None for s in (base.spec if base is not None else ())]
        spec += [None] * (len(full_shapes[k]) - len(spec))
        held[k] = parallel.mesh.NamedSharding(mesh, parallel.PartitionSpec(*spec),
                                              base.dims if base is not None else None)
    if parallel.mesh.axis_sizes(mesh).get("dp", 1) == 1:
        return held
    whole = {k: p.new_empty(()).expand(full_shapes[k]) for k, p in named.items()}
    return parallel.param_shardings(whole, mesh, "fsdp", held=held)


def _counter(reg, name: str) -> float:
    fam = reg.snapshot().get(name) or {}
    return float(sum(s.get("value", 0.0) for s in fam.get("series", ())))


def _print_exit_counts(learns: int) -> None:
    """The lines a soak reads from a peer that exits: each flash kernel's
    launches in this process beside the learn steps they came from (the
    warm-up pass launches once more), and the seeded frame faults' counts
    when ``MOOLIB_FAULTS`` installed them."""
    import json

    from ..ops import flash_attention as fa
    from ..testing import faults as _faults

    print(f"kernel_launches: {json.dumps(dict(fa.launch_counts(), learns=learns))}", flush=True)
    injected = _faults.install_from_env()  # idempotent: the process's injector, or None
    if injected is not None:
        print(f"frame_faults: {json.dumps(injected.counts)}", flush=True)


def _hist_sum(reg, name: str) -> float:
    fam = reg.snapshot().get(name) or {}
    return float(sum(s["value"].get("sum", 0.0) for s in fam.get("series", ())
                     if isinstance(s.get("value"), dict)))


def _train_elastic(flags, model, opt, rng, fwd_bwd, step_cost, device,
                   on_stats=None, start_step=0, save_checkpoint=None,
                   ckpt_info=None, host=None, dckpt=None) -> dict:
    """Elastic data-parallel LM training over the Accumulator cohort: the
    wants/has gradient protocol the RL agents ride (leader election, model
    sync, virtual batches, wire compression), applied unchanged to
    TransformerLM.  Peers join/leave freely; a joiner adopts the leader's
    model and AdamW state (JAX package ``examples/lm.py:500-865``).

    With a mesh ``host`` (rank 0 of a ``--mesh dp=N --shard_grads`` host)
    every learn, apply and state transfer is a ``_MeshHost`` step the other
    ranks take with it; ``dckpt`` is the distributed checkpoint plane."""
    import os as _os

    from .. import Accumulator, Broker

    # HA broker list: --broker_addrs joins (and, when hosting, replicates to)
    # the whole primary+standby set; --connect stays the single-address alias.
    broker_list = [a.strip() for a in (flags.broker_addrs or "").split(",") if a.strip()]
    if flags.address and broker_list and flags.address not in broker_list:
        broker_list = [flags.address] + broker_list
    broker = None
    if flags.address:
        broker = Broker()
        broker.set_name("broker")
        broker.listen(flags.address)
        standbys = [a for a in broker_list if a != flags.address]
        if standbys:
            broker.set_peer_brokers(standbys)
    # A comma-joined address flows through unchanged: Accumulator.connect
    # splits it into the failover list.
    addr = ",".join(broker_list) if broker_list else (flags.connect or flags.address)

    # Elastic fleet supervision: the broker-hosting peer can autoscale lm
    # worker subprocesses into this cohort.
    scaler = None
    if flags.autoscale:
        if broker is None:
            raise ValueError("--autoscale requires hosting the broker "
                             "(pass --address, not --connect)")
        from .. import autoscaler as autoscaler_mod

        fleet_dir = _os.path.join(flags.localdir or ".", "fleet")
        worker_args = [
            "--vocab", str(flags.vocab), "--seq_len", str(flags.seq_len),
            "--batch_size", str(flags.batch_size),
            "--d_model", str(flags.d_model), "--layers", str(flags.layers),
            "--heads", str(flags.heads), "--steps", str(flags.steps),
            "--virtual_batch_size", str(flags.virtual_batch_size),
            "--mesh", "", "--attention", flags.attention, "--quiet",
        ]
        if flags.device:
            worker_args += ["--device", flags.device]
        scaler = autoscaler_mod.Autoscaler(
            autoscaler_mod.AutoscalePolicy(flags.autoscale_min, flags.autoscale_max),
            autoscaler_mod.SubprocessFleet(
                autoscaler_mod.example_spawn(
                    addr, fleet_dir, "moolib_tpu_torch.examples.lm", worker_args),
                fleet_dir,
            ),
            poll_interval=flags.autoscale_interval,
        )
    from ..autoscaler import decommission_requested

    decommissioning = False

    named = dict(model.named_parameters())
    acc = Accumulator("lm", named)
    acc.set_name(flags.local_name or f"lm_{_os.getpid()}")
    if start_step:
        # Leader election prefers the restored peer.
        acc.set_model_version(start_step)
    acc.listen()
    if flags.shard_grads:
        # Wire protocol: every cohort peer must enable the sharded plane
        # (the per-range ops replace the single full-tree op).
        acc.set_sharded_allreduce(True)
    if flags.virtual_batch_size:
        acc.set_virtual_batch_size(flags.virtual_batch_size)
    if flags.wire_dtype == "bf16":
        acc.set_wire_dtype(torch.bfloat16)
    elif flags.wire_dtype == "int8":
        acc.set_wire_dtype("int8")
    acc.connect(addr)

    publisher = None
    announced_version = [0]  # latest version the accumulator announced
    if flags.publish_every:
        from ..serving import ModelPublisher

        # Every model-version advance (gradient apply, staged commit) lands
        # in the callback; the loop publishes at the step cadence.
        publisher = ModelPublisher(acc.rpc, name=flags.publish_channel)
        acc.add_model_version_callback(lambda v: announced_version.__setitem__(0, v))

    ostep = None
    if flags.overlap_grads and host is None:
        # One backward whose hooks stream the gradients into the round.
        half = flags.seq_len // 2
        ostep = parallel.make_train_step(
            lambda p, b, r: copy_task_loss(model(b), b, half), overlap_grads=True)

    steps_done = start_step
    applied = learns = 0
    loss_v = acc_v = first_loss = None
    exposed = []  # per round: step returned -> result ready (s)
    t_grads = None
    start = time.time()
    last_ckpt = start
    full_applies = []  # apply times while the cohort had --min_cohort members
    steps_counter = telemetry.get_registry().counter(
        "train_steps_total", "train-step invocations"
    )
    recovery_printed = False
    formed = False  # the cohort has had --form_cohort members
    timer = StepTimer()
    wd = Watchdog(timeout=flags.watchdog, name="lm")
    # Whole-run deadman: fed on every optimizer step, so a run whose
    # *progress* stalls (wedged reduce, lost cohort) fires even though no
    # single section is stuck.
    progress_token = wd.arm("step_progress")
    if dckpt is not None:
        # Distributed snapshots ride the accumulator's step lockstep: the
        # leader broadcasts a future boundary and every member captures its
        # shard asynchronously (checkpoint_tick below).
        acc.enable_distributed_checkpoint(dckpt, interval=flags.checkpoint_interval,
                                          aux_fn=lambda: {"steps": steps_done})
    opt_snapshot = {}

    def mesh_op():
        """A mesh host's rank 0 keeps pinging the broker while it waits in
        the mesh's collectives (seconds each at full width)."""
        import contextlib

        if host is None:
            return contextlib.nullcontext()
        return common.pumping([acc._group, broker])

    def opt_state_dict():
        if host is None:
            return opt.state_dict()
        with mesh_op():
            host.command(host.OPT_OUT)
            return host.opt_full()

    def ckpt_state_fn():
        # A mesh host gathers its sharded AdamW state before the tick that
        # may capture (below); the tick itself runs no collective.
        return {"opt_state": opt_snapshot.pop("v") if host is not None else opt.state_dict()}

    try:
        while steps_done < flags.steps:
            if broker is not None:
                broker.update()
            acc.update()
            if dckpt is not None:
                if host is not None and acc.checkpoint_capture_due():
                    opt_snapshot["v"] = opt_state_dict()
                acc.checkpoint_tick(state_fn=ckpt_state_fn)
            if scaler is not None:
                scaler.step()  # self-rate-limited supervision tick
            if decommission_requested(flags.localdir):
                decommissioning = True
                break  # drain + graceful __broker_leave in finally
            if acc.wants_state():
                acc.set_state({"opt_state": opt_state_dict(), "steps": steps_done})
            if acc.has_new_state():
                st = acc.state()
                if st is not None:
                    from .common import copy_into

                    if host is not None:
                        n_state = len(st["opt_state"]["state"])
                        with mesh_op():
                            host.command(host.STATE_IN, n_state)
                            host.load_state(acc.parameters(), st["opt_state"], n_state)
                    else:
                        copy_into(named, acc.parameters())
                        _load_adamw_state(opt, st["opt_state"])
                    acc.set_parameters(named)
                    steps_done = max(steps_done, int(st["steps"]))
            formed = formed or acc.cohort_size() >= flags.form_cohort
            if not acc.connected() or (applied and (acc.cohort_size() < flags.min_cohort
                                                    or not formed)):
                time.sleep(0.02)
                continue
            if acc.has_gradients():
                if flags.virtual_batch_size:
                    # The resize-stability contract: every APPLIED result
                    # carries at least the configured virtual batch.
                    stats = acc.get_gradient_stats()
                    if stats["batch_size"] < flags.virtual_batch_size:
                        print(f"vbatch_violation: {stats} "
                              f"target={flags.virtual_batch_size}", flush=True)
                if t_grads is not None:
                    # mtlint: allow-bare-timer(the end of the exposed-comm interval opened at the learn)
                    exposed.append(time.perf_counter() - t_grads)
                    t_grads = None
                with timer.section("apply"), wd.section("apply"):
                    grads = acc.gradients()
                    if host is not None:
                        with mesh_op():
                            host.command(host.APPLY)
                            host.apply(grads)
                    else:
                        for k, p in named.items():
                            p.grad = grads[k]
                        opt.step()
                    acc.set_parameters(named)
                    acc.zero_gradients()
                steps_done += 1
                applied += 1
                if acc.cohort_size() >= flags.min_cohort:
                    full_applies.append(time.time())
                steps_counter.inc()
                wd.feed(progress_token)
                if (publisher is not None and acc.is_leader() and announced_version[0]
                        and steps_done % flags.publish_every == 0):
                    from ..models.convert import to_flax

                    publisher.publish(to_flax(model), version=announced_version[0])
                if not recovery_printed:
                    rec = acc.recovery_info()
                    if rec["complete"]:
                        recovery_printed = True
                        import json as _json

                        print(f"recovered: {_json.dumps(rec)}", flush=True)
                if steps_done % flags.log_interval == 0:
                    if not flags.quiet:
                        print(f"step={steps_done} loss={loss_v} acc={acc_v} "
                              f"cohort={acc.cohort_size()}", flush=True)
                    if on_stats is not None:
                        on_stats({"step": steps_done, "loss": loss_v, "acc": acc_v,
                                  "cohort": acc.cohort_size()})
                if (save_checkpoint is not None and acc.is_leader()
                        and time.time() - last_ckpt > flags.checkpoint_interval):
                    last_ckpt = time.time()
                    save_checkpoint(steps_done)
            elif acc.wants_gradients():
                with timer.section("learn"), wd.section("learn"), \
                        telemetry.devmon.dispatch_span("lm.step"), mesh_op():
                    if host is not None:
                        host.command(host.LEARN)
                        loss, a, grads = host.learn()
                    else:
                        tokens = torch.from_numpy(make_batch(rng, flags)).to(device)
                        if ostep is not None:
                            loss, a, grads = ostep(named, tokens, None)
                        else:
                            loss, a = fwd_bwd(tokens)
                            grads = {k: p.grad for k, p in named.items()}
                    # mtlint: allow-bare-timer(exposed comm spans loop iterations; the summary lists each round)
                    t_grads = time.perf_counter()
                    acc.reduce_gradients(flags.batch_size, grads)
                    loss_v, acc_v = float(loss), float(a)
                    first_loss = loss_v if first_loss is None else first_loss
                    learns += 1
            else:
                time.sleep(0.002)
        # Leave together: a peer that applied the last result first (and may
        # host the broker) must not take that result's delivery down with it.
        # A decommissioned peer leaves alone, mid-run.
        from .common import finish_together

        if not decommissioning:
            finish_together(acc._group, [b for b in (broker,) if b] + [acc])
        cohort_end = {"params_sha256": params_sha256(named), "model_version": acc.model_version(),
                      "n_params": sum(p.numel() for p in named.values()),
                      "is_leader": acc.is_leader(), "recovery": acc.recovery_info()}
        ranks = host.stop() if host is not None else None
    finally:
        wd.close()
        if dckpt is not None:
            # Soak harnesses parse this line, the JAX example's byte for
            # byte: the async-capture overhead claim (stall < 10% of step
            # time during a snapshot) is measured here.
            s = dckpt.stats()
            print(
                "ckpt_async: captures=%d commits=%d stall_s=%.4f "
                "write_s=%.4f train_s=%.1f steps=%d" % (
                    s["captures"], s["commits"], s["stall_s"], s["write_s"],
                    time.time() - start, steps_done - start_step,
                ),
                flush=True,
            )
            dckpt.close()
        _print_exit_counts(learns=learns)
        if save_checkpoint is not None and steps_done > start_step and acc.is_leader():
            try:
                save_checkpoint(steps_done)
            except Exception as e:  # noqa: BLE001 — teardown must reach close()
                print(f"final checkpoint failed: {e!r}", flush=True)
        if decommissioning:
            acc.decommission(timeout=10.0)
        if scaler is not None:
            scaler.fleet.terminate_all()
        info = acc.debug_info()
        if publisher is not None:
            publisher.close()
        acc.close()
        if broker is not None:
            broker.close()
        telemetry.flush()  # final JSONL snapshot + host trace, if enabled
    elapsed = time.time() - start
    # MFU of the whole data-parallel step: one learner's counted forward +
    # backward over the median wall time between applied steps of the full
    # cohort (the cohort round and the optimizer included).
    per_step = float(np.median(np.diff(full_applies))) if len(full_applies) > 1 else None
    mfu_v = None
    if step_cost is not None and per_step:
        fin = telemetry.devmon.publish_step("lm.elastic_step", step_cost, per_step)
        if fin is not None:
            mfu_v = fin["mfu"]
    return {
        "steps": steps_done,
        "loss": loss_v,
        "first_loss": first_loss,
        "learns": learns,
        "acc": acc_v,
        "mfu": mfu_v,
        "tokens_per_s": applied * flags.batch_size * flags.seq_len / max(elapsed, 1e-6),
        "reduces": info["rpc_reduces"] + info["ici_reduces"],
        "wire_dtype": info["wire_dtype"],
        "step_s": per_step,
        "start_step": start_step,
        "decommissioned": decommissioning,
        "checkpoint": ckpt_info,
        "accumulator": info,
        "exposed_comm_s": exposed,
        "ranks": ranks,
        "checkpoint_stats": dckpt.stats() if dckpt is not None else None,
        **cohort_end,
    }


def main(argv=None):
    flags = common.mesh_flags_from_env()
    if flags is not None:  # a mesh rank spawned by its host's rank 0
        train(flags)
        return
    out = train(make_flags(argv))
    print(out)


if __name__ == "__main__":
    main()
