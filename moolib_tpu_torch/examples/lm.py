"""LM training: the port of the JAX package's ``examples/lm.py`` — the
single-device path and the elastic data-parallel path.

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

Run (the JAX defaults are a dp x sp mesh with ring attention, which the
port does not have yet, so pass a single device and dense or flash):
    python -m moolib_tpu_torch.examples.lm --mesh "" --attention flash --steps 400
    python -m moolib_tpu_torch.examples.lm --mesh "" --attention dense --device cpu
    python -m moolib_tpu_torch.examples.lm --mesh "" --attention dense --device cpu \
        --address 127.0.0.1:4431 --local_name lm0 --virtual_batch_size 16   # + a
        second process with --connect 127.0.0.1:4431 --local_name lm1

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

Mesh and ring parallelism, MoE, pipeline stages and the sharded gradient
plane (and with it the distributed checkpoint of ``--checkpoint_dir
--shard_grads``) come with later slices; their flags exit with a message.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import telemetry
from .._device import resolve
from ..checkpoint import Checkpointer
from ..models.transformer import REMAT_POLICIES, TransformerLM
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
                   help="ring = sequence-parallel over the sp mesh axis (not yet ported)")
    p.add_argument("--mesh", default="dp=2,sp=4",
                   help='mesh axes for the train step (not yet ported): pass --mesh "" '
                   "for the single-device step")
    p.add_argument("--pos", default="learned", choices=["learned", "rotary"],
                   help="position encoding: learned table (capped at seq_len) or rotary")
    p.add_argument("--moe_experts", type=int, default=0)
    p.add_argument("--moe_aux_weight", type=float, default=0.01)
    p.add_argument("--microbatches", type=int, default=0)
    p.add_argument("--pp_repeats", type=int, default=1)
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
    # Flags of the JAX example whose planes are not ported yet.
    for flag in ("shard_grads", "overlap_grads"):
        p.add_argument(f"--{flag}", action="store_true", help="not yet ported (slice 9)")
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
                   "on restart")
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
    return common.finalize_flags(p, argv)


def _unported(flags) -> list:
    """(flag, slice) for every flag set to a path this slice does not port."""
    found = []
    if flags.mesh:
        found.append(("--mesh", 9))
    if flags.attention == "ring":
        found.append(("--attention ring", 9))
    if flags.moe_experts:
        found.append(("--moe_experts", 9))
    if flags.overlap_grads:
        found.append(("--overlap_grads", 9))
    if flags.shard_grads:
        # With --checkpoint_dir this is the distributed checkpoint plane of
        # the sharded rounds: slice 9 as well.
        found.append(("--shard_grads", 9))
    return found


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


def train(flags, on_stats=None) -> dict:
    unported = _unported(flags)
    if unported:
        raise SystemExit(
            "; ".join(f"{f}: not yet ported (slice {n})" for f, n in unported)
            + ". The JAX example's defaults are --mesh dp=2,sp=4 --attention ring; "
            'this port trains on one device per process: pass --mesh "" '
            "--attention flash|dense"
        )
    if flags.publish_every and not (flags.address or flags.connect or flags.broker_addrs):
        raise SystemExit("--publish_every: the leader of an elastic cohort publishes; "
                         "pass --address, --connect or --broker_addrs")
    if flags.seq_len % 2:
        raise ValueError("--seq_len must be even")
    from ..utils import init_compile_cache

    # Before the first kernel load: a restart loads the kernels its fleet
    # built (--compile_cache_dir / MOOLIB_COMPILE_CACHE; no-op when unset).
    init_compile_cache(flags.compile_cache_dir)
    device = resolve(flags.device)
    telemetry.init_from_env()  # opt-in exporters (docs/TELEMETRY.md)
    # kill -USR2 toggles an on-demand torch.profiler window.
    telemetry.profiling.install_signal_toggle()

    model = make_model(flags, device)
    rng = np.random.default_rng(flags.seed)
    tokens0 = torch.from_numpy(make_batch(rng, flags)).to(device)
    opt = make_optimizer(model.parameters(), flags.learning_rate)
    half = flags.seq_len // 2

    def fwd_bwd(tokens):
        opt.zero_grad(set_to_none=True)
        loss, acc = copy_task_loss(model(tokens), tokens, half)
        loss.backward()
        return loss.detach(), acc

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
    if flags.checkpoint_dir:
        ckpt = Checkpointer(flags.checkpoint_dir)
        t0 = time.perf_counter()
        start_step = resume(ckpt, model, opt, device)
        if start_step:
            ckpt_info["restored_step"] = start_step
            ckpt_info["restore_s"] = time.perf_counter() - t0
            if not flags.quiet:
                print(f"resumed from checkpoint step {start_step}", flush=True)

    def save_checkpoint(steps):
        t0 = time.perf_counter()
        path = ckpt.save(steps, checkpoint_state(model, opt, steps))
        ckpt_info["save_s"] = time.perf_counter() - t0
        ckpt_info["saves"] += 1
        ckpt_info["bytes"] = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))

    # Outside the clock: the warm-up pass builds the kernels on first use
    # and warms the GEMM heuristics; its gradients are dropped and the
    # optimizer never sees them (the JAX example's discarded compile step).
    # It runs under devmon's FLOP counter: the step cost for the MFU (the
    # flash kernels are not aten ops, so attention is not counted on the
    # card — comparable to the 6·N·tokens count).
    step_cost = telemetry.devmon.step_cost("lm.step", fwd_bwd, tokens0)
    opt.zero_grad(set_to_none=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    if flags.address or flags.connect or flags.broker_addrs:
        return _train_elastic(flags, model, opt, rng, fwd_bwd, step_cost, device,
                              on_stats=on_stats, start_step=start_step,
                              save_checkpoint=save_checkpoint if ckpt else None,
                              ckpt_info=ckpt_info)

    start = time.time()
    last_ckpt = start
    loss = acc = None
    steps_done = start_step
    timer = StepTimer()  # registry-backed section breakdown (docs/TELEMETRY.md)
    wd = Watchdog(timeout=flags.watchdog, name="lm")
    try:
        for i in range(start_step, flags.steps):
            with timer.section("make_batch"), wd.section("make_batch"):
                tokens = torch.from_numpy(make_batch(rng, flags)).to(device)
            with timer.section("train_step"), wd.section("train_step"):
                loss, acc = step(tokens)
            steps_done = i + 1
            if steps_done % flags.log_interval == 0:
                loss_v, acc_v = float(loss), float(acc)
                telemetry.devmon.sample_memory()
                mfu_info = None
                step_s = timer.summary().get("train_step")
                if step_cost is not None and step_s:
                    mfu_info = telemetry.devmon.publish_step("lm.step", step_cost, step_s)
                if not flags.quiet:
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
            if ckpt is not None and time.time() - last_ckpt > flags.checkpoint_interval:
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
    }


def _load_adamw_state(opt, state) -> None:
    """A leader's AdamW ``state_dict`` (arrived as tensors on this device)
    into ``opt``: the step counts go back to the host, where a
    non-capturable AdamW keeps them."""
    for s in state["state"].values():
        if isinstance(s.get("step"), torch.Tensor):
            s["step"] = s["step"].cpu()
    opt.load_state_dict(state)


def _train_elastic(flags, model, opt, rng, fwd_bwd, step_cost, device,
                   on_stats=None, start_step=0, save_checkpoint=None,
                   ckpt_info=None) -> dict:
    """Elastic data-parallel LM training over the Accumulator cohort: the
    wants/has gradient protocol the RL agents ride (leader election, model
    sync, virtual batches, wire compression), applied unchanged to
    TransformerLM.  Peers join/leave freely; a joiner adopts the leader's
    model and AdamW state (JAX package ``examples/lm.py:500-865``)."""
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

    steps_done = start_step
    applied = 0
    loss_v = acc_v = None
    start = time.time()
    last_ckpt = start
    full_applies = []  # apply times while the cohort had --min_cohort members
    steps_counter = telemetry.get_registry().counter(
        "train_steps_total", "train-step invocations"
    )
    recovery_printed = False
    timer = StepTimer()
    wd = Watchdog(timeout=flags.watchdog, name="lm")
    # Whole-run deadman: fed on every optimizer step, so a run whose
    # *progress* stalls (wedged reduce, lost cohort) fires even though no
    # single section is stuck.
    progress_token = wd.arm("step_progress")
    try:
        while steps_done < flags.steps:
            if broker is not None:
                broker.update()
            acc.update()
            if scaler is not None:
                scaler.step()  # self-rate-limited supervision tick
            if decommission_requested(flags.localdir):
                decommissioning = True
                break  # drain + graceful __broker_leave in finally
            if acc.wants_state():
                acc.set_state({"opt_state": opt.state_dict(), "steps": steps_done})
            if acc.has_new_state():
                st = acc.state()
                if st is not None:
                    from .common import copy_into

                    copy_into(named, acc.parameters())
                    _load_adamw_state(opt, st["opt_state"])
                    acc.set_parameters(named)
                    steps_done = max(steps_done, int(st["steps"]))
            if not acc.connected() or (applied and acc.cohort_size() < flags.min_cohort):
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
                with timer.section("apply"), wd.section("apply"):
                    grads = acc.gradients()
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
                        telemetry.devmon.dispatch_span("lm.step"):
                    tokens = torch.from_numpy(make_batch(rng, flags)).to(device)
                    loss, a = fwd_bwd(tokens)
                    loss_v, acc_v = float(loss), float(a)
                    acc.reduce_gradients(flags.batch_size,
                                         {k: p.grad for k, p in named.items()})
            else:
                time.sleep(0.002)
        # Leave together: a peer that applied the last result first (and may
        # host the broker) must not take that result's delivery down with it.
        # A decommissioned peer leaves alone, mid-run.
        from .common import finish_together

        if not decommissioning:
            finish_together(acc._group, [b for b in (broker,) if b] + [acc])
        import hashlib

        h = hashlib.sha256()
        for k in sorted(named):
            h.update(named[k].detach().float().cpu().numpy().tobytes())
        cohort_end = {"params_sha256": h.hexdigest(), "model_version": acc.model_version(),
                      "is_leader": acc.is_leader(), "recovery": acc.recovery_info()}
    finally:
        wd.close()
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
        **cohort_end,
    }


def main(argv=None):
    out = train(make_flags(argv))
    print(out)


if __name__ == "__main__":
    main()
