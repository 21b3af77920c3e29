"""LM training on one device: the port of the JAX package's
``examples/lm.py`` single-device path.

The task makes long-range attention load-bearing: each sequence is a random
prefix followed by its own repetition; the loss counts only the repeated
half, so predicting token ``t`` requires attending ``T/2`` positions back.
A model whose attention is broken cannot beat chance.

With ``--attention flash`` on the card every layer runs the hand-written
flash kernels: the forward, and the dq and dk/dv passes in the backward.

Run (the JAX defaults are a dp x sp mesh with ring attention, which this
slice does not port, so pass a single device and dense or flash):
    python -m moolib_tpu_torch.examples.lm --mesh "" --attention flash --steps 400
    python -m moolib_tpu_torch.examples.lm --mesh "" --attention dense --device cpu

Mesh and ring parallelism, MoE, pipeline stages, the elastic cohort, weight
publishing and checkpoints come with later slices; their flags exit with a
message.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import telemetry
from .._device import resolve
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
    # Flags of the JAX example whose planes are not ported yet.
    for flag in ("address", "connect", "broker_addrs", "local_name", "wire_dtype",
                 "localdir", "checkpoint_dir", "compile_cache_dir"):
        p.add_argument(f"--{flag}", default=None, help="not yet ported")
    for flag in ("shard_grads", "overlap_grads", "autoscale"):
        p.add_argument(f"--{flag}", action="store_true", help="not yet ported")
    p.add_argument("--virtual_batch_size", type=int, default=0)
    p.add_argument("--autoscale_min", type=int, default=1)
    p.add_argument("--autoscale_max", type=int, default=4)
    p.add_argument("--autoscale_interval", type=float, default=2.0)
    p.add_argument("--checkpoint_interval", type=float, default=30.0)
    p.add_argument("--publish_every", type=int, default=0, help="not yet ported")
    p.add_argument("--publish_channel", default="model")
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
    for name in ("address", "connect", "broker_addrs", "wire_dtype"):
        if flags.get(name):
            found.append((f"--{name}", 4))
    if flags.overlap_grads:
        found.append(("--overlap_grads", 4))
    if flags.shard_grads:
        found.append(("--shard_grads", 9))
    if flags.publish_every:
        found.append(("--publish_every", 5))
    if flags.autoscale:
        found.append(("--autoscale", 7))
    for name in ("checkpoint_dir", "compile_cache_dir"):
        if flags.get(name):
            found.append((f"--{name}", 7))
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
            'this port trains on one device: pass --mesh "" --attention flash|dense'
        )
    if flags.seq_len % 2:
        raise ValueError("--seq_len must be even")
    device = resolve(flags.device)
    telemetry.init_from_env()  # opt-in exporters (docs/TELEMETRY.md)

    model = TransformerLM(
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
    rng = np.random.default_rng(flags.seed)
    tokens0 = torch.from_numpy(make_batch(rng, flags)).to(device)
    opt = make_optimizer(model.parameters(), flags.learning_rate)
    half = flags.seq_len // 2

    def step(tokens):
        opt.zero_grad(set_to_none=True)
        loss, acc = copy_task_loss(model(tokens), tokens, half)
        loss.backward()
        opt.step()
        return loss.detach(), acc

    # Outside the clock: the warm-up pass builds the kernels on first use
    # and warms the GEMM heuristics; its gradients are dropped and the
    # optimizer never sees them (the JAX example's discarded compile step).
    loss, _ = copy_task_loss(model(tokens0), tokens0, half)
    loss.backward()
    opt.zero_grad(set_to_none=True)
    float(loss.detach())

    start = time.time()
    loss = acc = None
    steps_done = 0
    timer = StepTimer()  # registry-backed section breakdown (docs/TELEMETRY.md)
    wd = Watchdog(timeout=flags.watchdog, name="lm")
    try:
        for i in range(flags.steps):
            with timer.section("make_batch"), wd.section("make_batch"):
                tokens = torch.from_numpy(make_batch(rng, flags)).to(device)
            with timer.section("train_step"), wd.section("train_step"):
                loss, acc = step(tokens)
            steps_done = i + 1
            if steps_done % flags.log_interval == 0:
                loss_v, acc_v = float(loss), float(acc)
                if not flags.quiet:
                    print(f"step={steps_done} loss={loss_v:.4f} acc={acc_v:.3f}", flush=True)
                if on_stats is not None:
                    on_stats({"step": steps_done, "loss": loss_v, "acc": acc_v})
    finally:
        wd.close()
        telemetry.flush()  # final JSONL snapshot + host trace, if enabled
    loss_v = None if loss is None else float(loss)  # waits for the last step
    acc_v = None if acc is None else float(acc)
    elapsed = time.time() - start
    return {
        "steps": steps_done,
        "loss": loss_v,
        "acc": acc_v,
        "mfu": None,  # the device monitor (telemetry.devmon) comes with slice 7
        "tokens_per_s": steps_done * flags.batch_size * flags.seq_len / max(elapsed, 1e-6),
    }


def main(argv=None):
    out = train(make_flags(argv))
    print(out)


if __name__ == "__main__":
    main()
