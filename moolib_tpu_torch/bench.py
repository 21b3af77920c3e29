"""IMPALA learner throughput on one card: the port's counterpart of the
repo-root ``bench.py`` (which stays the JAX package's benchmark).

Times the learner step — ImpalaNet forward + V-trace loss + backward +
RMSProp update, in place — at the reference Atari configuration
(``examples/vtrace/config.yaml:23-65``: 84x84x4 uint8 frames, 6 actions,
batch_size 32 unrolls of unroll_length 20, so [T+1, B] = [21, 32]), and
prints one JSON line:

    {"metric": "impala_learner_sps", "value": env frames/s, "step_ms": ...,
     "mfu": ..., "platform": "gpu", "device_kind": ..., ...}

``value`` is T·B frames per step over the median step; ``step_ms`` is the
median of CUDA-event times of single steps (at least 50, after warm-up);
``mfu`` is the analytic FLOPs of a step (3 × the forward's, counted by
:func:`analytic_forward_flops`) over the H100's 989 TFLOP/s bf16 peak.
The metric name follows the root bench's rules: ``_wide`` when
``MOOLIB_BENCH_CHANNELS`` changes the encoder widths, ``_smoke`` when
``MOOLIB_BENCH_T``/``MOOLIB_BENCH_B`` change the shape (for a CPU smoke).

    python -m moolib_tpu_torch.bench [--steps 100] [--warmup 10]
    MOOLIB_BENCH_T=2 MOOLIB_BENCH_B=2 python -m moolib_tpu_torch.bench --device cpu

Runs on CUDA unless ``--device cpu`` is passed (then the times are host
clock and no ``mfu`` is reported).
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ._device import resolve
from .examples.common import OptaxOptimizer, rmsprop
from .examples.vtrace.experiment import compute_loss
from .models.impala import ImpalaNet
from .utils.config import Config

# Reference IMPALA defaults (examples/vtrace/config.yaml), as in the root bench.
T, B = 20, 32
NUM_ACTIONS = 6
OBS = (84, 84, 4)
DISCOUNTING = 0.99
REALTIME_FLOOR_SPS = 2 * 128 * 60.0  # reference actor fleet at emulator speed
REF_CHANNELS = (16, 32, 32)
PEAK_BF16_FLOPS = 989e12  # NVIDIA H100 SXM data sheet, dense bf16
# The root bench's loss: pg + 0.5 * (0.5 * mean sq) + 0.01 * entropy.
LOSS_FLAGS = Config({"discounting": DISCOUNTING, "baseline_cost": 0.5, "entropy_cost": 0.01})


def _env_override(name, default, parse):
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return parse(raw)
    except ValueError:
        print(f"moolib_tpu_torch.bench: ignoring malformed {name}={raw!r}", file=sys.stderr)
        return default


def shape_from_env() -> tuple:
    """(T, B, channels) with the ``MOOLIB_BENCH_*`` overrides applied."""
    channels = _env_override("MOOLIB_BENCH_CHANNELS", REF_CHANNELS,
                             lambda raw: tuple(int(c) for c in raw.split(",")))
    return (_env_override("MOOLIB_BENCH_T", T, int), _env_override("MOOLIB_BENCH_B", B, int),
            channels)


def metric_name(t: int, b: int, channels: Sequence[int]) -> str:
    """The root bench's labels: ``_wide`` for other encoder widths,
    ``_smoke`` for another (T, B), so no such run publishes under the
    headline name."""
    metric = "impala_learner_sps_wide" if tuple(channels) != REF_CHANNELS else "impala_learner_sps"
    if (t, b) != (T, B):
        metric += "_smoke"
    return metric


def analytic_forward_flops(channels: Sequence[int] = REF_CHANNELS, obs=OBS, t1: int = T + 1,
                           b: int = B, hidden: int = 256, num_actions: int = NUM_ACTIONS) -> float:
    """Forward FLOPs of ImpalaNet (feed-forward) on [t1, b] frames, 2·m·k·n
    for every conv (as a matmul: m = frames·h·w, k = 9·c_in, n = c_out),
    the FC layer and the two heads; the arithmetic of the repo's
    ``benchmarks/impala_roofline.py:29-105``.  72.9 GFLOP at the reference
    shape (21·32 frames × 108.5 MFLOP)."""
    h, w, cin = obs
    flops = 0.0
    for ch in channels:
        flops += 2.0 * t1 * b * h * w * 9 * cin * ch
        h, w = math.ceil(h / 2), math.ceil(w / 2)
        flops += 4 * 2.0 * t1 * b * h * w * 9 * ch * ch  # two residual blocks, two convs each
        cin = ch
    flops += 2.0 * t1 * b * (h * w * cin) * hidden
    flops += 2.0 * t1 * b * (hidden + 1 + num_actions) * (num_actions + 1)
    return flops


def make_batch(t: int, b: int, device, obs=OBS) -> dict:
    """The root bench's batch: the same draws from ``default_rng(0)`` in
    the same order (``bench.py:150-157``), on ``device``."""
    rng = np.random.default_rng(0)
    batch = {
        "state": rng.integers(0, 256, size=(t + 1, b, *obs), dtype=np.uint8),
        "reward": rng.normal(size=(t + 1, b)).astype(np.float32),
        "done": rng.random((t + 1, b)) < 0.02,
        "prev_action": rng.integers(0, NUM_ACTIONS, size=(t + 1, b)),
        "action": rng.integers(0, NUM_ACTIONS, size=(t + 1, b)),
        "policy_logits": rng.normal(size=(t + 1, b, NUM_ACTIONS)).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def build_learner(device=None, channels: Optional[Sequence[int]] = None, obs=OBS,
                  seed: int = 0):
    """The root bench's model and optimizer on the port: ImpalaNet at
    ``channels`` ((16, 32, 32)), no LSTM, bf16 compute with f32
    parameters, and ``rmsprop(1e-3, 0.99, 0.01)``."""
    model = ImpalaNet(
        num_actions=NUM_ACTIONS, obs_shape=obs, channels=tuple(channels or REF_CHANNELS),
        use_lstm=False, dtype=torch.bfloat16, device=resolve(device),
        generator=torch.Generator().manual_seed(seed),
    )
    return model, OptaxOptimizer(model.parameters(), rmsprop(1e-3, decay=0.99, eps=0.01))


def learner_step(model, opt, batch) -> torch.Tensor:
    """Forward, the root bench's V-trace loss, backward and the update in
    place.  Returns the loss as a 0-d device tensor: no host sync unless
    the caller reads it."""
    opt.zero_grad()
    loss, _ = compute_loss(batch, (), model, LOSS_FLAGS)
    loss.backward()
    opt.step()
    return loss.detach()


def build_step(device=None, t: Optional[int] = None, b: Optional[int] = None,
               channels: Optional[Sequence[int]] = None, obs=OBS, seed: int = 0):
    """The root bench's learner step on the port: :func:`build_learner`
    and :func:`make_batch` at [T+1, B] = [t+1, b] ([21, 32]).  Returns
    ``(step, model, opt, batch)``, where ``step()`` is
    :func:`learner_step` on that batch."""
    dev = resolve(device)
    model, opt = build_learner(dev, channels, obs, seed)
    batch = make_batch(T if t is None else t, B if b is None else b, dev, obs)
    return functools.partial(learner_step, model, opt, batch), model, opt, batch


def step_times_ms(step, steps: int, device: torch.device) -> tuple:
    """Per-step milliseconds of ``steps`` consecutive steps (CUDA events
    between step ends on the card, the host clock on the CPU) and the
    losses as device tensors."""
    losses = []
    if device.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        events[0].record()
        for i in range(steps):
            losses.append(step())
            events[i + 1].record()
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(events, events[1:])], losses
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        times.append((time.perf_counter() - t0) * 1e3)
    return times, losses


def card_smi() -> Optional[str]:
    """``name, power.limit`` of the card from nvidia-smi, or None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run(device=None, steps: int = 100, warmup: int = 10) -> dict:
    t, b, channels = shape_from_env()
    dev = resolve(device)
    if dev.type == "cuda":
        steps = max(steps, 50)
    step, _, _, _ = build_step(dev, t, b, channels)
    _, warm_losses = step_times_ms(step, warmup, dev)
    times, losses = step_times_ms(step, steps, dev)
    losses = [float(x) for x in warm_losses + losses]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite learner loss: {losses}")
    step_ms = float(np.median(times))
    sps = t * b / (step_ms / 1e3)
    flops = 3.0 * analytic_forward_flops(channels, t1=t + 1, b=b)
    out = {
        "metric": metric_name(t, b, channels),
        "value": sps,
        "unit": "env_frames/s",
        "vs_baseline": sps / REALTIME_FLOOR_SPS,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "step_ms": step_ms,
        "step_ms_min": min(times),
        "step_ms_max": max(times),
        "steps_timed": steps,
        "model_tflops_per_step": flops / 1e12,
        "mfu": flops / (step_ms / 1e3) / PEAK_BF16_FLOPS if dev.type == "cuda" else None,
        "final_loss": losses[-1],
    }
    if dev.type == "cuda":
        out["smi"] = card_smi()
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    if tuple(channels) != REF_CHANNELS:
        out["channels"] = list(channels)
    if (t, b) != (T, B):
        out["T"], out["B"] = t, b
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="IMPALA learner throughput on one card")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--steps", type=int, default=100, help="timed steps (at least 50 are timed on a card)")
    p.add_argument("--warmup", type=int, default=10)
    args = p.parse_args(argv)
    print(json.dumps(run(args.device, args.steps, args.warmup)), flush=True)


if __name__ == "__main__":
    main()
