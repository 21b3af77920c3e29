"""Drive the PyTorch port on one CUDA card: build its kernels, hold each
against its plain version, train the d=1024/L=12 TransformerLM through
examples.lm.train(), run the lm_bench step, serve the same widths over
loopback Rpc and check the replies, run the IMPALA learner at the
reference Atari shape, fed once by EnvPool workers through the Batcher,
then allreduce full-width ImpalaNet and TransformerLM gradients taken
from the card through the port's Broker and Group, and train both in
two-learner Accumulator cohorts through the examples' own loops.

    python3 chip_smoke.py [--seed N]

Before anything touches CUDA, an EnvPool of SyntheticAtariEnv (4 worker
processes, 32 envs, 2 batches) is forked for phase 9.  Phases (any failure
exits non-zero, and no result line is printed):

1. device — require CUDA; print the card's name and power limit.
2. build — compile every kernel source under moolib_tpu_torch/ops/csrc
   (one nvcc each, all at once); print ptxas's register and spill lines
   and, from `cuobjdump -sass` of each library, every kernel's
   tensor-core instructions (HGMMA, HMMA).  Fails if a bfloat16
   forward, dq or dk/dv kernel has none, or if a bfloat16 build of their
   CUDA-core kernels exists.
3. kernels — at the serving prefill shape, the training shape and others,
   causal and full, float32 and bfloat16: flash_fwd against its plain
   version, and the backward's dq and dk/dv kernels against the plain
   backward run in f32 on the same q, k, v, out, lse and cotangent; the
   backward twice, bitwise equal; one lse-cotangent case per shape.  One
   JSON line per case with the errors and CUDA-event times of the kernels,
   the plain versions and torch's scaled_dot_product_attention (timed as a
   yardstick only; the port never calls it): its forward, and its backward
   alone as the median, min and max of 5 timings of 10 calls.
4. model — small float32 TransformerLMs on the card: flash attention (the
   kernels) against dense attention (plain torch) on the same weights, in
   the forward, the greedy tokens and every parameter gradient; and the
   remat policies against no remat.
5. train — the slice: examples.lm.train() on lm.py's copy task at vocab
   32768, d_model 1024, 12 layers, 8 heads of 128, bf16, flash attention,
   B=16 x T=1024, 20 AdamW steps at learning rate 1e-4 (lm_bench's).  The
   losses must be finite and fall, and each flash kernel must have run at
   least 12 x 20 times.  Step times, tokens/s, peak memory and a
   torch.profiler window of one step.
6. lm_bench — benchmarks/lm_bench.py's step on the port: lm_head_xent with
   4096-wide vocab chunks, backward, AdamW(1e-4), at (T, B) = (1024, 16)
   with max_len 8192; the fused loss against the materialized one on the
   first step; step time and MFU counted as lm_bench counts it.
7. slice (serving) — the same widths with rotary positions served by
   examples.lm_serve.serve() to 4 concurrent 1024-token prompts from a
   client Rpc; replies must equal the port's own generate() on the same
   batch, and the prefill must have launched flash_fwd once per layer.
   Prefill and generate() times, the host's time to enqueue one prefill,
   and a torch.profiler window of each.
8. impala_parity — ImpalaNet (feed-forward and LSTM, 84x84x4, f32 and
   bf16) and ActorCriticNet (LSTM, f32) on the card against the same model
   on the CPU, same weights and inputs: logits and baselines, then one
   step of examples.vtrace.experiment's compute_loss, backward and its
   clip + rmsprop update: the loss and every updated parameter, each
   within 1e-4 (f32) or 2e-2 (bf16) of max(1, max|CPU value|).
9. impala_learner — the slice: moolib_tpu_torch.bench's learner step
   (ImpalaNet (16, 32, 32) bf16, V-trace loss, backward, RMSProp) at
   T=20, B=32, 84x84x4, 6 actions, 200 steps: step times, frames/s,
   analytic TFLOP/s and MFU, peak memory, a torch.profiler window of 5
   steps (idle share, launches and device busy time per step, top device
   ops) and the host's time to issue one step.  Then the data
   path: actor forwards (T=1) and sampling on the card, actions back to the
   EnvPool through its CUDA-tensor seam, 21-step unrolls through
   Batcher(device="cuda") into 10 learner steps; each learner batch's
   frames must equal the shared-memory frames they came from.
10. cohort_impala — the cohort wire plane: a broker started with
   `python -m moolib_tpu_torch.broker` and four in-process peers (Rpc +
   Group).  Each holds one learner backward of the full-width ImpalaNet
   (bf16 compute, f32 parameters, no LSTM) at [T+1, B] = [21, 32] on its
   own seed's batch: 36 CUDA gradient leaves, 1,091,080 elements.  They
   reduce, as the dict of CUDA tensors it is, 20 rounds on each path: auto
   (the flat-bucket tree), the legacy tree, the ring, and the ring with the
   bf16 and q8 wires.  Every path: the four peers' result bytes equal, one
   pinned D2H staging event per peer round carrying every byte, and the
   result within rtol 1e-5, atol 1e-5 (f32 paths), 1e-2 x max|sum| (bf16)
   or 5e-2 x max|sum| (q8) of the float64 sum taken on the card.  Median
   round ms, the staging time and the bytes on the wire.  Then one
   GlobalStatsAccumulator round of the peers' losses and frames.
11. cohort_lm — two learner processes (spawned, each its own CUDA context
   on the card) build the d=1024/L=12 TransformerLM (max_len 1024, learned
   positions, bf16 compute, f32 parameters, flash attention) with the same
   weights, run one forward + backward each on their own B=4 x T=1024
   batch (the three flash kernels), and allreduce the ~219M-element f32
   gradient 5 times (auto: the flat-bucket tree).  Each result must equal
   grad_a + grad_b added on the card, bit for bit.  Round seconds,
   algorithm bandwidth, D2H staging and H2D-back times, peak memory.
12. accumulator_impala — the IMPALA training loop of slice 4b: two
   learner processes (spawned, one CUDA context each) run
   examples.vtrace.experiment.train(); learner 0 hosts the broker
   (--address), learner 1 joins (--connect).  Synthetic 84x84x4 uint8
   frames, the full-width ImpalaNet (16, 32, 32), no LSTM, bf16 compute,
   f32 parameters, 6 actions; unroll 20, learner batch 32, 2 actor batches
   of 32 envs over 4 env processes each, virtual batch 64, the device
   rollout, debug checksums on, to model version 50.  Both learners must
   end at the same version with bitwise-equal parameters (sha256 of the
   f32 parameters, compared here), zero checksum divergences, the
   non-leader synced through the chunked model transfer, and one
   buckets_d2h_events_total event per CUDA staging call.  SGD steps/s and
   learner frames/s across the cohort, count- and grad-round ms, model-sync
   bytes and ms, elections, env steps/s and act ms per learner, peak
   memory.
13. accumulator_lm — examples.lm's elastic path with the d=1024/L=12
   TransformerLM (max_len 1024, learned positions, bf16, f32 parameters,
   flash attention) on B=4 x T=1024 per learner, virtual batch 8:
   learner 0 (--address) applies one step alone, then learner 1
   (--connect) joins, receives the f32 parameters and the AdamW state
   through the chunked model sync (the same blob sha as the leader's), and
   the two take 5 steps together.  Bitwise-equal parameters at the end;
   step and grad-round seconds, algorithm bandwidth, model-sync GB/s, mfu
   from telemetry.devmon, peak memory and each flash kernel's launches,
   counted from 0 in each learner.

The last two lines are the kernel summary {"kernels": [...]}, with each
kernel's time, TFLOP/s, share of bound and tensor-core instruction count
at the training shape, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import json
import os
import queue
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from moolib_tpu_torch import bench, buckets, telemetry
from moolib_tpu_torch.batcher import Batcher
from moolib_tpu_torch.envpool import EnvPool
from moolib_tpu_torch.envs import SyntheticAtariEnv
from moolib_tpu_torch.examples import lm
from moolib_tpu_torch.examples.common import GlobalStatsAccumulator
from moolib_tpu_torch.examples.lm_serve import serve
from moolib_tpu_torch.examples.vtrace import experiment
from moolib_tpu_torch.models.actor_critic import ActorCriticNet
from moolib_tpu_torch.models.impala import ImpalaNet
from moolib_tpu_torch.models.transformer import TransformerLM, generate
from moolib_tpu_torch.ops import _build
from moolib_tpu_torch.ops import flash_attention as fa
from moolib_tpu_torch.ops.xent import lm_head_xent, naive_softmax_xent
from moolib_tpu_torch.group import Group
from moolib_tpu_torch.rpc import Rpc, serialization
from moolib_tpu_torch.utils import nest
from moolib_tpu_torch.utils.stats import StatMean, StatSum

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and float32 on the
# CUDA cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

KERNEL_SHAPES = [(1, 128, 2, 64), (4, 1024, 8, 128), (16, 1024, 8, 128), (2, 1000, 8, 128),
                 (1, 4096, 8, 128)]
SERVE_SHAPE = (4, 1024, 8, 128)  # the serving prefill: 4 prompts x 1024, 8 heads of 128
TRAIN_SHAPE = (16, 1024, 8, 128)  # the training step: 16 x 1024, 8 heads of 128
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}  # fwd (out, lse) atol
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # backward, x max(1, max|ref|)
TRAIN_STEPS = 20
# The repo's LM at lm_bench's widths (benchmarks/lm_bench.py:54-57,109-114).
LM_WIDTHS = ["--vocab", "32768", "--d_model", "1024", "--layers", "12", "--heads", "8"]
# impala_parity: card against CPU, error over max(1, max|CPU value|).
PARITY_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# impala_learner's data path: the actor fleet of one learner.
POOL = dict(num_processes=4, batch_size=32, num_batches=2)


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_call_ms(fn, reps: int) -> tuple:
    """(median, min, max) milliseconds of single calls, each timed by CUDA
    events, after one warm-up call.  For host-bound work, whose time
    varies from call to call with the host's load."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), min(times), max(times)


def enqueue_ms(fn, reps: int) -> float:
    """Median host milliseconds to enqueue one call of ``fn``, the card idle
    at the start of each and not waited for at the end.  Where it is most of
    the call's CUDA-event time, the call is bound by the host."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def bound_ms(ops: float, nbytes: float, dtype) -> tuple:
    """The least time for the work: the larger of its operations over the
    peak rate for ``dtype`` and its bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def flash_bounds(B, T, H, D, dtype, causal: bool) -> dict:
    """(bound ms, bound by, operations) of the three kernels on these
    inputs.  Per attended (query, key) pair: the forward does 2 products of
    2*D operations, the dq pass 3 (s, dp, dq) and the dk/dv pass 4 (s, dp,
    dv, dk).  Bytes: each [B, T, H, D] tensor read or written once
    (forward: q, k, v, out; dq pass: q, k, v, dO, dq; dk/dv pass: q, k, v,
    dO, dk, dv) plus the f32 row tables (forward: lse; backward: lse and
    delta)."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    tensor = B * T * H * D * (torch.finfo(dtype).bits // 8)
    row = B * T * H * 4
    work = {"flash_fwd": (4 * D * pairs, 4 * tensor + row),
            "flash_bwd_dq": (6 * D * pairs, 5 * tensor + 2 * row),
            "flash_bwd_dkv": (8 * D * pairs, 6 * tensor + 2 * row)}
    return {name: (*bound_ms(ops, nbytes, dtype), ops) for name, (ops, nbytes) in work.items()}


def device_profile(fn, top: int = 10) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), the
    device-busy total against the window's wall time, and launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_summary(prof, wall_ms, top)


def profile_summary(prof, wall_ms: float, top: int = 10) -> dict:
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.key[:90], e.self_device_time_total / 1e3, e.count) for e in kernels),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "kernel_launches": sum(r[2] for r in rows),
            "top": [[name, ms, n] for name, ms, n in rows[:top]],
            # The flash kernels' own device time, wherever they rank.
            "flash": [[name, ms, n] for name, ms, n in rows if "flash_" in name]}


def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    # References compute in true float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
         "name": torch.cuda.get_device_name(0), "smi": smi})
    return smi


def kernel_label(mangled: str) -> str:
    """``kernel<dtype,D,causal|full>`` from a mangled kernel name, which
    carries the template arguments (``Li<D>E``, ``Lb<0|1>E``) and the
    pointer types (``__nv_bfloat16`` or ``f``)."""
    kernel = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_wgmma)?_kernel)", mangled)
    d = re.search(r"Li(\d+)E", mangled)
    causal = re.search(r"Lb([01])E", mangled)
    return (f"{kernel.group(1) if kernel else mangled}"
            f"<{'bf16' if 'bfloat16' in mangled else 'f32'},"
            f"{d.group(1) if d else '?'},"
            f"{'causal' if causal and causal.group(1) == '1' else 'full'}>")


def ptxas_report(nvcc_log: str) -> dict:
    """ptxas -v's registers and spills per compiled kernel (its shared
    memory line counts static shared memory; these kernels take theirs
    dynamically, sized in the sources)."""
    out, name = {}, None
    for ln in nvcc_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = kernel_label(m.group(1))
            out[name] = []
        elif name is not None and ("spill" in ln or "Used" in ln):
            out[name].append(ln.split(":", 1)[-1].strip())
    return out


def sass_report(lib_path: str) -> dict:
    """Tensor-core instructions (``HGMMA``: wgmma; ``HMMA``: mma.sync) in
    each kernel's machine code, read with cuobjdump from the built library."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_label(m.group(1))
            out[name] = {"HGMMA": 0, "HMMA": 0}
        elif name is not None:
            for op in out[name]:
                out[name][op] += bool(re.search(rf"\b{op}\.", ln))
    return out


def check_tensor_cores(sass: dict) -> None:
    """Every bfloat16 instantiation of the three kernels runs on the tensor
    cores: a wgmma kernel for each (D, causal) with HGMMA instructions in
    it, and no bfloat16 build of their CUDA-core kernels."""
    for kernel in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                   "flash_bwd_dkv_wgmma_kernel"):
        for d in (64, 128):
            for mode in ("causal", "full"):
                name = f"{kernel}<bf16,{d},{mode}>"
                if not sass.get(name, {}).get("HGMMA"):
                    raise AssertionError(f"build: {name} has no HGMMA instruction ({sass.get(name)})")
    cuda_core = [n for n in sass if n.startswith(
        ("flash_fwd_kernel<bf16", "flash_bwd_dq_kernel<bf16", "flash_bwd_dkv_kernel<bf16"))]
    if cuda_core:
        raise AssertionError(f"build: bf16 CUDA-core kernels were built: {cuda_core}")


def phase_build() -> dict:
    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    sass = {name: sass_report(path) for name, path in paths.items()}
    log({"phase": "build", "seconds": seconds, "libraries": paths,
         "ptxas": {name: ptxas_report(info["log"])
                   for name, info in _build.build_info.items()},
         "sass_tensor_core_instructions": sass})
    merged = {k: v for lib in sass.values() for k, v in lib.items()}
    check_tensor_cores(merged)
    return merged


def _rel_err(got, want) -> tuple:
    err = (got.float() - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def _sdpa_bwd_ms(q, k, v, g, causal: bool) -> dict:
    """SDPA's whole backward (the library row): its forward runs once with
    the graph kept, then only ``torch.autograd.grad(..., retain_graph=True)``
    is timed by CUDA events: the median, min and max ms of 5 timings of 10
    calls each.  Beside them the device time of one call's kernels
    (torch.profiler), which the host's time to issue the call cannot
    inflate."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out, gt = sdpa(qt, kt, vt, is_causal=causal), g.transpose(1, 2)

    def bwd():
        torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)

    times = [cuda_ms(bwd, reps=10, warmup=2 if i == 0 else 0) for i in range(5)]
    return {"sdpa_bwd_ms": float(np.median(times)), "sdpa_bwd_ms_min": min(times),
            "sdpa_bwd_ms_max": max(times),
            "sdpa_bwd_device_ms": device_profile(bwd)["device_busy_ms"]}


def phase_kernels(gen: torch.Generator) -> dict:
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    cases = {}
    for B, T, H, D in KERNEL_SHAPES:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, g = (torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
                              for _ in range(4))
                out, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
                torch.cuda.synchronize()
                p_out, p_lse = fa._blockwise_attention_plain(q.float(), k.float(), v.float(),
                                                             causal)
                err_out = (out.float() - p_out).abs().max().item()
                err_lse = (lse - p_lse).abs().max().item()
                tol_out, tol_lse = TOL[dtype]
                if not (err_out <= tol_out and err_lse <= tol_lse):
                    raise AssertionError(
                        f"flash_fwd {B, T, H, D} causal={causal} {dtype}: "
                        f"out err {err_out} (atol {tol_out}), lse err {err_lse} (atol {tol_lse})"
                    )
                worst["flash_fwd"] = max(worst["flash_fwd"], err_out, err_lse)
                del p_out, p_lse

                # Backward: the two kernels against the plain version in f32
                # on the same inputs, as the training step calls them (no
                # lse cotangent).
                ops = fa._bwd_operands(q, k, v, out, lse, g, None)
                dq = fa._flash_bwd_dq_cuda(*ops, causal)
                dk, dv = fa._flash_bwd_dkv_cuda(*ops, causal)
                torch.cuda.synchronize()
                plain = lambda g_lse=None: fa._flash_backward_plain(  # noqa: E731
                    q.float(), k.float(), v.float(), out.float(), lse, g.float(), g_lse, causal)
                errs = {}
                for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), plain()):
                    errs[name], rel = _rel_err(got, want)
                    if not rel <= BWD_TOL[dtype]:
                        raise AssertionError(
                            f"flash_bwd {B, T, H, D} causal={causal} {dtype}: {name} err "
                            f"{errs[name]} is {rel} of max(1, max|ref|) (tol {BWD_TOL[dtype]})")
                worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
                worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"], errs["dv"])
                again = fa._flash_bwd_cuda(q, k, v, out, lse, g, None, causal)
                if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
                    raise AssertionError(f"flash_bwd {B, T, H, D} causal={causal} {dtype}: "
                                         "two runs on the same inputs are not bitwise equal")
                del again

                ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal), reps=20)
                dq_ms = cuda_ms(lambda: fa._flash_bwd_dq_cuda(*ops, causal), reps=10)
                dkv_ms = cuda_ms(lambda: fa._flash_bwd_dkv_cuda(*ops, causal), reps=10)
                plain_ms = cuda_ms(lambda: fa._blockwise_attention_plain(q, k, v, causal),
                                   reps=2, warmup=1)
                plain_bwd_ms = cuda_ms(plain, reps=2, warmup=1)
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                sdpa_ms = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal), reps=20)
                bounds = flash_bounds(B, T, H, D, dtype, causal)
                case = {"case": "flash", "shape": [B, T, H, D], "causal": causal,
                        "dtype": str(dtype).replace("torch.", ""), "err_out": err_out,
                        "err_lse": err_lse, "err_dq": errs["dq"], "err_dk": errs["dk"],
                        "err_dv": errs["dv"], "bitwise_repeat": True, "ms": ms,
                        "plain_ms": plain_ms, "sdpa_ms": sdpa_ms, "dq_ms": dq_ms,
                        "dkv_ms": dkv_ms, "plain_bwd_ms": plain_bwd_ms,
                        **_sdpa_bwd_ms(q, k, v, g, causal),
                        "bound_ms": {n: b[0] for n, b in bounds.items()},
                        "bound_by": {n: b[1] for n, b in bounds.items()},
                        "tflops": {n: bounds[n][2] / t / 1e9 for n, t in
                                   (("flash_fwd", ms), ("flash_bwd_dq", dq_ms),
                                    ("flash_bwd_dkv", dkv_ms))}}
                log(case)
                if causal and dtype == torch.bfloat16:
                    cases[(B, T, H, D)] = case
                del q, k, v, g, out, lse, ops, dq, dk, dv

        # A differentiable lse: its cotangent folds into delta.
        q, k, v, g = (torch.randn(B, T, H, D, generator=gen, device="cuda") for _ in range(4))
        g_lse = torch.randn(B, T, H, generator=gen, device="cuda")
        out, lse = fa.flash_attention(q, k, v, True, return_lse=True)
        got = fa._flash_bwd_cuda(q, k, v, out, lse, g, g_lse, True)
        want = fa._flash_backward_plain(q, k, v, out, lse, g, g_lse, True)
        rels = [_rel_err(a, b)[1] for a, b in zip(got, want)]
        if not max(rels) <= BWD_TOL[torch.float32]:
            raise AssertionError(f"flash_bwd {B, T, H, D} with g_lse: rel errs {rels}")
        log({"case": "flash_bwd_g_lse", "shape": [B, T, H, D], "rel_errs": rels})
        del q, k, v, g, g_lse, out, lse, got, want
    return {"worst": worst, "serve": cases[SERVE_SHAPE], "train": cases[TRAIN_SHAPE]}


def _model_grads(model, tokens):
    logp = torch.log_softmax(model(tokens)[:, :-1], -1)
    loss = -logp.gather(-1, tokens[:, 1:, None]).mean()
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def phase_model(gen: torch.Generator) -> None:
    """The kernels inside the model: flash vs dense attention, same weights,
    forward, greedy tokens and gradients; then the remat policies."""
    cfg = dict(vocab_size=512, d_model=256, num_heads=2, num_layers=2, max_len=320,
               dtype=torch.float32, pos_embedding="rotary", device="cuda")

    def build(attention, **kw):
        return TransformerLM(attention=attention, generator=torch.Generator().manual_seed(1),
                             **cfg, **kw)

    flash, dense = build("flash"), build("dense")
    tokens = torch.randint(0, 512, (2, 300), generator=gen, device="cuda")
    with torch.inference_mode():
        lf, ld = flash(tokens), dense(tokens)
        gf, gd = generate(flash, tokens[:, :256], 16), generate(dense, tokens[:, :256], 16)
    err = (lf - ld).abs().max().item()
    if not (torch.isfinite(lf).all() and err <= 1e-3):
        raise AssertionError(f"model logits: flash vs dense max err {err} (atol 1e-3)")
    if not torch.equal(gf, gd):
        raise AssertionError("model: greedy tokens differ between flash and dense attention")

    (loss_f, grads_f), (loss_d, grads_d) = _model_grads(flash, tokens), _model_grads(dense, tokens)
    loss_rel = abs(loss_f - loss_d) / abs(loss_d)
    grad_rel = max((grads_f[n] - grads_d[n]).abs().max().item()
                   / grads_d[n].abs().max().item() for n in grads_d)
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-3):
        raise AssertionError(f"model gradients: flash vs dense loss rel {loss_rel} (1e-5), "
                             f"worst grad rel {grad_rel} (1e-3)")
    remat_err = {}
    for policy in ("full", "dots", "dots_no_batch"):
        _, grads_r = _model_grads(build("flash", remat=True, remat_policy=policy), tokens)
        remat_err[policy] = max((grads_r[n] - grads_f[n]).abs().max().item() for n in grads_f)
        if not remat_err[policy] <= 2e-5:
            raise AssertionError(f"remat {policy}: grads differ by {remat_err[policy]} (2e-5)")
    log({"phase": "model", "logits_max_abs_err": err, "atol": 1e-3, "tokens_equal": True,
         "loss_rel_err": loss_rel, "grad_worst_rel_err": grad_rel,
         "remat_grad_max_abs_err": remat_err})


def _counts() -> dict:
    return {"flash_fwd": fa.flash_fwd_launches(), "flash_bwd_dq": fa.flash_bwd_dq_launches(),
            "flash_bwd_dkv": fa.flash_bwd_dkv_launches()}


def mfu(step_ms: float, n_matmul_params: int, B: int, T: int, L: int, d: int) -> dict:
    """lm_bench's accounting (benchmarks/lm_bench.py:119-126,188-202):
    6*N*tokens, plus 6*L*B*T^2*d for causal attention, over the bf16 peak."""
    flops = 6.0 * n_matmul_params * B * T
    attn = 6.0 * L * B * T * T * d
    sec = step_ms / 1e3
    return {"n_matmul_params": n_matmul_params, "tflop_6nd": flops / 1e12,
            "tflop_attn": attn / 1e12, "mfu_6nd": flops / sec / PEAK_FLOPS[torch.bfloat16],
            "mfu_attn": (flops + attn) / sec / PEAK_FLOPS[torch.bfloat16]}


def matmul_params(model) -> int:
    """Parameters that take part in matmuls: all but the embedding tables
    (lm_bench's N)."""
    return sum(p.numel() for n, p in model.named_parameters()
               if not n.startswith(("embed.", "pos.")))


def lm_matmul_params(vocab: int, d: int, layers: int) -> int:
    """The same N from the widths: per block qkv, proj and the two MLP
    layers (12*d*d weights, 9*d biases) and two LayerNorms (4*d), then
    ln_f and lm_head.  184,743,936 at vocab 32768, d 1024, 12 layers."""
    return layers * (12 * d * d + 13 * d) + 2 * d + d * vocab + vocab


def phase_train(seed: int) -> dict:
    B, T = 16, 1024
    flags = lm.make_flags(LM_WIDTHS + [
        "--seq_len", str(T), "--batch_size", str(B), "--attention", "flash", "--mesh", "",
        "--steps", str(TRAIN_STEPS), "--log_interval", "1", "--learning_rate", "1e-4",
        "--seed", str(seed), "--quiet",
    ])
    stats, ends = [], []
    window = {}

    def on_stats(s):
        # Called after each step's loss reached the host (the log line's
        # sync), so consecutive events bracket one whole step.
        stats.append(s)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        if s["step"] == TRAIN_STEPS - 1:  # profile the last step
            from torch.profiler import ProfilerActivity, profile

            window["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t0"] = time.perf_counter()
        elif s["step"] == TRAIN_STEPS:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            window["prof"].__exit__(None, None, None)

    # The main path: counts start at 0 here and are read right after.
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = lm.train(flags, on_stats=on_stats)
    wall_s = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()

    losses = [s["loss"] for s in stats]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: first {losses[0]}, last {losses[-1]}")
    need = 12 * TRAIN_STEPS
    if min(launches.values()) < need:
        raise AssertionError(f"train: kernel launches {launches}, each must be >= {need}")
    # Steps 2 .. TRAIN_STEPS-1: the profiled last step is left out.
    step_ms = [a.elapsed_time(b) for a, b in zip(ends[:-2], ends[1:-1])]
    median_ms = float(np.median(step_ms))
    res = {"phase": "train", "model": "TransformerLM vocab=32768 d=1024 L=12 H=8x128 bf16 "
           "learned positions, flash attention", "batch": B, "seq_len": T,
           "learning_rate": 1e-4, "steps": out["steps"], "losses": losses, "acc": out["acc"],
           "launches": launches, "step_ms_median": median_ms, "step_ms_min": min(step_ms),
           "step_ms_max": max(step_ms), "tokens_per_s_median": B * T / (median_ms / 1e3),
           "tokens_per_s_train": out["tokens_per_s"], "train_wall_s": wall_s,
           "max_memory_allocated": peak,
           **mfu(median_ms, lm_matmul_params(32768, 1024, 12), B, T, 12, 1024)}
    log(res)
    log({"phase": "train_profile", "window": "one train step (make_batch, forward, backward, "
         "AdamW, loss to host)", **profile_summary(window["prof"], window["wall_ms"])})
    return res


def phase_lm_bench(seed: int) -> dict:
    B, T, steps = 16, 1024, 6
    model = TransformerLM(
        vocab_size=32768, d_model=1024, num_heads=8, num_layers=12, max_len=8192,
        attention="flash", dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(seed),
    )
    opt = lm.make_optimizer(model.parameters(), 1e-4)
    toks = torch.from_numpy(np.random.default_rng(T).integers(0, 32768, size=(B, T))).cuda()

    # The fused loss against the materialized one on the first step's weights.
    with torch.no_grad():
        fused = lm_head_xent(model, toks, chunk_size=4096).item()
        feats = model(toks, return_features=True)[:, :-1].reshape(B * (T - 1), -1)
        naive = naive_softmax_xent(feats, model.lm_head.kernel, model.lm_head.bias,
                                   toks[:, 1:].reshape(-1)).item()
        del feats
    rel = abs(fused - naive) / abs(naive)
    if not rel <= 1e-3:
        raise AssertionError(f"lm_bench: fused xent {fused} vs naive {naive}: rel {rel} (1e-3)")

    losses = []

    def step():
        opt.zero_grad(set_to_none=True)
        loss = lm_head_xent(model, toks, chunk_size=4096)
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    med, lo, hi = median_call_ms(step, reps=steps)
    launches = _counts()
    losses = [x.item() for x in losses]
    if not all(np.isfinite(losses)) or min(launches.values()) < 12 * steps:
        raise AssertionError(f"lm_bench: losses {losses}, launches {launches}")
    n_params = matmul_params(model)
    if n_params != lm_matmul_params(32768, 1024, 12):
        raise AssertionError(f"lm_bench: {n_params} matmul parameters")
    res = {"phase": "lm_bench", "xent": "fused", "xent_chunk": 4096, "T": T, "B": B,
           "max_len": 8192, "fused_loss": fused, "naive_loss": naive, "fused_rel_err": rel,
           "losses": losses, "launches": launches, "step_ms_median": med, "step_ms_min": lo,
           "step_ms_max": hi, "tokens_per_s": B * T / (med / 1e3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **mfu(med, n_params, B, T, 12, 1024)}
    log(res)
    return res


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_slice(seed: int) -> dict:
    B, Tp, new = 4, 1024, 32
    t0 = time.perf_counter()
    model = TransformerLM(
        vocab_size=32768, d_model=1024, num_heads=8, num_layers=12, attention="flash",
        dtype=torch.bfloat16, pos_embedding="rotary", max_len=Tp + new, device="cuda",
        generator=torch.Generator().manual_seed(seed),
    ).eval()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(seed).integers(0, 32768, (B, Tp)).astype(np.int32)

    port = free_port()
    server, client = Rpc(), Rpc()
    server.set_name("lm_server")
    server.listen(f"127.0.0.1:{port}")
    client.set_name("lm_client")
    client.set_timeout(600)
    client.connect(f"127.0.0.1:{port}")
    try:
        # The serving path: counts start at 0 here and are read right after.
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        coro = serve(server, model, new, batch_size=B, total=B)
        t_send = time.perf_counter()
        futs = [client.async_("lm_server", "generate", p) for p in prompts]
        # All four must sit in the queue before the loop starts, so they are
        # served as one stacked batch.
        deadline = time.monotonic() + 60
        while client.sync("lm_server", "generate_stats")["depth_max"] < B:
            if time.monotonic() > deadline:
                raise TimeoutError("requests did not reach the server queue")
            time.sleep(0.01)
        result = {}
        th = threading.Thread(target=lambda: result.setdefault("it", asyncio.run(coro)))
        th.start()
        replies = [np.asarray(f.result(600)) for f in futs]
        latency_ms = (time.perf_counter() - t_send) * 1e3
        th.join(600)
        if th.is_alive():
            raise TimeoutError("serve loop did not finish")
        launches = fa.flash_fwd_launches()
        peak_bytes = torch.cuda.max_memory_allocated()
    finally:
        client.close()
        server.close()

    if result.get("it") != 1:
        raise AssertionError(f"expected one stacked batch, served in {result.get('it')} iterations")
    if launches < model.num_layers:
        raise AssertionError(f"flash_fwd launched {launches} times in the serving path, "
                             f"expected >= {model.num_layers}")
    got = np.stack(replies)
    if got.shape != (B, Tp + new) or not np.array_equal(got[:, :Tp], prompts):
        raise AssertionError(f"replies have shape {got.shape} or lost their prompts")
    if not ((got >= 0) & (got < 32768)).all():
        raise AssertionError("reply tokens out of vocabulary range")
    with torch.inference_mode():
        batch = torch.from_numpy(prompts)
        want = generate(model, batch, new).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError("served replies differ from generate() on the same batch")
        # Phase times on the same batch, outside the served run.
        dev_batch = batch.cuda()
        prefill_ms, _, _ = median_call_ms(lambda: model.prefill(dev_batch), reps=5)
        prefill_enqueue_ms = enqueue_ms(lambda: model.prefill(dev_batch), reps=5)
        gen_ms, gen_min, gen_max = median_call_ms(lambda: generate(model, dev_batch, new),
                                                  reps=5)
        profile = device_profile(lambda: generate(model, dev_batch, new))
        prefill_profile = device_profile(lambda: model.prefill(dev_batch))
    decode_ms = (gen_ms - prefill_ms) / (new - 1)
    out = {"phase": "slice", "model": "TransformerLM vocab=32768 d=1024 L=12 H=8x128 bf16 rotary",
           "batch": B, "prompt_len": Tp, "max_new_tokens": new, "init_s": init_s,
           "flash_fwd_launches": launches, "request_latency_ms": latency_ms,
           "prefill_ms": prefill_ms, "prefill_enqueue_ms": prefill_enqueue_ms,
           "generate_ms": gen_ms, "generate_ms_min": gen_min,
           "generate_ms_max": gen_max, "decode_ms_per_token": decode_ms,
           "max_memory_allocated": peak_bytes, "native_codec": serialization.native_available(),
           "replies_equal_generate": True}
    log(out)
    log({"phase": "profile", "window": "generate(4 x 1024 prompt, 32 new tokens)", **profile})
    log({"phase": "prefill_profile", "window": "model.prefill(4 x 1024 prompt)",
         **prefill_profile})
    return out


def _rl_batch(T1: int, B: int, obs, num_actions: int, seed: int, frames: bool) -> dict:
    rng = np.random.default_rng(seed)
    done = rng.random((T1, B)) < 0.2
    done[0, 0] = True
    return {
        "state": (rng.integers(0, 256, (T1, B, *obs), dtype=np.uint8) if frames
                  else rng.normal(size=(T1, B, *obs)).astype(np.float32)),
        "reward": rng.normal(size=(T1, B)).astype(np.float32),
        "done": done,
        "prev_action": rng.integers(0, num_actions, (T1, B)),
        "action": rng.integers(0, num_actions, (T1, B)),
        "policy_logits": rng.normal(size=(T1, B, num_actions)).astype(np.float32),
    }


def _parity_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |card - CPU| over max(1, max |CPU|)."""
    want = want.detach().float()
    err = (got.detach().cpu().float() - want).abs().max().item()
    return err / max(1.0, want.abs().max().item())


def _learner_backward(model, device, batch: dict, state: tuple, flags) -> tuple:
    """Forward, then compute_loss and its backward: (outputs, loss); the
    gradients are left in the parameters' ``.grad``."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    state = tuple(torch.from_numpy(x).to(device) for x in state)
    with torch.no_grad():
        outputs, _ = model(batch, state)
    loss, _ = experiment.compute_loss(batch, state, model, flags)
    loss.backward()
    return outputs, loss.detach()


def _learner_run(model, device, batch: dict, state: tuple, flags) -> dict:
    """Forward, then one compute_loss + backward + clip/rmsprop step."""
    opt = experiment.make_optimizer(model.parameters(), flags)
    outputs, loss = _learner_backward(model, device, batch, state, flags)
    opt.step()
    return {**outputs, "loss": loss}


def phase_impala_parity(seed: int, device="cuda", obs=(84, 84, 4), T1: int = 5,
                        B: int = 4) -> dict:
    """The RL models and one learner step on the card against the CPU."""
    flags = experiment.make_flags([])  # lr 1e-3, clip 40, the JAX example's costs
    A = 6
    cases = {
        "impala_ff": (functools.partial(ImpalaNet, A, obs, use_lstm=False,
                                        dtype=torch.float32), obs),
        "impala_lstm": (functools.partial(ImpalaNet, A, obs, use_lstm=True,
                                          dtype=torch.float32), obs),
        "actor_critic_lstm": (functools.partial(ActorCriticNet, A, obs_size=8, use_lstm=True),
                              (8,)),
        "impala_ff_bf16": (functools.partial(ImpalaNet, A, obs, use_lstm=False,
                                             dtype=torch.bfloat16), obs),
    }
    out = {}
    for i, (name, (make, shape)) in enumerate(cases.items()):
        host = make(device="cpu", generator=torch.Generator().manual_seed(seed + i))
        card = make(device=device)
        card.load_state_dict(host.state_dict())
        batch = _rl_batch(T1, B, shape, A, seed + i, frames=len(shape) == 3)
        rng = np.random.default_rng(seed + 100 + i)
        state = tuple(rng.normal(size=(B, host.core.hidden)).astype(np.float32)
                      for _ in range(2)) if host.use_lstm else ()
        want = _learner_run(host, "cpu", batch, state, flags)
        got = _learner_run(card, device, batch, state, flags)
        errs = {k: _parity_err(got[k], want[k]) for k in ("policy_logits", "baseline", "loss")}
        params = dict(host.named_parameters())
        errs["updated_params"] = max(_parity_err(p, params[n])
                                     for n, p in card.named_parameters())
        tol = PARITY_TOL[host.dtype]
        if not max(errs.values()) <= tol:
            raise AssertionError(f"impala_parity {name}: errors {errs} (tol {tol})")
        out[name] = {"errors": errs, "tol": tol, "loss": want["loss"].item()}
    res = {"phase": "impala_parity", "obs": list(obs), "T+1": T1, "B": B,
           "step": "compute_loss + backward + clip_by_global_norm(40) + rmsprop(1e-3, 0.99, "
           "0.01)", "cases": out}
    log(res)
    return res


def max_pool_bytes(obs, channels, frames: int, itemsize: int = 2) -> int:
    """Least bytes the encoder's three SAME max-pools move in one learner
    step: forward reads each input and writes each output once; backward
    reads the output gradient and the input and writes the input
    gradient."""
    h, w, _ = obs
    total = 0
    for ch in channels:
        n_in, h, w = frames * h * w * ch, -(-h // 2), -(-w // 2)
        n_out = frames * h * w * ch
        total += (n_in + n_out) + (n_out + 2 * n_in)
    return total * itemsize


def _learner_bench(device, obs, T: int, B: int, steps: int, profile_steps: int) -> dict:
    """bench.py's learner step at [T+1, B]: times, rates, memory, profile."""
    dev = torch.device(device)
    step, _, _, _ = bench.build_step(dev, T, B, obs=obs)
    _, warm = bench.step_times_ms(step, 10, dev)
    torch.cuda.reset_peak_memory_stats()
    times, losses = bench.step_times_ms(step, steps, dev)
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(lambda: [step() for _ in range(profile_steps)], top=15)
    issue_ms = enqueue_ms(step, reps=10)
    losses = [float(x) for x in warm + losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"impala_learner: non-finite losses {losses}")
    median = float(np.median(times))
    flops = 3.0 * bench.analytic_forward_flops(bench.REF_CHANNELS, obs, T + 1, B)
    res = {"phase": "impala_learner", "model": "ImpalaNet (16, 32, 32) bf16, no LSTM, "
           "V-trace loss, rmsprop(1e-3, 0.99, 0.01)", "obs": list(obs), "T": T, "B": B,
           "metric": bench.metric_name(T, B, bench.REF_CHANNELS), "steps": steps,
           "step_ms_median": median, "step_ms_min": min(times), "step_ms_max": max(times),
           "frames_per_s": T * B / (median / 1e3), "model_tflop_per_step": flops / 1e12,
           "tflops": flops / (median / 1e3) / 1e12,
           "mfu": flops / (median / 1e3) / bench.PEAK_BF16_FLOPS,
           "max_memory_allocated": peak, "first_loss": losses[0], "last_loss": losses[-1],
           "launches_per_step": prof["kernel_launches"] / profile_steps,
           "idle_share": prof["idle_share"],
           # Host-bound where the host's time to issue a step exceeds the
           # device's busy time in one.
           "host_issue_ms_per_step": issue_ms,
           "device_busy_ms_per_step": prof["device_busy_ms"] / profile_steps,
           "max_pool_bound_ms_per_step": max_pool_bytes(obs, bench.REF_CHANNELS, (T + 1) * B)
           / PEAK_BYTES_PER_S * 1e3}
    log(res)
    log({"phase": "impala_learner_profile", "window": f"{profile_steps} learner steps", **prof})
    return res


def _data_path(pool: EnvPool, device, seed: int, T: int, learn_steps: int) -> dict:
    """Actors on the card step the pool; their unrolls go through the
    Batcher into learner steps."""
    dev = torch.device(device)
    obs = pool.obs_spec["state"][0]
    model, opt = bench.build_learner(dev, obs=obs, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb, envs = pool.num_batches, pool.batch_size
    batchers = [Batcher(T + 1, device=dev, host=True, name=f"learn{b}") for b in range(nb)]
    frames = [[] for _ in range(nb)]
    prev = [torch.zeros(envs, dtype=torch.int64, device=dev) for _ in range(nb)]
    futs = [pool.step(b, np.zeros(envs, np.int64)) for b in range(nb)]
    act_ms, learner_events, losses, env_steps = [], [], [], 0
    h2d = telemetry.get_registry().counter_values().get("batcher_h2d_bytes_total", 0.0)
    t0 = time.perf_counter()
    while len(losses) < learn_steps:
        for b in range(nb):
            env_out = futs[b].result()
            ta = time.perf_counter()
            # Copied before the next step() lets the workers overwrite them.
            host = {k: v.copy() for k, v in env_out.items()}
            inputs = {k: torch.from_numpy(v).to(dev)[None] for k, v in host.items()}
            inputs["prev_action"] = prev[b][None]
            with torch.no_grad():
                out, _ = model(inputs, (), sample_generator=gen)
            action = out["action"][0]
            futs[b] = pool.step(b, action)  # the CUDA-tensor seam
            act_ms.append((time.perf_counter() - ta) * 1e3)
            env_steps += envs
            batchers[b].stack({**host, "prev_action": prev[b], "action": action,
                               "policy_logits": out["policy_logits"][0]})
            frames[b].append(host["state"])
            prev[b] = action
            if batchers[b].empty() or len(losses) == learn_steps:
                continue
            batch = batchers[b].get()
            if batch["state"].device.type != dev.type:
                raise AssertionError(f"impala_learner: the learner batch is on "
                                     f"{batch['state'].device}, not {dev}")
            if not torch.equal(batch["state"].cpu(), torch.from_numpy(np.stack(frames[b]))):
                raise AssertionError("impala_learner: the learner batch's frames are not "
                                     "the shared-memory frames of its unroll")
            frames[b] = []
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            losses.append(bench.learner_step(model, opt, batch))
            end.record()
            learner_events.append((start, end))
    for f in futs:
        f.result()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"impala_learner data path: non-finite losses {losses}")
    seam = all(p is not None for p in pool._stepper._pinned)
    if dev.type == "cuda" and not seam:
        raise AssertionError("impala_learner: actions did not pass the CUDA-tensor seam")
    res = {"phase": "impala_learner_data_path",
           "pool": {"num_processes": pool._num_processes, "batch_size": envs,
                    "num_batches": nb},
           "obs": list(obs), "unroll": T + 1, "learner_steps": len(losses),
           "env_steps": env_steps, "wall_s": wall_s, "env_steps_per_s": env_steps / wall_s,
           "act_ms_median": float(np.median(act_ms)),
           "learner_ms_median": float(np.median([a.elapsed_time(b)
                                                 for a, b in learner_events])),
           "losses": losses, "frames_equal_shm": True, "cuda_action_seam": seam,
           "batcher_h2d_bytes": telemetry.get_registry().counter_values().get(
               "batcher_h2d_bytes_total", 0.0) - h2d}
    log(res)
    return res


def phase_impala_learner(pool: EnvPool, seed: int, device="cuda", obs=(84, 84, 4),
                         T: int = 20, B: int = 32, steps: int = 200, profile_steps: int = 5,
                         learn_steps: int = 10) -> dict:
    # The slice's path: counts start at 0 here and are read right after.
    fa.reset_launches()
    res = _learner_bench(device, obs, T, B, steps, profile_steps)
    res["data_path"] = _data_path(pool, device, seed, T, learn_steps)
    res["flash_launches"] = _counts()
    return res


# ----------------------------------------------------------------- cohort
# cohort_impala: the reduce paths, and each one's tolerance against the
# float64 sum of the four peers' gradients computed on the card.  The f32
# paths hold tests/test_buckets.py's allclose; the compressed wires hold
# their error to a share of max|sum| over the whole payload (one scale per
# chunk spans many leaves).
COHORT_PATHS = {
    "auto": {},
    "tree": dict(bucketed=False, chunked=False),
    "ring": dict(chunked=True),
    "ring_bf16": dict(chunked=True, wire="bfloat16"),
    "ring_q8": dict(chunked=True, wire="q8"),
}
COHORT_F32_TOL = (1e-5, 1e-5)  # rtol, atol
COHORT_WIRE_TOL = {"ring_bf16": 1e-2, "ring_q8": 5e-2}  # x max|sum|
COHORT_PEERS = 4
COHORT_ROUNDS = 20
# cohort_lm: the repo's LM at lm_bench's widths, learned positions, one
# forward + backward of B x T tokens in each of two learner processes.
COHORT_LM = dict(vocab_size=32768, d_model=1024, num_heads=8, num_layers=12, max_len=1024)
COHORT_LM_BATCH = (4, 1024)
COHORT_LM_ROUNDS = 5
ROOT = os.path.dirname(os.path.abspath(__file__))


def start_broker(port: int) -> subprocess.Popen:
    """The port's broker CLI in its own process, listening once this returns."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "moolib_tpu_torch.broker", "--address", f"127.0.0.1:{port}",
         "--interval", "0.05"],
        env=dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")),
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    deadline = time.time() + 60
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"broker exited {proc.returncode}: {proc.stderr.read()[-2000:]}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return proc
        except OSError:
            time.sleep(0.1)
    stop_process(proc)
    raise RuntimeError("broker never listened")


def stop_process(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def _join_group(name: str, addr: str, group: str):
    rpc = Rpc()
    rpc.set_name(name)
    rpc.set_timeout(120)
    rpc.listen("127.0.0.1:0")
    rpc.connect(addr)
    g = Group(rpc, group)
    g.set_timeout(120)
    return rpc, g


def _pump(groups, until, seconds: float, what: str) -> None:
    deadline = time.time() + seconds
    while not until():
        if time.time() > deadline:
            raise AssertionError(f"{what}: timed out after {seconds} s")
        for g in groups:
            g.update()
        time.sleep(0.0005)


def _counter(prefix: str) -> float:
    return sum(v for k, v in telemetry.get_registry().counter_values().items()
               if k.startswith(prefix))


def _leaf_bytes(result) -> list:
    return [np.ascontiguousarray(x).tobytes() for x in nest.flatten(result)]


def _staging_ms(leaves, reps: int) -> dict:
    """buckets.BucketLayout.fill of one peer's gradient leaves into a pinned
    lease: CUDA-event time from before the copies to after them, and host
    time until the fill's event completed."""
    layout = buckets.BucketLayout([tuple(x.shape) for x in leaves], np.float32)
    flat = buckets.lease(layout.total, np.float32, pinned=leaves[0].is_cuda)
    dev_ms, host_ms = [], []
    try:
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            event = layout.fill(flat, leaves)
            end.record()
            if event is not None:
                event.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            end.synchronize()
            dev_ms.append(start.elapsed_time(end))
    finally:
        buckets.release(flat)
    nbytes = layout.total * 4
    med = float(np.median(dev_ms))
    return {"bytes": nbytes, "d2h_ms_median": med, "host_ms_median": float(np.median(host_ms)),
            "d2h_GB_per_s": nbytes / (med / 1e3) / 1e9 if med > 0 else None}


def phase_cohort_impala(seed: int, device="cuda", obs=(84, 84, 4), T1: int = 21, B: int = 32,
                        rounds: int = COHORT_ROUNDS) -> dict:
    """Four in-process peers reduce four full-width ImpalaNet gradients,
    CUDA tensors as they stand, on each path; then one cohort stats round."""
    A = 6
    flags = experiment.make_flags([])
    model = ImpalaNet(A, obs, use_lstm=False, dtype=torch.bfloat16, device=device,
                      generator=torch.Generator().manual_seed(seed))
    grads, losses = [], []
    for i in range(COHORT_PEERS):
        model.zero_grad(set_to_none=True)
        _, loss = _learner_backward(model, device, _rl_batch(T1, B, obs, A, seed + i, True),
                                    (), flags)
        grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()})
        losses.append(float(loss))
    names = list(grads[0])
    elements = sum(grads[0][n].numel() for n in names)
    ref = {n: sum(g[n].double() for g in grads).cpu().numpy() for n in names}
    ref_max = max(float(np.abs(v).max()) for v in ref.values())
    staging = _staging_ms([grads[0][n] for n in names], reps=rounds)

    port = free_port()
    broker = start_broker(port)
    peers = []
    try:
        peers = [_join_group(f"peer{i}", f"127.0.0.1:{port}", "cohort_impala")
                 for i in range(COHORT_PEERS)]
        groups = [g for _, g in peers]
        _pump(groups, lambda: all(g.active() and len(g.members()) == COHORT_PEERS
                                  for g in groups), 120, "cohort_impala: cohort")
        paths = {}
        for path, kw in COHORT_PATHS.items():
            times, err = [], 0.0
            ev0, d2h0 = _counter("buckets_d2h_events_total"), _counter("buckets_d2h_bytes_total")
            tx0 = _counter("rpc_tx_bytes_total")
            for r in range(rounds):
                t0 = time.perf_counter()
                futs = [g.all_reduce(f"{path}{r}", grd, **kw) for g, grd in zip(groups, grads)]
                _pump(groups, lambda: all(f.done() for f in futs), 120,
                      f"cohort_impala: {path} round {r}")
                times.append((time.perf_counter() - t0) * 1e3)
                results = [f.result(0) for f in futs]
                first = _leaf_bytes(results[0])
                if any(_leaf_bytes(x) != first for x in results[1:]):
                    raise AssertionError(f"cohort_impala {path}: peers' result bytes differ")
                out = results[0]
                if not all(isinstance(out[n], np.ndarray) for n in names):
                    raise AssertionError(f"cohort_impala {path}: results are not host arrays")
                err = max(err, max(float(np.abs(out[n] - ref[n]).max()) for n in names))
                if path in COHORT_WIRE_TOL:
                    if not err <= COHORT_WIRE_TOL[path] * ref_max:
                        raise AssertionError(f"cohort_impala {path}: max err {err} > "
                                             f"{COHORT_WIRE_TOL[path]} x max|sum| {ref_max}")
                else:
                    for n in names:
                        np.testing.assert_allclose(out[n], ref[n], *COHORT_F32_TOL,
                                                   err_msg=f"cohort_impala {path} {n}")
            events = _counter("buckets_d2h_events_total") - ev0
            d2h = _counter("buckets_d2h_bytes_total") - d2h0
            if torch.device(device).type == "cuda" and (
                    events != COHORT_PEERS * rounds or d2h != COHORT_PEERS * rounds * elements * 4):
                raise AssertionError(f"cohort_impala {path}: {events} staging events and {d2h} "
                                     f"D2H bytes; want one event and every byte per peer round")
            paths[path] = {"kwargs": kw, "round_ms_median": float(np.median(times)),
                           "round_ms_min": min(times), "round_ms_max": max(times),
                           "max_abs_err": err, "d2h_events": events, "d2h_bytes": d2h,
                           "rpc_tx_bytes_per_round": (_counter("rpc_tx_bytes_total") - tx0)
                           / rounds}
            if path in COHORT_WIRE_TOL:
                paths[path]["tol"] = f"{COHORT_WIRE_TOL[path]} x max|sum|"
            else:
                paths[path]["tol"] = {"rtol": COHORT_F32_TOL[0], "atol": COHORT_F32_TOL[1]}
        stats = _cohort_stats(groups, losses, T1 * B)
        ring_auto = groups[0].ring_auto(elements * 4)
    finally:
        for rpc, _ in peers:
            rpc.close()
        stop_process(broker)
    res = {"phase": "cohort_impala", "peers": COHORT_PEERS,
           "model": "ImpalaNet (16, 32, 32) bf16 compute, f32 parameters, no LSTM",
           "obs": list(obs), "T+1": T1, "B": B, "leaves": len(names), "elements": elements,
           "payload_bytes": elements * 4, "bucket_bytes": buckets.bucket_bytes(),
           "auto_path": "ring" if ring_auto else "bucketed",
           "max_abs_sum": ref_max, "rounds": rounds, "staging": staging, "paths": paths,
           "stats": stats}
    log(res)
    return res


def _cohort_stats(groups, losses, frames: int) -> dict:
    """One GlobalStatsAccumulator round over the cohort: each peer's loss
    (a StatMean), its frames (a StatSum) and its registry counters."""
    stats = [{"loss": StatMean(), "frames": StatSum(), "telemetry": telemetry.CohortCounters()}
             for _ in groups]
    accs = [GlobalStatsAccumulator(g, s) for g, s in zip(groups, stats)]
    for s, loss in zip(stats, losses):
        s["loss"] += loss
        s["frames"] += frames
    for a, s in zip(accs, stats):
        a.reduce(s)
    _pump(groups, lambda: all(a._inflight is None for a in accs), 60, "cohort stats")
    want = float(np.mean(losses))
    for s in stats:
        if s["loss"].count != len(groups) or s["frames"].value != frames * len(groups):
            raise AssertionError(f"cohort stats: count {s['loss'].count}, frames "
                                 f"{s['frames'].value}")
        if not abs(s["loss"].result() - want) <= 1e-6 * max(1.0, abs(want)):
            raise AssertionError(f"cohort stats: mean loss {s['loss'].result()} != {want}")
    return {"mean_loss": stats[0]["loss"].result(), "frames": stats[0]["frames"].value,
            "cohort_counter_series": len(stats[0]["telemetry"].result())}


def _lm_learner(rank: int, addr: str, seed: int, device: str, lm_cfg: dict, batch: tuple,
                rounds: int, out) -> None:
    """One learner process of cohort_lm: the LM's gradient on this rank's
    batch, ``rounds`` auto allreduces of it over the group, and the check
    against the peer's gradient fetched over Rpc and added on the card."""
    try:
        out.put((rank, _lm_learner_run(rank, addr, seed, device, lm_cfg, batch, rounds)))
    except BaseException as e:  # noqa: BLE001 - reported to the parent, which fails
        import traceback

        out.put((rank, {"error": f"{e!r}\n{traceback.format_exc()}"}))


def _lm_learner_run(rank, addr, seed, device, lm_cfg, batch, rounds) -> dict:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(**lm_cfg, attention="flash", dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator().manual_seed(seed))
    B, T = batch
    toks = torch.from_numpy(np.random.default_rng(seed + 1 + rank).integers(
        0, lm_cfg["vocab_size"], size=(B, T))).to(dev)
    fa.reset_launches()  # the path's launches: this rank's forward + backward
    loss = lm_head_xent(model, toks, chunk_size=4096)
    loss.backward()
    launches = _counts()
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    names = list(grads)
    elements = sum(g.numel() for g in grads.values())
    flat = torch.cat([grads[n].reshape(-1) for n in names])

    rpc, g = _join_group(f"learner{rank}", addr, "cohort_lm")
    rpc.define("gradient", lambda: flat.cpu().numpy())
    try:
        _pump([g], lambda: g.active() and len(g.members()) == 2, 120, "cohort_lm: cohort")
        times, h2d_ms, results = [], [], []
        d2h0 = _counter("buckets_d2h_bytes_total")
        ev0 = _counter("buckets_d2h_events_total")
        tx0 = _counter("rpc_tx_bytes_total")
        for r in range(rounds):
            t0 = time.perf_counter()
            fut = g.all_reduce(f"grads{r}", grads)
            _pump([g], fut.done, 600, f"cohort_lm: round {r}")
            times.append(time.perf_counter() - t0)
            res = fut.result(0)
            if cuda:  # the caller's copy of the result back to the card
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                back = {n: torch.from_numpy(res[n]).to(dev, non_blocking=True) for n in names}
                end.record()
                end.synchronize()
                h2d_ms.append(start.elapsed_time(end))
                del back
            results.append(_leaf_bytes(res))
        tx = (_counter("rpc_tx_bytes_total") - tx0) / rounds
        if any(x != results[0] for x in results[1:]):
            raise AssertionError("cohort_lm: rounds of the same gradients differ")
        events = _counter("buckets_d2h_events_total") - ev0
        d2h = _counter("buckets_d2h_bytes_total") - d2h0
        if cuda and (events != rounds or d2h != rounds * elements * 4):
            raise AssertionError(f"cohort_lm: {events} staging events, {d2h} D2H bytes")
        other = torch.from_numpy(rpc.sync(f"learner{1 - rank}", "gradient")).to(dev)
        want, off = [], 0
        for n in names:
            k = grads[n].numel()
            want.append((grads[n] + other[off:off + k].view_as(grads[n])).cpu().numpy().tobytes())
            off += k
        if results[-1] != want:
            bad = [n for n, a, b in zip(names, results[-1], want) if a != b]
            raise AssertionError(f"cohort_lm: result differs from grad_a + grad_b in {bad[:5]}")
        # Stay in the cohort until the peer has fetched our gradient too.
        done = g.all_reduce("done", 1)
        _pump([g], done.done, 300, "cohort_lm: done")
        done.result(0)
        staging = _staging_ms([grads[n] for n in names], reps=3) if cuda else None
        return {"rank": rank, "loss": float(loss.detach()), "leaves": len(names), "elements": elements,
                "round_s": times, "h2d_ms": h2d_ms, "staging": staging,
                "d2h_events": events, "launches": launches,
                "rpc_tx_bytes_per_round": tx, "max_memory_allocated": torch.cuda.max_memory_allocated() if cuda else 0,
                "equal_grad_a_plus_grad_b": True}
    finally:
        rpc.close()


def phase_cohort_lm(seed: int, device="cuda", lm_cfg=None, batch=COHORT_LM_BATCH,
                    rounds: int = COHORT_LM_ROUNDS, timeout: float = 600) -> dict:
    """Two learner processes (spawned, each its own CUDA context on the one
    card) allreduce the LM's full gradient through the port's Group."""
    import multiprocessing as mp

    lm_cfg = dict(COHORT_LM if lm_cfg is None else lm_cfg)
    port = free_port()
    broker = start_broker(port)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_lm_learner, args=(rank, f"127.0.0.1:{port}", seed, device,
                                                   lm_cfg, batch, rounds, out))
             for rank in range(2)]
    try:
        for p in procs:
            p.start()
        reports = {}
        deadline = time.time() + timeout
        while len(reports) < 2:
            try:
                rank, rep = out.get(timeout=5)
            except queue.Empty:
                if time.time() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                    raise AssertionError(f"cohort_lm: learners {[p.exitcode for p in procs]} "
                                         f"reported {sorted(reports)}")
                continue
            if "error" in rep:
                raise AssertionError(f"cohort_lm learner {rank}: {rep['error']}")
            reports[rank] = rep
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise AssertionError(f"cohort_lm: learner exit code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        stop_process(broker)
    nbytes = reports[0]["elements"] * 4
    med_s = float(np.median([t for r in reports.values() for t in r["round_s"]]))
    launches = {k: sum(r["launches"][k] for r in reports.values()) for k in reports[0]["launches"]}
    if torch.device(device).type == "cuda" and min(launches.values()) < 2 * lm_cfg["num_layers"]:
        raise AssertionError(f"cohort_lm: kernel launches {launches}, each must be >= "
                             f"{2 * lm_cfg['num_layers']}")
    res = {"phase": "cohort_lm", "processes": 2,
           "model": "TransformerLM vocab=32768 d=1024 L=12 H=8x128 max_len 1024, learned "
           "positions, bf16 compute, f32 parameters, flash attention" if lm_cfg == COHORT_LM
           else f"TransformerLM {lm_cfg}", "batch": list(batch), "rounds": rounds,
           "gradient_elements": reports[0]["elements"], "payload_bytes": nbytes,
           "round_s_median": med_s, "algbw_GB_per_s": nbytes / med_s / 1e9,
           "launches": launches, "learners": [reports[0], reports[1]]}
    log(res)
    return res


# accumulator_impala / accumulator_lm: the training loops of slice 4b, two
# learner processes each (spawned, one CUDA context each on the one card).
ACC_IMPALA_ARGS = ["--env", "synthetic", "--unroll_length", "20", "--batch_size", "32",
                   "--actor_batch_size", "32", "--num_actor_batches", "2",
                   "--num_env_processes", "4", "--virtual_batch_size", "64"]
ACC_IMPALA_SGD = 50
ACC_LM_ARGS = ["--vocab", "32768", "--d_model", "1024", "--layers", "12", "--heads", "8",
               "--seq_len", "1024", "--batch_size", "4", "--virtual_batch_size", "8",
               "--attention", "flash", "--mesh", "", "--learning_rate", "1e-4"]
ACC_LM_STEPS = 6  # one step of learner 0 alone, then 5 of the cohort


def _cohort_child(kind: str, rank: int, argv: list, out, started=None) -> None:
    """One learner process of accumulator_impala / accumulator_lm: the
    example's own train() on ``argv``; its summary goes to the parent.
    Nothing touches CUDA before train() (its EnvPool forks first)."""
    try:
        t0 = time.time()
        ev0 = _counter("buckets_d2h_events_total")
        if kind == "impala":
            summary = experiment.train(experiment.make_flags(argv))
        else:
            fa.reset_launches()

            def on_stats(s):  # tells the parent that learner 0 has stepped
                if started is not None:
                    started.put(s["step"])

            summary = lm.train(lm.make_flags(argv), on_stats=on_stats)
            summary["launches"] = _counts()
        summary.update(
            rank=rank, wall_s=time.time() - t0,
            d2h_events=_counter("buckets_d2h_events_total") - ev0,
            env_steps=_counter("envpool_steps_total"),
            max_memory_allocated=torch.cuda.max_memory_allocated()
            if torch.cuda.is_initialized() else 0)
        out.put((rank, summary))
    except BaseException as e:  # reported to the parent, which fails, then re-raised
        import traceback

        out.put((rank, {"error": f"{e!r}\n{traceback.format_exc()}"}))
        raise


def _run_cohort(kind: str, argvs: list, timeout: float, wait_first: bool) -> list:
    """Spawn the two learners (the second once the first has applied a step
    when ``wait_first``), collect both summaries, stop every process."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out, started = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_cohort_child, args=(kind, r, argvs[r], out, started))
             for r in range(2)]
    reports = {}
    deadline = time.time() + timeout

    def collect(block_s):
        try:
            rank, rep = out.get(timeout=block_s)
        except queue.Empty:
            if time.time() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                raise AssertionError(f"{kind}: learners {[p.exitcode for p in procs]} "
                                     f"reported {sorted(reports)}")
            return
        if "error" in rep:
            raise AssertionError(f"accumulator_{kind} learner {rank}: {rep['error']}")
        reports[rank] = rep

    try:
        procs[0].start()
        if wait_first:
            while True:
                try:
                    started.get(timeout=5)
                    break
                except queue.Empty:
                    collect(0.01)
                    if time.time() > deadline:
                        raise AssertionError(f"{kind}: learner 0 never stepped")
        procs[1].start()
        while len(reports) < 2:
            collect(5)
        while not started.empty():  # drained before the join (learner 0's step notes)
            started.get_nowait()
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise AssertionError(f"accumulator_{kind}: learner exit code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [reports[0], reports[1]]


def _cohort_checks(kind: str, reps: list, cuda: bool) -> tuple:
    """Both learners at the same model version with bitwise-equal
    parameters; the non-leader synced the model through the chunked
    transfer; on the card, one D2H event per staging call.  Returns
    (leader, joiner)."""
    if len({r["model_version"] for r in reps}) != 1:
        raise AssertionError(f"{kind}: versions {[r['model_version'] for r in reps]}")
    if reps[0]["params_sha256"] != reps[1]["params_sha256"]:
        raise AssertionError(f"{kind}: parameters differ after the last step")
    leaders = [r for r in reps if r["is_leader"]]
    joiners = [r for r in reps if not r["is_leader"]]
    if len(leaders) != 1:
        raise AssertionError(f"{kind}: leaders {[r['is_leader'] for r in reps]}")
    joiner = joiners[0]
    if joiner["recovery"]["model_sync_bytes_rx"] <= 0:
        raise AssertionError(f"{kind}: the joiner received no model-sync bytes")
    for r in reps:
        calls = r["accumulator"]["d2h_staged_calls"]
        if cuda and (calls == 0 or r["d2h_events"] != calls):
            raise AssertionError(f"{kind}: learner {r['rank']}: {r['d2h_events']} D2H events "
                                 f"for {calls} staging calls")
    return leaders[0], joiner


def phase_accumulator_impala(seed: int, device="cuda", args=None, sgd_steps: int = ACC_IMPALA_SGD,
                             timeout: float = 900) -> dict:
    """Two examples.vtrace.experiment.train() learners: learner 0 hosts the
    broker, learner 1 joins; synthetic Atari frames through the full-width
    ImpalaNet to a fixed count of SGD steps, debug checksums on."""
    port = free_port()
    common = list(ACC_IMPALA_ARGS if args is None else args) + [
        "--device", device, "--seed", str(seed), "--total_steps", str(10 ** 9),
        "--total_sgd_steps", str(sgd_steps), "--min_cohort", "2", "--debug_checksums",
        "--quiet", "--log_interval", "1e9"]
    argvs = [common + ["--address", f"127.0.0.1:{port}", "--local_name", "impala0"],
             common + ["--connect", f"127.0.0.1:{port}", "--local_name", "impala1"]]
    reps = _run_cohort("impala", argvs, timeout, wait_first=False)
    cuda = torch.device(device).type == "cuda"
    leader, joiner = _cohort_checks("accumulator_impala", reps, cuda)
    for r in reps:
        if r["accumulator"]["checksum_divergences"]:
            raise AssertionError(f"accumulator_impala: {r['accumulator']['checksum_divergences']} "
                                 f"checksum divergences on learner {r['rank']}")
    flags = experiment.make_flags(common)
    # Cohort rates over the steps both learners applied together: from the
    # joiner's first applied step to the last.
    times = [t for t, _ in joiner["sgd_times"]]
    span = times[-1] - times[0] if len(times) > 1 else float("nan")
    sgd_per_s = (len(times) - 1) / span
    frames = flags.virtual_batch_size * flags.unroll_length
    res = {"phase": "accumulator_impala", "processes": 2,
           "model": "ImpalaNet (16, 32, 32), no LSTM, bf16 compute, f32 parameters, "
           "84x84x4 uint8, 6 actions" if args is None else f"ImpalaNet {args}",
           "model_version": leader["model_version"], "sgd_steps_together": len(times),
           "sgd_steps_per_s": sgd_per_s, "learner_frames_per_s": sgd_per_s * frames,
           "params_sha256_equal": True, "checksum_divergences": 0,
           "checksum_failures": [r["accumulator"]["checksum_failures"] for r in reps],
           "model_sync": {"joiner": f"learner{joiner['rank']}",
                          "bytes": joiner["recovery"]["model_sync_bytes_rx"],
                          "ms": joiner["accumulator"]["model_sync_ms"]},
           "learners": [{
               "rank": r["rank"], "leader": r["is_leader"],
               "elections": r["accumulator"]["elections"],
               "count_round_ms": r["accumulator"]["round_ms"]["count"],
               "grad_round_ms": r["accumulator"]["round_ms"]["grad"],
               "rounds": r["accumulator"]["rounds"],
               # this learner's env steps over its span of applied SGD steps
               "env_steps_per_s": (r["sgd_times"][-1][1] - r["sgd_times"][0][1])
               / max(r["sgd_times"][-1][0] - r["sgd_times"][0][0], 1e-9),
               "env_steps_total": r["env_steps"],
               # The loop's StepTimer EMAs (alpha 0.05): act over thousands
               # of steps, learn and apply over ~50 (the first, cuDNN's
               # warm-up, fades to ~8% of its weight).
               "act_ms_ema": 1e3 * r["sections"].get("act", float("nan")),
               "learn_ms_ema": 1e3 * r["sections"].get("learn", float("nan")),
               "apply_ms_ema": 1e3 * r["sections"].get("apply", float("nan")),
               "d2h_events": r["d2h_events"],
               "d2h_staged_calls": r["accumulator"]["d2h_staged_calls"],
               "reduce_bytes": r["accumulator"]["reduce_bytes"],
               "mfu": r["mfu"],
               "max_memory_allocated": r["max_memory_allocated"],
               "wall_s": r["wall_s"]} for r in reps]}
    log(res)
    return res


def phase_accumulator_lm(seed: int, device="cuda", args=None, steps: int = ACC_LM_STEPS,
                         timeout: float = 900) -> dict:
    """Two examples.lm elastic learners: learner 0 hosts the broker and
    applies one step alone (its AdamW state then exists), learner 1 joins,
    syncs the model and AdamW state, and the two take the remaining steps
    together; the three flash kernels run in every forward and backward."""
    port = free_port()
    common = list(ACC_LM_ARGS if args is None else args) + [
        "--device", device, "--seed", str(seed), "--steps", str(steps),
        "--min_cohort", "2", "--quiet", "--log_interval", "1"]
    argvs = [common + ["--address", f"127.0.0.1:{port}", "--local_name", "lm0"],
             common + ["--connect", f"127.0.0.1:{port}", "--local_name", "lm1"]]
    reps = _run_cohort("lm", argvs, timeout, wait_first=True)
    cuda = torch.device(device).type == "cuda"
    leader, joiner = _cohort_checks("accumulator_lm", reps, cuda)
    if leader["rank"] != 0:
        raise AssertionError("accumulator_lm: learner 0 stepped first and must lead")
    if joiner["accumulator"]["model_sync_sha"] != leader["accumulator"]["model_sync_sha"]:
        raise AssertionError("accumulator_lm: the joiner's blob sha differs from the leader's")
    launches = {k: {f"learner{r['rank']}": r["launches"][k] for r in reps}
                for k in reps[0]["launches"]}
    layers = int(common[common.index("--layers") + 1])
    if cuda and any(v < 2 * layers for per in launches.values() for v in per.values()):
        raise AssertionError(f"accumulator_lm: flash launches {launches}")
    payload = leader["accumulator"]["reduce_bytes"]["rpc"] / max(
        1, leader["accumulator"]["rounds"]["grad"])
    grad_s = 1e-3 * leader["accumulator"]["round_ms"]["grad"]
    sync_s = 1e-3 * joiner["accumulator"]["model_sync_ms"]
    sync_bytes = joiner["recovery"]["model_sync_bytes_rx"]
    res = {"phase": "accumulator_lm", "processes": 2,
           "model": "TransformerLM vocab=32768 d=1024 L=12 H=8x128 max_len 1024, learned "
           "positions, bf16 compute, f32 parameters, flash attention" if args is None
           else f"TransformerLM {args}",
           "batch_per_learner": [4, 1024] if args is None else None,
           "steps": steps, "model_version": leader["model_version"],
           "params_sha256_equal": True,
           "step_s": [r["step_s"] for r in reps], "grad_round_s": grad_s,
           "payload_bytes_per_learner_round": payload,
           "algbw_GB_per_s": payload / grad_s / 1e9 if grad_s else None,
           "model_sync": {"bytes": sync_bytes, "s": sync_s, "GB_per_s": sync_bytes / sync_s / 1e9,
                          "sha": joiner["accumulator"]["model_sync_sha"]},
           "mfu": [r["mfu"] for r in reps], "launches": launches,
           "learners": [{"rank": r["rank"], "leader": r["is_leader"], "loss": r["loss"],
                         "count_round_ms": r["accumulator"]["round_ms"]["count"],
                         "grad_round_ms": r["accumulator"]["round_ms"]["grad"],
                         "d2h_events": r["d2h_events"],
                         "d2h_staged_calls": r["accumulator"]["d2h_staged_calls"],
                         "max_memory_allocated": r["max_memory_allocated"],
                         "wall_s": r["wall_s"]} for r in reps]}
    log(res)
    return res


def make_pool() -> EnvPool:
    """The data path's EnvPool, forked before the first CUDA call."""
    return EnvPool(SyntheticAtariEnv, **POOL)

def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    pool = make_pool()
    try:
        kern, sass, train, sl, rl, cl, acl = _phases(pool, args.seed)
    finally:
        pool.close()
    case = kern["train"]
    replaces = {"flash_fwd": "moolib_tpu/ops/flash_attention.py:54",
                "flash_bwd_dq": "moolib_tpu/ops/flash_attention.py:249",
                "flash_bwd_dkv": "moolib_tpu/ops/flash_attention.py:296"}
    times = {"flash_fwd": (case["ms"], case["plain_ms"], case["sdpa_ms"]),
             "flash_bwd_dq": (case["dq_ms"], case["plain_bwd_ms"], case["sdpa_bwd_ms"]),
             "flash_bwd_dkv": (case["dkv_ms"], case["plain_bwd_ms"], case["sdpa_bwd_ms"])}
    # The instantiation the training shape runs (bf16, D 128, causal).
    built = {"flash_fwd": "flash_fwd_wgmma_kernel", "flash_bwd_dq": "flash_bwd_dq_wgmma_kernel",
             "flash_bwd_dkv": "flash_bwd_dkv_wgmma_kernel"}
    instance = {name: f"{kernel}<bf16,128,causal>" for name, kernel in built.items()}
    log({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"moolib_tpu_torch/ops/csrc/{name[:9]}.cu",
        "replaces": replaces[name],
        "launches": train["launches"][name],
        "launches_by_path": {"train": train["launches"][name],
                             "serve": sl["flash_fwd_launches"] if name == "flash_fwd" else 0,
                             "impala_learner": rl["flash_launches"][name],
                             "cohort_lm": cl["launches"][name],
                             "accumulator_lm": sum(acl["launches"][name].values())},
        "max_abs_err": kern["worst"][name],
        "ms": times[name][0],
        "plain_ms": times[name][1],
        "bound_ms": case["bound_ms"][name],
        "bound_by": case["bound_by"][name],
        "library_ms": times[name][2],
        "shape": case["shape"],
        "kernel": instance[name],
        "tensor_core_instructions": sum(sass[instance[name]].values()),
        "tflops": case["tflops"][name],
        "share_of_bound": case["bound_ms"][name] / times[name][0],
    } for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


def _phases(pool: EnvPool, seed: int) -> tuple:
    phase_device()
    sass = phase_build()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kern = phase_kernels(gen)
    phase_model(gen)
    train = phase_train(seed)
    phase_lm_bench(seed)
    sl = phase_slice(seed)
    phase_impala_parity(seed)
    rl = phase_impala_learner(pool, seed)
    phase_cohort_impala(seed)
    torch.cuda.empty_cache()  # the learner processes share the card
    cl = phase_cohort_lm(seed)
    torch.cuda.empty_cache()
    phase_accumulator_impala(seed)
    torch.cuda.empty_cache()
    acl = phase_accumulator_lm(seed)
    return kern, sass, train, sl, rl, cl, acl


if __name__ == "__main__":
    main()
