"""Drive the PyTorch port on one CUDA card: build its kernels, hold each
against its plain version, train the d=1024/L=12 TransformerLM through
examples.lm.train(), run the lm_bench step, then serve the same widths over
loopback Rpc and check the replies.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero, and no result line is printed):

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

The last two lines are the kernel summary {"kernels": [...]}, with each
kernel's time, TFLOP/s, share of bound and tensor-core instruction count
at the training shape, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from moolib_tpu_torch.examples import lm
from moolib_tpu_torch.examples.lm_serve import serve
from moolib_tpu_torch.models.transformer import TransformerLM, generate
from moolib_tpu_torch.ops import _build
from moolib_tpu_torch.ops import flash_attention as fa
from moolib_tpu_torch.ops.xent import lm_head_xent, naive_softmax_xent
from moolib_tpu_torch.rpc import Rpc, serialization

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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    phase_device()
    sass = phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    kern = phase_kernels(gen)
    phase_model(gen)
    train = phase_train(args.seed)
    phase_lm_bench(args.seed)
    sl = phase_slice(args.seed)
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
                             "serve": sl["flash_fwd_launches"] if name == "flash_fwd" else 0},
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


if __name__ == "__main__":
    main()
