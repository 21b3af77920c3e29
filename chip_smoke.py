"""Drive the PyTorch port on one CUDA card: build its kernels, hold each
against its plain version, then serve the d=1024/L=12 TransformerLM over
loopback Rpc and check the replies.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero, and no result line is printed):

1. device — require CUDA; print the card's name and power limit.
2. build — compile every kernel source under moolib_tpu_torch/ops/csrc.
3. kernels — flash_fwd against its plain version on the card, causal and
   full, float32 and bfloat16, at the serving prefill shape and others; one
   JSON line per case with the errors and CUDA-event times of the kernel,
   the plain version and torch's scaled_dot_product_attention (timed as a
   yardstick only; the port never calls it).
4. model — a small float32 TransformerLM on the card: flash attention (the
   kernel) against dense attention (plain torch) on the same weights.
5. slice — TransformerLM(vocab 32768, d_model 1024, 8 heads of 128, 12
   layers, bf16, rotary) served by examples.lm_serve.serve() to 4
   concurrent 1024-token prompts from a client Rpc; replies must equal the
   port's own generate() on the same batch, and the prefill must have
   launched the flash kernel once per layer.

The last two lines are the kernel summary {"kernels": [...]} and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from moolib_tpu_torch.examples.lm_serve import serve
from moolib_tpu_torch.models.transformer import TransformerLM, generate
from moolib_tpu_torch.ops import _build
from moolib_tpu_torch.ops import flash_attention as fa
from moolib_tpu_torch.rpc import Rpc, serialization

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and float32 on the
# CUDA cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

KERNEL_SHAPES = [(1, 128, 2, 64), (4, 1024, 8, 128), (2, 1000, 8, 128), (1, 4096, 8, 128)]
MAIN_PATH_SHAPE = (4, 1024, 8, 128)  # the serving prefill: 4 prompts x 1024, 8 heads of 128
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}  # (out, lse) atol


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


def flash_bound_ms(B, T, H, D, dtype, causal: bool) -> tuple:
    """Least time for the forward on these inputs: 2 products of 2*D
    operations per attended (query, key) pair, against reading q, k, v once
    and writing out and lse once."""
    pairs = T * (T + 1) // 2 if causal else T * T
    ops = 4 * B * H * D * pairs
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * B * T * H * D * elem + B * T * H * 4
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.key[:90], e.self_device_time_total / 1e3, e.count) for e in kernels),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "kernel_launches": sum(r[2] for r in rows),
            "top": [[name, ms, n] for name, ms, n in rows[:top]]}


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


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = _build.build_all()
    regs = {
        name: [ln.split(":", 1)[1].strip() for ln in info["log"].splitlines() if "Used" in ln]
        for name, info in _build.build_info.items()
    }
    log({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": paths,
         "ptxas": regs})


def phase_kernels(gen: torch.Generator) -> dict:
    worst = 0.0
    main = None
    for B, T, H, D in KERNEL_SHAPES:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
                           for _ in range(3))
                out, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
                torch.cuda.synchronize()
                p_out, p_lse = fa._blockwise_attention_plain(q.float(), k.float(), v.float(), causal)
                err_out = (out.float() - p_out).abs().max().item()
                err_lse = (lse - p_lse).abs().max().item()
                tol_out, tol_lse = TOL[dtype]
                if not (err_out <= tol_out and err_lse <= tol_lse):
                    raise AssertionError(
                        f"flash_fwd {B, T, H, D} causal={causal} {dtype}: "
                        f"out err {err_out} (atol {tol_out}), lse err {err_lse} (atol {tol_lse})"
                    )
                worst = max(worst, err_out, err_lse)
                ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal), reps=20)
                plain_ms = cuda_ms(lambda: fa._blockwise_attention_plain(q, k, v, causal),
                                   reps=2, warmup=1)
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                sdpa_ms = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal), reps=20)
                bound_ms, bound_by = flash_bound_ms(B, T, H, D, dtype, causal)
                case = {"case": "flash_fwd", "shape": [B, T, H, D], "causal": causal,
                        "dtype": str(dtype).replace("torch.", ""), "err_out": err_out,
                        "err_lse": err_lse, "ms": ms, "plain_ms": plain_ms, "sdpa_ms": sdpa_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
                log(case)
                if (B, T, H, D) == MAIN_PATH_SHAPE and causal and dtype == torch.bfloat16:
                    main = case
                del q, k, v, out, lse, p_out, p_lse
    return {"worst": worst, "main": main}


def phase_model(gen: torch.Generator) -> None:
    """The kernel inside the model: flash vs dense attention, same weights."""
    cfg = dict(vocab_size=512, d_model=256, num_heads=2, num_layers=2, max_len=320,
               dtype=torch.float32, pos_embedding="rotary", device="cuda")
    flash = TransformerLM(attention="flash", generator=torch.Generator().manual_seed(1), **cfg)
    dense = TransformerLM(attention="dense", generator=torch.Generator().manual_seed(1), **cfg)
    tokens = torch.randint(0, 512, (2, 300), generator=gen, device="cuda")
    with torch.inference_mode():
        lf, ld = flash(tokens), dense(tokens)
        gf, gd = generate(flash, tokens[:, :256], 16), generate(dense, tokens[:, :256], 16)
    err = (lf - ld).abs().max().item()
    if not (torch.isfinite(lf).all() and err <= 1e-3):
        raise AssertionError(f"model logits: flash vs dense max err {err} (atol 1e-3)")
    if not torch.equal(gf, gd):
        raise AssertionError("model: greedy tokens differ between flash and dense attention")
    log({"phase": "model", "logits_max_abs_err": err, "atol": 1e-3, "tokens_equal": True})


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
        # The main path: counts start at 0 here and are read right after.
        fa.reset_flash_fwd_launches()
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
        raise AssertionError(f"flash_fwd launched {launches} times in the main path, "
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
        gen_ms, gen_min, gen_max = median_call_ms(lambda: generate(model, dev_batch, new),
                                                  reps=5)
        profile = device_profile(lambda: generate(model, dev_batch, new))
    decode_ms = (gen_ms - prefill_ms) / (new - 1)
    out = {"phase": "slice", "model": "TransformerLM vocab=32768 d=1024 L=12 H=8x128 bf16 rotary",
           "batch": B, "prompt_len": Tp, "max_new_tokens": new, "init_s": init_s,
           "flash_fwd_launches": launches, "request_latency_ms": latency_ms,
           "prefill_ms": prefill_ms, "generate_ms": gen_ms, "generate_ms_min": gen_min,
           "generate_ms_max": gen_max, "decode_ms_per_token": decode_ms,
           "max_memory_allocated": peak_bytes, "native_codec": serialization.native_available(),
           "replies_equal_generate": True}
    log(out)
    log({"phase": "profile", "window": "generate(4 x 1024 prompt, 32 new tokens)", **profile})
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    kern = phase_kernels(gen)
    phase_model(gen)
    sl = phase_slice(args.seed)
    main_case = kern["main"]
    log({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "moolib_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "moolib_tpu/ops/flash_attention.py:54",
        "launches": sl["flash_fwd_launches"],
        "max_abs_err": kern["worst"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["sdpa_ms"],
    }]})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
