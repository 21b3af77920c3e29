"""Device performance plane: memory and MFU accounting on the card.

The port of the JAX package's ``telemetry/devmon.py``, in the parts that
have a torch meaning.  Everything publishes through the process metrics
registry under the JAX package's metric names:

- **Memory** — :func:`sample_memory` reads ``torch.cuda.memory_stats`` of
  every initialized card into ``hbm_bytes_{in_use,peak,limit}{device}``
  gauges with high-watermark tracking and an OOM-margin warning
  (``MOOLIB_DEVMON_HBM_WARN_FRACTION``).  Without a card (or before CUDA
  is initialized) one host-RSS sample stands in under ``device="host"``.
- **Step cost / MFU** — :func:`step_cost` counts a step's FLOPs once per
  input signature with ``torch.utils.flop_counter.FlopCounterMode`` (the
  port's stand-in for XLA's ``cost_analysis``: matmuls, convolutions and
  attention, forward and backward, counted as 2 per multiply-add) and
  caches the count; :func:`publish_step` combines it with a measured step
  time into ``step_mfu{fn}`` plus a roofline verdict against the card's
  peaks (:func:`peak_flops`, :func:`peak_bandwidth`: 989 TFLOP/s bf16 dense
  and 3.35 TB/s for the H100 SXM).  The bytes a step moves are counted as
  its tensor inputs and parameters, each read once: a lower bound, not a
  measurement of traffic.

- **Dispatch timing** — :func:`set_dispatch_hook` installs one
  ``(fn, t0_ns, t1_ns)`` listener; :class:`dispatch_span` around a train
  step and :func:`instrument` around a callable feed it (free while no
  hook is installed).  ``telemetry.timeline`` anchors its capture windows
  onto train steps through this seam.

The JAX package's compile observability (``instrument_jit``'s recompile
detector, the ``jax.monitoring`` listeners) has no torch counterpart here:
eager torch compiles nothing per signature.  Torch is imported inside the
functions that need it, so the telemetry package stays importable from env
workers.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import metrics
from .flightrec import flight_event

__all__ = [
    "StepCost",
    "dispatch_span",
    "install_from_env",
    "instrument",
    "peak_bandwidth",
    "peak_flops",
    "publish_step",
    "reset_for_tests",
    "roofline",
    "sample_memory",
    "set_dispatch_hook",
    "start",
    "step_cost",
    "stop",
    "summary_text",
]

_REG = metrics.get_registry()
_M_HBM_IN_USE = _REG.gauge(
    "hbm_bytes_in_use", "allocator bytes in use per device (host RSS without a card)",
    ("device",),
)
_M_HBM_PEAK = _REG.gauge(
    "hbm_bytes_peak", "allocator peak bytes in use per device", ("device",)
)
_M_HBM_LIMIT = _REG.gauge(
    "hbm_bytes_limit", "device memory per device (host MemTotal without a card)",
    ("device",),
)
_M_STEP_MFU = _REG.gauge(
    "step_mfu",
    "model FLOPs utilization: counted flops / step seconds / peak FLOP/s",
    ("fn",),
)
_M_STEP_BPF = _REG.gauge(
    "step_bytes_per_flop",
    "counted bytes (inputs and parameters, read once) per flop for the step",
    ("fn",),
)
_M_STEP_FLOPS = _REG.gauge("step_flops", "counted model flops per step", ("fn",))
_M_STEP_BYTES = _REG.gauge(
    "step_bytes_accessed", "counted bytes per step (inputs and parameters, read once)",
    ("fn",),
)

# Peak dense bf16 FLOP/s and memory bandwidth per card, from NVIDIA's spec
# sheets.  Substring-matched against ``torch.cuda.get_device_name`` — order
# matters ("h100 pcie" before "h100").
_PEAK_FLOPS: List[Tuple[str, float]] = [
    ("h100 pcie", 756e12),
    ("h100", 989e12),
    ("h200", 989e12),
    ("a100", 312e12),
]
_PEAK_BW: List[Tuple[str, float]] = [
    ("h100 pcie", 2.0e12),
    ("h100", 3.35e12),
    ("h200", 4.8e12),
    ("a100", 2.039e12),
]
# Unknown devices (the CPU above all) get a *nominal* peak so step_mfu stays
# finite and tracks relative regressions; publish_step says so through
# ``peak_source``.
NOMINAL_PEAK_FLOPS = 1e12
NOMINAL_PEAK_BW = 100e9

_lock = threading.RLock()
_COST_CACHE: Dict[Tuple[str, Any], Optional["StepCost"]] = {}
_WATERMARKS: Dict[str, float] = {}  # device label -> peak bytes_in_use seen
_HBM_WARNED: Dict[str, bool] = {}  # device label -> currently above threshold
_LAST_MEMORY: Dict[str, Dict[str, float]] = {}
_thread: Optional[threading.Thread] = None
_thread_stop = threading.Event()


# ---------------------------------------------------------------------- memory
# Optional (fn, t0_ns, t1_ns) listener for instrumented dispatches — the
# seam telemetry.timeline uses to anchor capture windows onto train steps.
# Module-global read (no lock) on the call path; None means untimed.
_dispatch_hook = None


def set_dispatch_hook(hook) -> None:
    """Install (or clear, with None) the dispatch listener.  The hook is
    called as ``hook(name, t0_ns, t1_ns)`` with perf_counter_ns bounds of
    each instrumented call; it must be cheap and must not raise."""
    global _dispatch_hook
    _dispatch_hook = hook


class dispatch_span:
    """Times the body as one dispatch of ``name`` for the dispatch hook when
    one is installed; otherwise free.  The examples wrap each train step."""

    __slots__ = ("_name", "_t0")

    def __init__(self, name: str):
        self._name = name
        self._t0 = None

    def __enter__(self):
        if _dispatch_hook is not None:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        hook = _dispatch_hook
        if hook is not None and self._t0 is not None:
            try:
                hook(self._name, self._t0, time.perf_counter_ns())
            except Exception:  # noqa: BLE001 — listener must never break the step
                pass
        return False


class _Instrumented:
    """Callable wrapper timing each call for the dispatch hook; attribute
    access forwards to the wrapped callable."""

    __slots__ = ("_fn", "_name")

    def __init__(self, fn, name: str):
        self._fn = fn
        self._name = name

    def __call__(self, *args, **kwargs):
        hook = _dispatch_hook
        if hook is None:
            return self._fn(*args, **kwargs)
        t0 = time.perf_counter_ns()
        try:
            return self._fn(*args, **kwargs)
        finally:
            try:
                hook(self._name, t0, time.perf_counter_ns())
            except Exception:  # noqa: BLE001 — listener must never break the step
                pass

    def __getattr__(self, item):
        return getattr(self._fn, item)


def instrument(fn, name: str):
    """Wrap ``fn`` so each call is a dispatch of ``name`` (the timing half
    of the JAX package's ``instrument_jit``; idempotent)."""
    if isinstance(fn, _Instrumented):
        return fn
    return _Instrumented(fn, name)


def _host_memory() -> Optional[Dict[str, float]]:
    """RSS + MemTotal for a process without a card."""
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        rss = rss_pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None
    limit = 0.0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    limit = float(line.split()[1]) * 1024.0
                    break
    except (OSError, ValueError, IndexError):
        pass
    return {"bytes_in_use": float(rss), "bytes_limit": limit}


def _warn_fraction() -> float:
    try:
        return float(os.environ.get("MOOLIB_DEVMON_HBM_WARN_FRACTION", "0.9"))
    except ValueError:
        return 0.9


def _card_memory() -> Dict[str, Dict[str, float]]:
    """Allocator stats of every card this process has touched.  Never
    initializes CUDA itself (an env worker must stay fork-safe)."""
    if "torch" not in sys.modules:
        return {}
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        if not ms:
            continue
        out[f"cuda:{i}"] = {
            "bytes_in_use": float(ms.get("allocated_bytes.all.current", 0)),
            "bytes_peak": float(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": float(torch.cuda.get_device_properties(i).total_memory),
        }
    return out


def sample_memory() -> Dict[str, Dict[str, float]]:
    """One memory sample into the ``hbm_bytes_*`` gauges, with
    high-watermark tracking and an OOM-margin warning: crossing
    ``MOOLIB_DEVMON_HBM_WARN_FRACTION`` of the limit emits a
    ``devmon.hbm_pressure`` flight event once per excursion (re-armed when
    usage drops back under).  Without a card, one host-RSS sample under
    ``device="host"``."""
    out = _card_memory()
    if not out:
        host = _host_memory()
        if host is not None:
            out["host"] = {
                "bytes_in_use": host["bytes_in_use"],
                "bytes_peak": host["bytes_in_use"],
                "bytes_limit": host["bytes_limit"],
            }
    frac = _warn_fraction()
    for label, row in out.items():
        with _lock:
            wm = max(_WATERMARKS.get(label, 0.0), row["bytes_in_use"],
                     row.get("bytes_peak", 0.0))
            _WATERMARKS[label] = wm
            _LAST_MEMORY[label] = dict(row)
        row["bytes_peak"] = max(row.get("bytes_peak", 0.0), wm)
        _M_HBM_IN_USE.set(row["bytes_in_use"], device=label)
        _M_HBM_PEAK.set(row["bytes_peak"], device=label)
        _M_HBM_LIMIT.set(row["bytes_limit"], device=label)
        limit = row["bytes_limit"]
        if limit > 0:
            over = row["bytes_in_use"] / limit >= frac
            with _lock:
                warned = _HBM_WARNED.get(label, False)
                _HBM_WARNED[label] = over
            if over and not warned:
                flight_event(
                    "devmon.hbm_pressure",
                    device=label,
                    in_use=int(row["bytes_in_use"]),
                    limit=int(limit),
                    fraction=round(row["bytes_in_use"] / limit, 3),
                )
                sys.stderr.write(
                    f"moolib_tpu_torch.devmon: WARN {label} at "
                    f"{row['bytes_in_use'] / limit:.0%} of its memory limit\n"
                )
    return out


# --------------------------------------------------------------- step cost/MFU
class StepCost:
    """Counted cost of one step: flops + the bytes of its inputs."""

    __slots__ = ("flops", "bytes_accessed")

    def __init__(self, flops: float, bytes_accessed: float):
        self.flops = float(flops)
        self.bytes_accessed = float(bytes_accessed)

    @property
    def arithmetic_intensity(self) -> Optional[float]:
        return self.flops / self.bytes_accessed if self.bytes_accessed else None

    def __repr__(self):
        return f"StepCost(flops={self.flops:.3g}, bytes_accessed={self.bytes_accessed:.3g})"


def _tensor_leaves(obj, out: list) -> list:
    import torch

    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, torch.nn.Module):
        out.extend(obj.parameters())
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensor_leaves(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensor_leaves(v, out)
    return out


def _signature(args, kwargs) -> tuple:
    leaves = _tensor_leaves((list(args), kwargs), [])
    return tuple((tuple(t.shape), str(t.dtype), t.device.type) for t in leaves)


def step_cost(name: str, fn, *args, **kwargs) -> Optional["StepCost"]:
    """Count the flops of ``fn(*args, **kwargs)`` by running it once under
    ``FlopCounterMode``, cached per (name, input signature): the caller
    pays one extra step per geometry.  ``fn``'s result is dropped, so it
    must leave no state behind that the caller relies on (a function that
    sets fresh ``.grad`` tensors is fine).  Meta tensors count without
    computing.  Returns None when nothing was counted."""
    try:
        sig = (name, _signature(args, kwargs))
    except Exception:  # noqa: BLE001 — unreadable args: no count
        return None
    with _lock:
        if sig in _COST_CACHE:
            return _COST_CACHE[sig]
    from torch.utils.flop_counter import FlopCounterMode

    cost = None
    try:
        counter = FlopCounterMode(display=False)
        with counter:
            fn(*args, **kwargs)
        flops = float(counter.get_total_flops())
        nbytes = float(sum(t.numel() * t.element_size()
                           for t in {id(t): t for t in _tensor_leaves(
                               (list(args), kwargs, fn), [])}.values()))
        if flops > 0:
            cost = StepCost(flops, nbytes)
    except Exception:  # noqa: BLE001 — counting is best-effort
        cost = None
    with _lock:
        _COST_CACHE[sig] = cost
    if cost is not None:
        _M_STEP_FLOPS.set(cost.flops, fn=name)
        _M_STEP_BYTES.set(cost.bytes_accessed, fn=name)
    return cost


def _lookup(table, env: str, nominal: float, device_kind: Optional[str]):
    raw = os.environ.get(env)
    if raw:
        try:
            return float(raw), "env"
        except ValueError:
            pass
    k = (device_kind or "").lower()
    for sub, peak in table:
        if sub in k:
            return peak, "table"
    return nominal, "nominal"


def peak_flops(device_kind: Optional[str] = None) -> Tuple[float, str]:
    """Peak dense bf16 FLOP/s for a device name: ``MOOLIB_DEVMON_PEAK_FLOPS``
    override > spec table > nominal (unknown names, the CPU).  Returns
    ``(flops_per_s, source)`` with source in {"env", "table", "nominal"}."""
    return _lookup(_PEAK_FLOPS, "MOOLIB_DEVMON_PEAK_FLOPS", NOMINAL_PEAK_FLOPS, device_kind)


def peak_bandwidth(device_kind: Optional[str] = None) -> Tuple[float, str]:
    """Peak memory bytes/s for a device name (same resolution order as
    :func:`peak_flops`; override knob ``MOOLIB_DEVMON_PEAK_BW``)."""
    return _lookup(_PEAK_BW, "MOOLIB_DEVMON_PEAK_BW", NOMINAL_PEAK_BW, device_kind)


def _device_kind() -> Optional[str]:
    if "torch" not in sys.modules:
        return None
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0)


def roofline(
    flops: float, bytes_accessed: float, device_kind: Optional[str] = None
) -> Dict[str, Any]:
    """Roofline classification for a step: arithmetic intensity vs the
    card's ridge point (peak_flops / peak_bw).  AI below the ridge means the
    step is memory-bound; above, compute-bound."""
    pf, pf_src = peak_flops(device_kind)
    pb, pb_src = peak_bandwidth(device_kind)
    out: Dict[str, Any] = {
        "peak_flops": pf,
        "peak_bw": pb,
        "peak_source": pf_src if pf_src == pb_src else f"{pf_src}/{pb_src}",
    }
    if not bytes_accessed or not flops:
        out["bound"] = None
        return out
    ai = flops / bytes_accessed
    ridge = pf / pb
    out["arithmetic_intensity_flop_per_byte"] = ai
    out["ridge_flop_per_byte"] = ridge
    out["min_step_s_compute"] = flops / pf
    out["min_step_s_memory"] = bytes_accessed / pb
    out["roofline_mfu_ceiling"] = min(1.0, ai / ridge)
    out["bound"] = "memory" if ai < ridge else "compute"
    return out


def publish_step(
    name: str,
    cost: Optional["StepCost"],
    step_seconds: float,
    device_kind: Optional[str] = None,
) -> Optional[Dict[str, Any]]:
    """Combine a counted step cost with a measured step time into the
    ``step_mfu{fn}`` / ``step_bytes_per_flop{fn}`` gauges plus the roofline
    verdict.  Returns ``{"mfu", "bytes_per_flop", "bound", ...}`` (None when
    there is nothing to publish)."""
    if cost is None or step_seconds <= 0 or cost.flops <= 0:
        return None
    if device_kind is None:
        device_kind = _device_kind()
    roof = roofline(cost.flops, cost.bytes_accessed, device_kind)
    mfu = cost.flops / step_seconds / roof["peak_flops"]
    bpf = cost.bytes_accessed / cost.flops
    _M_STEP_MFU.set(mfu, fn=name)
    _M_STEP_BPF.set(bpf, fn=name)
    return {
        "mfu": mfu,
        "bytes_per_flop": bpf,
        "bound": roof.get("bound"),
        "peak_source": roof["peak_source"],
        "roofline": roof,
    }


# ------------------------------------------------------------------- lifecycle
def start(interval: float) -> bool:
    """Background memory-sampling thread (daemon; one per process)."""
    global _thread
    with _lock:
        if _thread is not None and _thread.is_alive():
            return False
        _thread_stop.clear()

        def _loop():
            while not _thread_stop.wait(interval):
                try:
                    sample_memory()
                except Exception:  # noqa: BLE001 — sampling must never crash the run
                    pass

        _thread = threading.Thread(target=_loop, name="devmon-mem", daemon=True)
        _thread.start()
        return True


def stop() -> None:
    global _thread
    with _lock:
        t, _thread = _thread, None
    if t is not None:
        _thread_stop.set()
        t.join(timeout=1.0)


def install_from_env() -> dict:
    """Start the periodic memory sampler when ``MOOLIB_DEVMON_INTERVAL`` >
    0.  Idempotent."""
    interval = 0.0
    raw = os.environ.get("MOOLIB_DEVMON_INTERVAL")
    if raw:
        try:
            interval = float(raw)
        except ValueError:
            interval = 0.0
    started = start(interval) if interval > 0 else False
    return {"interval": interval if started else None}


def summary_text() -> str:
    """Devmon section for diagnostics dumps: per-device memory watermarks
    and the counted step costs.  Formats already-collected dicts only —
    safe from a signal handler."""
    with _lock:
        marks = dict(_WATERMARKS)
        mem = {k: dict(v) for k, v in _LAST_MEMORY.items()}
        costs = {k[0]: v for k, v in _COST_CACHE.items() if v is not None}
    lines = ["--- devmon (device performance plane) ---\n"]
    if marks:
        for label in sorted(marks):
            row = mem.get(label, {})
            lines.append(
                f"memory {label}: watermark={marks[label] / 1e6:.1f}MB"
                f" in_use={row.get('bytes_in_use', 0.0) / 1e6:.1f}MB"
                f" limit={row.get('bytes_limit', 0.0) / 1e6:.1f}MB\n"
            )
    else:
        lines.append("memory: no samples yet\n")
    for name in sorted(costs):
        lines.append(f"step {name}: {costs[name]!r}\n")
    return "".join(lines)


def reset_for_tests() -> None:
    """Drop cost-cache / watermark state (test isolation only; registered
    metrics reset separately via the registry)."""
    stop()
    with _lock:
        _COST_CACHE.clear()
        _WATERMARKS.clear()
        _HBM_WARNED.clear()
        _LAST_MEMORY.clear()
