"""Tracing/profiling hooks: the port of the JAX package's
``utils/profiling.py``.

- :func:`trace` — context manager around ``torch.profiler.profile``
  (CPU and, where there is a card, CUDA activity), writing a Chrome trace
  into ``log_dir`` (where the JAX package wraps ``jax.profiler``).
- :class:`StepTimer` — cheap wall-clock section timing with EMA summaries,
  for the python-side loop.  Registry-backed: every section also lands in
  the telemetry registry (``loop_section_seconds{section=...}``) and
  records a host span.
- :func:`annotate` — ``torch.profiler.record_function``, so loop phases
  show up inside device traces.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

from .. import telemetry


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace into ``log_dir/trace.json`` (open it
    in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Label a region so it appears inside the device trace timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """EMA section timer for the training loop's python side.

    Each ``section`` observation additionally feeds the process telemetry:
    a ``loop_section_seconds{section=<name>}`` histogram sample in the
    registry and a span in the default tracer.  Pass ``publish=False`` (or
    a private ``registry``/``tracer``) to opt out — e.g. micro-benchmarks
    that would flood the span ring.
    """

    def __init__(
        self,
        alpha: float = 0.05,
        publish: bool = True,
        registry: Optional["telemetry.Registry"] = None,
        tracer: Optional["telemetry.Tracer"] = None,
    ):
        self._alpha = alpha
        self._ema: Dict[str, float] = {}
        self.last: Dict[str, float] = {}  # each section's latest seconds
        self._counts: Dict[str, int] = defaultdict(int)
        self._hist = None
        self._tracer = None
        if publish:
            reg = registry or telemetry.get_registry()
            self._hist = reg.histogram(
                "loop_section_seconds", "train-loop section wall time", ("section",)
            )
            self._tracer = tracer or telemetry.get_tracer()

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        span = self._tracer.span(name) if self._tracer is not None else None
        if span is not None:
            span.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if span is not None:
                span.__exit__(None, None, None)
            if self._hist is not None:
                self._hist.observe(dt, section=name)
            self.last[name] = dt
            prev = self._ema.get(name)
            self._ema[name] = dt if prev is None else (1 - self._alpha) * prev + self._alpha * dt
            self._counts[name] += 1

    def summary(self) -> Dict[str, float]:
        """EMA seconds per section."""
        return dict(self._ema)

    def report(self) -> str:
        total = sum(self._ema.values()) or 1e-9
        parts = [
            f"{k}={v*1e3:.1f}ms({v/total*100:.0f}%)"
            for k, v in sorted(self._ema.items(), key=lambda kv: -kv[1])
        ]
        return " ".join(parts)
