"""Profiling hooks.

Counterpart of vision_transformers_torch_xla_tpu/obs/profiler.py
(:17-61) on `torch.profiler`: `trace` captures the host and, when there
is a card, its kernels, and writes a Chrome trace (open it in
ui.perfetto.dev, chrome://tracing or TensorBoard's profiler plugin);
`step_annotation` and `named_scope` mark regions in it; `StepTimer` is
copied.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture the block's host work and, on a card, its kernels; on exit
    write them as `<log_dir>/trace-<time>-<pid>.pt.trace.json`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{int(time.time())}-{os.getpid()}.pt.trace.json"))


def step_annotation(name: str, step: Optional[int] = None):
    """Annotate a training step so it shows as one unit in the trace."""
    return record_function(name if step is None else f"{name}#{step}")


def named_scope(name: str):
    """Annotate a host-side region."""
    return record_function(name)


class StepTimer:
    """Host-side step timing with percentiles."""

    def __init__(self):
        self.times = []
        self._t = None

    def start(self):
        self._t = time.perf_counter()

    def stop(self):
        if self._t is not None:
            self.times.append(time.perf_counter() - self._t)
            self._t = None

    def summary(self) -> dict:
        if not self.times:
            return {}
        import numpy as np

        a = np.asarray(self.times)
        return {"mean_s": float(a.mean()), "p50_s": float(np.percentile(a, 50)),
                "p95_s": float(np.percentile(a, 95)), "n": len(a)}
