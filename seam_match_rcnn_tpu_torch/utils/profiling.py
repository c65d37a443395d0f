"""Profiling hooks.

Port of ``seam_match_rcnn_tpu/utils/profiling.py``: ``trace`` captures a
``torch.profiler`` trace of the enclosed region and writes it into
``log_dir`` as a Chrome trace (``*.pt.trace.json``, which Perfetto and
TensorBoard open), ``annotate`` names a region inside it, and ``StepTimer``
(a copy of the JAX package's) accounts wall time per phase.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str, device: str = "cuda"):
    """Capture a trace of the enclosed region into ``log_dir``: CPU and CUDA
    activity for ``device="cuda"`` (the default, which needs a card), CPU
    activity alone for ``device="cpu"``.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace: no CUDA device; pass device='cpu' to trace the CPU only")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    elif device != "cpu":
        raise ValueError(f"trace: device {device!r}, expected 'cuda' or 'cpu'")
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if device == "cuda":
            torch.cuda.synchronize()


@contextlib.contextmanager
def annotate(name: str):
    """Named sub-region inside an active trace."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Wall-clock per-phase accounting (data / compute / host)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}
