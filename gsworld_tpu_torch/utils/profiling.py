"""Tracing / profiling (port of gsworld_tpu/utils/profiling.py).

- ``trace(log_dir)``: context manager around ``torch.profiler`` (the CPU,
  and the card's kernels where CUDA is available); on exit it writes a
  Chrome trace, ``<log_dir>/trace.json``, viewable in Perfetto or
  chrome://tracing.  The profiler object is yielded for
  ``key_averages()``.
- ``StepTimer``: per-phase wall-clock stats with an FPS summary.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str = "./gsworld_trace"):
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Accumulates per-phase timings; phases nest freely."""

    def __init__(self):
        self._acc: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def fps(self, name: str, per_call_items: int = 1) -> float:
        ts = self._acc.get(name, [])
        total = sum(ts)
        return len(ts) * per_call_items / total if total else 0.0

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, ts in self._acc.items():
            arr = np.asarray(ts)
            out[name] = {
                "count": len(arr),
                "total_s": float(arr.sum()),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
            }
        return out

    def print_summary(self):
        for name, s in sorted(self.summary().items()):
            print(f"{name:30s} n={s['count']:5d} mean={s['mean_ms']:8.2f}ms "
                  f"p95={s['p95_ms']:8.2f}ms total={s['total_s']:7.2f}s")
