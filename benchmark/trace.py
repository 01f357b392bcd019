"""The traced window: ``torch.profiler`` over part of a ``--trace 1``
run's window, reduced to what the readers and the result line need: the
device's busy time (the union of every device operation's interval), the
kernels by name, the longest idle gaps and what the host was doing in
them.  The harness marks its own calls with ``record_function`` ranges
named ``bench.*``; the host side of a gap is named by the innermost of
those and the innermost profiler op around it."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

MARGIN_S = 0.05    # host idle time kept at each edge of the profile
NOT_KERNEL = ("Memcpy", "Memset")


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


class TraceData:
    """A traced window, in seconds.  ``ops``: every device operation
    (name, start, end); ``host``: every host range (name, start, end)."""

    def __init__(self, ops, host, window: Tuple[float, float], calls: int):
        self.ops = ops
        self.host = host
        self.lo, self.hi = window
        self.calls = calls            # timed calls inside the window
        inside = [(s, e) for _, s, e in ops if e > self.lo and s < self.hi]
        self.window_s = self.hi - self.lo
        self.busy_s = union_length(
            [(max(s, self.lo), min(e, self.hi)) for s, e in inside])

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [o for o in self.ops if not o[0].startswith(NOT_KERNEL)]

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        """{device op name: (count, seconds)}."""
        acc: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
        for name, s, e in self.ops:
            acc[name][0] += 1
            acc[name][1] += e - s
        return {k: (int(c), t) for k, (c, t) in acc.items()}

    def matching(self, words, exclude=()) -> Tuple[int, float]:
        """Count and seconds of the kernels whose name holds every one of
        ``words`` and none of ``exclude``."""
        n, t = 0, 0.0
        for name, (c, s) in self.by_name().items():
            if all(w in name for w in words) and not any(
                    x in name for x in exclude):
                n, t = n + c, t + s
        return n, t

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost ``bench.*``
        range and the innermost other range around it."""
        bench, op = None, None
        for name, s, e in self.host:
            if s <= t <= e:
                if name.startswith("bench."):
                    if bench is None or e - s < bench[1]:
                        bench = (name, e - s)
                elif op is None or e - s < op[1]:
                    op = (name, e - s)
        parts = [x[0] for x in (bench, op) if x is not None]
        return "/".join(parts) if parts else "outside every range"

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        free = gaps([(s, e) for _, s, e in self.ops], self.lo, self.hi)
        free.sort(key=lambda g: g[1] - g[0], reverse=True)
        return [[self.host_at(0.5 * (s + e)), e - s] for s, e in free[:n]]

    def breakdown(self) -> dict:
        top = sorted(self.by_name().items(), key=lambda kv: kv[1][1],
                     reverse=True)[:10]
        return {"device_ops": [[k, t] for k, (_, t) in top],
                "idle_gaps": self.idle_gaps()}


class Traced:
    """``with Traced() as t: ...`` profiles the block; ``t.data(calls)``
    reduces it.  The window is the block's ``bench.window`` range."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self.cuda = torch.cuda.is_available()
        if self.cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else []))
        self.prof.__enter__()
        time.sleep(MARGIN_S)
        self.range = record_function("bench.window")
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self.range.__exit__(*exc)
        time.sleep(MARGIN_S)
        self.prof.__exit__(*exc)
        return False

    def data(self, calls: int) -> TraceData:
        from torch.autograd import DeviceType
        ops, host, window = [], [], None
        for e in self.prof.events():
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == DeviceType.CUDA:
                # a host range's shadow on the device timeline is no op
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith(("bench.", "gsw."))):
                    ops.append((e.name, s, t))
            else:
                host.append((e.name, s, t))
                if e.name == "bench.window":
                    window = (s, t)
        if window is None:
            raise RuntimeError("the profiler lost the bench.window range")
        host.sort(key=lambda h: h[1])
        return TraceData(ops, host, window, calls)
