"""Kernels per closed-loop step: the profiler's kernels (device
operations other than copies and sets) over the traced window's
``GSWorldWrapper.step`` calls."""


def read(rec):
    t = rec.trace
    if t is None or "env_steps" not in rec.work or not t.calls:
        return None
    n = len(t.kernels())
    return n / t.calls if n else None
