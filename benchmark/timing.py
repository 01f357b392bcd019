"""Timing by CUDA events, for the per-layer readers."""

from __future__ import annotations


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls queued back to back
    between two CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
