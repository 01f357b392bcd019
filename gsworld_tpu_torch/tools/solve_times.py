#!/usr/bin/env python3
"""Times of the contact solver's linear solve on the card: one
factorization of a batch of symmetric positive definite (B, n, n)
matrices and three solves against it (one Newton step of
physics/world.py), by the solver's own routine (``world._Factor``:
Cholesky with two triangular solves) and by two it did not take (Cholesky
with ``cholesky_solve``, LU), eagerly and replayed from a CUDA graph; and
whether each can be captured at all.

    python3 gsworld_tpu_torch/tools/solve_times.py [--n 180] [--batches 1 4 64]

The matrices are J J^T + 1e-3 diag + identity rows, as the masked
Delassus systems are, from a seed.  Prints one line per (routine, B).
"""

import argparse
import functools
import os
import statistics
import subprocess

import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from gsworld_tpu_torch.physics import world as W


class CholeskySolve:
    """cholesky_ex + cholesky_solve."""

    def __init__(self, A):
        self.L = torch.linalg.cholesky_ex(A).L

    def solve(self, b):
        return torch.cholesky_solve(b[..., None], self.L)[..., 0]


class LU:
    """lu_factor_ex + lu_solve."""

    def __init__(self, A):
        self.LU, self.piv, _ = torch.linalg.lu_factor_ex(A)

    def solve(self, b):
        return torch.linalg.lu_solve(self.LU, self.piv, b[..., None])[..., 0]


# "cholesky_tri" is the solver's own: Cholesky and two triangular solves
ROUTINES = {"cholesky_tri": W._Factor, "cholesky": CholeskySolve, "lu": LU}


def newton_step(factor, A, b):
    """One Newton step of the contact solver's normal stage: solve
    A x = b, then two refinement sweeps, on one factorization."""
    fac = factor(A)
    x = fac.solve(b)
    for _ in range(2):
        x = x - fac.solve((A @ x[..., None])[..., 0] - b)
    return x


def event_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=180)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 4, 64])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--routines", nargs="+",
                    default=list(ROUTINES), choices=list(ROUTINES))
    ap.add_argument("--library", default=None,
                    help="torch.backends.cuda.preferred_linalg_library to "
                         "set first (cusolver, magma)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("solve_times needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    if args.library:
        torch.backends.cuda.preferred_linalg_library(args.library)
    print(f"preferred linalg library: "
          f"{torch.backends.cuda.preferred_linalg_library()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    n = args.n
    for B in args.batches:
        J = torch.randn((B, n, 12), generator=gen, device="cuda")
        A = J @ J.transpose(-1, -2)
        A = A + 1e-3 * torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1))
        # a third of the rows inactive: identity rows and columns
        off = torch.rand((B, n), generator=gen, device="cuda") < 0.33
        A = (torch.where(off[:, :, None] | off[:, None, :], 0.0, A)
             + torch.diag_embed(off.float()))
        b = torch.randn((B, n), generator=gen, device="cuda")
        ref = torch.linalg.solve(A.double(), b.double()[..., None])[..., 0]
        for name in args.routines:
            fn = functools.partial(newton_step, ROUTINES[name])
            x = fn(A, b)
            err = float((x.double() - ref).abs().max() / ref.abs().max())
            eager = event_ms(lambda: fn(A, b))
            try:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    fn(A, b)
                torch.cuda.current_stream().wait_stream(side)
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    xg = fn(A, b)
                g.replay()
                torch.cuda.synchronize()
                same = torch.equal(xg, x)
                graph = (f"graph replay {event_ms(g.replay):.4f} ms, "
                         f"{'bit for bit' if same else 'NOT equal to'} eager")
            except Exception as e:   # report what refused the capture
                torch.cuda.synchronize()
                graph = f"not capturable ({type(e).__name__}: {e})"[:300]
            print(f"{name:12s} ({B}, {n}, {n}): 1 factorization + 3 solves "
                  f"eager {eager:.4f} ms, {graph}; max rel err vs f64 "
                  f"{err:.3g}", flush=True)


if __name__ == "__main__":
    main()
