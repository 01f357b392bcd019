#!/usr/bin/env python3
"""Times of the contact solver's linear solve on the card: one
factorization of a batch of symmetric positive definite (B, n, n)
matrices and three solves against it (one Newton step of
physics/world.py's plain normal stage), by ``world._Factor`` (Cholesky
with two triangular solves) and by two routines the solver did not take
(Cholesky with ``cholesky_solve``, LU), eagerly and replayed from a CUDA
graph, and whether each can be captured at all; and the whole normal
stage (``world.normal_newton``: csrc/contact_newton.cu, one launch) at the
benchmark cells' shapes, beside its float32 bound and its plain version.

    python3 gsworld_tpu_torch/tools/solve_times.py [--n 180] [--batches 1 4 64]
        [--routines cholesky_tri cholesky lu newton]

The routines' matrices are J J^T + 1e-3 diag + identity rows, as the
masked Delassus systems are, from a seed; the stage's are the systems of
seeded env steps (``seeded_systems``), as the solver hands them, and
stress systems made from them (``newton_systems``).  Prints one line per
(routine, B) and per (shape, systems).
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


# "cholesky_tri" is the plain normal stage's: Cholesky and two triangular
# solves
ROUTINES = {"cholesky_tri": W._Factor, "cholesky": CholeskySolve, "lu": LU}
# the benchmark cells' shapes of the normal stage: env id, envs, env kwargs
NEWTON_SHAPES = {"e64": ("AlignFr3Env-v1", 64, {}),
                 "dr64": ("AlignXArmEnv-v1", 64,
                          dict(domain_randomization=True)),
                 "e1": ("AlignFr3Env-v1", 1, {})}
F32_FLOPS = 67e12    # the H100 SXM's float32 rate outside the tensor cores


def newton_step(factor, A, b):
    """One Newton step of the contact solver's normal stage: solve
    A x = b, then two refinement sweeps, on one factorization."""
    fac = factor(A)
    x = fac.solve(b)
    for _ in range(2):
        x = x - fac.solve((A @ x[..., None])[..., 0] - b)
    return x


def seeded_systems(env_id, B, seed, steps=3, **kw):
    """The inputs of every ``normal_newton`` call (one per substep) of one
    eager control step of ``env_id`` at B envs on the card, after
    ``steps`` steps of seeded random actions from reset(seed)."""
    from gsworld_tpu_torch import envs
    env = envs.make(env_id, num_envs=B, device="cuda", graph=False, **kw)
    env.reset(seed=seed)
    gen = torch.Generator().manual_seed(seed)
    acts = [2 * torch.rand((B, env.action_dim), generator=gen) - 1
            for _ in range(steps + 1)]
    for a in acts[:-1]:
        env.step(a)
    got, solve = [], W.normal_newton

    def spy(*args):
        got.append(tuple(t.clone() for t in args))
        return solve(*args)

    W.normal_newton = spy
    try:
        env.step(acts[-1])
    finally:
        W.normal_newton = solve
    return got


def active_rows(args):
    """(steps, B) rows in the active set of each Newton step of the plain
    version on ``args`` (its ``_masked`` calls, two a step)."""
    seen, masked = [], W._masked

    def spy(Am, m):
        seen.append(m.sum(-1))
        return masked(Am, m)

    W._masked = spy
    try:
        W.normal_newton_reference(*args)
    finally:
        W._masked = masked
    return torch.stack(seen[::2])


def newton_flops(args):
    """The float32 operations of the normal stage on ``args``: per env
    and step of m active rows, the factorization m^3 / 3, three two-sweep
    solves 6 m^2, two refinement products 4 m^2 and the switch's product
    over every row 2 n m."""
    n = args[0].shape[-1]
    m = active_rows(args).double()
    return float((m ** 3 / 3 + 10 * m ** 2 + 2 * n * m).sum())


def lcp_residual(args, x):
    """Per env, how far ``x`` is from a solution of the normal stage's LCP
    on ``args`` = (An_raw, act_mask, rhs, x_init), in float64: the
    largest |min(x, w)| (w = An_raw x + rhs) over the rows of act_mask
    and |x| over the others, over the largest |An_raw| |x| + |rhs| on
    the mask's rows.  0 at a solution (x >= 0, w >= 0, x w = 0 on the
    mask, x = 0 off it); x = 0 reads max(-rhs) / max |rhs| on the mask."""
    An, m, r = args[0].double(), args[1], args[2].double()
    x = x.double()
    w = (An @ x[..., None])[..., 0] + r
    scale = torch.where(m, (An.abs() @ x.abs()[..., None])[..., 0]
                        + r.abs(), 0.0).amax(-1).clamp_min(1e-30)
    off = torch.maximum(torch.where(m, torch.minimum(x, w).abs(), 0.0),
                        torch.where(m, 0.0, x.abs()))
    return off.amax(-1) / scale


def newton_systems(args):
    """(name, inputs) of the systems ``newton_times`` runs at a shape,
    from the first substep's seeded inputs ``args``: those as they are;
    the same matrices with every row in the mask and pushing (rhs -|rhs|
    - 0.01, from 0), whose redundant rows 7 steps do not resolve (the
    plain version's residual 0.03-1 there, in float64 too); and at more
    than one env the same with An_raw + mean(diag An_raw) I, which 7
    steps solve in most envs (``lcp_residual`` ~1e-7), though float32
    rounding leaves a few in ~6% of envs unresolved (1e-5 to 4e-3)."""
    An, act_mask, rhs, x_init = args
    pushing = (torch.ones_like(act_mask), -rhs.abs() - 0.01,
               torch.zeros_like(x_init))
    out = [("seeded", args), ("all rows", (An,) + pushing)]
    if An.shape[0] > 1:
        d = torch.diagonal(An, dim1=-2, dim2=-1)
        shift = torch.diag_embed(d.mean(-1, keepdim=True).expand_as(d))
        out.append(("all rows, shifted", (An + shift,) + pushing))
    return out


def newton_times(shapes=tuple(NEWTON_SHAPES), seed=0):
    """The normal stage at each of ``shapes`` on the ``newton_systems`` of
    the first substep of ``seeded_systems``: the kernel's time a launch
    by the profiler (``ms``) and a wrapper call's by CUDA events
    (``call_ms``); the plain version's (the ``_Factor`` path) by CUDA
    events, eager (``library_ms``) and replayed from a CUDA graph
    (``library_graph_ms``, as the loops run it; None where the capture
    fails); the bound (``newton_flops`` at F32_FLOPS); the kernel's and
    the plain version's ``lcp_residual`` (max and median over envs); and
    the gaps of the kernel and the plain version to each other and to the
    plain version's float64 run on the CPU (per env max |x - x'| over
    max |x'|).  -> one dict per (shape, systems)."""
    out = []
    for name in shapes:
        env_id, B, kw = NEWTON_SHAPES[name]
        seeded = seeded_systems(env_id, B, seed, **kw)[0]
        for what, args in newton_systems(seeded):
            call_ms = event_ms(lambda: W.normal_newton(*args))
            kernel_ms = profiler_ms(lambda: W.normal_newton(*args),
                                    "normal_newton_kernel")
            if kernel_ms is None:
                kernel_ms = call_ms
            plain_ms = event_ms(lambda: W.normal_newton_reference(*args),
                                reps=5)
            try:
                plain_graph_ms = graph_ms(
                    lambda: W.normal_newton_reference(*args))[0]
            except Exception:   # the capture failed: reported as None
                torch.cuda.synchronize()
                plain_graph_ms = None
            x = W.normal_newton(*args).cpu()
            want = W.normal_newton_reference(*args).cpu()
            f64 = W.normal_newton_reference(*(
                t.cpu().double() if t.is_floating_point() else t.cpu()
                for t in args))
            cpu_args = tuple(t.cpu() for t in args)
            res, plain_res = (lcp_residual(cpu_args, v) for v in (x, want))
            scale = want.double().abs().amax(-1).clamp_min(1e-30)
            gaps = [float(((a.double() - b).abs().amax(-1) / scale).max())
                    for a, b in ((x, want.double()), (x, f64),
                                 (want, f64))]
            flops = newton_flops(args)
            bound_ms = 1e3 * flops / F32_FLOPS
            out.append(dict(
                shape=name, systems=what, B=B, n=args[0].shape[-1],
                active_rows=float(active_rows(args).double().mean()),
                ms=kernel_ms, call_ms=call_ms, library_ms=plain_ms,
                library_graph_ms=plain_graph_ms, bound_ms=bound_ms,
                share=bound_ms / kernel_ms, max_rel_err=gaps[0],
                f64_gap=gaps[1], plain_f64_gap=gaps[2],
                finite_nonneg=bool(torch.isfinite(x).all()
                                   and (x >= 0).all()),
                res_max=float(res.max()), res_median=float(res.median()),
                plain_res_max=float(plain_res.max()),
                plain_res_median=float(plain_res.median())))
    return out


def newton_line(r):
    graph = ("not capturable" if r["library_graph_ms"] is None
             else f"{r['library_graph_ms']:.4f} ms replayed from a graph "
                  f"({r['library_graph_ms'] / r['ms']:.1f}x)")
    return (f"normal_newton {r['shape']} ({r['B']}, {r['n']}), {r['systems']}"
            f" ({r['active_rows']:.1f} active rows an env and step): kernel "
            f"{r['ms']:.4f} ms a launch by the profiler ({r['call_ms']:.4f} "
            f"ms a wrapper call by CUDA events), plain version "
            f"{r['library_ms']:.4f} ms eager ({r['library_ms'] / r['ms']:.1f}"
            f"x), {graph}, f32 bound {r['bound_ms']:.5f} ms "
            f"({100 * r['share']:.2f}% of it); LCP residual max / median "
            f"over envs {r['res_max']:.3g} / {r['res_median']:.3g} (the "
            f"plain version's {r['plain_res_max']:.3g} / "
            f"{r['plain_res_median']:.3g}); per env max |x - x'| / max |x| "
            f"against the plain version {r['max_rel_err']:.3g}, against its "
            f"float64 run {r['f64_gap']:.3g} (the plain version's "
            f"{r['plain_f64_gap']:.3g})")


def profiler_ms(fn, name, k=10):
    """Mean device duration (ms) that torch.profiler gives the kernels
    named with ``name`` over ``k`` calls of ``fn``; None where it shows
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(k):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    n = sum(e.count for e in hits)
    return (sum(e.self_device_time_total for e in hits) / n / 1e3
            if n else None)


def graph_ms(fn):
    """``fn`` captured into a CUDA graph (after a warm-up call on a side
    stream) -> (ms a replay by ``event_ms``, what the capture returned
    after one replay).  Raises where the capture fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    g.replay()
    torch.cuda.synchronize()
    return event_ms(g.replay), out


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
                    default=list(ROUTINES) + ["newton"],
                    choices=list(ROUTINES) + ["newton"])
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
            if name == "newton":
                continue
            fn = functools.partial(newton_step, ROUTINES[name])
            x = fn(A, b)
            err = float((x.double() - ref).abs().max() / ref.abs().max())
            eager = event_ms(lambda: fn(A, b))
            try:
                ms, xg = graph_ms(lambda: fn(A, b))
                same = torch.equal(xg, x)
                graph = (f"graph replay {ms:.4f} ms, "
                         f"{'bit for bit' if same else 'NOT equal to'} eager")
            except Exception as e:   # report what refused the capture
                torch.cuda.synchronize()
                graph = f"not capturable ({type(e).__name__}: {e})"[:300]
            print(f"{name:12s} ({B}, {n}, {n}): 1 factorization + 3 solves "
                  f"eager {eager:.4f} ms, {graph}; max rel err vs f64 "
                  f"{err:.3g}", flush=True)
    if "newton" in args.routines:
        for r in newton_times(seed=args.seed):
            print(newton_line(r), flush=True)


if __name__ == "__main__":
    main()
