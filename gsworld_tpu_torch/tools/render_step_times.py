"""Per-step times of the render step of ``chip_smoke.py`` phase 4 on one
GPU (its renderer, scene, raster configuration and pose states), split
into the host's part and the wait for the device.

    python3 gsworld_tpu_torch/tools/render_step_times.py [--root DIR] [--runs N]

``--root`` takes the package and ``chip_smoke.py`` of another checkout of
the repository (for example an earlier commit unpacked with ``git
archive``), so that two trees can be timed in turns on one card.  Per run
(two warm-up steps, then every state ``PASSES`` times) it prints the
10th, 50th and 90th percentiles of

  * the step: ``renderer.render`` of one state and a synchronize;
  * its host part: until ``render`` returns, every launch queued;
  * the rest: the wait for the device to finish the step;

the garbage collector's full collections in the timed steps, and, from a
profiler window of three more steps, the operator calls and kernel
launches the host made per step (the same counts say the two trees do
the same work).  That window's operators by self CPU time go to
``chiprun_out/render_ops_<checkout>_<run>.txt``.
"""

import argparse
import gc
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def percentiles(xs):
    xs = sorted(xs)
    return "/".join(f"{xs[int(p * (len(xs) - 1))]:.3f}" for p in (0.1, 0.5, 0.9))


def host_work(renderer, states, table_path):
    """(operator calls, kernel launch calls) per render step, from the
    host's side of a profiler window; its operators by self CPU time are
    written to ``table_path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for st in states:
            renderer.render(st)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    with open(table_path, "w") as f:
        f.write(ev.table(sort_by="self_cpu_time_total", row_limit=40))
    ops = sum(e.count for e in ev if e.key.startswith("aten::"))
    launches = sum(e.count for e in ev if "LaunchKernel" in e.key
                   or e.key == "cuLaunchKernel")
    return ops / len(states), launches / len(states)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose package and chip_smoke.py to time")
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc

    cs.phase_device()
    rc.build_kernels()
    renderer = cs.make_renderer("cuda", cs.NUM_ENVS, cs.BENCH_RASTER,
                                cs.BENCH_SIZES)
    # the eager render, whose host part this splits (a replay has none)
    renderer.env.graph = False
    states = cs.random_states(renderer.env, cs.STEPS, "cuda")
    name = os.path.basename(root)
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    for run in range(args.runs):
        for st in states[:2]:
            renderer.render(st)
        torch.cuda.synchronize()
        step, host = [], []
        full = gc.get_stats()[2]["collections"]
        for st in states * cs.PASSES:
            t0 = time.perf_counter()
            renderer.render(st)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            step.append(1e3 * (t2 - t0))
            host.append(1e3 * (t1 - t0))
        full = gc.get_stats()[2]["collections"] - full
        ops, launches = host_work(renderer, states[:3], os.path.join(
            out, f"render_ops_{name}_{run}.txt"))
        print(f"{name} run {run}: {len(step)} render "
              f"steps, ms p10/p50/p90: step {percentiles(step)}, host part "
              f"{percentiles(host)}, rest "
              f"{percentiles([s - h for s, h in zip(step, host)])}; "
              f"{full} full collections; per step {ops:.0f} operator calls, "
              f"{launches:.0f} kernel launches", flush=True)


if __name__ == "__main__":
    main()
