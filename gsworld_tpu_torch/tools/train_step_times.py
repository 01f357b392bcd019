"""Per-iteration times of the 3DGS train step on one GPU, split into the
host's part and the wait for the device, over the training run of
``chip_smoke.py`` phase 5 (its scene, views, schedule and seed).

    python3 gsworld_tpu_torch/tools/train_step_times.py [--root DIR] [--runs N]

``--root`` takes the package and ``chip_smoke.py`` of another checkout of
the repository (for example an earlier commit unpacked with ``git
archive``), so that two trees can be timed in turns on one card.  Per run
it prints, over the iterations that did not densify (after 5 warm-up
iterations), the 10th, 50th and 90th percentiles of

  * the step: from one iteration's end to the next, loss read included;
  * its host part: from the start of the step function until it returns,
    every launch queued (or, on a tree whose ``train`` replays a CUDA
    graph of the step, the replay queued) and nothing waited for;
  * the rest: mostly the loss read, which waits for the device to finish
    the step;

and a histogram of the step times in 2 ms bins.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def percentiles(xs):
    xs = sorted(xs)
    return "/".join(f"{xs[int(p * (len(xs) - 1))]:.2f}" for p in (0.1, 0.5, 0.9))


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
    from gsworld_tpu_torch.real2sim.pipeline import train_from_colmap_model
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.train3dgs import train as train_mod

    cs.phase_device()
    rc.build_kernels()
    renderer = cs.make_renderer("cuda", cs.NUM_ENVS, cs.BENCH_RASTER,
                                cs.BENCH_SIZES)
    setup = cs.TrainSetup(renderer.scene, cs.TRAIN_RASTER, "cuda")
    cams, images = setup.split()

    host = []
    make_step = train_mod.make_train_step

    def timed_make_step(cfg, params, **kw):
        step = make_step(cfg, params, **kw)

        def timed_step(*a):
            t0 = time.perf_counter()
            out = step(*a)
            host.append(1e3 * (time.perf_counter() - t0))
            return out
        return timed_step

    train_mod.make_train_step = timed_make_step
    for run in range(args.runs):
        host.clear()
        steps, clock = [], [0.0]

        def on_step(it, state, loss, densified):
            now = time.perf_counter()
            steps.append((1e3 * (now - clock[0]), densified))
            clock[0] = now

        torch.cuda.synchronize()
        clock[0] = time.perf_counter()
        train_from_colmap_model(
            setup.points, setup.colors, cams, images, setup.cfg,
            params=cs.train_params(), iterations=cs.TRAIN_ITERS,
            capacity=setup.capacity, seed=cs.SEED, device="cuda",
            callback=on_step)
        keep = [i for i, (_, d) in enumerate(steps) if i >= 5 and not d]
        total = [steps[i][0] for i in keep]
        hist = {}
        for t in total:
            b = 2 * int(t // 2)
            hist[b] = hist.get(b, 0) + 1
        print(f"{os.path.basename(root)} run {run}: {len(keep)} steps, ms "
              f"p10/p50/p90: step {percentiles(total)}, host part "
              f"{percentiles([host[i] for i in keep])}, rest "
              f"{percentiles([steps[i][0] - host[i] for i in keep])}; "
              f"step histogram (2 ms bins) {dict(sorted(hist.items()))}",
              flush=True)


if __name__ == "__main__":
    main()
