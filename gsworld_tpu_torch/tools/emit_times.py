"""The emit kernel of one checkout on one GPU: what its inputs look like,
its time by three clocks, the bin stage's kernel time split into its
parts, and a digest of the binning's outputs, at the three shapes of
``chip_smoke.py`` (the 8 frames of a render step of 4 envs; the 128 of
one of 64 envs, the e64 cell's; one 640x480 frame of the training scene
at its capacity).

    python3 gsworld_tpu_torch/tools/emit_times.py [--root DIR]

``--root`` takes the package of another checkout of the repository (for
example an earlier commit unpacked with ``git archive``), so that two
trees can be timed in turns on one card and their digests compared; the
inputs, the clocks and the digest are this checkout's ``chip_smoke.py``
for both.  Per shape it prints

  * the emitting Gaussians per frame, the histogram of their entry counts
    (1, 2-4, 5-16, 17-63, 64 and more), kept and unused slots;
  * the emit kernel's time by the back-to-back clock (launches queued one
    behind the other into outputs allocated before, nothing else between
    two events), by the profiler's device duration of the kernel, and by
    one wrapper call between two events, with its bound;
  * the kernel time of ``bin_entries_fused`` per call, split into depth
    sort, plan operations, emit, key sort (``torch.sort`` of 64-bit keys
    or ``sort_tiles``, whichever the checkout calls), ``searchsorted`` and
    the rest, from a torch.profiler window;
  * the SHA-256 of ``gaussian[:, :starts[:, T]]``, ``starts`` and
    ``overflow``.
The bin stage's kernels, by name, go to ``chiprun_out/bin_kernels_*.txt``.

``--stamps`` also builds csrc/emit.cu with ``-DGSW_EMIT_STAMPS``, in which
every block writes the device's nanosecond timer at its phase boundaries,
and prints where a block's life goes: finding its range of Gaussians,
staging the owners, computing the keys, storing (this checkout only).
"""

import argparse
import ctypes
import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KERNEL_NAME = "emit_kernel"
HIST_EDGES = ((1, 1), (2, 4), (5, 16), (17, 63), (64, 1 << 30))
BLOCK_SLOTS = 128       # kBlockSlots of csrc/emit.cu
STAMPS = 5              # kStamps there


def load_smoke():
    """This checkout's chip_smoke.py, whatever ``sys.path`` holds."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_counts(a):
    """Kept entries per Gaussian (F, N), in slot order, from the emit
    arguments ``a`` of any layout: counts per depth rank, or inclusive
    ends per depth rank or per Gaussian."""
    import torch
    if "cnt" in a:
        return a["cnt"].long()
    ends = a["ends"].long()
    return torch.diff(ends, dim=-1, prepend=torch.zeros_like(ends[:, :1]))


def raw_launcher(rc, a):
    """-> ``launch()`` that only queues the emit kernel, into outputs
    allocated here."""
    import torch
    if hasattr(rc, "emit_entries_launcher"):
        return rc.emit_entries_launcher(**a)[0]
    # the thread-per-Gaussian form's C entry (slots in depth-rank order)
    lib = rc.build_kernels()
    F, N = a["order"].shape
    keys = torch.empty((F, a["E"]), dtype=torch.int64, device="cuda")
    gid = torch.empty((F, a["E"]), dtype=torch.int32, device="cuda")
    ptrs = [a[k].data_ptr() for k in ("order", "offs", "cnt", "total", "rect",
                                      "mean2d", "conic", "opacity", "depth")]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        lib.gsw_emit_entries(*ptrs, keys.data_ptr(), gid.data_ptr(), F, N,
                             a["E"], a["gx"], a["T"], a["tile"],
                             int(a["cull_alpha"]), rc.LOG_ALPHA_MIN, stream)
    launch.keep = (keys, gid)
    return launch


def bin_split(proj, cfg, calls=10):
    """Kernel time (ms per call) of bin_entries_fused by part, from a
    profiler window over ``calls`` calls with the two sorts and the
    searchsorted wrapped in ranges: the first ``torch.sort`` of a call is
    the depth sort, the key sort is its second or ``sort_tiles``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from gsworld_tpu_torch.render import binning

    real_sort, real_search = torch.sort, torch.searchsorted
    real_tiles = getattr(binning, "sort_tiles", None)
    n_sort = [0]

    def sort(*args, **kw):
        n_sort[0] += 1
        with record_function("emt.depth_sort" if n_sort[0] == 1
                             else "emt.key_sort"):
            return real_sort(*args, **kw)

    def sort_tiles(*args, **kw):
        with record_function("emt.key_sort"):
            return real_tiles(*args, **kw)

    def searchsorted(*args, **kw):
        with record_function("emt.searchsorted"):
            return real_search(*args, **kw)

    binning.bin_entries_fused(proj, cfg)
    torch.cuda.synchronize()
    torch.sort, torch.searchsorted = sort, searchsorted
    if real_tiles is not None:
        binning.sort_tiles = sort_tiles
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                n_sort[0] = 0
                with record_function("emt.bin"):
                    binning.bin_entries_fused(proj, cfg)
            torch.cuda.synchronize()
    finally:
        torch.sort, torch.searchsorted = real_sort, real_search
        if real_tiles is not None:
            binning.sort_tiles = real_tiles
    avg = prof.key_averages()
    rng = {e.key: e.device_time_total / calls / 1e3 for e in avg
           if e.key.startswith("emt.") and e.device_type != DeviceType.CUDA}
    kern = [(e.key, e.self_device_time_total / calls / 1e3, e.count // calls)
            for e in avg if e.device_type == DeviceType.CUDA
            and not e.key.startswith("emt.")]
    emit = sum(t for k, t, _ in kern if KERNEL_NAME in k)
    parts = {"depth sort": rng.get("emt.depth_sort", 0.0),
             "key sort": rng.get("emt.key_sort", 0.0),
             "searchsorted": rng.get("emt.searchsorted", 0.0), "emit": emit}
    total = rng.get("emt.bin", 0.0)
    parts["plan ops, gather of ids and the rest"] = total - sum(parts.values())
    launches = sum(n for _, _, n in kern)
    return total, parts, launches, sorted(kern, key=lambda k: -k[1])


def block_phases(rc, a, tag):
    """Per-block phase times of one launch of the instrumented build."""
    import numpy as np
    import torch
    from gsworld_tpu_torch.utils import kernels
    lib = ctypes.CDLL(str(kernels.compile_library(
        [kernels.CSRC_DIR / "emit.cu"], defines=("GSW_EMIT_STAMPS",))))
    kernels.bind_emit(lib)
    lib.gsw_emit_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    launch = rc.emit_entries_launcher(**a, lib=lib)[0]
    launch()
    torch.cuda.synchronize()
    launch()
    torch.cuda.synchronize()
    blocks = a["ends"].shape[0] * -(-a["E"] // BLOCK_SLOTS)
    t = np.zeros((blocks, STAMPS), np.uint64)
    rc_ = lib.gsw_emit_stamps(t.ctypes.data, blocks)
    if rc_:
        raise RuntimeError(f"gsw_emit_stamps: {rc_}")
    t = (t.astype(np.int64) - int(t[:, 0].min())) / 1e3      # us

    def pct(x):
        return "/".join(f"{np.percentile(x, q):.2f}" for q in (50, 90, 100))

    names = ("range search", "staging", "keys", "stores")
    print(f"{tag} blocks ({blocks} of {BLOCK_SLOTS} slots, instrumented "
          f"build): first start to last end {t[:, 4].max():.1f} us; a block "
          f"starts at p50/p90/max {pct(t[:, 0])} us and lives "
          f"{pct(t[:, 4] - t[:, 0])} us: "
          + ", ".join(f"{n} {pct(t[:, k + 1] - t[:, k])}"
                      for k, n in enumerate(names)), flush=True)


def report(cs, tag, proj, cfg, stamps=False):
    import torch
    from gsworld_tpu_torch.render import binning
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    with torch.no_grad():
        a = binning.plan_emit(proj, cfg).args
        bins = binning.bin_entries_fused(proj, cfg)
    cnt = entry_counts(a)
    F, N = cnt.shape
    kept = cnt.sum(-1)
    hist = {f"{lo}-{hi}" if hi < 1 << 30 else f"{lo}+":
            int(((cnt >= lo) & (cnt <= hi)).sum()) for lo, hi in HIST_EDGES}
    print(f"{tag} inputs: F={F}, N={N}, E={a['E']}; emitting Gaussians per "
          f"frame {(cnt > 0).sum(-1).tolist()}; entries per emitting Gaussian "
          f"{hist}; kept slots {kept.tolist()}, unused "
          f"{(a['E'] - kept).tolist()}; live entries after the cull "
          f"{bins.starts[:, cfg.num_tiles].tolist()}; overflow "
          f"{bins.overflow.tolist()}", flush=True)
    launch = raw_launcher(rc, a)
    burst = cs.burst_ms(launch)
    prof = cs.profiler_kernel_ms(launch, KERNEL_NAME)
    call = cs.cuda_ms(lambda: rc.emit_entries(**a), reps=20)
    bound = cs.emit_bound(cnt, a["E"])[0]
    print(f"{tag} emit: back to back {burst:.4f} ms, profiler "
          f"{'not measured' if prof is None else f'{prof:.4f} ms'}, one "
          f"wrapper call between events {call:.4f} ms; bound {bound:.4f} ms "
          f"(bytes), share of bound {100 * bound / burst:.1f}% back to back",
          flush=True)
    with torch.no_grad():
        total, parts, launches, kern = bin_split(proj, cfg)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "bin_kernels_"
                           + tag.replace(" ", "_") + ".txt"), "w") as f:
        for key, ms, n in kern:
            f.write(f"{ms:10.4f} ms x{n:<3d} {key}\n")
    print(f"{tag} bin stage: {total:.4f} ms of kernels per call in "
          f"{launches} launches: "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()), flush=True)
    print(f"{tag} digest "
          f"{cs.binning_digest(bins.gaussian, bins.starts, bins.overflow)}",
          flush=True)
    if stamps:
        block_phases(rc, a, tag)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose package to time")
    ap.add_argument("--stamps", action="store_true",
                    help="also print per-block phase times from a build "
                         "with -DGSW_EMIT_STAMPS (this checkout's kernel)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = load_smoke()
    from gsworld_tpu_torch.render import rasterize_cuda as rc

    name = os.path.basename(root)
    cs.phase_device()
    rc.build_kernels()
    renderer = cs.make_renderer("cuda", cs.NUM_ENVS, cs.BENCH_RASTER,
                                cs.BENCH_SIZES)
    state = cs.random_states(renderer.env, 1, "cuda")[0]
    proj, _ = cs.render_inputs(renderer, state)
    report(cs, f"{name} render step", proj, renderer.raster_config,
           args.stamps)
    e64 = cs.make_renderer("cuda", cs.PROJECT_ENVS, cs.BENCH_RASTER,
                           cs.BENCH_SIZES)
    proj64, _ = cs.render_inputs(e64, cs.random_states(e64.env, 1, "cuda")[0])
    report(cs, f"{name} e64 render step", proj64, e64.raster_config,
           args.stamps)
    del e64, proj64
    setup = cs.TrainSetup(renderer.scene, cs.TRAIN_RASTER, "cuda")
    report(cs, f"{name} train frame", cs.train_inputs(setup)[0], setup.cfg,
           args.stamps)


if __name__ == "__main__":
    main()
