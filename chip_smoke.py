#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gsworld_tpu_torch) on one NVIDIA
GPU: builds the CUDA kernels from the sources in the checkout, holds each
kernel against its plain PyTorch version at the bench shapes, then drives
the GS render half of the AlignFr3 step (GSWorldRenderer.render) at the
bench configuration and reports its speed.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero before a result):
  1. device   nvidia-smi name and power limit; CUDA required; TF32 off
  2. build    nvcc build of gsworld_tpu_torch/csrc/*.cu (seconds)
  3. kernels  emit and compositor kernels vs their plain versions on the
              8 frames (4 envs x 2 cameras, 640x480) of the first render
              state, built by the render path itself, with CUDA-event times
              of both at that launch size
  4. slice    GSWorldRenderer, 4 envs x 2 cameras, 640x480, tile 32,
              D=64, E=393216, alpha cull on, ~222k Gaussians: 10 batched
              states; launch counts, ms per render step, frames/s,
              overflow, peak memory; a torch.profiler window; and a small
              render on the card held against the same render on the CPU
The second-to-last line is the kernels JSON, the last the device JSON.
Long outputs (profile, ptxas report) go to chiprun_out/.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

BENCH_RASTER = dict(width=640, height=480, tile=32, max_tiles_per_gaussian=64,
                    max_entries=393216, cull_alpha=True)
BENCH_SIZES = dict(n_background=120_000, n_per_link=6_000, n_per_object=6_000)
NUM_ENVS = 4
STEPS = 10
PASSES = 3              # timed render steps: PASSES x STEPS
SEED = 0
RGB_TOL = 1e-4          # kernel vs plain, f32 blend in another order
SEG_MISMATCH_MAX = 1e-3
CULL_BORDER = 1e-5      # entries this close to the cull threshold may flip


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=10):
    """Median CUDA-event time of ``fn`` in ms over ``reps`` runs (after
    one warm-up run)."""
    import torch
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


def phase_device():
    import torch
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = [f"nvidia-smi unavailable ({e})"]
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(smi[0] if smi else "nvidia-smi printed nothing")
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")


def phase_build():
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    t0 = time.perf_counter()
    rc.build_kernels()
    dt = time.perf_counter() - t0
    if rc.build_log():
        with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
            f.write(rc.build_log())
    log(f"phase 2 build: {dt:.2f} s (nvcc sm_90a, ptxas report in "
        f"chiprun_out/ptxas.txt)")


def make_renderer(device, num_envs, raster, sizes):
    from gsworld_tpu_torch.envs.tasks.tabletop.franka.align import (
        AlignFr3Env)
    from gsworld_tpu_torch.render.camera import RasterConfig
    from gsworld_tpu_torch.wrapper.gs_env import GSWorldRenderer
    env = AlignFr3Env(num_envs=num_envs, obs_mode="rgb+segmentation")
    env.cameras = [dataclasses.replace(c, width=raster["width"],
                                       height=raster["height"])
                   for c in env.cameras]
    return GSWorldRenderer(env, "fr3_align",
                           raster_config=RasterConfig(**raster),
                           synthetic_sizes=sizes, device=device)


def random_states(env, steps, device, seed=SEED):
    """``steps`` batched pose states: the task-init qpos plus a seeded
    walk inside the joint limits; cans and rack drawn in the AlignFr3
    episode-init ranges."""
    import math

    import torch
    from gsworld_tpu_torch import constants
    from gsworld_tpu_torch.core.maths import axis_angle_to_quat, quat_multiply
    from gsworld_tpu_torch.envs.base import EnvPoses
    gen = torch.Generator().manual_seed(seed)
    B = env.num_envs
    lim = torch.as_tensor(env.agent.model.qlimits)
    q = torch.as_tensor(constants.fr3_umi_task_init_qpos).repeat(B, 1)
    xo = env.x_offset
    aa = lambda *v: axis_angle_to_quat(torch.tensor(v))      # noqa: E731
    # cans upright (x +90 deg) then turned z +45 deg; rack z -90 deg
    can_q = quat_multiply(aa(0.0, 0.0, math.pi / 4), aa(math.pi / 2, 0, 0))
    rack_q = aa(0.0, 0.0, -math.pi / 2)
    states = []
    for _ in range(steps):
        q = q + 0.05 * torch.randn(q.shape, generator=gen)
        q = torch.minimum(torch.maximum(q, lim[:, 0]), lim[:, 1])
        u = torch.rand((B, 6), generator=gen)
        a_pos = torch.stack([
            torch.stack([xo - 0.2 + 0.05 * u[:, 0], 0.1 + 0.1 * u[:, 1],
                         torch.full((B,), env.green_half_height)], -1),
            torch.stack([xo - 0.25 + 0.2 * u[:, 2], 0.1 + 0.1 * u[:, 3],
                         torch.full((B,), env.red_half_height)], -1),
            torch.stack([xo - 0.25 + 0.2 * u[:, 4], -0.2 + 0.1 * u[:, 5],
                         torch.full((B,), env.goal_height)], -1),
        ], dim=1)
        a_quat = torch.stack([can_q, can_q, rack_q]).expand(B, 3, 4)
        states.append(EnvPoses(qpos=q.to(device), a_pos=a_pos.to(device),
                               a_quat=a_quat.contiguous().to(device)))
    return states


def phase_kernels(renderer, state):
    """Emit and compositor kernels vs plain versions on the frames of one
    render step (every env x camera), with the inputs the render path
    builds for them."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.render.binning import plan_emit, sort_entries
    from gsworld_tpu_torch.render.rasterize import project_frames

    cfg = renderer.raster_config
    T = cfg.num_tiles
    with torch.no_grad():
        posed, cams = renderer.frames(state)
        proj, lead = project_frames(posed, cams, cfg, renderer.scene.sh0,
                                    renderer.scene.shN)
        plan = plan_emit(proj, cfg)
    a = plan.args
    F = proj.depth.shape[0]

    keys_k, gid_k = rc.emit_entries(**a)
    keys_p, gid_p = rc.emit_entries_reference(**a)
    torch.cuda.synchronize()
    if not torch.equal(gid_k, gid_p):
        raise AssertionError("emit: Gaussian ids differ from the plain "
                             "version")
    diff = keys_k != keys_p
    n_flip = int(diff.sum())
    if n_flip:
        f, slot, score, _ = rc.emit_slots(
            a["order"], a["offs"], a["cnt"], a["rect"], a["mean2d"],
            a["conic"], a["opacity"], tile=cfg.tile)
        margin = torch.full_like(keys_k, 2 ** 40, dtype=torch.float32)
        margin.view(-1)[f * a["E"] + slot] = (score - rc.LOG_ALPHA_MIN).abs()
        worst = float(margin[diff].max())
        if worst >= CULL_BORDER:
            raise AssertionError(f"emit: {n_flip} keys differ, one "
                                 f"{worst:.3g} from the cull threshold")
    gaus_k, starts_k = sort_entries(keys_k, gid_k, T)
    gaus_p, starts_p = sort_entries(keys_p, gid_p, T)
    d_starts = int((starts_k.long() - starts_p.long()).abs().max())
    if n_flip == 0 and (d_starts or not torch.equal(gaus_k, gaus_p)):
        raise AssertionError("emit: starts or entry order differ")
    if d_starts > n_flip:
        raise AssertionError(f"emit: starts differ by {d_starts} with only "
                             f"{n_flip} borderline entries")
    log(f"phase 3 emit, {F} frames {tuple(lead)} (E={a['E']} each): live "
        f"entries {starts_k[:, T].tolist()}, kept {a['total'].tolist()}, "
        f"overflow {plan.overflow.tolist()}; {n_flip} borderline cull "
        f"flips, max |starts diff| {d_starts}")
    emit_ms = cuda_ms(lambda: rc.emit_entries(**a), reps=20)
    emit_plain_ms = cuda_ms(lambda: rc.emit_entries_reference(**a), reps=10)
    log(f"phase 3 emit time: kernel {emit_ms:.4f} ms, plain "
        f"{emit_plain_ms:.4f} ms")

    sem = renderer.scene.semantics
    comp_args = (starts_k, gaus_k, proj.mean2d, proj.conic, proj.opacity,
                 proj.color, sem)
    kw = dict(width=cfg.width, height=cfg.height, tile=cfg.tile, bg=cfg.bg)
    ik, tk, sk = rc.composite_tiles(*comp_args, **kw)
    ip, tp, sp = rc.composite_tiles_reference(*comp_args, **kw)
    torch.cuda.synchronize()
    rgb_f = (ik - ip).abs().amax(dim=(1, 2, 3))               # per frame
    t_f = (tk - tp).abs().amax(dim=(1, 2))
    rgb_err, t_err = float(rgb_f.max()), float(t_f.max())
    seg_mis = float((sk != sp).float().mean())
    if not (rgb_err <= RGB_TOL and t_err <= RGB_TOL
            and seg_mis <= SEG_MISMATCH_MAX):
        raise AssertionError(f"composite: rgb err {rgb_err:.3g}, T err "
                             f"{t_err:.3g}, seg mismatch {seg_mis:.4%}")
    log(f"phase 3 composite, {F} frames: max |rgb| err {rgb_err:.3g}, max |T| err "
        f"{t_err:.3g}, seg mismatch {seg_mis:.4%} (tolerance {RGB_TOL}, "
        f"{SEG_MISMATCH_MAX:.1%}); per frame |rgb| "
        f"{[float(f'{x:.3g}') for x in rgb_f.tolist()]}, |T| "
        f"{[float(f'{x:.3g}') for x in t_f.tolist()]}")
    comp_ms = cuda_ms(lambda: rc.composite_tiles(*comp_args, **kw), reps=20)
    comp_plain_ms = cuda_ms(
        lambda: rc.composite_tiles_reference(*comp_args, **kw), reps=10)
    log(f"phase 3 composite time: kernel {comp_ms:.4f} ms, plain "
        f"{comp_plain_ms:.4f} ms")
    return [
        dict(name="emit_entries", route="cuda",
             source="gsworld_tpu_torch/csrc/emit.cu",
             replaces="gsworld_tpu/render/rasterize_pallas.py:117",
             max_abs_err=float(d_starts), ms=emit_ms,
             plain_ms=emit_plain_ms),
        dict(name="composite_tiles", route="cuda",
             source="gsworld_tpu_torch/csrc/composite.cu",
             replaces="gsworld_tpu/render/rasterize_pallas.py:323",
             max_abs_err=max(rgb_err, t_err), ms=comp_ms,
             plain_ms=comp_plain_ms),
    ]


def check_outputs(out, B, H, W):
    import torch
    for cam, o in out.items():
        rgb, seg = o["rgb"], o["segmentation"]
        if rgb.shape != (B, H, W, 3) or rgb.dtype != torch.uint8:
            raise AssertionError(f"{cam}: rgb {tuple(rgb.shape)} {rgb.dtype}")
        if seg.shape != (B, H, W, 1) or seg.dtype != torch.int16:
            raise AssertionError(f"{cam}: seg {tuple(seg.shape)} {seg.dtype}")
        if float(rgb.float().std()) < 5.0:
            raise AssertionError(f"{cam}: image is (nearly) constant")
        if len(torch.unique(seg)) < 3:
            raise AssertionError(f"{cam}: segmentation has < 3 ids")


def phase_slice(renderer, states):
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    cfg = renderer.raster_config
    B, C = renderer.env.num_envs, len(renderer.env.cameras)
    for st in states[:2]:                                  # warm-up
        renderer.render(st)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rc.reset_launch_counts()
    step_ms = []
    for st in states * PASSES:
        t0 = time.perf_counter()
        out = renderer.render(st)
        torch.cuda.synchronize()
        step_ms.append(1000.0 * (time.perf_counter() - t0))
    counts = dict(rc.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"slice: kernel {name} was never launched")
    check_outputs(out, B, cfg.height, cfg.width)
    overflow = int(renderer.last_overflow.sum())
    ms = statistics.median(step_ms)
    line = (f"phase 4 slice: {renderer.scene.num_gaussians} Gaussians, {B} envs "
        f"x {C} cams {cfg.width}x{cfg.height}: {ms:.3f} ms per render step "
        f"(median of {len(step_ms)}; min {min(step_ms):.3f}, max "
        f"{max(step_ms):.3f}), {1000.0 * B * C / ms:.2f} frames/s, "
        f"overflow {overflow} entries in the last step, peak memory "
        f"{peak / 2**30:.3f} GiB, launches {counts}")
    log(line)
    return counts, line


def phase_profile(renderer, states):
    """torch.profiler over 3 render steps: device time per gsw.* stage and
    per kernel, and the device's busy share of the window (diagnostic;
    reports "not measured" instead of failing the run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for st in states[:3]:
                renderer.render(st)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        avg = prof.key_averages()
        kernels = sorted(
            ((e.self_device_time_total, e.count, e.key) for e in avg
             if e.device_type == DeviceType.CUDA
             and not e.key.startswith("gsw.")), reverse=True)
        # per gsw.* range: kernel time inside it (host-side row), its span
        # on the device timeline (device-side row), host time
        stages = {}
        for e in avg:
            if e.key.startswith("gsw."):
                st = stages.setdefault(e.key, [0.0, 0.0, 0.0])
                if e.device_type == DeviceType.CUDA:
                    st[1] = e.device_time_total
                else:
                    st[0], st[2] = e.device_time_total, e.cpu_time_total
        stages = [(k, *v) for k, v in stages.items()]
        busy = sum(k[0] for k in kernels)
        with open(os.path.join(OUT_DIR, "profile_render.txt"), "w") as f:
            f.write(f"wall {wall * 1e3:.3f} ms over 3 render steps "
                    f"(profiler on), kernel time {busy / 1e3:.3f} ms\n")
            for key, dev, span, cpu in stages:
                f.write(f"stage {key}: kernels {dev / 1e3:.3f} ms, device "
                        f"span {span / 1e3:.3f} ms, host {cpu / 1e3:.3f} "
                        f"ms\n")
            for t, n, k in kernels:
                f.write(f"{t / 1e3:12.3f} ms {n:6d}  {k}\n")
        if busy == 0:
            log("phase 4 profile: no device time in key_averages (not "
                "measured)")
            return
        log(f"phase 4 profile (3 steps, profiler on): wall "
            f"{wall * 1e3 / 3:.3f} ms/step, kernels {busy / 1e3 / 3:.3f} "
            f"ms/step, device busy {100 * busy / 1e3 / (wall * 1e3):.1f}%")
        for key, dev, span, cpu in stages:
            log(f"    stage {key:14s} kernels {dev / 1e3 / 3:8.3f}, device "
                f"span {span / 1e3 / 3:8.3f}, host {cpu / 1e3 / 3:8.3f} "
                f"ms/step")
        for t, n, k in kernels[:8]:
            log(f"    kernel {t / 1e3 / 3:8.3f} ms/step x{n // 3:<4d} "
                f"{k[:80]}")
    except Exception as e:  # diagnostic only: report, do not fail the run
        log(f"phase 4 profile: not measured ({type(e).__name__}: {e})")


def phase_small_agreement():
    """A small render on the card (kernels) against the same render on
    the CPU (plain versions)."""
    import numpy as np
    import torch
    raster = dict(BENCH_RASTER, width=160, height=120, max_entries=16384)
    sizes = {k: int(v * 0.02) for k, v in BENCH_SIZES.items()}
    outs = []
    for dev in ("cuda", "cpu"):
        r = make_renderer(dev, 2, raster, sizes)
        st = random_states(r.env, 1, dev, seed=SEED + 1)[0]
        outs.append(r.render(st))
    worst_psnr, worst_seg = np.inf, 1.0
    for cam in outs[0]:
        a = outs[0][cam]["rgb"].cpu().numpy().astype(np.float64)
        b = outs[1][cam]["rgb"].numpy().astype(np.float64)
        mse = np.mean((a - b) ** 2)
        worst_psnr = min(worst_psnr,
                         10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
        worst_seg = min(worst_seg, float(np.mean(
            outs[0][cam]["segmentation"].cpu().numpy()
            == outs[1][cam]["segmentation"].numpy())))
    if worst_psnr < 40.0 or worst_seg < 0.995:
        raise AssertionError(f"small render: card vs CPU PSNR "
                             f"{worst_psnr:.2f} dB, seg agreement "
                             f"{worst_seg:.4f}")
    log(f"phase 4 small render (2 envs x 2 cams 160x120): card vs CPU "
        f"PSNR {worst_psnr:.2f} dB (>= 40), seg agreement {worst_seg:.4%} "
        f"(>= 99.5%)")


def main():
    import torch
    os.makedirs(OUT_DIR, exist_ok=True)
    phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    t0 = time.perf_counter()
    renderer = make_renderer("cuda", NUM_ENVS, BENCH_RASTER, BENCH_SIZES)
    states = random_states(renderer.env, STEPS, "cuda")
    log(f"setup: scene of {renderer.scene.num_gaussians} Gaussians and "
        f"{STEPS} states in {time.perf_counter() - t0:.2f} s")
    kernels = phase_kernels(renderer, states[0])
    counts, slice_line = phase_slice(renderer, states)
    phase_profile(renderer, states)
    phase_small_agreement()
    for k in kernels:
        k["launches"] = counts[k["name"]]
    log(slice_line)          # repeated here so the end of the log holds it
    line = json.dumps({"kernels": kernels})
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
        f.write(line + "\n")
    log(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)
        sys.exit(1)
