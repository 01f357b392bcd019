#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gsworld_tpu_torch) on one NVIDIA
GPU: builds the CUDA kernels from the sources in the checkout, holds each
kernel against its plain PyTorch version at the shapes of its path, then
drives the GS render half of the AlignFr3 step (GSWorldRenderer.render),
3DGS training (real2sim.pipeline.train_from_colmap_model), the physics
step of AlignFr3Env-v1 and the closed loop (rollout.random_actions) at
full size, then the end-effector control modes, the other six tasks, the
xArm closed loop with domain randomization, the closed loop on merged
real-scan PLYs, the real2sim toolchain, scripted demo collection
(rollout.run_with_gs), the env axis split into shards (dist) and the
bench raster's fidelity against its uncapped render, and reports their
speed.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero before a result):
  1. device   nvidia-smi name and power limit; CUDA required; TF32 off
  2. build    nvcc build of gsworld_tpu_torch/csrc/*.cu (seconds)
  3. kernels  emit and compositor kernels vs their plain versions on the
              8 frames (4 envs x 2 cameras, 640x480) of the first render
              state, built by the render path itself, with CUDA-event times
              of both at that launch size; pixels whose transmittance stop
              flips between the two versions are counted and excused.  The
              emit kernel's bound is tens of microseconds, so it is timed
              by launches queued back to back between two events and by
              the profiler's device duration, beside one wrapper call and
              beside the same kernel on slots in Gaussian order; the key
              sort (csrc/sort_tiles.cu) bit for bit torch.sort of its
              32-bit keys, and the sorted ids and starts bit for bit the
              64-bit key sort the port had (SHA-256 of both), its time by
              the profiler beside its bound and torch.sort of the 64-bit
              keys; the preprocess kernel (csrc/project.cu: repose,
              projection, SH colour) vs its plain version on the 128
              frames of one render step of 64 envs x 2 cameras (radius and
              rect equal on 99.99% of pairs, depth's inf pattern equal, the
              floats within 1e-6 relative, colour 1e-5), timed by CUDA events
              and the profiler beside the plain path and its bound, then
              the emit kernel and the key sort on those 128 frames, as on
              the 8
  3b. bwd     the compositor backward kernel and the emit kernel vs their
              plain versions on one 640x480 frame of the phase-5 training
              scene at its capacity, inputs from the training path's
              projection and binning, and the key sort as in phase 3;
              the backward twice on one input, bit for bit; the
              per-Gaussian sum in slot order
              (csrc/entry_rows.cu) vs its plain version bit for bit, with
              the times of both and of index_add_, the library call it
              replaced
  4. slice    GSWorldRenderer, 4 envs x 2 cameras, 640x480, tile 32,
              D=64, E=393216, alpha cull on, ~222k Gaussians: 10 batched
              states rendered eagerly (the env's graph=False) and through
              the renderer's CUDA graph (one replay per render step), 3
              passes each in one call; launch counts (the eager renders
              and the capture), ms per render step, frames/s, overflow,
              peak memory allocated and reserved of each form; every
              state's rgb, segmentation and overflow of the graph bit for
              bit the eager render's; one preprocess, emit and compositor
              kernel per replay by the profiler; a torch.profiler window of the
              eager render; and a small render on the card held against
              the same render on the CPU
  5. train    train_from_colmap_model at 640x480 (tile 32, D=64, E=2^19):
              the ~222k-Gaussian fr3_align scene rendered from 9 look-at
              cameras on a 120-degree arc is the truth, the middle view is
              held out; the scene is rebuilt from its noisy means and
              colours for 300 iterations (densify at 100, 200, 300, capacity
              2N), through the train step's CUDA graph (one replay per
              iteration) and eagerly (graph=False), 2 runs of each,
              alternated: host launch counts (the graph's: its warm-up
              steps and capture), ms per step, losses, alive counts, peak
              memory; all four runs, graph and eager, give the same
              losses, held-out PSNR and returned scene bit for bit; one eager
              train step and densify pass under
              torch.use_deterministic_algorithms(True, warn_only=True) and
              utils.determinism's op audit name no op that is not
              deterministic on the card; one train step eagerly twice and
              through the graph from one state, bit for bit in every
              field, its loss and image unchanged by the next replay; in
              the graph run, one call of the graph per iteration, one call
              of the densify graph per densify pass and, by the profiler
              over the 3 replays after the first densify, one emit,
              compositor, backward and entry-rows kernel per replay; one
              densify pass through its graph vs eager from one state with
              the same split noise, bit for bit
  5b. step    one training step of a ~2k-Gaussian scene at 160x120 on the
              card against the same step on the CPU
  6n. newton  the contact solver's normal Newton kernel
              (csrc/contact_newton.cu, world.normal_newton) vs its plain
              version on the systems of seeded steps at e64's (64 envs x
              180 rows), dr64's (64 x 108) and e1's (1 x 180) shapes, and
              on the same matrices with every row active, as they are
              and shifted by their mean diagonal: the seeded systems at 64
              envs bit for bit, at one env and the shifted ones an LCP
              residual within NEWTON_RES_RATIO of the plain version's;
              the kernel's time a launch by the profiler beside the plain
              version's (the _Factor path) by CUDA events, eager and from
              a CUDA graph, and the float32 bound of the work, and both
              sides' gaps to a float64 run (tools/solve_times.py)
  6a. physics AlignFr3Env-v1 (obs_mode state_dict) at 1, 4 and 64 envs:
              reset(seed), env.step calls of random actions, 10 eager
              (graph=False) and 30 through the CUDA graph of the whole
              step:
              ms per step, env-steps/s, kernels per step, peak memory;
              torch.profiler windows; 10 graph steps against 10 eager
              steps, every tensor each step returns and every state field
              bit for bit, step k's outputs unchanged after step k + 1;
              one control step on the card against the same step on the
              CPU
  6b. sanity  40 zero-action steps on the card: both cans rest, the arm
              holds its init pose, no pair force, nothing non-finite
  6c. loop    rollout.random_actions.build + rollout_fps: the closed loop
              (physics step, then the GS render of the new state) at 4
              envs x 2 cameras 640x480 for 30 steps, at 1 env, and at 64
              envs for 3 steps, eager (graph=False, at most 10 steps: one
              emit and one compositor launch per step) and through the
              wrapper's CUDA
              graph (one replay per step; one emit and one compositor
              kernel per replay by the profiler); the eager step split
              into physics and render by CUDA events; the frames follow a
              moved can; at 4 envs 10 steps through the graph against 10
              graph=False steps from one reset(seed), interleaved, every
              tensor each step returns and the state bit for bit, step
              k's outputs unchanged after step k + 1.  Then
              the scanned loop on the same wrappers (rollout_fps(use_scan=
              True): the wrapper's whole step captured as one CUDA graph,
              one replay per step, best of 3 reps): ms per step beside the
              eager loop's, peak memory, the launches of the capture, and
              by the profiler over 3 scanned steps exactly one emit and one
              compositor kernel per replay and no copy to the host (their
              frames bit for bit the same steps run eagerly); at 4
              envs 10 scanned steps against 10 eager steps from one
              reset(seed) with the same actions, every env's and camera's
              rgb and segmentation, every WorldState field, prev_target and
              the task state bit for bit, and emit and compositor vs plain
              on a graph step's frames; at 4 envs reset (4 seeds),
              render_current_step and render() (after steps 5-8) through
              the wrapper's graphs vs graph=False, interleaved: every
              observation leaf, the overflow and the reset state bit for
              bit, call k's outputs unchanged after call k + 1, ms per
              call of each form, one preprocess, emit and compositor kernel per
              reset and render replay by the profiler; at 64 envs the
              memory reserved with the step, reset and render graphs
              captured, in one shared pool and in a pool each
  6d. more    AlignFr3Env-v1 at 4 envs in pd_ee_delta_pos and
              pd_ee_delta_pose (IK inside the captured step): eager and
              graph steps, graph vs eager bit for bit (WorldState and
              prev_target), one step card vs CPU; every other task at 4
              envs: reset(seed) card == CPU bit for bit, 3 steps card vs
              CPU, flags and task state; the pd_ee_delta_pose closed loop
              through the wrapper's graph vs graph=False as 6c's;
              AlignXArmEnv-v1 with domain
              randomization through rollout.random_actions at 4 envs x 2
              cameras 640x480 (the xarm6_align scene at the bench sizes),
              eager and through the graph as 6c's, and its scanned loop
              as 6c's (tint and camera noise inside the
              graph; scanned vs eager bit for bit); its reset and renders
              through the graphs vs graph=False as 6c's; both kernels vs
              plain on the 8 tinted frames of a scanned step; the tint
              moves only pixels the objects reach
  7a. scans   the fr3_align synthetic scene written as the PLYs (and the
              labels .npy) that configs/fr3_align.json names, under a
              temporary directory; merge_scene_from_config equals the
              synthetic scene field by field; GSWorldWrapper(...,
              asset_dir=...) merges them (is_real_scene) and its AlignFr3
              loop, 4 envs x 2 cameras 640x480, gives the synthetic loop's
              frames bit for bit over 30 steps; one emit and one
              compositor launch per step; both kernels vs plain on its 8
              frames; seconds to write and merge the PLYs
  7b. real2sim the robot and background of fr3_align rendered from phase
              5's arc; a COLMAP text model of them in SfM units (the world
              x SFM_UNITS); ArucoScaleFactor on a virtual 10 cm marker's
              corner tracks (scale within 1e-6); cameras_from_colmap of
              the read-back model (world_view within 1e-5);
              train_from_colmap_model at 640x480 for 300 iterations (one
              composite_bwd launch each); the PLY read back bit for bit;
              sample_robot_pcd, Umeyama on hand-picked link origins and
              ICP on the clouds; segment_real_gs; the AlignFr3 loop on the
              labelled scan and 7a's objects (4 envs x 2 cameras 640x480,
              30 steps): finite frames, link ids, frames that follow the
              arm; held-out PSNR, sim2gs error, label shares, seconds per
              stage
  8a. demos   run_with_gs.collect of one episode (seed 0) of each of the
              seven tasks' scripted solutions, 1 env x 2 cameras 640x480,
              the full synthetic scene, sim 100 / control 20, recorded to
              HDF5 (an in-memory stand-in where h5py is missing) and
              video: plan ok or failed, success, steps, seconds, ms per
              control step (through the wrapper's graph), the IK's ms per
              waypoint, overflow, host launches (the resets and the
              capture), one preprocess, emit and compositor kernel per replayed
              step by the profiler, 10 more steps through the graph vs
              graph=False bit for bit with ms per step of both; the
              success table
  8b. replay  AlignFr3's and AlignXArm's recorded episodes replayed by
              replay_h5 through the same wrappers (one render-graph call
              per frame): the recorded frames bit for bit; both
              kernels vs plain on a replayed state's frames;
              AlignFr3's first screw move (dry run) and its first 10
              steps, card against CPU
  8c. rrt     move_to_pose_with_RRTConnect around the spice rack placed on
              the straight joint line (every path configuration free),
              every batch the RRT run checked through the checker's graphs
              (one per batch size) bit for bit the eager checker's; the
              checker's configurations per ms through its graph and
              eagerly; an env state checkpoint
              round trip and GSWorldWrapper(log_state=True)'s bundles
  9a. shard   rollout_fps(shard=True) over env_mesh() (every visible card)
              at 4 envs x 2 cameras 640x480 for 30 steps, each shard
              stepping through its wrapper's graph (no host launch after
              the capture; one preprocess, emit and compositor kernel per shard
              and step by the profiler); the loop split into 2
              shards on one card (dist.sharded.ShardedLoop over
              ["cuda:0", "cuda:0"]), and over every card where more than
              one is visible, against the unsharded loop from the
              same reset(seed) (each shard through its reset graph) and
              actions: the reset's and step 1's frames (max |diff|
              <= 1 count, segmentation >= 99.9% equal; the first field that
              differs, if any), every WorldState field within 1e-5 after
              10 steps, mean_across_envs of the reward within 1e-6 of the
              unsharded mean, ms per step of both; init_distributed (NCCL,
              world size 1, a file store under OUT_DIR) and its all_reduce
              mean against the local mean.  The scanned split:
              rollout_fps(shard=True, use_scan=True), and on each split
              above ShardedLoop.scan_steps against the unsharded
              scan_steps over 10 steps (the same gates), ms per step
  9b. fidelity tools/render_parity.py on phase 4's 10 render states: the
              bench raster against the render with D = the tile count and
              E doubled from 2^19 until nothing drops, per camera uint8
              PSNR (min, median), max |diff|, segmentation agreement, the
              entries the bench render dropped and those its D cap shrank;
              emit and compositor vs plain on env 0's 2 frames of the
              first state at the lifted shape (phase 3's gates)
The lines before the JSON lines repeat the train, render-step, physics,
closed-loop, EE-mode, xArm-loop, scan-loop, real2sim, demo, shard and
fidelity lines; the
second-to-last line is the kernels JSON, the last the device JSON.  Long
outputs (profile, ptxas report) go to OUT_DIR, the git-ignored output
directory of the checkout.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

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
T_EPS = 1e-4            # the compositors' transmittance stop threshold
STOP_HAIR = 1e-6        # |T - T_EPS| of a pixel that may stop one entry apart
FLIP_MIN_DT = 1e-7      # below the least T change of a stop flip (T_EPS/255)
# backward kernel vs plain, relative to each field's max: the per-entry
# sums run in another order (warp shuffles and per-warp partials against
# chunked cumulative sums), as the JAX package's bar for its own kernel
# (tests/test_pallas_backward.py)
BWD_TOL = 1e-3
TRAIN_RASTER = dict(width=640, height=480)   # RasterConfig defaults otherwise
TRAIN_ITERS = 300
TRAIN_VIEWS = 9
TRAIN_ARC_DEG = 120.0
STEP_TOL = 1e-4         # one train step, card vs CPU, relative to field max
TRAIN_REPEATS = 2       # phase 5's runs of each form, bit for bit alike
TRAIN_PROFILE_STEPS = 3  # phase 5's graph replays in the profiler's window
# the key sort's kernels are CUB's (csrc/sort_tiles.cu), in a namespace of
# their own; its digit histogram runs once a call
SORT_NAMESPACE = "gsw::cub::"
# each wrapper's CUDA kernel, by the name the profiler shows
KERNEL_NAMES = {"emit_entries": "emit_kernel",
                "sort_tiles": SORT_NAMESPACE
                + "DeviceRadixSortHistogramKernel",
                "composite_tiles": "composite_kernel",
                "composite_bwd": "composite_bwd_kernel",
                "sum_entry_rows": "entry_rows_kernel",
                "project_posed": "project_posed_kernel",
                "normal_newton": "normal_newton_kernel"}
TRAIN_KERNELS = ("composite_bwd", "sum_entry_rows")  # the train path's own
# the render path's (one launch per render); training projects through
# PyTorch (render/project.py:project_frames), so it launches no preprocess
RENDER_KERNELS = ("emit_entries", "sort_tiles", "composite_tiles",
                  "project_posed")
RENDER_ONLY_KERNELS = ("project_posed",)
PHYSICS_KERNELS = ("normal_newton",)   # the env step's own
# kernels per replay (by the kernels' names) of a render or reset graph;
# a step graph's add the physics' (``step_replay_kernels``)
REPLAY_KERNELS = {"emit_kernel": 1, KERNEL_NAMES["sort_tiles"]: 1,
                  "composite_kernel": 1,
                  "project_posed_kernel": 1, "normal_newton_kernel": 0}
BURST = 50              # launches per window of the back-to-back clock
PHYS_ENVS = (1, 4, 64)
PHYS_STEPS = 30
EAGER_STEPS = 10        # timed steps of an eager form (host-bound, 4-10x
                        # its graph's step)
GRAPH_STEPS = 10        # graph vs eager, bit for bit
# one control step, card vs CPU, from the same state (absolute)
PHYS_POS_TOL = 1e-5
PHYS_VEL_TOL = 1e-3
# normal Newton kernel where it need not give the plain version's bits
# (one env, whose plain version takes other library routines than a
# batch's; the shifted all-rows systems): the median over envs of its
# LCP residual (tools/solve_times.lcp_residual) at most NEWTON_RES_RATIO
# times the plain version's, floor NEWTON_RES_FLOOR (float32 rounding of
# w reads ~1e-7; x = 0 reads 1)
NEWTON_RES_RATIO = 3.0
NEWTON_RES_FLOOR = 1e-6
REST_STEPS = 40
LOOP_STEPS = 30
SHARDS = 2              # 9a: shards of the split loop on one card
SHARD_STEPS = 10
SHARD_STATE_TOL = 1e-5  # every WorldState field after SHARD_STEPS steps
SHARD_MEAN_TOL = 1e-6   # mean_across_envs against the unsharded mean
SEG_AGREE_MIN = 0.999
LOOP_STEPS_64 = 3
SCAN_CHECK_STEPS = 10   # scanned vs eager, bit for bit (6c, 6d, 9a)
RESET_REPS = 4          # resets and renders of each form (6c, 6d)
SCAN_PROFILE_STEPS = 3  # scanned steps in the profiler's window
PROFILE_MARGIN_S = 0.02  # host idle time at each edge of a profiler window
EE_MODES = ("pd_ee_delta_pos", "pd_ee_delta_pose")
OTHER_TASKS = ("PnpBoxFr3Env-v1", "PourMustardFr3Env-v1", "StackFr3Env-v1",
               "AlignXArmEnv-v1", "BananaRotationXArmEnv-v1",
               "SpoonOnBoardXArmEnv-v1")
TASK_STEPS = 3
STATIC_LIN = 0.05       # actor_is_static's threshold = the depenetration cap
SFM_UNITS = 2.7         # SfM units per GS unit of phase 7b's text model
MARKER = 0.1            # side of 7b's virtual ArUco marker, GS units
MARKER_SIM = (0.45, 0.15, 0.0)   # its centre on the table, sim frame
PICK_NOISE = 0.005      # GS units: error of 7b's hand-picked link origins
SCALE_TOL = 1e-6        # recovered scale, relative (tests/test_real2sim.py)
VIEW_TOL = 1e-5         # rescaled cameras' world_view against the arc's
SCAN_MOVE_STEPS = 5
# phase 8: one scripted episode per task through run_with_gs.collect
DEMO_TASKS = (("AlignFr3Env-v1", "fr3_align"),
              ("PnpBoxFr3Env-v1", "fr3_pnp_box"),
              ("StackFr3Env-v1", "fr3_stack"),
              ("PourMustardFr3Env-v1", "fr3_pour"),
              ("AlignXArmEnv-v1", "xarm6_align"),
              ("BananaRotationXArmEnv-v1", "xarm6_rot_banana"),
              ("SpoonOnBoardXArmEnv-v1", "xarm6_spoon2board"))
DEMO_REPLAY = ("AlignFr3Env-v1", "AlignXArmEnv-v1")
DEMO_W, DEMO_H = 640, 480
DEMO_DRY_TOL = 1e-5     # rad, dry-run waypoints card vs CPU
DEMO_CPU_STEPS = 10
DEMO_CHECK_STEPS = 5    # 8a: graph vs eager steps after each episode
# compare_trajectories card vs CPU over the first 10 steps, m and rad:
# measured on an H100: 0 for every actor, 6.1e-7 qpos RMSE
DEMO_TRAJ_TOL = 1e-5
RRT_SWING = 1.2         # rad of joint 1 between 8c's start and goal
RRT_BATCH = 4096        # configurations per timed checker call
LOG_STEPS = 3

# Roofline of one H100 SXM at its 700 W limit (NVIDIA's data sheet): f32
# lane instructions (67 TFLOP/s counts an FMA as two), MUFU operations
# (exp, reciprocal: 16 per SM and clock) and HBM bytes, per second
F32_RATE = 3.35e13          # 132 SMs x 128 lanes x 1.98 GHz
MUFU_RATE = 4.18e12         # 132 SMs x 16 x 1.98 GHz
HBM_RATE = 3.35e12
# the preprocess kernel (csrc/project.cu), counted from its source
# (--fmad=false; an IEEE divide or square root ~8 instructions beside its
# MUFU operation): per (frame, Gaussian) pair the view transform, EWA,
# radius, rect and SH colour, 14 divides and 3 square roots; per (env,
# Gaussian) the repose, the covariance, the opacity and its log, 5
# divides, 2 square roots, 5 exps and logs.  Bytes: each pair's 60
# written (mean2d 8, depth 4, conic 12, colour 12, opacity 4, radius 4,
# rect 16), each Gaussian's 244 read once (means, log-scales, quaternion,
# opacity logit, 3 + 45 SH coefficients, the slot id)
OPS_PROJECT_PAIR = 450
MUFU_PROJECT_PAIR = 17
OPS_PROJECT_GAUSS = 230
MUFU_PROJECT_GAUSS = 12
PROJECT_PAIR_BYTES = 60
PROJECT_GAUSS_BYTES = 244
PROJECT_ENVS = 64       # phase 3's preprocess check: the e64 cell's frames
PROJECT_EXACT = 0.9999  # radius and rect equal on this share of pairs
PROJECT_REL = 1e-6      # mean2d, depth, conic, opacity (relative)
PROJECT_COLOR_ABS = 1e-5
# f32 instructions per (pixel, entry) pair, counted from csrc/composite.cu
# and csrc/composite_bwd.cu (--fmad=false, so every product and sum is an
# instruction of its own; expf is ~6 plus one MUFU.EX2, an IEEE divide ~6
# plus one MUFU.RCP).  The bounds charge only the work no walk can avoid:
# every blended pair's test, exp and blend, and one box test per live
# entry; a pair that a perfect cull would skip costs nothing there.
OPS_TEST = 12       # dx, dy, the exponent, its > 0 test
OPS_EXP = 9         # expf, the opacity product and clamp, the alpha test
OPS_BLEND_FWD = 12  # the stop test, the weight, colour sums, segmentation
OPS_BLEND_BWD = 51  # the stop test, the suffix sum, nine gradient terms
OPS_CULL = 95       # one entry's box-max exponent test (subtile_keep in
MUFU_CULL = 2       # csrc/composite_common.cuh: two divides among them)
ENTRY_BYTES = 40    # per live entry: Gaussian id + 9 floats (mean, conic,
#                     opacity, colour) read once
SEM_BYTES = 4       # + its semantic id, when segmenting
ROW_BYTES = 36      # the backward's 9-float row per entry, written once
FWD_PIXEL_BYTES = 16  # RGB + T written (+ SEM_BYTES of segmentation)
BWD_PIXEL_BYTES = 32  # RGB, T and their cotangents read


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


def burst_ms(launch, k=BURST, reps=7):
    """The back-to-back clock, for kernels whose bound is far below the
    host's cost of one wrapper call: ``k`` calls of ``launch`` queued one
    behind the other between two CUDA events, the time divided by ``k``;
    median of ``reps``.  ``launch`` does nothing but queue the kernel into
    outputs allocated before, so the device never waits for the host
    once the queue has filled."""
    import torch
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(k):
            launch()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / k)
    return statistics.median(times)


def profiler_kernel_ms(launch, name, k=BURST):
    """The profiler's clock: mean device duration (ms) that torch.profiler
    gives the kernels whose name contains ``name`` over ``k`` calls of
    ``launch``; None where the profiler shows no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(k):
            launch()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    n = sum(e.count for e in hits)
    if n == 0:
        return None
    return sum(e.self_device_time_total for e in hits) / n / 1e3


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
    from gsworld_tpu_torch.utils import kernels
    t0 = time.perf_counter()
    kernels.build_kernels()
    dt = time.perf_counter() - t0
    if kernels.build_log():
        with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
            f.write(kernels.build_log())
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


def composite_gate(ik, tk, ip, tp):
    """Kernel (ik, tk) vs plain (ip, tp) compositor outputs (F, H, W, 3),
    (F, H, W).  A pixel whose transmittance lands within a hair of the
    stop threshold can stop one entry earlier in one version than in the
    other (sequential product against chunked cumulative product), which
    moves T by T_excl alpha (at least T_EPS / 255 ~ 3.9e-7, up to ~1e-4)
    and RGB by up to that times the colour.  Such a stop flip (final T
    within STOP_HAIR of T_EPS in either version, T apart by more than
    FLIP_MIN_DT) is excused.  Returns the per-frame max |rgb| and |T|
    errors over the other pixels, and the (F, H, W) mask of excused
    pixels."""
    d_rgb = (ik - ip).abs().amax(dim=-1)
    d_t = (tk - tp).abs()
    near = ((tk - T_EPS).abs() < STOP_HAIR) | ((tp - T_EPS).abs() < STOP_HAIR)
    excused = near & (d_t > FLIP_MIN_DT)
    keep = (~excused).to(d_rgb.dtype)
    return ((d_rgb * keep).flatten(1).amax(dim=1),
            (d_t * keep).flatten(1).amax(dim=1), excused)


def worst_pixel(ik, tk, ip, tp, excused, starts, gaussian, mean2d, conic,
                opacity, tile, width):
    """Where the kernel and plain compositors differ most (excused pixels
    left out): the pixel, both T, its tile's entry count and how close
    one of them comes to the alpha threshold 1/255 (relative) and to the
    power <= 0 test, the two compares besides the stop that can flip."""
    import torch
    d = torch.maximum((ik - ip).abs().amax(dim=-1), (tk - tp).abs())
    d = d.masked_fill(excused, 0.0)
    F, H, W = d.shape
    i = int(d.argmax())
    f, y, x = i // (H * W), (i // W) % H, i % W
    gx = -(-width // tile)
    t = (y // tile) * gx + x // tile
    g = gaussian[f, int(starts[f, t]):int(starts[f, t + 1])].long()
    dx = mean2d[f, g, 0] - x
    dy = mean2d[f, g, 1] - y
    A, B, C = conic[f, g].unbind(-1)
    power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    alpha = torch.clamp_max(opacity[f, g] * torch.exp(power), 0.99)
    near_a = float(((alpha * 255.0 - 1.0).abs()).min()) if len(g) else -1.0
    near_p = float(power.abs().min()) if len(g) else -1.0
    return (f"worst pixel: frame {f} (x {x}, y {y}), |diff| "
            f"{float(d[f, y, x]):.3g}, T kernel {float(tk[f, y, x]):.7g} "
            f"plain {float(tp[f, y, x]):.7g}; {len(g)} entries in its "
            f"tile, min |255 alpha - 1| {near_a:.3g}, min |power| "
            f"{near_p:.3g}")


def bound_of(ops, mufu, nbytes):
    """The least time (ms) of ``ops`` f32 instructions, ``mufu`` MUFU
    operations and ``nbytes`` HBM bytes on one H100, and what binds it:
    -> (bound_ms, "operations" or "bytes", {resource: ms})."""
    parts = {"f32": 1e3 * ops / F32_RATE, "mufu": 1e3 * mufu / MUFU_RATE,
             "bytes": 1e3 * nbytes / HBM_RATE}
    worst = max(parts, key=parts.get)
    return parts[worst], ("bytes" if worst == "bytes" else "operations"), parts


def composite_work(starts, gaussian, proj, cfg):
    """Entries per tile, the (pixel, entry) pairs the walk needs (plain
    walk, rasterize_cuda.walk_counts) and the longest walk of any pixel
    of a tile and of a 16x16 sub-tile: what one block of the compositors
    must walk at least.  -> dict of numbers; per-frame lists where
    marked."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    per_tile = (starts[:, 1:] - starts[:, :-1]).double()
    w = rc.walk_counts(starts, gaussian, proj.mean2d, proj.conic,
                       proj.opacity, width=cfg.width, height=cfg.height,
                       tile=cfg.tile)
    walked = w["walked"]
    F, H, W = walked.shape

    def block_max(sub):
        gx, gy = -(-W // sub), -(-H // sub)
        pad = walked.new_zeros((F, gy * sub, gx * sub))
        pad[:, :H, :W] = walked
        return pad.reshape(F, gy, sub, gx, sub).amax(dim=(2, 4))

    kept = subtile_kept(starts, gaussian, proj, cfg)
    return dict(
        kept_total=int(kept.sum()), kept_max=int(kept.max()),
        tile_max=per_tile.amax(dim=1).long().tolist(),
        tile_p99=torch.quantile(per_tile, 0.99, dim=1).round().long().tolist(),
        tile_mean=[round(x, 1) for x in per_tile.mean(dim=1).tolist()],
        live=int(starts[:, -1].sum()),
        walked=int(walked.sum()), exps=int(w["exps"].sum()),
        blended=int(w["blended"].sum()),
        walk_tile_max=int(block_max(cfg.tile).max()),
        walk_sub16_max=int(block_max(16).max()),
        walk_sub8_max=int(block_max(8).max()),
        pixels=F * H * W)


def subtile_kept(starts, gaussian, proj, cfg):
    """Entries each block of the compositor kernels walks after its
    sub-tile cull (plain versions of the record gather and the cull):
    (F, T, S) counts over the S sub-tiles of each tile."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    F, T = starts.shape[0], starts.shape[1] - 1
    sub = min(rc.SUB_TILE, cfg.tile)
    ns = -(-cfg.tile // sub)
    gx = -(-cfg.width // cfg.tile)
    rec = rc.pack_records_reference(starts, gaussian, proj.mean2d,
                                    proj.conic, proj.opacity, proj.color,
                                    None)
    kept = torch.zeros((F, T, ns * ns), dtype=torch.int64,
                       device=starts.device)
    for f in range(F):
        n = int(starts[f, -1])
        t = torch.repeat_interleave(
            torch.arange(T, device=starts.device),
            (starts[f, 1:] - starts[f, :-1]).long())
        for s in range(ns * ns):
            lx0, ly0 = (s % ns) * sub, (s // ns) * sub
            x0 = ((t % gx) * cfg.tile + lx0).float()
            y0 = ((t // gx) * cfg.tile + ly0).float()
            x1 = x0 + (min(lx0 + sub, cfg.tile) - lx0 - 1)
            y1 = y0 + (min(ly0 + sub, cfg.tile) - ly0 - 1)
            keep = rc.subtile_keep_reference(rec[f, :n], x0, x1, y0, y1)
            kept[f, :, s].index_add_(0, t, keep.long())
    return kept


def composite_bounds(work, segment):
    """Bounds of the forward and backward compositors on ``work``
    (composite_work): the blended pairs' tests, exps and blends (the
    backward's with its divide) and one box test per live entry, against
    the bytes moved once -> {"fwd": (ms, by, parts), "bwd": ...}."""
    pairs, live = work["blended"], work["live"]
    cull_ops, cull_mufu = OPS_CULL * live, MUFU_CULL * live
    fwd_ops = (OPS_TEST + OPS_EXP + OPS_BLEND_FWD) * pairs + cull_ops
    bwd_ops = (OPS_TEST + OPS_EXP + OPS_BLEND_BWD) * pairs + cull_ops
    ent = ENTRY_BYTES + (SEM_BYTES if segment else 0)
    fwd_px = FWD_PIXEL_BYTES + (SEM_BYTES if segment else 0)
    return dict(
        fwd=bound_of(fwd_ops, pairs + cull_mufu,
                     live * ent + work["pixels"] * fwd_px),
        bwd=bound_of(bwd_ops, 2 * pairs + cull_mufu,
                     live * (ENTRY_BYTES + ROW_BYTES)
                     + work["pixels"] * BWD_PIXEL_BYTES))


def work_line(phase, work, timed):
    """One line: the tile histogram, the pairs, and per kernel (``timed``:
    (name, bound_of result, measured ms)) its bound, what binds it and
    its share of the bound at the measured time."""
    parts = []
    for name, (b, by, p), ms in timed:
        parts.append(f"{name} bound {b:.4f} ms ({by}; f32 {p['f32']:.4f}, "
                     f"MUFU {p['mufu']:.4f}, bytes {p['bytes']:.4f} ms), "
                     f"kernel {ms:.4f} ms, share of bound (bound / kernel) "
                     f"{100 * b / ms:.2f}%")
    return (f"phase {phase} work: entries per tile max {work['tile_max']}, "
            f"p99 {work['tile_p99']}, mean {work['tile_mean']}; {work['live']}"
            f" live entries; pairs walked {work['walked']} (exp "
            f"{work['exps']}, blended {work['blended']}); after the "
            f"16x16 sub-tile cull the blocks walk {work['kept_total']} "
            f"entries, at most {work['kept_max']} in one; longest walk of "
            f"one pixel {work['walk_tile_max']} entries (its 32x32 tile), "
            f"longest of a 16x16 sub-tile {work['walk_sub16_max']}, of an "
            f"8x8 {work['walk_sub8_max']}; " + "; ".join(parts))


def emit_bound(cnt, E):
    """Bound of the emit kernel on ``cnt`` (F, N), the kept entries per
    depth rank, and E slots per frame: the ranks that emit are charged 52
    bytes (two ends, the id, rect, mean, conic, opacity), the others their
    4-byte end; every slot's 8-byte key and id is written.  Bytes bind
    (~50 f32 instructions per kept entry for the box cull are far
    below)."""
    F, N = cnt.shape
    emitting = int((cnt > 0).sum())
    nbytes = emitting * 52 + (F * N - emitting) * 4 + F * E * 8
    return bound_of(50 * int(cnt.sum()), emitting, nbytes)


def render_inputs(renderer, state, tint=None, cfg=None):
    """Projections of every frame (env x camera) of one render step by
    the plain preprocess (colours times the per-slot ``tint`` (B, S, 3)
    where given; the renderer's raster config unless ``cfg``)
    -> (Projected (F, N, ...), leading shape)."""
    import torch
    from gsworld_tpu_torch.render.rasterize_cuda import \
        project_posed_reference
    with torch.no_grad():
        slots, cams = renderer.slots_and_cameras(state)
        flat = project_posed_reference(renderer.scene, slots, cams,
                                       cfg or renderer.raster_config, tint)
        return flat, cams.world_view.shape[:2]


def train_inputs(setup):
    """Projection of the first training view of the phase-5 scene at its
    capacity, as the training path builds it -> (Projected (1, N, ...),
    the padded scene)."""
    import torch
    from gsworld_tpu_torch.gs.pcd_init import create_from_pcd
    from gsworld_tpu_torch.gs.transform import PosedGaussians
    from gsworld_tpu_torch.render.rasterize import project_frames
    from gsworld_tpu_torch.train3dgs.densify import pad_scene_capacity
    scene = pad_scene_capacity(
        create_from_pcd(setup.points, setup.colors, device=setup.device),
        setup.capacity)
    with torch.no_grad():
        flat, _ = project_frames(
            PosedGaussians(scene.means, scene.log_scales, scene.quats,
                           scene.logit_opacities),
            setup.cams[0], setup.cfg, scene.sh0, scene.shN)
    return flat, scene


def entry_counts(ends):
    """Kept entries per depth rank (F, N) from the emit kernel's inclusive
    slot ends."""
    import torch
    ends = ends.long()
    return torch.diff(ends, dim=-1, prepend=torch.zeros_like(ends[:, :1]))


def sort_bound(n, bits):
    """Bound of the key sort on ``n`` keys of ``bits`` bits: one read of
    the 4-byte keys for the digit histograms, then per 8-bit pass the key
    and the value read and written, 16 bytes a slot."""
    nbytes = n * 4 + -(-bits // 8) * n * 16
    return bound_of(0, 0, nbytes)


def parent_sort(keys, gid, depth, T):
    """The key sort as the port had it before its slots followed the depth
    ranking, on the card: one stable ``torch.sort`` of the 64-bit keys
    ``(f (T+1) + tile) << 32 | depth bits`` of the emitted entries (the
    sentinel's depth bits those of +inf) -> (sorted ids (F, E), starts
    (F, T+1) int32, the 64-bit keys).  Equal 64-bit keys keep slot order,
    which is rank order, so this is the parent's answer on any layout
    whose ranks order equal depths by id."""
    import torch
    F, E = keys.shape
    dbits = torch.gather(depth.contiguous().view(torch.int32), 1,
                         gid.long().clamp_min(0)).long() & 0xFFFFFFFF
    dbits = torch.where(gid >= 0, dbits, 0x7F800000)
    key64 = (keys.long() << 32) | dbits
    keys_s, perm = torch.sort(key64.reshape(-1), stable=True)
    fr = torch.arange(F, device=keys.device, dtype=torch.int64)
    bounds = (fr[:, None] * (T + 1) + torch.arange(
        T + 1, device=keys.device, dtype=torch.int64)) << 32
    starts = (torch.searchsorted(keys_s, bounds.reshape(-1)).view(F, T + 1)
              - fr[:, None] * E).to(torch.int32)
    return gid.reshape(-1)[perm].view(F, E), starts, key64


def binning_digest(gaussian, starts, overflow):
    """SHA-256 of the sorted ids up to each frame's live count, the starts
    and the overflow (tools/emit_times.py's digest)."""
    import hashlib
    import torch
    h = hashlib.sha256()
    T = starts.shape[1] - 1
    live = starts[:, T].long().tolist()
    for f, n in enumerate(live):
        h.update(gaussian[f, :n].cpu().numpy().tobytes())
    h.update(starts.cpu().numpy().tobytes())
    h.update(overflow.to(torch.int64).cpu().numpy().tobytes())
    return h.hexdigest()


def sort_kernels_ms(launch, k=10):
    """Profiler device time (ms) per call of ``launch`` summed over the key
    sort's kernels (csrc/sort_tiles.cu: CUB's in its own namespace): each
    kernel's mean duration times its launches per call -> (ms or None,
    {name: (kernels seen, per call)})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(k):
            launch()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and SORT_NAMESPACE in e.key
            and e.count]
    if not hits:
        return None, {}
    names, ms = {}, 0.0
    for e in hits:
        per_call = max(1, round(e.count / k))
        name = e.key.split("<")[0].split("::")[-1]
        names[name] = (e.count, per_call)
        ms += e.self_device_time_total / e.count * per_call / 1e3
    return ms, names


def check_sort(phase, what, keys, gid, depth, overflow, T, timed=True):
    """The key sort (csrc/sort_tiles.cu through ``binning.sort_entries``)
    on the emit kernel's ``keys`` and ``gid`` (F, E): the sorted keys and
    permutation of ``sort_tiles`` bit for bit those of its plain version
    (``torch.sort``), and the sorted ids up to each frame's live count and
    the starts bit for bit the parent's answer (``parent_sort``), with the
    SHA-256 of both; its time by the profiler beside its bound, the
    wrapper call's, and ``torch.sort`` of the 64-bit keys (library_ms).
    -> (the sort's entry for the kernels line, sorted ids, starts)."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.render.binning import sort_entries

    F, E = keys.shape
    bits = max((F * (T + 1) - 1).bit_length(), 1)
    got_k, got_p = rc.sort_tiles(keys.clone(), bits)
    want_k, want_p = rc.sort_tiles_reference(keys, bits)
    if not (torch.equal(got_k, want_k) and torch.equal(got_p, want_p)):
        raise AssertionError(f"sort ({what}): keys or permutation differ "
                             f"from torch.sort's")
    gaus, starts, _ = sort_entries(keys.clone(), gid, T)
    gaus_o, starts_o, key64 = parent_sort(keys, gid, depth, T)
    live = starts[:, T].long()
    same = torch.equal(starts, starts_o) and all(
        torch.equal(gaus[f, :n], gaus_o[f, :n])
        for f, n in enumerate(live.tolist()))
    new_d = binning_digest(gaus, starts, overflow)
    old_d = binning_digest(gaus_o, starts_o, overflow)
    if not same or new_d != old_d:
        raise AssertionError(f"sort ({what}): sorted ids or starts differ "
                             f"from the 64-bit key sort's ({new_d} against "
                             f"{old_d})")
    log(f"phase {phase} sort, {what}: {F * E} keys of {bits} bits, sorted "
        f"keys and permutation bit for bit torch.sort's; sorted ids and "
        f"starts bit for bit the 64-bit key sort's, SHA-256 {new_d} (64-bit "
        f"sort {old_d})")
    if not timed:
        return None, gaus, starts
    buf = torch.empty_like(keys)

    def launch():
        buf.copy_(keys)
        rc.sort_tiles(buf, bits)

    ms, names = sort_kernels_ms(launch)
    call_ms = cuda_ms(lambda: rc.sort_tiles(keys.clone(), bits), reps=10)
    copy_ms = cuda_ms(lambda: buf.copy_(keys), reps=10)
    # the device's clock: copies and sorts queued back to back, less the
    # copies alone
    burst = burst_ms(launch, k=10) - burst_ms(lambda: buf.copy_(keys), k=10)
    plain_ms = cuda_ms(lambda: rc.sort_tiles_reference(keys, bits), reps=5)
    library_ms = cuda_ms(lambda: torch.sort(key64.reshape(-1), stable=True),
                         reps=5)
    b, by, _ = sort_bound(F * E, bits)
    kernel_ms = ms if ms is not None else call_ms - copy_ms
    log(f"phase {phase} sort time, {what}: kernels "
        + ("not measured by the profiler" if ms is None
           else f"{ms:.4f} ms by the profiler (kernels seen in 10 calls, "
           f"per call: {names})")
        + f", {burst:.4f} ms back to back (less the keys' copies), "
        f"{call_ms:.4f} ms for one wrapper call with the keys' copy "
        f"({copy_ms:.4f} ms) between events; plain (torch.sort of the "
        f"32-bit keys) {plain_ms:.4f} ms; torch.sort of the 64-bit keys "
        f"{library_ms:.4f} ms; bound {b:.4f} ms ({by}), share of bound "
        f"{100 * b / kernel_ms:.2f}%")
    entry = dict(name="sort_tiles", route="cuda",
                 source="gsworld_tpu_torch/csrc/sort_tiles.cu",
                 replaces="gsworld_tpu/render/binning.py:109 (step 4)",
                 max_abs_err=0.0, ms=kernel_ms, plain_ms=plain_ms,
                 bound_ms=b, bound_by=by, library_ms=library_ms,
                 profiler_ms=ms, burst_ms=burst, call_ms=call_ms, bits=bits,
                 digest=new_d)
    return entry, gaus, starts


def check_emit(phase, what, plan, depth, cfg, timed=True):
    """Emit kernel vs its plain version on the plan_emit result ``plan``
    (keys equal except within CULL_BORDER of the cull threshold, ids
    equal, starts and entry order equal after the sort), the key sort
    (``check_sort``; ``depth`` (F, N) the projection's), a line on what
    the inputs look like, and the times, the emit's in both slot layouts.
    -> (the emit kernel's and the sort's entries for the kernels line,
    sorted Gaussian ids, starts)."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.render.binning import slot_runs, sort_entries

    a = plan.args
    T, E = cfg.num_tiles, a["E"]
    F = a["ends"].shape[0]
    keys_k, gid_k = rc.emit_entries(**a)
    keys_p, gid_p = rc.emit_entries_reference(**a)
    torch.cuda.synchronize()
    if not torch.equal(gid_k, gid_p):
        raise AssertionError(f"emit ({what}): Gaussian ids differ from the "
                             f"plain version")
    diff = keys_k != keys_p
    n_flip = int(diff.sum())
    if n_flip:
        f, slot, score, _ = rc.emit_slots(
            a["ends"], a["order"], a["rect"], a["mean2d"], a["conic"],
            a["opacity"], E=E, tile=cfg.tile)
        margin = torch.full_like(keys_k, 2 ** 40, dtype=torch.float32)
        margin.view(-1)[f * E + slot] = (score - rc.LOG_ALPHA_MIN).abs()
        worst = float(margin[diff].max())
        if worst >= CULL_BORDER:
            raise AssertionError(f"emit ({what}): {n_flip} keys differ, one "
                                 f"{worst:.3g} from the cull threshold")
    sort_entry, gaus_k, starts_k = check_sort(
        phase, what, keys_k, gid_k, depth, plan.overflow, T, timed=timed)
    gaus_p, starts_p, _ = sort_entries(keys_p, gid_p, T)
    d_starts = int((starts_k.long() - starts_p.long()).abs().max())
    if n_flip == 0 and (d_starts or not torch.equal(gaus_k, gaus_p)):
        raise AssertionError(f"emit ({what}): starts or entry order differ")
    if d_starts > n_flip:
        raise AssertionError(f"emit ({what}): starts differ by {d_starts} "
                             f"with only {n_flip} borderline entries")
    cnt = entry_counts(a["ends"])
    kept = cnt.sum(-1)
    hist = {name: int(((cnt >= lo) & (cnt <= hi)).sum()) for name, lo, hi in (
        ("1", 1, 1), ("2-4", 2, 4), ("5-16", 5, 16), ("17-63", 17, 63),
        ("64+", 64, 2 ** 30))}
    log(f"phase {phase} emit, {what} (F={F}, N={cnt.shape[1]}, E={E} "
        f"each): emitting Gaussians {(cnt > 0).sum(-1).tolist()}, entries "
        f"per emitting Gaussian {hist}, kept slots {kept.tolist()}, unused "
        f"{(E - kept).tolist()}, live entries after the cull "
        f"{starts_k[:, T].tolist()}, overflow {plan.overflow.tolist()}; "
        f"{n_flip} borderline cull flips, max |starts diff| {d_starts}")
    if not timed:
        return None, None, gaus_k, starts_k
    # the bound is tens of microseconds: the back-to-back clock and the
    # profiler read the kernel, one wrapper call between two events reads
    # the host's checks, allocations and ctypes call with it
    launch = rc.emit_entries_launcher(**a)[0]
    ms = burst_ms(launch)
    prof_ms = profiler_kernel_ms(launch, "emit_kernel")
    call_ms = cuda_ms(lambda: rc.emit_entries(**a), reps=20)
    plain_ms = cuda_ms(lambda: rc.emit_entries_reference(**a), reps=10)
    # the same kernel on the Gaussian-order layout the port had before:
    # the identity for the ranking, the kept counts summed over ids
    first, end = slot_runs(a["ends"], a["order"])
    ids = torch.arange(cnt.shape[1], device=cnt.device, dtype=torch.int32)
    by_id = dict(a, ends=torch.cumsum(end - first, -1, dtype=torch.int32),
                 order=ids.expand(F, -1).contiguous())
    id_ms = burst_ms(rc.emit_entries_launcher(**by_id)[0])
    b, by, _ = emit_bound(cnt, E)
    log(f"phase {phase} emit time, {what}: kernel {ms:.4f} ms back to back "
        f"({BURST} launches per window), "
        + ("profiler not measured" if prof_ms is None
           else f"{prof_ms:.4f} ms by the profiler")
        + f", {call_ms:.4f} ms for one wrapper call between events; the "
        f"same kernel on slots in Gaussian order {id_ms:.4f} ms back to "
        f"back ({ms - id_ms:+.4f} ms for the depth-rank layout); plain "
        f"{plain_ms:.4f} ms; bound {b:.4f} ms ({by}), share of bound "
        f"(bound / kernel) {100 * b / ms:.2f}%")
    entry = dict(name="emit_entries", route="cuda",
                 source="gsworld_tpu_torch/csrc/emit.cu",
                 replaces="gsworld_tpu/render/rasterize_pallas.py:117",
                 max_abs_err=float(d_starts), ms=ms, plain_ms=plain_ms,
                 bound_ms=b, bound_by=by, library_ms=None,
                 profiler_ms=prof_ms, call_ms=call_ms,
                 gaussian_order_ms=id_ms)
    return entry, sort_entry, gaus_k, starts_k


def phase_kernels(renderer, state, phase=3, tint=None, timed=True,
                  cfg=None):
    """Emit and compositor kernels vs plain versions on the frames of one
    render step (every env x camera), with the inputs the plain
    preprocess builds for them (tinted by the slots' ``tint`` (B, S, 3)
    where given; with the renderer's raster config unless ``cfg``).  ``timed`` adds the times, the bounds
    and the worst pixel."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.render.binning import plan_emit

    cfg = cfg or renderer.raster_config
    proj, lead = render_inputs(renderer, state, tint, cfg)
    with torch.no_grad():
        plan = plan_emit(proj, cfg)
    a = plan.args
    F = proj.depth.shape[0]
    what = f"{F} {'tinted ' if tint is not None else ''}render frames"
    emit_entry, sort_entry, gaus_k, starts_k = check_emit(
        phase, f"{what} {tuple(lead)}", plan, proj.depth, cfg, timed=timed)

    sem = renderer.scene.semantics
    comp_args = (starts_k, gaus_k, proj.mean2d, proj.conic, proj.opacity,
                 proj.color, sem)
    kw = dict(width=cfg.width, height=cfg.height, tile=cfg.tile, bg=cfg.bg)
    ik, tk, sk, rec_k = rc.composite_tiles(*comp_args, **kw)
    ip, tp, sp = rc.composite_tiles_reference(*comp_args, **kw)
    rec_p = rc.pack_records_reference(*comp_args)
    torch.cuda.synchronize()
    live = (torch.arange(a["E"], device=rec_k.device)[None]
            < starts_k[:, -1:].long())
    # copied fields bit for bit; the log of the opacity (logf against
    # torch.log) to 2 f32 ulps
    lk, lp = rec_k[live][:, 10], rec_p[live][:, 10]
    if not (torch.equal(rec_k[live][:, :10].view(torch.int32),
                        rec_p[live][:, :10].view(torch.int32))
            and bool(((lk - lp).abs() <= 2.4e-7 * lp.abs()).all())):
        raise AssertionError("composite: the record gather differs from "
                             "the plain gather")
    rgb_f, t_f, excused = composite_gate(ik, tk, ip, tp)     # per frame
    rgb_err, t_err = float(rgb_f.max()), float(t_f.max())
    n_excused = int(excused.sum())
    # segmentation may follow a stop flip too; the bound is unchanged
    seg_mis = float((sk != sp).float().mean())
    if not (rgb_err <= RGB_TOL and t_err <= RGB_TOL
            and seg_mis <= SEG_MISMATCH_MAX):
        raise AssertionError(f"composite: rgb err {rgb_err:.3g}, T err "
                             f"{t_err:.3g} ({n_excused} stop flips "
                             f"excused), seg mismatch {seg_mis:.4%}")
    log(f"phase {phase} composite, {what}: records equal the plain gather "
        f"(log opacity to 2 ulps); max |rgb| err {rgb_err:.3g}, max |T| err "
        f"{t_err:.3g} over all but {n_excused} stop-flip pixels (per frame "
        f"{excused.flatten(1).sum(1).tolist()}), seg mismatch "
        f"{seg_mis:.4%} (tolerance {RGB_TOL}, {SEG_MISMATCH_MAX:.1%}); per "
        f"frame |rgb| {[float(f'{x:.3g}') for x in rgb_f.tolist()]}, |T| "
        f"{[float(f'{x:.3g}') for x in t_f.tolist()]}")
    if not timed:
        return None
    log("phase 3 composite " + worst_pixel(
        ik, tk, ip, tp, excused, starts_k, gaus_k, proj.mean2d, proj.conic,
        proj.opacity, cfg.tile, cfg.width))
    comp_ms = cuda_ms(lambda: rc.composite_tiles(*comp_args, **kw), reps=20)
    comp_plain_ms = cuda_ms(
        lambda: rc.composite_tiles_reference(*comp_args, **kw), reps=10)
    log(f"phase 3 composite time: kernel {comp_ms:.4f} ms, plain "
        f"{comp_plain_ms:.4f} ms")
    work = composite_work(starts_k, gaus_k, proj, cfg)
    fwd = composite_bounds(work, segment=True)["fwd"]
    log(work_line(3, work, [("composite", fwd, comp_ms)]))
    return [
        emit_entry,
        sort_entry,
        dict(name="composite_tiles", route="cuda",
             source="gsworld_tpu_torch/csrc/composite.cu",
             replaces="gsworld_tpu/render/rasterize_pallas.py:323",
             max_abs_err=max(rgb_err, t_err), ms=comp_ms,
             plain_ms=comp_plain_ms, bound_ms=fwd[0], bound_by=fwd[1],
             library_ms=None),
    ]


def project_gates(got, want):
    """The preprocess kernel's outputs ``got`` against the plain
    version's ``want`` (Projected, F x N pairs): radius and rect equal on
    PROJECT_EXACT of the pairs, depth's inf pattern everywhere, mean2d,
    depth, conic and opacity within PROJECT_REL relative, colour within
    PROJECT_COLOR_ABS -> (text, the largest relative or absolute gap of
    each field); a gate missed raises."""
    import torch
    pairs = want.depth.numel()
    exact = int(((got.radius == want.radius)
                 & (got.rect == want.rect).all(-1)).sum())
    parts = [f"radius and rect equal on {exact} of {pairs} pairs "
             f"({100 * exact / pairs:.5f}%)"]
    gaps = {}
    ok = exact >= PROJECT_EXACT * pairs
    if not torch.equal(torch.isinf(got.depth), torch.isinf(want.depth)):
        raise AssertionError("project: depth's inf pattern differs from the "
                             "plain version's")
    for name in ("mean2d", "depth", "conic", "opacity", "color"):
        g, w = getattr(got, name), getattr(want, name)
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        gap = torch.where(same, torch.zeros_like(g), (g - w).abs())
        if name != "color":
            gap = gap / w.abs().clamp_min(1e-30)
        gaps[name] = float(gap.max())
        bits = int((g.view(torch.int32) == w.view(torch.int32)).sum())
        parts.append(f"{name} bit for bit on {bits} of {w.numel()}, largest "
                     f"{'absolute' if name == 'color' else 'relative'} gap "
                     f"{gaps[name]:.3g}")
        ok = ok and gaps[name] <= (PROJECT_COLOR_ABS if name == "color"
                                   else PROJECT_REL)
    text = "; ".join(parts)
    if not ok:
        raise AssertionError(f"project: {text}")
    return text, gaps


def phase_project():
    """The preprocess kernel (csrc/project.cu) vs its plain version on all
    frames of one render step of the e64 cell's shape (PROJECT_ENVS envs x
    2 cameras, 640x480, the full scene), with the gates of
    ``project_gates``; CUDA-event times of the wrapper call, the kernel
    by the profiler and the plain path, beside the bound; then the emit
    kernel and the key sort on the kernel's projections (``check_emit``)
    -> the preprocess kernel's entry for the kernels line, the emit
    kernel's and the sort's at this shape."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.render.binning import plan_emit
    renderer = make_renderer("cuda", PROJECT_ENVS, BENCH_RASTER, BENCH_SIZES)
    state = random_states(renderer.env, 1, "cuda", seed=SEED + 17)[0]
    cfg, scene = renderer.raster_config, renderer.scene
    with torch.no_grad():
        slots, cams = renderer.slots_and_cameras(state)
        args = (scene, slots, cams, cfg, renderer.slot_tint(state.obj_color))
        got = rc.project_posed(*args)
        want = rc.project_posed_reference(*args)
        torch.cuda.synchronize()
        F, N = want.depth.shape
        text, gaps = project_gates(got, want)
        log(f"phase 3 project, {F} render frames ({PROJECT_ENVS} envs x "
            f"{F // PROJECT_ENVS} cameras) x {N} Gaussians: {text}; in view "
            f"{int((want.radius > 0).sum())} pairs")
        plan, depth = plan_emit(got, cfg), got.depth
        del got, want
        emit_e64, sort_e64, _, _ = check_emit(
            3, f"{F} render frames ({PROJECT_ENVS} envs)", plan, depth, cfg)
        del plan, depth
        ms = cuda_ms(lambda: rc.project_posed(*args), reps=20)
        prof_ms = profiler_kernel_ms(lambda: rc.project_posed(*args),
                                     KERNEL_NAMES["project_posed"], k=10)
        plain_ms = cuda_ms(lambda: rc.project_posed_reference(*args), reps=5)
    B = PROJECT_ENVS
    nbytes = F * N * PROJECT_PAIR_BYTES + N * PROJECT_GAUSS_BYTES
    b, by, parts = bound_of(F * N * OPS_PROJECT_PAIR
                            + B * N * OPS_PROJECT_GAUSS,
                            F * N * MUFU_PROJECT_PAIR
                            + B * N * MUFU_PROJECT_GAUSS, nbytes)
    kernel_ms = prof_ms if prof_ms is not None else ms
    log(f"phase 3 project time: {ms:.4f} ms for one wrapper call between "
        f"events, "
        + ("kernel not measured by the profiler" if prof_ms is None
           else f"kernel {prof_ms:.4f} ms by the profiler")
        + f"; plain path {plain_ms:.4f} ms ({plain_ms / ms:.1f}x the call); "
        f"bound {b:.4f} ms ({by}: {nbytes / 1e9:.3f} GB at "
        f"{HBM_RATE / 1e12:.2f} TB/s {parts['bytes']:.4f} ms, f32 "
        f"{parts['f32']:.4f} ms, MUFU {parts['mufu']:.4f} ms), share of bound "
        f"(bound / kernel) {100 * b / kernel_ms:.2f}%")
    del renderer, args, slots, cams
    torch.cuda.empty_cache()
    return emit_e64, sort_e64, dict(name="project_posed", route="cuda",
                source="gsworld_tpu_torch/csrc/project.cu",
                replaces="none (gs/transform.py:repose_scene + "
                         "render/project.py:project_gaussians, XLA in JAX)",
                max_abs_err=gaps["color"], max_rel_err=max(
                    gaps[k] for k in ("mean2d", "depth", "conic", "opacity")),
                ms=kernel_ms, call_ms=ms, profiler_ms=prof_ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None)


def check_outputs(out, B, H, W, ids_per_camera=True):
    """Shapes and dtypes of the JAX wrapper's sensor_data, images that are
    not constant, and at least 3 segmentation ids in every camera (or, for
    states the physics chose, over all cameras together)."""
    import torch
    if not ids_per_camera:
        ids = torch.unique(torch.cat([o["segmentation"].flatten()
                                      for o in out.values()]))
        if len(ids) < 3:
            raise AssertionError("segmentation has < 3 ids over all cameras")
    for cam, o in out.items():
        rgb, seg = o["rgb"], o["segmentation"]
        if rgb.shape != (B, H, W, 3) or rgb.dtype != torch.uint8:
            raise AssertionError(f"{cam}: rgb {tuple(rgb.shape)} {rgb.dtype}")
        if seg.shape != (B, H, W, 1) or seg.dtype != torch.int16:
            raise AssertionError(f"{cam}: seg {tuple(seg.shape)} {seg.dtype}")
        if float(rgb.float().std()) < 5.0:
            raise AssertionError(f"{cam}: image is (nearly) constant")
        if ids_per_camera and len(torch.unique(seg)) < 3:
            raise AssertionError(f"{cam}: segmentation has < 3 ids")


def render_outputs(out, overflow):
    """{path: tensor} of a render's outputs and its overflow."""
    return dict(obs_leaves(out), overflow=overflow)


def phase_slice(renderer, states):
    """4: the render step eagerly (the env's ``graph=False``) and through
    the renderer's CUDA graph, PASSES passes over the same STEPS states in
    one call: ms per render step, peak memory allocated and reserved of
    each form; every state's rgb, segmentation and overflow of the graph
    bit for bit the eager render's; one preprocess, emit and compositor kernel
    per replay by the profiler -> (launch counts of the phase: the eager
    renders and the graph's capture, the line, {kernel name: kernels per
    replay})."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.utils.cuda_graph import FnGraph
    env, cfg = renderer.env, renderer.raster_config
    B, C = env.num_envs, len(env.cameras)
    graph0 = env.graph
    rc.reset_launch_counts()
    runs = {}
    for graph in (False, True):
        env.graph = graph
        for st in states[:2]:      # warm-up (the graph's capture)
            renderer.render(st)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, outs = [], []
        for k, st in enumerate(states * PASSES):
            t0 = time.perf_counter()
            out = renderer.render(st)
            torch.cuda.synchronize()
            step_ms.append(1000.0 * (time.perf_counter() - t0))
            if k >= len(states) * (PASSES - 1):
                outs.append(render_outputs(out, renderer.last_overflow))
        runs[graph] = (step_ms, outs, torch.cuda.max_memory_allocated(),
                       torch.cuda.max_memory_reserved())
    counts = dict(rc.launch_counts)
    want = 2 + len(states) * PASSES + FnGraph.WARMUP + 1
    for name in RENDER_KERNELS:
        if counts[name] != want:
            raise AssertionError(f"slice: kernel {name} launched "
                                 f"{counts[name]} times (want {want}: the "
                                 f"eager renders and the graph's capture)")
    bad = [f"state {i} {k}" for i, (g, e) in enumerate(
        zip(runs[True][1], runs[False][1])) for k in leaves_differ(g, e)]
    if bad:
        raise AssertionError(f"slice: the render graph differs from the "
                             f"eager render in {bad[:8]} ({len(bad)} in all)")
    check_outputs(out, B, cfg.height, cfg.width)
    prof_text, _, per = replay_kernels(
        lambda: [renderer.render(st) for st in states[:3]], 3,
        "render-graph replays (GSWorldRenderer.render)")
    env.graph = graph0
    overflow = int(renderer.last_overflow.sum())
    parts = []
    for graph, name in ((False, "eager (graph=False)"),
                        (True, "graph (one replay per render step)")):
        ms, _, peak, reserved = runs[graph]
        med = statistics.median(ms)
        parts.append(f"{name} {med:.3f} ms per render step (median of "
                     f"{len(ms)}; min {min(ms):.3f}, max {max(ms):.3f}), "
                     f"{1000.0 * B * C / med:.2f} frames/s, peak memory "
                     f"{peak / 2**30:.3f} GiB allocated "
                     f"({reserved / 2**30:.3f} reserved)")
    med = {g: statistics.median(runs[g][0]) for g in runs}
    line = (f"phase 4 slice: {renderer.scene.num_gaussians} Gaussians, {B} "
            f"envs x {C} cams {cfg.width}x{cfg.height}: " + "; ".join(parts)
            + f"; graph / eager {med[True] / med[False]:.3f}; the graph's "
            f"rgb, segmentation and overflow bit for bit the eager render's "
            f"on all {len(states)} states; {prof_text}; overflow {overflow} "
            f"entries in the last step, launches {counts} (the eager renders "
            f"and the graph's capture)")
    log(line)
    return counts, line, per


def phase_profile(phase, what, step):
    """torch.profiler over 3 calls of ``step(i)``: device time per kernel,
    and the device's busy share of the window (diagnostic; reports "not
    measured" instead of failing the run).
    ``what`` names the steps ("render", "train")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                step(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        avg = prof.key_averages()
        kernels = sorted(
            ((e.self_device_time_total, e.count, e.key) for e in avg
             if e.device_type == DeviceType.CUDA
             and not e.key.startswith("gsw.")), reverse=True)
        busy = sum(k[0] for k in kernels)
        with open(os.path.join(OUT_DIR, f"profile_{what}.txt"), "w") as f:
            f.write(f"wall {wall * 1e3:.3f} ms over 3 {what} steps "
                    f"(profiler on), kernel time {busy / 1e3:.3f} ms\n")
            for t, n, k in kernels:
                f.write(f"{t / 1e3:12.3f} ms {n:6d}  {k}\n")
        if busy == 0:
            log(f"phase {phase} profile: no device time in key_averages "
                f"(not measured)")
            return
        log(f"phase {phase} profile (3 {what} steps, profiler on): wall "
            f"{wall * 1e3 / 3:.3f} ms/step, kernels {busy / 1e3 / 3:.3f} "
            f"ms/step, device busy {100 * busy / 1e3 / (wall * 1e3):.1f}%")
        for t, n, k in kernels[:8]:
            log(f"    kernel {t / 1e3 / 3:8.3f} ms/step x{n // 3:<4d} "
                f"{k[:80]}")
    except Exception as e:  # diagnostic only: report, do not fail the run
        log(f"phase {phase} profile: not measured ({type(e).__name__}: "
            f"{e})")


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


def look_at_w2c(n, arc_deg):
    """World->camera matrices (f64, GS frame) of ``n`` cameras on a
    horizontal arc of ``arc_deg`` degrees in front of the fr3_align robot,
    1.1 m from a point 0.35 m ahead of its base and 0.3 m up, 0.4 m above
    that point and looking at it."""
    import numpy as np
    from gsworld_tpu_torch import constants
    _, sim2gs = constants.robot_calibration("fr3_align")
    sim2gs = np.asarray(sim2gs, np.float64)
    to_gs = lambda p: sim2gs[:3, :3] @ p + sim2gs[:3, 3]    # noqa: E731
    target = to_gs(np.array([0.35, 0.0, 0.3]))
    up = sim2gs[:3, :3] @ np.array([0.0, 0.0, 1.0])
    up /= np.linalg.norm(up)
    out = []
    for i in range(n):
        th = math.radians(arc_deg) * (i / max(n - 1, 1) - 0.5)
        eye = to_gs(np.array([0.35 + 1.1 * math.cos(th), 1.1 * math.sin(th),
                              0.70]))
        fwd = (target - eye) / np.linalg.norm(target - eye)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        w2c = np.eye(4)
        w2c[:3, :3] = np.stack([right, down, fwd])
        w2c[:3, 3] = -w2c[:3, :3] @ eye
        out.append(w2c)
    return out


def arc_intrinsics(width, height, K=None):
    """D435i intrinsics (or ``K``) scaled to ``width`` x ``height``."""
    import numpy as np
    from gsworld_tpu_torch import constants
    K = np.array(constants.rs_d435i_rgb_k if K is None else K, np.float64)
    K[0] *= width / 640.0
    K[1] *= height / 480.0
    return K


def look_at_arc(n, arc_deg, width, height, device, K=None):
    """GS cameras of :func:`look_at_w2c` with :func:`arc_intrinsics`."""
    import numpy as np
    import torch
    from gsworld_tpu_torch.render.camera import camera_from_opencv
    K = arc_intrinsics(width, height, K)
    return [camera_from_opencv(
        torch.as_tensor(w2c, dtype=torch.float32, device=device),
        K.astype(np.float32), width, height)
        for w2c in look_at_w2c(n, arc_deg)]


class TrainSetup:
    """Phase-5 inputs: the truth scene's renders from an arc of cameras
    (the middle one held out) and the noisy point cloud that
    create_from_pcd starts from (the recipe of
    tests/test_real2sim_pipeline.py: means + N(0, 5e-3), colours
    sh0 C0 + 0.5 + N(0, 0.02))."""

    def __init__(self, truth, raster, device, seed=SEED):
        import numpy as np
        import torch
        from gsworld_tpu_torch.gs.pcd_init import C0
        from gsworld_tpu_torch.gs.transform import PosedGaussians
        from gsworld_tpu_torch.render.camera import RasterConfig
        from gsworld_tpu_torch.render.rasterize import render
        self.cfg = RasterConfig(**raster)
        self.device = device
        self.n = truth.num_gaussians
        self.capacity = 2 * self.n
        self.cams = look_at_arc(TRAIN_VIEWS, TRAIN_ARC_DEG, self.cfg.width,
                                self.cfg.height, device)
        posed = PosedGaussians(truth.means, truth.log_scales, truth.quats,
                               truth.logit_opacities)
        with torch.no_grad():
            self.images = [render(posed, c, self.cfg, truth.sh0,
                                  truth.shN)["rgb"] for c in self.cams]
        self.hold = TRAIN_VIEWS // 2
        rng = np.random.default_rng(seed)
        means = truth.means.cpu().numpy()
        self.points = means + rng.normal(scale=5e-3, size=means.shape)
        self.colors = np.clip(truth.sh0.cpu().numpy() * C0 + 0.5
                              + rng.normal(scale=0.02, size=means.shape),
                              0.0, 1.0)

    def split(self):
        """-> (training cameras, training images)."""
        keep = [i for i in range(len(self.cams)) if i != self.hold]
        return [self.cams[i] for i in keep], [self.images[i] for i in keep]


def phase_backward(setup):
    """Backward kernel vs plain version on one frame of the training scene
    at its capacity, with the training path's projection and binning and
    the kernel forward's outputs for both versions; the emit kernel vs its
    plain version on the same frame.  -> (the backward's entry for the
    kernels line, the emit kernel's entry at this shape)."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.render.binning import plan_emit, slot_runs
    from gsworld_tpu_torch.render.rasterize import bin_detached

    cfg = setup.cfg
    dev = setup.device
    flat, _ = train_inputs(setup)
    bins = bin_detached(flat, cfg)
    # the emit kernel at the training path's shape, on the same inputs
    emit_train, sort_train, gaus_e, starts_e = check_emit(
        "3b", "1 training frame", plan_emit(flat, cfg), flat.depth, cfg)
    if not (torch.equal(gaus_e, bins.gaussian)
            and torch.equal(starts_e, bins.starts)):
        raise AssertionError("emit (training frame): the binning path's "
                             "entries differ from the checked ones")
    args = (bins.starts, bins.gaussian, flat.mean2d, flat.conic,
            flat.opacity, flat.color)
    img, T, _, rec = rc.composite_tiles(*args, None, width=cfg.width,
                                        height=cfg.height, tile=cfg.tile,
                                        bg=cfg.bg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    img_ct = torch.randn(img.shape, generator=gen, device=dev)
    T_ct = 0.5 * torch.randn(T.shape, generator=gen, device=dev)
    bwd_args = (*args, img, T, img_ct, T_ct)
    kw = dict(width=cfg.width, height=cfg.height, tile=cfg.tile)
    rows_k = rc.composite_bwd(*bwd_args, **kw, records=rec)
    rows_p = rc.composite_bwd_reference(*bwd_args, **kw)
    torch.cuda.synchronize()
    N = flat.opacity.shape[1]
    runs = slot_runs(bins.ends, bins.order)
    gk = rc.sum_entry_rows(rows_k, bins.perm, *runs)
    gp = rc.sum_entry_rows(rows_p, bins.perm, *runs)
    rel, abs_err = {}, 0.0
    for name, sl in (("mean2d", slice(0, 2)), ("conic", slice(2, 5)),
                     ("color", slice(5, 8)), ("opacity", slice(8, 9))):
        d = float((gk[..., sl] - gp[..., sl]).abs().max())
        rel[name] = d / max(float(gp[..., sl].abs().max()), 1e-30)
        abs_err = max(abs_err, d)
    if not all(v <= BWD_TOL for v in rel.values()):
        raise AssertionError(f"composite_bwd: relative errors {rel} "
                             f"(tolerance {BWD_TOL})")
    live = int(bins.starts[0, -1])
    log(f"phase 3b composite_bwd, 1 frame {cfg.width}x{cfg.height} of "
        f"{N} slots ({live} live entries of E={cfg.max_entries}, overflow "
        f"{int(bins.overflow[0])}): max |kernel - plain| / max |plain| "
        f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} } (tolerance "
        f"{BWD_TOL})")
    ms = cuda_ms(lambda: rc.composite_bwd(*bwd_args, **kw, records=rec),
                 reps=20)
    plain_ms = cuda_ms(lambda: rc.composite_bwd_reference(*bwd_args, **kw),
                       reps=3)
    fwd_ms = cuda_ms(lambda: rc.composite_tiles(*args, None, bg=cfg.bg, **kw),
                     reps=20)
    log(f"phase 3b composite_bwd time: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms (forward kernel on the same frame "
        f"{fwd_ms:.4f} ms)")
    work = composite_work(bins.starts, bins.gaussian, flat, cfg)
    bounds = composite_bounds(work, segment=False)
    log(work_line("3b", work, [("composite_bwd", bounds["bwd"], ms),
                               ("composite", bounds["fwd"], fwd_ms)]))
    bwd_entry = dict(name="composite_bwd", route="cuda",
                     source="gsworld_tpu_torch/csrc/composite_bwd.cu",
                     replaces="gsworld_tpu/render/rasterize_pallas.py:535",
                     max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bounds["bwd"][0], bound_by=bounds["bwd"][1],
                     library_ms=None)
    rows_entry = check_entry_rows(rows_k, bins, N)
    # the backward's parts are added in a fixed order: two calls, one bits
    again = rc.composite_bwd(*bwd_args, **kw, records=rec)
    if not torch.equal(again, rows_k):
        raise AssertionError("composite_bwd: two calls on one input differ")
    log("phase 3b composite_bwd: a second call on the same inputs gives "
        "the same rows bit for bit")
    return bwd_entry, rows_entry, emit_train, sort_train


def check_entry_rows(rows, bins, N):
    """csrc/entry_rows.cu (``sum_entry_rows``) vs its plain version on the
    backward kernel's rows of the training frame, bit for bit (both add
    each Gaussian's rows in slot order); CUDA-event times of both and of
    the one library call that computes the same sums (``index_add_`` by
    Gaussian id, which adds in no fixed order), its result beside ->
    kernels-line entry."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.render.binning import slot_runs
    F, E, K = rows.shape
    runs = slot_runs(bins.ends, bins.order)
    got = rc.sum_entry_rows(rows, bins.perm, *runs)
    want = rc.sum_entry_rows_reference(rows, bins.perm, *runs)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        d = float((got - want).abs().max())
        raise AssertionError(f"sum_entry_rows: kernel vs plain differ "
                             f"(max |diff| {d:.3g}); want bit for bit")
    idx = ((torch.arange(F, device=rows.device) * N)[:, None]
           + bins.gaussian.long().clamp_min(0)).reshape(-1)
    flat_rows = rows.reshape(-1, K)
    acc = torch.zeros((F * N, K), dtype=rows.dtype, device=rows.device)
    lib = torch.zeros_like(acc).index_add_(0, idx, flat_rows).reshape(F, N, K)
    lib_diff = float((lib - got).abs().max()) / max(
        float(got.abs().max()), 1e-30)
    ms = cuda_ms(lambda: rc.sum_entry_rows(rows, bins.perm, *runs),
                 reps=20)
    plain_ms = cuda_ms(
        lambda: rc.sum_entry_rows_reference(rows, bins.perm, *runs), reps=3)
    library_ms = cuda_ms(lambda: acc.index_add_(0, idx, flat_rows), reps=20)
    # each input read once, each output written once
    nbytes = (rows.numel() * 4 + bins.perm.numel() * 4
              + 2 * bins.ends.numel() * 4 + got.numel() * 4)
    bound_ms = 1e3 * nbytes / HBM_RATE
    ends = bins.ends.long()
    cnt = torch.diff(ends, dim=-1, prepend=torch.zeros_like(ends[:, :1]))
    log(f"phase 3b sum_entry_rows, {F} frame of {N} Gaussians, {E} entry "
        f"slots ({int(cnt.sum())} owned, at most {int(cnt.max())} a "
        f"Gaussian): kernel vs plain bit for bit; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms (its "
        f"sums {lib_diff:.3g} of the max from the kernel's); bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at HBM rate; "
        f"{100 * bound_ms / ms:.1f}% of it)")
    return dict(name="sum_entry_rows", route="cuda",
                source="gsworld_tpu_torch/csrc/entry_rows.cu",
                replaces="gsworld_tpu/render/rasterize_pallas.py:779",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms)


def train_params():
    from gsworld_tpu_torch.train3dgs.optim import OptimizationParams
    return OptimizationParams(densify_from_iter=TRAIN_ITERS // 3,
                              densification_interval=TRAIN_ITERS // 3,
                              densify_until_iter=TRAIN_ITERS,
                              opacity_reset_interval=10_000)


def train_run(setup, graph):
    """Phase 5's training through the entry point at full size on the
    card, through one CUDA graph of the train step (``graph``) or eagerly
    -> dict of its results.  The launch counters see the eager run's
    launches, and for the graph run the warm-up steps and the capture
    only (one graph per ``train`` call).  The graph run also counts the
    graph's calls (one replay each: TRAIN_ITERS), and the profiler counts
    the kernels of the TRAIN_PROFILE_STEPS replays after the first
    densify (one emit, one compositor and one backward kernel each, and
    the loss reads); those steps are left out of the step times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gsworld_tpu_torch.real2sim.pipeline import train_from_colmap_model
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.train3dgs.loss import psnr
    from gsworld_tpu_torch.train3dgs.train import render_trainable
    from gsworld_tpu_torch.utils import profiling
    from gsworld_tpu_torch.utils.cuda_graph import FnGraph

    what = "train (graph)" if graph else "train (eager)"
    cams, images = setup.split()
    step_s, densified_at = [], []
    clock = [0.0]
    densify0 = train_params().densify_from_iter
    window = range(densify0 + 1, densify0 + 1 + TRAIN_PROFILE_STEPS)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof_wall = [0.0]

    def on_step(it, state, loss, densified):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_s.append((now - clock[0], densified or it in window))
        if densified:
            densified_at.append((it, int(state.ds.alive.sum())))
        if graph and it == window.start - 1:
            prof.start()
            time.sleep(PROFILE_MARGIN_S)
            prof_wall[0] = time.perf_counter()
        elif graph and it == window.stop - 1:
            prof_wall[0] = now - prof_wall[0]
            time.sleep(PROFILE_MARGIN_S)
            prof.stop()
        clock[0] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rc.reset_launch_counts()
    before = profiling.counters.snapshot()
    clock[0] = t0 = time.perf_counter()
    scene, losses = train_from_colmap_model(
        setup.points, setup.colors, cams, images, setup.cfg,
        params=train_params(), iterations=TRAIN_ITERS,
        capacity=setup.capacity, seed=SEED, device=setup.device,
        callback=on_step, graph=graph)
    wall = time.perf_counter() - t0
    replays = profiling.since(before, profiling.counters.snapshot())
    calls = replays.get("graph.replays/the train step", 0)
    densify_calls = replays.get("graph.replays/the densify pass", 0)
    counts = dict(rc.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        out, _ = render_trainable(
            scene, torch.zeros((scene.num_gaussians, 2), device=setup.device),
            setup.cams[setup.hold], setup.cfg)
        hold_psnr = float(psnr(out, setup.images[setup.hold]))

    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: a loss is not finite")
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    if not last < 0.8 * first:
        raise AssertionError(f"{what}: mean loss of the last 20 iterations "
                             f"{last:.5f} is not below 0.8 x the first 20 "
                             f"{first:.5f}")
    alive = [n for _, n in densified_at]
    if len(densified_at) != 3 or all(n == setup.n for n in alive):
        raise AssertionError(f"{what}: densify ran at {densified_at}, "
                             f"expected 3 passes that change the alive count")
    want = FnGraph.WARMUP + 1 if graph else TRAIN_ITERS
    for name, n in counts.items():
        if n != (0 if name in RENDER_ONLY_KERNELS + PHYSICS_KERNELS
                 else want):
            raise AssertionError(f"{what}: kernel {name} launched {n} times "
                                 f"from the host in {TRAIN_ITERS} iterations "
                                 f"(want {want})")
    if calls != (TRAIN_ITERS if graph else 0) or densify_calls != (
            len(densified_at) if graph else 0):
        raise AssertionError(f"{what}: the train-step graph replayed "
                             f"{calls} times in {TRAIN_ITERS} iterations, "
                             f"the densify graph {densify_calls} times "
                             f"for {len(densified_at)} passes")
    prof_text, per = None, None
    if graph:
        prof_text, per = window_kernels(
            prof, TRAIN_PROFILE_STEPS,
            f"train-step replays after the first densify (iterations "
            f"{window.start}-{window.stop - 1})",
            {"emit_kernel": 1, KERNEL_NAMES["sort_tiles"]: 1,
             "composite_kernel": 1, "composite_bwd_kernel": 1,
             "entry_rows_kernel": 1, "normal_newton_kernel": 0}, 1,
            TRAIN_PROFILE_STEPS, prof_wall[0])
    ms = [1000.0 * dt for dt, skip in step_s[5:] if not skip]
    return dict(scene=scene, losses=losses, counts=counts, peak=peak,
                psnr=hold_psnr, wall=wall, ms=ms, first=first, last=last,
                densified_at=densified_at, replays=calls,
                densify_replays=densify_calls,
                prof_text=prof_text, per_replay=per)


def bits(x):
    """A float32 tensor as its raw bits (int32), any other as it is: two
    are bit for bit alike when torch.equal holds for their bits."""
    import torch
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def scene_bits(scene):
    """Every field of a GaussianScene, float32 ones as their raw bits."""
    from gsworld_tpu_torch.gs.model import SCENE_FIELDS
    return {f: bits(getattr(scene, f)) for f in SCENE_FIELDS}


def runs_alike(a, b):
    """Whether two train runs returned the same losses, held-out PSNR and
    scene, bit for bit -> list of what differs."""
    import torch
    differ = [k for k in ("losses", "psnr") if a[k] != b[k]]
    sa, sb = scene_bits(a["scene"]), scene_bits(b["scene"])
    differ += [f for f in sa if sa[f].shape != sb[f].shape
               or not torch.equal(sa[f], sb[f])]
    return differ


def phase_train(setup):
    """5: 3DGS training through the entry point at full size, through the
    train step's CUDA graph and eagerly in the same call, TRAIN_REPEATS
    times each, alternated: every run, of either form, gives the same
    losses, held-out PSNR and returned scene bit for bit; the graph's calls
    and the profiler's kernels per replay in each graph run; the audit of one
    eager step and densify pass; one step graph vs eager and eager vs
    eager bit for bit; the eager step's kernels by the profiler."""
    every = {True: [], False: []}
    for _ in range(TRAIN_REPEATS):
        for g in (True, False):
            every[g].append(train_run(setup, g))
    for g, xs in every.items():
        for x in xs[1:]:
            differ = runs_alike(xs[0], x)
            if differ:
                raise AssertionError(
                    f"train ({'graph' if g else 'eager'}): two runs from one "
                    f"seed differ in {differ} (held-out PSNR "
                    f"{[y['psnr'] for y in xs]})")
    across = runs_alike(every[True][0], every[False][0])
    if across:
        raise AssertionError(
            f"train: the graph run and the eager run from one seed differ in "
            f"{across} (held-out PSNR {every[True][0]['psnr']!r} through the "
            f"graph, {every[False][0]['psnr']!r} eager)")
    runs = {g: x[0] for g, x in every.items()}
    r = runs[True]
    losses, n_it = r["losses"], TRAIN_ITERS
    parts = []
    for graph, name in ((True, "graph"), (False, "eager")):
        x = runs[graph]
        med = statistics.median(x["ms"])
        parts.append(f"{name} (first run) {x['wall']:.2f} s, {med:.3f} ms "
                     f"per train "
                     f"step (median of {len(x['ms'])} without densify and "
                     f"the profiled steps; min "
                     f"{min(x['ms']):.3f}, max {max(x['ms']):.3f}), held-out "
                     f"PSNR {x['psnr']:.3f} dB, peak memory "
                     f"{x['peak'] / 2**30:.3f} GiB, host launches "
                     f"{x['counts']}")
    cams, _ = setup.split()
    line = (f"phase 5 train: {setup.n} Gaussians (capacity {setup.capacity})"
            f", {len(cams)} views {setup.cfg.width}x{setup.cfg.height} (+1 "
            f"held out), {n_it} iterations: " + "; ".join(parts)
            + f"; {TRAIN_REPEATS} runs of each form, alternated: losses, "
            f"held-out PSNR ({r['psnr']!r} dB through the graph, "
            f"{runs[False]['psnr']!r} eager) and the returned scene bit for "
            f"bit within each form and graph run vs eager run; graph: loss "
            f"{losses[0]:.5f} / "
            f"{losses[n_it // 3 - 1]:.5f} / {losses[2 * n_it // 3 - 1]:.5f} "
            f"/ {losses[-1]:.5f} at iterations 1/{n_it // 3}/"
            f"{2 * n_it // 3}/{n_it} (first 20 mean {r['first']:.5f}, last "
            f"20 {r['last']:.5f}), alive after densify {r['densified_at']} "
            f"-> {r['scene'].num_gaussians} returned")
    log(line)
    prof_line = (f"phase 5 train graph: {r['replays']} calls of the "
                 f"train-step graph and {r['densify_replays']} of the "
                 f"densify graph in {n_it} iterations; {r['prof_text']}")
    log(prof_line)
    audit_line = train_audit(setup, r["scene"])
    step_line = train_step_graph_vs_eager(setup, r["scene"])
    step_line += "; " + densify_graph_vs_eager(setup, r["scene"])
    profile_train(setup, r["scene"])
    return r["counts"], [line, audit_line, step_line, prof_line], \
        r["psnr"], runs[False]["counts"], dict(replays=r["replays"],
                                                per_replay=r["per_replay"])


def _train_state(setup, scene):
    """A fresh TrainState of ``scene`` padded to the setup's capacity."""
    from gsworld_tpu_torch.train3dgs.densify import (init_densify_state,
                                                      pad_scene_capacity)
    from gsworld_tpu_torch.train3dgs.optim import adam_init
    from gsworld_tpu_torch.train3dgs.train import TrainState
    n = scene.num_gaussians
    scene = pad_scene_capacity(scene, setup.capacity)
    return TrainState(scene=scene,
                      ds=init_densify_state(setup.capacity, n, setup.device),
                      opt_state=adam_init(scene), step=0)


def replay_stamps(what, replay, tags, n=3):
    """``replay(i)`` n times under ``utils.profiling.recording()``: the
    stamp ring holds the entry anchor, n times ``tags`` and the exit
    anchor, in that order, at rising device times, none lost; every
    device span positive -> text (mean ms of each span)."""
    from gsworld_tpu_torch.utils import profiling as P
    with P.recording() as rec:
        for i in range(n):
            replay(i)
    e = rec._drain()
    want = ["anchor"] + list(tags) * n + ["anchor"]
    rising = all(int(a) < int(b) for a, b in zip(e.ns, e.ns[1:]))
    dev = rec.device_spans()
    if e.lost or e.tags != want or not rising or any(
            x.start_ns >= x.end_ns for x in dev):
        raise AssertionError(f"{what}: stamps {e.tags} (want {want}), "
                             f"lost {e.lost}, rising {rising}")
    means = {}
    for x in dev:
        means.setdefault(x.name, []).append((x.end_ns - x.start_ns) / 1e6)
    return (f"{n} replays stamped {len(e.tags) - 2} tags in order at rising "
            f"times, none lost (anchor error "
            f"{rec.anchor_error_ns / 1e3:.1f} us; "
            + ", ".join(f"{k} {statistics.fmean(v):.3f} ms"
                        for k, v in means.items()) + ")")


def train_step_graph_vs_eager(setup, scene):
    """One train step from one state (the trained scene after one eager
    step, so that Adam's moments hold a gradient), eagerly twice and
    through the graph: every scene field, Adam moment, densify statistic
    and the loss of the second eager step and of the graph step bit for
    bit the first eager step's -> line."""
    import torch
    from gsworld_tpu_torch.gs.model import SCENE_FIELDS
    from gsworld_tpu_torch.train3dgs.train import make_train_step
    from gsworld_tpu_torch.utils.cuda_graph import clone_tree
    cams, images = setup.split()
    params = train_params()
    base, _, _ = make_train_step(setup.cfg, params, graph=False)(
        _train_state(setup, scene), cams[0], images[0])
    outs = []
    for graph in (False, False, True):
        train_step = make_train_step(setup.cfg, params, graph=graph)
        st, loss, img = train_step(clone_tree(base), cams[1],
                                   images[1])
        torch.cuda.synchronize()
        fields = {f: getattr(st.scene, f) for f in SCENE_FIELDS
                  if getattr(st.scene, f).is_floating_point()}
        fields.update({f"mu.{k}": v for k, v in st.opt_state.mu.items()})
        fields.update({f"nu.{k}": v for k, v in st.opt_state.nu.items()})
        fields.update({f"ds.{k}": getattr(st.ds, k)
                       for k in ("grad_accum", "denom", "max_radii")})
        fields["loss"] = loss.reshape(1)
        fields["image"] = img
        outs.append({k: v.clone() for k, v in fields.items()})
    # the graph step's loss and image are its own: a second replay leaves
    # them as they were
    kept = loss.clone(), img.clone()
    train_step(st, cams[2], images[2])
    torch.cuda.synchronize()
    if not (torch.equal(loss, kept[0]) and torch.equal(img, kept[1])):
        raise AssertionError("train step: the graph step's loss or image "
                             "changed at the next step")
    stamps = replay_stamps(
        "5 train step graph", lambda i: train_step(st, cams[i], images[i]),
        ("train.begin", "train.forward|backward", "train.backward|update",
         "train.end"))

    def differ(a, b):
        """-> {field: max |a - b| / max |b|} of the fields whose bits
        differ."""
        return {k: float((a[k].double() - b[k].double()).abs().max())
                / max(float(b[k].double().abs().max()), 1e-30)
                for k in b if not torch.equal(bits(a[k]), bits(b[k]))}

    spread, gate = differ(outs[1], outs[0]), differ(outs[2], outs[0])
    if spread or gate:
        raise AssertionError(f"train step: eager vs eager differ in "
                             f"{spread}, graph vs eager in {gate} (relative "
                             f"to each field's max); want bit for bit")
    line = (f"phase 5 train step graph vs eager, one step of the trained "
            f"scene at capacity {setup.capacity}: all {len(outs[0])} fields "
            f"(scene, Adam moments, densify statistics, loss, image) of a "
            f"second eager step and of the graph step bit for bit the first "
            f"eager step's; the graph step's loss and image unchanged after "
            f"the next replay; {stamps}")
    log(line)
    return line


def train_audit(setup, scene):
    """The determinism diagnostic: one eager train step and one eager
    densify pass of the trained scene at capacity under
    ``utils.determinism.audit`` (torch.use_deterministic_algorithms(True,
    warn_only=True) and the op audit): every op of the train path with no
    deterministic kernel on the card, or whose kernel adds in no fixed
    order unless that mode is on.  Raises when it names any -> line."""
    import torch
    from gsworld_tpu_torch.train3dgs.densify import densify_and_prune
    from gsworld_tpu_torch.train3dgs.train import make_train_step
    from gsworld_tpu_torch.utils.determinism import OpAudit, audit
    cams, images = setup.split()
    params = train_params()
    state = _train_state(setup, scene)
    step = make_train_step(setup.cfg, params, graph=False)
    mode = OpAudit()
    (state, loss, _), found = audit(
        lambda: step(state, cams[1], images[1]), mode)
    pts = setup.points
    gen = torch.Generator(device=setup.device).manual_seed(SEED)
    _, found_d = audit(lambda: densify_and_prune(
        state.scene, state.ds, gen,
        grad_threshold=params.densify_grad_threshold,
        percent_dense=params.percent_dense,
        scene_extent=float(np.linalg.norm(pts.max(0) - pts.min(0)) / 2.0)
        or 1.0))
    torch.cuda.synchronize()
    if found or found_d or not math.isfinite(float(loss)):
        raise AssertionError(f"train path: ops that are not deterministic "
                             f"on the card: train step {found}, densify "
                             f"{found_d} (loss {float(loss)})")
    line = (f"phase 5 determinism: one eager train step ({mode.ops} aten "
            f"ops) and one densify pass under torch.use_deterministic_"
            f"algorithms(True, warn_only=True) and the op audit: no op "
            f"without a deterministic kernel, no scatter- or index-add, "
            f"accumulating index_put_, convolution or pad backward (the "
            f"hand-written kernels are not aten ops: csrc/ has no atomic "
            f"add)")
    log(line)
    return line


def densify_graph_vs_eager(setup, scene):
    """One densify pass through its CUDA graph (``densify_graph``) against
    the eager pass, from one state (the trained scene at its capacity
    after one eager train step, whose statistics ask for clones and
    splits) with the same split noise: every scene field, the densify
    state and the Adam moments bit for bit; ms of each (host clock to a
    synchronize; the graph's call after its capture) -> text."""
    import torch
    from gsworld_tpu_torch.train3dgs.densify import densify_and_prune
    from gsworld_tpu_torch.train3dgs.optim import zero_rows
    from gsworld_tpu_torch.train3dgs.train import (_write_state,
                                                   densify_graph,
                                                   make_train_step)
    from gsworld_tpu_torch.utils.cuda_graph import clone_tree, tree_map
    cams, images = setup.split()
    params = train_params()
    base, _, _ = make_train_step(setup.cfg, params, graph=False)(
        _train_state(setup, scene), cams[0], images[0])
    pts = setup.points
    kw = dict(grad_threshold=params.densify_grad_threshold,
              percent_dense=params.percent_dense,
              scene_extent=float(np.linalg.norm(
                  pts.max(0) - pts.min(0)) / 2.0) or 1.0)
    eager, graphed = clone_tree(base), clone_tree(base)
    g = densify_graph(graphed, **kw)
    gens = [torch.Generator(device=setup.device).manual_seed(SEED + 31)
            for _ in range(2)]

    def eager_pass():
        sc, ds, changed = densify_and_prune(eager.scene, eager.ds, gens[0],
                                            **kw)
        zero_rows(eager.opt_state, changed)
        _write_state(eager, sc, ds)

    alive0 = int(base.ds.alive.sum())
    t_e, _ = step_ms(eager_pass)
    means = graphed.scene.means
    t_g, _ = step_ms(lambda: g(graphed, torch.randn(
        means.shape, generator=gens[1], dtype=means.dtype,
        device=means.device)))
    leaves = []
    tree_map(leaves.append, (eager, graphed))
    n = len(leaves) // 2
    differ = sum(not torch.equal(a, b) for a, b in zip(leaves[:n],
                                                         leaves[n:]))
    alive = int(graphed.ds.alive.sum())
    if differ or alive == alive0:
        raise AssertionError(f"5 densify: graph vs eager differ in {differ} "
                             f"of {n} tensors; alive {alive0} -> {alive}")
    return (f"one densify pass through its graph vs eager from the trained "
            f"scene after one step (alive {alive0} -> {alive} of "
            f"{setup.capacity}), the same split noise: all {n} tensors of "
            f"the train state (scene, densify state, Adam moments) bit for "
            f"bit; {t_g:.3f} ms through the graph, {t_e:.3f} eager (host "
            f"clock to a synchronize)")


def profile_train(setup, scene):
    """The trained scene's eager train step (padded back to its capacity,
    fresh optimizer state): 3 steps under the profiler by kernel
    (``phase_profile``)."""
    from gsworld_tpu_torch.train3dgs.train import make_train_step
    cams, images = setup.split()
    state = [_train_state(setup, scene)]
    train_step = make_train_step(setup.cfg, train_params(), graph=False)

    def step(i):
        state[0], loss, _ = train_step(state[0], cams[i], images[i])
        float(loss)            # the training loop reads every loss

    phase_profile(5, "train", step)


def phase_small_train():
    """One training step of a small scene on the card against the same
    step on the CPU (plain versions)."""
    import torch
    from gsworld_tpu_torch.gs.model import SCENE_FIELDS
    from gsworld_tpu_torch.real2sim.pipeline import train_from_colmap_model
    raster = dict(BENCH_RASTER, width=160, height=120, max_entries=16384)
    sizes = {k: int(v * 0.01) for k, v in BENCH_SIZES.items()}
    truth = make_renderer("cpu", 1, raster, sizes).scene
    setup = TrainSetup(truth, dict(width=160, height=120), "cpu")
    scenes = []
    for dev in ("cuda", "cpu"):
        cams = look_at_arc(TRAIN_VIEWS, TRAIN_ARC_DEG, 160, 120, dev)
        scene, _ = train_from_colmap_model(
            setup.points, setup.colors, cams[:1], setup.images[:1],
            setup.cfg, params=train_params(), iterations=1, seed=SEED,
            device=dev)
        scenes.append(scene)
    rel = {}
    for f in SCENE_FIELDS:
        a = getattr(scenes[0], f).cpu().double()
        b = getattr(scenes[1], f).double()
        rel[f] = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                  1e-30)
    if not all(v <= STEP_TOL for v in rel.values()):
        raise AssertionError(f"small train step: card vs CPU {rel}")
    log(f"phase 5b small train step ({setup.n} Gaussians, 160x120): card vs "
        f"CPU max |diff| / max |field| "
        f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} } (tolerance "
        f"{STEP_TOL})")


# ---------------------------------------------------------------------- #
# Phase 6: the physics step and the closed loop
# ---------------------------------------------------------------------- #


def make_env(num_envs, device, graph, obs_mode="state_dict",
             env_id="AlignFr3Env-v1", **kw):
    from gsworld_tpu_torch import envs
    return envs.make(env_id, num_envs=num_envs, obs_mode=obs_mode,
                     device=device, graph=graph, **kw)


def seeded_actions(env, n, seed=SEED):
    """``n`` batches of random actions from an explicit generator."""
    import torch
    gen = torch.Generator(device=env.device).manual_seed(seed)
    return [env.action_space_sample(gen) for _ in range(n)]


def world_diff(a, b):
    """Per field of two WorldStates: (bit-for-bit equal, max |a - b|)."""
    import torch
    from gsworld_tpu_torch.physics.world import WORLD_FIELDS
    out = {}
    for f in WORLD_FIELDS:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        out[f] = (torch.equal(x, y), float((x - y).abs().max()))
    return out


def card_vs_cpu(env, cpu_env, a, what):
    """One control step of ``env``'s state on the card and on the CPU:
    positions within PHYS_POS_TOL, velocities within PHYS_VEL_TOL; prints
    every field's difference and what is left of contact_lam's once each
    patch's rows are matched by position (ROADMAP C13)."""
    from gsworld_tpu_torch.physics.world import (world_state_from_numpy,
                                                  world_state_to_numpy)
    start = world_state_to_numpy(env.state.world)
    w_card, _ = env._physics(env.state.world, env.state.prev_target, a)
    w_cpu, _ = cpu_env._physics(
        world_state_from_numpy(start, device="cpu"),
        env.state.prev_target.cpu(), a.cpu())
    d = {f: v[1] for f, v in world_diff(w_card, w_cpu).items()}
    pos_err = max(d["qpos"], d["a_pos"])
    vel_err = max(d["qvel"], d["a_lin"], d["a_ang"])
    if not (pos_err <= PHYS_POS_TOL and vel_err <= PHYS_VEL_TOL):
        raise AssertionError(f"physics: card vs CPU after one control step "
                             f"from {what}: {d}")
    lam_card = w_card.contact_lam.cpu().numpy()
    lam_cpu = w_cpu.contact_lam.numpy()
    matched = match_patch_rows(lam_card, lam_cpu)
    lam_left = float(abs(matched - lam_cpu).max())
    log(f"phase 6a card vs CPU, one control step of {NUM_ENVS} envs from "
        f"{what}: max |diff| qpos/a_pos {pos_err:.3g} (<= {PHYS_POS_TOL}), "
        f"velocities {vel_err:.3g} (<= {PHYS_VEL_TOL}); all fields "
        f"{ {k: float(f'{v:.3g}') for k, v in d.items()} }; contact_lam "
        f"with each patch's rows matched by nearest position: max |diff| "
        f"{lam_left:.3g} of max |lam| {float(abs(lam_cpu).max()):.3g} "
        f"({int((matched != lam_card).any(-1).sum())} rows reordered)")


def match_patch_rows(got, want, R=6):
    """Reorder each contact patch's R rows of ``got`` (B, C, 6) to the
    order of ``want`` by nearest contact position (columns 3-5): rows
    that tie to the last bit may come out of the patch reduction in
    another order on another device."""
    import numpy as np
    Bn, Cn, _ = got.shape
    g = got.reshape(Bn, Cn // R, R, 6)
    w = want.reshape(Bn, Cn // R, R, 6)
    d = np.linalg.norm(w[..., :, None, 3:] - g[..., None, :, 3:], axis=-1)
    idx = d.argmin(axis=-1)
    return np.take_along_axis(g, idx[..., None], axis=2).reshape(got.shape)


def check_finite(world, what):
    import torch
    from gsworld_tpu_torch.physics.world import WORLD_FIELDS
    bad = [f for f in WORLD_FIELDS
           if not bool(torch.isfinite(getattr(world, f)).all())]
    if bad:
        raise AssertionError(f"{what}: non-finite values in {bad}")


def count_kernels(step, n=3):
    """CUDA kernels launched (or replayed from a graph) per call of
    ``step``, by the profiler; None where it shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
    k = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("gsw."))
    return k / n if k else None


def env_graph_vs_eager(B, what, **kw):
    """``env.step`` of a ``graph=True`` env against a ``graph=False`` env
    (``kw`` to both) from reset(SEED + 3) with GRAPH_STEPS seeded actions
    (``graph_steps_vs_eager``) -> (eager env, graphed env, actions)."""
    eager = make_env(B, "cuda", False, **kw)
    graphed = make_env(B, "cuda", True, **kw)
    actions = seeded_actions(eager, GRAPH_STEPS, seed=SEED + 7)
    eager.reset(seed=SEED + 3)
    graphed.reset(seed=SEED + 3)
    graph_steps_vs_eager(graphed.step, eager.step, actions, what,
                         lambda: graphed.state, lambda: eager.state)
    if "step" not in graphed._graphs:
        raise AssertionError(f"{what}: stepped without a captured graph")
    return eager, graphed, actions


def physics_steps(B, graph, **kw):
    """reset(SEED), two warm-up steps, then PHYS_STEPS (EAGER_STEPS
    without ``graph``) timed env.step of seeded random actions -> (env, ms
    per step, peak bytes, kernels per step).  ``kw`` go to the env
    (another control mode)."""
    import torch
    env = make_env(B, "cuda", graph, **kw)
    actions = seeded_actions(env, PHYS_STEPS if graph else EAGER_STEPS)
    env.reset(seed=SEED)
    for a in actions[:2]:
        env.step(a)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for a in actions:
        t0 = time.perf_counter()
        env.step(a)
        torch.cuda.synchronize()
        ms.append(1000.0 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    check_finite(env.state.world, f"physics B={B}")
    kernels = count_kernels(lambda i: env.step(actions[i]))
    return env, ms, peak, kernels


def phase_newton():
    """6n: the normal Newton kernel vs its plain version at the benchmark
    cells' shapes (``tools/solve_times.newton_times``) -> (the kernel's
    entry for the kernels line, its lines)."""
    from gsworld_tpu_torch.tools import solve_times
    rows = solve_times.newton_times(seed=SEED)
    lines = [f"phase 6n {solve_times.newton_line(r)}" for r in rows]
    for line in lines:
        log(line)
    # the seeded systems at 64 envs: the plain version's bits; at one env
    # and on the shifted all-rows systems (whose last product the plain
    # version sums in an order not fitted in a few envs): an LCP residual
    # as small as the plain version's; on the redundant all-rows systems,
    # which neither side resolves in 7 steps, timing and x >= 0 only
    def off(r):
        if r["systems"] == "seeded" and r["B"] > 1:
            return r["max_rel_err"] != 0.0
        if r["systems"] == "all rows":     # 7 steps resolve neither side
            return not r["finite_nonneg"]
        return r["res_median"] > NEWTON_RES_RATIO * max(
            NEWTON_RES_FLOOR, r["plain_res_median"])

    bad = [r for r in rows if off(r)]
    if bad:
        raise AssertionError(f"normal_newton off the plain version: {bad}")
    seeded = [r for r in rows if r["systems"] == "seeded"]
    e64 = next(r for r in seeded if r["shape"] == "e64")
    entry = dict(name="normal_newton", route="cuda",
                 source="gsworld_tpu_torch/csrc/contact_newton.cu",
                 replaces="none (physics/world.py's normal stage: "
                          "cuSOLVER potrf + cuBLAS trsm; XLA in JAX)",
                 max_rel_err=max(r["max_rel_err"] for r in seeded),
                 ms=e64["ms"], call_ms=e64["call_ms"],
                 plain_ms=e64["library_ms"],
                 library_ms=e64["library_ms"],
                 library_graph_ms=e64["library_graph_ms"],
                 bound_ms=e64["bound_ms"],
                 bound_by="f32", shapes=rows)
    return entry, lines


def phase_physics():
    """6a: the physics step alone, eager and through its CUDA graph."""
    import torch
    from gsworld_tpu_torch.physics.world import contact_row_count
    lines = []
    for B in PHYS_ENVS:
        res = {}
        for graph in (False, True):
            res[graph] = physics_steps(B, graph)
        env = res[True][0]
        if "step" not in env._graphs:
            raise AssertionError("physics: graph=True stepped without a "
                                 "captured graph")
        rows = contact_row_count(env.scene)
        parts = []
        for graph, name in ((False, "eager"), (True, "graph")):
            _, ms, peak, kernels = res[graph]
            med = statistics.median(ms)
            parts.append(
                f"{name} {med:.3f} ms per control step (median of "
                f"{len(ms)}; min {min(ms):.3f}, max {max(ms):.3f}), "
                f"{1000.0 * B / med:.1f} env-steps/s, "
                + ("kernels per step not measured" if kernels is None
                   else f"{kernels:.0f} kernels per step")
                + f", peak memory {peak / 2**30:.3f} GiB")
        line = (f"phase 6a env step (physics, observation, reward), "
                f"AlignFr3Env-v1, {B} envs, {rows} contact rows, "
                f"{env.scene.substeps} substeps: " + "; ".join(parts))
        log(line)
        lines.append(line)
        if B == NUM_ENVS:
            keep = res

    # ---- graph vs eager, bit for bit, from the same state and actions
    eager, graphed, actions = env_graph_vs_eager(NUM_ENVS, "6a env step")
    log(f"phase 6a graph vs eager, {NUM_ENVS} envs, {GRAPH_STEPS} env.step "
        f"calls (the whole step through its graph) from one state and the "
        f"same actions: every tensor each step returns (observation, "
        f"reward, flags, info), every WorldState field, prev_target and "
        f"the task state bit for bit after every step; step k's outputs "
        f"unchanged after step k + 1")

    # ---- one control step, card vs CPU, from the same state; and from
    # the state PR 5 read its contact_lam gap on (its episode drawn by the
    # card's generator, then the same 10 steps)
    cpu_env = make_env(NUM_ENVS, "cpu", False)
    card_vs_cpu(eager, cpu_env, actions[0],
                f"the state after {GRAPH_STEPS} steps")
    old = make_env(NUM_ENVS, "cuda", False)
    old._state = old._reset_fn(torch.rand(
        (NUM_ENVS, old.episode_draws), device="cuda",
        generator=torch.Generator("cuda").manual_seed(SEED + 3)))[0]
    for a in actions:
        old.step(a)
    card_vs_cpu(old, cpu_env, actions[0],
                f"PR 5's state (episode from the card's generator, "
                f"{GRAPH_STEPS} steps)")

    # ---- profile by kernel, eager and through the graph
    env_e, env_g = keep[False][0], keep[True][0]
    acts = seeded_actions(env_e, 3, seed=SEED + 11)
    phase_profile("6a", "env_step_eager", lambda i: env_e.step(acts[i]))
    phase_profile("6a", "env_step_graph", lambda i: env_g.step(acts[i]))
    return lines


def phase_rest():
    """6b: 40 zero-action steps; the world must come to rest."""
    import torch
    from gsworld_tpu_torch import constants
    env = make_env(NUM_ENVS, "cuda", True)
    env.reset(seed=SEED)
    zero = torch.zeros(env.action_dim, device=env.device)
    for _ in range(REST_STEPS):
        env.step(zero)
    w = env.state.world
    check_finite(w, "rest")
    speed = float(torch.linalg.norm(w.a_lin[:, :2], dim=-1).max())
    z = w.a_pos[:, :2, 2].cpu()
    want = torch.tensor([env.green_half_height, env.red_half_height])
    z_err = float((z - want).abs().max())
    q0 = torch.as_tensor(constants.fr3_umi_task_init_qpos[:7])
    arm_err = float((w.qpos[:, :7].cpu() - q0).abs().max())
    force = float(w.la_forces.abs().max())
    if not (speed < 0.05 and z_err <= 2e-3 and arm_err <= 2e-3
            and force == 0.0):
        raise AssertionError(f"rest: can speed {speed:.3g} m/s, |z - half "
                             f"height| {z_err:.3g} m, arm drift "
                             f"{arm_err:.3g} rad, pair force {force:.3g} N")
    log(f"phase 6b rest, {NUM_ENVS} envs after {REST_STEPS} zero-action "
        f"steps: can speed {speed:.3g} m/s (< 0.05), |z - half height| "
        f"{z_err:.3g} m (<= 2e-3), arm within {arm_err:.3g} rad of its "
        f"init pose (<= 2e-3), pair forces {force:.3g} N, all finite")


def loop_steps(wrapper, n, seed=SEED):
    """``n`` eager closed-loop steps timed in two parts by CUDA events
    (the env's ``_step_fn``, then the render; a graph replay cannot be
    split): -> (physics ms, render ms) medians, last obs."""
    import torch
    env = wrapper.env
    gen = torch.Generator(device=env.device).manual_seed(seed)
    phys, rend = [], []
    for _ in range(n):
        a = env.action_space_sample(gen)
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        (env._state, obs, *_rest) = env._step_fn(env._state, a)
        e[1].record()
        obs = dict(obs)
        obs["sensor_data"] = wrapper._render_fn(env._state)
        e[2].record()
        e[2].synchronize()
        phys.append(e[0].elapsed_time(e[1]))
        rend.append(e[1].elapsed_time(e[2]))
    return statistics.median(phys), statistics.median(rend), obs


def phase_closed_loop():
    """6c: the closed loop through rollout.random_actions: eager
    (graph=False), through the wrapper's CUDA graph (``step``: one replay
    per step) and scanned (``use_scan=True``: the same graph replayed
    with no host read between steps)."""
    import gc
    import torch
    lines, counts4, scan4 = [], None, None
    for B, steps in ((NUM_ENVS, LOOP_STEPS), (1, LOOP_STEPS),
                     (64, LOOP_STEPS_64)):
        t0 = time.perf_counter()
        env, wrapper = bench_build("AlignFr3Env-v1", B, "fr3_align")
        counts, text, _, ms = timed_loop(wrapper, f"closed loop B={B}",
                                         steps)
        scan_ms, scan_text, scan_counts = scanned_loop(
            wrapper, f"scanned loop B={B}", steps)
        cam = env.cameras[0]
        line = (f"phase 6c closed loop, {B} envs x {len(env.cameras)} cams "
                f"{cam.width}x{cam.height}, {steps} steps: {text}; "
                f"{scan_text}; ms per step eager / graph / scanned "
                f"{ms['eager']:.3f} / {ms['graph']:.3f} / {scan_ms:.3f} "
                f"(built, warmed and run in "
                f"{time.perf_counter() - t0:.1f} s)")
        log(line)
        lines.append(line)
        if B == NUM_ENVS:
            counts4, scan4 = counts, scan_counts
            check_frames_follow_state(wrapper)
            for graph in (False, True):
                env.graph = graph
                phase_profile("6c", "closed_loop_"
                              + ("graph" if graph else "eager"),
                              lambda i: wrapper.step(
                                  env.action_space_sample()))
            line = (f"phase 6c graph vs eager, {B} envs: "
                    + graph_vs_eager(wrapper, "6c closed loop"))
            log(line)
            lines.append(line)
            env.graph = True
            line = (f"phase 6c stamps of the closed-loop step graph, {B} "
                    f"envs: " + replay_stamps(
                        "6c closed-loop step graph",
                        lambda i: wrapper.step(env.action_space_sample()),
                        ("loop.begin", "loop.physics|render", "loop.end")))
            log(line)
            lines.append(line)
            reset_text, reset4 = reset_render_vs_eager(wrapper,
                                                       "6c closed loop")
            line = f"phase 6c reset and render, {B} envs: {reset_text}"
            log(line)
            lines.append(line)
        shared = graphs_reserved(env, wrapper) if B == 64 else None
        del env, wrapper
        gc.collect()
        torch.cuda.empty_cache()
        if shared:
            line = graph_pool_memory(B, shared)
            log(line)
            lines.append(line)
    scan4["reset_per_replay"] = reset4
    return counts4, scan4, lines


def graphs_reserved(env, wrapper):
    """``memory_reserved`` and ``memory_allocated`` once the wrapper's
    step, reset and render graphs are all captured, the cache's free
    blocks released."""
    import torch
    if "reset" not in wrapper._graphs:
        wrapper.reset(seed=SEED)
    if "step" not in wrapper._graphs:
        wrapper.step(env.action_space_sample())
    wrapper.render_current_step()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(), torch.cuda.memory_allocated()


def graph_pool_memory(B, shared):
    """6c at ``B`` envs: ``graphs_reserved`` of the 6c wrapper (``shared``:
    its graphs share the env's pool, ``graph_pool``) beside that of a
    fresh wrapper whose graphs each have a pool of their own (its env's
    ``graph_pool`` replaced by one that gives None) -> the phase's line."""
    import gc
    import torch
    t0 = time.perf_counter()
    env, wrapper = bench_build("AlignFr3Env-v1", B, "fr3_align")
    env.graph_pool = lambda: None
    own = graphs_reserved(env, wrapper)
    del env, wrapper
    gc.collect()
    torch.cuda.empty_cache()
    return (f"phase 6c graph memory, {B} envs, the step, reset and render "
            f"graphs captured: {shared[0] / 2**30:.3f} GiB reserved "
            f"({shared[1] / 2**30:.3f} allocated) with one pool for the "
            f"wrapper's graphs, {own[0] / 2**30:.3f} GiB reserved "
            f"({own[1] / 2**30:.3f} allocated) with a pool for each graph "
            f"({time.perf_counter() - t0:.1f} s)")


def check_frames_follow_state(wrapper):
    """The render reads the stepped state: move the green can of env 0 by
    5 cm and env 0's frames change, while the other envs' stay as they
    were."""
    import torch
    env = wrapper.env
    def both():
        out = wrapper.render_current_step()
        return torch.cat([out[c.name]["rgb"] for c in env.cameras], dim=1)

    before = both().clone()
    w = env.state.world
    a_pos = w.a_pos.clone()
    a_pos[0, 0, 1] -= 0.05
    env._state = env.state.replace(world=w.replace(a_pos=a_pos))
    after = both()
    env._state = env.state.replace(world=w)
    changed = (before != after).any(dim=-1).flatten(1).sum(dim=1)
    if not (int(changed[0]) > 200 and int(changed[1:].sum()) == 0):
        raise AssertionError(f"closed loop: pixels changed per env after "
                             f"moving env 0's can: {changed.tolist()}")
    log(f"phase 6c frames follow the state: moving env 0's green can by "
        f"5 cm changes {int(changed[0])} pixels of its two frames and none "
        f"of the other envs'")


# ---------------------------------------------------------------------- #
# Phase 6d: end-effector control, the other tasks, the xArm closed loop
# ---------------------------------------------------------------------- #


def phase_ee_modes():
    """6d: AlignFr3Env-v1 at 4 envs in both end-effector modes (IK inside
    the captured step): eager and graph steps, graph vs eager bit for bit
    (everything the step returns, every state field), one step card vs
    CPU; the closed loop in pd_ee_delta_pose through the wrapper's graph
    against graph=False (``graph_vs_eager``)."""
    import torch
    from gsworld_tpu_torch.physics.world import (world_state_from_numpy,
                                                  world_state_to_numpy)
    lines = []
    for mode in EE_MODES:
        res = {g: physics_steps(NUM_ENVS, g, control_mode=mode)
               for g in (False, True)}
        if "step" not in res[True][0]._graphs:
            raise AssertionError(f"{mode}: stepped without a captured graph")
        parts = []
        for graph, name in ((False, "eager"), (True, "graph")):
            _, ms, peak, kernels = res[graph]
            med = statistics.median(ms)
            parts.append(
                f"{name} {med:.3f} ms per control step (median of {len(ms)}; "
                f"min {min(ms):.3f}, max {max(ms):.3f}), "
                + ("kernels per step not measured" if kernels is None
                   else f"{kernels:.0f} kernels per step")
                + f", peak memory {peak / 2**30:.3f} GiB")
        eager, _, actions = env_graph_vs_eager(NUM_ENVS, f"6d {mode}",
                                               control_mode=mode)
        cpu_env = make_env(NUM_ENVS, "cpu", False, control_mode=mode)
        start = world_state_to_numpy(eager.state.world)
        w_card, t_card = eager._physics(
            eager.state.world, eager.state.prev_target, actions[0])
        w_cpu, t_cpu = cpu_env._physics(
            world_state_from_numpy(start, device="cpu"),
            eager.state.prev_target.cpu(), actions[0].cpu())
        d = {f: v[1] for f, v in world_diff(w_card, w_cpu).items()}
        tgt_err = float((t_card.cpu() - t_cpu).abs().max())
        pos_err = max(d["qpos"], d["a_pos"], tgt_err)
        vel_err = max(d["qvel"], d["a_lin"], d["a_ang"])
        if not (pos_err <= PHYS_POS_TOL and vel_err <= PHYS_VEL_TOL):
            raise AssertionError(f"{mode}: card vs CPU, targets {tgt_err}, "
                                 f"{d}")
        line = (f"phase 6d EE mode {mode}, AlignFr3Env-v1, {NUM_ENVS} envs "
                f"(12 IK steps inside the step): " + "; ".join(parts)
                + f"; graph vs eager {GRAPH_STEPS} steps bit for bit in "
                f"every tensor each step returns and every state field "
                f"(WorldState, prev_target, task), step k's outputs "
                f"unchanged after step k + 1; card vs CPU one "
                f"step: targets {tgt_err:.3g}, qpos/a_pos "
                f"{max(d['qpos'], d['a_pos']):.3g} (<= {PHYS_POS_TOL}), "
                f"velocities {vel_err:.3g} (<= {PHYS_VEL_TOL})")
        log(line)
        lines.append(line)
    # the closed loop in an EE mode: the wrapper's graph holds the IK
    env, wrapper = bench_build("AlignFr3Env-v1", NUM_ENVS, "fr3_align",
                               control_mode=EE_MODES[-1])
    line = (f"phase 6d EE mode {EE_MODES[-1]} closed loop, {NUM_ENVS} envs "
            f"x {len(env.cameras)} cams 640x480: "
            + graph_vs_eager(wrapper, f"6d {EE_MODES[-1]} closed loop"))
    log(line)
    lines.append(line)
    del env, wrapper
    torch.cuda.empty_cache()
    return lines


def speed_ties(world):
    """(B,) envs where an actor's speed lands on actor_is_static's
    threshold, which is also the solver's depenetration speed cap: there
    a "static" flag is decided by the last bit."""
    import torch
    speed = torch.linalg.norm(world.a_lin.cpu(), dim=-1)
    return ((speed - STATIC_LIN).abs() < 1e-6).any(dim=-1)


def compare_info(card, cpu, ties, what):
    """Evaluate flags equal (a "static" flag and success excused only in
    an env in ``ties``); numbers to 1e-4 of their largest value.
    -> number of excused flags."""
    import torch
    excused = 0
    for k, v in cpu.items():
        c = card[k].cpu()
        if v.dtype == torch.bool:
            diff = c != v
            if ("static" in k or k == "success") and not (diff & ~ties).any():
                excused += int(diff.sum())
            elif diff.any():
                raise AssertionError(f"{what}: flag {k} card {c.tolist()} "
                                     f"CPU {v.tolist()}")
        elif float((c - v).abs().max()) > 1e-4 * max(
                float(v.abs().max()), 1.0):
            raise AssertionError(f"{what}: {k} card {c.tolist()} CPU "
                                 f"{v.tolist()}")
    return excused


def phase_tasks():
    """6d: every other registered task at 4 envs: reset(seed) on the card
    equals reset(seed) on the CPU bit for bit; 3 control steps (the card
    through its graph) against the CPU; flags and task state agree."""
    import torch
    lines = []
    for env_id in OTHER_TASKS:
        card = make_env(NUM_ENVS, "cuda", True, env_id=env_id)
        cpu = make_env(NUM_ENVS, "cpu", False, env_id=env_id)
        card.reset(seed=SEED)
        cpu.reset(seed=SEED)
        for f in ("a_pos", "a_quat", "qpos", "root_pos"):
            if not torch.equal(getattr(card.state.world, f).cpu(),
                               getattr(cpu.state.world, f)):
                raise AssertionError(f"{env_id}: reset(seed) {f} differs "
                                     f"between the card and the CPU")
        actions = seeded_actions(cpu, TASK_STEPS, seed=SEED + 5)
        excused = 0
        for a in actions:
            out_card = card.step(a.cuda())
            out_cpu = cpu.step(a)
            excused += compare_info(out_card[4], out_cpu[4],
                                    speed_ties(cpu.state.world), env_id)
        d = {f: v[1] for f, v in world_diff(card.state.world,
                                            cpu.state.world).items()}
        pos_err = max(d["qpos"], d["a_pos"])
        vel_err = max(d["qvel"], d["a_lin"], d["a_ang"])
        if not (pos_err <= PHYS_POS_TOL and vel_err <= PHYS_VEL_TOL):
            raise AssertionError(f"{env_id}: card vs CPU after "
                                 f"{TASK_STEPS} steps {d}")
        task = {}
        for k, v in cpu.state.task.items():
            c = card.state.task[k].cpu()
            err = (0.0 if v.dtype == torch.bool and torch.equal(c, v)
                   else float((c.float() - v.float()).abs().max()))
            if err > 1e-6:
                raise AssertionError(f"{env_id}: task state {k} card "
                                     f"{c.tolist()} CPU {v.tolist()}")
            task[k] = err
        if "step" not in card._graphs:
            raise AssertionError(f"{env_id}: no captured graph on the card")
        line = (f"phase 6d task {env_id}, {NUM_ENVS} envs: reset(seed) card "
                f"== CPU bit for bit (a_pos, a_quat, qpos, root_pos); after "
                f"{TASK_STEPS} control steps (card through its graph) max "
                f"|diff| qpos/a_pos {pos_err:.3g}, velocities {vel_err:.3g}; "
                f"evaluate flags equal ({excused} static flags excused at "
                f"the 0.05 m/s speed tie); task state max |diff| {task}")
        log(line)
        lines.append(line)
    return lines


def phase_xarm_loop():
    """6d: AlignXArmEnv-v1 with domain randomization, rgb+segmentation,
    4 envs x 2 cameras 640x480, the xarm6_align synthetic scene at the
    bench sizes and raster, through rollout.random_actions."""
    t0 = time.perf_counter()
    env, wrapper = bench_build("AlignXArmEnv-v1", NUM_ENVS, "xarm6_align",
                               domain_randomization=True)
    counts, text, _, ms = timed_loop(wrapper, "xArm loop")
    if set(env.state.task) != {"obj_color", "cam_pose_noise"}:
        raise AssertionError(f"xArm loop: task state {set(env.state.task)}")
    scan_ms, scan_text, scan_counts = scanned_loop(
        wrapper, "xArm scanned loop", LOOP_STEPS)
    cam = env.cameras[0]
    line = (f"phase 6d xArm closed loop, AlignXArmEnv-v1 with domain "
            f"randomization, {NUM_ENVS} envs x {len(env.cameras)} cams "
            f"{cam.width}x{cam.height}, {wrapper.renderer.scene.num_gaussians}"
            f" Gaussians, {LOOP_STEPS} steps: {text}; {scan_text}; ms per "
            f"step eager / graph / scanned {ms['eager']:.3f} / "
            f"{ms['graph']:.3f} / {scan_ms:.3f} (built, warmed and run in "
            f"{time.perf_counter() - t0:.1f} s)")
    log(line)
    scan_line = ("phase 6d xArm graph vs eager (tint and camera noise "
                 "inside the graph): " + graph_vs_eager(
                     wrapper, "6d xArm closed loop", tint=True))
    log(scan_line)
    reset_line = ("phase 6d xArm reset and render (tint and camera noise "
                  "inside the graphs): " + reset_render_vs_eager(
                      wrapper, "6d xArm closed loop")[0])
    log(reset_line)
    return (dict(counts, per_replay=scan_counts["per_replay"]),
            [line, scan_line, reset_line], wrapper)


def check_tint(wrapper):
    """6d: zero tint on env 0's objects changes only pixels an object's
    Gaussians reach (lit in a render with every other Gaussian black),
    never the segmentation, and no other env's pixels."""
    import torch
    from gsworld_tpu_torch import constants
    from gsworld_tpu_torch.render.rasterize import render_projected
    from gsworld_tpu_torch.wrapper.gs_env import world_poses
    r, st = wrapper.renderer, wrapper.env.state
    poses = world_poses(st.world, st.task)
    cfg = r.raster_config
    hw = (cfg.height, cfg.width)
    with torch.no_grad():
        def frame(tint):
            flat, lead = render_inputs(r, poses, tint)
            img, _, seg, _ = render_projected(flat, cfg, r.scene.semantics)
            return img.reshape(lead + hw + (3,)), seg.reshape(lead + hw)

        before, seg0 = frame(r.slot_tint(poses.obj_color))
        color = poses.obj_color.clone()
        color[0] = 0.0
        after, seg1 = frame(r.slot_tint(color))
        is_obj = torch.zeros(r.layout.num_slots, device=color.device)
        is_obj[r.obj_slot] = 1.0
        lit, _ = frame(is_obj[None, :, None].expand(NUM_ENVS, -1, 3))
    reached = lit.sum(-1) > 0
    changed = (before != after).any(-1)
    ids = torch.tensor([constants.obj_gs_semantics[n] for n in r.gs_objects],
                       device=seg0.device)
    on_obj = torch.isin(seg0.long(), ids)
    outside = int((changed[0] & ~reached[0]).sum())
    if (changed[1:].any() or outside or not torch.equal(seg0, seg1)
            or not changed[0].any()):
        raise AssertionError(f"tint: changed pixels per env "
                             f"{changed.flatten(1).sum(1).tolist()}, "
                             f"{outside} outside the objects' reach")
    log(f"phase 6d tint: zero tint on env 0's objects changes "
        f"{int(changed[0].sum())} of its pixels, all reached by an object "
        f"Gaussian ({int(reached[0].sum())} reached; "
        f"{int((changed[0] & on_obj[0]).sum())} of the changed carry an "
        f"object's segmentation id, {int((changed[0] & ~on_obj[0]).sum())} "
        f"the background's); segmentation and the other envs bit for bit")


# ---------------------------------------------------------------------- #
# Phase 7: real-scan scenes and the real2sim toolchain
# ---------------------------------------------------------------------- #


def write_config_scans(splats, cfg_path, asset_dir):
    """Write the splat dict ``splats`` as the scans that the scene config
    ``cfg_path`` names, under ``asset_dir``: an entry with a scalar label
    gets the Gaussians of that label (a PLY without semantics), an entry
    with an ``.npy`` label file the others (labels in the PLY and the
    ``.npy``).  -> the merged scene's Gaussians as indices into
    ``splats``, in the order the config puts them."""
    import numpy as np
    from gsworld_tpu_torch.gs.merge import load_scene_config
    from gsworld_tpu_torch.gs.ply import save_splats_to_ply
    entries = load_scene_config(cfg_path)
    sem = np.asarray(splats["semantics"])
    scalar = [int(e["semantic_labels"]) for e in entries
              if isinstance(e.get("semantic_labels"), (int, float))]
    rest = np.flatnonzero(~np.isin(sem, scalar))
    order = []
    for e in entries:
        lab = e.get("semantic_labels")
        is_scalar = isinstance(lab, (int, float))
        idx = np.flatnonzero(sem == int(lab)) if is_scalar else rest
        part = {k: np.asarray(v)[idx] for k, v in splats.items()}
        save_splats_to_ply(part, os.path.join(asset_dir, e["data_path"]),
                           with_semantics=not is_scalar)
        if isinstance(lab, str):
            np.save(os.path.join(asset_dir, lab), part["semantics"])
        order.append(idx)
    return np.concatenate(order)


def bench_build(env_id, num_envs, cfg_name, device="cuda", raster=None,
                synthetic_scale=1.0, **kw):
    """rollout.random_actions.build at the bench configuration
    (rgb+segmentation, sim 120 / control 40 Hz, BENCH_RASTER unless
    ``raster`` is given; ``kw``: ``asset_dir``, ``cfg_dir``, the env's
    own) -> (env, wrapper)."""
    from gsworld_tpu_torch.rollout.random_actions import build
    r = raster or BENCH_RASTER
    return build(env_id, num_envs, cfg_name, 120, 40, r["width"],
                 r["height"], synthetic_scale=synthetic_scale,
                 obs_mode="rgb+segmentation", tile=r["tile"],
                 max_tiles_per_gaussian=r["max_tiles_per_gaussian"],
                 max_entries=r["max_entries"], device=device, **kw)


def frames_of(obs):
    """(rgb, segmentation) of every camera of ``obs``, side by side."""
    import torch
    sd = obs["sensor_data"]
    return (torch.cat([sd[c]["rgb"] for c in sorted(sd)], dim=2),
            torch.cat([sd[c]["segmentation"] for c in sorted(sd)], dim=2))


def timed_loop(wrapper, what, steps=None):
    """rollout_fps over ``steps`` closed-loop steps (LOOP_STEPS unless
    given; at most EAGER_STEPS eager), first eager (``graph=False``: one
    preprocess, emit and compositor launch and ``newton_per_step``
    normal_newton launches per step on the launch counters),
    then through the wrapper's
    CUDA graph (the env's ``graph=True``: the capture in the warm-up, one
    replay per step, no counter moves in the timed steps, and the
    profiler counts one preprocess, emit and compositor kernel and
    ``newton_per_step`` normal_newton kernels per replay), each with its
    peak memory; frames of the cameras' shape, a
    finite state;
    then up to 10 further steps of the eager step's two parts (a replay
    cannot be split) timed by CUDA events, whose observation is checked
    -> (launch counts of the eager run, text for the phase's line, the
    last observation, {"eager": ms per step, "graph": ms per step})."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.rollout.random_actions import rollout_fps
    steps = steps or LOOP_STEPS
    env = wrapper.env
    B, cam = env.num_envs, env.cameras[0]

    def timed_start():
        # after the reset and the warm-up steps (graph capture, first
        # renders), just before the timed steps
        torch.cuda.reset_peak_memory_stats()
        rc.reset_launch_counts()

    runs, graph0 = {}, env.graph
    for graph in (False, True):
        env.graph = graph
        n = steps if graph else min(steps, EAGER_STEPS)
        fps, spf, frames = rollout_fps(wrapper, n, seed=SEED, warmup=2,
                                       on_timed_start=timed_start)
        counts = dict(rc.launch_counts)
        per_step = dict.fromkeys(RENDER_KERNELS, 1)
        per_step["normal_newton"] = newton_per_step(env)
        for name, k in per_step.items():
            if counts[name] != (0 if graph else k * n):
                raise AssertionError(
                    f"{what} ({'graph' if graph else 'eager'}): kernel "
                    f"{name} launched {counts[name]} times from the host in "
                    f"{n} steps")
        if frames.shape != (B, cam.height, cam.width, 3) \
                or frames.dtype.name != "uint8":
            raise AssertionError(f"{what}: frames {frames.shape} "
                                 f"{frames.dtype}")
        runs[graph] = (fps, 1000.0 * spf, counts,
                       torch.cuda.max_memory_allocated(),
                       torch.cuda.max_memory_reserved())
    check_finite(env.state.world, what)
    overflow = int(wrapper.renderer.last_overflow.sum())
    prof_text = step_kernels(wrapper, what)
    env.graph = graph0
    n = min(steps, 10)
    phys_ms, rend_ms, obs = loop_steps(wrapper, n)
    check_outputs(obs["sensor_data"], B, cam.height, cam.width,
                  ids_per_camera=False)
    parts = [f"{name} {fps:.2f} env-steps/s, {ms:.3f} ms per step, peak "
             f"memory {peak / 2**30:.3f} GiB allocated "
             f"({reserved / 2**30:.3f} reserved)"
             for name, (fps, ms, _, peak, reserved) in (
                 ("eager (graph=False)", runs[False]),
                 ("graph (one replay per step)", runs[True]))]
    text = ("; ".join(parts)
            + f" (host clock over {min(steps, EAGER_STEPS)} eager and "
            f"{steps} graph steps, each run ended by a synchronize and a "
            f"host read); graph / eager "
            f"{runs[True][1] / runs[False][1]:.3f}; launches "
            f"{runs[False][2]} in the eager steps, none in the "
            f"graph's; {prof_text}; eager step by CUDA events physics + "
            f"observation {phys_ms:.3f} ms, render {rend_ms:.3f} ms "
            f"(medians of {n} further steps); overflow {overflow} entries "
            f"in the last step")
    return runs[False][2], text, obs, {"eager": runs[False][1],
                                       "graph": runs[True][1]}


def replay_kernels(run, calls, what, names=REPLAY_KERNELS,
                   per_call=1, d2h=0, check=None):
    """torch.profiler over ``run()``, which makes ``calls`` calls that
    replay CUDA graphs (scanned steps, steps, sharded steps): exactly
    ``names[name] * per_call`` kernels named with each ``name`` per call
    (``names`` {name: count}, or names of one each), and ``d2h`` copies
    from the device to the host in all (None: any number, printed); a
    window that shows another count raises.
    The launch counters do not see replays.  ``check(out)``, when given, holds what the replays
    returned against eager steps -> (equal, text): unequal raises, and a
    wrong count's error says whether the outputs were right (the
    profiler lost a kernel's record) or not (a replay did not run).  The
    window keeps PROFILE_MARGIN_S of host idle time at each edge, so that
    no kernel lies near an edge (the profiler keeps only what lies inside
    its window) -> (text, what ``run`` returned, {name: kernels per
    call})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
    equal, check_text = check(out) if check else (True, None)
    text, per = window_kernels(prof, calls, what, names, per_call, d2h,
                               wall, check_text)
    if not equal:
        raise AssertionError(f"{what}: {check_text}")
    return text, out, per


def window_kernels(prof, calls, what, names, per_call, d2h, wall,
                   note=None):
    """The gate and line of a profiler window over ``calls`` graph
    replays (``replay_kernels``) -> (text, {name: kernels per call})."""
    from torch.autograd import DeviceType
    kern = {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("gsw.")}

    def count(word):
        return sum(c for k, (c, _) in kern.items() if word in k)

    want = {w: per_call * (names[w] if isinstance(names, dict) else 1)
            for w in names}
    got = {w: count(w) for w in want}
    copies = count("DtoH")
    if any(got[w] != want[w] * calls for w in want) or (
            d2h is not None and copies != d2h):
        raise AssertionError(f"{what}: {calls} calls ran kernels {got} "
                             f"(want {want} per call) and "
                             f"{copies} copies to the host (want {d2h})"
                             + (f"; {note}" if note else ""))
    busy = sum(t for _, t in kern.values()) / 1e3            # ms
    text = (f"profiler over {calls} {what}: "
            + ", ".join(f"{v // calls} {k}" for k, v in got.items())
            + f" per call (kernel names), "
            f"{sum(c for c, _ in kern.values()) // calls} kernels per call, "
            f"{copies} copies to the host, kernels {busy / calls:.3f} ms per "
            f"call in {1e3 * wall / calls:.3f} ms (profiler on; device "
            f"busy {100 * busy / (1e3 * wall):.1f}%)"
            + (f"; {note}" if note else ""))
    return text, {k: v // calls for k, v in got.items()}


def newton_per_step(env):
    """normal_newton launches of one step of ``env``: one per substep and
    normal stage (two with a friction stage), none without contact rows
    (the solver returns before the stage)."""
    from gsworld_tpu_torch.physics.world import contact_row_count
    sc = env.scene
    if not contact_row_count(sc):
        return 0
    return sc.substeps * (1 if sc.solver.friction_stage == "off" else 2)


def step_replay_kernels(env):
    """REPLAY_KERNELS of a replay of ``env``'s step graph: the render's
    kernels and the physics' normal_newton launches."""
    return dict(REPLAY_KERNELS,
                normal_newton_kernel=newton_per_step(env))


def uncounted(fn):
    """``fn()`` with the launch counters left as they were: launches made
    to check a result are not the path's."""
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    saved = dict(rc.launch_counts)
    try:
        return fn()
    finally:
        rc.launch_counts.update(saved)


def scan_kernels(wrapper, what):
    """The profiler over SCAN_PROFILE_STEPS scanned steps (``scan_steps``:
    one graph replay per step): one preprocess, emit and compositor kernel per
    replay, no copy to the host before the last step's end, and the
    window's frames bit for bit the same steps run eagerly
    (``_step_and_render`` from the window's start state) -> (text,
    {kernel name: kernels per replay} as the profiler counted them)."""
    import torch
    from gsworld_tpu_torch.rollout.random_actions import scan_steps
    from gsworld_tpu_torch.utils.cuda_graph import clone_tree
    env, n = wrapper.env, SCAN_PROFILE_STEPS
    cam = env.cameras[0].name
    acts = env.action_space_sample(torch.Generator().manual_seed(SEED + 13),
                                   steps=n)
    start = clone_tree(env.state)

    def eager_frames():
        s, frames = clone_tree(start), []
        for a in acts:
            s, obs, *_ = wrapper._step_and_render(s, a)
            frames.append(obs["sensor_data"][cam]["rgb"][0])
        return torch.stack(frames)

    def check(out):
        want = uncounted(eager_frames)
        equal = out[0].shape == want.shape and torch.equal(out[0], want)
        return equal, ("the window's frames bit for bit the same steps run "
                       "eagerly" if equal else "the window's frames differ "
                       "from the same steps run eagerly")

    text, out, per = replay_kernels(lambda: scan_steps(wrapper, acts), n,
                                    f"scanned steps ({what})",
                                    names=step_replay_kernels(env),
                                    check=check)
    if out[0].shape[0] != n or out[1].shape != (n,):
        raise AssertionError(f"{what}: scanned frames "
                             f"{tuple(out[0].shape)}, means "
                             f"{tuple(out[1].shape)}")
    return text, per


def step_kernels(wrapper, what, n=SCAN_PROFILE_STEPS):
    """The profiler over ``n`` ``wrapper.step`` calls through the
    wrapper's CUDA graph: one preprocess, emit and compositor kernel and
    ``newton_per_step`` normal_newton kernels per step, no copy to the
    host; the env's state is restored after them -> text."""
    import torch
    from gsworld_tpu_torch.utils import cuda_graph
    env = wrapper.env
    if not cuda_graph.graphed(env.graph, env.device):
        raise AssertionError(f"{what}: the env does not step through a "
                             f"graph")
    acts = env.action_space_sample(torch.Generator().manual_seed(SEED + 19),
                                   steps=n)
    saved = cuda_graph.clone_tree(env.state)
    text, _, _ = replay_kernels(lambda: [wrapper.step(a) for a in acts], n,
                                f"steps through the graph ({what})",
                                names=step_replay_kernels(env))
    env._state = saved
    return text


def step_leaves(out):
    """{path: tensor} of every tensor a step returned (obs, reward,
    terminated, truncated, info)."""
    return dict(obs_leaves(dict(zip(
        ("obs", "reward", "terminated", "truncated", "info"),
        (out[0], {"": out[1]}, {"": out[2]}, {"": out[3]}, out[4])))))


def leaves_differ(a, b):
    """Paths of two {path: tensor} maps whose tensors are not equal bit
    for bit (or that only one has)."""
    import torch
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b
                  or not torch.equal(a[k], b[k].to(a[k].device)))


def state_leaves(state):
    """{path: tensor} of an EnvState's tensors."""
    w = state.world
    out = {f"world.{f.name}": getattr(w, f.name)
           for f in dataclasses.fields(w) if getattr(w, f.name) is not None}
    out.update(elapsed=state.elapsed, prev_target=state.prev_target)
    out.update({f"task.{k}": v for k, v in state.task.items()})
    return out


def state_differ(a, b):
    """Paths of two EnvStates' tensors that are not equal bit for bit."""
    return leaves_differ(state_leaves(a), state_leaves(b))


def graph_steps_vs_eager(step_g, step_e, actions, what, state_g, state_e):
    """``step_g(a)`` (through a graph) against ``step_e(a)`` (eager) over
    ``actions`` from one state: every tensor the steps return and every
    tensor of the states (``state_g()``, ``state_e()``) bit for bit after
    every step, and what step k returned unchanged after step k + 1 ->
    (host ms per step of each, steps 2 on, each ended by a synchronize).
    Raises on the first step that differs."""
    import torch
    ms_g, ms_e, prev = [], [], None
    for i, a in enumerate(actions):
        t_e, out_e = step_ms(lambda: step_e(a))
        t_g, out_g = step_ms(lambda: step_g(a))
        if i:
            ms_e.append(t_e)
            ms_g.append(t_g)
        bad = []
        if prev is not None:
            bad += [f"step {i}'s {k} changed by step {i + 1}"
                    for k in leaves_differ(step_leaves(prev[0]), prev[1])]
        bad += [f"step {i + 1} {k}" for k in leaves_differ(
            step_leaves(out_g), step_leaves(out_e))]
        bad += [f"state after step {i + 1}: {k}"
                for k in state_differ(state_g(), state_e())]
        if bad:
            raise AssertionError(f"{what}: graph and eager differ: "
                                 f"{bad[:8]} ({len(bad)} in all)")
        prev = (out_g, {k: v.clone()
                        for k, v in step_leaves(out_g).items()})
    torch.cuda.synchronize()
    return statistics.median(ms_g), statistics.median(ms_e)


def scanned_loop(wrapper, what, steps):
    """rollout_fps(use_scan=True) over ``steps`` steps (its warm-up is one
    whole scan of ``steps`` steps, with the capture in its first step,
    unless ``step`` captured already): the frames' contract; the launch
    counters before the timed reps (the reset's render, the capture's
    warm-up steps and the capture itself) and in them (none: a replay
    moves no counter); peak memory of the timed reps; the profiler's
    kernels per replay -> (ms per step, text, launches before the timed
    reps and kernels per replay)."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.rollout.random_actions import (SCAN_REPS,
                                                          rollout_fps)
    from gsworld_tpu_torch.utils.cuda_graph import FnGraph
    env = wrapper.env
    cam = env.cameras[0]
    # the captures the reset and the first scanned step make, if not made
    step_made = "step" in wrapper._graphs
    want = ((0 if "reset" in wrapper._graphs else FnGraph.WARMUP + 1)
            + (0 if step_made else FnGraph.WARMUP + 1))
    before = {}

    def timed_start():
        before.update(rc.launch_counts)
        rc.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()

    rc.reset_launch_counts()
    fps, spf, frames = rollout_fps(wrapper, steps, seed=SEED, warmup=2,
                                   use_scan=True, on_timed_start=timed_start)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    if frames.shape != (steps, cam.height, cam.width, 3) \
            or frames.dtype.name != "uint8" or frames.std() < 5.0:
        raise AssertionError(f"{what}: scanned frames {frames.shape} "
                             f"{frames.dtype}")
    # the physics runs in the step graph's captures only
    wants = dict.fromkeys(RENDER_KERNELS, want)
    wants["normal_newton"] = newton_per_step(env) * (
        0 if step_made else FnGraph.WARMUP + 1)
    for name, w in wants.items():
        if before[name] != w or rc.launch_counts[name]:
            raise AssertionError(
                f"{what}: {name} launched {before[name]} times before the "
                f"timed reps (want {w}: the captures of the reset and "
                f"step graphs not made before) and {rc.launch_counts[name]} "
                f"in them (want 0)")
    check_finite(env.state.world, what)
    prof_text, per_replay = scan_kernels(wrapper, what)
    text = (f"scanned (rollout_fps(use_scan=True): one CUDA graph replay "
            f"per step, best of {SCAN_REPS} reps of {steps}) "
            f"{1000.0 * spf:.3f} ms per step, {fps:.2f} env-steps/s, peak "
            f"memory {peak / 2**30:.3f} GiB allocated "
            f"({reserved / 2**30:.3f} reserved), frames {frames.shape}, "
            f"launch counters {want} before the timed reps (the captures "
            f"not made before) and 0 in them; {prof_text}")
    return 1000.0 * spf, text, dict(before, per_replay=per_replay)


def wrapper_graph_vs_eager(wrapper, actions, what):
    """``wrapper.step`` through its CUDA graph against ``wrapper.step``
    with ``graph=False``, interleaved from the env's state with
    ``actions`` (``graph_steps_vs_eager``); the env is left at the graph
    run's state -> (graph ms, eager ms per step, the eager steps'
    outputs, the eager run's last state)."""
    from gsworld_tpu_torch.utils.cuda_graph import clone_tree
    env = wrapper.env
    graph0 = env.graph
    states = {False: clone_tree(env.state), True: env.state}
    eager = []

    def step(graph, a):
        env.graph = graph
        env._state = states[graph]
        out = wrapper.step(a)
        states[graph] = env._state
        if not graph:
            eager.append(out)
        return out

    try:
        ms_g, ms_e = graph_steps_vs_eager(
            lambda a: step(True, a), lambda a: step(False, a), actions,
            what, lambda: states[True], lambda: states[False])
    finally:
        env.graph = graph0
        env._state = states[True]
    return ms_g, ms_e, eager, states[False]


def graph_vs_eager(wrapper, what, tint=False):
    """``wrapper.step`` through its CUDA graph against ``wrapper.step``
    with ``graph=False``, interleaved from one reset(SEED) state with the
    same SCAN_CHECK_STEPS actions (``graph_steps_vs_eager``: every tensor
    each step returns, every WorldState field, prev_target and the task
    state bit for bit, step k's observation unchanged after step k + 1);
    the scanned loop's replays (``step_graph``) and ``scan_steps``'
    frames against the same eager steps; then emit and the compositor
    against their plain versions on the frames of the state after one
    graph step (tinted by its task's colours with ``tint``) -> text."""
    import torch
    from gsworld_tpu_torch.rollout.random_actions import scan_steps
    from gsworld_tpu_torch.utils.cuda_graph import clone_tree
    from gsworld_tpu_torch.wrapper.gs_env import world_poses
    env, n = wrapper.env, SCAN_CHECK_STEPS
    acts = env.action_space_sample(torch.Generator().manual_seed(SEED + 17),
                                   steps=n)
    wrapper.reset(seed=SEED)
    s0 = clone_tree(env.state)
    ms_g, ms_e, eager, s_eager = wrapper_graph_vs_eager(wrapper, acts, what)
    g = wrapper.step_graph(acts[0])
    g.load(s0, None)
    bad = []
    for i, a in enumerate(acts):
        g.load(None, a)
        g.replay()
        for c, d in g.outputs[1]["sensor_data"].items():
            bad += [f"replay {i + 1} {c} {k}" for k, v in d.items()
                    if not torch.equal(v, eager[i][0]["sensor_data"][c][k])]
    bad += [f"replays: {k}" for k in state_differ(g.inputs[0], s_eager)]
    cam = env.cameras[0].name
    frames, means = scan_steps(wrapper, acts, state=clone_tree(s0))
    rgbs = [e[0]["sensor_data"][cam]["rgb"] for e in eager]
    if not torch.equal(frames, torch.stack([r[0] for r in rgbs])):
        bad.append("scan_steps frames")
    if not torch.equal(means, torch.stack(
            [r.sum(dtype=torch.float64) / r.numel() for r in rgbs]).float()):
        bad.append("scan_steps means")
    if bad:
        raise AssertionError(f"{what}: scanned and eager differ: {bad[:8]} "
                             f"({len(bad)} fields)")
    g.load(s0, acts[0])
    g.replay()
    st = clone_tree(g.inputs[0])
    poses = world_poses(st.world, st.task)
    phase_kernels(wrapper.renderer, poses, phase="6c" if not tint else "6d",
                  tint=(wrapper.renderer.slot_tint(poses.obj_color)
                        if tint else None), timed=False)
    return (f"step through the graph vs graph=False, {n} steps from "
            f"reset({SEED}), the same actions: every tensor each step "
            f"returns (every env's and camera's rgb and segmentation, the "
            f"rest of the observation, reward, flags, info), every "
            f"WorldState field, prev_target and the task state bit for bit "
            f"after every step, step k's outputs unchanged after step "
            f"k + 1; {ms_g:.3f} ms per step through the graph, {ms_e:.3f} "
            f"eager (host clock, a synchronize per step, median of steps "
            f"2-{n}); the scanned loop's replays and scan_steps' frames "
            f"the eager steps' bit for bit; emit and compositor vs plain "
            f"on a graph step's frames within phase 3's gates (lines "
            f"above)")


def reset_render_vs_eager(wrapper, what):
    """``reset``, ``render_current_step`` and ``render()`` through the
    wrapper's CUDA graphs against ``graph=False``, interleaved: reset(SEED
    + k) for RESET_REPS seeds, then both renders after 5 steps and after
    each of RESET_REPS - 1 more: every observation leaf (sensor data
    included), the overflow and the state after a reset bit for bit, and
    what call k returned unchanged after call k + 1; ms per call of each
    form (calls 2 on); one preprocess, emit and compositor kernel per reset and
    render replay by the profiler, and no physics kernel -> (text,
    {kernel name: kernels per reset replay})."""
    import torch
    env, r = wrapper.env, wrapper.renderer
    graph0 = env.graph
    ms, bad, prev = {}, [], []

    def call(name, graph, fn):
        env.graph = graph
        t, out = step_ms(fn)
        ms.setdefault((name.split()[0], graph), []).append(t)
        leaves = {}
        if isinstance(out, tuple):          # reset: (obs, info), the state
            out = out[0]
            leaves = {f"state/{k}": v.clone()
                      for k, v in state_leaves(env.state).items()}
        if isinstance(out, torch.Tensor):   # render(): the rgb
            out = {"rgb": out}
        return dict(obs_leaves(out), overflow=r.last_overflow.clone(),
                    **leaves)

    def compare(name, fn):
        e, g = call(name, False, fn), call(name, True, fn)
        bad.extend(f"{name}: {k}" for k in leaves_differ(g, e))
        if prev:
            bad.extend(f"{prev[0]}'s {k} changed by {name}"
                       for k in leaves_differ(prev[1], prev[2]))
        prev[:] = [name, g, {k: v.clone() for k, v in g.items()}]

    try:
        for k in range(RESET_REPS):
            compare(f"reset {SEED + k}", lambda: wrapper.reset(seed=SEED + k))
        gen = torch.Generator().manual_seed(SEED + 29)
        for k in range(5 + RESET_REPS - 1):
            wrapper.step(env.action_space_sample(gen))
            if k >= 4:
                compare(f"render_current_step after step {k + 1}",
                        wrapper.render_current_step)
                compare(f"render() after step {k + 1}", wrapper.render)
        if bad:
            raise AssertionError(f"{what}: reset and render graphs vs "
                                 f"eager: {bad[:8]} ({len(bad)} in all)")
        reset_text, _, per = replay_kernels(
            lambda: [wrapper.reset(seed=SEED) for _ in range(2)], 2,
            f"reset-graph replays ({what})", d2h=None)
        render_text, _, _ = replay_kernels(
            lambda: [wrapper.render_current_step(), wrapper.render()], 2,
            f"render-graph replays, the sensor cameras and the human view "
            f"({what})")
    finally:
        env.graph = graph0

    def med(name, graph):
        return statistics.median(ms[name, graph][1:])

    times = ", ".join(
        f"{name} {med(name, True):.3f} graph / {med(name, False):.3f} eager"
        for name in ("reset", "render_current_step", "render()"))
    text = (f"reset through its graph vs graph=False over seeds "
            f"{SEED}-{SEED + RESET_REPS - 1}, render_current_step and "
            f"render() after steps 5-{5 + RESET_REPS - 1}: every observation "
            f"leaf (sensor data included), the overflow and the reset state "
            f"bit for bit, call k's outputs unchanged after call k + 1; ms "
            f"per call (host clock to a synchronize, medians of calls 2 on) "
            f"{times}; {reset_text}; {render_text}")
    return text, per


def phase_scan_loop(tmp, device="cuda"):
    """7a: the fr3_align synthetic scene written as the scans
    configs/fr3_align.json names (robot + background with a labels .npy,
    one PLY per object), merged through get_scene, and the AlignFr3 closed
    loop on it against the loop on the synthetic scene itself.
    -> (launch counts, line, asset_dir)."""
    import torch
    from gsworld_tpu_torch import constants
    from gsworld_tpu_torch.gs.merge import merge_scene_from_config
    from gsworld_tpu_torch.gs.model import SCENE_FIELDS, scene_to_splats
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.wrapper.gs_env import world_poses
    t0 = time.perf_counter()
    syn_env, syn = bench_build("AlignFr3Env-v1", NUM_ENVS, "fr3_align",
                               device)
    if syn.is_real_scene:
        raise AssertionError("7a: fr3_align's scans exist in the checkout; "
                             "the synthetic stand-in was expected")
    scene = syn.renderer.scene
    asset_dir = os.path.join(tmp, "assets")
    cfg_path = os.path.join(constants.CFG_DIR, "fr3_align.json")
    t1 = time.perf_counter()
    order = write_config_scans(scene_to_splats(scene), cfg_path, asset_dir)
    write_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    merged, layout = merge_scene_from_config(
        cfg_path, link_names=list(syn_env.agent.model.link_names),
        object_labels={n: constants.obj_gs_semantics[n]
                       for n in syn.renderer.gs_objects},
        asset_dir=asset_dir, gs_semantics=constants.fr3_gs_semantics,
        device=device)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t1
    idx = torch.as_tensor(order, device=device)
    differ = [f for f in SCENE_FIELDS
              if not torch.equal(getattr(merged, f), getattr(scene, f)[idx])]
    if differ or layout != syn.renderer.layout:
        raise AssertionError(f"7a: the merged scene differs from the "
                             f"synthetic one in {differ} (layout equal: "
                             f"{layout == syn.renderer.layout})")
    identity = bool((idx == torch.arange(len(idx), device=device)).all())
    del merged

    env, wrapper = bench_build("AlignFr3Env-v1", NUM_ENVS, "fr3_align",
                               device, asset_dir=asset_dir)
    if not wrapper.is_real_scene:
        raise AssertionError("7a: the wrapper did not merge the scans")
    # the two loops in lockstep: same seed, same actions, same frames
    gen = torch.Generator().manual_seed(SEED)
    obs_s, _ = syn.reset(seed=SEED)
    obs_r, _ = wrapper.reset(seed=SEED)
    rc.reset_launch_counts()
    for i in range(LOOP_STEPS + 1):
        if i:
            a = env.action_space_sample(gen)
            obs_s, *_ = syn.step(a)
            obs_r, *_ = wrapper.step(a)
        (rs, ss), (rr, sr) = frames_of(obs_s), frames_of(obs_r)
        if not (torch.equal(rs, rr) and torch.equal(ss, sr)):
            raise AssertionError(
                f"7a: step {i}: the merged scan's frames differ from the "
                f"synthetic scene's in {int((rs != rr).any(-1).sum())} rgb "
                f"and {int((ss != sr).sum())} segmentation pixels")
    lockstep = dict(rc.launch_counts)
    del syn_env, syn, obs_s
    torch.cuda.empty_cache()

    counts, text, _, _ = timed_loop(wrapper, "7a scan loop")
    cam = env.cameras[0]
    st = env.state
    phase_kernels(wrapper.renderer, world_poses(st.world, st.task),
                  phase="7a", timed=False)
    line = (f"phase 7a real-scan loop, AlignFr3Env-v1 on configs/"
            f"fr3_align.json's scans ({scene.num_gaussians} Gaussians in 4 "
            f"PLYs, {'the synthetic order' if identity else 'permuted'}; "
            f"written in {write_s:.3f} s, merged in {merge_s:.3f} s), "
            f"{NUM_ENVS} envs x {len(env.cameras)} cams "
            f"{cam.width}x{cam.height}: merged scene == synthetic field by "
            f"field, frames (rgb + segmentation) bit for bit the synthetic "
            f"loop's over {LOOP_STEPS} steps from seed {SEED} (launches "
            f"{lockstep} for both loops); {text} (built, checked and run in "
            f"{time.perf_counter() - t0:.1f} s)")
    log(line)
    del env, wrapper, st
    torch.cuda.empty_cache()
    return counts, line, asset_dir


def project_px(w2c, K, pts):
    """Pixels (P, 2) of world points ``pts`` (P, 3) through a pinhole."""
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    px = cam @ K.T
    return px[:, :2] / px[:, 2:3]


def sim2gs_error(T, ref):
    """(rotation degrees, translation mm, scale ratio) of the similarity
    ``T`` against ``ref`` (mm: GS units x 1000)."""
    import numpy as np
    s, s_ref = (np.cbrt(np.linalg.det(M[:3, :3])) for M in (T, ref))
    dR = (T[:3, :3] / s) @ (ref[:3, :3] / s_ref).T
    ang = math.degrees(math.acos(min(1.0, max(-1.0,
                                               (np.trace(dR) - 1) / 2))))
    mm = 1000.0 * float(np.linalg.norm(T[:3, 3] - ref[:3, 3]))
    return ang, mm, s / s_ref


def write_sfm_model(setup, out_dir, n_obs=64):
    """Phase 7b's COLMAP text model of the arc in SfM units (the GS frame
    scaled by SFM_UNITS): one PINHOLE camera, one image per view with
    ``n_obs`` observations, the noisy points and their uint8 colours.
    -> the view names."""
    import numpy as np
    from gsworld_tpu_torch.physics.kinematics import _np_mat_to_quat
    from gsworld_tpu_torch.real2sim import colmap_io
    W, H = setup.cfg.width, setup.cfg.height
    K = arc_intrinsics(W, H)
    cams = {1: colmap_io.ColmapCamera(
        1, "PINHOLE", W, H, np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))}
    pts = np.asarray(setup.points, np.float64)
    images = {}
    for i, w2c in enumerate(look_at_w2c(TRAIN_VIEWS, TRAIN_ARC_DEG)):
        images[i + 1] = colmap_io.ColmapImage(
            i + 1, _np_mat_to_quat(w2c[:3, :3]), SFM_UNITS * w2c[:3, 3], 1,
            f"view_{i:02d}.png", project_px(w2c, K, pts[:n_obs]),
            np.arange(n_obs, dtype=np.int64))
    rgb = np.round(np.asarray(setup.colors) * 255.0).astype(np.uint8)
    colmap_io.write_model_txt(out_dir, cams, images,
                              (np.arange(len(pts)), SFM_UNITS * pts, rgb))
    return [im.name for im in images.values()]


def marker_tracks(names, width, height):
    """Pixel corners of a virtual MARKER-sized ArUco marker lying on the
    table at MARKER_SIM, in every view of the arc."""
    import numpy as np
    from gsworld_tpu_torch import constants
    _, sim2gs = constants.robot_calibration("fr3_align")
    sim2gs = np.asarray(sim2gs, np.float64)
    R = sim2gs[:3, :3]
    u, v = (R[:, k] / np.linalg.norm(R[:, k]) for k in (0, 1))
    c = R @ np.asarray(MARKER_SIM) + sim2gs[:3, 3]
    h = MARKER / 2
    corners = np.stack([c - h * u - h * v, c + h * u - h * v,
                        c + h * u + h * v, c - h * u + h * v])
    K = arc_intrinsics(width, height)
    return {n: project_px(w2c, K, corners) for n, w2c in
            zip(names, look_at_w2c(TRAIN_VIEWS, TRAIN_ARC_DEG))}


def phase_real2sim(tmp, asset_dir, psnr5=None, device="cuda"):
    """7b: real2sim on the card.  The fr3_align robot and background (the
    fr3_no_objs layout) rendered from phase 5's arc, a COLMAP text model
    of it in SfM units, ArUco metric scaling from a virtual marker's
    corner tracks, 3DGS training from the read-back model, the PLY,
    the robot's point cloud, Umeyama + ICP, label transfer, a scene
    config of the labelled scan and 7a's objects, and the AlignFr3 closed
    loop on it.  -> (train launches, loop launches, line)."""
    import json

    import numpy as np
    import torch
    from scipy.spatial import cKDTree
    from gsworld_tpu_torch import constants
    from gsworld_tpu_torch.envs.tasks.tabletop.franka.align import (
        AlignFr3Env)
    from gsworld_tpu_torch.gs.merge import load_scene_config
    from gsworld_tpu_torch.gs.model import SCENE_FIELDS, scene_to_splats
    from gsworld_tpu_torch.gs.ply import load_ply_to_splats, save_splats_to_ply
    from gsworld_tpu_torch.gs.scene_factory import get_scene
    from gsworld_tpu_torch.physics.kinematics import forward_kinematics
    from gsworld_tpu_torch.physics.spec_io import load_surface_points
    from gsworld_tpu_torch.real2sim import alignment, colmap_io, label_transfer
    from gsworld_tpu_torch.real2sim.aruco_scale import ArucoScaleFactor
    from gsworld_tpu_torch.real2sim.pipeline import (cameras_from_colmap,
                                                     train_from_colmap_model)
    from gsworld_tpu_torch.real2sim.urdf_pcd import sample_robot_pcd
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.render.rasterize import render as gs_render
    from gsworld_tpu_torch.train3dgs.loss import psnr
    from gsworld_tpu_torch.train3dgs.train import render_trainable
    from gsworld_tpu_torch.utils.cuda_graph import FnGraph
    from gsworld_tpu_torch.wrapper.gs_env import world_poses

    stages = {}
    clock = [time.perf_counter()]

    def stage(name):
        if device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = round(now - clock[0], 3)
        clock[0] = now

    uid = "fr3_umi"
    model = AlignFr3Env(num_envs=1).agent.model
    scan_qpos = constants.robot_scan_qpos[uid]
    gs_sem, sim2gs = constants.robot_calibration("fr3_no_objs")
    sim2gs = np.asarray(sim2gs, np.float64)
    truth, _, is_real = get_scene(
        "fr3_no_objs", model, scan_qpos, (), list(model.link_names),
        synthetic_sizes=BENCH_SIZES, surface_points=load_surface_points(uid),
        device=device)
    if is_real:
        raise AssertionError("7b: fr3_no_objs's scans exist in the checkout")
    setup = TrainSetup(truth, TRAIN_RASTER, device)
    W, H = setup.cfg.width, setup.cfg.height
    stage("truth and renders")

    sparse = os.path.join(tmp, "sfm", "sparse", "0")
    names = write_sfm_model(setup, sparse)
    asf = ArucoScaleFactor(sparse, aruco_size=MARKER)
    res = asf.run(marker_tracks(names, W, H))
    scale_err = abs(res.scale * SFM_UNITS - 1.0)
    if not scale_err <= SCALE_TOL:
        raise AssertionError(f"7b: ArUco scale {res.scale!r} against "
                             f"1/{SFM_UNITS}: relative error {scale_err:.3g}")
    asf.apply(res, sparse)
    stage("COLMAP model and ArUco scale")

    cams_m = colmap_io.read_cameras_txt(os.path.join(sparse, "cameras.txt"))
    imgs_m = colmap_io.read_images_txt(os.path.join(sparse, "images.txt"))
    _, xyz, rgb = colmap_io.read_points3d_txt(
        os.path.join(sparse, "points3D.txt"))
    cams, got_names = cameras_from_colmap(cams_m, imgs_m, W, H, device=device)
    view_err = max(float((a.world_view - b.world_view).abs().max())
                   for a, b in zip(cams, setup.cams))
    if got_names != names or not view_err <= VIEW_TOL:
        raise AssertionError(f"7b: rescaled cameras: world_view max |diff| "
                             f"{view_err:.3g}, names {got_names[:2]}...")
    stage("read back")

    keep = [i for i in range(len(cams)) if i != setup.hold]
    rc.reset_launch_counts()
    scan, losses = train_from_colmap_model(
        xyz, rgb, [cams[i] for i in keep], [setup.images[i] for i in keep],
        setup.cfg, params=train_params(), iterations=TRAIN_ITERS,
        capacity=setup.capacity, seed=SEED, device=device)
    train_counts = dict(rc.launch_counts)
    # one graph per train call: the warm-up steps and the capture launch
    # from the host, the TRAIN_ITERS replays do not (phase 5 counts the
    # train path's kernels once per replay by the profiler)
    for name in TRAIN_KERNELS:
        if train_counts[name] != FnGraph.WARMUP + 1:
            raise AssertionError(f"7b train: {name} launched "
                                 f"{train_counts[name]} times from the "
                                 f"host in {TRAIN_ITERS} iterations (want "
                                 f"{FnGraph.WARMUP + 1}: one capture)")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("7b train: a loss is not finite")
    bad = {f: int((~torch.isfinite(getattr(scan, f))).reshape(
               scan.num_gaussians, -1).any(-1).sum())
           for f in SCENE_FIELDS if getattr(scan, f).is_floating_point()}
    if any(bad.values()):
        raise AssertionError(f"7b train: Gaussians with non-finite fields "
                             f"in the trained scan {bad} (ROADMAP C19)")
    with torch.no_grad():
        out, _ = render_trainable(
            scan, torch.zeros((scan.num_gaussians, 2), device=device),
            cams[setup.hold], setup.cfg)
        hold_psnr = float(psnr(out, setup.images[setup.hold]))
    stage("train")

    scan_dir = os.path.join(tmp, "scan")
    ply = os.path.join(scan_dir, "point_cloud.ply")
    splats = scene_to_splats(scan)
    save_splats_to_ply(splats, ply)
    back = load_ply_to_splats(ply)
    if not all(np.array_equal(back[k].view(np.int32), splats[k].view(
            np.int32).reshape(back[k].shape)) for k in splats):
        raise AssertionError("7b: the scan's PLY does not read back bit for "
                             "bit")
    stage("PLY write and read")

    pcd, pcd_lab = sample_robot_pcd(uid, 300_000)
    stage("robot point cloud")
    pos, _ = forward_kinematics(
        model, torch.as_tensor(np.asarray(scan_qpos, np.float32)))
    links = [n for n in model.link_names if n in gs_sem]
    sim_pts = pos.numpy()[[model.link_names.index(n) for n in links]]
    sim_pts = sim_pts.astype(np.float64)
    rng = np.random.default_rng(SEED)
    picked = (sim_pts @ sim2gs[:3, :3].T + sim2gs[:3, 3]
              + rng.normal(scale=PICK_NOISE, size=sim_pts.shape))
    means = back["means"].astype(np.float64)
    T0 = alignment.umeyama(sim_pts, picked)
    T = alignment.align_from_correspondences(sim_pts, picked,
                                             sim_cloud=pcd, gs_cloud=means)
    stage("Umeyama + ICP")
    labels, _ = label_transfer.segment_real_gs(means, pcd, pcd_lab, T)
    missing = sorted(set(np.unique(pcd_lab).tolist())
                     - set(np.unique(labels).tolist()))
    if missing:
        raise AssertionError(f"7b: link labels {missing} of the robot cloud "
                             f"are missing from the transferred labels")
    lut = np.full(max(max(np.atleast_1d(v)) for v in gs_sem.values()) + 2, -1)
    for k, name in enumerate(gs_sem):
        for lab in np.atleast_1d(gs_sem[name]):
            lut[int(lab) + 1] = k
    truth_sem = truth.semantics.cpu().numpy()
    _, nn = cKDTree(truth.means.cpu().numpy()).query(means)
    linked = float((labels >= 0).mean())
    agree = float((lut[labels + 1] == lut[truth_sem[nn] + 1]).mean())
    not_in_cloud = sorted(
        int(lab) for v in gs_sem.values() for lab in np.atleast_1d(v)
        if int(lab) not in set(pcd_lab.tolist()))
    stage("label transfer")

    npy = os.path.join(scan_dir, "scan_semantics_gs.npy")
    np.save(npy, labels)
    objs = load_scene_config(os.path.join(constants.CFG_DIR,
                                          "fr3_align.json"))[1:]
    cfg_dir = os.path.join(tmp, "configs")
    os.makedirs(cfg_dir, exist_ok=True)
    with open(os.path.join(cfg_dir, "fr3_scan.json"), "w") as f:
        json.dump({"models": [dict(data_path=ply, semantic_labels=npy,
                                   transformation=[])] + [
            dict(data_path=os.path.join(asset_dir, e["data_path"]),
                 semantic_labels=e["semantic_labels"], transformation=[])
            for e in objs]}, f, indent=2)
    env, wrapper = bench_build("AlignFr3Env-v1", NUM_ENVS, "fr3_scan",
                               device, cfg_dir=cfg_dir)
    if not wrapper.is_real_scene:
        raise AssertionError("7b: the wrapper did not merge the scan")
    loop_counts, text, obs, _ = timed_loop(wrapper, "7b scan loop")
    r = wrapper.renderer
    st = env.state
    with torch.no_grad():
        posed, vcams = r.frames(world_poses(st.world, st.task))
        img = gs_render(posed, vcams, r.raster_config, r.scene.sh0,
                        r.scene.shN, semantics=r.scene.semantics)["rgb"]
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("7b loop: a frame is not finite")
    rgb0, seg0 = frames_of(obs)
    q0 = st.world.qpos.clone()
    link_ids = torch.as_tensor(np.unique(pcd_lab), device=seg0.device)
    seg_links = int(torch.isin(seg0.long(), link_ids).sum())
    gen = torch.Generator().manual_seed(SEED + 1)
    for _ in range(SCAN_MOVE_STEPS):
        obs, *_ = wrapper.step(env.action_space_sample(gen))
    rgb1, _ = frames_of(obs)
    moved = float((env.state.world.qpos - q0).abs().max())
    changed = int((rgb0 != rgb1).any(-1).sum())
    if seg_links == 0 or not (moved > 1e-3 and changed > 0):
        raise AssertionError(f"7b loop: {seg_links} pixels carry a link id; "
                             f"the arm moved {moved:.3g} rad and {changed} "
                             f"pixels changed")
    stage("closed loop")
    ang0, mm0, s0 = sim2gs_error(T0, sim2gs)
    ang, mm, s = sim2gs_error(T, sim2gs)
    line = (f"phase 7b real2sim: ArUco scale {res.scale:.12g} from "
            f"{res.n_detections} views (1/{SFM_UNITS}: relative error "
            f"{scale_err:.3g}, tolerance {SCALE_TOL}); rescaled cameras' "
            f"world_view within {view_err:.3g} of the arc's; trained "
            f"{truth.num_gaussians} points -> {scan.num_gaussians} Gaussians "
            f"in {TRAIN_ITERS} iterations at {W}x{H} (loss {losses[0]:.5f} "
            f"-> {losses[-1]:.5f}, launches {train_counts}), held-out PSNR "
            f"{hold_psnr:.2f} dB (phase 5: "
            f"{'not run' if psnr5 is None else f'{psnr5:.2f} dB'}); PLY bit "
            f"for bit; sim2gs against the calibration: Umeyama on "
            f"{len(links)} picked link origins ({PICK_NOISE} noise) "
            f"{ang0:.4f} deg, {mm0:.3f} mm, scale x{s0:.6f}; after ICP on "
            f"{len(pcd)} robot points {ang:.4f} deg, {mm:.3f} mm, scale "
            f"x{s:.6f}; {linked:.2%} of the scan's Gaussians carry a link "
            f"label, {agree:.2%} agree with the nearest truth Gaussian's "
            f"link (labels {not_in_cloud} are not in the robot cloud); "
            f"closed loop on the labelled scan + 3 object PLYs, {NUM_ENVS} "
            f"envs x {len(env.cameras)} cams {W}x{H}: {text}; {seg_links} "
            f"pixels carry a link id, {changed} pixels changed after "
            f"{SCAN_MOVE_STEPS} more steps (arm moved {moved:.3g} rad); "
            f"seconds per stage {stages}")
    log(line)
    del env, wrapper, obs, st, posed
    torch.cuda.empty_cache()
    return train_counts, loop_counts, line


def phase_scans(psnr5=None):
    """Phases 7a and 7b, their scans under a temporary directory that is
    removed after them -> launch counts and lines."""
    import tempfile
    import torch
    with tempfile.TemporaryDirectory(prefix="gsw_scans_") as tmp:
        scan_counts, scan_line, asset_dir = phase_scan_loop(tmp)
        train_counts, loop_counts, r2s_line = phase_real2sim(tmp, asset_dir,
                                                             psnr5)
    torch.cuda.empty_cache()
    return dict(scan_loop=scan_counts, train=train_counts,
                real2sim_loop=loop_counts, lines=[scan_line, r2s_line])


# ---------------------------------------------------------------------- #
# Phase 8: motion planning and demo collection
# ---------------------------------------------------------------------- #


class _MemDataset:
    """A dataset of the in-memory HDF5 stand-in: one numpy array."""

    def __init__(self, data):
        self.data = np.array(data)
        self.attrs = {}

    def __array__(self, dtype=None, copy=None):
        return self.data if dtype is None else self.data.astype(dtype)


class _MemGroup:
    """A group of the in-memory HDF5 stand-in: named children + attrs."""

    def __init__(self):
        self.children = {}
        self.attrs = {}

    def create_group(self, name):
        return self._put(name, _MemGroup())

    def create_dataset(self, name, data=None, **kw):
        return self._put(name, _MemDataset(data))

    def _put(self, name, node):
        *parents, leaf = name.split("/")
        group = self[("/".join(parents))] if parents else self
        if leaf in group.children:
            raise ValueError(f"{name} exists")
        group.children[leaf] = node
        return node

    def __getitem__(self, name):
        node = self
        for part in (p for p in name.split("/") if p):
            node = node.children[part]
        return node

    def keys(self):
        return self.children.keys()

    def items(self):
        return self.children.items()

    def copy(self, source, dest, name):
        import copy as _copy
        dest._put(name, _copy.deepcopy(source))


class _MemFile(_MemGroup):
    """``h5py.File`` of the stand-in: mode "w" makes an empty root kept
    under the path (an empty file marks it on disk), mode "r" reads it."""

    store = {}

    def __init__(self, path, mode="r"):
        super().__init__()
        path = os.path.abspath(path)
        if mode == "w":
            _MemFile.store[path] = self
            open(path, "wb").close()
        else:
            src = _MemFile.store[path]
            self.children, self.attrs = src.children, src.attrs

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def ensure_h5py():
    """``h5py`` where it is installed; else an in-memory stand-in in
    sys.modules["h5py"] with the calls rollout/record.py and replay.py
    make (the package itself never falls back) -> which one, for the log."""
    try:
        import h5py
        return f"the installed h5py {h5py.__version__}"
    except ImportError:
        import types
        mod = types.ModuleType("h5py")
        mod.File, mod.Group = _MemFile, _MemGroup
        sys.modules["h5py"] = mod
        return ("an in-memory stand-in (h5py is not installed here): "
                "File, create_group, create_dataset, attrs, keys, items, "
                "[], copy, close")


class DemoProbes:
    """Instruments one ``collect`` call without changing what it does:
    every GSWorldWrapper step is timed to a synchronize (the recorder
    reads each step's frame and state on the host anyway) and its overflow
    read; each waypoint's IK (MotionPlanningSolver._ik: the replay of
    its CUDA graph, captured at the solver's first waypoint) is timed the
    same way; the recorder's frames are kept before its video is written; the
    wrappers are kept for the replay phase.  Restores everything on
    exit."""

    def __enter__(self):
        import torch
        from gsworld_tpu_torch.rollout import record
        from gsworld_tpu_torch.rollout.planner import motionplanner
        from gsworld_tpu_torch.utils.profiling import StepTimer
        from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper
        self.timer = StepTimer()
        self.overflow = 0
        self.resets = 0
        self.wrappers = []
        self.frames = None
        solver = motionplanner.MotionPlanningSolver
        self._orig = [(solver, "_ik", solver._ik),
                      (GSWorldWrapper, "step", GSWorldWrapper.step),
                      (GSWorldWrapper, "reset", GSWorldWrapper.reset),
                      (record.RecordEpisode, "flush_video",
                       record.RecordEpisode.flush_video)]
        ik, step, reset, flush_video = (o[2] for o in self._orig)
        probes = self

        def timed_ik(planner, *a):
            with probes.timer.phase("ik"):
                out = ik(planner, *a)
                torch.cuda.synchronize()
            return out

        def timed_step(wrapper, action):
            with probes.timer.phase("step"):
                out = step(wrapper, action)
                torch.cuda.synchronize()
            probes.overflow = max(probes.overflow, int(
                wrapper.renderer.last_overflow.max()))
            return out

        def counted_reset(wrapper, *a, **kw):
            probes.resets += 1
            if wrapper not in probes.wrappers:
                probes.wrappers.append(wrapper)
            return reset(wrapper, *a, **kw)

        def kept_flush(rec, *a, **kw):
            if rec._frames:
                probes.frames = np.stack(rec._frames)
            return flush_video(rec, *a, **kw)

        solver._ik = timed_ik
        GSWorldWrapper.step = timed_step
        GSWorldWrapper.reset = counted_reset
        record.RecordEpisode.flush_video = kept_flush
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)


def collect_task(env_id, cfg_name, out_dir):
    """8a: one ``run_with_gs.collect`` episode of ``env_id`` at 640x480 x
    2 cameras on the full synthetic scene -> (result dict, wrapper)."""
    import torch
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.rollout.run_with_gs import collect
    from gsworld_tpu_torch.utils.cuda_graph import FnGraph
    rc.reset_launch_counts()
    t0 = time.perf_counter()
    with DemoProbes() as probes:
        stats = collect(env_id, cfg_name, num_traj=1, max_seeds=1,
                        only_count_success=False, save_video=True,
                        width=DEMO_W, height=DEMO_H, synthetic_scale=1.0,
                        output_dir=out_dir, seed0=SEED)
    seconds = time.perf_counter() - t0
    counts = dict(rc.launch_counts)
    wrapper, = probes.wrappers
    check_finite(wrapper.env.state.world, f"8a {env_id}")
    s = probes.timer.summary()
    steps = s["step"]["count"]
    ik = s.get("ik", {"count": 0, "mean_ms": float("nan"),
                      "p50_ms": float("nan")})
    plan_ok = stats["failed_plan_rate"] == 0.0
    with open(os.path.join(out_dir, "trajectory.json")) as f:
        episodes = json.load(f)["episodes"]
    if plan_ok != (len(episodes) == 1):
        raise AssertionError(f"8a {env_id}: plan ok {plan_ok} but "
                             f"{len(episodes)} episodes recorded")
    success = bool(episodes[0]["success"]) if episodes else False
    frames = probes.frames
    if plan_ok:
        if episodes[0]["elapsed_steps"] != steps:
            raise AssertionError(f"8a {env_id}: {steps} steps, "
                                 f"{episodes[0]['elapsed_steps']} recorded")
        if frames is None or frames.shape != (steps + 1, DEMO_H, DEMO_W, 3):
            raise AssertionError(f"8a {env_id}: recorded frames "
                                 f"{None if frames is None else frames.shape}")
    renders = steps + probes.resets
    # the resets and steps replay the wrapper's graphs: the host counters
    # see their captures (the warm-up calls and the capture itself)
    if steps and "step" not in wrapper._graphs:
        raise AssertionError(f"8a {env_id}: stepped without the graph")
    if "reset" not in wrapper._graphs:
        raise AssertionError(f"8a {env_id}: reset without the graph")
    captured = (FnGraph.WARMUP + 1) * (2 if steps else 1)
    for name in RENDER_KERNELS:
        if counts[name] != captured:
            raise AssertionError(f"8a {env_id}: {name} launched "
                                 f"{counts[name]} times from the host for "
                                 f"{probes.resets} resets and {steps} steps "
                                 f"through the graph (want {captured})")
    prof_text = step_kernels(wrapper, f"8a {env_id}")
    acts = wrapper.env.action_space_sample(
        torch.Generator().manual_seed(SEED + 23), steps=DEMO_CHECK_STEPS)
    ms_g, ms_e, _, _ = wrapper_graph_vs_eager(wrapper, acts,
                                              f"8a {env_id}")
    res = dict(env_id=env_id, plan_ok=plan_ok, success=success, steps=steps,
               seconds=seconds, step_ms=s["step"]["mean_ms"],
               step_p50_ms=s["step"]["p50_ms"], ik_calls=ik["count"],
               ik_ms=ik["mean_ms"], ik_p50_ms=ik["p50_ms"],
               overflow=probes.overflow, counts=counts, renders=renders,
               frames=frames, graph_ms=ms_g, eager_ms=ms_e,
               h5=os.path.join(out_dir, "trajectory.h5"))
    cam = wrapper.env.cameras[0]
    line = (f"phase 8a demo {env_id} ({cfg_name}), 1 env x "
            f"{len(wrapper.env.cameras)} cams {cam.width}x{cam.height}, "
            f"{wrapper.renderer.scene.num_gaussians} Gaussians, sim 100 / "
            f"control 20: plan {'ok' if plan_ok else 'failed (-1)'}, success "
            f"{success}, {steps} steps in {seconds:.1f} s (collect, scene "
            f"build and video included); {res['step_ms']:.2f} ms per control "
            f"step (median {res['step_p50_ms']:.2f}; physics + render + "
            f"record, to a synchronize); IK {res['ik_ms']:.2f} ms per "
            f"waypoint (median {res['ik_p50_ms']:.2f}) over {ik['count']} "
            f"waypoints, {ik['count'] * res['ik_ms'] / 1e3:.1f} s in all; "
            f"max overflow {probes.overflow} entries per frame; host "
            f"launches {counts} for the captures of the reset and step "
            f"graphs ({probes.resets} resets); "
            f"{prof_text}; {DEMO_CHECK_STEPS} more steps from the episode's "
            f"end, through the graph vs graph=False interleaved, bit for "
            f"bit in everything they return and the state: {ms_g:.3f} ms "
            f"per step through the graph, {ms_e:.3f} eager (a synchronize "
            f"per step, median of steps 2-{DEMO_CHECK_STEPS})")
    log(line)
    return res, line, wrapper


def phase_demo_collect(tmp):
    """8a: every scripted solution's episode through run_with_gs.collect
    -> ({env_id: result}, lines, {env_id: wrapper} of the replay tasks)."""
    import torch
    results, lines, keep = {}, [], {}
    for env_id, cfg in DEMO_TASKS:
        res, line, wrapper = collect_task(env_id, cfg,
                                          os.path.join(tmp, env_id))
        results[env_id] = res
        lines.append(line)
        if env_id in DEMO_REPLAY:
            keep[env_id] = wrapper
        del wrapper
        torch.cuda.empty_cache()
    rows = " | ".join(f"{k.split('Env')[0]} "
                      f"{'ok' if r['plan_ok'] else 'plan failed'}, "
                      f"{'success' if r['success'] else 'no success'}, "
                      f"{r['steps']} steps" for k, r in results.items())
    n_ok = sum(r["success"] for r in results.values())
    table = (f"phase 8a success table, seed {SEED}: {n_ok} of "
             f"{len(results)} tasks succeed; {rows}")
    log(table)
    return results, lines + [table], keep


def phase_demo_replay(results, wrappers):
    """8b: the recorded AlignFr3 and AlignXArm episodes replayed through
    the same wrappers (frames bit for bit), both kernels against their
    plain versions on a replayed state's frames, and AlignFr3's first
    screw move and first steps on the card against the CPU."""
    from gsworld_tpu_torch.rollout.replay import replay_h5
    from gsworld_tpu_torch.utils.cuda_graph import FnGraph
    from gsworld_tpu_torch.wrapper.gs_env import world_poses
    lines = []
    for env_id in DEMO_REPLAY:
        res, wrapper = results[env_id], wrappers[env_id]
        if not res["plan_ok"]:
            raise AssertionError(f"8b {env_id}: its plan failed, nothing "
                                 f"to replay")
        t0 = time.perf_counter()
        with counted_calls(FnGraph) as calls:
            frames = replay_h5(wrapper, res["h5"])
        dt = time.perf_counter() - t0
        if calls[0] != len(frames) or not wrapper.renderer._graphs:
            raise AssertionError(f"8b {env_id}: {calls[0]} render-graph "
                                 f"calls for {len(frames)} frames")
        want = res["frames"][1:]
        if frames.shape != want.shape or not np.array_equal(frames, want):
            bad = (int((frames != want).any(-1).sum())
                   if frames.shape == want.shape else frames.shape)
            raise AssertionError(f"8b {env_id}: replayed frames differ from "
                                 f"the recorded ones ({bad})")
        st = wrapper.env.state
        phase_kernels(wrapper.renderer, world_poses(st.world, st.task),
                      phase="8b", timed=False)
        line = (f"phase 8b replay {env_id}: replay_h5 of the recorded "
                f"episode renders its {len(frames)} step frames through "
                f"the render graph ({calls[0]} calls) bit for bit "
                f"the recorded video's ({dt:.1f} s, "
                f"{1e3 * dt / len(frames):.2f} ms per frame); emit and "
                f"compositor vs plain on the last replayed state's frames "
                f"within the phase-3 gates (lines above)")
        log(line)
        lines.append(line)
    lines.append(demo_card_vs_cpu())
    return lines


class counted_calls:
    """``with counted_calls(cls) as n:`` counts the calls of instances of
    ``cls`` (graph classes) in ``n[0]``; restores ``cls.__call__`` on
    exit."""

    def __init__(self, cls):
        self.cls, self.n = cls, [0]

    def __enter__(self):
        call, n = self.cls.__call__, self.n
        self.orig = call

        def counted(graph, *a, **kw):
            n[0] += 1
            return call(graph, *a, **kw)

        self.cls.__call__ = counted
        return n

    def __exit__(self, *exc):
        self.cls.__call__ = self.orig


class _StopEpisode(Exception):
    pass


def first_steps(env, n):
    """The state dicts of the first ``n`` steps of solveAlignFr3 on the
    bare ``env`` (render off), as numpy."""
    from gsworld_tpu_torch.rollout.planner.solutions import solveAlignFr3
    from gsworld_tpu_torch.rollout.record import _to_np
    states = []
    step = env.step

    def recorded_step(action):
        out = step(action)
        states.append(_to_np(env.get_state_dict()))
        if len(states) == n:
            raise _StopEpisode
        return out

    env.step = recorded_step
    try:
        solveAlignFr3(env, seed=SEED)
    except _StopEpisode:
        pass
    finally:
        del env.step
    return {"actors": {k: np.stack([s["actors"][k] for s in states])
                       for k in states[0]["actors"]},
            "articulations": {k: np.stack([s["articulations"][k]
                                           for s in states])
                              for k in states[0]["articulations"]}}


def demo_card_vs_cpu():
    """8b: AlignFr3Env-v1 (1 env, pd_joint_pos, sim 100 / control 20,
    render off) on the card and on the CPU from reset(SEED): the dry-run
    waypoints of solveAlignFr3's first screw move (within DEMO_DRY_TOL
    rad) and its first DEMO_CPU_STEPS executed steps by
    compare_trajectories (within DEMO_TRAJ_TOL)."""
    from gsworld_tpu_torch.rollout.planner.motionplanner import (
        FR3UmiMotionPlanningSolver)
    from gsworld_tpu_torch.rollout.planner.solutions import (
        TOPDOWN_Q, _actor_pos)
    from gsworld_tpu_torch.rollout.replay import compare_trajectories
    kw = dict(control_mode="pd_joint_pos",
              sim_config=dict(sim_freq=100, control_freq=20))
    card = make_env(1, "cuda", True, **kw)
    cpu = make_env(1, "cpu", False, **kw)
    wps = []
    for env, graph in ((card, True), (card, False), (cpu, False)):
        env.reset(seed=SEED)
        env.graph = graph
        planner = FR3UmiMotionPlanningSolver(env)
        grasp = _actor_pos(env, "dtc_green_can_fr3") + np.array(
            [0, 0, 0.03], np.float32)
        tcp, _ = planner.tcp_pose()
        z_keep = max(float(tcp[2]), float(grasp[2] + 0.10))
        wps.append(planner.move_to_pose_with_screw(
            np.array([grasp[0], grasp[1], z_keep], np.float32), TOPDOWN_Q,
            dry_run=True, speed=0.6))
    card.graph = True
    if -1 in wps or len({len(w) for w in wps}) != 1:
        raise AssertionError(f"8b: dry run card (graph, eager) vs CPU "
                             f"{[len(w) for w in wps]} waypoints")
    if not np.array_equal(np.stack(wps[0]), np.stack(wps[1])):
        raise AssertionError("8b: the IK's graph and eager waypoints differ")
    dry = float(np.abs(np.stack(wps[0]) - np.stack(wps[2])).max())
    if dry > DEMO_DRY_TOL:
        raise AssertionError(f"8b: dry-run waypoints card vs CPU {dry:.3g}")
    m = compare_trajectories(first_steps(card, DEMO_CPU_STEPS),
                             first_steps(cpu, DEMO_CPU_STEPS))
    worst = max(m.values())
    if worst > DEMO_TRAJ_TOL:
        raise AssertionError(f"8b: first {DEMO_CPU_STEPS} steps card vs "
                             f"CPU {m}")
    line = (f"phase 8b card vs CPU, AlignFr3Env-v1 from reset({SEED}): the "
            f"first screw move's {len(wps[0])} dry-run waypoints, the IK's "
            f"CUDA graph bit for bit its eager solve on the card, within "
            f"{dry:.3g} rad of the CPU's (<= {DEMO_DRY_TOL}); the first "
            f"{DEMO_CPU_STEPS} "
            f"executed steps (render off) by compare_trajectories: "
            f"{ {k: float(f'{v:.3g}') for k, v in m.items()} } (each <= "
            f"{DEMO_TRAJ_TOL})")
    log(line)
    return line


def phase_demo_rrt(tmp):
    """8c: RRT-Connect around an obstacle on the card, an env state
    checkpoint round trip and the wrapper's state log."""
    import torch
    from gsworld_tpu_torch.render.camera import RasterConfig
    from gsworld_tpu_torch.rollout.planner import rrt
    from gsworld_tpu_torch.rollout.planner.motionplanner import (
        FR3UmiMotionPlanningSolver)
    from gsworld_tpu_torch.utils.checkpoint import (load_env_state,
                                                    save_env_state)
    from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper
    env = make_env(1, "cuda", True, control_mode="pd_joint_pos",
                   sim_config=dict(sim_freq=100, control_freq=20))
    env.reset(seed=SEED)
    planner = FR3UmiMotionPlanningSolver(env)
    act = list(env.agent.arm_dof_ids)
    w = env.state.world
    q0 = w.qpos[0].clone()
    q1, mid = q0.clone(), q0.clone()
    q1[act[0]] += RRT_SWING
    mid[act[0]] += RRT_SWING / 2
    p_mid, _ = planner._fk(mid, w.root_pos[0], w.root_quat[0])
    p_goal, q_goal = planner._fk(q1, w.root_pos[0], w.root_quat[0])
    a_pos = w.a_pos.clone()
    a_pos[0, env.actor_index["spice_rack"]] = p_mid - torch.tensor(
        [0.0, 0.0, 0.08], device=p_mid.device)
    env._state = env.state.replace(world=w.replace(a_pos=a_pos))
    check = rrt.make_collision_checker(env)
    args = (a_pos[0], w.a_quat[0], w.root_pos[0], w.root_quat[0])
    paths, checkers, batches = [], [], []
    plan, made = rrt.rrt_connect, rrt.make_collision_checker

    def kept(*a, **kw):
        paths.append(plan(*a, **kw))
        return paths[-1]

    def recorded(*a, **kw):
        # every batch the RRT run checks, with its answer
        chk = made(*a, **kw)
        checkers.append(chk)

        def rec(q, *args):
            out = chk(q, *args)
            batches.append((np.array(q), [x.clone() for x in args],
                            out.clone()))
            return out

        return rec

    rrt.rrt_connect, rrt.make_collision_checker = kept, recorded
    t0 = time.perf_counter()
    try:
        res = planner.move_to_pose_with_RRTConnect(
            p_goal.cpu().numpy(), q_goal.cpu().numpy())
    finally:
        rrt.rrt_connect, rrt.make_collision_checker = plan, made
    dt = time.perf_counter() - t0
    if res == -1 or not paths or paths[0] is None:
        raise AssertionError("8c: RRT-Connect found no path")
    path = paths[0]
    blocked = not rrt._edge_free(check, path[0], path[-1], args)[0]
    hits = int(check(path, *args).sum())
    if not blocked or hits:
        raise AssertionError(f"8c: straight line blocked {blocked}, "
                             f"{hits} path configurations in collision")
    gen = torch.Generator().manual_seed(SEED)
    lim = torch.as_tensor(env.agent.model.qlimits, dtype=torch.float32)
    batch = (lim[:, 0] + (lim[:, 1] - lim[:, 0])
             * torch.rand((RRT_BATCH, lim.shape[0]), generator=gen)).to(env.device)
    # the RRT run's checks went through the checker's graphs (one per
    # batch size); each batch again through the eager checker, bit for bit
    captures = sorted(m for c in checkers for m in c.graphs)
    if not checkers or not captures:
        raise AssertionError("8c: the RRT run checked without a graph")
    env.graph = False
    try:
        differ = [i for i, (q, a, out) in enumerate(batches)
                  if not torch.equal(checkers[0](q, *a), out)]
        eager_ms = cuda_ms(lambda: check(batch, *args), reps=10)
    finally:
        env.graph = True
    if differ:
        raise AssertionError(f"8c: the checker's graphs and the eager "
                             f"checker differ on batches {differ[:8]} of "
                             f"{len(batches)}")
    check_ms = cuda_ms(lambda: check(batch, *args), reps=10)
    line = (f"phase 8c RRT: move_to_pose_with_RRTConnect from the AlignFr3 "
            f"reset to the TCP pose of joint 1 turned by {RRT_SWING} rad, the "
            f"spice rack where the straight joint line passes (blocked): a "
            f"path of {len(path)} densified configurations, every one free "
            f"by the checker, planned and followed in {dt:.2f} s; the RRT "
            f"run checked {len(batches)} batches of "
            f"{min(len(q) for q, _, _ in batches)}-"
            f"{max(len(q) for q, _, _ in batches)} configurations through "
            f"{len(captures)} checker graphs (one captured per batch size), "
            f"every answer bit for bit the eager checker's; the checker "
            f"does {RRT_BATCH / check_ms:.1f} configurations per ms through "
            f"its graph ({check_ms:.3f} ms for {RRT_BATCH}), "
            f"{RRT_BATCH / eager_ms:.1f} eager ({eager_ms:.3f} ms)")
    log(line)

    state = env.state
    back = load_env_state(save_env_state(state, os.path.join(tmp, "st.npz")),
                          like=state)
    if not states_equal(back, state):
        raise AssertionError("8c: the env state checkpoint does not round "
                             "trip bit for bit")
    log_dir = os.path.join(tmp, "state_log")
    env.reset(seed=SEED)
    env.cameras = [dataclasses.replace(c, width=DEMO_W, height=DEMO_H)
                   for c in env.cameras]
    wrapper = GSWorldWrapper(env, "fr3_align",
                             raster_config=RasterConfig(width=DEMO_W,
                                                        height=DEMO_H),
                             synthetic_sizes=BENCH_SIZES, log_state=True,
                             state_log_path=log_dir)
    wrapper.reset(seed=SEED)
    states = []
    for _ in range(LOG_STEPS):
        wrapper.step(planner._action(planner._arm(env.state.world.qpos[0]),
                                     planner.OPEN))
        states.append(env.state)
    files = sorted(os.listdir(log_dir))
    if files != [f"state_{i:06d}.npz" for i in range(LOG_STEPS)] or not all(
            states_equal(load_env_state(os.path.join(log_dir, f), like=s), s)
            for f, s in zip(files, states)):
        raise AssertionError(f"8c: state log {files} does not load back "
                             f"equal")
    line2 = (f"phase 8c checkpoint: save_env_state / load_env_state of a "
             f"card state round trips bit for bit; GSWorldWrapper(log_state="
             f"True) wrote {len(files)} bundles in {LOG_STEPS} steps, each "
             f"loading back bit for bit the state after its step")
    log(line2)
    return [line, line2]


def states_equal(a, b):
    import torch
    from gsworld_tpu_torch.physics.world import WORLD_FIELDS
    return (all(torch.equal(getattr(a.world, f), getattr(b.world, f))
                for f in WORLD_FIELDS if getattr(b.world, f) is not None)
            and torch.equal(a.elapsed, b.elapsed)
            and torch.equal(a.prev_target, b.prev_target)
            and a.task.keys() == b.task.keys()
            and all(torch.equal(a.task[k], b.task[k]) for k in a.task))


def phase_demos():
    """Phases 8a-8c under a temporary directory removed after them ->
    (launch counts of 8a, lines)."""
    import tempfile
    import torch
    log(f"phase 8 h5py: {ensure_h5py()}")
    with tempfile.TemporaryDirectory(prefix="gsw_demos_") as tmp:
        results, lines, wrappers = phase_demo_collect(tmp)
        lines += phase_demo_replay(results, wrappers)
        del wrappers
        torch.cuda.empty_cache()
        lines += phase_demo_rrt(tmp)
    counts = {k: sum(r["counts"][k] for r in results.values())
              for k in KERNEL_NAMES}
    torch.cuda.empty_cache()
    return counts, lines


def obs_leaves(tree, prefix=""):
    """(path, tensor) of every leaf of a nested observation dict, in key
    order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from obs_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def step_ms(step):
    """Host-clock ms of ``step()`` ended by a synchronize."""
    import torch
    t0 = time.perf_counter()
    out = step()
    torch.cuda.synchronize()
    return 1000.0 * (time.perf_counter() - t0), out


def shard_vs_unsharded(env, wrapper, mesh):
    """The loop split over ``mesh`` against the unsharded loop from the
    same reset(seed) and the same actions: frames of step 1, the state
    after SHARD_STEPS steps, the reward's mean_across_envs, launches per
    shard per step, ms per step of both -> (the phase's line, the
    sharded step's rewards)."""
    import torch
    from gsworld_tpu_torch.dist import mesh as M
    from gsworld_tpu_torch.dist.sharded import ShardedLoop
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    t0 = time.perf_counter()
    n = len(mesh)
    loop = ShardedLoop(wrapper, mesh)
    reset_u, _ = wrapper.reset(seed=SEED)
    reset_s, _ = loop.reset(seed=SEED)
    # every shard reset through its wrapper's reset graph
    if not all("reset" in sh._graphs for sh in loop.shards):
        raise AssertionError("9a: a shard reset without its graph")
    reset_differ, reset_err, reset_agree = obs_vs_unsharded(reset_u,
                                                            reset_s)
    if reset_err > 1 or reset_agree < SEG_AGREE_MIN:
        raise AssertionError(f"9a: the reset's frames differ by {reset_err} "
                             f"counts, segmentation {reset_agree}")
    gen = torch.Generator().manual_seed(SEED)
    ms_u, ms_s, first = [], [], None
    for i in range(SHARD_STEPS):
        a = env.action_space_sample(gen)
        t_u, out_u = step_ms(lambda: wrapper.step(a))
        rc.reset_launch_counts()
        t_s, out_s = step_ms(lambda: loop.step(a))
        if i and any(rc.launch_counts[k]
                     for k in RENDER_KERNELS + PHYSICS_KERNELS):
            raise AssertionError(f"9a: host launches in a sharded step "
                                 f"after the capture {rc.launch_counts}, "
                                 f"want none (one graph replay per shard)")
        if i == 0:           # the first step captures the step graphs
            first = (out_u, out_s)
        else:
            ms_u.append(t_u)
            ms_s.append(t_s)
    (obs_u, *_), (obs_s, *_) = first
    differ, rgb_err, seg_agree = obs_vs_unsharded(obs_u, obs_s)
    if rgb_err > 1 or seg_agree < SEG_AGREE_MIN:
        raise AssertionError(f"9a: step 1 frames differ by {rgb_err} "
                             f"counts, segmentation {seg_agree}")
    wd = world_diff(loop.state.world, env.state.world)
    bad = {f: d for f, (eq, d) in wd.items() if d > SHARD_STATE_TOL}
    if bad:
        raise AssertionError(f"9a: WorldState after {SHARD_STEPS} steps "
                             f"differs beyond {SHARD_STATE_TOL}: {bad}")
    state_first = next((f for f, (eq, _) in wd.items() if not eq), None)
    r_u, r_s = out_u[1], out_s[1]
    mean_err = abs(float(M.mean_across_envs(list(r_s.tensor_split(n))))
                   - float(r_u.mean()))
    if mean_err > SHARD_MEAN_TOL:
        raise AssertionError(f"9a: mean_across_envs of the reward differs "
                             f"from the unsharded mean by {mean_err:.3g}")
    # after the comparisons: the window steps the split loop alone
    a = env.action_space_sample(gen)
    prof_text, _, _ = replay_kernels(lambda: loop.step(a), 1,
                                     f"sharded step over {n} shards",
                                     names=step_replay_kernels(env),
                                     per_call=n)
    b = NUM_ENVS // n
    line = (f"phase 9a {n} shards on {[str(d) for d in mesh]} "
            f"({' + '.join([str(b)] * n)} envs) vs the unsharded "
            f"{NUM_ENVS}-env loop from reset({SEED}), same actions: the "
            f"reset through each shard's reset graph "
            + ("every observation bit for bit" if not reset_differ else
               f"first differing observation field {reset_differ[0]} "
               f"({len(reset_differ)} fields)")
            + f", frames max |diff| {reset_err} counts, segmentation equal "
            f"{reset_agree:.6f}; step 1 "
            + ("every observation bit for bit" if not differ else
               f"first differing observation field {differ[0]} "
               f"({len(differ)} fields)")
            + f", frames max |diff| {rgb_err} counts, segmentation equal "
            f"{seg_agree:.6f}; WorldState after {SHARD_STEPS} steps "
            + ("bit for bit" if state_first is None else
               f"first differing field {state_first}, max |diff| "
               f"{max(d for _, d in wd.values()):.3g}")
            + f" (gate {SHARD_STATE_TOL}); mean_across_envs(reward) - "
            f"unsharded mean {mean_err:.3g} (gate {SHARD_MEAN_TOL}); "
            f"{prof_text}; ms per "
            f"step through the graphs (host clock, synchronized, median of "
            f"steps "
            f"2-{SHARD_STEPS}) sharded {statistics.median(ms_s):.3f}, "
            f"unsharded {statistics.median(ms_u):.3f} "
            f"({time.perf_counter() - t0:.1f} s)")
    log(line)
    return line, r_s


def obs_vs_unsharded(obs_u, obs_s):
    """An unsharded and a sharded observation -> (paths that differ,
    frames' max |diff| in counts, least segmentation agreement over the
    cameras)."""
    import torch
    leaves_u = dict(obs_leaves(obs_u))
    differ = [k for k, v in obs_leaves(obs_s)
              if not torch.equal(v.to(leaves_u[k].device), leaves_u[k])]
    rgb_err, seg_agree = 0, []
    for c in obs_u["sensor_data"]:
        su, ss = obs_u["sensor_data"][c], obs_s["sensor_data"][c]
        rgb_err = max(rgb_err, int((su["rgb"].int() - ss["rgb"].int())
                                   .abs().max()))
        seg_agree.append(float((su["segmentation"] == ss["segmentation"])
                               .float().mean()))
    return differ, rgb_err, min(seg_agree)


def shard_scan_vs_unsharded(env, wrapper, mesh):
    """9a's gates on the scanned loop: the split's scan over ``mesh``
    (``ShardedLoop.scan_steps``: per step one action copy and one graph
    replay per shard) against the unsharded scan from the same
    reset(SEED) and SHARD_STEPS actions: env 0's frames at every step and
    every env's and camera's frames at the last step (max |diff| <= 1
    count, segmentation >= SEG_AGREE_MIN equal), every WorldState field
    within SHARD_STATE_TOL, mean_across_envs of the last reward within
    SHARD_MEAN_TOL of the unsharded mean; ms per scanned step of both
    (the first, capturing scan untimed) -> the phase's line."""
    import torch
    from gsworld_tpu_torch.dist import mesh as M
    from gsworld_tpu_torch.dist.sharded import ShardedLoop
    from gsworld_tpu_torch.rollout.random_actions import scan_steps
    t0 = time.perf_counter()
    n = len(mesh)
    loop = ShardedLoop(wrapper, mesh)
    acts = env.action_space_sample(torch.Generator().manual_seed(SEED),
                                   steps=SHARD_STEPS)
    wrapper.reset(seed=SEED)
    loop.reset(seed=SEED)
    scan_steps(wrapper, acts[:1])            # the captures
    loop.scan_steps(acts[:1])
    wrapper.reset(seed=SEED)
    loop.reset(seed=SEED)
    t_u, f_u = step_ms(lambda: scan_steps(wrapper, acts)[0])
    t_s, f_s = step_ms(lambda: loop.scan_steps(acts)[0])
    env0_err = int((f_u.int() - f_s.to(f_u.device).int()).abs().max())
    # each step graph's outputs: (state, obs, reward, terminated, ...)
    graphs = [sh._graphs["step"] for sh in loop.shards]
    sd_u = wrapper._graphs["step"].outputs[1]["sensor_data"]
    sd_s = M.gather_env_axis([g.outputs[1]["sensor_data"] for g in graphs],
                             mesh[0])
    rgb_err, seg_agree = env0_err, []
    for c in sd_u:
        su, ss = sd_u[c], sd_s[c]
        rgb_err = max(rgb_err, int((su["rgb"].int() - ss["rgb"].int())
                                   .abs().max()))
        seg_agree.append(float((su["segmentation"] == ss["segmentation"])
                               .float().mean()))
    if rgb_err > 1 or min(seg_agree) < SEG_AGREE_MIN:
        raise AssertionError(f"9a scanned: frames differ by {rgb_err} "
                             f"counts, segmentation {seg_agree}")
    wd = world_diff(loop.state.world, env.state.world)
    bad = {f: d for f, (eq, d) in wd.items() if d > SHARD_STATE_TOL}
    if bad:
        raise AssertionError(f"9a scanned: WorldState after {SHARD_STEPS} "
                             f"steps differs beyond {SHARD_STATE_TOL}: {bad}")
    mean_err = abs(float(M.mean_across_envs([g.outputs[2] for g in graphs]))
                   - float(wrapper._graphs["step"].outputs[2].mean()))
    if mean_err > SHARD_MEAN_TOL:
        raise AssertionError(f"9a scanned: mean_across_envs of the reward "
                             f"differs by {mean_err:.3g}")
    state_first = next((f for f, (eq, _) in wd.items() if not eq), None)
    b = NUM_ENVS // n
    line = (f"phase 9a scanned: {n} shards on {[str(d) for d in mesh]} "
            f"({' + '.join([str(b)] * n)} envs), ShardedLoop.scan_steps vs "
            f"the unsharded scan_steps, {SHARD_STEPS} steps from "
            f"reset({SEED}), same actions: frames max |diff| {rgb_err} "
            f"counts (env 0 every step, every env at the last), "
            f"segmentation equal {min(seg_agree):.6f}; WorldState "
            + ("bit for bit" if state_first is None else
               f"first differing field {state_first}, max |diff| "
               f"{max(d for _, d in wd.values()):.3g}")
            + f" (gate {SHARD_STATE_TOL}); mean_across_envs(reward) - "
            f"unsharded mean {mean_err:.3g}; ms per scanned step (host "
            f"clock, one synchronize at the end) sharded "
            f"{t_s / SHARD_STEPS:.3f}, unsharded {t_u / SHARD_STEPS:.3f} "
            f"({time.perf_counter() - t0:.1f} s)")
    log(line)
    return line


def phase_shard():
    """9a: rollout_fps(shard=True) over env_mesh() (every visible card);
    the loop split into SHARDS shards on one card (and over every card,
    where there are more) against the unsharded loop; init_distributed
    (NCCL, world size 1, a file store under OUT_DIR) with
    mean_across_envs's all_reduce against the local mean."""
    import torch
    import torch.distributed as dist
    from gsworld_tpu_torch.dist import mesh as M
    from gsworld_tpu_torch.render import rasterize_cuda as rc
    from gsworld_tpu_torch.rollout.random_actions import rollout_fps
    t0 = time.perf_counter()
    env, wrapper = bench_build("AlignFr3Env-v1", NUM_ENVS, "fr3_align")
    mesh = M.env_mesh()
    fps, spf, frames = rollout_fps(wrapper, LOOP_STEPS, seed=SEED,
                                   shard=True,
                                   on_timed_start=rc.reset_launch_counts)
    counts = dict(rc.launch_counts)
    # each shard's step replays its wrapper's graph, captured in the
    # warm-up: no host launch in the timed steps (the profiler counts one
    # kernel of each per shard and step in the lines below)
    for name in RENDER_KERNELS + PHYSICS_KERNELS:
        if counts[name]:
            raise AssertionError(f"9a: {name} launched {counts[name]} times "
                                 f"from the host in {LOOP_STEPS} steps over "
                                 f"{len(mesh)} shards after the capture")
    cam = env.cameras[0]
    if frames.shape != (NUM_ENVS, cam.height, cam.width, 3):
        raise AssertionError(f"9a: frames {frames.shape}")
    s_fps, s_spf, s_frames = rollout_fps(wrapper, LOOP_STEPS, seed=SEED,
                                         shard=True, use_scan=True)
    if s_frames.shape != (LOOP_STEPS, cam.height, cam.width, 3):
        raise AssertionError(f"9a: scanned frames {s_frames.shape}")
    lines = [f"phase 9a rollout_fps(shard=True), env_mesh() = "
             f"{[str(d) for d in mesh]}, {NUM_ENVS} envs x "
             f"{len(env.cameras)} cams {cam.width}x{cam.height}, "
             f"{LOOP_STEPS} steps through each shard's graph: {fps:.2f} "
             f"env-steps/s, {1000.0 * spf:.3f} ms per step (host clock), "
             f"host launches {counts}; scanned (use_scan=True, one graph "
             f"replay per shard "
             f"and step, best of 3 reps) {s_fps:.2f} env-steps/s, "
             f"{1000.0 * s_spf:.3f} ms per step "
             f"({time.perf_counter() - t0:.1f} s)"]
    log(lines[0])
    meshes = [M.env_mesh(["cuda:0"] * SHARDS)] + ([mesh] if len(mesh) > 1
                                                   else [])
    for m in meshes:
        line, rewards = shard_vs_unsharded(env, wrapper, m)
        lines.append(line)
        lines.append(shard_scan_vs_unsharded(env, wrapper, m))

    # the process group: NCCL, one process, a file store (no network)
    store = os.path.join(OUT_DIR, "dist_store")
    if os.path.exists(store):
        os.remove(store)
    parts = list(rewards.tensor_split(len(m)))
    local = M.mean_across_envs(parts)
    M.init_distributed(init_method=f"file://{store}", rank=0, world_size=1)
    if not dist.is_initialized():
        raise AssertionError("9a: init_distributed formed no process group")
    backend = dist.get_backend()
    try:
        reduced = M.mean_across_envs(parts)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    red_err = abs(float(reduced) - float(local))
    if red_err > SHARD_MEAN_TOL:
        raise AssertionError(f"9a: all_reduce mean differs by {red_err:.3g}")
    line = (f"phase 9a init_distributed ({backend}, world size 1, a file "
            f"store): mean_across_envs through all_reduce - the local mean "
            f"{red_err:.3g} (gate {SHARD_MEAN_TOL}) "
            f"({time.perf_counter() - t0:.1f} s for 9a)")
    log(line)
    lines.append(line)
    del env, wrapper
    torch.cuda.empty_cache()
    return counts, lines


def phase_fidelity():
    """9b: tools/render_parity.py on the STEPS render states of phase 4:
    the bench raster against the render with D = the tile count and E
    doubled from 2^19 until nothing drops; then emit and compositor
    against their plain versions on env 0's frames of the first state at
    the lifted shape, with phase 3's gates."""
    import torch
    from gsworld_tpu_torch.envs.base import EnvPoses
    from gsworld_tpu_torch.tools import render_parity as rp
    t0 = time.perf_counter()
    renderer = make_renderer("cuda", NUM_ENVS, BENCH_RASTER, BENCH_SIZES)
    states = random_states(renderer.env, STEPS, "cuda")
    res = rp.compare(renderer, states)
    lines = []
    for cam, d in res["cameras"].items():
        line = (f"phase 9b fidelity {cam}, {len(states)} states x "
                f"{NUM_ENVS} envs, bench (D={res['bench']['D']}, "
                f"E={res['bench']['E']}) vs lifted (D={res['lifted']['D']}, "
                f"E={res['lifted']['E']}): uint8 PSNR min "
                f"{d['psnr_min']:.2f} dB, median {d['psnr_median']:.2f} "
                f"(E budget alone, bench D with the lifted E: min "
                f"{d['psnr_e_min']:.2f}, median {d['psnr_e_median']:.2f}), "
                f"max |diff| {d['max_abs_diff']}, segmentation agreement "
                f"{d['seg_agreement']:.6f}; bench overflow (E budget) per "
                f"frame max {d['dropped_max']} mean {d['dropped_mean']:.1f}; "
                f"pre-cull entries the D cap shrank per frame max "
                f"{d['d_cap_max']} mean {d['d_cap_mean']:.1f}")
        log(line)
        lines.append(line)
    lifted = rp.lifted_config(renderer.raster_config, res["lifted"]["E"])
    s0 = states[0]
    one = EnvPoses(qpos=s0.qpos[:1], a_pos=s0.a_pos[:1],
                   a_quat=s0.a_quat[:1])
    phase_kernels(renderer, one, phase="9b", timed=False, cfg=lifted)
    line = (f"phase 9b kernels at the lifted shape "
            f"(D={lifted.max_tiles_per_gaussian}, E={lifted.max_entries}, "
            f"env 0's "
            f"{len(renderer.env.cameras)} frames of state 0): emit and "
            f"compositor within phase 3's gates (lines above) "
            f"({time.perf_counter() - t0:.1f} s for 9b)")
    log(line)
    lines.append(line)
    del renderer, states
    torch.cuda.empty_cache()
    return lines


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1-3b only and print no result line")
    ap.add_argument("--physics-only", action="store_true",
                    help="run phases 1, 6n, 6a, 6b and 6d's EE-mode and "
                         "task rows only (the contact kernel builds the "
                         "library at its first launch) and print no result "
                         "line")
    ap.add_argument("--scans-only", action="store_true",
                    help="run phases 1, 2, 7a and 7b only and print no "
                         "result line")
    ap.add_argument("--demos-only", action="store_true",
                    help="run phases 1, 2 and 8a-8c only and print no "
                         "result line")
    ap.add_argument("--dist-only", action="store_true",
                    help="run phases 1, 2, 9a and 9b only and print no "
                         "result line")
    ap.add_argument("--train-only", action="store_true",
                    help="run phases 1, 2, 5 and 5b only (training through "
                         "the train step's graph and eagerly) and print no "
                         "result line")
    ap.add_argument("--loops-only", action="store_true",
                    help="run phases 1, 2, 6c, the xArm loop of 6d and 9a "
                         "only (the closed loops, eager and scanned) and "
                         "print no result line")
    args = ap.parse_args(argv)
    os.makedirs(OUT_DIR, exist_ok=True)
    phase_device()
    sys.path.insert(0, REPO)
    if args.physics_only:
        phase_physics()
        phase_newton()
        phase_rest()
        phase_ee_modes()
        phase_tasks()
        return           # a partial run prints no result line
    phase_build()
    if args.scans_only:
        phase_scans()
        return           # a partial run prints no result line
    if args.demos_only:
        phase_demos()
        return           # a partial run prints no result line
    if args.dist_only:
        phase_shard()
        phase_fidelity()
        return           # a partial run prints no result line
    if args.loops_only:
        phase_closed_loop()
        phase_xarm_loop()
        phase_shard()
        return           # a partial run prints no result line
    if args.train_only:
        renderer = make_renderer("cuda", NUM_ENVS, BENCH_RASTER, BENCH_SIZES)
        setup = TrainSetup(renderer.scene, TRAIN_RASTER, "cuda")
        del renderer
        phase_train(setup)
        phase_small_train()
        return           # a partial run prints no result line
    t0 = time.perf_counter()
    renderer = make_renderer("cuda", NUM_ENVS, BENCH_RASTER, BENCH_SIZES)
    states = random_states(renderer.env, STEPS, "cuda")
    setup = TrainSetup(renderer.scene, TRAIN_RASTER, "cuda")
    log(f"setup: scene of {renderer.scene.num_gaussians} Gaussians, {STEPS} "
        f"states and {TRAIN_VIEWS} training views in "
        f"{time.perf_counter() - t0:.2f} s")
    kernels = phase_kernels(renderer, states[0])
    emit_e64, sort_e64, project_entry = phase_project()
    kernels.append(project_entry)
    bwd_entry, rows_entry, emit_train, sort_train = phase_backward(setup)
    kernels += [bwd_entry, rows_entry]
    # the emit and sort entries' numbers are the render step's; their
    # times at the e64 cell's 128 frames and on the training frame ride
    # along
    keep = ("max_abs_err", "ms", "profiler_ms", "burst_ms", "call_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "gaussian_order_ms", "bits", "digest")
    for entry, e64, train in ((kernels[0], emit_e64, emit_train),
                              (kernels[1], sort_e64, sort_train)):
        entry["e64"] = {k: e64[k] for k in keep if k in e64}
        entry["train_frame"] = {k: train[k] for k in keep if k in train}
    if args.kernels_only:
        log(json.dumps({"kernels": kernels}))
        return           # a partial run prints no result line
    counts, slice_line, render_per_replay = phase_slice(renderer, states)
    # the eager render's kernels
    renderer.env.graph = False
    phase_profile(4, "render", lambda i: renderer.render(states[i]))
    renderer.env.graph = True
    phase_small_agreement()
    (train_counts, train_lines, psnr5, eager_train_counts,
     train_graph) = phase_train(setup)
    phase_small_train()
    del renderer, states, setup
    torch.cuda.empty_cache()
    physics_lines = phase_physics()
    newton_entry, newton_lines = phase_newton()
    physics_lines += newton_lines
    phase_rest()
    loop_counts, scan_counts, loop_lines = phase_closed_loop()
    ee_lines = phase_ee_modes()
    task_lines = phase_tasks()
    # (both kernels vs plain on its tinted frames ran in phase_xarm_loop,
    # on a scanned step's)
    xarm_counts, xarm_lines, wrapper = phase_xarm_loop()
    check_tint(wrapper)
    del wrapper
    torch.cuda.empty_cache()
    scans = phase_scans(psnr5)
    demo_counts, demo_lines = phase_demos()
    t9 = time.perf_counter()
    shard_counts, shard_lines = phase_shard()
    shard_lines += phase_fidelity()
    log(f"phase 9: {time.perf_counter() - t9:.1f} s")
    # launches: the render path's for its kernels, the training path's for
    # its two, the eager closed loop's for the physics' (every path's
    # counts are in the lines below); the closed loop's launches of the
    # forward kernels ride along.  The train path replays one CUDA graph
    # per iteration: its host counts are the capture's (warm-up steps and
    # capture), and the profiler counts one kernel of each per replay
    # (phase 5's lines)
    kernels.append(newton_entry)
    for k in kernels:
        k["launches"] = (train_counts if k["name"] in TRAIN_KERNELS
                         else loop_counts if k["name"] in PHYSICS_KERNELS
                         else counts)[k["name"]]
        k["train_graph_launches_at_capture"] = train_counts[k["name"]]
        k["train_graph_replays"] = train_graph["replays"]
        k["train_graph_kernels_per_replay"] = (
            None if k["name"] in RENDER_ONLY_KERNELS
            else train_graph["per_replay"][KERNEL_NAMES[k["name"]]])
        k["eager_train_launches"] = eager_train_counts[k["name"]]
        k["real2sim_train_launches"] = scans["train"][k["name"]]
        k["demo_loop_launches"] = demo_counts[k["name"]]
        if k["name"] not in TRAIN_KERNELS:
            k["closed_loop_launches"] = loop_counts[k["name"]]
            # the scanned loop launches its kernels from a graph replay:
            # the counters move at capture, the profiler counts replays
            k["scanned_loop_launches_before_replays"] = scan_counts[
                k["name"]]
            kname = KERNEL_NAMES[k["name"]]
            k["scanned_loop_kernels_per_replay"] = scan_counts[
                "per_replay"][kname]
            # the render graph's (phase 4) and the wrapper's reset graph's
            # (6c) kernels of each name per replay, by the profiler
            k["render_graph_kernels_per_replay"] = render_per_replay[kname]
            k["reset_graph_kernels_per_replay"] = scan_counts[
                "reset_per_replay"][kname]
            k["xarm_loop_launches"] = xarm_counts[k["name"]]
            k["xarm_scanned_loop_kernels_per_replay"] = xarm_counts[
                "per_replay"][kname]
            k["scan_loop_launches"] = scans["scan_loop"][k["name"]]
            k["real2sim_loop_launches"] = scans["real2sim_loop"][k["name"]]
            k["shard_loop_launches"] = shard_counts[k["name"]]
    for line in train_lines:  # repeated so the end of the log holds them
        log(line)
    log(slice_line)
    for line in (physics_lines + loop_lines + ee_lines + xarm_lines
                 + scans["lines"] + demo_lines + shard_lines):
        log(line)
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
