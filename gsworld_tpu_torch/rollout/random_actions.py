"""Random-action closed-loop rollout (port of
gsworld_tpu/rollout/random_actions.py): build the env and its GS wrapper,
roll random actions for ``ep_len`` steps and measure the closed-loop rate
(env steps per second including the GS render across all envs).

    python -m gsworld_tpu_torch.rollout.random_actions -n 4 --ep_len 30
    python -m gsworld_tpu_torch.rollout.random_actions -n 4 --ep_len 30 --scan

``--scan`` runs the scanned loop, the counterpart of the JAX package's
``lax.scan`` of the whole episode: each step replays one CUDA graph of
the wrapper's whole step (physics, observation and GS render), with no
host read between steps.  Runs on the card unless ``--device cpu`` is
given.  The command line's
defaults are the benchmark's configuration (``rgb+segmentation``, tile
32, 64 tiles per Gaussian, 393216 entries per frame); ``build``'s own
defaults are the smaller ones the tests use.  Another task:
``-e AlignXArmEnv-v1 --cfg_name xarm6_align``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time

import numpy as np
import torch

from gsworld_tpu_torch.utils import cuda_graph


def build(env_id: str, num_envs: int, cfg_name: str, sim_freq: int,
          control_freq: int, width: int, height: int,
          synthetic_scale: float = 1.0, obs_mode: str = "rgb",
          max_tiles_per_gaussian: int = 64, tile: int = 32,
          max_entries: int = 1 << 19, device="cuda", graph: bool = True,
          asset_dir=None, cfg_dir=None, **env_kwargs):
    """-> (env, wrapper).  ``graph`` steps the env and the wrapper through
    CUDA graphs of their whole step (ignored on the CPU); ``asset_dir``
    and ``cfg_dir`` say where the scene config and its scans are (the
    wrapper merges the scans when they exist); ``env_kwargs`` go to the
    env (e.g. ``domain_randomization=True``, ``control_mode``)."""
    from gsworld_tpu_torch import envs
    from gsworld_tpu_torch.render.camera import RasterConfig
    from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper

    env = envs.make(env_id, num_envs=num_envs, obs_mode=obs_mode,
                    sim_config=dict(sim_freq=sim_freq,
                                    control_freq=control_freq),
                    device=device, graph=graph, **env_kwargs)
    env.cameras = [dataclasses.replace(c, width=width, height=height)
                   for c in env.cameras]
    sizes = dict(
        n_background=int(120_000 * synthetic_scale),
        n_per_link=int(6_000 * synthetic_scale),
        n_per_object=int(6_000 * synthetic_scale))
    wrapper = GSWorldWrapper(
        env, cfg_name,
        raster_config=RasterConfig(
            width=width, height=height, tile=tile,
            max_tiles_per_gaussian=max_tiles_per_gaussian,
            max_entries=max_entries),
        asset_dir=asset_dir, cfg_dir=cfg_dir, synthetic_sizes=sizes,
        device=device)
    return env, wrapper


SCAN_REPS = 3   # timed reps of the scanned loop; the best one counts


def _host_read(obs, env) -> np.ndarray:
    """The first camera's frames on the host: ends every queued kernel."""
    return obs["sensor_data"][env.cameras[0].name]["rgb"].cpu().numpy()


def _synchronize(devices):
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def scan_shards(wrappers, actions):
    """Step each of ``wrappers`` (shards of one loop, each on its own
    device) through its own ``actions`` (n, B_k, A), one step of every
    shard after another, from the states their envs hold -> (env 0's
    first-camera frames of the first shard, (n, H, W, 3) uint8, and the
    mean of every step's first-camera rgb over all envs of all shards,
    (n,) f32, the JAX package's per-step sums of its scanned loop), both
    on the first shard's device; each env is left at its new state.

    On the card each shard replays its wrapper's ``step_graph``: one load
    of the shard's state, then per step one copy of the step's actions
    into the graph's input and one replay, queued with the shard's device
    current, one sum of the shard's frames and one copy of the frame into
    a buffer made before the first step, with no host read or copy to the
    host before the end; each env then takes a clone of its graph's
    state.  On the CPU the same steps run eagerly (the plain version of
    the same function)."""
    n = actions[0].shape[0]
    w0 = wrappers[0]
    cam = w0.env.cameras[0].name
    if not cuda_graph.graphed(True, w0.env.device):
        frames, sums = [], []
        for i in range(n):
            total = 0.0
            for k, (w, a) in enumerate(zip(wrappers, actions)):
                w.env._state, obs, *_ = w._step_and_render(w.env._state,
                                                           a[i])
                rgb = obs["sensor_data"][cam]["rgb"]
                total = total + rgb.sum(dtype=torch.float64)
                if k == 0:
                    frames.append(rgb[0])
            sums.append(total)
        frames = torch.stack(frames)
        count = sum(w.num_envs for w in wrappers) * frames[0].numel()
        return frames, (torch.stack(sums) / count).to(torch.float32)
    graphs = [w.step_graph(a[0]) for w, a in zip(wrappers, actions)]
    for w, g in zip(wrappers, graphs):
        g.load(w.env._state, None)
    # the graph's outputs: (state, obs, reward, terminated, truncated, info)
    rgb = [g.outputs[1]["sensor_data"][cam]["rgb"] for g in graphs]
    src = rgb[0][0]
    frames = torch.empty((n,) + tuple(src.shape), dtype=src.dtype,
                         device=src.device)
    sums = [torch.zeros(n, dtype=torch.float64, device=g.device)
            for g in graphs]
    for i in range(n):
        for k, (g, a) in enumerate(zip(graphs, actions)):
            g.load(None, a[i])
            g.replay()
            with cuda_graph.device_guard(g.device):
                sums[k][i] = rgb[k].sum(dtype=torch.float64)
                if k == 0:
                    frames[i].copy_(src)
    for w, g in zip(wrappers, graphs):
        with cuda_graph.device_guard(g.device):
            w.env._state = cuda_graph.clone_tree(g.inputs[0])
        w.renderer.last_overflow = w._step_overflow
    count = sum(w.num_envs for w in wrappers) * src.numel()
    with cuda_graph.device_guard(src.device):
        total = sum(s.to(src.device) for s in sums)
        return frames, (total / count).to(torch.float32)


def scan_steps(wrapper, actions, state=None):
    """The scanned loop (the JAX package's ``scan_fn``): ``actions`` (n,
    B, A) on the env's device stepped from ``state`` (default: the env's
    own) -> (env 0's first-camera frames (n, H, W, 3) uint8, each step's
    first-camera rgb mean over the envs (n,) f32); the env is left at the
    new state.  On the card every step replays the wrapper's CUDA graph of
    its whole step, and a capture that fails raises (the scanned loop
    never runs eagerly on the card); on the CPU the steps run eagerly."""
    if state is not None:
        wrapper.env._state = state
    return scan_shards([wrapper], [actions])


def rollout_fps(wrapper, ep_len: int, seed: int = 0, warmup: int = 2,
                use_scan: bool = False, shard: bool = False,
                on_timed_start=None):
    """Run the closed loop and return (env-steps/s, seconds per step,
    frames).

    Eager (``use_scan=False``): the loop is on the host, as a user's is;
    each step replays the wrapper's CUDA graph of its whole step when the
    env was built on the card with ``graph=True``.  After ``warmup``
    steps, ``ep_len`` timed steps; the clock stops after a synchronize and
    a host read of the last frame, and ``frames`` are the last step's
    first-camera frames (B, H, W, 3) uint8.

    Scanned (``use_scan=True``), timed as the JAX package times its
    ``lax.scan``: with ``warmup``, one whole scan of ``ep_len`` steps (the
    JAX package's compile call; the capture is in its first step), then
    SCAN_REPS reps of ``ep_len`` steps, each continuing from the state
    the last one left, each with its own actions, drawn up front from the
    loop's CPU generator (so a seed gives the eager loop's actions).  Each
    rep computes on the device the per-step mean of the first camera's
    rgb over all envs, and its clock stops after a synchronize and the
    host read of those ``ep_len`` floats; the best rep counts.  The last
    rep's frames are copied to the host after its clock: env 0's
    first-camera frames of every step, (ep_len, H, W, 3) uint8.

    ``shard`` splits the env axis over every visible card
    (``dist.mesh.env_mesh()``; over the CPU for an env built there): a
    ``dist.sharded.ShardedLoop`` of the wrapper, whose env i steps as
    env i of the unsharded loop.  ``on_timed_start()`` is called after the
    reset and the warm-up steps, just before the clock starts (a caller's
    counters start there).
    """
    env = wrapper.env
    loop, devices = wrapper, [env.device]
    if shard:
        from gsworld_tpu_torch.dist.mesh import env_mesh
        from gsworld_tpu_torch.dist.sharded import ShardedLoop
        mesh = env_mesh(None if env.device.type == "cuda" else [env.device])
        loop, devices = ShardedLoop(wrapper, mesh), list(mesh)
    obs, _ = loop.reset(seed=seed)
    gen = torch.Generator().manual_seed(seed)    # same actions on any device
    if use_scan:
        scan = (loop.scan_steps if shard
                else functools.partial(scan_steps, wrapper))
        if warmup:
            scan(env.action_space_sample(gen, steps=ep_len))[1].cpu()
        _synchronize(devices)
        if on_timed_start is not None:
            on_timed_start()
        best = float("inf")
        for _ in range(SCAN_REPS):
            actions = env.action_space_sample(gen, steps=ep_len)
            t0 = time.perf_counter()
            frames, means = scan(actions)
            _synchronize(devices)
            means.cpu().numpy()
            best = min(best, time.perf_counter() - t0)
        return ep_len * env.num_envs / best, best / ep_len, \
            frames.cpu().numpy()
    for _ in range(warmup):
        obs, *_ = loop.step(env.action_space_sample(gen))
    _host_read(obs, env)
    _synchronize(devices)
    if on_timed_start is not None:
        on_timed_start()
    t0 = time.perf_counter()
    for _ in range(ep_len):
        obs, *_ = loop.step(env.action_space_sample(gen))
    _synchronize(devices)
    frames = _host_read(obs, env)
    dt = time.perf_counter() - t0
    return ep_len * env.num_envs / dt, dt / ep_len, frames


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--env_id", "-e", default="AlignFr3Env-v1")
    p.add_argument("--cfg_name", default="fr3_align")
    p.add_argument("--num_envs", "-n", type=int, default=1)
    p.add_argument("--ep_len", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sim_freq", type=int, default=120)
    p.add_argument("--control_freq", type=int, default=40)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--synthetic_scale", type=float, default=1.0)
    p.add_argument("--obs_mode", default="rgb+segmentation")
    p.add_argument("--tile", type=int, default=32)
    p.add_argument("--max_tiles_per_gaussian", type=int, default=64)
    p.add_argument("--max_entries", type=int, default=393216)
    p.add_argument("--scan", action="store_true",
                   help="the scanned loop: one CUDA graph replay of the "
                        "whole step per step, best of 3 reps")
    p.add_argument("--no_graph", action="store_true",
                   help="step eagerly in the eager loop (the scanned loop "
                        "always replays its graph)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--save_video_dir", default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    env, wrapper = build(args.env_id, args.num_envs, args.cfg_name,
                         args.sim_freq, args.control_freq, args.width,
                         args.height, args.synthetic_scale,
                         obs_mode=args.obs_mode, tile=args.tile,
                         max_tiles_per_gaussian=args.max_tiles_per_gaussian,
                         max_entries=args.max_entries, device=args.device,
                         graph=not args.no_graph)
    fps, spf, frames = rollout_fps(wrapper, args.ep_len, args.seed,
                                   use_scan=args.scan)
    print(f"FPS: {fps:.2f} (env-steps/s incl. GS render, "
          f"{args.num_envs} envs, {spf*1000:.1f} ms/step)")
    if args.save_video_dir and args.scan:
        # env 0's first camera, one frame per step (JAX's CLI saves
        # frames[:, 0], the first pixel row of each frame: not copied)
        from gsworld_tpu_torch.rollout.io_utils import save_images_to_dir
        save_images_to_dir(frames, args.save_video_dir)
    elif args.save_video_dir:
        import os
        os.makedirs(args.save_video_dir, exist_ok=True)
        np.save(os.path.join(args.save_video_dir, "last_frames.npy"), frames)
    return fps


if __name__ == "__main__":
    main()
