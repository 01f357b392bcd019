#!/usr/bin/env python3
"""Render fidelity of the bench raster against the port's own render with
the caps lifted (port of tools/render_parity.py).

The bench raster (tile 32, D = 64 tiles per Gaussian, E = 393216 entries
per frame) drops entries when a frame asks for more (``overflow``).  The
reference here is the same render with D = the frame's tile count (no
Gaussian's rect is shrunk) and E doubled from 2^19 until ``overflow``
reads 0 in every frame, up to 2^23.  Per camera, over every env of every
state: uint8 PSNR (min and median; also against the render with the
bench D and the lifted E, which prices the E budget alone), max |diff|,
the share of equal
segmentation pixels, the entries the bench render dropped (its
``overflow``, which counts the E budget's loss) and the pre-cull entries
its D cap shrank away (the centred D cap shrinks a rect in the
projection, before ``overflow`` is counted).

    python3 gsworld_tpu_torch/tools/render_parity.py [--num_envs 4]
        [--states 10] [--device cuda]

The command line renders the AlignFr3 closed loop's states: a reset and
``--states - 1`` random-action steps at 640x480 on the full synthetic
scene.  ``chip_smoke.py`` (phase 9b) calls :func:`compare` on its own
render states.
"""

import argparse
import dataclasses
import json
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

E_START = 1 << 19
E_MAX = 1 << 23


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR (dB) of two uint8 images; inf where they are equal."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(
        10 * np.log10(255.0 ** 2 / mse))


def render_with(renderer, poses, cfg):
    """Render ``poses`` with the raster config ``cfg`` -> (per camera
    {"rgb", "segmentation"} on the host, overflow (B, C) on the host)."""
    out = renderer.render(poses, raster_config=cfg)
    host = {cam: {k: v.cpu().numpy() for k, v in o.items()}
            for cam, o in out.items()}
    return host, renderer.last_overflow.cpu().numpy()


def pre_cull_entries(renderer, poses, cfg) -> np.ndarray:
    """Entries (tile, Gaussian) the projection with ``cfg`` asks for
    before the alpha cull, per frame (B, C): what the D cap shrinks."""
    from gsworld_tpu_torch.render.rasterize import project_frames
    with torch.no_grad():
        posed, cams = renderer.frames(poses)
        flat, lead = project_frames(posed, cams, cfg, renderer.scene.sh0,
                                    renderer.scene.shN)
        r = flat.rect.long()
        area = ((r[..., 2] - r[..., 0]) * (r[..., 3] - r[..., 1])
                ).clamp_min(0)
        valid = (flat.radius > 0) & torch.isfinite(flat.depth)
        return (area * valid).sum(-1).reshape(lead).cpu().numpy()


def lifted_config(cfg, E: int):
    """``cfg`` with D = its tile count and E = ``E``."""
    return dataclasses.replace(cfg, max_tiles_per_gaussian=cfg.num_tiles,
                               max_entries=E)


def uncapped_render(renderer, poses, e_start: int = E_START):
    """The render of ``poses`` with D lifted and E doubled from
    ``e_start`` until no frame drops an entry -> (frames as
    :func:`render_with` gives them, the config).  Raises when E would
    pass E_MAX."""
    E = e_start
    while True:
        cfg = lifted_config(renderer.raster_config, E)
        frames, overflow = render_with(renderer, poses, cfg)
        if int(overflow.max()) == 0:
            return frames, cfg
        if 2 * E > E_MAX:
            raise RuntimeError(f"overflow {int(overflow.max())} at E = {E}: "
                               f"more than E = {E_MAX} entries a frame")
        E *= 2


def compare(renderer, states):
    """Bench render (the renderer's config) against the uncapped render of
    each pose state in ``states`` -> a dict: per camera the PSNR (min,
    median, per frame), the PSNR against the render with the bench D and
    the lifted E (the E budget's cost alone; min, median), max |diff|,
    segmentation agreement and dropped
    entries (``overflow``: the E budget's loss; max, mean, per frame), the
    pre-cull entries the D cap took from the bench render (max, mean);
    the bench and lifted D and E."""
    per = {}
    E = E_START
    for poses in states:
        bench, overflow = render_with(renderer, poses,
                                      renderer.raster_config)
        ref, cfg = uncapped_render(renderer, poses, E)
        E = cfg.max_entries          # the next state starts where this ended
        shrunk = (pre_cull_entries(renderer, poses, cfg)
                  - pre_cull_entries(renderer, poses, renderer.raster_config))
        # the bench D with the lifted E: what the E budget alone costs
        bench_cfg = renderer.raster_config
        e_only, e_overflow = render_with(renderer, poses, dataclasses.replace(
            bench_cfg, max_entries=max(E, bench_cfg.max_entries)))
        if int(e_overflow.max()):
            raise RuntimeError("the bench D dropped entries at the lifted E")
        for ci, cam in enumerate(bench):
            d = per.setdefault(cam, dict(psnr=[], psnr_e=[], max_abs=0,
                                         seg_equal=0, pixels=0, dropped=[],
                                         shrunk=[]))
            a, b = bench[cam]["rgb"], ref[cam]["rgb"]
            d["psnr"] += [psnr_u8(x, y) for x, y in zip(a, b)]
            d["psnr_e"] += [psnr_u8(x, y)
                            for x, y in zip(a, e_only[cam]["rgb"])]
            d["max_abs"] = max(d["max_abs"], int(np.abs(
                a.astype(np.int32) - b.astype(np.int32)).max()))
            if "segmentation" in bench[cam]:
                sa, sb = bench[cam]["segmentation"], ref[cam]["segmentation"]
                d["seg_equal"] += int((sa == sb).sum())
                d["pixels"] += sa.size
            d["dropped"] += overflow[:, ci].astype(int).tolist()
            d["shrunk"] += shrunk[:, ci].astype(int).tolist()
    cameras = {}
    for cam, d in per.items():
        cameras[cam] = dict(
            psnr_min=min(d["psnr"]), psnr_median=statistics.median(d["psnr"]),
            psnr=d["psnr"], psnr_e_min=min(d["psnr_e"]),
            psnr_e_median=statistics.median(d["psnr_e"]),
            max_abs_diff=d["max_abs"],
            seg_agreement=(d["seg_equal"] / d["pixels"] if d["pixels"]
                           else None),
            dropped_max=max(d["dropped"]),
            dropped_mean=statistics.fmean(d["dropped"]),
            dropped=d["dropped"], d_cap_max=max(d["shrunk"]),
            d_cap_mean=statistics.fmean(d["shrunk"]))
    bcfg = renderer.raster_config
    return dict(cameras=cameras,
                bench=dict(D=bcfg.max_tiles_per_gaussian,
                           E=bcfg.max_entries),
                lifted=dict(D=bcfg.num_tiles, E=E))


def loop_states(wrapper, n: int, seed: int = 0):
    """The pose states of a reset and ``n - 1`` random-action steps."""
    from gsworld_tpu_torch.wrapper.gs_env import world_poses
    env = wrapper.env
    wrapper.reset(seed=seed)
    gen = torch.Generator().manual_seed(seed)
    states = [world_poses(env.state.world, env.state.task)]
    for _ in range(n - 1):
        wrapper.step(env.action_space_sample(gen))
        states.append(world_poses(env.state.world, env.state.task))
    return states


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_envs", type=int, default=4)
    ap.add_argument("--states", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from gsworld_tpu_torch.rollout.random_actions import build
    _, wrapper = build("AlignFr3Env-v1", args.num_envs, "fr3_align", 120, 40,
                       640, 480, obs_mode="rgb+segmentation",
                       max_entries=393216, device=args.device)
    res = compare(wrapper.renderer,
                  loop_states(wrapper, args.states, args.seed))
    for cam, d in res["cameras"].items():
        print(f"{cam}: PSNR min {d['psnr_min']:.2f} dB, median "
              f"{d['psnr_median']:.2f} (E budget alone: min "
              f"{d['psnr_e_min']:.2f}, median {d['psnr_e_median']:.2f}), "
              f"max |diff| {d['max_abs_diff']}, "
              f"segmentation agreement {d['seg_agreement']:.6f}, dropped "
              f"entries max {d['dropped_max']} mean {d['dropped_mean']:.1f}, "
              f"D cap max {d['d_cap_max']} mean {d['d_cap_mean']:.1f}")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
