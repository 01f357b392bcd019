"""The reference of a closed-loop configuration whose env takes keyword
arguments of its own (``env_kwargs``): the xArm6 align task under
GSWorld's domain randomization.  The check is ``closed_loop.py``'s, with
its ``compare``, ``Tally`` and ``projected`` unchanged: a reset is
checked from its seed alone, so the reference draws the episode's
randomization itself (per-env object friction, scale and colour, the
camera pose noise), and the check holds the program to those draws in
the state (``a_friction``, ``a_scale``, ``obj_color``,
``cam_pose_noise``) and in the frames they tint and move.

The reference computes its render's first half (forward kinematics,
slot transforms, repose, camera bridge) over every env of the loop's
batch, as the loop does, and projects, bins and composites the sampled
envs alone.  Those batched products round by their batch in float32
(the camera matrices of one wrist frame differ by 1 ulp between a 64-
and a 4-env batch), and a Gaussian on the edge of a cull is kept in one
and culled in the other, so a frame rendered from 4 envs can differ in
a patch from the same frame rendered from 64.  Compositing all 64 envs
would take more memory than the card has.

The xArm modules it registers (``gsw/envs/agents/xarm6.py``,
``gsw/envs/tasks/real_xarm.py``, ``gsw/envs/tasks/tabletop/xarm6/``)
are copies of gsworld_tpu_torch's at commit 3aa1745 (unchanged there
since before e3f5779, the commit of the rest of ``gsw/``), renamed, with
no kernel; the five helpers the task takes from the FR3 tasks are
inlined in ``align.py``.  Their docstrings note where they depart from
GSWorld's published description.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from benchmark.reference import closed_loop


class LoopReference(closed_loop.LoopReference):
    """The reference env and renderer of a closed-loop configuration, the
    env made with the configuration's ``env_kwargs``."""

    def __init__(self, config: dict, num_envs: int, device, tf32=False):
        from benchmark.reference.gsw import envs
        # registers AlignXArmEnv-v1
        from benchmark.reference.gsw.envs.tasks.tabletop.xarm6 import (
            align,  # noqa: F401
        )
        from benchmark.reference.gsw.render.camera import RasterConfig
        from benchmark.reference.gsw.wrapper.gs_env import GSWorldWrapper
        self.device = torch.device(device)
        self.tf32 = tf32
        r = config["raster"]
        env = envs.make(config["env_id"], num_envs=num_envs,
                        obs_mode=config["obs_mode"],
                        control_mode=config["control_mode"],
                        sim_config=dict(sim_freq=config["sim_freq"],
                                        control_freq=config["control_freq"]),
                        device=self.device, **config["env_kwargs"])
        env.cameras = [dataclasses.replace(c, width=r["width"],
                                           height=r["height"])
                       for c in env.cameras]
        self.env = env
        self.wrapper = GSWorldWrapper(
            env, config["scene"],
            raster_config=RasterConfig(
                width=r["width"], height=r["height"], tile=r["tile"],
                max_tiles_per_gaussian=r["max_tiles_per_gaussian"],
                max_entries=r["max_entries"]),
            synthetic_sizes=config["synthetic_sizes"], device=self.device)

    @torch.no_grad()
    def run(self, sample: closed_loop.Sample, envs: List[int]) -> dict:
        """``closed_loop.LoopReference.run``, its render's first half
        computed over every env (``render_sampled``)."""
        from benchmark.reference.gsw.wrapper.gs_env import world_poses
        env = self.env
        with closed_loop.precision(self.tf32):
            out = {}
            if sample.kind == "reset":
                state = env._reset_layout(*env.reset_draws(sample.seed))
            else:
                (state, _, out["reward"], out["terminated"],
                 out["truncated"], _) = env._step_fn(
                    self.state_from(sample.before),
                    sample.action.to(self.device))
            out["frames"] = render_sampled(
                self.wrapper.renderer, world_poses(state.world, state.task),
                torch.as_tensor(envs, device=self.device))
            out["state"] = state
        return out


def sampled_frames(renderer, poses, idx):
    """The render's first half (FK, slot transforms, repose, camera
    bridge) of every env of ``poses``, then the rows of the envs ``idx``
    -> (posed Gaussians (b, 1, N, ...), GS cameras (b, C), tint (b, 1, N,
    3) or None).  A camera field shared by every env, (C,), is kept
    whole."""
    posed, cams = renderer.frames(poses)
    tint = renderer.color_tint(poses.obj_color)
    return (type(posed)(*(x[idx] for x in posed)),
            type(cams)(*(x[idx] if x.dim() >= 2 else x for x in cams)),
            None if tint is None else tint[idx][:, None])


def render_sampled(renderer, poses, idx) -> dict:
    """The reference renderer's ``render`` of the envs ``idx`` of
    ``poses`` through the sensor cameras, from ``sampled_frames``."""
    from benchmark.reference.gsw.render.rasterize import render as gs_render
    posed, cams, tint = sampled_frames(renderer, poses, idx)
    scene, env = renderer.scene, renderer.env
    want_seg = "segmentation" in env.obs_mode
    out = gs_render(posed, cams, renderer.raster_config, scene.sh0,
                    scene.shN,
                    semantics=scene.semantics if want_seg else None,
                    color_tint=tint)
    renderer.last_overflow = out["overflow"]
    imgs = torch.clamp(out["rgb"] * 255.0, 0, 255).to(torch.uint8)
    result = {}
    for ci, cam in enumerate(env.cameras):
        result[cam.name] = {"rgb": imgs[:, ci]}
        if want_seg:
            result[cam.name]["segmentation"] = (
                out["seg"][:, ci, :, :, None].to(torch.int16))
    return result
