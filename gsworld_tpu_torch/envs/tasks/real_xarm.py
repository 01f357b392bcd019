"""RealXArm6 base env and its domain randomization (port of
gsworld_tpu/envs/tasks/real_xarm.py).

Two D435i cameras at 640x480 from the xArm hand-eye calibrations: the
wrist camera on the end-effector link (``xarm_wrist2base``), the right
camera on the robot base (``xarm_right2base``).  With
``domain_randomization=True`` every episode draws per env: object
friction ``clip(mean + std n)``, a uniform object scale, a uniform object
colour (A, 3) that the GS render multiplies into the object's splats, and
a camera pose noise (C, 6) (uniform offset, normal rotation vector) that
perturbs the sensor cameras' extrinsics.  The normal numbers come from
the episode's uniform draws through the inverse CDF, so the randomization
is a pure function of its draws, like the episode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch

from gsworld_tpu_torch import constants
from gsworld_tpu_torch.envs.base import (
    CameraSpec,
    EpisodeInit,
    GsBaseEnv,
    calib_mat2sapien_trans_mat,
    look_at_sapien,
)
from gsworld_tpu_torch.envs.registry import register_env
import gsworld_tpu_torch.envs.agents.xarm6  # noqa: F401 (registers agents)


@dataclasses.dataclass
class SO100GraspCubeDomainRandomizationConfig:
    """What the randomization draws and in which ranges."""

    initial_qpos_noise_scale: float = 0.02
    randomize_colors: bool = True
    randomize_lighting: bool = True
    max_camera_offset: Tuple[float, float, float] = (0.025, 0.025, 0.025)
    camera_target_noise: float = 0.005
    camera_view_rot_noise: float = 0.005
    camera_fov_noise: float = 0.0
    obj_scale_range: Tuple[float, float] = (0.95, 1.05)
    obj_friction_mean: float = 0.3
    obj_friction_std: float = 0.05
    obj_friction_bounds: Tuple[float, float] = (0.1, 0.5)
    randomize_obj_color: bool = True


def normal_from_uniform(u):
    """Standard normal numbers from uniform draws in [0, 1) by the inverse
    CDF, kept finite at u = 0."""
    z = (2.0 * u - 1.0).clamp(-1.0 + 2.0 ** -24, 1.0 - 2.0 ** -24)
    return math.sqrt(2.0) * torch.erfinv(z)


@register_env("RealXArm6-v1", max_episode_steps=200000)
class RealXArm6(GsBaseEnv):
    SUPPORTED_REWARD_MODES = ("none", "dense", "sparse")

    def __init__(self, *args, robot_uids="xarm6_uf_gripper",
                 domain_randomization: bool = False,
                 domain_randomization_config: dict = None, **kwargs):
        self.domain_randomization = domain_randomization
        cfg = SO100GraspCubeDomainRandomizationConfig()
        if domain_randomization_config:
            cfg = dataclasses.replace(cfg, **domain_randomization_config)
        self.domain_randomization_config = cfg
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    def _default_sensor_configs(self) -> List[CameraSpec]:
        wrist_pose = calib_mat2sapien_trans_mat(constants.xarm_wrist2base)
        right_pose = calib_mat2sapien_trans_mat(constants.xarm_right2base)
        return [
            CameraSpec("wrist_cam", 640, 480, constants.rs_d435i_rgb_k,
                       mount_link=self.agent.ee_link, local_pose=wrist_pose),
            CameraSpec("right_cam", 640, 480, constants.rs_d435i_rgb_k,
                       mount_link=self.agent.base_link, local_pose=right_pose),
        ]

    def _default_human_render_camera_configs(self):
        return [CameraSpec(
            "render_camera", 640, 480, constants.rs_d435i_rgb_k,
            mount_link=None,
            local_pose=look_at_sapien([1.7, 1.0, 0.7], [0.0, 0.0, 0.15]))]

    @property
    def dr_draws(self) -> int:
        """Per env: friction and scale per actor, 3 colour channels per
        actor, 3 offsets and 3 rotations per camera."""
        if not self.domain_randomization:
            return 0
        return 5 * len(self.actor_names) + 6 * len(self.cameras)

    def _randomize_world(self, world, task, draws):
        if not self.domain_randomization:
            return world, task
        cfg = self.domain_randomization_config
        Bn, A, C = draws.shape[0], len(self.actor_names), len(self.cameras)
        cuts = np.cumsum([0, A, A, 3 * A, 3 * C, 3 * C])
        u = [draws[:, a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        fric = (cfg.obj_friction_mean
                + cfg.obj_friction_std * normal_from_uniform(u[0]))
        lo, hi = cfg.obj_scale_range
        world = world.replace(
            a_friction=fric.clamp(*cfg.obj_friction_bounds),
            a_scale=(u[1] * (hi - lo) + lo).clamp_min(lo))
        task = dict(task)
        if cfg.randomize_colors and cfg.randomize_obj_color:
            task["obj_color"] = u[2].reshape(Bn, A, 3)
        off = torch.tensor(cfg.max_camera_offset, dtype=draws.dtype,
                           device=draws.device)
        pos_noise = (u[3].reshape(Bn, C, 3) * 2.0 - 1.0) * off
        rot_noise = (cfg.camera_view_rot_noise
                     * normal_from_uniform(u[4]).reshape(Bn, C, 3))
        task["cam_pose_noise"] = torch.cat([pos_noise, rot_noise], dim=-1)
        return world, task

    def _initialize_episode(self, draws):
        Bn = draws.shape[0]
        q = torch.as_tensor(
            np.asarray(constants.robot_task_init_qpos[self.robot_uids],
                       np.float32), device=draws.device)
        return EpisodeInit(
            qpos=q.expand(Bn, -1).clone(),
            a_pos=torch.zeros((Bn, 0, 3), device=draws.device),
            a_quat=torch.zeros((Bn, 0, 4), device=draws.device), task={})
