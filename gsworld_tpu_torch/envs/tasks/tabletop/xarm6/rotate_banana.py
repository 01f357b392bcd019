"""BananaRotationXArmEnv-v1: turn the banana by more than 30 degrees while
it stays on the table (port of gsworld_tpu/envs/tasks/tabletop/xarm6/
rotate_banana.py).

The banana spawns at yaw +90 deg.  Success = turned > 30 deg from that,
its height 2-5 cm from the spawn height, not grasped (any force
direction), robot static.
"""

from __future__ import annotations

import math

import torch

from gsworld_tpu_torch.core.maths import axis_angle_to_quat, quat_angle_between
from gsworld_tpu_torch.envs.base import EpisodeInit
from gsworld_tpu_torch.envs.registry import register_env
from gsworld_tpu_torch.envs.tasks.tabletop.franka.pnp_box import (
    fixed_quats,
    init_qpos,
)
from gsworld_tpu_torch.envs.tasks.tabletop.xarm6.align import XArmTabletop
from gsworld_tpu_torch.physics import builders as B


@register_env("BananaRotationXArmEnv-v1", max_episode_steps=100)
class BananaRotationXArmEnv(XArmTabletop):
    rotation_thresh = 30.0   # degrees
    actor_names = ("011_banana",)
    obj_name = actor_names[0]
    obj_height = 0.019
    # banana x, y
    episode_draws = 2

    def _load_scene(self):
        # the YCB banana as a flat convex box (~19 x 4 x 3.6 cm)
        self._actor_defs = [
            B.box_actor("011_banana", [0.095, 0.019, 0.018], friction=0.6),
        ]

    def _banana_init_q(self, device=None):
        """The spawn orientation, yaw +90 deg, made on the CPU and copied
        to ``device`` once: ``evaluate`` runs inside a captured step,
        where nothing is copied from the host."""
        cache = self.__dict__.setdefault("_init_q", {})
        key = None if device is None else torch.device(device)
        if key not in cache:
            q = axis_angle_to_quat(torch.tensor([0.0, 0.0, math.pi / 2]))
            cache[key] = q if device is None else q.to(device)
        return cache[key]

    def _initialize_episode(self, draws) -> EpisodeInit:
        Bn, dev = draws.shape[0], draws.device
        u = draws.to(torch.float32)
        xo = self.x_offset
        pos = torch.stack([xo + u[:, 0] * 0.2 - 0.3, u[:, 1] * 0.2 - 0.1,
                           torch.full((Bn,), self.obj_height, device=dev)],
                          dim=-1)
        return EpisodeInit(
            qpos=init_qpos(self, Bn, dev), a_pos=pos[:, None],
            a_quat=fixed_quats(Bn, dev, self._banana_init_q()), task={})

    def evaluate(self, data):
        p, q = self.actor_pose(data, self.obj_name)
        rotation_diff = quat_angle_between(q, self._banana_init_q(q.device))
        is_rot = rotation_diff > self.rotation_thresh
        dz = (p[:, 2] - self.obj_height).abs()
        at_height = (dz <= 0.05) & (dz >= 0.02)
        grasped = self.is_grasping(data, self.obj_name, max_angle=180.0)
        robot_static = self.agent_is_static(data, 0.2)
        banana_static = self.actor_is_static(data, self.obj_name)
        success = is_rot & at_height & (~grasped) & robot_static
        return {"is_grasped": grasped, "is_rotation_correct": is_rot,
                "is_at_table_height": at_height,
                "is_robot_static": robot_static,
                "is_banana_static": banana_static,
                "rotation_diff_degrees": rotation_diff,
                "success": success}

    def _get_obs_extra(self, data, info):
        tcp_p, tcp_q = self.tcp_pose(data)
        p, q = self.actor_pose(data, self.obj_name)
        return dict(tcp_pose=torch.cat([tcp_p, tcp_q], dim=-1),
                    obj_pose=torch.cat([p, q], dim=-1),
                    is_grasped=info["is_grasped"],
                    rotation_diff=info["rotation_diff_degrees"])

    def compute_dense_reward(self, data, action, info):
        tcp_p, _ = self.tcp_pose(data)
        p, _ = self.actor_pose(data, self.obj_name)
        reward = 1.0 - torch.tanh(5.0 * torch.linalg.norm(p - tcp_p, dim=-1))
        reward = reward + 1.0 * info["is_grasped"]
        reward = reward + 2.0 * torch.tanh(
            info["rotation_diff_degrees"] / self.rotation_thresh)
        return torch.where(info["success"], 6.0, reward)
