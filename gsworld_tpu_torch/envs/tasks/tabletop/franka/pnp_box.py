"""PnpBoxFr3Env-v1: pick the mustard bottle and place it into the snack
box (port of gsworld_tpu/envs/tasks/tabletop/franka/pnp_box.py).

The bottle spawns at a random yaw; bottle and box swap places half of the
time.  Success = the bottle's xy within the box footprint (less 2 cm),
not grasped, the bottle static.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gsworld_tpu_torch import constants
from gsworld_tpu_torch.core.maths import axis_angle_to_quat
from gsworld_tpu_torch.envs.base import EpisodeInit
from gsworld_tpu_torch.envs.registry import register_env
from gsworld_tpu_torch.envs.tasks.real_fr3 import RealFr3
from gsworld_tpu_torch.physics import builders as B

GOAL_HALF = np.array([0.33 * 0.5, 0.195 * 0.5, 0.065 * 0.5], np.float32)
IDENTITY_Q = (1.0, 0.0, 0.0, 0.0)


def random_z_quat(u, bounds=(0.0, 2.0 * math.pi)):
    """Yaw-only orientations (B, 4) from uniform draws ``u`` (B,) in
    [0, 1): the angle ``lo + u (hi - lo)``, as a uniform draw in bounds."""
    lo, hi = bounds
    ang = (u * (hi - lo) + lo).clamp_min(lo)
    return axis_angle_to_quat(torch.stack([0.0 * ang, 0.0 * ang, ang],
                                          dim=-1))


def fixed_quats(Bn, device, *quats):
    """(B, len(quats), 4) of constant orientations given as wxyz tuples or
    (4,) tensors, made on the CPU and copied, so every device gets the
    same bits."""
    q = torch.stack([torch.as_tensor(v, dtype=torch.float32).cpu()
                     for v in quats])
    return q.to(device).expand(Bn, len(quats), 4).clone()


def swap_xy(a, b, swap):
    """``a``, ``b`` (B, 3) with their xy exchanged where ``swap`` (B,)."""
    s = swap[:, None]
    a2 = torch.where(s, b[:, :2], a[:, :2])
    b2 = torch.where(s, a[:, :2], b[:, :2])
    return (torch.cat([a2, a[:, 2:]], dim=-1),
            torch.cat([b2, b[:, 2:]], dim=-1))


def init_qpos(env, Bn, device):
    q = torch.as_tensor(
        np.asarray(constants.robot_task_init_qpos[env.robot_uids],
                   np.float32), device=device)
    return q.expand(Bn, -1).clone()


@register_env("PnpBoxFr3Env-v1", max_episode_steps=50)
class PnpBoxFr3Env(RealFr3):
    SUPPORTED_ROBOTS = ("fr3_umi", "fr3_umi_wrist435")
    goal_thresh = 0.025
    actor_names = ("006_mustard_bottle", "snack_box")
    obj_name, goal_name = actor_names
    x_offset = 0.615
    goal_height = 0.033
    obj_height = 0.098
    # bottle x, y; box x, y; bottle yaw; swap
    episode_draws = 6

    def __init__(self, *args, robot_uids="fr3_umi",
                 robot_init_qpos_noise=0.02, num_envs=1, **kwargs):
        super().__init__(*args, robot_uids=robot_uids, num_envs=num_envs,
                         robot_init_qpos_noise=robot_init_qpos_noise,
                         **kwargs)

    def _load_scene(self):
        # the YCB mustard bottle as its bounding convex box
        self._actor_defs = [
            B.box_actor("006_mustard_bottle", [0.048, 0.031, 0.0955],
                        friction=0.6),
            B.box_actor("snack_box", GOAL_HALF, friction=0.6),
        ]

    def _initialize_episode(self, draws) -> EpisodeInit:
        Bn, dev = draws.shape[0], draws.device
        u = draws.to(torch.float32)
        xo = self.x_offset
        full = lambda v: torch.full((Bn,), v, device=dev)     # noqa: E731
        obj = torch.stack([u[:, 0] * 0.2 - 0.25 + xo, u[:, 1] * 0.1 + 0.1,
                           full(self.obj_height)], dim=-1)
        goal = torch.stack([u[:, 2] * 0.2 - 0.25 + xo, u[:, 3] * 0.1 - 0.2,
                            full(self.goal_height)], dim=-1)
        q = random_z_quat(u[:, 4])
        obj, goal = swap_xy(obj, goal, u[:, 5] > 0.5)
        a_quat = torch.stack([q, fixed_quats(Bn, dev, IDENTITY_Q)[:, 0]],
                             dim=1)
        return EpisodeInit(qpos=init_qpos(self, Bn, dev),
                           a_pos=torch.stack([obj, goal], dim=1),
                           a_quat=a_quat, task={})

    def evaluate(self, data):
        p, _ = self.actor_pose(data, self.obj_name)
        pg, _ = self.actor_pose(data, self.goal_name)
        half_xy_goal = float(GOAL_HALF[:2].max())
        in_box = (torch.linalg.norm(p[:, :2] - pg[:, :2], dim=-1)
                  <= half_xy_goal - 0.02)
        grasped = self.is_grasping(data, self.obj_name)
        robot_static = self.agent_is_static(data, 0.2)
        obj_static = self.actor_is_static(data, self.obj_name)
        success = in_box & (~grasped) & obj_static
        return {"is_grasped": grasped, "is_obj_in_box": in_box,
                "is_robot_static": robot_static, "is_obj_static": obj_static,
                "success": success}

    def _get_obs_extra(self, data, info):
        tcp_p, tcp_q = self.tcp_pose(data)
        pg, _ = self.actor_pose(data, self.goal_name)
        obs = dict(tcp_pose=torch.cat([tcp_p, tcp_q], dim=-1), goal_pos=pg,
                   is_grasped=info["is_grasped"])
        if "state" in self.obs_mode:
            p, q = self.actor_pose(data, self.obj_name)
            obs.update(tcp_to_goal_pos=pg - tcp_p,
                       obj_pose=torch.cat([p, q], dim=-1),
                       tcp_to_obj_pos=p - tcp_p, obj_to_goal_pos=pg - p)
        return obs

    def compute_dense_reward(self, data, action, info):
        tcp_p, _ = self.tcp_pose(data)
        p, _ = self.actor_pose(data, self.obj_name)
        pg, _ = self.actor_pose(data, self.goal_name)
        dist = lambda a, b: torch.linalg.norm(a - b, dim=-1)  # noqa: E731
        reward = 1.0 - torch.tanh(5.0 * dist(p, tcp_p))
        grasped = info["is_grasped"]
        reward = reward + 1.0 * grasped
        transport = 1.0 - torch.tanh(5.0 * dist(pg, p))
        reward = reward + transport * grasped
        in_box = info["is_obj_in_box"]
        reward = reward + 1.0 * in_box + 1.0 * (in_box & ~grasped)
        reward = reward + 1.0 * (in_box & info["is_obj_static"]
                                 & info["is_robot_static"])
        return torch.where(info["success"], 6.0, reward)
