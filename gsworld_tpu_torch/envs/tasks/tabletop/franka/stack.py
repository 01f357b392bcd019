"""StackFr3Env-v1: stack the DTC red tomato can onto the YCB tomato soup
can (port of gsworld_tpu/envs/tasks/tabletop/franka/stack.py).

The goal is the upright YCB can, the object the DTC red can (upright by
an x +90 deg turn, then z +45 deg); their sampled xy are swapped.
Success = the object's xy within the goal can's footprint (less 2 cm),
not grasped, both cans static.
"""

from __future__ import annotations

import math

import torch

from gsworld_tpu_torch.core.maths import axis_angle_to_quat, quat_multiply
from gsworld_tpu_torch.envs.base import EpisodeInit
from gsworld_tpu_torch.envs.registry import register_env
from gsworld_tpu_torch.envs.tasks.real_fr3 import RealFr3
from gsworld_tpu_torch.envs.tasks.tabletop.franka.pnp_box import (
    IDENTITY_Q,
    fixed_quats,
    init_qpos,
    swap_xy,
)
from gsworld_tpu_torch.physics import builders as B

YCB_CAN_RADIUS = 0.033


def upright_can_quat():
    """The DTC cans' fix: x +90 deg (upright), then z +45 deg (CPU)."""
    aa = lambda *v: axis_angle_to_quat(torch.tensor(v))       # noqa: E731
    return quat_multiply(aa(0.0, 0.0, math.pi / 4),
                         aa(math.pi / 2, 0.0, 0.0))


@register_env("StackFr3Env-v1", max_episode_steps=100)
class StackFr3Env(RealFr3):
    SUPPORTED_ROBOTS = ("fr3_umi", "fr3_umi_wrist435")
    goal_thresh = 0.025
    actor_names = ("005_tomato_soup_can", "dtc_red_tomato_can_fr3")
    goal_name, obj_name = actor_names
    x_offset = 0.615
    goal_height = 0.051
    obj_height = 0.05
    # object x, y; goal x, y offset
    episode_draws = 4

    def __init__(self, *args, robot_uids="fr3_umi",
                 robot_init_qpos_noise=0.02, num_envs=1, **kwargs):
        super().__init__(*args, robot_uids=robot_uids, num_envs=num_envs,
                         robot_init_qpos_noise=robot_init_qpos_noise,
                         **kwargs)

    def _load_scene(self):
        self._actor_defs = [
            # goal: the YCB tomato soup can, a z-up cylinder
            B.cylinder_actor("005_tomato_soup_can", radius=YCB_CAN_RADIUS,
                             half_length=0.051, axis="z", friction=0.6),
            # object: the DTC red can, y-axis body frame
            B.cylinder_actor("dtc_red_tomato_can_fr3", radius=0.037,
                             half_length=0.05, axis="y", friction=0.6),
        ]

    def _initialize_episode(self, draws) -> EpisodeInit:
        Bn, dev = draws.shape[0], draws.device
        u = draws.to(torch.float32)
        xo = self.x_offset
        full = lambda v: torch.full((Bn,), v, device=dev)     # noqa: E731
        obj = torch.stack([-0.125 + u[:, 0] * 0.125 + xo,
                           0.1 + u[:, 1] * 0.1, full(self.obj_height)],
                          dim=-1)
        goal = torch.stack([u[:, 2] * 0.2 - 0.25 + xo,
                            obj[:, 1] - 0.15 - u[:, 3] * 0.1,
                            full(self.goal_height)], dim=-1)
        # the sampled xy are swapped
        obj, goal = swap_xy(obj, goal, torch.ones(Bn, dtype=torch.bool,
                                                  device=dev))
        return EpisodeInit(
            qpos=init_qpos(self, Bn, dev),
            a_pos=torch.stack([goal, obj], dim=1),
            a_quat=fixed_quats(Bn, dev, IDENTITY_Q, upright_can_quat()),
            task={})

    def evaluate(self, data):
        p, _ = self.actor_pose(data, self.obj_name)
        pg, _ = self.actor_pose(data, self.goal_name)
        in_box = (torch.linalg.norm(p[:, :2] - pg[:, :2], dim=-1)
                  <= YCB_CAN_RADIUS - 0.02)
        grasped = self.is_grasping(data, self.obj_name)
        robot_static = self.agent_is_static(data, 0.2)
        goal_static = self.actor_is_static(data, self.goal_name)
        obj_static = self.actor_is_static(data, self.obj_name) & goal_static
        success = in_box & (~grasped) & obj_static
        return {"is_grasped_0": grasped, "is_obj_in_box": in_box,
                "is_robot_static": robot_static, "is_obj_static": obj_static,
                "is_goal_site_static": goal_static,
                "success": success}

    def _get_obs_extra(self, data, info):
        tcp_p, tcp_q = self.tcp_pose(data)
        pg, _ = self.actor_pose(data, self.goal_name)
        obs = dict(tcp_pose=torch.cat([tcp_p, tcp_q], dim=-1), goal_pos=pg,
                   is_grasped=info["is_grasped_0"])
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
        grasped = info["is_grasped_0"]
        reward = reward + 1.0 * grasped
        reward = reward + (1.0 - torch.tanh(5.0 * dist(pg, p))) * grasped
        in_box = info["is_obj_in_box"]
        reward = reward + 1.0 * in_box + 1.0 * (in_box & ~grasped)
        reward = reward + 1.0 * (in_box & info["is_obj_static"]
                                 & info["is_robot_static"])
        return torch.where(info["success"], 6.0, reward)
