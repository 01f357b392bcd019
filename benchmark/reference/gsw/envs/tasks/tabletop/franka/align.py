"""AlignFr3Env-v1: place both DTC cans into the spice-rack goal box (port
of gsworld_tpu/envs/tasks/tabletop/franka/align.py).

Two cans (green parmesan container + red tomato can) spawn with randomized
tabletop poses; success = both cans' xy within the goal box footprint, not
grasped, and everything static.  The cans are convex cylinders with the
DTC frame convention (body +y = can axis), so the init quaternions of the
real assets apply verbatim.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.gsw import constants
from benchmark.reference.gsw.core.maths import axis_angle_to_quat, quat_multiply
from benchmark.reference.gsw.envs.base import EpisodeInit
from benchmark.reference.gsw.envs.registry import register_env
from benchmark.reference.gsw.envs.tasks.real_fr3 import RealFr3
from benchmark.reference.gsw.physics import builders as B

# goal box half sizes
GOAL_HALF = np.array([0.0725 * 2.54 * 0.5, 0.11625 * 2.54 * 0.5,
                      0.05375 * 2.54 * 0.5], np.float32)
RESAMPLE_ROUNDS = 16


@register_env("AlignFr3Env-v1", max_episode_steps=100)
class AlignFr3Env(RealFr3):
    SUPPORTED_ROBOTS = ("fr3_umi", "fr3_umi_wrist435")
    goal_thresh = 0.025
    actor_names = ("dtc_green_can_fr3", "dtc_red_tomato_can_fr3",
                   "spice_rack")
    x_offset = 0.615
    goal_height = 0.068
    # upright (cylinder axis vertical) resting half-height = half_length
    green_half_height = 0.065
    red_half_height = 0.05
    # 6 numbers for the first layout, 2 per round of the bounded
    # rejection resampling of the red can
    episode_draws = 6 + 2 * RESAMPLE_ROUNDS

    def __init__(self, *args, robot_uids="fr3_umi",
                 robot_init_qpos_noise=0.02, num_envs=1, **kwargs):
        super().__init__(*args, robot_uids=robot_uids, num_envs=num_envs,
                         robot_init_qpos_noise=robot_init_qpos_noise,
                         **kwargs)

    def _load_scene(self):
        # DTC cans approximated as y-axis cylinders (DTC mesh frame), so the
        # init quats (x +90deg -> upright) hold
        self._actor_defs = [
            B.cylinder_actor("dtc_green_can_fr3", radius=0.033,
                             half_length=self.green_half_height, axis="y",
                             friction=0.6),
            B.cylinder_actor("dtc_red_tomato_can_fr3", radius=0.037,
                             half_length=self.red_half_height, axis="y",
                             friction=0.6),
            B.box_actor("spice_rack", GOAL_HALF, friction=0.6),
        ]

    def _initialize_episode(self, draws) -> EpisodeInit:
        """draws (B, 38): [green x, y; goal x, y; red x, y of the first
        try; then (x, y) of each of 16 resampling rounds]."""
        Bn, dev = draws.shape[0], draws.device
        u = draws.to(torch.float32)
        aa = lambda *v: axis_angle_to_quat(                   # noqa: E731
            torch.tensor(v, dtype=torch.float32, device=dev))
        # cans upright (x +90 deg) then turned z +45 deg; rack z -90 deg
        can_q = quat_multiply(aa(0.0, 0.0, math.pi / 4),
                              aa(math.pi / 2, 0.0, 0.0))
        rack_q = aa(0.0, 0.0, -math.pi / 2)

        xo = self.x_offset
        full = lambda v: torch.full((Bn,), v, device=dev)     # noqa: E731
        obj0 = torch.stack([-0.2 + u[:, 0] * 0.05 + xo,
                            0.1 + u[:, 1] * 0.1,
                            full(self.green_half_height)], dim=-1)
        goal = torch.stack([u[:, 2] * 0.2 - 0.25 + xo,
                            u[:, 3] * 0.1 - 0.2,
                            full(self.goal_height)], dim=-1)
        obj1 = torch.stack([obj0[:, 0] + u[:, 4] * 0.05 + 0.1,
                            u[:, 5] * 0.1 + 0.1,
                            full(self.red_half_height)], dim=-1)
        # bounded rejection resampling, as masked rounds over the batch:
        # an env keeps its red can once the layout is accepted
        goal_bad = torch.linalg.norm(obj0 - goal, dim=-1) < 0.15
        for r in range(RESAMPLE_ROUNDS):
            bad = (torch.linalg.norm(obj0 - obj1, dim=-1) < 0.1) | goal_bad
            cand = torch.stack([u[:, 6 + 2 * r] * 0.2 - 0.25 + xo,
                                u[:, 7 + 2 * r] * 0.1 + 0.1,
                                full(self.red_half_height)], dim=-1)
            obj1 = torch.where(bad[:, None], cand, obj1)

        a_pos = torch.stack([obj0, obj1, goal], dim=1)
        a_quat = torch.stack([can_q, can_q, rack_q]).expand(Bn, 3, 4).clone()
        qpos = torch.as_tensor(
            np.asarray(constants.fr3_umi_task_init_qpos, np.float32),
            device=dev).expand(Bn, -1).clone()
        return EpisodeInit(qpos=qpos, a_pos=a_pos, a_quat=a_quat, task={})

    def evaluate(self, data):
        p0, _ = self.actor_pose(data, "dtc_green_can_fr3")
        p1, _ = self.actor_pose(data, "dtc_red_tomato_can_fr3")
        pg, _ = self.actor_pose(data, "spice_rack")
        half_xy_goal = float(GOAL_HALF[:2].max())
        dist = lambda a, b: torch.linalg.norm(a - b, dim=-1)  # noqa: E731
        is_xy0 = dist(p0[:, :2], pg[:, :2]) <= half_xy_goal - 0.02
        is_xy1 = dist(p1[:, :2], pg[:, :2]) <= half_xy_goal - 0.02
        in_box = is_xy0 & is_xy1
        g0 = self.is_grasping(data, "dtc_green_can_fr3")
        g1 = self.is_grasping(data, "dtc_red_tomato_can_fr3")
        grasped = g0 & g1
        robot_static = self.agent_is_static(data, 0.2)
        obj_static = (self.actor_is_static(data, "dtc_green_can_fr3")
                      & self.actor_is_static(data, "dtc_red_tomato_can_fr3"))
        success = in_box & (~grasped) & obj_static
        return {
            "is_grasped_0": g0, "is_grasped_1": g1,
            "is_obj0_in_box": is_xy0, "is_obj1_in_box": is_xy1,
            "is_obj_in_box": in_box,
            "is_robot_static": robot_static, "is_obj_static": obj_static,
            "success": success,
        }

    def _get_obs_extra(self, data, info):
        tcp_p, tcp_q = self.tcp_pose(data)
        pg, _ = self.actor_pose(data, "spice_rack")
        obs = dict(
            tcp_pose=torch.cat([tcp_p, tcp_q], dim=-1),
            goal_pos=pg,
            is_grasped_0=info["is_grasped_0"],
            is_grasped_1=info["is_grasped_1"],
        )
        if "state" in self.obs_mode:
            p0, q0 = self.actor_pose(data, "dtc_green_can_fr3")
            obs.update(
                tcp_to_goal_pos=pg - tcp_p,
                obj_pose=torch.cat([p0, q0], dim=-1),
                tcp_to_obj_pos=p0 - tcp_p,
                obj_to_goal_pos=pg - p0,
            )
        return obs

    def compute_dense_reward(self, data, action, info):
        # "the object" of the reward is the green can
        tcp_p, _ = self.tcp_pose(data)
        p0, _ = self.actor_pose(data, "dtc_green_can_fr3")
        pg, _ = self.actor_pose(data, "spice_rack")
        dist = lambda a, b: torch.linalg.norm(a - b, dim=-1)  # noqa: E731
        reward = 1.0 - torch.tanh(5.0 * dist(p0, tcp_p))
        grasped = info["is_grasped_0"] & info["is_grasped_1"]
        reward = reward + 1.0 * grasped
        transport = 1.0 - torch.tanh(5.0 * dist(pg, p0))
        reward = reward + transport * grasped
        in_box = info["is_obj_in_box"]
        reward = reward + 1.0 * in_box
        reward = reward + 1.0 * (in_box & ~grasped)
        reward = reward + 1.0 * (in_box & info["is_obj_static"]
                                 & info["is_robot_static"])
        return torch.where(info["success"], 6.0, reward)

    def compute_normalized_dense_reward(self, data, action, info):
        return self.compute_dense_reward(data, action, info) / 6.0
