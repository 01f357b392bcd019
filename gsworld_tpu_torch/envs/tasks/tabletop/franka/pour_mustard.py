"""PourMustardFr3Env-v1: grasp the mustard bottle and tilt it over the
bread slice (port of gsworld_tpu/envs/tasks/tabletop/franka/
pour_mustard.py).

A pour is a tilt of |euler_x| > pi/10 within 0.15 m (xy) of the bread.
The task state carries it per env from step to step: ``has_poured``
(sticky) and ``pouring_state`` (+0.1 per pouring step, at most 1).
Success = grasped and above the bread.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gsworld_tpu_torch.core.maths import matrix_to_euler_xyz, quat_to_matrix
from gsworld_tpu_torch.envs.base import EpisodeInit
from gsworld_tpu_torch.envs.registry import register_env
from gsworld_tpu_torch.envs.tasks.real_fr3 import RealFr3
from gsworld_tpu_torch.envs.tasks.tabletop.franka.pnp_box import (
    IDENTITY_Q,
    fixed_quats,
    init_qpos,
    random_z_quat,
    swap_xy,
)
from gsworld_tpu_torch.physics import builders as B

GOAL_HALF = np.array([0.14 * 0.5, 0.115 * 0.5, 0.015 * 0.5], np.float32)
RESAMPLE_ROUNDS = 16


@register_env("PourMustardFr3Env-v1", max_episode_steps=50)
class PourMustardFr3Env(RealFr3):
    SUPPORTED_ROBOTS = ("fr3_umi", "fr3_umi_wrist435")
    pour_angle_thresh = np.pi / 10
    pour_position_thresh = 0.15
    actor_names = ("006_mustard_bottle", "bread_slice")
    obj_name, goal_name = actor_names
    x_offset = 0.615
    bottle_height = 0.098
    goal_height = 0.010
    # bottle x, y, yaw; bread x, y; swap; then (x, y) of each of the 16
    # rounds that resample the bread while it lies within 0.15 m
    episode_draws = 6 + 2 * RESAMPLE_ROUNDS

    def __init__(self, *args, robot_uids="fr3_umi",
                 robot_init_qpos_noise=0.02, num_envs=1, **kwargs):
        super().__init__(*args, robot_uids=robot_uids, num_envs=num_envs,
                         robot_init_qpos_noise=robot_init_qpos_noise,
                         **kwargs)

    def _load_scene(self):
        self._actor_defs = [
            B.box_actor("006_mustard_bottle", [0.048, 0.031, 0.0955],
                        friction=0.6),
            B.box_actor("bread_slice", GOAL_HALF, friction=0.6),
        ]

    def _initialize_episode(self, draws) -> EpisodeInit:
        Bn, dev = draws.shape[0], draws.device
        u = draws.to(torch.float32)
        xo = self.x_offset
        full = lambda v: torch.full((Bn,), v, device=dev)     # noqa: E731
        bottle = torch.stack([u[:, 0] * 0.2 - 0.3 + xo, u[:, 1] * 0.1 + 0.1,
                              full(self.bottle_height)], dim=-1)
        q = random_z_quat(u[:, 2], bounds=(0.0, math.pi * 0.5))
        bread = lambda ux, uy: torch.stack(                     # noqa: E731
            [ux * 0.2 - 0.3 + xo, uy * 0.1 - 0.2,
             full(self.goal_height / 2)], dim=-1)
        box = bread(u[:, 3], u[:, 4])
        # bounded rejection resampling as masked rounds: an env keeps its
        # bread once it lies 0.15 m from the bottle
        for r in range(RESAMPLE_ROUNDS):
            bad = torch.linalg.norm(bottle[:, :2] - box[:, :2], dim=-1) < 0.15
            box = torch.where(bad[:, None],
                              bread(u[:, 6 + 2 * r], u[:, 7 + 2 * r]), box)
        bottle, box = swap_xy(bottle, box, u[:, 5] > 0.5)
        a_quat = torch.stack([q, fixed_quats(Bn, dev, IDENTITY_Q)[:, 0]],
                             dim=1)
        task = {"has_poured": torch.zeros(Bn, dtype=torch.bool, device=dev),
                "pouring_state": torch.zeros(Bn, device=dev)}
        return EpisodeInit(qpos=init_qpos(self, Bn, dev),
                           a_pos=torch.stack([bottle, box], dim=1),
                           a_quat=a_quat, task=task)

    def _pour_predicates(self, data):
        p, q = self.actor_pose(data, self.obj_name)
        pg, _ = self.actor_pose(data, self.goal_name)
        tilt = matrix_to_euler_xyz(quat_to_matrix(q))[:, 0].abs()
        above = (torch.linalg.norm(p[:, :2] - pg[:, :2], dim=-1)
                 < self.pour_position_thresh)
        return above, tilt > self.pour_angle_thresh

    def update_task_state(self, data, task):
        above, tilted = self._pour_predicates(data)
        pouring = above & tilted
        return {
            "has_poured": task["has_poured"] | pouring,
            "pouring_state": torch.where(
                pouring, (task["pouring_state"] + 0.1).clamp_max(1.0),
                task["pouring_state"]),
        }

    def evaluate(self, data):
        task = data["task"]
        above, tilted = self._pour_predicates(data)
        grasped = self.is_grasping(data, self.obj_name)
        robot_static = self.agent_is_static(data, 0.2)
        obj_static = self.actor_is_static(data, self.obj_name)
        success = grasped & above
        return {
            "is_grasped": grasped, "is_above_box": above,
            "is_tilted_enough": tilted,
            "has_poured": task["has_poured"] | (above & tilted),
            "is_robot_static": robot_static, "is_obj_static": obj_static,
            "pouring_state": task["pouring_state"],
            "success": success,
        }

    def _get_obs_extra(self, data, info):
        tcp_p, tcp_q = self.tcp_pose(data)
        pg, _ = self.actor_pose(data, self.goal_name)
        obs = dict(tcp_pose=torch.cat([tcp_p, tcp_q], dim=-1), goal_pos=pg,
                   is_grasped=info["is_grasped"],
                   has_poured=info["has_poured"],
                   pouring_state=info["pouring_state"])
        if "state" in self.obs_mode:
            p, q = self.actor_pose(data, self.obj_name)
            obs.update(tcp_to_goal_pos=pg - tcp_p,
                       obj_pose=torch.cat([p, q], dim=-1),
                       tcp_to_obj_pos=p - tcp_p, obj_to_goal_pos=pg - p)
        return obs

    def compute_dense_reward(self, data, action, info):
        tcp_p, _ = self.tcp_pose(data)
        p, _ = self.actor_pose(data, self.obj_name)
        reward = 1.0 - torch.tanh(5.0 * torch.linalg.norm(p - tcp_p, dim=-1))
        reward = reward + 1.0 * info["is_grasped"]
        reward = reward + 1.0 * (info["is_grasped"] & info["is_above_box"])
        reward = reward + 2.0 * info["has_poured"]
        return torch.where(info["success"], 6.0, reward)
