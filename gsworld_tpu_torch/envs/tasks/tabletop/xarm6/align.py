"""AlignXArmEnv-v1: place the DTC green can next to the tomato soup can
(port of gsworld_tpu/envs/tasks/tabletop/xarm6/align.py).

Success = the can's xy within the tomato can's footprint, not grasped,
both static.  The robot's root stands 3 cm above the table.
"""

from __future__ import annotations

import torch

from gsworld_tpu_torch.envs.base import EpisodeInit
from gsworld_tpu_torch.envs.registry import register_env
from gsworld_tpu_torch.envs.tasks.real_xarm import RealXArm6
from gsworld_tpu_torch.envs.tasks.tabletop.franka.pnp_box import (
    IDENTITY_Q,
    fixed_quats,
    init_qpos,
    swap_xy,
)
from gsworld_tpu_torch.envs.tasks.tabletop.franka.stack import (
    upright_can_quat,
)
from gsworld_tpu_torch.physics import builders as B

YCB_CAN_RADIUS = 0.033


class XArmTabletop(RealXArm6):
    """The xArm tabletop tasks: the root at (x_offset - 0.615, 0, 0.03)."""

    SUPPORTED_ROBOTS = ("xarm6_uf_gripper", "xarm6_uf_gripper_wrist435")
    x_offset = 0.615

    def __init__(self, *args, robot_uids="xarm6_uf_gripper",
                 robot_init_qpos_noise=0.02, num_envs=1, **kwargs):
        super().__init__(*args, robot_uids=robot_uids, num_envs=num_envs,
                         robot_init_qpos_noise=robot_init_qpos_noise,
                         **kwargs)

    def _root_pose(self):
        return (self.x_offset - 0.615, 0.0, 0.03)


@register_env("AlignXArmEnv-v1", max_episode_steps=100)
class AlignXArmEnv(XArmTabletop):
    goal_thresh = 0.025
    actor_names = ("dtc_green_can", "005_tomato_soup_can")
    obj_name, goal_name = actor_names
    goal_height = 0.051
    obj_height = 0.05
    # can x (two), y (two); tomato can x (two), y offset (two)
    episode_draws = 8

    def _load_scene(self):
        self._actor_defs = [
            B.cylinder_actor("dtc_green_can", radius=0.033, half_length=0.065,
                             axis="y", friction=0.6),
            B.cylinder_actor("005_tomato_soup_can", radius=YCB_CAN_RADIUS,
                             half_length=0.051, axis="z", friction=0.6),
        ]

    def _initialize_episode(self, draws) -> EpisodeInit:
        Bn, dev = draws.shape[0], draws.device
        u = draws.to(torch.float32)
        xo = self.x_offset
        full = lambda v: torch.full((Bn,), v, device=dev)     # noqa: E731
        obj = torch.stack([
            -0.125 + u[:, 0] * 0.125 + xo + u[:, 1] * 0.05 - 0.025,
            0.1 + u[:, 2] * 0.1 + 0.15 + u[:, 3] * 0.05 - 0.025,
            full(self.obj_height)], dim=-1)
        goal = torch.stack([
            u[:, 4] * 0.2 - 0.25 + xo + u[:, 5] * 0.04 - 0.02 + 0.05,
            obj[:, 1] - 0.25 - u[:, 6] * 0.1 + u[:, 7] * 0.04 - 0.02,
            full(self.goal_height)], dim=-1)
        # swapped: the green can on the right, the tomato can on the left
        obj, goal = swap_xy(obj, goal, torch.ones(Bn, dtype=torch.bool,
                                                  device=dev))
        return EpisodeInit(
            qpos=init_qpos(self, Bn, dev),
            a_pos=torch.stack([obj, goal], dim=1),
            a_quat=fixed_quats(Bn, dev, upright_can_quat(), IDENTITY_Q),
            task={})

    def evaluate(self, data):
        p, _ = self.actor_pose(data, self.obj_name)
        pg, _ = self.actor_pose(data, self.goal_name)
        in_box = (torch.linalg.norm(p[:, :2] - pg[:, :2], dim=-1)
                  <= YCB_CAN_RADIUS)
        grasped = self.is_grasping(data, self.obj_name)
        robot_static = self.agent_is_static(data, 0.2)
        goal_static = self.actor_is_static(data, self.goal_name)
        all_static = self.actor_is_static(data, self.obj_name) & goal_static
        success = in_box & (~grasped) & all_static
        return {"is_grasped_0": grasped, "is_obj_in_box": in_box,
                "is_robot_static": robot_static, "is_obj_static": all_static,
                "is_goal_site_static": goal_static,
                "success": success}

    def _get_obs_extra(self, data, info):
        tcp_p, tcp_q = self.tcp_pose(data)
        pg, _ = self.actor_pose(data, self.goal_name)
        p, q = self.actor_pose(data, self.obj_name)
        return dict(
            tcp_pose=torch.cat([tcp_p, tcp_q], dim=-1), goal_pos=pg,
            is_grasped=info["is_grasped_0"],
            tcp_to_goal_pos=pg - tcp_p,
            obj_pose=torch.cat([p, q], dim=-1),
            tcp_to_obj_pos=p - tcp_p, obj_to_goal_pos=pg - p)

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
