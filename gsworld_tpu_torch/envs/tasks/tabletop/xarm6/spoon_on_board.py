"""SpoonOnBoardXArmEnv-v1: place the wooden spoon onto the cutting board
(port of gsworld_tpu/envs/tasks/tabletop/xarm6/spoon_on_board.py).

The spoon rests on two support blocks.  The board's position is kept in
the task state as ``goal_pos`` (1 cm above the board).  Success = the
spoon's xy within the board (0.15 x 0.1 half sizes less 2 cm), its z
within 5 cm of the goal, not grasped (any force direction), robot static.
"""

from __future__ import annotations

import math

import torch

from gsworld_tpu_torch.core.maths import axis_angle_to_quat, quat_multiply
from gsworld_tpu_torch.envs.base import EpisodeInit
from gsworld_tpu_torch.envs.registry import register_env
from gsworld_tpu_torch.envs.tasks.tabletop.franka.pnp_box import (
    IDENTITY_Q,
    fixed_quats,
    init_qpos,
)
from gsworld_tpu_torch.envs.tasks.tabletop.xarm6.align import XArmTabletop
from gsworld_tpu_torch.physics import builders as B

SPOON_NAME = "dtc:Kitchen_Spoon_B008H2JLP8_LargeWooden"
BOARD_NAME = "dtc:Cutting_Board_B005CZ90HM_LimeGreen"
BOARD_HALF_X, BOARD_HALF_Y = 0.15, 0.1


@register_env("SpoonOnBoardXArmEnv-v1", max_episode_steps=100)
class SpoonOnBoardXArmEnv(XArmTabletop):
    goal_thresh = 0.025
    actor_names = (SPOON_NAME, BOARD_NAME, "support_block_0",
                   "support_block_1")
    obj_name, goal_name = SPOON_NAME, BOARD_NAME
    goal_height = 0.012
    obj_height = 0.0
    # spoon x, y; board x, y
    episode_draws = 4

    def _load_scene(self):
        self._actor_defs = [
            # the spoon: long thin convex box (20 cm), length on x
            B.box_actor(SPOON_NAME, [0.10, 0.022, 0.012], friction=0.6),
            B.box_actor(BOARD_NAME, [BOARD_HALF_X, BOARD_HALF_Y, 0.006],
                        friction=0.6),
            # two blocks under the spoon
            B.box_actor("support_block_0", [0.02, 0.02, 0.005], friction=0.8),
            B.box_actor("support_block_1", [0.02, 0.02, 0.005], friction=0.8),
        ]

    def _initialize_episode(self, draws) -> EpisodeInit:
        Bn, dev = draws.shape[0], draws.device
        u = draws.to(torch.float32)
        xo = self.x_offset
        full = lambda v: torch.full((Bn,), v, device=dev)     # noqa: E731
        spoon = torch.stack([xo - 0.3 + u[:, 0] * 0.05,
                             -0.05 + u[:, 1] * 0.05,
                             full(self.obj_height + 0.01)], dim=-1)
        board = torch.stack([xo - 0.3 + u[:, 2] * 0.1, 0.15 + u[:, 3] * 0.1,
                             full(self.goal_height)], dim=-1)
        block_offset = 0.20 / 3.0
        blk = lambda dx: torch.stack([spoon[:, 0] + dx, spoon[:, 1],  # noqa
                                      full(0.005)], dim=-1)
        aa = lambda *v: axis_angle_to_quat(torch.tensor(v))   # noqa: E731
        spoon_q = quat_multiply(aa(0.0, 0.0, math.pi / 2),
                                aa(math.pi / 2, 0.0, 0.0))
        board_q = aa(-math.pi / 2, 0.0, 0.0)
        goal_pos = torch.cat([board[:, :2],
                              full(self.goal_height + 0.01)[:, None]], dim=-1)
        return EpisodeInit(
            qpos=init_qpos(self, Bn, dev),
            a_pos=torch.stack([spoon, board, blk(-block_offset),
                               blk(block_offset)], dim=1),
            a_quat=fixed_quats(Bn, dev, spoon_q, board_q, IDENTITY_Q,
                               IDENTITY_Q),
            task={"goal_pos": goal_pos})

    def evaluate(self, data):
        p, _ = self.actor_pose(data, self.obj_name)
        goal = data["task"]["goal_pos"]
        off = p[:, :2] - goal[:, :2]
        in_xy = ((off[:, 0].abs() <= BOARD_HALF_X - 0.02)
                 & (off[:, 1].abs() <= BOARD_HALF_Y - 0.02))
        z_ok = (p[:, 2] - goal[:, 2]).abs() <= 0.05
        grasped = self.is_grasping(data, self.obj_name, max_angle=180.0)
        robot_static = self.agent_is_static(data, 0.2)
        spoon_static = self.actor_is_static(data, self.obj_name)
        success = in_xy & z_ok & (~grasped) & robot_static
        return {"is_grasped": grasped,
                "is_spoon_on_board": in_xy & z_ok,
                "is_robot_static": robot_static,
                "is_spoon_static": spoon_static,
                "success": success}

    def _get_obs_extra(self, data, info):
        tcp_p, tcp_q = self.tcp_pose(data)
        pg, _ = self.actor_pose(data, self.goal_name)
        obs = dict(tcp_pose=torch.cat([tcp_p, tcp_q], dim=-1), goal_pos=pg,
                   is_grasped=info["is_grasped"])
        if "state" in self.obs_mode:
            p, q = self.actor_pose(data, self.obj_name)
            obs.update(tcp_to_goal_pos=pg - tcp_p,
                       spoon_pose=torch.cat([p, q], dim=-1),
                       tcp_to_spoon_pos=p - tcp_p,
                       spoon_to_board_pos=pg - p)
        return obs

    def compute_dense_reward(self, data, action, info):
        tcp_p, _ = self.tcp_pose(data)
        p, _ = self.actor_pose(data, self.obj_name)
        pg, _ = self.actor_pose(data, self.goal_name)
        dist = lambda a, b: torch.linalg.norm(a - b, dim=-1)  # noqa: E731
        reward = 1.0 - torch.tanh(5.0 * dist(p, tcp_p))
        grasped = info["is_grasped"]
        reward = reward + 2.0 * grasped
        reward = reward + (1.0 - torch.tanh(5.0 * dist(pg, p))) * grasped
        reward = reward + 2.0 * info["is_spoon_on_board"]
        return torch.where(info["success"], 8.0, reward)
