"""RealFr3 base env: empty scene with the real-calibrated cameras (port of
gsworld_tpu/envs/tasks/real_fr3.py).  The wrist D435i is mounted on the
end-effector link (hand-eye calibration ``wrist2eef``), the right camera
on the robot base (``right2base``); both 640x480 with the D435i
intrinsics."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.gsw import constants
from benchmark.reference.gsw.envs.base import (
    CameraSpec,
    EpisodeInit,
    GsBaseEnv,
    calib_mat2sapien_trans_mat,
    look_at_sapien,
)
from benchmark.reference.gsw.envs.registry import register_env


@register_env("RealFr3-v1", max_episode_steps=200000)
class RealFr3(GsBaseEnv):
    SUPPORTED_REWARD_MODES = ("none", "dense", "sparse")

    def __init__(self, *args, robot_uids="fr3_umi", **kwargs):
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    def _default_sensor_configs(self):
        wrist_pose = calib_mat2sapien_trans_mat(constants.wrist2eef)
        right_pose = calib_mat2sapien_trans_mat(constants.right2base)
        return [
            CameraSpec("wrist_cam", 640, 480, constants.rs_d435i_rgb_k,
                       mount_link=self.agent.ee_link, local_pose=wrist_pose),
            CameraSpec("right_cam", 640, 480, constants.rs_d435i_rgb_k,
                       mount_link=self.agent.base_link, local_pose=right_pose),
        ]

    def _default_human_render_camera_configs(self):
        # 640x480 real-intrinsics human render camera looking at the
        # workspace
        return [CameraSpec(
            "render_camera", 640, 480, constants.rs_d435i_rgb_k,
            mount_link=None,
            local_pose=look_at_sapien([1.0, 0.2, 0.5], [0.0, 0.0, 0.15]))]

    def _initialize_episode(self, draws):
        Bn = draws.shape[0]
        q = torch.as_tensor(
            np.asarray(constants.robot_task_init_qpos[self.robot_uids],
                       np.float32), device=draws.device)
        return EpisodeInit(
            qpos=q.expand(Bn, -1).clone(),
            a_pos=torch.zeros((Bn, 0, 3), device=draws.device),
            a_quat=torch.zeros((Bn, 0, 4), device=draws.device), task={})
