"""RealFr3 base: the real-calibrated cameras (port of
gsworld_tpu/envs/tasks/real_fr3.py).  The wrist D435i is mounted on the
end-effector link (hand-eye calibration ``wrist2eef``), the right camera
on the robot base (``right2base``); both 640x480 with the D435i
intrinsics."""

from __future__ import annotations

from gsworld_tpu_torch import constants
from gsworld_tpu_torch.envs.base import (
    CameraSpec,
    GsBaseEnv,
    calib_mat2sapien_trans_mat,
)


class RealFr3(GsBaseEnv):
    def _default_sensor_configs(self):
        wrist_pose = calib_mat2sapien_trans_mat(constants.wrist2eef)
        right_pose = calib_mat2sapien_trans_mat(constants.right2base)
        return [
            CameraSpec("wrist_cam", 640, 480, constants.rs_d435i_rgb_k,
                       mount_link=self.agent.ee_link, local_pose=wrist_pose),
            CameraSpec("right_cam", 640, 480, constants.rs_d435i_rgb_k,
                       mount_link=self.agent.base_link, local_pose=right_pose),
        ]
