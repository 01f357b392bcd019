"""Static task description shared by the envs: cameras and the pose state
the renderer reads (port of the camera part of gsworld_tpu/envs/base.py).

No physics and no reset yet: an env here is the robot agent, its sensor
cameras and the names of its actors, in the order the physics scene keeps
them.  The batched pose state to render is an :class:`EnvPoses`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gsworld_tpu_torch.core.maths import tf_from_pq, tf_inverse_rigid
from gsworld_tpu_torch.envs.agents.fr3_umi import AgentSpec, fr3_agent
from gsworld_tpu_torch.physics.kinematics import forward_kinematics

# SAPIEN camera convention -> OpenCV
SAPIEN2OPENCV = np.array([
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
], dtype=np.float32)


def calib_mat2sapien_trans_mat(calib_mat: np.ndarray) -> np.ndarray:
    """OpenCV camera-axes matrix -> SAPIEN camera pose: columns
    (x, y, z) -> (z, -x, -y)."""
    out = np.eye(4, dtype=np.float64)
    out[:3, 0] = calib_mat[:3, 2]
    out[:3, 1] = -calib_mat[:3, 0]
    out[:3, 2] = -calib_mat[:3, 1]
    out[:3, 3] = calib_mat[:3, 3]
    return out


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """A sensor camera: intrinsics + mount (link-relative SAPIEN pose).
    Resizing a camera changes width/height only; K stays as calibrated."""

    name: str
    width: int
    height: int
    intrinsic: np.ndarray          # (3, 3)
    mount_link: Optional[str]      # None = world-fixed
    local_pose: np.ndarray         # (4, 4) SAPIEN-convention pose in mount frame
    near: float = 0.01
    far: float = 100.0


@dataclasses.dataclass
class EnvPoses:
    """Batched pose state of B envs: what the GS render reads."""

    qpos: torch.Tensor                         # (B, dof)
    a_pos: torch.Tensor                        # (B, A, 3)
    a_quat: torch.Tensor                       # (B, A, 4) wxyz
    root_pos: Optional[torch.Tensor] = None    # (B, 3), default origin
    root_quat: Optional[torch.Tensor] = None   # (B, 4), default identity
    a_scale: Optional[torch.Tensor] = None     # (B, A), default 1


class GsBaseEnv:
    """Robot agent + sensor cameras + actor names of one task."""

    actor_names: Tuple[str, ...] = ()

    def __init__(self, num_envs: int = 1, robot_uids: str = "fr3_umi",
                 obs_mode: str = "rgb"):
        self.num_envs = num_envs
        self.robot_uids = robot_uids
        self.obs_mode = obs_mode
        self.agent: AgentSpec = fr3_agent(robot_uids)
        self.actor_index = {n: i for i, n in enumerate(self.actor_names)}
        self.cameras = list(self._default_sensor_configs())

    def _default_sensor_configs(self) -> Sequence[CameraSpec]:
        return ()

    def camera_extrinsics_cv(self, poses: EnvPoses, cameras=None,
                             link_pose=None) -> torch.Tensor:
        """(B, n_cams, 4, 4) OpenCV world->cam extrinsics from FK.
        ``link_pose`` = (link_pos, link_quat) when FK already ran."""
        cameras = self.cameras if cameras is None else cameras
        if link_pose is None:
            link_pose = forward_kinematics(self.agent.model, poses.qpos,
                                           poses.root_pos, poses.root_quat)
        link_pos, link_quat = link_pose
        kw = dict(dtype=torch.float32, device=link_pos.device)
        s2cv = torch.as_tensor(SAPIEN2OPENCV, **kw)
        B = link_pos.shape[0]
        outs = []
        for cam in cameras:
            local = torch.as_tensor(np.asarray(cam.local_pose, np.float32),
                                    **kw)
            if cam.mount_link is None:
                pose = local.expand(B, 4, 4)
            else:
                li = self.agent.model.link_id(cam.mount_link)
                pose = tf_from_pq(link_pos[:, li], link_quat[:, li]) @ local
            outs.append(s2cv @ tf_inverse_rigid(pose))
        return torch.stack(outs, dim=1)
