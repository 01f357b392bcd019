"""Agent registry + AgentSpec: the static description of a robot agent
(articulation, controllers, grasp-check configuration); port of
gsworld_tpu/envs/agents/base.py."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from benchmark.reference.gsw.core.maths import compute_angle_between, quat_to_matrix
from benchmark.reference.gsw.envs.controllers import CompositeController
from benchmark.reference.gsw.physics.kinematics import ArticulationModel
from benchmark.reference.gsw.physics.spec_io import RobotSpec

_AGENT_REGISTRY: Dict[str, Callable[[], "AgentSpec"]] = {}
_AGENT_CACHE: Dict[str, "AgentSpec"] = {}


def register_agent(uid: str, factory: Callable[[], "AgentSpec"]):
    _AGENT_REGISTRY[uid] = factory


def get_agent(uid: str) -> "AgentSpec":
    if uid not in _AGENT_CACHE:
        if uid not in _AGENT_REGISTRY:
            raise KeyError(f"unknown agent uid {uid!r}; known: "
                           f"{sorted(_AGENT_REGISTRY)}")
        _AGENT_CACHE[uid] = _AGENT_REGISTRY[uid]()
    return _AGENT_CACHE[uid]


@dataclasses.dataclass(frozen=True)
class AgentSpec:
    uid: str
    spec: RobotSpec
    model: ArticulationModel
    controllers: Dict[str, CompositeController]
    default_control_mode: str
    ee_link: str
    base_link: str
    finger_links: Tuple[str, ...]
    contact_links: Tuple[str, ...]        # links participating in contacts
    arm_dof_ids: Tuple[int, ...]
    gripper_dof_ids: Tuple[int, ...]
    finger_friction: float = 2.0
    # per finger: (axis index in link frame, sign) of the opening direction
    finger_open_axes: Tuple[Tuple[int, float], ...] = ((0, 1.0), (1, -1.0))

    def controller(self, mode: Optional[str] = None) -> CompositeController:
        mode = mode or self.default_control_mode
        if mode not in self.controllers:
            raise KeyError(f"agent {self.uid} has no control mode {mode!r}; "
                           f"available: {sorted(self.controllers)}")
        return self.controllers[mode]

    def is_grasping_from_forces(self, finger_forces, link_quats,
                                min_force: float = 0.5,
                                max_angle_deg: float = 85.0):
        """Grasp predicate from per-finger contact forces (world frame).

        Args:
          finger_forces: (..., n_fingers, 3) force exerted by the object on
            each finger link.
          link_quats: (..., n_fingers, 4) world quats of the finger links.

        Both fingers must feel >= min_force with the force within
        max_angle of the finger's opening direction.
        """
        R = quat_to_matrix(link_quats)                # (..., nf, 3, 3)
        out = None
        for i, (axis, sign) in enumerate(self.finger_open_axes):
            d = sign * R[..., i, :, axis]             # column = axis direction
            f = finger_forces[..., i, :]
            force = torch.linalg.norm(f, dim=-1)
            ang = compute_angle_between(d, f)
            flag = ((force >= min_force)
                    & (torch.rad2deg(ang) <= max_angle_deg))
            out = flag if out is None else out & flag
        return out
