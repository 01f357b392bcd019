"""FR3 + UMI gripper agents: the articulation plus the links the render
path mounts cameras on (port of gsworld_tpu/envs/agents/fr3_umi.py,
kinematics only; the controllers come with the physics step)."""

from __future__ import annotations

import dataclasses

from gsworld_tpu_torch.physics.kinematics import (
    ArticulationModel,
    build_articulation,
)
from gsworld_tpu_torch.physics.spec_io import load_robot_spec

FR3_UIDS = ("fr3_umi", "fr3_umi_wrist435", "fr3_umi_wrist435_cam_mount")


@dataclasses.dataclass(frozen=True)
class AgentSpec:
    uid: str
    model: ArticulationModel
    ee_link: str
    base_link: str


def fr3_agent(uid: str = "fr3_umi") -> AgentSpec:
    if uid not in FR3_UIDS:
        raise KeyError(f"unknown FR3 agent uid {uid!r}; known: {FR3_UIDS}")
    model = build_articulation(load_robot_spec(uid))
    return AgentSpec(uid=uid, model=model, ee_link="fr3_hand_tcp",
                     base_link="base")
