"""Robot spec loading from the extracted JSON + NPZ data files.

The shipped robots live under ``gsworld_tpu/assets/robots/`` as
``<name>.json`` (kinematic tree in URDF document order) and
``<name>_geom.npz`` (collision support points and per-link surface
samples).  They are data files, read here by path.  Only the kinematic
part is loaded: the port has no dynamics or contacts yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from gsworld_tpu_torch import constants

JOINT_FIXED = 0
JOINT_REVOLUTE = 1
JOINT_PRISMATIC = 2


@dataclasses.dataclass
class MimicSpec:
    joint: str
    multiplier: float = 1.0
    offset: float = 0.0


@dataclasses.dataclass
class JointSpec:
    name: str
    jtype: int
    parent: str
    child: str
    origin_pos: np.ndarray         # (3,)
    origin_rot: np.ndarray         # (3, 3)
    axis: np.ndarray               # (3,)
    limit_lower: float = -np.inf
    limit_upper: float = np.inf
    mimic: Optional[MimicSpec] = None


@dataclasses.dataclass
class RobotSpec:
    name: str
    link_names: List[str]          # document order
    joints: List[JointSpec]        # document order (= SAPIEN qpos order)


def load_robot_spec(name: str, spec_dir: Optional[str] = None) -> RobotSpec:
    spec_dir = spec_dir or constants.ROBOT_SPEC_DIR
    with open(os.path.join(spec_dir, f"{name}.json")) as f:
        data = json.load(f)
    joints = []
    for jj in data["joints"]:
        mimic = MimicSpec(**jj["mimic"]) if "mimic" in jj else None
        joints.append(JointSpec(
            name=jj["name"], jtype=jj["type"], parent=jj["parent"],
            child=jj["child"],
            origin_pos=np.asarray(jj["origin_pos"]),
            origin_rot=np.asarray(jj["origin_rot"]).reshape(3, 3),
            axis=np.asarray(jj["axis"]),
            limit_lower=jj["limit"][0], limit_upper=jj["limit"][1],
            mimic=mimic))
    return RobotSpec(name=data["name"],
                     link_names=[lj["name"] for lj in data["links"]],
                     joints=joints)


def load_surface_points(name: str, spec_dir: Optional[str] = None
                        ) -> Dict[str, np.ndarray]:
    """Per-link surface point samples (link frame) of robot ``name``."""
    spec_dir = spec_dir or constants.ROBOT_SPEC_DIR
    with np.load(os.path.join(spec_dir, f"{name}_geom.npz")) as npz:
        return {k[len("surf/"):]: npz[k] for k in npz.files
                if k.startswith("surf/")}
