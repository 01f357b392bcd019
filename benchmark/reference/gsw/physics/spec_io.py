"""Robot specs as the extracted JSON + NPZ data files: loading, and
writing (``save_robot_spec``, which benchmark.reference.gsw/tools/
extract_robot_specs.py drives).

The shipped robots live under ``gsworld_tpu/assets/robots/`` as
``<name>.json`` (kinematic tree in URDF document order) and
``<name>_geom.npz`` (collision support points and per-link surface
samples).  They are data files, read here by path: the kinematic tree,
the links' masses, centres of mass and inertias, the joints' effort,
velocity, damping and friction, and each link's collision geometry
(primitives, or convex support points stored in the NPZ under the geom's
``points_key``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from benchmark.reference.gsw import constants

JOINT_FIXED = 0
JOINT_REVOLUTE = 1
JOINT_PRISMATIC = 2


@dataclasses.dataclass
class MimicSpec:
    joint: str
    multiplier: float = 1.0
    offset: float = 0.0


@dataclasses.dataclass
class GeomSpec:
    kind: str     # "box" | "cylinder" | "sphere" | "capsule" | "points" | "mesh"
    origin_pos: np.ndarray         # (3,) in link frame
    origin_rot: np.ndarray         # (3, 3)
    size: Optional[np.ndarray] = None    # box: full extents; cyl: [r, l]; sphere: [r]
    points: Optional[np.ndarray] = None  # "points": (K, 3) convex support pts
    mesh_path: Optional[str] = None      # "mesh" (URDF only): file, scale
    mesh_scale: Optional[np.ndarray] = None


@dataclasses.dataclass
class LinkSpec:
    name: str
    mass: float = 0.0
    com_pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    com_rot: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(3))
    inertia: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((3, 3)))
    collisions: List[GeomSpec] = dataclasses.field(default_factory=list)
    visuals: List[GeomSpec] = dataclasses.field(default_factory=list)


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
    effort: float = np.inf
    velocity: float = np.inf
    damping: float = 0.0
    friction: float = 0.0
    mimic: Optional[MimicSpec] = None


@dataclasses.dataclass
class RobotSpec:
    name: str
    links: List[LinkSpec]          # document order
    joints: List[JointSpec]        # document order (= SAPIEN qpos order)

    @property
    def link_names(self) -> List[str]:
        return [l.name for l in self.links]

    def link_index(self) -> Dict[str, int]:
        return {lk.name: i for i, lk in enumerate(self.links)}

    @property
    def movable_joints(self) -> List[JointSpec]:
        return [j for j in self.joints if j.jtype != JOINT_FIXED]

    @property
    def dof(self) -> int:
        return len(self.movable_joints)


def _geom_to_json(g: GeomSpec, npz: Dict[str, np.ndarray], key: str):
    d = {"kind": g.kind,
         "origin_pos": np.asarray(g.origin_pos).tolist(),
         "origin_rot": np.asarray(g.origin_rot).reshape(-1).tolist()}
    if g.size is not None:
        d["size"] = np.asarray(g.size).tolist()
    if g.points is not None:
        npz[key] = np.asarray(g.points, np.float32)
        d["points_key"] = key
    return d


def _finite_or_none(x: float):
    return float(x) if np.isfinite(x) else None


def save_robot_spec(spec: RobotSpec, out_dir: str,
                    surface_points: Optional[Dict[str, np.ndarray]] = None):
    """Write ``<name>.json`` + ``<name>_geom.npz`` into ``out_dir``, as
    :func:`load_robot_spec` reads them: links and joints in document
    order, collision support points and per-link ``surface_points`` in
    the NPZ.  Mesh geoms must already be reduced to "points" geoms
    (tools/extract_robot_specs.py)."""
    npz: Dict[str, np.ndarray] = {}
    links = [{
        "name": lk.name, "mass": float(lk.mass),
        "com_pos": np.asarray(lk.com_pos).tolist(),
        "com_rot": np.asarray(lk.com_rot).reshape(-1).tolist(),
        "inertia": np.asarray(lk.inertia).reshape(-1).tolist(),
        "collisions": [_geom_to_json(g, npz, f"col/{lk.name}/{i}")
                       for i, g in enumerate(lk.collisions)],
    } for lk in spec.links]
    joints = []
    for j in spec.joints:
        jj = {
            "name": j.name, "type": int(j.jtype),
            "parent": j.parent, "child": j.child,
            "origin_pos": np.asarray(j.origin_pos).tolist(),
            "origin_rot": np.asarray(j.origin_rot).reshape(-1).tolist(),
            "axis": np.asarray(j.axis).tolist(),
            "limit": [float(j.limit_lower), float(j.limit_upper)],
            "effort": _finite_or_none(j.effort),
            "velocity": _finite_or_none(j.velocity),
            "damping": float(j.damping), "friction": float(j.friction),
        }
        if j.mimic is not None:
            jj["mimic"] = {"joint": j.mimic.joint,
                           "multiplier": j.mimic.multiplier,
                           "offset": j.mimic.offset}
        joints.append(jj)
    for name, pts in (surface_points or {}).items():
        npz[f"surf/{name}"] = np.asarray(pts, np.float32)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{spec.name}.json"), "w") as f:
        json.dump({"name": spec.name, "links": links, "joints": joints}, f,
                  indent=1)
    np.savez_compressed(os.path.join(out_dir, f"{spec.name}_geom.npz"),
                        **npz)


def _geom_from_json(d: dict, npz) -> GeomSpec:
    return GeomSpec(
        kind=d["kind"],
        origin_pos=np.asarray(d["origin_pos"]),
        origin_rot=np.asarray(d["origin_rot"]).reshape(3, 3),
        size=np.asarray(d["size"]) if "size" in d else None,
        points=np.asarray(npz[d["points_key"]]) if "points_key" in d else None)


def load_robot_spec(name: str, spec_dir: Optional[str] = None) -> RobotSpec:
    spec_dir = spec_dir or constants.ROBOT_SPEC_DIR
    with open(os.path.join(spec_dir, f"{name}.json")) as f:
        data = json.load(f)
    with np.load(os.path.join(spec_dir, f"{name}_geom.npz")) as npz:
        links = [LinkSpec(
            name=lj["name"], mass=lj["mass"],
            com_pos=np.asarray(lj["com_pos"]),
            com_rot=np.asarray(lj["com_rot"]).reshape(3, 3),
            inertia=np.asarray(lj["inertia"]).reshape(3, 3),
            collisions=[_geom_from_json(g, npz) for g in lj["collisions"]])
            for lj in data["links"]]
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
            effort=jj["effort"] if jj["effort"] is not None else np.inf,
            velocity=jj["velocity"] if jj["velocity"] is not None else np.inf,
            damping=jj["damping"], friction=jj["friction"],
            mimic=mimic))
    return RobotSpec(name=data["name"], links=links, joints=joints)


def load_surface_points(name: str, spec_dir: Optional[str] = None
                        ) -> Dict[str, np.ndarray]:
    """Per-link surface point samples (link frame) of robot ``name``."""
    spec_dir = spec_dir or constants.ROBOT_SPEC_DIR
    with np.load(os.path.join(spec_dir, f"{name}_geom.npz")) as npz:
        return {k[len("surf/"):]: npz[k] for k in npz.files
                if k.startswith("surf/")}
