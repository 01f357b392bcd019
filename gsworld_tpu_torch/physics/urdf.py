"""URDF parsing into the port's plain-data robot description (port of
gsworld_tpu/physics/urdf.py, ``parse_urdf``).

Self-contained (xml.etree only).  Produces the ``physics/spec_io.py``
dataclasses, which ``physics.kinematics.build_articulation`` compiles.
The shipped robots are read from their extracted JSON+NPZ files
(``spec_io.load_robot_spec``); this parser serves user robots of the
real2sim pipeline (reference analog: SAPIEN's URDF loader reached via
mani_skill BaseAgent, e.g. fr3_umi.py:18).

Conventions: URDF origins are (xyz, rpy) with fixed-axis rolls:
R = Rz(yaw) @ Ry(pitch) @ Rx(roll).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional, Tuple

import numpy as np

from gsworld_tpu_torch.physics.spec_io import (
    JOINT_FIXED,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    GeomSpec,
    JointSpec,
    LinkSpec,
    MimicSpec,
    RobotSpec,
)

_TYPE_MAP = {
    "fixed": JOINT_FIXED,
    "revolute": JOINT_REVOLUTE,
    "continuous": JOINT_REVOLUTE,
    "prismatic": JOINT_PRISMATIC,
}


def _floats(text: str) -> np.ndarray:
    return np.asarray([float(v) for v in text.split()], np.float64)


def rpy_to_matrix(rpy) -> np.ndarray:
    r, p, y = float(rpy[0]), float(rpy[1]), float(rpy[2])
    cr, sr, cp, sp = np.cos(r), np.sin(r), np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _origin(elem) -> Tuple[np.ndarray, np.ndarray]:
    if elem is None:
        return np.zeros(3), np.eye(3)
    return (_floats(elem.get("xyz", "0 0 0")),
            rpy_to_matrix(_floats(elem.get("rpy", "0 0 0"))))


def _parse_geom(elem, base_dir: str) -> Optional[GeomSpec]:
    pos, rot = _origin(elem.find("origin"))
    geo = elem.find("geometry")
    if geo is None:
        return None
    for child in geo:
        tag = child.tag
        if tag == "mesh":
            fn = child.get("filename", "").replace("package://", "")
            path = fn if os.path.isabs(fn) else os.path.normpath(
                os.path.join(base_dir, fn))
            return GeomSpec("mesh", pos, rot, mesh_path=path,
                            mesh_scale=_floats(child.get("scale", "1 1 1")))
        if tag == "box":
            return GeomSpec("box", pos, rot, size=_floats(child.get("size")))
        if tag in ("cylinder", "capsule"):
            return GeomSpec(tag, pos, rot,
                            size=np.array([float(child.get("radius")),
                                           float(child.get("length"))]))
        if tag == "sphere":
            return GeomSpec("sphere", pos, rot,
                            size=np.array([float(child.get("radius"))]))
    return None


def _parse_link(le, base_dir: str) -> LinkSpec:
    link = LinkSpec(name=le.get("name"))
    inertial = le.find("inertial")
    if inertial is not None:
        link.com_pos, link.com_rot = _origin(inertial.find("origin"))
        m = inertial.find("mass")
        link.mass = float(m.get("value")) if m is not None else 0.0
        ine = inertial.find("inertia")
        if ine is not None:
            i = {k: float(ine.get(k, 0))
                 for k in ("ixx", "iyy", "izz", "ixy", "ixz", "iyz")}
            link.inertia = np.array([[i["ixx"], i["ixy"], i["ixz"]],
                                     [i["ixy"], i["iyy"], i["iyz"]],
                                     [i["ixz"], i["iyz"], i["izz"]]])
    for tag, out in (("collision", link.collisions),
                     ("visual", link.visuals)):
        for ge in le.findall(tag):
            g = _parse_geom(ge, base_dir)
            if g is not None:
                out.append(g)
    return link


def _parse_joint(je) -> JointSpec:
    jtype = _TYPE_MAP.get(je.get("type"))
    if jtype is None:
        raise ValueError(f"unsupported joint type {je.get('type')!r}")
    pos, rot = _origin(je.find("origin"))
    ax = je.find("axis")
    axis = _floats(ax.get("xyz")) if ax is not None else np.array([1.0, 0, 0])
    n = np.linalg.norm(axis)
    axis = axis / n if n > 0 else axis
    j = JointSpec(name=je.get("name"), jtype=jtype,
                  parent=je.find("parent").get("link"),
                  child=je.find("child").get("link"),
                  origin_pos=pos, origin_rot=rot, axis=axis)
    lim = je.find("limit")
    if lim is not None:
        for attr, field in (("lower", "limit_lower"), ("upper", "limit_upper"),
                            ("effort", "effort"), ("velocity", "velocity")):
            if lim.get(attr) is not None:
                setattr(j, field, float(lim.get(attr)))
    if je.get("type") == "continuous":
        j.limit_lower, j.limit_upper = -2 * np.pi, 2 * np.pi
    dyn = je.find("dynamics")
    if dyn is not None:
        j.damping = float(dyn.get("damping", 0))
        j.friction = float(dyn.get("friction", 0))
    mim = je.find("mimic")
    if mim is not None:
        j.mimic = MimicSpec(joint=mim.get("joint"),
                            multiplier=float(mim.get("multiplier") or 1.0),
                            offset=float(mim.get("offset") or 0.0))
    return j


def parse_urdf(path: str) -> RobotSpec:
    """Links and joints of a URDF file, in document order (the qpos order
    of SAPIEN)."""
    root = ET.parse(path).getroot()
    base_dir = os.path.dirname(os.path.abspath(path))
    return RobotSpec(name=root.get("name", "robot"),
                     links=[_parse_link(le, base_dir)
                            for le in root.findall("link")],
                     joints=[_parse_joint(je) for je in root.findall("joint")])
