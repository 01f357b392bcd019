"""Checkpoint / resume (port of gsworld_tpu/utils/checkpoint.py): numpy
``.npz`` bundles of a GaussianScene and of an env state, keyed by field
name, and the state-dict sanity checks.

The JAX package saves scenes through orbax; the port has no orbax, so a
scene is an ``.npz`` of its ``GaussianScene`` fields.  An env state is an
``.npz`` of ``env_state_to_numpy``'s fields, nested names joined by "/"
(``world/qpos``, ``elapsed``, ``task/obj_color``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from gsworld_tpu_torch.envs.base import (
    EnvState,
    env_state_from_numpy,
    env_state_to_numpy,
)
from gsworld_tpu_torch.gs.model import SCENE_FIELDS, GaussianScene
from gsworld_tpu_torch.physics.world import (
    WorldState,
    world_state_from_numpy,
    world_state_to_numpy,
)


def _npz_path(path: str) -> str:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def save_scene(scene: GaussianScene, path: str,
               extra: Optional[Dict[str, Any]] = None):
    """Save a GaussianScene as an .npz of its fields; ``extra`` arrays are
    stored as ``extra/<name>``.  -> the path written (``.npz`` appended
    by numpy where missing)."""
    path = _npz_path(path)
    arrays = {f: getattr(scene, f).detach().cpu().numpy()
              for f in SCENE_FIELDS}
    for k, v in (extra or {}).items():
        arrays[f"extra/{k}"] = (v.detach().cpu().numpy()
                                if isinstance(v, torch.Tensor)
                                else np.asarray(v))
    np.savez(path, **arrays)
    return path if path.endswith(".npz") else path + ".npz"


def load_scene(path: str, like: GaussianScene) -> GaussianScene:
    """Restore a scene saved by :func:`save_scene` on ``like``'s
    device."""
    with np.load(path) as data:
        return GaussianScene(**{
            f: torch.as_tensor(data[f], device=like.means.device)
            for f in SCENE_FIELDS})


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def save_env_state(state, path: str):
    """Save an EnvState (or a WorldState) as an .npz keyed by field name
    -> the path written."""
    path = _npz_path(path)
    fields = (world_state_to_numpy(state) if isinstance(state, WorldState)
              else env_state_to_numpy(state))
    np.savez_compressed(path, **_flatten(fields))
    return path if path.endswith(".npz") else path + ".npz"


def load_env_state(path: str, like):
    """Restore a state saved by :func:`save_env_state` as the kind of
    ``like`` (EnvState or WorldState), on ``like``'s device."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    fields: Dict[str, Any] = {}
    for k, v in flat.items():
        node = fields
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    if isinstance(like, WorldState):
        return world_state_from_numpy(fields, device=like.qpos.device)
    assert isinstance(like, EnvState), type(like)
    fields.setdefault("task", {})
    return env_state_from_numpy(fields, device=like.world.qpos.device)


def is_state_dict_consistent(state_dict: Dict[str, Any]) -> bool:
    """Every array leaf shares the same leading (batch) dimension."""
    sizes = set()

    def visit(node):
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
        else:
            shape = (tuple(node.shape) if isinstance(node, torch.Tensor)
                     else np.shape(node))
            if len(shape) >= 1:
                sizes.add(shape[0])

    visit(state_dict)
    return len(sizes) <= 1


def check_joint_stuck(qpos_history, qvel_history,
                      pos_tol: float = 1e-4, vel_tol: float = 1e-3) -> bool:
    """Joints commanded but not moving: qpos moved no more than
    ``pos_tol`` over the history and no |qvel| above ``vel_tol``."""
    qp = np.asarray(qpos_history)
    qv = np.asarray(qvel_history)
    if len(qp) < 2:
        return False
    moved = np.abs(qp[-1] - qp[0]).max() > pos_tol
    moving = np.abs(qv).max() > vel_tol
    return (not moved) and (not moving)
