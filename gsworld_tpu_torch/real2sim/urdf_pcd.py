"""Robot -> labelled semantic point cloud at the scan pose (port of
gsworld_tpu/real2sim/urdf_pcd.py).

Parity port of real2sim/scripts/uniform_pcd_from_urdf_visual_mesh.py: put
the robot at ``robot_scan_qpos``, sample points area-proportionally
across the link surfaces with per-link semantic labels, export
``<robot>.ply`` + ``<robot>_semantics.npy``.  One FK poses the links (the
port's f32 ``forward_kinematics`` on the CPU, as ``gs.scene_factory``
uses it); the numpy draws follow the JAX package's order, so one seed
gives one cloud in both packages.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from gsworld_tpu_torch import constants
from gsworld_tpu_torch.core.maths import quat_to_matrix
from gsworld_tpu_torch.gs import ply as plyio
from gsworld_tpu_torch.physics.kinematics import (build_articulation,
                                                  forward_kinematics)
from gsworld_tpu_torch.physics.spec_io import (load_robot_spec,
                                               load_surface_points)


def sample_robot_pcd(robot_uid: str, n_points: int = 300_000,
                     qpos: Optional[np.ndarray] = None,
                     gs_semantics: Optional[Dict] = None,
                     seed: int = 0):
    """-> (points (N, 3) f32 in the sim world frame, labels (N,) int32);
    a multi-label link takes its first label."""
    model = build_articulation(load_robot_spec(robot_uid))
    surface = load_surface_points(robot_uid)
    if qpos is None:
        qpos = constants.robot_scan_qpos[robot_uid]
    if gs_semantics is None:
        gs_semantics, _ = constants.robot_calibration(robot_uid)

    pos, quat = forward_kinematics(
        model, torch.as_tensor(np.asarray(qpos, np.float32)))
    R = quat_to_matrix(quat).numpy()
    pos = pos.numpy()

    rng = np.random.default_rng(seed)
    # area-proportional budget: the stored surface samples were drawn
    # area-proportionally, so their count stands for the link's area
    links = [n for n in model.link_names if n in surface and n in gs_semantics]
    weights = np.asarray([len(surface[n]) for n in links], np.float64)
    weights = weights / weights.sum()
    counts = np.floor(weights * n_points).astype(int)
    counts[-1] += n_points - counts.sum()

    pts_out, labels_out = [], []
    for name, cnt in zip(links, counts):
        li = model.link_names.index(name)
        local = surface[name]
        idx = rng.integers(0, len(local), cnt)
        pts_out.append(local[idx] @ R[li].T + pos[li])
        lab = gs_semantics[name]
        lab = lab[0] if isinstance(lab, list) else lab
        labels_out.append(np.full(cnt, lab, np.int32))
    return (np.concatenate(pts_out).astype(np.float32),
            np.concatenate(labels_out))


def export_robot_pcd(robot_uid: str, out_dir: str, n_points: int = 300_000,
                     **kwargs):
    """Write ``<robot>.ply`` (xyz and zero normals) and
    ``<robot>_semantics.npy``; -> the PLY's path."""
    points, labels = sample_robot_pcd(robot_uid, n_points, **kwargs)
    os.makedirs(out_dir, exist_ok=True)
    zeros = np.zeros(len(points), np.float32)
    cols = {"x": points[:, 0], "y": points[:, 1], "z": points[:, 2],
            "nx": zeros, "ny": zeros, "nz": zeros}
    ply_path = os.path.join(out_dir, f"{robot_uid}.ply")
    plyio.write_ply_vertex(ply_path, cols)
    np.save(os.path.join(out_dir, f"{robot_uid}_semantics.npy"), labels)
    return ply_path
