"""sim<->GS alignment: Umeyama correspondence fit + scaled ICP (port of
gsworld_tpu/real2sim/alignment.py; host numpy/scipy, f64).

Parity port of real2sim/scripts/open3d_alignment.py:32-62 and icp.py
(SURVEY.md §2 C22): a coarse similarity transform from >=3 manual point
correspondences, refined by point-to-point ICP with a 3 cm threshold and
``with_scaling=True``, printing/returning the 4x4 sim2gs matrix destined
for constants.py.  scipy cKDTree replaces open3d."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def umeyama(src: np.ndarray, dst: np.ndarray, with_scaling: bool = True):
    """Least-squares similarity transform mapping src -> dst.
    Returns a 4x4 matrix T with dst ~= T[:3,:3] @ src + T[:3,3]."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    if with_scaling:
        var = (sc ** 2).sum() / len(src)
        scale = np.trace(np.diag(S) @ D) / var
    else:
        scale = 1.0
    t = mu_d - scale * R @ mu_s
    T = np.eye(4)
    T[:3, :3] = scale * R
    T[:3, 3] = t
    return T


def icp_point_to_point(src: np.ndarray, dst: np.ndarray,
                       init: Optional[np.ndarray] = None,
                       threshold: float = 0.03, max_iters: int = 50,
                       with_scaling: bool = True,
                       tol: float = 1e-8) -> Tuple[np.ndarray, float]:
    """Scaled point-to-point ICP (open3d registration_icp equivalent with
    TransformationEstimationPointToPoint(with_scaling=True), 3 cm
    correspondence threshold).

    Returns (T 4x4, rmse of inlier correspondences)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    T = np.eye(4) if init is None else np.asarray(init, np.float64).copy()
    tree = cKDTree(dst)
    prev_rmse = np.inf
    rmse = np.inf
    for _ in range(max_iters):
        cur = src @ T[:3, :3].T + T[:3, 3]
        dist, idx = tree.query(cur, k=1)
        inlier = dist < threshold
        if inlier.sum() < 3:
            break
        T_new = umeyama(src[inlier], dst[idx[inlier]], with_scaling)
        T = T_new
        rmse = float(np.sqrt((dist[inlier] ** 2).mean()))
        if abs(prev_rmse - rmse) < tol:
            break
        prev_rmse = rmse
    return T, rmse


def align_from_correspondences(sim_points, gs_points, sim_cloud=None,
                               gs_cloud=None, threshold: float = 0.03):
    """The open3d_alignment.py flow: Umeyama on picked correspondences,
    optional ICP refinement on the full clouds. Returns the 4x4 sim2gs."""
    T = umeyama(sim_points, gs_points, with_scaling=True)
    if sim_cloud is not None and gs_cloud is not None:
        T, _ = icp_point_to_point(sim_cloud, gs_cloud, init=T,
                                  threshold=threshold)
    return T
