"""Scene initialisation from a sparse point cloud (port of
gsworld_tpu/gs/pcd_init.py, the Inria ``create_from_pcd``).

  * SH DC coefficients from RGB: sh0 = (rgb - 0.5) / C0;
  * isotropic log-scales from the mean *squared* distance to the 3 nearest
    neighbours (simple-knn): scales = log(sqrt(clamp(mean3nn_sq, 1e-7)));
  * identity rotations, opacity logit = inverse_sigmoid(0.1);
  * semantics zero unless given.

The KNN runs once on the host (scipy cKDTree).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.spatial import cKDTree

from benchmark.reference.gsw.gs.model import GaussianScene, scene_from_splats

C0 = 0.28209479177387814  # SH band-0 constant


def mean_sq_dist_3nn(points: np.ndarray) -> np.ndarray:
    """Mean squared distance to each point's 3 nearest neighbours."""
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    if n <= 1:
        return np.full((n,), 1e-4)
    d, _ = cKDTree(points).query(points, k=min(4, n))
    return np.mean(d[:, 1:] ** 2, axis=1)


def rgb_to_sh0(rgb: np.ndarray) -> np.ndarray:
    """DC coefficient whose band-0 SH evaluation reproduces ``rgb``."""
    return (np.asarray(rgb, np.float32) - 0.5) / C0


def create_from_pcd(points: np.ndarray, colors: Optional[np.ndarray] = None,
                    semantics: Optional[np.ndarray] = None,
                    device="cuda") -> GaussianScene:
    """Scene from sparse points and optional RGB, in [0, 1] or uint8-range
    (any value above 1 means the colours are divided by 255)."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    if colors is None:
        colors = np.full((n, 3), 0.5, np.float32)
    colors = np.asarray(colors, np.float32)
    if colors.max() > 1.0 + 1e-6:
        colors = colors / 255.0

    dist2 = np.clip(mean_sq_dist_3nn(points), 1e-7, None)
    log_scales = np.repeat(
        np.log(np.sqrt(dist2)).astype(np.float32)[:, None], 3, axis=1)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    opac = np.full((n, 1), np.log(0.1 / (1.0 - 0.1)), np.float32)
    sem = (np.zeros((n,), np.int32) if semantics is None
           else np.asarray(semantics, np.int32))
    return scene_from_splats(dict(
        means=points, sh0=rgb_to_sh0(colors).reshape(n, 3, 1),
        shN=np.zeros((n, 3, 15), np.float32), scales=log_scales,
        quats=quats, opacities=opac, semantics=sem), device=device)
