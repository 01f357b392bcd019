"""Scene reconstruction from a sparse point cloud and posed images (port
of the offline core of gsworld_tpu/real2sim/pipeline.py).

``train_from_colmap_model`` is the entry point of 3DGS training:
``gs.pcd_init.create_from_pcd`` seeds the scene from the sparse points,
``train3dgs.train.train`` densifies and optimises it, and the dead
capacity slots are dropped before it is returned.  The COLMAP / ArUco
stages of ``reconstruct_scene`` are not ported (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gsworld_tpu_torch.gs.model import SCENE_FIELDS, GaussianScene
from gsworld_tpu_torch.gs.pcd_init import create_from_pcd
from gsworld_tpu_torch.render.camera import GSCamera, RasterConfig
from gsworld_tpu_torch.train3dgs.optim import OptimizationParams
from gsworld_tpu_torch.train3dgs.train import train


def train_from_colmap_model(points_xyz: np.ndarray,
                            points_rgb: Optional[np.ndarray],
                            cams: Sequence[GSCamera],
                            images: Sequence, cfg: RasterConfig,
                            params: Optional[OptimizationParams] = None,
                            iterations: Optional[int] = None,
                            capacity: Optional[int] = None,
                            seed: int = 0, device="cuda",
                            callback: Optional[Callable] = None
                            ) -> Tuple[GaussianScene, List[float]]:
    """create_from_pcd -> train on ``device``.  Images are (H, W, 3) in
    [0, 1] (numpy arrays or tensors); ``callback`` is passed to
    :func:`train`.  Returns (scene of the alive Gaussians, losses)."""
    scene0 = create_from_pcd(points_xyz, points_rgb, device=device)
    extent = float(np.linalg.norm(
        points_xyz.max(0) - points_xyz.min(0)) / 2.0) or 1.0
    images = [torch.as_tensor(im, dtype=torch.float32, device=device)
              for im in images]
    scene, ds, losses = train(scene0, list(cams), images, cfg,
                              params=params, iterations=iterations,
                              capacity=capacity, seed=seed,
                              scene_extent=extent, callback=callback)
    alive = ds.alive
    return GaussianScene(**{f: getattr(scene, f)[alive]
                            for f in SCENE_FIELDS}), losses


def write_scene_config(path: str, ply_rel_path: str,
                       semantic_labels=-1, transformation=()):
    """Scene-config JSON in the reference schema (configs/fr3_align.json)."""
    cfg = {"models": [{"data_path": ply_rel_path,
                       "semantic_labels": semantic_labels,
                       "transformation": list(transformation)}]}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    return path
