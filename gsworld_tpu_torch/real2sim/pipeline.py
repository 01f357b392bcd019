"""End-to-end real2sim scene construction (port of
gsworld_tpu/real2sim/pipeline.py).

Mirrors the reference orchestration (colmap_and_gs.sh:100-156):

  (1) COLMAP SfM                         -> a text model
  (2) ArUco metric rescale               -> the metric text model
  (3) 3DGS training from the sparse pcd  -> point_cloud/iteration_N/*.ply
  (+) export the PLY into the assets layout and write a scene config

Stages (1) and (2) shell out to host tools (the COLMAP CLI, OpenCV) as
the reference does; stage (3) is ``train_from_colmap_model``:
``gs.pcd_init.create_from_pcd`` seeds the scene from the sparse points,
``train3dgs.train.train`` densifies and optimises it on the device, and
the dead capacity slots are dropped before it is returned.  It needs only
a parsed model and images in memory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gsworld_tpu_torch.gs.model import (SCENE_FIELDS, GaussianScene,
                                        scene_to_splats)
from gsworld_tpu_torch.gs.pcd_init import create_from_pcd
from gsworld_tpu_torch.gs.ply import save_splats_to_ply
from gsworld_tpu_torch.real2sim import colmap_io
from gsworld_tpu_torch.render.camera import (GSCamera, RasterConfig,
                                             camera_from_opencv)
from gsworld_tpu_torch.train3dgs.optim import OptimizationParams
from gsworld_tpu_torch.train3dgs.train import train


@dataclasses.dataclass
class ReconstructionResult:
    scene: GaussianScene
    losses: List[float]
    ply_path: Optional[str] = None
    config_path: Optional[str] = None


def cameras_from_colmap(cameras: Dict[int, colmap_io.ColmapCamera],
                        images: Dict[int, colmap_io.ColmapImage],
                        width: int, height: int, device="cuda"
                        ) -> Tuple[List[GSCamera], List[str]]:
    """GS cameras on ``device`` (and their image names) from a COLMAP
    model, its intrinsics rescaled to the training size (the Inria
    loader's resolution divisor)."""
    cams, names = [], []
    for img in images.values():
        cc = cameras[img.camera_id]
        K = cc.K.copy()
        K[0] *= width / cc.width
        K[1] *= height / cc.height
        w2c = torch.as_tensor(img.w2c(), dtype=torch.float32, device=device)
        cams.append(camera_from_opencv(w2c, K, width, height))
        names.append(img.name)
    return cams, names


def train_from_colmap_model(points_xyz: np.ndarray,
                            points_rgb: Optional[np.ndarray],
                            cams: Sequence[GSCamera],
                            images: Sequence, cfg: RasterConfig,
                            params: Optional[OptimizationParams] = None,
                            iterations: Optional[int] = None,
                            capacity: Optional[int] = None,
                            seed: int = 0, log_every: int = 0,
                            device="cuda", *,
                            callback: Optional[Callable] = None,
                            graph: bool = True
                            ) -> Tuple[GaussianScene, List[float]]:
    """create_from_pcd -> train on ``device``.  Images are (H, W, 3) in
    [0, 1] (numpy arrays or tensors); ``log_every``, ``callback`` and
    ``graph`` (one CUDA graph of the train step on the card) are passed
    to :func:`train`.  Returns (scene of the alive Gaussians, losses)."""
    scene0 = create_from_pcd(points_xyz, points_rgb, device=device)
    extent = float(np.linalg.norm(
        points_xyz.max(0) - points_xyz.min(0)) / 2.0) or 1.0
    images = [torch.as_tensor(im, dtype=torch.float32, device=device)
              for im in images]
    scene, ds, losses = train(scene0, list(cams), images, cfg,
                              params=params, iterations=iterations,
                              capacity=capacity, seed=seed,
                              scene_extent=extent, log_every=log_every,
                              callback=callback, graph=graph)
    alive = ds.alive
    return GaussianScene(**{f: getattr(scene, f)[alive]
                            for f in SCENE_FIELDS}), losses


def _load_images(image_dir: str, names: Sequence[str], width: int,
                 height: int) -> List[np.ndarray]:
    """Images (H, W, 3) f32 in [0, 1], read with imageio and resized with
    PIL (a strided pick without it)."""
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError("imageio is required to read the training images "
                          "from disk; pass them in memory to "
                          "train_from_colmap_model") from e
    out = []
    for n in names:
        img = np.asarray(iio.imread(os.path.join(image_dir, n)))
        if img.shape[0] != height or img.shape[1] != width:
            try:
                from PIL import Image
                img = np.asarray(Image.fromarray(img).resize((width, height)))
            except ImportError:
                ys = np.linspace(0, img.shape[0] - 1, height).astype(int)
                xs = np.linspace(0, img.shape[1] - 1, width).astype(int)
                img = img[ys][:, xs]
        out.append(img[..., :3].astype(np.float32) / 255.0)
    return out


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


def reconstruct_scene(data_dir: str, model_dir: str,
                      iterations: int = 30000,
                      width: Optional[int] = None,
                      height: Optional[int] = None,
                      aruco_size: Optional[float] = None,
                      skip_sfm: bool = False,
                      colmap_command: str = "colmap",
                      camera_model: str = "PINHOLE",
                      export_ply: Optional[str] = None,
                      scene_config: Optional[str] = None,
                      capacity: Optional[int] = None,
                      log_every: int = 500,
                      backend: str = "auto",
                      device="cuda") -> ReconstructionResult:
    """Images -> trained scene (colmap_and_gs.sh:100-156), training on
    ``device``.  ``backend`` is accepted for the JAX package's callers and
    ignored: the port has one backend (the CUDA kernels on the card,
    their plain versions on the CPU).

    ``data_dir`` holds ``images/``; with ``skip_sfm`` it holds the text
    model in ``sparse/0``, else SfM writes one.  The trained PLY lands in
    ``model_dir/point_cloud/iteration_N/``, plus the optional
    ``export_ply`` copy and ``scene_config`` JSON.
    """
    image_dir = os.path.join(data_dir, "images")
    if skip_sfm:
        sparse = os.path.join(data_dir, "sparse", "0")
    else:
        from gsworld_tpu_torch.real2sim.sfm import run_sfm
        # the text model is where run_sfm wrote it; the JAX package reads
        # sparse/0 here, where SfM wrote none (ROADMAP C15)
        sparse = run_sfm(image_dir, data_dir, camera_model=camera_model,
                         colmap_command=colmap_command)
    if aruco_size is not None:
        from gsworld_tpu_torch.real2sim.aruco_scale import ArucoScaleFactor
        asf = ArucoScaleFactor(sparse, aruco_size=aruco_size,
                               image_dir=image_dir)
        asf.apply(asf.run(), sparse)

    cameras = colmap_io.read_cameras_txt(os.path.join(sparse, "cameras.txt"))
    images_meta = colmap_io.read_images_txt(
        os.path.join(sparse, "images.txt"))
    _, xyz, rgb = colmap_io.read_points3d_txt(
        os.path.join(sparse, "points3D.txt"))

    cam0 = next(iter(cameras.values()))
    width = width or cam0.width
    height = height or cam0.height
    cams, names = cameras_from_colmap(cameras, images_meta, width, height,
                                      device=device)
    imgs = _load_images(image_dir, names, width, height)

    scene, losses = train_from_colmap_model(
        xyz, rgb, cams, imgs, RasterConfig(width=width, height=height),
        iterations=iterations, capacity=capacity, log_every=log_every,
        device=device)

    out_dir = os.path.join(model_dir, "point_cloud", f"iteration_{iterations}")
    os.makedirs(out_dir, exist_ok=True)
    ply_path = os.path.join(out_dir, "point_cloud.ply")
    save_splats_to_ply(scene_to_splats(scene), ply_path)
    if export_ply:
        os.makedirs(os.path.dirname(export_ply) or ".", exist_ok=True)
        shutil.copyfile(ply_path, export_ply)
        ply_path = export_ply
    config_path = None
    if scene_config:
        config_path = write_scene_config(scene_config,
                                         os.path.basename(ply_path))
    return ReconstructionResult(scene=scene, losses=losses,
                                ply_path=ply_path, config_path=config_path)
