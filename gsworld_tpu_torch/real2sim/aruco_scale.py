"""ArUco metric scaling of a COLMAP reconstruction (port of
gsworld_tpu/real2sim/aruco_scale.py).

Parity port of real2sim/aruco_estimator: detect the marker in every
frame, ray-cast its corners (n = x @ K^-T @ R^T, aruco.py:25-40),
least-squares-intersect the rays per corner (opt.py:21-58), set
scale = marker_size / mean(adjacent corner distances)
(aruco_scale_factor.py:253), then scale the sparse points and camera
translations and rewrite the model (:274-296).

Detection needs OpenCV and PIL, which are imported only inside the
functions that detect; without them, pass precomputed corner tracks
(the geometry runs on numpy alone).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from gsworld_tpu_torch.real2sim import colmap_io


def detect_aruco_corners_cv2(image, dict_type: str = "DICT_4X4_1000"):
    """Corners (4, 2) of the first marker OpenCV finds, or None."""
    try:
        from cv2 import aruco
    except ImportError as e:
        raise ImportError(
            "OpenCV (cv2) is required for in-process ArUco detection; "
            "install opencv-python or pass precomputed corner tracks") from e
    d = aruco.getPredefinedDictionary(getattr(aruco, dict_type))
    detector = aruco.ArucoDetector(d, aruco.DetectorParameters())
    corners, ids, _ = detector.detectMarkers(image)
    if ids is None or len(corners) == 0:
        return None
    return np.asarray(corners[0][0], np.float64)       # (4, 2)


def _detect_one(path: str):
    """Pool worker: load an image and detect marker corners (or None)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("PIL is required to load images for ArUco "
                          "detection; pass precomputed corner tracks") from e
    return detect_aruco_corners_cv2(np.asarray(Image.open(path)))


def ray_cast_corners(c2w: np.ndarray, K: np.ndarray, corners: np.ndarray):
    """Camera origin + unit rays through the 4 marker corners
    (aruco.py:25-40: n = x @ K^-1.T @ R.T with R = c2w rotation)."""
    R = c2w[:3, :3]
    origin = c2w[:3, 3]
    homog = np.concatenate([corners, np.ones((4, 1))], axis=1)
    rays = homog @ np.linalg.inv(K).T @ R.T
    rays = rays / np.linalg.norm(rays, axis=1, keepdims=True)
    return origin, rays


def intersect_rays(P0: np.ndarray, N: np.ndarray) -> np.ndarray:
    """Least-squares intersection point of K lines (opt.py:21-44)."""
    projs = np.eye(3)[None] - N[:, :, None] * N[:, None, :]
    R = projs.sum(axis=0)
    q = (projs @ P0[:, :, None]).sum(axis=0)
    return (np.linalg.pinv(R) @ q)[:, 0]


def corners_3d_from_tracks(origins: np.ndarray, rays: np.ndarray):
    """(M, 3) origins + (M, 4, 3) rays -> (4, 3) corner points."""
    return np.stack([intersect_rays(origins, rays[:, c]) for c in range(4)])


def scale_from_corners(corners3d: np.ndarray, marker_size: float) -> float:
    """scale = marker_size / mean side length (aruco_scale_factor.py:253)."""
    sides = [np.linalg.norm(corners3d[i] - corners3d[(i + 1) % 4])
             for i in range(4)]
    return float(marker_size / np.mean(sides))


@dataclasses.dataclass
class ArucoScaleResult:
    scale: float
    corners3d: np.ndarray
    n_detections: int


class ArucoScaleFactor:
    """Detection + ray casting + scaling of a COLMAP text model
    (aruco_scale_factor.py:43-297)."""

    def __init__(self, model_dir: str, aruco_size: float = 0.1,
                 image_dir: Optional[str] = None):
        self.model_dir = model_dir
        self.aruco_size = aruco_size
        self.image_dir = image_dir or os.path.join(
            os.path.dirname(model_dir.rstrip("/")), "images")
        self.cameras = colmap_io.read_cameras_txt(
            os.path.join(model_dir, "cameras.txt"))
        self.images = colmap_io.read_images_txt(
            os.path.join(model_dir, "images.txt"))
        self.points = colmap_io.read_points3d_txt(
            os.path.join(model_dir, "points3D.txt"))

    def collect_tracks(self, corner_tracks: Optional[Dict[str, np.ndarray]]
                       = None, num_procs: Optional[int] = None):
        """(origins (M, 3), rays (M, 4, 3)); ``corner_tracks`` maps image
        name -> (4, 2) pixel corners.

        When not given, detection fans out over a process pool as in the
        reference (aruco_scale_factor.py:136-139, Pool(min(12, cpus)));
        ``num_procs=1`` detects in this process."""
        if corner_tracks is None:
            names = [im.name for im in self.images.values()]
            paths = [os.path.join(self.image_dir, n) for n in names]
            if num_procs is None:
                num_procs = min(12, os.cpu_count() or 1)
            if num_procs > 1 and len(paths) > 1:
                import multiprocessing as mp
                with mp.get_context("spawn").Pool(num_procs) as pool:
                    detected = pool.map(_detect_one, paths)
            else:
                detected = [_detect_one(p) for p in paths]
            corner_tracks = {n: c for n, c in zip(names, detected)
                             if c is not None}
        origins, rays = [], []
        for im in self.images.values():
            if im.name not in corner_tracks:
                continue
            corners = np.asarray(corner_tracks[im.name], np.float64)
            K = self.cameras[im.camera_id].K
            o, r = ray_cast_corners(im.c2w(), K, corners)
            origins.append(o)
            rays.append(r)
        return np.asarray(origins), np.asarray(rays)

    def run(self, corner_tracks=None) -> ArucoScaleResult:
        origins, rays = self.collect_tracks(corner_tracks)
        if len(origins) < 2:
            raise ValueError("need >=2 marker detections to triangulate")
        corners3d = corners_3d_from_tracks(origins, rays)
        scale = scale_from_corners(corners3d, self.aruco_size)
        return ArucoScaleResult(scale=scale, corners3d=corners3d,
                                n_detections=len(origins))

    def apply(self, result: ArucoScaleResult, out_dir: str):
        """Scale points3D and camera tvecs, rewrite the text model
        (aruco_scale_factor.py:274-296)."""
        s = result.scale
        ids, xyz, rgb = self.points
        images = {k: dataclasses.replace(im, tvec=im.tvec * s)
                  for k, im in self.images.items()}
        colmap_io.write_model_txt(out_dir, self.cameras, images,
                                  (ids, xyz * s, rgb))
        return out_dir
