"""COLMAP text-model I/O: cameras.txt, images.txt, points3D.txt (port of
gsworld_tpu/real2sim/colmap_io.py).

Self-contained replacement for the colmap_wrapper dependency the
reference's ArUco rescaler uses (aruco_scale_factor.py:274-296 rewrites
the sparse model after metric scaling).  Host numpy only.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray      # e.g. PINHOLE: fx fy cx cy

    @property
    def K(self) -> np.ndarray:
        p = self.params
        if self.model in ("PINHOLE",):
            fx, fy, cx, cy = p[:4]
        elif self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray        # wxyz, world->cam rotation
    tvec: np.ndarray        # world->cam translation
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray

    def w2c(self) -> np.ndarray:
        # The JAX package imports a name from gsworld_tpu.physics.kinematics
        # here that it never uses, which pulls JAX into a host tool
        # (ROADMAP C16); the port builds the matrix from the qvec alone.
        w, x, y, z = self.qvec
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)],
        ])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = self.tvec
        return T

    def c2w(self) -> np.ndarray:
        return np.linalg.inv(self.w2c())


def _rows(path):
    """The non-empty, non-comment lines of a text-model file, stripped."""
    with open(path) as f:
        return [line.strip() for line in f
                if line.strip() and not line.startswith("#")]


def read_cameras_txt(path) -> Dict[int, ColmapCamera]:
    out = {}
    for line in _rows(path):
        el = line.split()
        out[int(el[0])] = ColmapCamera(
            camera_id=int(el[0]), model=el[1], width=int(el[2]),
            height=int(el[3]), params=np.asarray([float(v) for v in el[4:]]))
    return out


def read_images_txt(path) -> Dict[int, ColmapImage]:
    """Two lines per image: the pose and name, then (x, y, point3D_id)
    triples.  Empty lines are skipped before pairing, as in the JAX
    reader, so an image without observations other than the last one
    misaligns the pairs after it (ROADMAP C17)."""
    out = {}
    lines = _rows(path)
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.asarray([float(v) for v in pts]).reshape(-1, 3) \
            if pts else np.zeros((0, 3))
        out[int(el[0])] = ColmapImage(
            image_id=int(el[0]),
            qvec=np.asarray([float(v) for v in el[1:5]]),
            tvec=np.asarray([float(v) for v in el[5:8]]),
            camera_id=int(el[8]), name=el[9],
            xys=xys[:, :2], point3D_ids=xys[:, 2].astype(np.int64))
    return out


def read_points3d_txt(path):
    """-> (ids (P,), xyz (P, 3) f64, rgb (P, 3) uint8)."""
    ids, xyz, rgb = [], [], []
    for line in _rows(path):
        el = line.split()
        ids.append(int(el[0]))
        xyz.append([float(v) for v in el[1:4]])
        rgb.append([int(v) for v in el[4:7]])
    return (np.asarray(ids), np.asarray(xyz, np.float64),
            np.asarray(rgb, np.uint8))


def write_model_txt(out_dir, cameras: Dict[int, ColmapCamera],
                    images: Dict[int, ColmapImage], points):
    """Write the three text files (values as ``.12g``)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        for c in cameras.values():
            f.write(f"{c.camera_id} {c.model} {c.width} {c.height} "
                    + " ".join(f"{v:.12g}" for v in c.params) + "\n")
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# Image list\n")
        for im in images.values():
            f.write(f"{im.image_id} "
                    + " ".join(f"{v:.12g}" for v in im.qvec) + " "
                    + " ".join(f"{v:.12g}" for v in im.tvec)
                    + f" {im.camera_id} {im.name}\n")
            row = np.concatenate(
                [im.xys, im.point3D_ids[:, None].astype(np.float64)],
                axis=1) if len(im.xys) else np.zeros((0, 3))
            f.write(" ".join(f"{v:.12g}" for v in row.reshape(-1)) + "\n")
    ids, xyz, rgb = points
    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list\n")
        for i, p, c in zip(ids, xyz, rgb):
            f.write(f"{i} {p[0]:.12g} {p[1]:.12g} {p[2]:.12g} "
                    f"{c[0]} {c[1]} {c[2]} 0\n")
