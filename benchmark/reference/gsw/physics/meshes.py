"""Mesh utilities of the scene builders (port of
gsworld_tpu/physics/meshes.py, host side: numpy + scipy): STL / PLY / OBJ
readers, convex support points, farthest-point sampling and the support
points of primitive shapes."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_stl(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load an STL file -> (vertices (V, 3), faces (F, 3) int32).

    Handles binary and ascii STL. Vertices are not deduplicated across
    faces for ascii; binary path dedups exactly equal vertices.
    """
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        data = f.read()
    if head == b"solid":
        # might still be binary with a "solid" header; sniff for "facet"
        if b"facet" in data[:500]:
            return _load_stl_ascii(data.decode("ascii", errors="ignore"))
    return _load_stl_binary(data)


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a triangle mesh from .stl / .ply / .obj ->
    (vertices (V, 3) f64, faces (F, 3) i32). The DTC/YCB asset DBs ship
    convex collision meshes as PLY (reference dtc.py:32-38, ycb.py:24-30)."""
    low = path.lower()
    if low.endswith(".stl"):
        return load_stl(path)
    if low.endswith(".ply"):
        return _load_ply_mesh(path)
    if low.endswith(".obj"):
        return _load_obj_mesh(path)
    raise ValueError(f"unsupported mesh format: {path}")


def _load_obj_mesh(path: str):
    verts, faces = [], []
    for line in open(path):
        t = line.split()
        if not t:
            continue
        if t[0] == "v":
            verts.append([float(v) for v in t[1:4]])
        elif t[0] == "f":
            idx = [int(v.split("/")[0]) - 1 for v in t[1:]]
            for i in range(1, len(idx) - 1):   # fan-triangulate
                faces.append([idx[0], idx[i], idx[i + 1]])
    return (np.asarray(verts, np.float64),
            np.asarray(faces, np.int32).reshape(-1, 3))


def _load_ply_mesh(path: str):
    """Minimal PLY triangle-mesh reader (ascii + binary_little_endian)."""
    f = open(path, "rb")
    assert f.readline().strip() == b"ply"
    fmt = None
    elems = []          # (name, count, [(prop_name, dtype) or ("list", ...)])
    cur = None
    while True:
        line = f.readline().strip().decode()
        if line == "end_header":
            break
        t = line.split()
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = (t[1], int(t[2]), [])
            elems.append(cur)
        elif t[0] == "property":
            cur[2].append(tuple(t[1:]))
    _np = {"float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
           "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
           "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
           "uint": "u4", "uint32": "u4"}
    verts = faces = None
    for name, count, props in elems:
        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(count)]
            if name == "vertex":
                names = [p[-1] for p in props]
                xi = [names.index(k) for k in ("x", "y", "z")]
                verts = np.asarray([[float(r[i]) for i in xi] for r in rows])
            elif name == "face":
                faces = []
                for r in rows:
                    n = int(r[0])
                    idx = [int(v) for v in r[1:1 + n]]
                    for i in range(1, n - 1):
                        faces.append([idx[0], idx[i], idx[i + 1]])
                faces = np.asarray(faces, np.int32)
            continue
        # binary little endian
        if name == "vertex":
            dt = np.dtype([(p[1], "<" + _np[p[0]]) for p in props])
            arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
            verts = np.stack([arr["x"], arr["y"], arr["z"]],
                             axis=1).astype(np.float64)
        elif name == "face":
            assert props[0][0] == "list"
            cdt = "<" + _np[props[0][1]]
            idt = "<" + _np[props[0][2]]
            isz = np.dtype(idt).itemsize
            csz = np.dtype(cdt).itemsize
            faces = []
            for _ in range(count):
                n = int(np.frombuffer(f.read(csz), dtype=cdt)[0])
                idx = np.frombuffer(f.read(isz * n), dtype=idt).astype(int)
                for i in range(1, n - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
            faces = np.asarray(faces, np.int32)
        else:
            # skip unknown fixed-size elements
            dt = np.dtype([(p[-1], "<" + _np[p[0]]) for p in props])
            f.read(dt.itemsize * count)
    f.close()
    if faces is None:
        faces = np.zeros((0, 3), np.int32)
    return verts, faces


def _load_stl_binary(data: bytes):
    n_tri = int(np.frombuffer(data[80:84], dtype="<u4")[0])
    rec = np.frombuffer(data[84:84 + n_tri * 50], dtype=np.uint8).reshape(n_tri, 50)
    tris = rec[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3)
    flat = tris.reshape(-1, 3)
    verts, inv = np.unique(flat.round(8), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    return verts.astype(np.float64), faces


def _load_stl_ascii(text: str):
    verts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            verts.append([float(x) for x in line.split()[1:4]])
    flat = np.asarray(verts, np.float64).reshape(-1, 3)
    uverts, inv = np.unique(flat.round(8), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    return uverts, faces


def farthest_point_sample(points: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """Greedy farthest-point subsampling (returns <=k points)."""
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    if n <= k:
        return points
    rng = np.random.default_rng(seed)
    idx = np.zeros(k, np.int64)
    idx[0] = rng.integers(n)
    d = np.linalg.norm(points - points[idx[0]], axis=1)
    for i in range(1, k):
        idx[i] = int(np.argmax(d))
        d = np.minimum(d, np.linalg.norm(points - points[idx[i]], axis=1))
    return points[idx]


def convex_support_points(verts: np.ndarray, max_points: int = 48) -> np.ndarray:
    """Convex hull vertices, farthest-point-downsampled to <= max_points.
    These act as the support set for contact generation (a static-size
    stand-in for convex-decomposed meshes)."""
    from scipy.spatial import ConvexHull
    verts = np.asarray(verts, np.float64)
    if verts.shape[0] > 3:
        try:
            hull = ConvexHull(verts)
            verts = verts[hull.vertices]
        except Exception:
            pass
    return farthest_point_sample(verts, max_points)


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """``n`` points on a triangle mesh, triangles drawn in proportion to
    their area, uniform inside each (the reference's per-link surface
    sampling); the vertices themselves where the mesh has no area."""
    rng = np.random.default_rng(seed)
    a, b, c = (verts[faces[:, k]] for k in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = areas.sum()
    if total <= 0:
        return verts[rng.integers(0, len(verts), n)]
    fi = rng.choice(len(faces), size=n, p=areas / total)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return a[fi] + u * (b[fi] - a[fi]) + v * (c[fi] - a[fi])


def primitive_points(kind: str, size: np.ndarray, max_points: int = 48) -> np.ndarray:
    """Support points for primitive shapes (box/cylinder/sphere/capsule)."""
    if kind == "box":
        hx, hy, hz = np.asarray(size, np.float64) / 2.0
        corners = np.array([[sx * hx, sy * hy, sz * hz]
                            for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
        return corners
    if kind == "cylinder":
        r, l = float(size[0]), float(size[1])
        ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        ring = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
        top = np.concatenate([ring, np.full((12, 1), l / 2)], axis=1)
        bot = np.concatenate([ring, np.full((12, 1), -l / 2)], axis=1)
        return np.concatenate([top, bot])
    if kind == "sphere":
        r = float(size[0])
        pts = fibonacci_sphere(26) * r
        return pts
    if kind == "capsule":
        r, l = float(size[0]), float(size[1])
        sph = fibonacci_sphere(20) * r
        return np.concatenate([sph + [0, 0, l / 2], sph + [0, 0, -l / 2]])
    raise ValueError(f"unknown primitive {kind}")


def fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1 - 2 * i / max(n - 1, 1)
    r = np.sqrt(np.maximum(0, 1 - y * y))
    return np.stack([np.cos(phi * i) * r, y, np.sin(phi * i) * r], axis=1)
