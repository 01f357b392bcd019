"""PLY I/O for 3DGS point clouds (port of gsworld_tpu/gs/ply.py; no
plyfile dependency).

File layout matches the Inria/GSWorld semantic PLY exactly
(gsworld/mani_skill/utils/wrappers/semantic_3dgs_wrapper.py:75-167 and
gsworld/utils/pcd_utils.py:33-129): per-vertex float32 properties

    x y z nx ny nz
    f_dc_0..2                      # SH degree-0 (DC), channel-major
    f_rest_0..44                   # SH degree 1..3, layout [ch][coeff]
    opacity                        # logit
    scale_0..2                     # log
    rot_0..3                       # wxyz quaternion, not necessarily unit
    semantics                      # optional integer label stored as f4

Reads binary_little_endian and ascii PLYs; writes binary_little_endian.
Host numpy only: a scene reaches the device through
``gs.model.scene_from_splats``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

_F_REST_COUNT = 45  # 3 channels x 15 coeffs for SH degree 3
MAX_SH_DEGREE = 3

_TYPE_MAP = {
    b"float": "<f4", b"float32": "<f4", b"double": "<f8", b"float64": "<f8",
    b"uchar": "u1", b"uint8": "u1", b"char": "i1", b"int8": "i1",
    b"short": "<i2", b"int16": "<i2", b"ushort": "<u2", b"uint16": "<u2",
    b"int": "<i4", b"int32": "<i4", b"uint": "<u4", b"uint32": "<u4",
}


def _parse_header(f):
    """Parse a PLY header -> (format, vertex count, property names,
    structured dtype of one vertex)."""
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    props = []
    count = 0
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == b"format":
            fmt = tok[1].decode()
        elif tok[0] == b"element":
            in_vertex = tok[1] == b"vertex"
            if in_vertex:
                count = int(tok[2])
        elif tok[0] == b"property" and in_vertex:
            if tok[1] == b"list":
                raise ValueError(
                    "list properties unsupported for vertex element")
            props.append((tok[2].decode(), _TYPE_MAP[tok[1]]))
        elif tok[0] == b"end_header":
            break
    return fmt, count, [p[0] for p in props], np.dtype(props)


def read_ply_vertex(path: str) -> Dict[str, np.ndarray]:
    """The vertex element of a PLY file as {property name: (N,) array}."""
    with open(path, "rb") as f:
        fmt, count, names, dtype = _parse_header(f)
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(count * dtype.itemsize),
                                 dtype=dtype, count=count)
        elif fmt == "ascii":
            rows = np.loadtxt(f, dtype=np.float64, max_rows=count, ndmin=2)
            data = np.zeros(count, dtype=dtype)
            for i, n in enumerate(names):
                data[n] = rows[:, i]
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return {n: np.ascontiguousarray(data[n]) for n in names}


def write_ply_vertex(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Write named per-vertex float32 columns as a binary_little_endian
    PLY, in the order of ``columns``."""
    names = list(columns.keys())
    n = len(columns[names[0]])
    data = np.zeros(n, dtype=np.dtype([(name, "<f4") for name in names]))
    for name in names:
        data[name] = np.asarray(columns[name], dtype=np.float32).reshape(n)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name in names:
            f.write(f"property float {name}\n".encode())
        f.write(b"end_header\n")
        f.write(data.tobytes())


def load_ply_to_splats(path: str, semantics_default: float = 0.0
                       ) -> Dict[str, np.ndarray]:
    """A 3DGS PLY as a splat dict of numpy arrays (layouts of
    gsworld/utils/pcd_utils.py:72-129):

      means (N,3) f32 | sh0 (N,3,1) | shN (N,3,15) | scales (N,3) log |
      quats (N,4) wxyz | opacities (N,1) logit | semantics (N,) int32
    """
    cols = read_ply_vertex(path)
    n = len(cols["x"])
    means = np.stack([cols["x"], cols["y"], cols["z"]],
                     axis=1).astype(np.float32)
    opac = np.asarray(cols["opacity"], dtype=np.float32)[:, None]

    sh0 = np.zeros((n, 3, 1), np.float32)
    for c in range(3):
        sh0[:, c, 0] = cols[f"f_dc_{c}"]

    rest_names = sorted((k for k in cols if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    assert len(rest_names) == _F_REST_COUNT, \
        f"expected 45 f_rest, got {len(rest_names)}"
    shn = np.zeros((n, _F_REST_COUNT), np.float32)
    for i, k in enumerate(rest_names):
        shn[:, i] = cols[k]
    # stored channel-major: [ch0 c0..c14, ch1 c0..c14, ch2 c0..c14]
    shn = shn.reshape(n, 3, 15)

    scales = np.stack([cols[f"scale_{i}"] for i in range(3)],
                      axis=1).astype(np.float32)
    quats = np.stack([cols[f"rot_{i}"] for i in range(4)],
                     axis=1).astype(np.float32)
    if "semantics" in cols:
        sem = np.asarray(cols["semantics"]).astype(np.int32)
    else:
        sem = np.full(n, int(semantics_default), np.int32)
    return {"means": means, "sh0": sh0, "shN": shn, "scales": scales,
            "quats": quats, "opacities": opac, "semantics": sem}


def save_splats_to_ply(splats: Dict[str, np.ndarray], path: str,
                       with_semantics: Optional[bool] = None) -> None:
    """Inverse of :func:`load_ply_to_splats`; attribute order of the
    reference writer (semantic_3dgs_wrapper.py:75-98)."""
    means = np.asarray(splats["means"], np.float32)
    n = means.shape[0]
    zeros = np.zeros(n, np.float32)
    cols: Dict[str, np.ndarray] = {
        "x": means[:, 0], "y": means[:, 1], "z": means[:, 2],
        "nx": zeros, "ny": zeros, "nz": zeros,
    }
    sh0 = np.asarray(splats["sh0"], np.float32).reshape(n, 3)
    for c in range(3):
        cols[f"f_dc_{c}"] = sh0[:, c]
    shn = np.asarray(splats["shN"], np.float32).reshape(n, _F_REST_COUNT)
    for i in range(_F_REST_COUNT):
        cols[f"f_rest_{i}"] = shn[:, i]
    cols["opacity"] = np.asarray(splats["opacities"], np.float32).reshape(n)
    scales = np.asarray(splats["scales"], np.float32)
    for i in range(3):
        cols[f"scale_{i}"] = scales[:, i]
    quats = np.asarray(splats["quats"], np.float32)
    for i in range(4):
        cols[f"rot_{i}"] = quats[:, i]
    if with_semantics is None:
        with_semantics = "semantics" in splats
    if with_semantics:
        cols["semantics"] = np.asarray(splats["semantics"],
                                       np.float32).reshape(n)
    write_ply_vertex(path, cols)
