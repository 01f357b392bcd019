"""Procedural semantic Gaussian splats for the synthetic stand-in scene
(port of gsworld_tpu/gs/synthetic.py).

Pure numpy.  The random draws are made in exactly the JAX package's
order, so the same seed gives the same splats in both packages.  Value
distributions mimic trained 3DGS scenes (log-scales ~ N(-5.5, 0.8),
logit-opacities biased positive, near-unit wxyz quats).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from benchmark.reference.gsw.gs.model import SH_REST_COEFFS

SH_C0 = 0.28209479177387814  # SH DC basis


def _rand_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q *= (1.0 + 0.01 * rng.normal(size=(n, 1))).astype(np.float32)
    return q


def make_blob(
    rng: np.random.Generator,
    n: int,
    center: Sequence[float],
    extent: Union[float, Sequence[float]],
    color: Sequence[float],
    label: int,
    log_scale_mean: float = -5.5,
) -> Dict[str, np.ndarray]:
    """A Gaussian blob splat dict: points uniform in a box around center."""
    extent = np.broadcast_to(np.asarray(extent, np.float32), (3,))
    means = (np.asarray(center, np.float32)
             + rng.uniform(-1, 1, size=(n, 3)).astype(np.float32) * extent)
    rgb = np.clip(np.asarray(color, np.float32)
                  + 0.08 * rng.normal(size=(n, 3)), 0.0, 1.0
                  ).astype(np.float32)
    sh0 = ((rgb - 0.5) / SH_C0)[:, :, None]
    shn = (0.02 * rng.normal(size=(n, 3, SH_REST_COEFFS))).astype(np.float32)
    scales = (log_scale_mean + 0.8 * rng.normal(size=(n, 3))).astype(np.float32)
    opac = (2.0 + 1.0 * rng.normal(size=(n, 1))).astype(np.float32)
    return {
        "means": means,
        "sh0": sh0.astype(np.float32),
        "shN": shn,
        "scales": scales,
        "quats": _rand_quats(rng, n),
        "opacities": opac,
        "semantics": np.full(n, label, np.int32),
    }


def concat_splats(splats: Iterable[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    splats = list(splats)
    return {k: np.concatenate([s[k] for s in splats], axis=0)
            for k in splats[0]}


def make_room_shell(
    rng: np.random.Generator,
    n: int,
    center: Sequence[float],
    extent: Sequence[float],
    color: Sequence[float],
    label: int = -1,
    log_scale_mean: float = -4.2,
) -> Dict[str, np.ndarray]:
    """Background splats on the surface of a box (floor, 4 walls,
    ceiling), faces chosen in proportion to their area."""
    extent = np.asarray(extent, np.float64)
    center = np.asarray(center, np.float64)
    areas = np.repeat(np.array([extent[0] * extent[1],
                                extent[0] * extent[2],
                                extent[1] * extent[2]]), 2)
    face = rng.choice(6, size=n, p=areas / areas.sum())
    pts = rng.uniform(-1, 1, size=(n, 3)) * extent
    sign = np.where(face % 2 == 0, -1.0, 1.0)
    pick = np.array([2, 2, 1, 1, 0, 0])[face]
    for a in range(3):
        m = pick == a
        pts[m, a] = sign[m] * extent[a]
    blob = make_blob(rng, n, [0, 0, 0], 0.0, color, label,
                     log_scale_mean=log_scale_mean)
    blob["means"] = (pts + center).astype(np.float32)
    return blob


def make_tabletop_scene(
    seed: int = 0,
    n_background: int = 20000,
    n_per_link: int = 1500,
    n_per_object: int = 3000,
    link_labels: Optional[Dict[str, Union[int, List[int]]]] = None,
    object_labels: Optional[Dict[str, int]] = None,
    link_centers: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """A whole synthetic tabletop as one splat dict: a background box,
    one blob per robot link label (stacked up the z axis unless
    ``link_centers`` (L, 3) places them) and one per object along the
    table.  Labels follow the constants' scheme (-1 background, links
    0..L, objects >= 100)."""
    rng = np.random.default_rng(seed)
    parts = [make_blob(rng, n_background, [0.3, 0.0, 0.4], [1.5, 1.5, 0.8],
                       [0.55, 0.5, 0.45], -1, log_scale_mean=-4.5)]
    for i, label in enumerate((link_labels or {}).values()):
        c = (link_centers[i] if link_centers is not None
             else np.array([0.0, 0.0, 0.1 + 0.09 * i], np.float32))
        for lab in (label if isinstance(label, list) else [label]):
            parts.append(make_blob(rng, n_per_link, c, 0.05,
                                   [0.9, 0.9, 0.92], lab))
    for j, label in enumerate((object_labels or {}).values()):
        c = np.array([0.55, -0.25 + 0.18 * j, 0.03], np.float32)
        col = [0.2 + 0.3 * (j % 3 == 0), 0.6 * (j % 3 == 1) + 0.2,
               0.6 * (j % 3 == 2) + 0.2]
        parts.append(make_blob(rng, n_per_object, c, [0.035, 0.035, 0.05],
                               col, label))
    return concat_splats(parts)
