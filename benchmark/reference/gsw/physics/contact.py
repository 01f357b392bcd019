"""Contact generation between convex support-point colliders (port of
gsworld_tpu/physics/contact.py).

Every collider is a static-size set of convex support points plus its
convex-hull face planes.  Contact generation is dense and static-shaped:

  * points vs. plane      : exact for convex shapes
    (:func:`points_vs_plane`);
  * points vs. hull faces : SAT quantities of a point set against a hull
    (:func:`hull_query_sat`), run in both directions for each pair;
    :func:`points_vs_hull` gives each point's depth and least-penetrated
    face (the planner's collision checker).

Every candidate contact always exists as a row; an ``active`` mask selects
the penetrating ones.  No shape depends on the data, so a step never asks
the host anything.  Functions broadcast over leading axes (envs, pairs).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.gsw.core.maths import quat_rotate, quat_to_matrix


def hull_faces(points: np.ndarray, max_faces: int = 64) -> np.ndarray:
    """Host side: convex hull face planes (F, 4) as (nx, ny, nz, d) with
    n.x + d <= 0 inside; padded/truncated to max_faces (pad = far plane)."""
    from scipy.spatial import ConvexHull
    pts = np.asarray(points, np.float64)
    try:
        hull = ConvexHull(pts)
        eq = hull.equations  # (F, 4), n.x + d <= 0 inside
        # dedup near-identical faces
        eq = np.unique(eq.round(5), axis=0)
    except Exception:
        # degenerate (flat/small) collider: fall back to AABB faces
        lo, hi = pts.min(0), pts.max(0)
        eq = []
        for ax in range(3):
            n = np.zeros(3); n[ax] = 1.0
            eq.append(np.concatenate([n, [-hi[ax]]]))
            eq.append(np.concatenate([-n, [lo[ax]]]))
        eq = np.asarray(eq)
    if eq.shape[0] > max_faces:
        idx = np.linspace(0, eq.shape[0] - 1, max_faces).astype(int)
        eq = eq[idx]
    pad = np.zeros((max_faces - eq.shape[0], 4))
    pad[:, 2] = 1.0
    pad[:, 3] = -1e9  # "far plane": never the separating face
    return np.concatenate([eq, pad]).astype(np.float32)


class ContactSet(NamedTuple):
    """Fixed-size candidate contact rows (C is static), B envs.

    ``body_a``/``body_b`` index a unified body table (see world.py):
    robot links first, then actors; -1 = static environment.  They are
    the same for every env.  The normal points from B toward A (the
    direction A must move to separate).
    """

    pos: torch.Tensor       # (B, C, 3) world contact point
    normal: torch.Tensor    # (B, C, 3)
    pen: torch.Tensor       # (B, C) penetration depth (> 0 when touching)
    body_a: torch.Tensor    # (C,) int64
    body_b: torch.Tensor    # (C,) int64
    friction: torch.Tensor  # (B, C)
    active: torch.Tensor    # (B, C) bool


def transform_points(pos, quat, pts):
    """Body-frame points (..., K, 3) -> world, poses (..., 3), (..., 4)."""
    return quat_rotate(quat[..., None, :], pts) + pos[..., None, :]


def points_vs_plane(pts_w, plane):
    """Points (..., K, 3) vs a (bounded) plane.

    plane: (4,) = (n, d) with n.x + d = height above, or (8,) =
    (n, d, xmin, xmax, ymin, ymax) restricting contact to an xy region
    (a bounded tabletop).  Returns (pen (..., K), normal (..., K, 3),
    pos (..., K, 3))."""
    n = plane[:3]
    pen = -(pts_w @ n + plane[3])
    if plane.shape[0] >= 8:
        x, y = pts_w[..., 0], pts_w[..., 1]
        inside = ((x >= plane[4]) & (x <= plane[5])
                  & (y >= plane[6]) & (y <= plane[7]))
        pen = torch.where(inside, pen, -1.0)
    return pen, n.expand(pts_w.shape), pts_w


def points_vs_hull(pts_w, hull_pose_pos, hull_pose_quat, faces):
    """Points (..., K, 3) vs a convex hull with faces (..., F, 4) in the
    hull's body frame at world pose (pos (..., 3), quat (..., 4)).

    Returns (pen (..., K), normal_w (..., K, 3), pos (..., K, 3)): a
    point penetrates when it is behind all faces; depth = -max_f signed
    distance; normal = the world normal of the least-penetrated
    (separating) face, pointing out of the hull."""
    Rh = quat_to_matrix(hull_pose_quat)                        # (..., 3, 3)
    local = torch.einsum("...ji,...kj->...ki", Rh,
                         pts_w - hull_pose_pos[..., None, :])
    sd = (local @ faces[..., :3].transpose(-1, -2)
          + faces[..., None, :, 3])                            # (..., K, F)
    max_sd, best = sd.max(dim=-1)                              # first max
    # the separating face's normal per point, as an exact one-hot product
    onehot = torch.nn.functional.one_hot(best, faces.shape[-2]).to(sd.dtype)
    n_local = onehot @ faces[..., :3]                          # (..., K, 3)
    normal_w = torch.einsum("...ij,...kj->...ki", Rh, n_local)
    return -max_sd, normal_w, pts_w


def hull_query_sat(pts_w, hull_pose_pos, hull_pose_quat, faces,
                   margin: float = 0.0):
    """SAT building blocks for src points (..., K, 3) vs a dst hull with
    faces (..., F, 4) in the hull's body frame at pose (pos, quat).

    ``margin`` relaxes the inside test (speculative contacts): a point
    within ``margin`` of being behind every face counts, with its
    (negative) penetration reported faithfully.

    Returns:
      inside (..., K) bool : src point is behind every valid dst face
      depth  (..., F)      : SAT depth of the deepest src point behind each
                             dst face (+big for padding faces)
      sd     (..., K, F)   : signed distance of each point to each face
      nrm_w  (..., F, 3)   : world-frame dst face normals
    """
    Rh = quat_to_matrix(hull_pose_quat)                        # (..., 3, 3)
    local = torch.einsum("...ji,...kj->...ki", Rh,
                         pts_w - hull_pose_pos[..., None, :])
    sd = (local @ faces[..., :3].transpose(-1, -2)
          + faces[..., None, :, 3])                            # (..., K, F)
    valid = faces[..., 3] > -1e8                               # padding = far
    inside = torch.where(valid[..., None, :], sd, -1.0).amax(dim=-1) < margin
    # the (1e7,)*3 padding points are masked out of the per-face min:
    # their huge |sd| would otherwise poison every face whose normal has a
    # negative dot with the pad direction and hide the true minimal axis
    pt_valid = pts_w.abs().amax(dim=-1) < 1e6                  # (..., K)
    sd_for_min = torch.where(pt_valid[..., None], sd, 1e9)
    depth = torch.where(valid, -sd_for_min.amin(dim=-2), 1e9)  # (..., F)
    nrm_w = torch.einsum("...ij,...fj->...fi", Rh, faces[..., :3])
    return inside, depth, sd, nrm_w


def reduce_patch(pen, pos, R: int, margin: float = 0.0):
    """Contact-patch reduction: keep the deepest penetrating point, then
    greedily add the R-1 penetrating points farthest (max-min distance)
    from those already kept.  ``margin`` admits speculative points
    (pen > -margin).  Ties go to the lowest index.

    pen (..., K), pos (..., K, 3) -> (pen (..., R), idx (..., R)).
    Requires K >= R (a point is never picked twice, so there are no
    duplicate active rows).
    """
    K = pen.shape[-1]
    NEG = -1e9
    ar = torch.arange(K, device=pen.device)
    valid = pen > -margin
    fill = NEG + pen
    i0 = torch.where(valid, pen, fill).argmax(dim=-1)
    idxs = [i0]
    taken = ar == i0[..., None]
    p0 = torch.take_along_dim(pos, i0[..., None, None], dim=-2)
    d2min = torch.sum((pos - p0) ** 2, dim=-1)
    for _ in range(R - 1):
        s = torch.where(taken, 2 * NEG, torch.where(valid, d2min, fill))
        j = s.argmax(dim=-1)
        idxs.append(j)
        taken = taken | (ar == j[..., None])
        pj = torch.take_along_dim(pos, j[..., None, None], dim=-2)
        d2min = torch.minimum(d2min, torch.sum((pos - pj) ** 2, dim=-1))
    idx = torch.stack(idxs, dim=-1)                            # (..., R)
    return torch.take_along_dim(pen, idx, dim=-1), idx


def concat_contacts(sets) -> ContactSet:
    """Row-wise concatenation (the row axis is the last of ``body_a`` and
    the second of the per-env fields)."""
    return ContactSet(*[
        torch.cat([getattr(s, f) for s in sets],
                  dim=0 if f in ("body_a", "body_b") else 1)
        for f in ContactSet._fields])
