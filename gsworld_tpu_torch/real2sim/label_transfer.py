"""Semantic label transfer: sim-frame labeled pcd -> GS scan (port of
gsworld_tpu/real2sim/label_transfer.py; host numpy/scipy).

Parity port of real2sim/real2sim_utils/segment_utils.py:55-114 and
scripts/segment_real_gs.py:16-105 (SURVEY.md §2 C22): inverse-transform the
GS points into the sim frame, 1-NN label vote via cKDTree, validate against
per-link AABBs with a distance threshold and closest-bbox fallback; -1 =
background.  The bbox loop is vectorized (the reference iterates per point).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.spatial import cKDTree


def compute_semantic_bboxes(points: np.ndarray, labels: np.ndarray,
                            margin: float = 0.0) -> Dict[int, Tuple]:
    """Per-label AABBs (bbox_utils.py:5-33 analog)."""
    out = {}
    for lab in np.unique(labels):
        if lab < 0:
            continue
        p = points[labels == lab]
        out[int(lab)] = (p.min(axis=0) - margin, p.max(axis=0) + margin)
    return out


def _point_to_bbox_distances(points: np.ndarray, bboxes: Dict[int, Tuple]):
    """(M, n_boxes) distances + label list."""
    labs = sorted(bboxes)
    mins = np.stack([bboxes[l][0] for l in labs])    # (B, 3)
    maxs = np.stack([bboxes[l][1] for l in labs])
    d = np.maximum(np.maximum(mins[None] - points[:, None], 0.0),
                   points[:, None] - maxs[None])     # (M, B, 3)
    return np.linalg.norm(d, axis=2), np.asarray(labs)


def transfer_labels_with_bbox(source_points: np.ndarray,
                              source_labels: np.ndarray,
                              target_points: np.ndarray,
                              transformation_matrix: np.ndarray,
                              semantic_bboxes: Dict[int, Tuple],
                              bbox_distance_threshold: float = 0.1):
    """segment_utils.py:55-114 semantics: target points are mapped into the
    source (sim) frame by inv(T); labels come from the 1-NN source point,
    validated against that label's AABB; if too far, fall back to the
    closest AABB within the threshold, else -1."""
    homog = np.concatenate(
        [target_points, np.ones((len(target_points), 1))], axis=1)
    tt = (np.linalg.inv(transformation_matrix) @ homog.T).T[:, :3]

    tree = cKDTree(source_points)
    distances, indices = tree.query(tt, k=1)
    labels = source_labels[indices].astype(np.int64)

    if semantic_bboxes:
        dists, labs = _point_to_bbox_distances(tt, semantic_bboxes)
        lab_index = {int(l): i for i, l in enumerate(labs)}
        own_col = np.asarray([lab_index.get(int(l), -1) for l in labels])
        has_box = own_col >= 0
        own_dist = np.where(has_box,
                            dists[np.arange(len(tt)), np.maximum(own_col, 0)],
                            np.inf)
        # points whose own bbox is too far: fall back to the closest bbox
        # within the threshold, else -1
        need_fix = has_box & (own_dist > bbox_distance_threshold)
        best_col = np.argmin(dists, axis=1)
        best_dist = dists[np.arange(len(tt)), best_col]
        fallback = np.where(best_dist <= bbox_distance_threshold,
                            labs[best_col], -1)
        labels = np.where(need_fix, fallback, labels)
        labels = np.where(~has_box, -1, labels)
    return labels.astype(np.int32), distances


def segment_real_gs(gs_points: np.ndarray, sim_points: np.ndarray,
                    sim_labels: np.ndarray, sim2gs: np.ndarray,
                    bbox_distance_threshold: float = 0.1,
                    bbox_margin: float = 0.02):
    """The scripts/segment_real_gs.py:16-105 flow: returns (M,) labels for the
    GS scan (save as <scene>_semantics_gs.npy)."""
    bboxes = compute_semantic_bboxes(sim_points, sim_labels, bbox_margin)
    labels, dist = transfer_labels_with_bbox(
        sim_points, sim_labels, gs_points, sim2gs, bboxes,
        bbox_distance_threshold)
    return labels, dist
