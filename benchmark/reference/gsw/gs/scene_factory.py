"""Scene acquisition (port of gsworld_tpu/gs/scene_factory.py): the real
GS scans a scene config names, merged by gs/merge.py, or a synthetic
stand-in where the scans are absent.

The stand-in of either robot family (the ``fr3_*`` and ``xarm6_*`` scene
configs) is built in the GS frame of the scene config from the
calibration data and the robot's surface points: link Gaussians at
``sim2gs . T_link(scan_qpos)``, object Gaussians at
``sim2gs_obj . (local surface)``, so the repose moves them as it moves
real scans.  The numpy draws follow the JAX package's order, so one seed
gives one scene in both packages.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.gsw import constants
from benchmark.reference.gsw.core.maths import quat_to_matrix
from benchmark.reference.gsw.gs import merge as gsmerge
from benchmark.reference.gsw.gs import synthetic
from benchmark.reference.gsw.gs.model import (
    GaussianScene,
    SlotLayout,
    build_slot_ids,
    scene_from_splats,
)
from benchmark.reference.gsw.physics.kinematics import forward_kinematics


def _apply_tf(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def synthesize_scene(
    cfg_name: str,
    model,                      # ArticulationModel
    scan_qpos: np.ndarray,
    object_names: Sequence[str],
    seed: int = 0,
    n_background: int = 120_000,
    n_per_link: int = 6_000,
    n_per_object: int = 6_000,
    surface_points: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """Synthetic semantic splat dict in the GS frame of ``cfg_name``."""
    gs_sem, sim2gs = constants.robot_calibration(cfg_name)
    rng = np.random.default_rng(seed)
    parts = []

    # room shell + table patch (the sim tabletop z=0 mapped through sim2gs)
    parts.append(synthetic.make_room_shell(
        rng, int(n_background * 0.7), [0.0, -0.5, 0.0], [1.8, 1.2, 1.8],
        [0.5, 0.48, 0.45], -1))
    table_sim = rng.uniform([-0.3, -0.7, -0.01], [1.2, 0.7, 0.0],
                            size=(n_background - int(n_background * 0.7), 3))
    tbl = synthetic.make_blob(rng, len(table_sim), [0, 0, 0], 0.0,
                              [0.45, 0.32, 0.2], -1, log_scale_mean=-4.8)
    tbl["means"] = _apply_tf(np.asarray(sim2gs, np.float64),
                             table_sim).astype(np.float32)
    parts.append(tbl)

    # robot links at their scan pose (f32 FK, as the JAX package)
    pos, quat = forward_kinematics(
        model, torch.as_tensor(np.asarray(scan_qpos, np.float32)))
    Rl = quat_to_matrix(quat).numpy()
    pos = pos.numpy()
    for name, labels in gs_sem.items():
        if name not in model.link_names:
            continue
        li = model.link_names.index(name)
        if surface_points and name in surface_points and \
                len(surface_points[name]) > 8:
            local = np.asarray(surface_points[name])
            idx = rng.integers(0, len(local), n_per_link)
            base = local[idx] + 0.002 * rng.normal(size=(n_per_link, 3))
        else:
            base = 0.03 * rng.normal(size=(n_per_link, 3))
        gs_pts = _apply_tf(sim2gs, base @ Rl[li].T + pos[li])
        labels = labels if isinstance(labels, list) else [labels]
        n = len(gs_pts) // len(labels)    # multi-label links split points
        for j, lab in enumerate(labels):
            sl = synthetic.make_blob(rng, n, [0, 0, 0], 0.0,
                                     [0.85, 0.85, 0.88], lab,
                                     log_scale_mean=-5.8)
            sl["means"] = gs_pts[j * n:(j + 1) * n].astype(np.float32)
            parts.append(sl)

    palette = [[0.2, 0.7, 0.25], [0.75, 0.2, 0.2], [0.7, 0.6, 0.2],
               [0.3, 0.4, 0.8], [0.8, 0.5, 0.2]]
    for k, name in enumerate(object_names):
        label = constants.obj_gs_semantics[name]
        T_obj = constants.sim2gs_object_transforms.get(name, np.eye(4))
        local = rng.uniform(-1, 1, size=(n_per_object, 3)) * [0.033, 0.06, 0.033]
        sl = synthetic.make_blob(rng, n_per_object, [0, 0, 0], 0.0,
                                 palette[k % len(palette)], label,
                                 log_scale_mean=-5.8)
        sl["means"] = _apply_tf(np.asarray(T_obj, np.float64),
                                local).astype(np.float32)
        parts.append(sl)
    return synthetic.concat_splats(parts)


def get_scene(cfg_name: str, model, scan_qpos, object_names,
              link_names: Sequence[str],
              asset_dir: Optional[str] = None,
              cfg_dir: Optional[str] = None,
              synthetic_seed: int = 0,
              synthetic_sizes: Optional[dict] = None,
              surface_points: Optional[Dict[str, np.ndarray]] = None,
              device="cuda") -> Tuple[GaussianScene, SlotLayout, bool]:
    """(scene, layout, is_real): the merged real scans of
    ``<cfg_dir>/<cfg_name>.json`` when it exists and names files that
    exist, else the synthetic stand-in.  As in the JAX package, only a
    missing file (``FileNotFoundError``) falls back; any other fault of
    the config or its scans raises."""
    cfg_dir = cfg_dir or constants.CFG_DIR
    asset_dir = asset_dir or constants.ASSET_DIR
    cfg_path = os.path.join(cfg_dir, f"{cfg_name}.json")
    gs_sem, _ = constants.robot_calibration(cfg_name)
    object_labels = {n: constants.obj_gs_semantics[n] for n in object_names}
    if os.path.exists(cfg_path):
        try:
            scene, layout = gsmerge.merge_scene_from_config(
                cfg_path, link_names=link_names, object_labels=object_labels,
                asset_dir=asset_dir, gs_semantics=gs_sem, device=device)
            return scene, layout, True
        except FileNotFoundError:
            pass
    splats = synthesize_scene(cfg_name, model, scan_qpos, object_names,
                              seed=synthetic_seed,
                              surface_points=surface_points,
                              **(synthetic_sizes or {}))
    slot_ids, layout = build_slot_ids(splats["semantics"], gs_sem,
                                      link_names, object_labels)
    return scene_from_splats(splats, slot_ids, device=device), layout, False
