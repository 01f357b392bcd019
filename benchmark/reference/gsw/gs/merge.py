"""Scene composition (port of gsworld_tpu/gs/merge.py): load the semantic
Gaussian PLYs a scene-config JSON names and concatenate them into one
scene on the device.

Consumes the reference's scene-config schema verbatim (configs/*.json,
e.g. configs/fr3_align.json; consumed by gaussian_merger.py:29-65,155-191):

    {"models": [{"data_path": "<ply relative to ASSET_DIR>",
                 "semantic_labels": <npy path | int>,
                 "transformation": []}, ...]}

The first entry is conventionally the robot+background scan with
per-point labels; the rest are objects with a scalar label matching
``constants.obj_gs_semantics``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from benchmark.reference.gsw import constants
from benchmark.reference.gsw.gs import ply as plyio
from benchmark.reference.gsw.gs.model import (
    build_slot_ids,
    concatenate_scenes,
    scene_from_splats,
)


def load_scene_config(json_path: str) -> List[dict]:
    with open(json_path, "r") as f:
        config = json.load(f)
    if "models" not in config or not isinstance(config["models"], list):
        raise ValueError("scene config JSON must contain a 'models' list")
    return config["models"]


def _resolve(path: str, asset_dir: str) -> str:
    return path if os.path.isabs(path) else os.path.join(asset_dir, path)


def load_model_entry(entry: dict, asset_dir: str) -> Dict[str, np.ndarray]:
    """One model entry: its PLY and its semantic labels
    (gaussian_merger.py:67-98,162-191): from an ``.npy`` path (one label
    per Gaussian), from a scalar, or else the PLY's own."""
    splats = plyio.load_ply_to_splats(_resolve(entry["data_path"], asset_dir))
    labels = entry.get("semantic_labels", None)
    n = splats["means"].shape[0]
    if isinstance(labels, str):
        sem = np.load(_resolve(labels, asset_dir)).astype(np.int32)
        if sem.shape[0] != n:
            raise ValueError(
                f"semantic npy has {sem.shape[0]} labels for {n} gaussians")
        splats["semantics"] = sem.reshape(n)
    elif isinstance(labels, (int, float)):
        splats["semantics"] = np.full(n, int(labels), np.int32)
    return splats


def merge_scene_from_config(
    cfg_name_or_path: str,
    link_names: Sequence[str] = (),
    object_labels: Optional[Dict[str, int]] = None,
    asset_dir: Optional[str] = None,
    cfg_dir: Optional[str] = None,
    gs_semantics: Optional[Dict[str, Union[int, Sequence[int]]]] = None,
    device="cuda",
):
    """Load and merge a scene config -> (GaussianScene on ``device``,
    SlotLayout).

    ``cfg_name_or_path`` is a path to a JSON file or a bare name resolved
    against CFG_DIR (as gs_world_wrapper.py:76).  Without
    ``object_labels``, every scalar-labelled entry whose label is in
    ``constants.obj_gs_semantics`` becomes an object slot, named by the
    first name that label has there.
    """
    asset_dir = asset_dir or constants.ASSET_DIR
    cfg_dir = cfg_dir or constants.CFG_DIR
    path = cfg_name_or_path
    if not os.path.exists(path):
        path = os.path.join(cfg_dir, f"{cfg_name_or_path}.json")
    cfg_name = os.path.splitext(os.path.basename(path))[0]
    if gs_semantics is None:
        gs_semantics, _ = constants.robot_calibration(cfg_name)

    entries = load_scene_config(path)
    all_splats = [load_model_entry(e, asset_dir) for e in entries]

    semantics = np.concatenate([s["semantics"] for s in all_splats])
    if object_labels is None:
        label2name = {}
        for name, lab in constants.obj_gs_semantics.items():
            label2name.setdefault(lab, name)
        object_labels = {}
        for e in entries:
            lab = e.get("semantic_labels")
            if isinstance(lab, (int, float)) and int(lab) in label2name:
                object_labels[label2name[int(lab)]] = int(lab)

    slot_ids, layout = build_slot_ids(semantics, gs_semantics, link_names,
                                      object_labels)
    offset = 0
    scenes = []
    for s in all_splats:
        n = s["means"].shape[0]
        scenes.append(scene_from_splats(s, slot_ids[offset:offset + n],
                                        device=device))
        offset += n
    return concatenate_scenes(scenes), layout
