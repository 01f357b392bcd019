"""Calibration database of the port.

The numbers are measured data (sim->GS alignments, semantic id maps,
scan/init joint configurations, camera intrinsics and hand-eye
calibrations).  They have ONE source: ``gsworld_tpu/constants.py``, which
imports only ``os``, ``pathlib`` and ``numpy``.  It is loaded here by file
path, so the JAX package's ``__init__`` (and with it JAX) never runs.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

_SOURCE = (Path(__file__).resolve().parent.parent / "gsworld_tpu"
           / "constants.py")


def _load_source():
    spec = importlib.util.spec_from_file_location(
        "gsworld_tpu_torch._calibration_data", _SOURCE)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load calibration data from {_SOURCE}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_src = _load_source()

CFG_DIR = _src.CFG_DIR
ASSET_DIR = _src.ASSET_DIR
ROBOT_SPEC_DIR = _src.ROBOT_SPEC_DIR

robot_calibration = _src.robot_calibration
fr3_gs_semantics = _src.fr3_gs_semantics
sim2gs_arm_trans = _src.sim2gs_arm_trans
sim2gs_object_transforms = _src.sim2gs_object_transforms
object_offset = _src.object_offset
object_scale = _src.object_scale
obj_gs_semantics = _src.obj_gs_semantics
robot_scan_qpos = _src.robot_scan_qpos
robot_task_init_qpos = _src.robot_task_init_qpos
fr3_umi_task_init_qpos = _src.fr3_umi_task_init_qpos
wrist2eef = _src.wrist2eef
right2base = _src.right2base
rs_d435i_rgb_k = _src.rs_d435i_rgb_k
