"""The port's calibration database (gsworld_tpu_torch.constants) is its
own copy of the JAX package's (gsworld_tpu.constants): every name it
exports equals the JAX package's, arrays element for element with the
same dtype, dicts key by key, and robot_calibration gives the same pair
for every robot family.  The port module loads no file of the JAX
package."""

import ast
from pathlib import Path

import numpy as np
import pytest

from gsworld_tpu import constants as jc
from gsworld_tpu_torch import constants as tc

EXPORTED = sorted(n for n, v in vars(tc).items()
                  if not n.startswith("_") and not callable(v)
                  and n not in ("annotations", "np", "os"))


def _assert_same(a, b, name):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    elif isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), name
        for k in b:
            _assert_same(a[k], b[k], f"{name}[{k!r}]")
    else:
        assert a == b, name


def test_exports_the_names_the_port_uses():
    assert {"ASSET_DIR", "CFG_DIR", "ROBOT_SPEC_DIR", "fr3_gs_semantics",
            "sim2gs_arm_trans", "sim2gs_object_transforms", "object_offset",
            "object_scale", "obj_gs_semantics", "robot_scan_qpos",
            "robot_task_init_qpos", "fr3_umi_task_init_qpos", "wrist2eef",
            "right2base", "rs_d435i_rgb_k", "xarm_wrist2base",
            "xarm_right2base", "UFGRIPPER_CLOSED_THRESHOLD",
            "cylinder_fix", "sim2gs_xarm_trans", "xarm_gs_semantics",
            "xarm_task_init_qpos"} <= set(EXPORTED)


@pytest.mark.parametrize("name", EXPORTED)
def test_name_equals_jax(name):
    _assert_same(getattr(tc, name), getattr(jc, name), name)


@pytest.mark.parametrize("cfg", ["fr3_align", "franka_test", "xarm6_pick",
                                 "r1_table"])
def test_robot_calibration_equals_jax(cfg):
    got, want = tc.robot_calibration(cfg), jc.robot_calibration(cfg)
    _assert_same(got[0], want[0], f"{cfg} semantics")
    _assert_same(got[1], want[1], f"{cfg} sim2gs")
    with pytest.raises(NotImplementedError):
        tc.robot_calibration("ur5_scene")


def test_port_module_loads_no_jax_package_file():
    tree = ast.parse(Path(tc.__file__).read_text())
    imported = {a.name for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names} | {
        n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert imported <= {"__future__", "annotations", "os", "numpy", "np"}, \
        imported
    assert "spec_from_file_location" not in Path(tc.__file__).read_text()
