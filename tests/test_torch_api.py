"""Parity of the port's remaining public functions with their JAX twins on
the CPU, on inputs made with numpy from a seed:

  * ``gs/synthetic.make_tabletop_scene``, ``physics/meshes.sample_surface``:
    host numpy in both packages, array for array equal;
  * ``physics/spec_io.save_robot_spec`` (and the port's robot-spec
    extraction tool): the JSON text and every NPZ array equal to the JAX
    package's output, and read back by the port's loader equal to the
    asset it was written from;
  * ``gs/transform.transform_gaussians`` / ``identity_slots``,
    ``core/maths.extract_rigid_transform`` / ``tf_apply`` /
    ``quat_inverse``: f32 arithmetic in another order, within TOL = 1e-5
    (absolute, on values of order 1);
  * ``gs/model.SlotLayout.slot_of`` and the ``RobotSpec`` helpers
    (``dof``, ``link_index``, ``movable_joints``): equal;
  * ``render/rasterize.render_uint8``: >= 40 dB uint8 PSNR against JAX's
    on a tiny scene (JAX's CPU render composites in its XLA path).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsworld_tpu import constants as jconst
from gsworld_tpu.core import maths as jm
from gsworld_tpu.gs import synthetic as jsyn
from gsworld_tpu.gs import transform as jtr
from gsworld_tpu.gs.model import build_slot_ids as j_build_slot_ids
from gsworld_tpu.physics import meshes as jmeshes
from gsworld_tpu.physics import spec_io as jspec
from gsworld_tpu.render.camera import RasterConfig as JCfg
from gsworld_tpu.render.camera import make_camera as j_make_camera
from gsworld_tpu.render.rasterize import render_uint8 as j_render_uint8
from gsworld_tpu_torch import gs as tgs
from gsworld_tpu_torch import render as trender
from gsworld_tpu_torch.core import maths as tm
from gsworld_tpu_torch.gs import synthetic as tsyn
from gsworld_tpu_torch.gs.model import build_slot_ids
from gsworld_tpu_torch.physics import meshes as tmeshes
from gsworld_tpu_torch.physics import spec_io as tspec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
PSNR_MIN = 40.0


def _quats(rng, *shape):
    q = rng.normal(size=shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


# ------------------------------------------------------------------ #
# host numpy: equal
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("with_parts", [False, True])
def test_make_tabletop_scene_matches_jax(with_parts):
    kw = dict(seed=3, n_background=300, n_per_link=20, n_per_object=30)
    if with_parts:
        kw.update(link_labels={"a": 0, "b": [1, 2]},
                  object_labels={"can": 101, "rack": 102, "box": 103})
    want = jsyn.make_tabletop_scene(**kw)
    got = tsyn.make_tabletop_scene(**kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    centers = np.array([[0.1, 0.2, 0.3], [0.0, -0.1, 0.5]], np.float32)
    kw["link_centers"] = centers
    for k, v in jsyn.make_tabletop_scene(**kw).items():
        np.testing.assert_array_equal(tsyn.make_tabletop_scene(**kw)[k], v)


def _box_mesh(rng):
    verts = rng.uniform(-0.1, 0.1, size=(8, 3))
    faces = np.array([[0, 1, 2], [1, 3, 2], [4, 6, 5], [5, 6, 7],
                      [0, 4, 1], [1, 4, 5], [2, 3, 6], [3, 7, 6],
                      [0, 2, 4], [2, 6, 4], [1, 5, 3], [3, 5, 7]])
    return verts, faces


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_surface_matches_jax(seed):
    verts, faces = _box_mesh(np.random.default_rng(seed))
    want = jmeshes.sample_surface(verts, faces, 500, seed=seed)
    got = tmeshes.sample_surface(verts, faces, 500, seed=seed)
    assert got.shape == (500, 3)
    np.testing.assert_array_equal(got, want)
    # a mesh without area: the vertices themselves
    flat = np.zeros((3, 3))
    np.testing.assert_array_equal(
        tmeshes.sample_surface(flat, np.array([[0, 1, 2]]), 9, seed=seed),
        jmeshes.sample_surface(flat, np.array([[0, 1, 2]]), 9, seed=seed))


def _assert_spec_files_equal(got_dir, want_dir, name):
    with open(os.path.join(got_dir, f"{name}.json")) as f:
        got = f.read()
    with open(os.path.join(want_dir, f"{name}.json")) as f:
        assert got == f.read()
    with np.load(os.path.join(got_dir, f"{name}_geom.npz")) as g, \
            np.load(os.path.join(want_dir, f"{name}_geom.npz")) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_save_robot_spec_matches_jax_and_reads_back(tmp_path):
    name = "fr3_umi"
    spec = tspec.load_robot_spec(name)
    surf = tspec.load_surface_points(name)
    tspec.save_robot_spec(spec, str(tmp_path / "port"), surf)
    jspec.save_robot_spec(jspec.load_robot_spec(name), str(tmp_path / "jax"),
                          jspec.load_surface_points(name))
    _assert_spec_files_equal(tmp_path / "port", tmp_path / "jax", name)
    # the port's loader reads what it wrote as the asset
    back = tspec.load_robot_spec(name, str(tmp_path / "port"))
    assert [lk.name for lk in back.links] == [lk.name for lk in spec.links]
    for a, b in zip(back.links, spec.links):
        assert a.mass == b.mass
        for f in ("com_pos", "com_rot", "inertia"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert len(a.collisions) == len(b.collisions)
        for ga, gb in zip(a.collisions, b.collisions):
            assert ga.kind == gb.kind
            for f in ("origin_pos", "origin_rot", "size", "points"):
                x, y = getattr(ga, f), getattr(gb, f)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
    assert len(back.joints) == len(spec.joints)
    for a, b in zip(back.joints, spec.joints):
        assert a.mimic == b.mimic
        for f in a.__dataclass_fields__:
            if f != "mimic":
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    got = tspec.load_surface_points(name, str(tmp_path / "port"))
    assert set(got) == set(surf)
    for k in surf:
        np.testing.assert_array_equal(got[k], surf[k])


@pytest.mark.parametrize("name", ["fr3_umi", "xarm6_uf_gripper"])
def test_robot_spec_helpers_match_jax(name):
    got, want = tspec.load_robot_spec(name), jspec.load_robot_spec(name)
    assert got.dof == want.dof
    assert got.link_index() == want.link_index()
    assert [j.name for j in got.movable_joints] == [
        j.name for j in want.movable_joints]


_STL = """solid part
{facets}endsolid part
"""
_URDF = """<?xml version="1.0"?>
<robot name="toy">
  <link name="base">
    <inertial><origin xyz="0 0 0.05"/><mass value="1.5"/>
      <inertia ixx="0.01" ixy="0" ixz="0" iyy="0.02" iyz="0" izz="0.03"/>
    </inertial>
    <collision><origin xyz="0 0 0.02" rpy="0 0 0.3"/>
      <geometry><mesh filename="part.stl" scale="1 1 2"/></geometry>
    </collision>
    <collision><geometry><box size="0.1 0.2 0.05"/></geometry></collision>
  </link>
  <link name="arm">
    <collision><origin xyz="0.1 0 0"/>
      <geometry><cylinder radius="0.03" length="0.2"/></geometry>
    </collision>
  </link>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="arm"/>
    <origin xyz="0 0 0.1" rpy="0.1 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-1.5" upper="1.5" effort="10" velocity="2"/>
  </joint>
</robot>
"""


def _write_toy_robot(src):
    verts, faces = _box_mesh(np.random.default_rng(5))
    facets = "".join(
        "facet normal 0 0 0\n outer loop\n"
        + "".join(f"  vertex {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n"
                  for v in verts[f])
        + " endloop\nendfacet\n" for f in faces)
    os.makedirs(src, exist_ok=True)
    with open(os.path.join(src, "part.stl"), "w") as f:
        f.write(_STL.format(facets=facets))
    path = os.path.join(src, "toy.urdf")
    with open(path, "w") as f:
        f.write(_URDF)
    return path


def test_extract_robot_specs_tool_matches_jax(tmp_path):
    """The extraction (URDF -> support points + surface samples -> spec
    files) of the port's tool against the JAX tool, on a toy robot with a
    mesh and primitive collisions (the shipped robots' sources are not in
    the repository)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import extract_robot_specs as jtool
    finally:
        sys.path.pop(0)
    from gsworld_tpu.physics.urdf import parse_urdf as j_parse_urdf
    from gsworld_tpu_torch.tools import extract_robot_specs as ttool
    urdf = _write_toy_robot(str(tmp_path / "src"))
    spec, surface = ttool.extract(urdf, "toy", str(tmp_path / "port"))
    jspec_ = j_parse_urdf(urdf)
    jspec_.name = "toy"
    jsurf = {lk.name: s for lk in jspec_.links
             if (s := jtool.reduce_link_collisions(lk)) is not None}
    jspec.save_robot_spec(jspec_, str(tmp_path / "jax"), jsurf)
    _assert_spec_files_equal(tmp_path / "port", tmp_path / "jax", "toy")
    back = tspec.load_robot_spec("toy", str(tmp_path / "port"))
    assert [g.kind for g in back.links[0].collisions] == ["points", "box"]
    assert set(tspec.load_surface_points("toy", str(tmp_path / "port"))) \
        == {"base", "arm"}


# ------------------------------------------------------------------ #
# f32 maths: within TOL
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("parts", ["all", "rigid", "scale", "none"])
def test_transform_gaussians_matches_jax(parts):
    rng = np.random.default_rng(11)
    B, N = 2, 64
    means = rng.normal(size=(N, 3)).astype(np.float32) * 0.3
    log_scales = (-4.0 + 0.5 * rng.normal(size=(N, 3))).astype(np.float32)
    quats = _quats(rng, N) * rng.uniform(0.9, 1.1, (N, 1)).astype(np.float32)
    opac = rng.normal(size=N).astype(np.float32)
    R = np.asarray(jm.quat_to_matrix(jnp.asarray(_quats(rng, B))))
    t = rng.normal(size=(B, 3)).astype(np.float32)
    s = rng.uniform(0.8, 1.2, size=B).astype(np.float32)
    kw = dict(all=dict(R=R, t=t, scale=s), rigid=dict(R=R, t=t),
              scale=dict(scale=s), none={})[parts]
    want = jtr.transform_gaussians(
        jnp.asarray(means), jnp.asarray(log_scales), jnp.asarray(quats),
        jnp.asarray(opac), **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tgs.transform_gaussians(
        _t(means), _t(log_scales), _t(quats), _t(opac),
        **{k: _t(v) for k, v in kw.items()})
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def test_identity_slots_match_jax():
    apply = [False, False, True, True]
    want = jtr.identity_slots(4, apply, batch_shape=(2, 3))
    got = tgs.identity_slots(4, apply, batch_shape=(2, 3), device="cpu")
    for f in ("R", "t", "scale", "apply_scale"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def _scaled_rigid(rng, n):
    R = np.asarray(jm.quat_to_matrix(jnp.asarray(_quats(rng, n))))
    M = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    M[:, :3, :3] = R * rng.uniform(0.5, 2.0, (n, 1, 1))
    M[:, :3, 3] = rng.normal(size=(n, 3))
    return M.astype(np.float32)


def test_extract_rigid_transform_matches_jax():
    rng = np.random.default_rng(2)
    calib = np.stack([np.asarray(v, np.float32) for v in (
        jconst.sim2gs_arm_trans, jconst.sim2gs_xarm_trans,
        jconst.sim2gs_mustard_trans)])
    M = np.concatenate([_scaled_rigid(rng, 6), calib])
    want = jm.extract_rigid_transform(jnp.asarray(M))
    got = tm.extract_rigid_transform(_t(M))
    for g, w in zip(got, want):
        _close(g, w)
    # the analytic form agrees with the SVD form on these matrices
    for g, w in zip(tm.extract_rigid_transform_fast(_t(M)), got):
        _close(g, w, 1e-4)


def test_tf_apply_and_quat_inverse_match_jax():
    rng = np.random.default_rng(4)
    T = _scaled_rigid(rng, 5)
    p = rng.normal(size=(5, 7, 3)).astype(np.float32)
    _close(tm.tf_apply(_t(T)[:, None], _t(p)),
           jm.tf_apply(jnp.asarray(T)[:, None], jnp.asarray(p)))
    q = _quats(rng, 9) * rng.uniform(0.5, 2.0, (9, 1)).astype(np.float32)
    _close(tm.quat_inverse(_t(q)), jm.quat_inverse(jnp.asarray(q)))
    # q^-1 q is the identity rotation
    ident = tm.quat_multiply(tm.quat_inverse(_t(q)), _t(q))
    _close(ident, np.tile([1.0, 0, 0, 0], (9, 1)))


def test_slot_of_matches_jax():
    rng = np.random.default_rng(0)
    sem = rng.integers(-1, 4, size=200)
    gs_sem = {"l0": 0, "l1": [1, 2]}
    args = (sem, gs_sem, ["l0", "l1", "l2"], {"can": 3})
    _, jl = j_build_slot_ids(*args)
    _, tl = build_slot_ids(*args)
    for name in ("", "l0", "l1", "l2", "can"):
        assert tl.slot_of(name) == jl.slot_of(name)
    with pytest.raises(ValueError):
        tl.slot_of("nope")


# ------------------------------------------------------------------ #
# render_uint8
# ------------------------------------------------------------------ #

def test_render_uint8_matches_jax():
    s = jsyn.make_blob(np.random.default_rng(1), 400, [0, 0, 0], 0.5,
                       [0.6, 0.4, 0.3], 0, log_scale_mean=-3.0)
    kw = dict(width=64, height=48, max_entries=4096)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.0
    sh0, shN = s["sh0"].reshape(-1, 3), s["shN"].reshape(-1, 45)
    fields = (s["means"], s["scales"], s["quats"], s["opacities"].ravel())
    want = np.asarray(j_render_uint8(
        jtr.PosedGaussians(*map(jnp.asarray, fields)),
        j_make_camera(w2c, 0.5, 0.5), JCfg(max_per_tile=512, tile_chunk=4,
                                           **kw),
        jnp.asarray(sh0), jnp.asarray(shN)))
    got = trender.render_uint8(
        tgs.PosedGaussians(*map(_t, fields)),
        trender.make_camera(_t(w2c), 0.5, 0.5), trender.RasterConfig(**kw),
        _t(sh0), _t(shN)).numpy()
    assert got.shape == want.shape == (48, 64, 3) and got.dtype == np.uint8
    assert got.std() > 5.0, "constant image"
    mse = np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    assert psnr >= PSNR_MIN, f"PSNR {psnr:.1f} dB"


def test_package_exports_follow_jax():
    """gs/ and render/ export JAX's names wherever the port has them;
    JAX's dense-path binning and compositor names are A11's (not
    ported)."""
    import gsworld_tpu.gs as jgs
    import gsworld_tpu.render as jrender
    skip = {"TileBins", "bin_gaussians", "composite_tiles"}
    for jmod, tmod in ((jgs, tgs), (jrender, trender)):
        names = {n for n in dir(jmod) if not n.startswith("_")
                 and not isinstance(getattr(jmod, n), type(json))}
        missing = sorted(names - set(dir(tmod)) - skip)
        assert not missing, missing
