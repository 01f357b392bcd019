"""Parity of the port's real2sim toolchain with the JAX package on the
CPU: COLMAP text I/O and cameras_from_colmap, ArUco metric scaling,
Umeyama + ICP, label transfer, parse_urdf, the robot point cloud, and
run_sfm / reconstruct_scene driven through a stub ``colmap`` executable.

Inputs are made with numpy from a seed and fed to both packages.  The
port's reconstruction runs in a subprocess with JAX blocked, as the
card's machine has no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsworld_tpu.physics import kinematics as jkin
from gsworld_tpu.physics import urdf as jurdf
from gsworld_tpu.real2sim import alignment as jalign
from gsworld_tpu.real2sim import aruco_scale as jaruco
from gsworld_tpu.real2sim import colmap_io as jcolmap
from gsworld_tpu.real2sim import label_transfer as jlabel
from gsworld_tpu.real2sim import pipeline as jpipeline
from gsworld_tpu.real2sim import urdf_pcd as jpcd
from gsworld_tpu.render import camera as jcamera
from gsworld_tpu_torch.physics import kinematics as kin
from gsworld_tpu_torch.physics import urdf
from gsworld_tpu_torch.real2sim import (alignment, aruco_scale, colmap_io,
                                        label_transfer, pipeline, sfm,
                                        urdf_pcd)
from gsworld_tpu_torch.render import camera

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the packages' host code is the same numpy in the same order
EXACT = 1e-12
# f32 FK and camera tensors computed in another operation order
F32_TOL = 1e-6


def _look_at_c2w(eye, target):
    """tests/test_real2sim.py's look-at camera (x right, y down, z on)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
    c2w[:3, 3] = eye
    return c2w


def _qvec(R):
    return kin._np_mat_to_quat(R)


def _project(w2c, K, pts):
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    px = cam @ K.T
    return px[:, :2] / px[:, 2:3]


EYES = [[1, 0, 2], [-1, 0.5, 2.2], [0.3, -1, 1.8], [0.8, 0.9, 2.5]]
K0 = np.array([[600.0, 0, 320], [0, 610, 240], [0, 0, 1]])


def _model(mod, world_scale=1.0, n_points=40, seed=20):
    """A text model in ``mod``'s dataclasses: three camera models, one
    image per eye (each with observations), coloured points; the world
    scaled by ``world_scale``."""
    rng = np.random.default_rng(seed)
    cams = {1: mod.ColmapCamera(1, "PINHOLE", 640, 480,
                                np.array([600.0, 610, 320, 240])),
            2: mod.ColmapCamera(2, "SIMPLE_RADIAL", 320, 240,
                                np.array([300.0, 160, 120, 0.01])),
            3: mod.ColmapCamera(3, "OPENCV", 640, 480, np.array(
                [590.0, 595, 321, 239, 0.1, -0.01, 0, 0]))}
    pts = rng.uniform(-0.3, 0.3, (n_points, 3)) * world_scale
    images = {}
    for i, eye in enumerate(EYES):
        w2c = np.linalg.inv(_look_at_c2w(np.asarray(eye) * world_scale,
                                         [0, 0, 0]))
        cid = 1 + i % 3
        K = cams[cid].K
        ids = rng.choice(n_points, 6, replace=False)
        images[i + 1] = mod.ColmapImage(
            i + 1, _qvec(w2c[:3, :3]), w2c[:3, 3], cid, f"im_{i}.png",
            _project(w2c, K, pts[ids]), ids.astype(np.int64))
    rgb = rng.integers(0, 256, (n_points, 3)).astype(np.uint8)
    return cams, images, (np.arange(n_points) + 1, pts, rgb)


def _read(mod, d):
    return (mod.read_cameras_txt(os.path.join(d, "cameras.txt")),
            mod.read_images_txt(os.path.join(d, "images.txt")),
            mod.read_points3d_txt(os.path.join(d, "points3D.txt")))


def _same_model(a, b):
    (ca, ia, pa), (cb, ib, pb) = a, b
    assert list(ca) == list(cb) and list(ia) == list(ib)
    for k in ca:
        assert (ca[k].model, ca[k].width, ca[k].height) == \
            (cb[k].model, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
        np.testing.assert_array_equal(ca[k].K, cb[k].K)
    for k in ia:
        assert (ia[k].name, ia[k].camera_id) == (ib[k].name, ib[k].camera_id)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(ia[k], f),
                                          getattr(ib[k], f), err_msg=f)
        np.testing.assert_array_equal(ia[k].w2c(), ib[k].w2c())
        np.testing.assert_array_equal(ia[k].c2w(), ib[k].c2w())
    for x, y in zip(pa, pb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- COLMAP


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_text_io_matches_jax(tmp_path, writer):
    """A model written by one package reads the same in both, and both
    writers write the same bytes."""
    w, o = (colmap_io, jcolmap) if writer == "port" else (jcolmap, colmap_io)
    w.write_model_txt(str(tmp_path / "a"), *_model(w))
    o.write_model_txt(str(tmp_path / "b"), *_model(o))
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "a" / f).read_bytes() == \
            (tmp_path / "b" / f).read_bytes(), f
    _same_model(_read(colmap_io, str(tmp_path / "a")),
                _read(jcolmap, str(tmp_path / "a")))


@pytest.mark.parametrize("size", [(640, 480), (320, 200)])
def test_cameras_from_colmap_matches_jax(tmp_path, size):
    colmap_io.write_model_txt(str(tmp_path), *_model(colmap_io))
    cams, names = pipeline.cameras_from_colmap(
        *_read(colmap_io, str(tmp_path))[:2], *size, device="cpu")
    jcams, jnames = jpipeline.cameras_from_colmap(
        *_read(jcolmap, str(tmp_path))[:2], *size)
    assert names == jnames == [f"im_{i}.png" for i in range(len(EYES))]
    for c, j in zip(cams, jcams):
        for f in ("world_view", "cam_center", "tanfovx", "tanfovy"):
            np.testing.assert_allclose(getattr(c, f).numpy(),
                                       np.asarray(getattr(j, f)),
                                       atol=F32_TOL, err_msg=f)
        proj = camera.projection_matrix(c.tanfovx, c.tanfovy) @ c.world_view
        jproj = jcamera.projection_matrix(j.tanfovx, j.tanfovy) @ j.world_view
        np.testing.assert_allclose(proj.numpy(), np.asarray(jproj),
                                   atol=F32_TOL)


# --------------------------------------------------------------- ArUco


def test_aruco_synthetic_marker_matches_jax():
    """tests/test_real2sim.py's marker in a world 3.7x too large, through
    both packages: rays, corners and the scale."""
    world_scale, marker_m = 3.7, 0.1
    c = marker_m * world_scale / 2
    corners_w = np.array([[-c, -c, 0], [c, -c, 0], [c, c, 0], [-c, c, 0]])
    out = {}
    for name, mod in (("port", aruco_scale), ("jax", jaruco)):
        origins, rays = [], []
        for eye in EYES:
            c2w = _look_at_c2w(np.asarray(eye) * world_scale, [0, 0, 0])
            o, r = mod.ray_cast_corners(
                c2w, K0, _project(np.linalg.inv(c2w), K0, corners_w))
            origins.append(o)
            rays.append(r)
        corners = mod.corners_3d_from_tracks(np.asarray(origins),
                                             np.asarray(rays))
        out[name] = (np.asarray(rays), corners,
                     mod.scale_from_corners(corners, marker_m))
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=EXACT)
    np.testing.assert_allclose(out["port"][1], corners_w, atol=1e-6)
    assert out["port"][2] == pytest.approx(1 / world_scale, rel=1e-6)


def test_aruco_scale_factor_run_and_apply_match_jax(tmp_path):
    world_scale, marker = 2.5, 0.1
    h = marker * world_scale / 2
    corners_w = np.array([[-h, -h, 0.01], [h, -h, 0.01], [h, h, 0.01],
                          [-h, h, 0.01]])
    cams, images, pts = _model(colmap_io, world_scale)
    colmap_io.write_model_txt(str(tmp_path / "sparse"), cams, images, pts)
    tracks = {im.name: _project(im.w2c(), cams[im.camera_id].K, corners_w)
              for im in images.values()}
    res = {}
    for name, mod in (("port", aruco_scale), ("jax", jaruco)):
        asf = mod.ArucoScaleFactor(str(tmp_path / "sparse"),
                                   aruco_size=marker)
        res[name] = asf.run(tracks)
        asf.apply(res[name], str(tmp_path / name))
    assert res["port"].n_detections == res["jax"].n_detections == len(EYES)
    assert abs(res["port"].scale - res["jax"].scale) <= EXACT
    assert res["port"].scale == pytest.approx(1 / world_scale, rel=1e-6)
    np.testing.assert_allclose(res["port"].corners3d, res["jax"].corners3d,
                               rtol=0, atol=EXACT)
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    _, _, (_, xyz, _) = _read(colmap_io, str(tmp_path / "port"))
    np.testing.assert_allclose(xyz, pts[1] / world_scale, atol=1e-9)


def test_aruco_detection_needs_cv2_and_pil(tmp_path, monkeypatch):
    colmap_io.write_model_txt(str(tmp_path / "sparse"), *_model(colmap_io))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        aruco_scale.detect_aruco_corners_cv2(np.zeros((8, 8), np.uint8))
    monkeypatch.setitem(sys.modules, "PIL", None)
    asf = aruco_scale.ArucoScaleFactor(str(tmp_path / "sparse"))
    with pytest.raises(ImportError, match="PIL"):
        asf.collect_tracks(num_procs=1)


# ------------------------------------------- alignment, label transfer


def _similarity(ang, s, t):
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = s * R, t
    return T


def test_umeyama_and_icp_match_jax():
    rng = np.random.default_rng(1)
    cloud = rng.uniform(-0.3, 0.3, size=(500, 3))
    T_true = _similarity(0.3, 0.93, [0.05, 0.1, -0.02])
    dst = (cloud @ T_true[:3, :3].T + T_true[:3, 3]
           + rng.normal(scale=2e-3, size=cloud.shape))
    np.testing.assert_allclose(alignment.umeyama(cloud[:9], dst[:9]),
                               jalign.umeyama(cloud[:9], dst[:9]),
                               rtol=0, atol=EXACT)
    np.testing.assert_allclose(
        alignment.umeyama(cloud, dst, with_scaling=False),
        jalign.umeyama(cloud, dst, with_scaling=False), rtol=0, atol=EXACT)
    T0 = np.eye(4)
    T0[:3, :3], T0[:3, 3] = 0.9 * np.eye(3), T_true[:3, 3] + 0.01
    T, rmse = alignment.icp_point_to_point(cloud, dst, init=T0,
                                           threshold=0.2)
    jT, jrmse = jalign.icp_point_to_point(cloud, dst, init=T0,
                                          threshold=0.2)
    np.testing.assert_allclose(T, jT, rtol=0, atol=EXACT)
    assert abs(rmse - jrmse) <= EXACT and rmse < 5e-3
    picks = rng.choice(len(cloud), 6, replace=False)
    np.testing.assert_allclose(
        alignment.align_from_correspondences(cloud[picks], dst[picks],
                                             cloud, dst),
        jalign.align_from_correspondences(cloud[picks], dst[picks],
                                          cloud, dst), rtol=0, atol=EXACT)


def test_segment_real_gs_matches_jax():
    """Labels from the 1-NN point, its own box, the fallback to the
    closest box within the threshold, and -1 beyond it."""
    rng = np.random.default_rng(2)
    centres = np.array([[0, 0, 0], [0.5, 0, 0], [0.25, 0.3, 0.1]])
    src = np.concatenate([rng.normal(size=(200, 3)) * 0.02 + c
                          for c in centres])
    labels = np.repeat(np.array([3, 7, 12], np.int32), 200)
    labels[:5] = -1                       # a few unlabelled sim points
    sim2gs = _similarity(0.4, 0.95, [0.1, 0.2, 0.3])
    tgt_sim = np.concatenate([
        rng.normal(size=(60, 3)) * 0.05 + centres[k % 3] for k in range(4)]
        + [rng.uniform(-1, 2, (80, 3))])
    tgt_gs = tgt_sim @ sim2gs[:3, :3].T + sim2gs[:3, 3]
    for thr, margin in ((0.1, 0.02), (0.03, 0.0)):
        got = label_transfer.segment_real_gs(tgt_gs, src, labels, sim2gs,
                                             thr, margin)
        want = jlabel.segment_real_gs(tgt_gs, src, labels, sim2gs, thr,
                                      margin)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=EXACT)
        assert {-1, 3, 7, 12} <= set(got[0].tolist())
    bb = label_transfer.compute_semantic_bboxes(src, labels, 0.01)
    jbb = jlabel.compute_semantic_bboxes(src, labels, 0.01)
    assert list(bb) == list(jbb) == [3, 7, 12]
    for k in bb:
        np.testing.assert_array_equal(np.stack(bb[k]), np.stack(jbb[k]))


# ----------------------------------------------------------------- URDF

URDF = """<?xml version="1.0"?>
<robot name="toy">
  <link name="base">
    <inertial><origin xyz="0 0 0.05" rpy="0.1 0 0"/><mass value="2.0"/>
      <inertia ixx="0.1" iyy="0.2" izz="0.3" ixy="0.01" ixz="0" iyz="0.02"/>
    </inertial>
    <visual><origin xyz="0 0 0.1" rpy="0.1 0.2 0.3"/>
      <geometry><box size="0.2 0.3 0.1"/></geometry></visual>
    <collision><geometry><cylinder radius="0.05" length="0.2"/></geometry>
    </collision>
  </link>
  <link name="l1">
    <visual><geometry>
      <mesh filename="package://meshes/l1.stl" scale="0.001 0.001 0.001"/>
    </geometry></visual>
    <collision><origin xyz="0.01 0 0"/>
      <geometry><sphere radius="0.04"/></geometry></collision>
    <collision><geometry><capsule radius="0.02" length="0.1"/></geometry>
    </collision>
  </link>
  <link name="l2"/><link name="l3"/><link name="tool"/>
  <link name="finger_a"/><link name="finger_b"/>
  <joint name="j1" type="revolute"><parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0.2" rpy="0 0 0.5"/><axis xyz="0 0 1"/>
    <limit lower="-2.5" upper="2.5" effort="80" velocity="2"/>
    <dynamics damping="0.5" friction="0.1"/></joint>
  <joint name="j2" type="continuous"><parent link="l1"/><child link="l2"/>
    <origin xyz="0.1 0 0.3" rpy="1.5707963 0 0"/><axis xyz="0 1 1"/></joint>
  <joint name="j3" type="prismatic"><parent link="l2"/><child link="l3"/>
    <origin xyz="0 0.2 0" rpy="0.3 -0.2 0.1"/><axis xyz="1 0 0"/>
    <limit lower="0" upper="0.3" effort="100" velocity="0.5"/></joint>
  <joint name="jt" type="fixed"><parent link="l3"/><child link="tool"/>
    <origin xyz="0 0 0.1"/></joint>
  <joint name="fa" type="prismatic"><parent link="tool"/>
    <child link="finger_a"/><origin xyz="0 0.02 0.05"/><axis xyz="0 1 0"/>
    <limit lower="0" upper="0.04" effort="20" velocity="0.2"/></joint>
  <joint name="fb" type="prismatic"><parent link="tool"/>
    <child link="finger_b"/><origin xyz="0 -0.02 0.05"/><axis xyz="0 -1 0"/>
    <limit lower="0" upper="0.04"/>
    <mimic joint="fa" multiplier="1.5" offset="0.01"/></joint>
</robot>
"""


def _same_fields(a, b, names):
    for f in names:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_allclose(x, y, rtol=0, atol=EXACT, err_msg=f)
        else:
            assert x == y, (f, x, y)


def test_parse_urdf_matches_jax(tmp_path):
    path = tmp_path / "robot" / "toy.urdf"
    path.parent.mkdir()
    path.write_text(URDF)
    spec, jspec = urdf.parse_urdf(str(path)), jurdf.parse_urdf(str(path))
    assert spec.name == jspec.name == "toy"
    assert spec.link_names == [l.name for l in jspec.links]
    for l, jl in zip(spec.links, jspec.links):
        _same_fields(l, jl, ("name", "mass", "com_pos", "com_rot", "inertia"))
        for geoms, jgeoms in ((l.collisions, jl.collisions),
                              (l.visuals, jl.visuals)):
            assert len(geoms) == len(jgeoms)
            for g, jg in zip(geoms, jgeoms):
                _same_fields(g, jg, ("kind", "origin_pos", "origin_rot",
                                     "size", "mesh_path", "mesh_scale"))
    kinds = {g.kind for l in spec.links for g in l.collisions + l.visuals}
    assert kinds == {"box", "cylinder", "sphere", "mesh", "capsule"}
    assert spec.links[1].visuals[0].mesh_path == str(
        tmp_path / "robot" / "meshes" / "l1.stl")
    assert [j.name for j in spec.joints] == [j.name for j in jspec.joints]
    for j, jj in zip(spec.joints, jspec.joints):
        _same_fields(j, jj, ("name", "jtype", "parent", "child", "origin_pos",
                             "origin_rot", "axis", "limit_lower",
                             "limit_upper", "effort", "velocity", "damping",
                             "friction"))
        assert (j.mimic is None) == (jj.mimic is None)
        if j.mimic is not None:
            _same_fields(j.mimic, jj.mimic, ("joint", "multiplier", "offset"))
    assert spec.joints[-1].mimic.multiplier == 1.5

    model, jmodel = kin.build_articulation(spec), \
        jkin.build_articulation(jspec)
    assert model.link_names == tuple(jmodel.link_names)
    assert model.dof == jmodel.dof == 5
    q = np.random.default_rng(3).uniform(-1, 1, (6, 5)).astype(np.float32)
    pos, quat = kin.forward_kinematics(model, torch.as_tensor(q))
    jpos, jquat = jkin.forward_kinematics(jmodel, jnp.asarray(q))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=F32_TOL)
    np.testing.assert_allclose(quat.numpy(), np.asarray(jquat),
                               atol=F32_TOL)


def test_parse_urdf_refuses_unknown_joints(tmp_path):
    path = tmp_path / "bad.urdf"
    path.write_text(URDF.replace('type="fixed"', 'type="floating"'))
    for mod in (urdf, jurdf):
        with pytest.raises(ValueError, match="floating"):
            mod.parse_urdf(str(path))


# ------------------------------------------------------ robot point cloud


@pytest.mark.parametrize("uid", ["fr3_umi", "xarm6_uf_gripper"])
def test_robot_pcd_matches_jax(tmp_path, uid):
    pts, lab = urdf_pcd.sample_robot_pcd(uid, 3000, seed=4)
    jpts, jlab = jpcd.sample_robot_pcd(uid, 3000, seed=4)
    np.testing.assert_array_equal(lab, jlab)
    np.testing.assert_allclose(pts, jpts, atol=F32_TOL)
    path = urdf_pcd.export_robot_pcd(uid, str(tmp_path / "port"), 2000)
    jpath = jpcd.export_robot_pcd(uid, str(tmp_path / "jax"), 2000)
    assert os.path.basename(path) == os.path.basename(jpath)
    npy = f"{uid}_semantics.npy"
    assert (tmp_path / "port" / npy).read_bytes() == \
        (tmp_path / "jax" / npy).read_bytes()
    assert open(path, "rb").read() == open(jpath, "rb").read()


# ------------------------------------------------- SfM and reconstruction


def test_sfm_without_colmap(tmp_path, monkeypatch):
    """No colmap on PATH: the port raises the JAX package's "not found"
    error; JAX's reconstruct_scene raises TypeError first, passing
    run_sfm a colmap_command it does not take (ROADMAP C14)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="colmap binary not found"):
        sfm.run_sfm(str(tmp_path / "images"), str(tmp_path / "ws"))
    with pytest.raises(FileNotFoundError, match="colmap binary not found"):
        pipeline.reconstruct_scene(str(tmp_path), str(tmp_path / "out"),
                                   iterations=1, device="cpu")
    with pytest.raises(TypeError, match="colmap_command"):
        jpipeline.reconstruct_scene(str(tmp_path), str(tmp_path / "out"),
                                    iterations=1)


STUB = '''#!{python}
"""Stand-in for the colmap CLI: logs each command; the mapper makes
sparse/0, model_converter copies a prepared text model."""
import os, shutil, sys
here = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(here, "calls.log"), "a") as f:
    f.write(sys.argv[1] + "\\n")
arg = dict(zip(sys.argv[2::2], sys.argv[3::2]))
if sys.argv[1] == "feature_extractor":
    open(arg["--database_path"], "w").close()
elif sys.argv[1] == "mapper":
    os.makedirs(os.path.join(arg["--output_path"], "0"), exist_ok=True)
elif sys.argv[1] == "model_converter":
    assert os.path.isdir(arg["--input_path"])
    for f in os.listdir(os.path.join(here, "model")):
        shutil.copy(os.path.join(here, "model", f), arg["--output_path"])
'''

RECONSTRUCT = """
import json, os, sys
sys.modules["jax"] = None
import numpy as np
from gsworld_tpu_torch.gs.ply import load_ply_to_splats
from gsworld_tpu_torch.real2sim.pipeline import reconstruct_scene
for case in sys.argv[1:]:
    data, out, skip = case.split("|")
    res = reconstruct_scene(
        data, out, iterations=2, width=32, height=24, aruco_size=None,
        skip_sfm=skip == "1", export_ply=os.path.join(out, "assets",
                                                      "scan.ply"),
        scene_config=os.path.join(out, "configs", "scan.json"),
        log_every=1, device="cpu")
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    splats = load_ply_to_splats(res.ply_path)
    assert len(splats["means"]) == res.scene.num_gaussians > 0
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_2",
                                       "point_cloud.ply"))
    cfg = json.load(open(res.config_path))
    assert cfg["models"][0]["data_path"] == "scan.ply"
    print("OK", skip)
bad = [m for m in sys.modules
       if m == "gsworld_tpu" or m.startswith("gsworld_tpu.")]
assert not bad, bad
"""


def _reconstruction_inputs(data, model):
    """PNG images at 64x48 in ``data``/images and a PINHOLE text model of
    them in ``model``."""
    import imageio.v3 as iio
    rng = np.random.default_rng(5)
    (data / "images").mkdir(parents=True)
    cams = {1: colmap_io.ColmapCamera(1, "PINHOLE", 64, 48,
                                      np.array([60.0, 60, 32, 24]))}
    pts = rng.uniform(-0.3, 0.3, (60, 3))
    images = {}
    for i, eye in enumerate(EYES[:3]):
        w2c = np.linalg.inv(_look_at_c2w(eye, [0, 0, 0]))
        images[i + 1] = colmap_io.ColmapImage(
            i + 1, _qvec(w2c[:3, :3]), w2c[:3, 3], 1, f"im_{i}.png",
            _project(w2c, cams[1].K, pts[:4]), np.arange(4))
        iio.imwrite(data / "images" / f"im_{i}.png",
                    rng.integers(0, 256, (48, 64, 3)).astype(np.uint8))
    colmap_io.write_model_txt(str(model), cams, images, (
        np.arange(60), pts, rng.integers(0, 256, (60, 3)).astype(np.uint8)))


@pytest.fixture(scope="module")
def reconstructions(tmp_path_factory):
    """Both reconstructions in one subprocess with JAX blocked: through a
    stub colmap on PATH (its text model served by model_converter), and
    from sparse/0 with skip_sfm -> (root, stdout)."""
    root = tmp_path_factory.mktemp("reconstruct")
    _reconstruction_inputs(root / "data0", root / "bin" / "model")
    _reconstruction_inputs(root / "data1", root / "data1" / "sparse" / "0")
    stub = root / "bin" / "colmap"
    stub.write_text(STUB.format(python=sys.executable))
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{stub.parent}:{os.environ['PATH']}")
    cases = [f"{root / f'data{k}'}|{root / f'out{k}'}|{k}" for k in (0, 1)]
    proc = subprocess.run([sys.executable, "-c", RECONSTRUCT, *cases],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return root, proc.stdout


@pytest.mark.parametrize("skip_sfm", [False, True])
def test_reconstruct_scene_without_jax(reconstructions, skip_sfm):
    """reconstruct_scene end to end on the CPU with JAX blocked: through
    the four colmap commands and the text model run_sfm returns, or from
    sparse/0 with skip_sfm; images resized from 64x48 to 32x24, a PLY and
    a scene config written."""
    root, out = reconstructions
    assert f"OK {int(skip_sfm)}" in out.split("\n")
    assert out.count("iter 2: loss=") == 2
    # only the SfM case ran colmap, each command once
    assert (root / "bin" / "calls.log").read_text().split() == [
        "feature_extractor", "exhaustive_matcher", "mapper",
        "model_converter"]
    data = root / f"data{int(skip_sfm)}"
    assert (root / f"out{int(skip_sfm)}" / "assets" / "scan.ply").exists()
    if not skip_sfm:
        # the model is where run_sfm wrote it, not in sparse/0 (C15)
        assert (data / "sparse_txt" / "images.txt").exists()
        assert not (data / "sparse" / "0" / "images.txt").exists()


def test_new_entry_points_default_to_the_card():
    import inspect
    from gsworld_tpu_torch.gs.merge import merge_scene_from_config
    from gsworld_tpu_torch.train3dgs.densify import init_densify_state
    for fn in (pipeline.cameras_from_colmap, pipeline.reconstruct_scene,
               merge_scene_from_config, init_densify_state):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn.__name__
