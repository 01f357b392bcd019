"""Parity of the port's real-scan scene code with the JAX package on the
CPU: PLY I/O (gs/ply.py), concatenate_scenes, merge_scene_from_config
(gs/merge.py), get_scene's merge branch and its fallback, and the
wrapper on a merged scan.

Scans are tiny PLYs written here from splats made with numpy from a
seed; both packages read and merge the same files.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gsworld_tpu.envs.agents.base import get_agent as j_get_agent
import gsworld_tpu.envs.agents.fr3_umi  # noqa: F401  (registers agents)
from gsworld_tpu.gs import merge as jmerge
from gsworld_tpu.gs import ply as jply
from gsworld_tpu.gs.model import concatenate_scenes as j_concatenate
from gsworld_tpu.gs.model import scene_from_splats as j_scene_from_splats
from gsworld_tpu.gs.scene_factory import get_scene as j_get_scene
from gsworld_tpu_torch.envs.tasks.tabletop.franka.align import AlignFr3Env
from gsworld_tpu_torch.gs import merge, ply, synthetic
from gsworld_tpu_torch.gs.model import (SCENE_FIELDS, concatenate_scenes,
                                        scene_from_splats)
from gsworld_tpu_torch.gs.scene_factory import get_scene

# f32 FK places the synthetic link Gaussians (tests/test_torch_gs.py)
FK_TOL = 1e-5


def _splats(seed, n=120, label=3):
    """A blob of ``n`` Gaussians with every field random (non-zero shN)."""
    rng = np.random.default_rng(seed)
    return synthetic.make_blob(rng, n, [0.1, -0.2, 0.3], 0.2,
                               [0.6, 0.4, 0.3], label)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint8)


def _same_columns(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)


def _same_scene(port, jax_scene):
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(jax_scene, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def blob():
    s = _splats(0)
    s["semantics"] = np.random.default_rng(1).integers(-1, 16, len(
        s["means"])).astype(np.int32)
    return s


# ---------------------------------------------------------------- PLY


@pytest.mark.parametrize("with_semantics", [True, False])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_written_by_one_reads_bit_for_bit_in_the_other(
        tmp_path, blob, writer, with_semantics):
    path = str(tmp_path / "scan.ply")
    write = ply.save_splats_to_ply if writer == "port" \
        else jply.save_splats_to_ply
    write(blob, path, with_semantics=with_semantics)
    other = str(tmp_path / "other.ply")
    (jply if writer == "port" else ply).save_splats_to_ply(
        blob, other, with_semantics=with_semantics)
    assert open(path, "rb").read() == open(other, "rb").read()
    _same_columns(ply.read_ply_vertex(path), jply.read_ply_vertex(path))
    got, want = ply.load_ply_to_splats(path), jply.load_ply_to_splats(path)
    _same_columns(got, want)
    assert got["semantics"].dtype == np.int32
    if with_semantics:
        np.testing.assert_array_equal(got["semantics"], blob["semantics"])
    else:
        assert (got["semantics"] == 0).all()
    for k in ("means", "sh0", "shN", "scales", "quats", "opacities"):
        np.testing.assert_array_equal(got[k], np.asarray(blob[k]).reshape(
            got[k].shape), err_msg=k)


def test_ascii_ply_and_other_types(tmp_path):
    """ASCII PLYs with double, uchar and int properties, f_rest columns in
    a shuffled order (read back sorted by number)."""
    rng = np.random.default_rng(2)
    n = 7
    names = (["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2", "opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    rest = [f"f_rest_{i}" for i in rng.permutation(45)]
    vals = rng.normal(size=(n, len(names) + len(rest)))
    labels = rng.integers(0, 200, n)
    header = ["ply", "format ascii 1.0", "comment scan", f"element vertex {n}"]
    header += [f"property double {c}" if c == "x" else f"property float {c}"
               for c in names + rest]
    header += ["property uchar semantics", "element face 0",
               "property list uchar int vertex_indices", "end_header"]
    rows = [" ".join(f"{v:.9g}" for v in r) + f" {lab}"
            for r, lab in zip(vals, labels)]
    path = tmp_path / "ascii.ply"
    path.write_text("\n".join(header + rows) + "\n")
    _same_columns(ply.read_ply_vertex(str(path)),
                  jply.read_ply_vertex(str(path)))
    got = ply.load_ply_to_splats(str(path))
    _same_columns(got, jply.load_ply_to_splats(str(path)))
    np.testing.assert_array_equal(got["semantics"], labels)
    col = {c: i for i, c in enumerate(names + rest)}
    np.testing.assert_array_equal(
        got["shN"].reshape(n, 45)[:, 7],
        vals[:, col["f_rest_7"]].astype(np.float32))


@pytest.mark.parametrize("body, error", [
    ("property list uchar int vertex_indices", "list properties"),
    ("property float x", "unsupported PLY format"),
])
def test_ply_refusals_match_jax(tmp_path, body, error):
    fmt = "binary_big_endian" if "float" in body else "ascii"
    path = tmp_path / "bad.ply"
    path.write_text(f"ply\nformat {fmt} 1.0\nelement vertex 1\n{body}\n"
                    "end_header\n")
    for mod in (ply, jply):
        with pytest.raises(ValueError, match=error):
            mod.read_ply_vertex(str(path))


# ------------------------------------------------------ merge and concat


def test_concatenate_scenes_matches_jax(blob):
    parts = [_splats(s, n) for s, n in ((3, 50), (4, 20), (5, 33))]
    ids = [np.arange(len(p["means"]), dtype=np.int32) % 4 for p in parts]
    port = concatenate_scenes([scene_from_splats(p, i, device="cpu")
                               for p, i in zip(parts, ids)])
    _same_scene(port, j_concatenate([j_scene_from_splats(p, i)
                                     for p, i in zip(parts, ids)]))


def _write_scans(root):
    """A robot scan with per-Gaussian labels in an .npy, one with its
    labels in the PLY, two objects with scalar labels (one PLY without a
    semantics column) and a config naming them, in the reference schema;
    paths relative to ``root`` / "assets" and one absolute."""
    assets = root / "assets"
    robot = _splats(10, 200, -1)
    robot["semantics"] = np.random.default_rng(11).choice(
        [-1, 0, 2, 10, 14, 15], 200).astype(np.int32)
    arm = _splats(12, 60, 5)
    ply.save_splats_to_ply(robot, str(assets / "scene" / "fr3.ply"),
                           with_semantics=False)
    np.save(str(assets / "scene" / "fr3_semantics_gs.npy"),
            robot["semantics"])
    ply.save_splats_to_ply(arm, str(assets / "scene" / "arm.ply"))
    ply.save_splats_to_ply(_splats(13, 40, 0), str(assets / "objs" / "g.ply"),
                           with_semantics=False)
    ply.save_splats_to_ply(_splats(14, 30, 7), str(root / "rack.ply"))
    cfg = {"models": [
        {"data_path": "./scene/fr3.ply",
         "semantic_labels": "./scene/fr3_semantics_gs.npy",
         "transformation": []},
        {"data_path": "./scene/arm.ply", "transformation": []},
        {"data_path": "./objs/g.ply", "semantic_labels": 201,
         "transformation": []},
        {"data_path": str(root / "rack.ply"), "semantic_labels": 109.0,
         "transformation": []},
    ]}
    (root / "configs").mkdir()
    (root / "configs" / "fr3_test.json").write_text(json.dumps(cfg))
    return str(assets), str(root / "configs")


@pytest.mark.parametrize("object_labels", [
    None, {"dtc_green_can_fr3": 201, "spice_rack": 109}])
def test_merge_scene_from_config_matches_jax(tmp_path, object_labels):
    asset_dir, cfg_dir = _write_scans(tmp_path)
    links = ["base", "fr3_link1", "fr3_link4", "fr3_hand"]
    kw = dict(link_names=links, object_labels=object_labels,
              asset_dir=asset_dir, cfg_dir=cfg_dir)
    scene, layout = merge.merge_scene_from_config("fr3_test", **kw,
                                                  device="cpu")
    j_scene, j_layout = jmerge.merge_scene_from_config("fr3_test", **kw)
    _same_scene(scene, j_scene)
    assert dataclasses.asdict(layout) == dataclasses.asdict(j_layout)
    if object_labels is None:     # the first name of each label
        assert set(layout.object_slots) == {"dtc_green_can", "spice_rack"}
    assert scene.num_gaussians == 200 + 60 + 40 + 30
    # a path to the JSON resolves as the bare name does
    again, _ = merge.merge_scene_from_config(
        f"{cfg_dir}/fr3_test.json", **dict(kw, cfg_dir=None), device="cpu")
    _same_scene(again, j_scene)


def test_merge_refuses_a_wrong_label_count(tmp_path):
    asset_dir, cfg_dir = _write_scans(tmp_path)
    np.save(f"{asset_dir}/scene/fr3_semantics_gs.npy",
            np.zeros(199, np.int32))
    for mod, kw in ((merge, dict(device="cpu")), (jmerge, {})):
        with pytest.raises(ValueError, match="199 labels for 200"):
            mod.merge_scene_from_config("fr3_test", asset_dir=asset_dir,
                                        cfg_dir=cfg_dir, **kw)


# ------------------------------------------------------------ get_scene


@pytest.fixture(scope="module")
def models():
    env = AlignFr3Env()
    return env.agent.model, j_get_agent("fr3_umi").model, env.actor_names


@pytest.mark.parametrize("case", ["real", "missing", "empty"])
def test_get_scene_matches_jax(tmp_path, models, case):
    """Scans present: merged, is_real; a file missing: the synthetic
    scene in both; an empty models list: both raise (np.concatenate of
    no arrays), as no fallback catches it."""
    model, j_model, objects = models
    asset_dir, cfg_dir = _write_scans(tmp_path)
    if case == "missing":
        (tmp_path / "rack.ply").unlink()
    if case == "empty":
        (tmp_path / "configs" / "fr3_test.json").write_text(
            json.dumps({"models": []}))
    scan_qpos = np.zeros(model.dof, np.float32)
    kw = dict(scan_qpos=scan_qpos, object_names=list(objects),
              link_names=list(model.link_names), asset_dir=asset_dir,
              cfg_dir=cfg_dir, synthetic_sizes=dict(
                  n_background=100, n_per_link=4, n_per_object=6))
    if case == "empty":
        with pytest.raises(ValueError):
            j_get_scene("fr3_test", j_model, **kw)
        with pytest.raises(ValueError):
            get_scene("fr3_test", model, **kw, device="cpu")
        return
    scene, layout, is_real = get_scene("fr3_test", model, **kw, device="cpu")
    j_scene, j_layout, j_is_real = j_get_scene("fr3_test", j_model, **kw)
    assert is_real == j_is_real == (case == "real")
    assert dataclasses.asdict(layout) == dataclasses.asdict(j_layout)
    if case == "real":
        _same_scene(scene, j_scene)
        return
    for f in SCENE_FIELDS:
        got, want = getattr(scene, f).numpy(), np.asarray(getattr(j_scene, f))
        if f == "means":
            np.testing.assert_allclose(got, want, atol=FK_TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)


# -------------------------------------------------- the wrapper on a scan


def test_wrapper_on_merged_scans_renders_the_synthetic_frames(tmp_path):
    """configs/fr3_align.json's scans written from the small synthetic
    scene: the merged scene renders the synthetic scene's frames bit for
    bit after reset and one step (plain versions on the CPU)."""
    from gsworld_tpu_torch import constants
    from gsworld_tpu_torch.gs.model import scene_to_splats
    kw = dict(raster=dict(cs.BENCH_RASTER, width=160, height=120,
                          max_entries=16384), synthetic_scale=0.004)
    _, syn = cs.bench_build("AlignFr3Env-v1", 2, "fr3_align", "cpu", **kw)
    assert not syn.is_real_scene
    order = cs.write_config_scans(scene_to_splats(syn.renderer.scene),
                                  f"{constants.CFG_DIR}/fr3_align.json",
                                  str(tmp_path))
    np.testing.assert_array_equal(order, np.arange(len(order)))
    env, real = cs.bench_build("AlignFr3Env-v1", 2, "fr3_align", "cpu",
                               asset_dir=str(tmp_path), **kw)
    assert real.is_real_scene and real.renderer.is_real_scene
    for f in SCENE_FIELDS:
        assert torch.equal(getattr(real.renderer.scene, f),
                           getattr(syn.renderer.scene, f)), f
    gen = torch.Generator().manual_seed(0)
    obs = [w.reset(seed=0)[0] for w in (syn, real)]
    for step in range(2):
        if step:
            a = env.action_space_sample(gen)
            obs = [w.step(a)[0] for w in (syn, real)]
        (rs, ss), (rr, sr) = cs.frames_of(obs[0]), cs.frames_of(obs[1])
        assert torch.equal(rs, rr) and torch.equal(ss, sr), step
        assert len(torch.unique(ss)) >= 3
