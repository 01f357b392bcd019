"""The port's physics scene and control step
(gsworld_tpu_torch/physics/{builders,world}.py) against the JAX package's:
every array of the two AlignFr3 scenes equal, and ``control_step`` from
three states made by the JAX package (after reset, cans resting after 20
steps, a can pinched between the fingers), for 1 and 10 control steps with
seeded PD targets.  One step: positions 1e-5, velocities, pair forces and
contact impulses 1e-3 relative to each field's largest value (or to 0.01
m/s, 0.01 rad/s, 1 N where a field is at rest); ten steps: positions 1e-3.

One looser bar, on the pinched state.  ``reduce_patch`` picks each next
row by the largest distance to the rows it has; the ring points of the
can are symmetric, so two candidates tie to the last bit and the two
packages' roundings pick them in another order: two adjacent rows of one
patch change places (rows 151/152 and 154/155, the green can's points
against the hand's hull, and 80/81, against the left finger's).  The
contacts are the same set, so one step agrees once rows are matched
within their patch; but the position gate then drops the warm start of
the rows that changed places, the unconverged Jacobi polish starts
elsewhere, and a 20-30 N grasp of a 4 g can amplifies it: after ten
steps the can's pose is held to 1e-2 (position) and 5e-2 (quaternion),
the joints still to 1e-3 (found: 4e-4, 8e-3, 5e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsworld_tpu import envs as jenvs
from gsworld_tpu.physics import world as JW
from gsworld_tpu_torch import envs as tenvs
from gsworld_tpu_torch.physics import builders as TB
from gsworld_tpu_torch.physics import meshes as TM
from gsworld_tpu_torch.physics import world as TW
from gsworld_tpu.physics import builders as JB
from gsworld_tpu.physics import meshes as JM
from torch_physics_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    jax_world_to_numpy,
    numpy_to_jax_world,
    pinched_world,
    rel_err,
    torch_world,
)

B = 2
POS_TOL_1, VEL_TOL_1, POS_TOL_10 = 1e-5, 1e-3, 1e-3


@pytest.fixture(scope="module")
def pair():
    jenv = jenvs.make("AlignFr3Env-v1", num_envs=B)
    tenv = tenvs.make("AlignFr3Env-v1", num_envs=B, device="cpu")
    jstep = jax.jit(jax.vmap(
        lambda w, t: JW.control_step(jenv.scene, w, t)))
    return jenv, tenv, jstep


def _targets(world, rng, model, grip=None):
    """Seeded PD targets near the current joints: arm +-0.1 rad, gripper
    anywhere in its range or held at ``grip``."""
    t = np.asarray(world["qpos"]) + rng.uniform(
        -0.1, 0.1, world["qpos"].shape).astype(np.float32)
    t[:, 7:] = (rng.uniform(0.0, 0.04, (t.shape[0], 1)) if grip is None
                else grip)
    return np.clip(t, model.qlimits[:, 0], model.qlimits[:, 1]).astype(
        np.float32)


@pytest.fixture(scope="module")
def states(pair):
    """The three start states, made by the JAX package."""
    jenv, tenv, jstep = pair
    jenv.reset(seed=0)
    reset = jax_world_to_numpy(jenv.state.world)
    w = jenv.state.world
    hold = jnp.asarray(reset["qpos"])
    for _ in range(20):
        w = jstep(w, hold)
    resting = jax_world_to_numpy(w)
    # the pinch: the green can held at the fingers while they close for 12
    # steps, then 4 free steps in the grasp
    tcp = np.asarray(jenv.tcp_pose(
        jax.tree.map(lambda x: x[0], jenv._vmapped_data(jenv.state)))[0])
    d = pinched_world(B, 180, 9, tcp, finger_q=0.04)
    closed = d["qpos"].copy()
    closed[:, 7:] = 0.0
    w = numpy_to_jax_world(d)
    pin = jnp.asarray(d["a_pos"][:, 0])
    for i in range(16):
        w = jstep(w, jnp.asarray(closed))
        if i < 12:
            w = w.replace(a_pos=w.a_pos.at[:, 0].set(pin),
                          a_lin=w.a_lin.at[:, 0].set(0.0),
                          a_ang=w.a_ang.at[:, 0].set(0.0))
    pinched = jax_world_to_numpy(w)
    return dict(reset=reset, resting=resting, pinched=pinched)


def test_pinched_state_is_a_grasp(states):
    """The fixture's third state has the can in the fingers: both finger
    pairs carry force and the can has not fallen."""
    f = np.linalg.norm(states["pinched"]["la_forces"], axis=-1)   # (B, 9)
    assert (f[:, 0] > 0.5).all() and (f[:, 3] > 0.5).all(), f
    assert (states["pinched"]["a_pos"][:, 0, 2] > 0.1).all()


SCENE_ARRAYS = ("planes", "link_collision_pts", "link_faces", "link_friction",
                "la_pairs", "aa_pairs", "kp", "kd", "force_limit")
ACTOR_ARRAYS = ("mass", "inertia", "sup_pts", "faces", "friction")


@pytest.mark.parametrize("name", SCENE_ARRAYS + ACTOR_ARRAYS)
def test_scene_arrays_equal(pair, name):
    jenv, tenv, _ = pair
    js, ts = jenv.scene, tenv.scene
    if name in ACTOR_ARRAYS:
        js, ts = js.actors, ts.actors
    np.testing.assert_array_equal(np.asarray(getattr(ts, name)),
                                  np.asarray(getattr(js, name)))


def test_scene_scalars_and_tensors(pair):
    jenv, tenv, _ = pair
    js, ts = jenv.scene, tenv.scene
    assert ts.actors.names == js.actors.names
    assert (ts.sim_freq, ts.control_freq, ts.substeps, ts.h) == (
        js.sim_freq, js.control_freq, js.substeps, js.h)
    assert ts.compensate_passive == js.compensate_passive
    for f in ("iterations", "relaxation", "baumgarte", "slop", "max_pen_vel",
              "contact_patch", "contact_margin", "link_face_pref",
              "max_kick_lin", "max_kick_ang"):
        assert getattr(ts.solver, f) == getattr(js.solver, f), f
    assert ts.solver.friction_stage == "off"
    st = ts.tensors
    assert st.sup_pts.device.type == "cpu" and st.sup_pts.dtype == torch.float32
    np.testing.assert_array_equal(st.sup_pts.numpy(), ts.actors.sup_pts)
    assert st.la_sel.shape == (9, 180) and st.oh_a.shape == (180, 3)


@pytest.mark.parametrize("fn,args", [
    ("farthest_point_sample", (40, 12)),
    ("convex_support_points", (60, 24)),
    ("primitive_points", ("box",)), ("primitive_points", ("cylinder",)),
    ("primitive_points", ("sphere",)), ("primitive_points", ("capsule",)),
    ("fibonacci_sphere", (26,)),
])
def test_meshes_equal(fn, args):
    rng = np.random.default_rng(2)
    if fn in ("farthest_point_sample", "convex_support_points"):
        call = (rng.normal(size=(args[0], 3)), args[1])
    elif fn == "primitive_points":
        call = (args[0], np.array([0.04, 0.1, 0.06]))
    else:
        call = args
    np.testing.assert_array_equal(getattr(TM, fn)(*call),
                                  getattr(JM, fn)(*call))


@pytest.mark.parametrize("kind", ["box", "cylinder", "convex"])
def test_actor_defs_equal(kind):
    rng = np.random.default_rng(4)
    pts = rng.normal(scale=0.03, size=(50, 3))
    make = {"box": lambda m: m.box_actor("b", [0.03, 0.02, 0.05]),
            "cylinder": lambda m: m.cylinder_actor("c", 0.03, 0.06, axis="x"),
            "convex": lambda m: m.convex_actor("v", pts)}[kind]
    t, j = make(TB), make(JB)
    assert t.mass == j.mass
    for f in ("sup_pts", "inertia", "faces"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    tv, jv = TB.hull_mass_properties(pts), JB.hull_mass_properties(pts)
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a, b)


def _write_tetra(path):
    """A small closed mesh (a skewed tetrahedron plus an inner vertex) as
    .obj, ascii .ply or ascii .stl."""
    v = np.array([[0, 0, 0], [0.06, 0, 0], [0.01, 0.05, 0], [0.02, 0.01, 0.04],
                  [0.02, 0.015, 0.01]])
    f = [(0, 2, 1), (0, 1, 3), (1, 2, 3), (2, 0, 3)]
    with open(path, "w") as fh:
        if path.endswith(".obj"):
            fh.writelines(f"v {a} {b} {c}\n" for a, b, c in v)
            fh.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f)
        elif path.endswith(".ply"):
            fh.write("ply\nformat ascii 1.0\nelement vertex 5\n"
                     "property float x\nproperty float y\nproperty float z\n"
                     "element face 4\nproperty list uchar int "
                     "vertex_indices\nend_header\n")
            fh.writelines(f"{a} {b} {c}\n" for a, b, c in v)
            fh.writelines(f"3 {a} {b} {c}\n" for a, b, c in f)
        else:
            fh.write("solid t\n")
            for tri in f:
                fh.write("facet normal 0 0 0\nouter loop\n")
                fh.writelines("vertex {} {} {}\n".format(*v[i]) for i in tri)
                fh.write("endloop\nendfacet\n")
            fh.write("endsolid t\n")


@pytest.mark.parametrize("ext", [".obj", ".ply", ".stl"])
def test_mesh_readers_and_mesh_actor_equal(tmp_path, ext):
    path = str(tmp_path / ("dtc_test_can" + ext))
    _write_tetra(path)
    for a, b in zip(TM.load_mesh(path), JM.load_mesh(path)):
        np.testing.assert_array_equal(a, b)
    t, j = TB.mesh_actor("m", path, scale=1.5), JB.mesh_actor("m", path,
                                                              scale=1.5)
    assert t.mass == j.mass and t.mass > 0
    for f in ("sup_pts", "inertia", "faces"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    # the asset upgrade path finds the mesh by the actor's name
    fallback = TB.box_actor("dtc_test_can", [0.01, 0.01, 0.01])
    assert TB.asset_collision_path("dtc_test_can", str(tmp_path)) == path
    up = TB.actor_from_asset(fallback, asset_dir=str(tmp_path))
    assert up.sup_pts.shape[0] == 4 and up.mass != fallback.mass
    assert TB.actor_from_asset(fallback, asset_dir=str(tmp_path / "no")) \
        is fallback
    with pytest.raises(ValueError, match="unsupported mesh format"):
        TM.load_mesh(str(tmp_path / "mesh.dae"))


def _run(pair, start, n_steps, seed, grip=None):
    jenv, tenv, jstep = pair
    rng = np.random.default_rng(seed)
    jw, tw = numpy_to_jax_world(start), torch_world(start)
    cur = start
    for _ in range(n_steps):
        tgt = _targets(cur, rng, tenv.agent.model, grip)
        jw = jstep(jw, jnp.asarray(tgt))
        tw = TW.control_step(tenv.scene, tw, torch.as_tensor(tgt))
        cur = jax_world_to_numpy(jw)
    return TW.world_state_to_numpy(tw), cur


def _match_patch_rows(got, want, R=6):
    """Reorder each patch's R rows of ``got`` (B, C, 6) to the order of
    ``want`` by nearest contact position (see the module docstring)."""
    Bn, Cn, _ = got.shape
    g = got.reshape(Bn, Cn // R, R, 6)
    w = want.reshape(Bn, Cn // R, R, 6)
    d = np.linalg.norm(w[..., :, None, 3:] - g[..., None, :, 3:], axis=-1)
    idx = d.argmin(axis=-1)                                 # (B, P, R)
    return np.take_along_axis(g, idx[..., None], axis=2).reshape(got.shape)


@pytest.mark.parametrize("state", ["reset", "resting", "pinched"])
def test_control_step_once(pair, states, state):
    got, want = _run(pair, states[state], 1, seed=11)
    for f in ("qpos", "a_pos", "a_quat"):
        assert rel_err(got[f], want[f]) <= POS_TOL_1, f
    # a body at rest has velocities of ~1e-7 around zero: below 0.01 m/s
    # (rad/s) and 1 N the error is held against that scale
    got["contact_lam"] = _match_patch_rows(got["contact_lam"],
                                           want["contact_lam"])
    for f, floor in (("qvel", 1e-2), ("a_lin", 1e-2), ("a_ang", 1e-2),
                     ("la_forces", 1.0), ("contact_lam", 1e-2)):
        assert rel_err(got[f], want[f], floor) <= VEL_TOL_1, f
    for f in ("root_pos", "root_quat", "a_friction", "a_scale"):
        np.testing.assert_array_equal(got[f], want[f])


@pytest.mark.parametrize("state", ["reset", "resting", "pinched"])
def test_control_step_ten_times(pair, states, state):
    got, want = _run(pair, states[state], 10, seed=12)
    tol = dict(qpos=POS_TOL_10, a_pos=POS_TOL_10, a_quat=POS_TOL_10)
    if state == "pinched":      # rows that tie change places, see above
        tol.update(a_pos=1e-2, a_quat=5e-2)
        assert (got["a_pos"][:, 0, 2] > 0.3).all(), "the can is still held"
    for f, t in tol.items():
        assert rel_err(got[f], want[f]) <= t, f
    assert all(np.isfinite(v).all() for v in got.values())


def test_world_state_bridge_round_trip(states):
    d = states["pinched"]
    back = TW.world_state_to_numpy(torch_world(d))
    for f in TW.WORLD_FIELDS:
        np.testing.assert_array_equal(back[f], d[f])
    partial = dict(d, contact_lam=None, a_scale=None)
    w = TW.world_state_from_numpy(partial, device="cpu")
    assert w.contact_lam is None and w.a_scale is None


def test_control_step_needs_scene_tensors(pair, states):
    _, tenv, _ = pair
    import dataclasses
    bare = dataclasses.replace(tenv.scene, tensors=None)
    with pytest.raises(ValueError, match="no tensors"):
        TW.control_step(bare, torch_world(states["reset"]),
                        torch.as_tensor(states["reset"]["qpos"]))
