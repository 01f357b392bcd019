"""The port's contact generation and contact solve
(gsworld_tpu_torch/physics/{contact,world}.py) against the JAX package's,
on the same numpy inputs: hull faces, the SAT query, the patch reduction
(indices equal), the AlignFr3 scene's 180 contact rows on resting, grasped
and separated layouts (active set and bodies equal, positions, normals and
depths to 1e-6), and the solve with each friction stage (1e-4 relative).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsworld_tpu import envs as jenvs
from gsworld_tpu.physics import contact as JC
from gsworld_tpu.physics import dynamics as JD
from gsworld_tpu.physics import world as JW
from gsworld_tpu_torch import envs as tenvs
from gsworld_tpu_torch.physics import contact as TC
from gsworld_tpu_torch.physics import dynamics as TD
from gsworld_tpu_torch.physics import world as TW
from torch_physics_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    blank_world,
    lifted_world,
    numpy_to_jax_world,
    pinched_world,
    rel_err,
    torch_world,
)

B = 2
GEN_TOL = 1e-6
SOLVE_TOL = 1e-4


@pytest.fixture(scope="module")
def scenes():
    jenv = jenvs.make("AlignFr3Env-v1", num_envs=B)
    tenv = tenvs.make("AlignFr3Env-v1", num_envs=B, device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def layouts(scenes):
    jenv, tenv = scenes
    n_rows = TW.contact_row_count(tenv.scene)
    n_la = len(tenv.scene.la_pairs)
    model = tenv.agent.model
    q0 = torch.as_tensor(blank_world(1, n_rows, n_la)["qpos"])
    kin = TD.compute_kinematics(model, q0, torch.zeros(1, 3),
                                torch.tensor([[1.0, 0, 0, 0]]))
    tcp = kin.link_pos[0, model.link_id("fr3_hand_tcp")].numpy()
    rng = np.random.default_rng(3)
    out = dict(resting=blank_world(B, n_rows, n_la, rng),
               grasped=pinched_world(B, n_rows, n_la, tcp),
               separated=lifted_world(B, n_rows, n_la))
    # a warm start and some motion, so every term of the solve is live
    for d in out.values():
        d["qvel"] = rng.normal(scale=0.05, size=d["qvel"].shape).astype(
            np.float32)
        d["qvel"][:, 8] = d["qvel"][:, 7]
        d["a_lin"] = rng.normal(scale=0.02, size=d["a_lin"].shape).astype(
            np.float32)
    return out


def test_row_count_is_180(scenes):
    jenv, tenv = scenes
    assert TW.contact_row_count(tenv.scene) == 180
    assert JW.contact_row_count(jenv.scene) == 180
    st = tenv.scene.tensors
    assert st.body_a.shape == (180,) and st.q_src.shape == (24,)


@pytest.mark.parametrize("shape", ["box", "cylinder", "flat"])
def test_hull_faces(shape):
    rng = np.random.default_rng(1)
    pts = {"box": rng.uniform(-1, 1, (8, 3)) * [0.1, 0.2, 0.05],
           "cylinder": np.stack([0.03 * np.cos(np.arange(20) * 0.314),
                                 0.03 * np.sin(np.arange(20) * 0.314),
                                 np.repeat([-0.05, 0.05], 10)], 1),
           "flat": np.concatenate([rng.uniform(-1, 1, (6, 2)),
                                   np.zeros((6, 1))], 1)}[shape]
    np.testing.assert_array_equal(TC.hull_faces(pts, 32),
                                  JC.hull_faces(pts, 32))


def _sat_inputs(seed):
    rng = np.random.default_rng(seed)
    faces = JC.hull_faces(rng.uniform(-0.05, 0.05, (10, 3)), 32)
    pts = rng.uniform(-0.08, 0.08, (24, 3)).astype(np.float32)
    pts[20:] = 1e7                                     # padding points
    pos = rng.normal(scale=0.01, size=3).astype(np.float32)
    quat = rng.normal(size=4).astype(np.float32)
    quat /= np.linalg.norm(quat)
    return pts, pos, quat, faces


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hull_query_sat(seed):
    pts, pos, quat, faces = _sat_inputs(seed)
    want = JC.hull_query_sat(jnp.asarray(pts), jnp.asarray(pos),
                             jnp.asarray(quat), jnp.asarray(faces),
                             margin=0.008)
    got = TC.hull_query_sat(*(torch.as_tensor(x) for x in
                              (pts, pos, quat, faces)), margin=0.008)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    real = faces[:, 3] > -1e8
    valid = pts[:, 0] < 1e6
    assert rel_err(got[1].numpy()[real], np.asarray(want[1])[real]) <= GEN_TOL
    assert rel_err(got[2].numpy()[valid][:, real],
                   np.asarray(want[2])[valid][:, real]) <= GEN_TOL
    assert rel_err(got[3].numpy(), want[3]) <= GEN_TOL


@pytest.mark.parametrize("case", ["spread", "ties", "none_valid"])
def test_reduce_patch_indices_equal(case):
    rng = np.random.default_rng(5)
    pos = rng.uniform(-0.05, 0.05, (4, 24, 3)).astype(np.float32)
    pen = rng.uniform(-0.02, 0.01, (4, 24)).astype(np.float32)
    if case == "ties":
        pen[:, ::2] = 0.004
        pos[:, 12:] = 1e7
    if case == "none_valid":
        pen[:] = -1.0
    jp, ji = JC.reduce_patch(jnp.asarray(pen), jnp.asarray(pos), 6,
                             margin=0.008)
    tp, ti = TC.reduce_patch(torch.as_tensor(pen), torch.as_tensor(pos), 6,
                             margin=0.008)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _generate(scenes, d):
    jenv, tenv = scenes

    def jgen(w):
        kin = JD.compute_kinematics(jenv.scene.model, w.qpos, w.root_pos,
                                    w.root_quat)
        return JW._generate_contacts(jenv.scene, kin, w)[0]

    want = jax.vmap(jgen)(numpy_to_jax_world(d))
    tw = torch_world(d)
    kin = TD.compute_kinematics(tenv.scene.model, tw.qpos, tw.root_pos,
                                tw.root_quat)
    got, spans = TW._generate_contacts(tenv.scene, kin, tw)
    return got, want


@pytest.mark.parametrize("layout", ["resting", "grasped", "separated"])
def test_generate_contacts(scenes, layouts, layout):
    got, want = _generate(scenes, layouts[layout])
    active = np.asarray(want.active)
    np.testing.assert_array_equal(got.active.numpy(), active)
    for name in ("body_a", "body_b"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name))[0])
    n_active = int(active.sum())
    if layout == "separated":
        assert n_active == 0
    else:
        assert n_active >= 6 * B
    if layout == "grasped":
        # both fingers touch the green can (links 12, 13; actor 0 = body 14)
        a, b = np.asarray(want.body_a)[0], np.asarray(want.body_b)[0]
        for link in (12, 13):
            rows = ((a == link) & (b == 14)) | ((a == 14) & (b == link))
            assert active[:, rows].any(axis=1).all(), link
    for name in ("pos", "normal", "pen", "friction"):
        g = getattr(got, name).numpy()[active]
        w = np.asarray(getattr(want, name))[active]
        assert np.abs(g - w).max(initial=0.0) <= GEN_TOL, name


def _solve_inputs(scenes, d, stage):
    """Both packages' free velocities, contacts and solve from the state
    ``d`` with friction stage ``stage``."""
    jenv, tenv = scenes
    jscene = dataclasses.replace(jenv.scene, solver=dataclasses.replace(
        jenv.scene.solver, friction_stage=stage))
    tscene = dataclasses.replace(tenv.scene, solver=dataclasses.replace(
        tenv.scene.solver, friction_stage=stage))
    h = jscene.h
    anc = jnp.asarray(JD._ancestor_dofs(jscene.model), jnp.float32)

    def jsolve(w, lam0):
        m = jscene.model
        kin = JD.compute_kinematics(m, w.qpos, w.root_pos, w.root_quat)
        M = JD.mass_matrix(m, kin)
        bias = JD.bias_forces(m, kin, w.qvel)
        qv, Minv = JD.implicit_pd_velocity(
            m, M, bias, w.qpos, w.qvel, w.qpos, jnp.asarray(jscene.kp),
            jnp.asarray(jscene.kd), jnp.asarray(jscene.force_limit), h,
            tau_external=bias)
        contacts, _ = JW._generate_contacts(jscene, kin, w)
        return JW._solve_contacts(jscene, kin, contacts, Minv, qv,
                                  w.a_lin + h * JD.GRAVITY, w.a_ang, w, anc,
                                  lam0=lam0)

    tw = torch_world(d)
    m = tscene.model
    st = tscene.tensors
    kin = TD.compute_kinematics(m, tw.qpos, tw.root_pos, tw.root_quat)
    M = TD.mass_matrix(m, kin)
    bias = TD.bias_forces(m, kin, tw.qvel)
    qv, Minv = TD.implicit_pd_velocity(m, M, bias, tw.qpos, tw.qvel, tw.qpos,
                                       st.kp, st.kd, st.force_limit, h,
                                       tau_external=bias)
    contacts, _ = TW._generate_contacts(tscene, kin, tw)
    # a warm start at the true contact points: half of the rows matched
    lam0 = np.zeros((B, 180, 6), np.float32)
    lam0[..., 3:] = contacts.pos.numpy()
    lam0[:, ::2, 3:] += 1.0
    lam0[..., 0] = 0.01 * contacts.active.numpy()
    lam0[..., 1] = 0.001 * contacts.active.numpy()
    got = TW._solve_contacts(tscene, kin, contacts, Minv, qv,
                             tw.a_lin + st.h_gravity, tw.a_ang, tw,
                             lam0=torch.as_tensor(lam0))
    want = jax.jit(jax.vmap(jsolve))(numpy_to_jax_world(d),
                                     jnp.asarray(lam0))
    return got, want


@pytest.mark.parametrize("stage", ["off", "qp", "pgs"])
def test_solve_contacts(scenes, layouts, stage):
    """The grasped layout: finger, palm, table and can rows all live."""
    got, want = _solve_inputs(scenes, layouts["grasped"], stage)
    for name, g, w in zip(("qvel", "a_lin", "a_ang", "lam"), got, want):
        assert np.isfinite(g.numpy()).all(), name
        assert rel_err(g.numpy(), w) <= SOLVE_TOL, name


def test_unknown_friction_stage_raises(scenes, layouts):
    with pytest.raises(ValueError, match="friction_stage"):
        _solve_inputs(scenes, layouts["resting"], "sometimes")


def test_no_environment_variable_sets_the_friction_stage():
    """GSW_FQP set before the port is imported changes nothing."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c",
         "from gsworld_tpu_torch.physics.world import SolverParams; "
         "print(SolverParams().friction_stage)"],
        cwd=repo, env=dict(os.environ, GSW_FQP="qp"), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "off"
