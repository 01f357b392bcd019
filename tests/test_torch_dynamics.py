"""The port's articulated dynamics (gsworld_tpu_torch/physics/dynamics.py)
against the JAX package's on 8 random fr3_umi states: the same numpy
inputs, made from a seed, through both; 1e-5 relative to each field's
largest value (found: kinematics 4.8e-7, mass matrix 3.4e-7, bias forces
2.2e-7, implicit PD 1.9e-6, free step 3.7e-7; both run in f32 with sums
in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsworld_tpu.envs.agents.base import get_agent as jget_agent
import gsworld_tpu.envs.agents.fr3_umi  # noqa: F401 (registers agents)
from gsworld_tpu.physics import dynamics as JD
from gsworld_tpu_torch.envs.agents.fr3_umi import fr3_agent
from gsworld_tpu_torch.physics import dynamics as TD
from torch_physics_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    rel_err,
)

TOL = 1e-5
N = 8
H = 1.0 / 120.0


@pytest.fixture(scope="module")
def setup():
    jm, tm = jget_agent("fr3_umi").model, fr3_agent("fr3_umi").model
    rng = np.random.default_rng(0)
    lo, hi = tm.qlimits[:, 0], tm.qlimits[:, 1]
    q = rng.uniform(lo, hi, (N, tm.dof)).astype(np.float32)
    q[:, 8] = q[:, 7]                                   # the mimic holds
    qd = rng.normal(scale=0.5, size=(N, tm.dof)).astype(np.float32)
    qd[:, 8] = qd[:, 7]
    tgt = np.clip(q + rng.normal(scale=0.05, size=q.shape), lo,
                  hi).astype(np.float32)
    root_p = rng.normal(scale=0.1, size=(N, 3)).astype(np.float32)
    root_q = rng.normal(size=(N, 4)).astype(np.float32)
    root_q /= np.linalg.norm(root_q, axis=-1, keepdims=True)
    return dict(jm=jm, tm=tm, q=q, qd=qd, tgt=tgt, root_p=root_p,
                root_q=root_q)


def _kin(s):
    jk = jax.vmap(lambda q, p, r: JD.compute_kinematics(s["jm"], q, p, r))(
        jnp.asarray(s["q"]), jnp.asarray(s["root_p"]),
        jnp.asarray(s["root_q"]))
    tk = TD.compute_kinematics(s["tm"], torch.as_tensor(s["q"]),
                               torch.as_tensor(s["root_p"]),
                               torch.as_tensor(s["root_q"]))
    return jk, tk


def test_model_fields_equal(setup):
    for f in ("dof_link", "effort", "velocity", "damping", "friction", "mass",
              "com_pos", "inertia", "qlimits", "parent", "dof_index"):
        np.testing.assert_array_equal(getattr(setup["tm"], f),
                                      getattr(setup["jm"], f), err_msg=f)
    np.testing.assert_array_equal(TD._ancestor_dofs(setup["tm"]),
                                  JD._ancestor_dofs(setup["jm"]))
    np.testing.assert_array_equal(TD.mimic_basis(setup["tm"]),
                                  JD.mimic_basis(setup["jm"]))


@pytest.mark.parametrize("field", ["link_pos", "link_quat", "S", "com_w",
                                   "Iw"])
def test_compute_kinematics(setup, field):
    jk, tk = _kin(setup)
    assert rel_err(getattr(tk, field).numpy(), getattr(jk, field)) <= TOL


def test_mass_matrix(setup):
    jk, tk = _kin(setup)
    jM = jax.vmap(lambda k: JD.mass_matrix(setup["jm"], k))(jk)
    tM = TD.mass_matrix(setup["tm"], tk).numpy()
    assert rel_err(tM, jM) <= TOL
    assert np.abs(tM - np.swapaxes(tM, -1, -2)).max() <= 1e-5


def test_bias_forces(setup):
    jk, tk = _kin(setup)
    jb = jax.vmap(lambda k, v: JD.bias_forces(setup["jm"], k, v))(
        jk, jnp.asarray(setup["qd"]))
    tb = TD.bias_forces(setup["tm"], tk, torch.as_tensor(setup["qd"]))
    assert rel_err(tb.numpy(), jb) <= TOL


@pytest.mark.parametrize("limit", [100.0, 2.0],
                         ids=["unsaturated", "saturating"])
@pytest.mark.parametrize("external", [False, True],
                         ids=["no_ext", "passive_comp"])
def test_implicit_pd_velocity(setup, limit, external):
    """With the gripper's mimic; at limit 2.0 the arm drives saturate."""
    s = setup
    jk, tk = _kin(s)
    kp, kd = np.full(9, 1e3, np.float32), np.full(9, 1e2, np.float32)
    fl = np.full(9, limit, np.float32)

    def jf(k, q, v, t):
        M = JD.mass_matrix(s["jm"], k)
        b = JD.bias_forces(s["jm"], k, v)
        return JD.implicit_pd_velocity(
            s["jm"], M, b, q, v, t, kp, kd, fl, H,
            tau_external=b if external else None)

    jqv, jMinv = jax.vmap(jf)(jk, jnp.asarray(s["q"]), jnp.asarray(s["qd"]),
                              jnp.asarray(s["tgt"]))
    q, v, t = (torch.as_tensor(s[k]) for k in ("q", "qd", "tgt"))
    M = TD.mass_matrix(s["tm"], tk)
    b = TD.bias_forces(s["tm"], tk, v)
    tqv, tMinv = TD.implicit_pd_velocity(
        s["tm"], M, b, q, v, t, torch.as_tensor(kp), torch.as_tensor(kd),
        torch.as_tensor(fl), H, tau_external=b if external else None)
    assert rel_err(tqv.numpy(), jqv) <= TOL
    assert rel_err(tMinv.numpy(), jMinv) <= TOL
    # the mimic follower moves with its parent
    assert np.abs(tqv.numpy()[:, 8] - tqv.numpy()[:, 7]).max() <= 1e-6


@pytest.mark.parametrize("field", ["qpos", "qvel"])
def test_step_articulation_free(setup, field):
    s = setup
    kp, kd = np.full(9, 1e3, np.float32), np.full(9, 1e2, np.float32)
    fl = np.full(9, 100.0, np.float32)
    jq, jv, _ = jax.vmap(lambda q, v, t, p, r: JD.step_articulation_free(
        s["jm"], q, v, t, kp, kd, fl, H, root_pos=p, root_quat=r))(
        *(jnp.asarray(s[k]) for k in ("q", "qd", "tgt", "root_p", "root_q")))
    tq, tv, _ = TD.step_articulation_free(
        s["tm"], *(torch.as_tensor(s[k]) for k in ("q", "qd", "tgt")),
        torch.as_tensor(kp), torch.as_tensor(kd), torch.as_tensor(fl), H,
        root_pos=torch.as_tensor(s["root_p"]),
        root_quat=torch.as_tensor(s["root_q"]))
    got, want = (tq, jq) if field == "qpos" else (tv, jv)
    assert rel_err(got.numpy(), want) <= TOL
