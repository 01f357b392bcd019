"""The contact solver's normal Newton stage on the CPU, where
``physics/world.py:normal_newton`` takes its plain version: the port's
``_solve_contacts`` against the frozen benchmark reference's
(``benchmark/reference/gsw/physics/world.py``, the solve as it was before
the stage became a module-level function) bit for bit at the grasped
layout, with every friction stage; and the CPU path launches no kernel.
The kernel itself is held to the plain version on the card by
``tests/test_torch_newton_card.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference.gsw import envs as renvs
from benchmark.reference.gsw.physics import dynamics as RD
from benchmark.reference.gsw.physics import world as RW
from gsworld_tpu_torch import envs as tenvs
from gsworld_tpu_torch.physics import dynamics as TD
from gsworld_tpu_torch.physics import world as TW
from gsworld_tpu_torch.utils import kernels
from torch_physics_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    blank_world,
    pinched_world,
)

B = 2


@pytest.fixture(scope="module")
def envs_and_grasp():
    port = tenvs.make("AlignFr3Env-v1", num_envs=B, device="cpu")
    ref = renvs.make("AlignFr3Env-v1", num_envs=B, device="cpu")
    n_rows = TW.contact_row_count(port.scene)
    n_la = len(port.scene.la_pairs)
    model = port.agent.model
    q0 = torch.as_tensor(blank_world(1, n_rows, n_la)["qpos"])
    kin = TD.compute_kinematics(model, q0, torch.zeros(1, 3),
                                torch.tensor([[1.0, 0, 0, 0]]))
    tcp = kin.link_pos[0, model.link_id("fr3_hand_tcp")].numpy()
    d = pinched_world(B, n_rows, n_la, tcp)
    # motion and a warm start at the contact points, so every term lives
    rng = np.random.default_rng(19)
    d["qvel"] = rng.normal(scale=0.05, size=d["qvel"].shape).astype(
        np.float32)
    d["qvel"][:, 8] = d["qvel"][:, 7]
    d["a_lin"] = rng.normal(scale=0.02, size=d["a_lin"].shape).astype(
        np.float32)
    return port, ref, d


def _solve(W, D, env, d, stage):
    """``W._solve_contacts`` of ``env``'s scene with friction stage
    ``stage`` from the numpy state ``d``, its inputs computed by the same
    package's modules ``W`` and ``D``; half the warm start matched."""
    scene = dataclasses.replace(env.scene, solver=dataclasses.replace(
        env.scene.solver, friction_stage=stage))
    m, st = scene.model, scene.tensors
    w = W.world_state_from_numpy(d, device="cpu")
    kin = D.compute_kinematics(m, w.qpos, w.root_pos, w.root_quat)
    M = D.mass_matrix(m, kin)
    bias = D.bias_forces(m, kin, w.qvel)
    qv, Minv = D.implicit_pd_velocity(m, M, bias, w.qpos, w.qvel, w.qpos,
                                      st.kp, st.kd, st.force_limit, scene.h,
                                      tau_external=bias)
    contacts, _ = W._generate_contacts(scene, kin, w)
    lam0 = torch.zeros(contacts.pen.shape + (6,))
    lam0[..., 3:] = contacts.pos
    lam0[:, ::2, 3:] += 1.0
    lam0[..., 0] = 0.01 * contacts.active
    lam0[..., 1] = 0.001 * contacts.active
    return W._solve_contacts(scene, kin, contacts, Minv, qv,
                             w.a_lin + st.h_gravity, w.a_ang, w, lam0=lam0)


@pytest.mark.parametrize("stage", ["off", "qp", "pgs"])
def test_solve_contacts_matches_the_frozen_reference_bit_for_bit(
        envs_and_grasp, stage):
    port, ref, d = envs_and_grasp
    kernels.reset_launch_counts()
    got = _solve(TW, TD, port, d, stage)
    want = _solve(RW, RD, ref, d, stage)
    assert kernels.launch_counts["normal_newton"] == 0
    # the grasp is live: normal impulses on both sides of the can
    assert bool((got[3][..., 0] > 0).sum(-1).ge(4).all())
    for name, g, w in zip(("qvel", "a_lin", "a_ang", "lam"), got, want):
        assert torch.equal(g, w), name


def test_cpu_dispatch_is_the_plain_version_and_counts_no_launch():
    gen = torch.Generator().manual_seed(19)
    n = 40
    J = torch.randn((3, n, n + 5), generator=gen)
    An = J @ J.transpose(-1, -2) / n + 0.5 * torch.eye(n)
    act_mask = torch.rand((3, n), generator=gen) < 0.8
    rhs = torch.randn((3, n), generator=gen) - 0.5
    x_init = torch.rand((3, n), generator=gen) * (rhs < 0)
    kernels.reset_launch_counts()
    got = TW.normal_newton(An, act_mask, rhs, x_init)
    assert kernels.launch_counts["normal_newton"] == 0
    assert torch.equal(got, TW.normal_newton_reference(An, act_mask, rhs,
                                                       x_init))
    # the LCP's solution on the mask: x >= 0, w = 0 where x > 0, else w >= 0
    w = (An @ got[..., None])[..., 0] + rhs
    assert bool((got >= 0).all()) and bool((got[~act_mask] == 0).all())
    live = got > 0
    assert float(w[live].abs().max()) < 1e-4
    assert float(w[act_mask & ~live].min()) > -1e-4
