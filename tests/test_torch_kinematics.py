"""Parity of the port's maths, robot model, FK and camera mounts
(gsworld_tpu_torch.core / physics / envs) with the JAX reference on the
CPU.  Inputs are made with numpy from a seed and fed to both packages."""

import types
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsworld_tpu import constants as jconstants
from gsworld_tpu.core import maths as jm
from gsworld_tpu.envs.agents.base import get_agent as j_get_agent
import gsworld_tpu.envs.agents.fr3_umi  # noqa: F401  (registers agents)
from gsworld_tpu.envs.base import GsBaseEnv as JGsBaseEnv
from gsworld_tpu.envs.tasks.real_fr3 import RealFr3 as JRealFr3
from gsworld_tpu.physics.kinematics import apply_mimic as j_apply_mimic
from gsworld_tpu.physics.kinematics import forward_kinematics as j_fk
from gsworld_tpu_torch import constants
from gsworld_tpu_torch.core import maths as tm
from gsworld_tpu_torch.envs.agents.fr3_umi import FR3_UIDS, fr3_agent
from gsworld_tpu_torch.envs.base import EnvPoses
from gsworld_tpu_torch.envs.tasks.tabletop.franka.align import AlignFr3Env
from gsworld_tpu_torch.physics.kinematics import apply_mimic, forward_kinematics


class _World(NamedTuple):
    """The pose fields of the JAX WorldState that its camera code reads."""

    qpos: jnp.ndarray
    root_pos: jnp.ndarray
    root_quat: jnp.ndarray


# f32 rotation chains over ~12 links, evaluated in another operation order
FK_TOL = 1e-5


def _random_qpos(model, n, seed):
    lo, hi = model.qlimits[:, 0], model.qlimits[:, 1]
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.uniform(size=(n, len(lo)))).astype(np.float32)


def _random_root(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            q.astype(np.float32))


class TestMaths:
    def test_quaternion_functions_match_jax(self):
        rng = np.random.default_rng(0)
        a = rng.normal(size=(16, 4)).astype(np.float32)
        b = rng.normal(size=(16, 4)).astype(np.float32)
        v = rng.normal(size=(16, 3)).astype(np.float32)
        au = a / np.linalg.norm(a, axis=1, keepdims=True)
        pairs = [
            (jm.quat_multiply(a, b), tm.quat_multiply(torch.as_tensor(a),
                                                      torch.as_tensor(b))),
            (jm.quat_rotate(au, v), tm.quat_rotate(torch.as_tensor(au),
                                                   torch.as_tensor(v))),
            (jm.quat_to_matrix(au), tm.quat_to_matrix(torch.as_tensor(au))),
            (jm.quat_compose_preserving_norm(au, b),
             tm.quat_compose_preserving_norm(torch.as_tensor(au),
                                             torch.as_tensor(b))),
            (jm.matrix_to_quat(jm.quat_to_matrix(au)),
             tm.matrix_to_quat(tm.quat_to_matrix(torch.as_tensor(au)))),
            (jm.tf_inverse_rigid(jm.tf_from_pq(v, au)),
             tm.tf_inverse_rigid(tm.tf_from_pq(torch.as_tensor(v),
                                               torch.as_tensor(au)))),
        ]
        for ref, got in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6)

    def test_axis_angle_including_zero_angle(self):
        rng = np.random.default_rng(1)
        aa = rng.normal(size=(8, 3)).astype(np.float32)
        aa[0] = 0.0
        aa[1] = 1e-9
        np.testing.assert_allclose(
            tm.axis_angle_to_quat(torch.as_tensor(aa)).numpy(),
            np.asarray(jm.axis_angle_to_quat(jnp.asarray(aa))), atol=1e-7)
        zero = torch.zeros(3, requires_grad=True)
        tm.axis_angle_to_quat(zero).sum().backward()
        assert torch.isfinite(zero.grad).all()

    def test_extract_rigid_transform_on_calibration(self):
        Ms = np.stack([np.asarray(T, np.float32) for T in
                       constants.sim2gs_object_transforms.values()])
        _, js, jR, _ = jm.extract_rigid_transform_fast(jnp.asarray(Ms))
        _, ts, tR, _ = tm.extract_rigid_transform_fast(torch.as_tensor(Ms))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)


class TestModel:
    def test_constants_are_the_reference_data(self):
        for name in ("sim2gs_arm_trans", "wrist2eef", "right2base",
                     "rs_d435i_rgb_k", "fr3_umi_task_init_qpos"):
            np.testing.assert_array_equal(getattr(constants, name),
                                          getattr(jconstants, name))
        assert constants.fr3_gs_semantics == jconstants.fr3_gs_semantics
        assert constants.obj_gs_semantics == jconstants.obj_gs_semantics
        assert constants.ROBOT_SPEC_DIR == jconstants.ROBOT_SPEC_DIR

    @pytest.mark.parametrize("uid", FR3_UIDS)
    def test_articulation_tables_match(self, uid):
        jmod = j_get_agent(uid).model
        tmod = fr3_agent(uid).model
        assert tmod.link_names == jmod.link_names
        assert tmod.dof_names == jmod.dof_names
        for f in ("parent", "jtype", "origin_pos", "origin_quat", "axis",
                  "dof_index", "qlimits", "mimic_parent", "mimic_mult",
                  "mimic_offset"):
            np.testing.assert_array_equal(getattr(tmod, f),
                                          getattr(jmod, f), err_msg=f)


class TestFK:
    @pytest.mark.parametrize("uid,seed", [("fr3_umi", 0),
                                          ("fr3_umi_wrist435", 1)])
    def test_fk_matches_jax(self, uid, seed):
        jmod = j_get_agent(uid).model
        tmod = fr3_agent(uid).model
        q = _random_qpos(tmod, 6, seed)
        rp, rq = _random_root(6, seed + 10)
        jp, jq = j_fk(jmod, jnp.asarray(q), jnp.asarray(rp), jnp.asarray(rq))
        tp, tq = forward_kinematics(tmod, torch.as_tensor(q),
                                    torch.as_tensor(rp), torch.as_tensor(rq))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=FK_TOL)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=FK_TOL)
        # default root pose, unbatched qpos
        jp0, _ = j_fk(jmod, jnp.asarray(q[0]))
        tp0, _ = forward_kinematics(tmod, torch.as_tensor(q[0]))
        np.testing.assert_allclose(tp0.numpy(), np.asarray(jp0), atol=FK_TOL)

    def test_apply_mimic_matches_jax(self):
        tmod = fr3_agent().model
        q = _random_qpos(tmod, 4, 5)
        np.testing.assert_array_equal(
            apply_mimic(tmod, torch.as_tensor(q)).numpy(),
            np.asarray(j_apply_mimic(j_get_agent("fr3_umi").model,
                                     jnp.asarray(q))))


class TestCameras:
    def test_extrinsics_match_jax(self):
        B = 4
        env = AlignFr3Env(num_envs=B)
        jagent = j_get_agent("fr3_umi")
        jcams = JRealFr3._default_sensor_configs(
            types.SimpleNamespace(agent=jagent))
        assert [c.name for c in env.cameras] == [c.name for c in jcams]
        for a, b in zip(env.cameras, jcams):
            assert (a.mount_link, a.width, a.height) == (
                b.mount_link, b.width, b.height)
            np.testing.assert_allclose(a.local_pose, b.local_pose)
        q = _random_qpos(env.agent.model, B, 3)
        rp, rq = _random_root(B, 4)
        world = _World(jnp.asarray(q), jnp.asarray(rp), jnp.asarray(rq))
        fake_env = types.SimpleNamespace(agent=jagent, num_envs=B,
                                         cameras=jcams)
        jext = JGsBaseEnv.camera_extrinsics_cv(
            fake_env, types.SimpleNamespace(
                world=world, task={}), jcams)
        poses = EnvPoses(qpos=torch.as_tensor(q), a_pos=torch.zeros(B, 3, 3),
                         a_quat=torch.zeros(B, 3, 4),
                         root_pos=torch.as_tensor(rp),
                         root_quat=torch.as_tensor(rq))
        text = env.camera_extrinsics_cv(poses)
        assert text.shape == (B, 2, 4, 4)
        np.testing.assert_allclose(text.numpy(), np.asarray(jext),
                                   atol=FK_TOL)
