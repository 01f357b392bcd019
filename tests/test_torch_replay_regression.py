"""The port replays the committed grasp trajectory
(tests/fixtures/grasp_traj.npz, tests/test_replay_regression.py): 25
control steps at sim 100 / control 20 of the green can teleported between
the FR3's fingers, the gripper closing and holding under gravity, from
JAX's reset(seed=0) state bridged to the port (the teleport done by the
JAX env, as the fixture's recording did).  The state sequence is checked
against the fixture by the port's ``compare_trajectories``.

Tolerances: the JAX test's own for every actor and the qpos (position
RMSE 1e-3, max 3e-3, qpos RMSE 1e-3, quaternion RMSE 2e-3).  The grasped
can is the pinched state of ROADMAP C10, where two ring points of a can
tie to the last bit and the packages may keep them in another order; on
this trajectory the port stays on the fixture (measured on the CPU: the
can's position RMSE 1.6e-6, max 3.3e-6, quaternion RMSE 1.7e-5; qpos
RMSE 1.3e-7), so the can needs no bound of its own.  No JAX physics step
is compiled: only JAX's reset.
"""

import os

import numpy as np

import jax
import jax.numpy as jnp

from gsworld_tpu import envs as jenvs
from gsworld_tpu_torch import envs as tenvs
from gsworld_tpu_torch.envs.base import env_state_from_numpy
from gsworld_tpu_torch.rollout.replay import compare_trajectories
from torch_physics_common import (
    jax_state_fields,
    one_torch_thread,  # noqa: F401 (autouse fixture)
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "grasp_traj.npz")
STEPS = 25
CAN = "dtc_green_can_fr3"


def _bridged_start():
    """JAX's reset(seed=0) with the can teleported 3.5 cm below the TCP
    and every actor at rest, as the fixture's recording set it up ->
    (numpy state fields, arm qpos)."""
    kw = dict(num_envs=1, obs_mode="state_dict", control_mode="pd_joint_pos",
              sim_config=dict(sim_freq=100, control_freq=20))
    env = jenvs.make("AlignFr3Env-v1", **kw)
    env.reset(seed=0)
    arm_q0 = np.asarray(env.state.world.qpos[0])[
        np.asarray(env.agent.arm_dof_ids)]
    data = jax.tree.map(lambda x: x[0], env._vmapped_data(env.state))
    tcp_p, _ = env.tcp_pose(data)
    tcp_p = tcp_p - jnp.asarray([0.0, 0.0, 0.035])
    oi = env.actor_index[CAN]
    w = env.state.world
    w = w.replace(a_pos=w.a_pos.at[:, oi].set(tcp_p),
                  a_lin=jnp.zeros_like(w.a_lin),
                  a_ang=jnp.zeros_like(w.a_ang))
    return jax_state_fields(env.state.replace(world=w)), arm_q0, kw


def test_port_replays_the_committed_grasp():
    z = np.load(FIXTURE, allow_pickle=True)
    fields, arm_q0, kw = _bridged_start()
    env = tenvs.make("AlignFr3Env-v1", device="cpu", **kw)
    names = list(env.actor_names)
    assert list(z["names"]) == names
    env.reset(seed=0)
    env._state = env_state_from_numpy(fields, device="cpu")
    a = np.zeros((1, env.action_dim), np.float32)
    a[0, :len(arm_q0)] = arm_q0
    a[0, -1] = -1.0                      # close
    qpos, apos, aquat = [], [], []
    for _ in range(STEPS):
        env.step(a)
        w = env.state.world
        qpos.append(w.qpos[0].numpy())
        apos.append(w.a_pos[0].numpy())
        aquat.append(w.a_quat[0].numpy())
    qpos, apos, aquat = np.stack(qpos), np.stack(apos), np.stack(aquat)
    assert np.isfinite(qpos).all() and np.isfinite(apos).all()
    rec = {"actors": {n: z["apos"][:, i] for i, n in enumerate(names)},
           "articulations": {"robot": z["qpos"]}}
    now = {"actors": {n: apos[:, i] for i, n in enumerate(names)},
           "articulations": {"robot": qpos}}
    m = compare_trajectories(rec, now)
    for i, n in enumerate(names):
        assert m[f"actor/{n}/rmse"] < 1e-3, (n, m)
        assert m[f"actor/{n}/max"] < 3e-3, (n, m)
        dq = np.sqrt(((aquat[:, i] - z["aquat"][:, i]) ** 2).mean())
        assert dq < 2e-3, (n, dq)
    assert m["articulation/robot/qpos_rmse"] < 1e-3, m
    # the can is held: it stays within 1 cm of its start height
    assert np.abs(apos[:, names.index(CAN), 2]
                  - fields["world"]["a_pos"][0, names.index(CAN), 2]).max() \
        < 1e-2
