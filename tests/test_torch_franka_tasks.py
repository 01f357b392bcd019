"""The port's other Franka tasks (PnpBox, PourMustard, Stack) against the
JAX package's: the episode layout from JAX-derived draws (bit for bit
against JAX's sampler run op by op, one ulp against its jitted reset),
one step from a bridged state (observation tree to 1e-5, evaluate flags
equal, reward to 1e-4, state to 1e-5), PourMustard's sticky task state
step by step, its bounded resampling as masked rounds, and the seeded
reset."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsworld_tpu import envs as jenvs
from gsworld_tpu_torch import envs as tenvs
from gsworld_tpu_torch.core.maths import axis_angle_to_quat
from gsworld_tpu_torch.envs.tasks.tabletop.franka.pour_mustard import (
    PourMustardFr3Env,
)
from torch_physics_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    X_OFFSET,
    check_reset_layout,
    check_step,
    step_pair,
)

TASKS = ["PnpBoxFr3Env-v1", "PourMustardFr3Env-v1", "StackFr3Env-v1"]
B = 2
_PAIRS = {}


def pair(env_id):
    """(JAX env, port env) of ``env_id`` at B envs, built once."""
    if env_id not in _PAIRS:
        _PAIRS[env_id] = (jenvs.make(env_id, num_envs=B),
                          tenvs.make(env_id, num_envs=B, device="cpu"))
    return _PAIRS[env_id]


@pytest.mark.parametrize("env_id", TASKS)
def test_reset_layout_from_jax_draws(env_id):
    check_reset_layout(env_id, *pair(env_id), seed=3)


@pytest.mark.parametrize("env_id", TASKS)
def test_step_matches_jax(env_id):
    jenv, tenv = pair(env_id)
    jout, tout, _ = step_pair(jenv, tenv, seed=5, act_seed=6)
    check_step(jenv, tenv, jout, tout)
    assert tenv.actor_names == tuple(jenv.scene.actors.names)
    assert tenv.max_episode_steps == jenv.max_episode_steps


@pytest.mark.parametrize("env_id", TASKS)
def test_reset_is_seeded(env_id):
    env = tenvs.make(env_id, num_envs=8, device="cpu")
    env.reset(seed=1)
    a = env.state.world.a_pos.clone()
    env.reset(seed=1)
    assert torch.equal(env.state.world.a_pos, a)
    env.reset(seed=2)
    assert not torch.equal(env.state.world.a_pos, a)
    assert len(torch.unique(a[:, 0, 0])) == 8
    assert env.state.world.contact_lam.shape[1] > 0


def test_has_poured_is_sticky():
    """A tilted bottle above the bread latches has_poured and adds 0.1 to
    pouring_state; moved away, has_poured stays and pouring_state holds,
    in both packages step by step (env 1 is left where it was)."""
    jenv, tenv = pair("PourMustardFr3Env-v1")
    oi, gi = tenv.actor_index["006_mustard_bottle"], tenv.actor_index[
        "bread_slice"]
    tilted = axis_angle_to_quat(torch.tensor([np.pi / 3, 0.0, 0.0])).numpy()

    def tilt_over_bread(f):
        w = f["world"]
        w["a_pos"][0, oi, :2] = w["a_pos"][0, gi, :2]
        w["a_quat"][0, oi] = tilted
        w["qpos"][:] = w["qpos"][:1]

    jout, tout, _ = step_pair(jenv, tenv, seed=0, act_seed=1,
                              prepare=tilt_over_bread)
    check_step(jenv, tenv, jout, tout, state_tol=1e-4)
    task = tenv.state.task
    assert task["has_poured"].tolist() == [True, False]
    assert task["pouring_state"][0] == pytest.approx(0.1)
    assert float(task["pouring_state"][1]) == 0.0
    # away from the bread in both packages: the flag sticks
    jw, tw = jenv.state.world, tenv.state.world
    jenv._state = jenv.state.replace(world=jw.replace(
        a_pos=jw.a_pos.at[:, oi, 0].add(0.5)))
    a_pos = tw.a_pos.clone()
    a_pos[:, oi, 0] += 0.5
    tenv._state = tenv.state.replace(world=tw.replace(a_pos=a_pos))
    zero = np.zeros((B, tenv.action_dim), np.float32)
    jout, tout = jenv.step(jnp.asarray(zero)), tenv.step(zero)
    assert tout[4]["has_poured"].tolist() == [True, False]
    np.testing.assert_array_equal(tout[4]["has_poured"].numpy(),
                                  np.asarray(jout[4]["has_poured"]))
    np.testing.assert_allclose(tenv.state.task["pouring_state"].numpy(),
                               np.asarray(jenv.state.task["pouring_state"]),
                               atol=1e-7)
    assert tenv.state.task["pouring_state"][0] == pytest.approx(0.1)


@pytest.mark.parametrize("case", ["accepted_at_once", "third_round",
                                  "never_accepted"])
def test_pour_resampling_rounds(case):
    """The bread is resampled while it lies within 0.15 m (xy) of the
    bottle, at most 16 rounds, as masked rounds over the batch; inside
    [0, 1) the ranges never reject, so draws from outside drive it."""
    env = PourMustardFr3Env(num_envs=1, device="cpu")
    xo = X_OFFSET
    u = np.full((1, env.episode_draws), 0.5, np.float32)
    u[0, 5] = 0.0                                  # no swap
    bottle = np.array([xo - 0.2, 0.15])
    on_bottle = (0.5, 3.5)          # a round's draws that hit the bottle
    if case != "accepted_at_once":
        u[0, 4] = 3.5               # the first bread sits on the bottle
        rounds = 2 if case == "third_round" else 16
        for r in range(rounds):
            u[0, 6 + 2 * r], u[0, 7 + 2 * r] = on_bottle
        if case == "third_round":
            u[0, 10], u[0, 11] = 0.5, 0.5          # accepted
            u[0, 12::2], u[0, 13::2] = on_bottle   # later rounds ignored
    ep = env._initialize_episode(torch.as_tensor(u))
    p = ep.a_pos.numpy()[0]
    np.testing.assert_allclose(p[0, :2], bottle, atol=1e-6)
    d = np.linalg.norm(p[0, :2] - p[1, :2])
    if case == "never_accepted":
        np.testing.assert_allclose(p[1, :2], bottle, atol=1e-5)
        assert d < 0.15
    else:
        np.testing.assert_allclose(p[1, :2], [xo - 0.2, -0.15], atol=1e-6)
        assert d >= 0.15
    assert ep.task["has_poured"].dtype == torch.bool
    assert ep.task["pouring_state"].shape == (1,)


def test_pnp_swap_and_success():
    """Half the draws swap bottle and box; a bottle resting in the box,
    released, is a success."""
    env = tenvs.make("PnpBoxFr3Env-v1", num_envs=2, device="cpu")
    u = torch.tensor([[0.1, 0.2, 0.3, 0.4, 0.0, 0.4],
                      [0.1, 0.2, 0.3, 0.4, 0.0, 0.6]])
    p = env._initialize_episode(u).a_pos
    torch.testing.assert_close(p[0, 0, :2], p[1, 1, :2])
    torch.testing.assert_close(p[0, 1, :2], p[1, 0, :2])
    env.reset(seed=0)
    w = env.state.world
    a_pos = w.a_pos.clone()
    a_pos[:, 0, :2] = a_pos[:, 1, :2]
    env._state = env.state.replace(world=w.replace(a_pos=a_pos))
    info = env.evaluate(env._env_data(env.state))
    assert info["is_obj_in_box"].all() and info["success"].all()
