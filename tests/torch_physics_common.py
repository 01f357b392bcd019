"""Shared helpers of the tests/test_torch_*.py files that hold the port's
physics, env and closed loop against the JAX package: numpy bridges in
both directions, hand-made AlignFr3 layouts, and comparisons relative to
each field's largest value."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsworld_tpu.physics.world import WorldState as JWorldState
from gsworld_tpu_torch import constants
from gsworld_tpu_torch.envs.base import env_state_from_numpy
from gsworld_tpu_torch.physics.world import WORLD_FIELDS, world_state_from_numpy



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's physics on the CPU is thousands of tiny operations that
    gain nothing from intra-op threads; one thread per test process keeps
    parallel test workers from oversubscribing the cores.  Restored after
    the module.  A test module takes it by importing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


X_OFFSET = 0.615
UPRIGHT = np.array([np.cos(np.pi / 4), np.sin(np.pi / 4), 0, 0], np.float32)
RACK_Q = np.array([np.cos(np.pi / 4), 0, 0, -np.sin(np.pi / 4)], np.float32)


def jax_world_to_numpy(w):
    """Batched JAX WorldState -> dict of numpy arrays, field by field."""
    return {f: np.asarray(getattr(w, f)) for f in WORLD_FIELDS}


def numpy_to_jax_world(d):
    return JWorldState(**{f: jnp.asarray(d[f]) for f in WORLD_FIELDS})


def torch_world(d):
    return world_state_from_numpy(d, device="cpu")


def rel_err(got, want, floor=1e-12):
    """max |got - want| / max(max |want|, floor), on numpy arrays.  The
    floor is the scale below which a field is noise around zero (the
    velocity of a body at rest)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


def blank_world(B, n_rows, n_la, rng=None):
    """A world of B envs at the task-init pose: both cans upright at rest
    on the table, the rack in its goal range; everything else zero."""
    q = np.tile(np.asarray(constants.fr3_umi_task_init_qpos, np.float32),
                (B, 1))
    a_pos = np.tile(np.array([[X_OFFSET - 0.18, 0.15, 0.065],
                              [X_OFFSET - 0.05, 0.12, 0.05],
                              [X_OFFSET - 0.15, -0.15, 0.068]], np.float32),
                    (B, 1, 1))
    if rng is not None:
        a_pos[:, :, :2] += rng.uniform(-0.01, 0.01, (B, 3, 2))
    a_quat = np.tile(np.stack([UPRIGHT, UPRIGHT, RACK_Q]), (B, 1, 1))
    z = lambda *s: np.zeros(s, np.float32)                    # noqa: E731
    root_quat = z(B, 4)
    root_quat[:, 0] = 1.0
    return dict(qpos=q, qvel=z(B, 9), root_pos=z(B, 3), root_quat=root_quat,
                a_pos=a_pos.astype(np.float32), a_quat=a_quat,
                a_lin=z(B, 3, 3), a_ang=z(B, 3, 3), la_forces=z(B, n_la, 3),
                contact_lam=z(B, n_rows, 6),
                a_friction=np.full((B, 3), 0.6, np.float32),
                a_scale=np.ones((B, 3), np.float32))


def pinched_world(B, n_rows, n_la, tcp_pos, finger_q=0.0325):
    """The green can between the fingers, 3.5 cm below the TCP, with the
    fingers closed onto its radius of 3.3 cm (0.5 mm of penetration each
    side); ``tcp_pos`` (3,) is the TCP position at the task-init pose."""
    d = blank_world(B, n_rows, n_la)
    d["qpos"][:, 7:] = finger_q
    d["a_pos"][:, 0] = np.asarray(tcp_pos, np.float32) - np.array(
        [0.0, 0.0, 0.035], np.float32)
    return d


def lifted_world(B, n_rows, n_la):
    """Everything apart: cans and rack 30 cm above the table."""
    d = blank_world(B, n_rows, n_la)
    d["a_pos"][:, :, 2] += 0.3
    return d


def jit_vmap(fn):
    return jax.jit(jax.vmap(fn))


# ---------------------------------------------------------------------- #
# task envs: JAX-derived draws, bridged states, observation trees
# ---------------------------------------------------------------------- #

# how many keys each JAX task sampler splits its episode key into
SAMPLER_KEYS = {
    "PnpBoxFr3Env-v1": 6, "PourMustardFr3Env-v1": 8, "StackFr3Env-v1": 6,
    "AlignXArmEnv-v1": 8, "BananaRotationXArmEnv-v1": 2,
    "SpoonOnBoardXArmEnv-v1": 4,
}


def jax_episode_draws(env_id, seed, B):
    """The port's (B, episode_draws) for the episodes JAX's ``reset(seed)``
    lays out: ``jax.random.uniform(ks[i])`` of each env's episode key,
    one per scalar the JAX sampler draws, in the order the port's sampler
    reads them.  PourMustard's resampling rounds draw from a key chain
    (``k, k1, k2 = split(k, 3)`` from ks[5]): rounds 1-16 come after the
    swap draw of ks[6]."""
    out = []
    for key in jax.random.split(jax.random.PRNGKey(seed), B):
        init_key = jax.random.split(key, 3)[0]
        ks = jax.random.split(init_key, SAMPLER_KEYS[env_id])
        u = [float(jax.random.uniform(k)) for k in ks]
        if env_id == "PourMustardFr3Env-v1":
            rounds, k = [], ks[5]
            for _ in range(16):
                k, k1, k2 = jax.random.split(k, 3)
                rounds += [float(jax.random.uniform(k1)),
                           float(jax.random.uniform(k2))]
            u = u[:5] + [u[6]] + rounds
        out.append(u)
    return np.asarray(out, np.float32)


def jax_eager_episodes(jenv, seed):
    """JAX's sampler run op by op (``jax.disable_jit``) on each env's
    episode key of ``reset(seed)`` -> dict of stacked numpy arrays.  Under
    jit XLA contracts u * a + b into one FMA and folds constants, which
    moves a coordinate by up to one ulp; op by op every operation rounds
    as the port's does."""
    eps = []
    with jax.disable_jit():
        for key in jax.random.split(jax.random.PRNGKey(seed), jenv.num_envs):
            eps.append(jenv._initialize_episode(jax.random.split(key, 3)[0]))
    out = {f: np.stack([np.asarray(getattr(e, f)) for e in eps])
           for f in ("qpos", "a_pos", "a_quat")}
    out["task"] = {k: np.stack([np.asarray(e.task[k]) for e in eps])
                   for k in eps[0].task}
    return out


def jax_state_fields(js):
    """A JAX EnvState as the port's ``env_state_from_numpy`` takes it
    (writable copies)."""
    return dict(world={f: np.array(v)
                       for f, v in jax_world_to_numpy(js.world).items()},
                elapsed=np.array(js.elapsed),
                prev_target=np.array(js.prev_target),
                task={k: np.array(v) for k, v in js.task.items()})


def obs_tree(obs, prefix=""):
    out = {}
    for k, v in obs.items():
        if isinstance(v, dict):
            out.update(obs_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def assert_obs_match(jobs, tobs, tol=1e-5):
    """Same keys, shapes and dtypes; flags equal, numbers within ``tol``
    of each leaf's largest value (at least 1)."""
    jobs, tobs = obs_tree(jobs), obs_tree(tobs)
    assert set(jobs) == set(tobs), set(jobs) ^ set(tobs)
    for k, jv in jobs.items():
        tv, jv = tobs[k].cpu().numpy(), np.asarray(jv)
        assert tv.shape == jv.shape and tv.dtype == jv.dtype, (
            k, tv.shape, jv.shape, tv.dtype, jv.dtype)
        if jv.dtype == bool:
            np.testing.assert_array_equal(tv, jv, err_msg=k)
        else:
            assert np.abs(tv - jv).max() <= tol * max(np.abs(jv).max(),
                                                      1.0), k


def assert_info_match(jinfo, tinfo, tol=1e-4):
    """Flags equal; number-valued entries (a pour's state, a rotation in
    degrees) within ``tol`` of their largest value (at least 1)."""
    assert set(jinfo) == set(tinfo)
    for k, jv in jinfo.items():
        jv, tv = np.asarray(jv), tinfo[k].cpu().numpy()
        assert tv.dtype == jv.dtype, (k, tv.dtype, jv.dtype)
        if jv.dtype == bool:
            np.testing.assert_array_equal(tv, jv, err_msg=k)
        else:
            assert np.abs(tv - jv).max() <= tol * max(np.abs(jv).max(),
                                                      1.0), k


def check_reset_layout(env_id, jenv, tenv, seed):
    """The port's sampler on JAX-derived draws lays out JAX's episodes of
    ``reset(seed)``: bit for bit against JAX's sampler op by op, within
    one ulp (6e-8) of JAX's jitted reset."""
    # (Stack splits 6 keys and reads 4: the unread ones are dropped)
    draws = jax_episode_draws(env_id, seed, jenv.num_envs)
    draws = draws[:, :tenv.episode_draws]
    assert draws.shape == (jenv.num_envs, tenv.episode_draws)
    ep = tenv._initialize_episode(torch.as_tensor(draws))
    want = jax_eager_episodes(jenv, seed)
    for f in ("qpos", "a_pos", "a_quat"):
        got = getattr(ep, f).numpy()
        assert got.dtype == want[f].dtype, f
        np.testing.assert_array_equal(got, want[f], err_msg=f)
    assert set(ep.task) == set(want["task"])
    for k, v in want["task"].items():
        assert ep.task[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(ep.task[k].numpy(), v, err_msg=k)
    jenv.reset(seed=seed)
    jw = jenv.state.world
    assert np.abs(ep.a_pos.numpy() - np.asarray(jw.a_pos)).max() <= 6e-8
    np.testing.assert_array_equal(ep.a_quat.numpy(), np.asarray(jw.a_quat))


def step_pair(jenv, tenv, seed, act_seed, prepare=None):
    """Both envs step once from JAX's ``reset(seed)`` state, bridged
    (``prepare`` edits its numpy fields first) -> (JAX step outputs, the
    port's, the bridged fields)."""
    jenv.reset(seed=seed)
    fields = jax_state_fields(jenv.state)
    if prepare is not None:
        prepare(fields)
    jenv._state = jenv.state.replace(
        world=numpy_to_jax_world(fields["world"]),
        task={k: jnp.asarray(v) for k, v in fields["task"].items()})
    tenv.reset(seed=0)
    tenv._state = env_state_from_numpy(fields, device="cpu")
    rng = np.random.default_rng(act_seed)
    act = rng.uniform(-1, 1, (jenv.num_envs, jenv.action_dim)).astype(
        np.float32)
    return jenv.step(jnp.asarray(act)), tenv.step(act), fields


STATIC_LIN = 0.05          # actor_is_static's threshold = max_pen_vel


def speed_ties(jenv):
    """(B,) envs where an actor leaves the step at the solver's
    depenetration speed cap (SolverParams.max_pen_vel, 0.05 m/s), which
    is also actor_is_static's threshold: its speed lands on 0.05 within
    rounding in both packages, so a "static" flag there is a coin flip."""
    speed = np.linalg.norm(np.asarray(jenv.state.world.a_lin), axis=-1)
    return (np.abs(speed - STATIC_LIN) < 1e-6).any(axis=-1)


def check_step(jenv, tenv, jout, tout, state_tol=1e-5):
    """Observation tree, flags, reward (1e-4), termination and the state
    after one step.  A "static" flag (and what follows from it: success,
    reward, termination) may differ only in an env where an actor's speed
    ties with the threshold (``speed_ties``)."""
    jobs, jr, jterm, jtrunc, jinfo = jout
    tobs, tr, tterm, ttrunc, tinfo = tout
    ties = speed_ties(jenv)
    flipped = np.zeros(jenv.num_envs, bool)
    for k in jinfo:
        if "static" in k or k == "success":
            d = tinfo[k].numpy() != np.asarray(jinfo[k])
            assert not (d & ~ties).any(), (k, d, ties)
            flipped |= d
    keep = ~flipped
    assert_obs_match(jobs, tobs)
    assert_info_match({k: np.asarray(v)[keep] for k, v in jinfo.items()},
                      {k: v[torch.as_tensor(keep)] for k, v in tinfo.items()})
    assert tr.dtype == torch.float32 and tr.shape == (jenv.num_envs,)
    assert np.abs(tr.numpy() - np.asarray(jr))[keep].max(initial=0) <= 1e-4
    np.testing.assert_array_equal(tterm.numpy()[keep], np.asarray(jterm)[keep])
    np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
    for f in ("qpos", "a_pos", "a_quat"):
        assert rel_err(getattr(tenv.state.world, f).numpy(),
                       getattr(jenv.state.world, f)) <= state_tol, f
    assert rel_err(tenv.state.prev_target.numpy(),
                   jenv.state.prev_target) <= 1e-6
    assert set(tenv.state.task) == set(jenv.state.task)
    for k, v in jenv.state.task.items():
        v = np.asarray(v)
        got = tenv.state.task[k].numpy()
        assert got.dtype == v.dtype, k
        if v.dtype == bool:
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            assert np.abs(got - v).max() <= 1e-6 * max(np.abs(v).max(), 1), k
