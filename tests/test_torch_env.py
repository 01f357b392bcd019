"""The port's env layer (gsworld_tpu_torch/envs) against the JAX
package's: controller targets, episode init as a pure function of its
draws (drawn on the CPU), and one AlignFr3Env-v1 step from a bridged
state (observation tree, evaluate flags equal, reward to 1e-4).  The
end-effector modes are tests/test_torch_ik.py's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsworld_tpu import envs as jenvs
from gsworld_tpu_torch import envs as tenvs
from gsworld_tpu_torch.envs.base import (
    env_state_from_numpy,
    env_state_to_numpy,
)
from gsworld_tpu_torch.envs.tasks.tabletop.franka.align import AlignFr3Env
from torch_physics_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    X_OFFSET,
    jax_world_to_numpy,
    rel_err,
)

B = 2


@pytest.fixture(scope="module")
def pair():
    jenv = jenvs.make("AlignFr3Env-v1", num_envs=B)
    tenv = tenvs.make("AlignFr3Env-v1", num_envs=B, device="cpu")
    return jenv, tenv


@pytest.mark.parametrize("mode", ["pd_joint_delta_pos", "pd_joint_pos"])
def test_compute_targets(pair, mode):
    jenv, tenv = pair
    jc, tc = jenv.agent.controller(mode), tenv.agent.controller(mode)
    assert jc.action_dim == tc.action_dim == 8
    for a, b in zip(jc.gains(), tc.gains()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    lim = tenv.agent.model.qlimits
    q = rng.uniform(lim[:, 0], lim[:, 1], (16, 9)).astype(np.float32)
    prev = rng.uniform(lim[:, 0], lim[:, 1], (16, 9)).astype(np.float32)
    # beyond [-1, 1] too: the clip comes before the rescale
    act = rng.uniform(-1.5, 1.5, (16, 8)).astype(np.float32)
    want = jc.compute_targets(jnp.asarray(q), jnp.asarray(prev),
                              jnp.asarray(act))
    got = tc.compute_targets(torch.as_tensor(q), torch.as_tensor(prev),
                             torch.as_tensor(act))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6
    assert torch.equal(torch.as_tensor(prev), torch.as_tensor(prev.copy()))


def test_draws_come_from_a_cpu_generator():
    """reset(seed)'s episode draws and the env's own actions come from
    CPU generators, so a seed means one episode on every device."""
    env = AlignFr3Env(num_envs=3, device="cpu")
    want = torch.rand((3, env.episode_draws),
                      generator=torch.Generator("cpu").manual_seed(11))
    assert torch.equal(env.episode_draws_for(11), want)
    ep, dr = env.reset_draws(11)
    assert torch.equal(ep, want) and dr.shape == (3, 0)
    env.reset(seed=11)
    a = env.action_space_sample()
    gen = torch.Generator("cpu").manual_seed(12)
    assert torch.equal(a, torch.rand((3, 8), generator=gen) * 2.0 - 1.0)


def test_cli_takes_the_bench_configuration():
    from gsworld_tpu_torch.rollout.random_actions import parse_args
    a = parse_args([])
    assert (a.obs_mode, a.tile, a.max_tiles_per_gaussian, a.max_entries) \
        == ("rgb+segmentation", 32, 64, 393216)
    a = parse_args(["--obs_mode", "rgb", "--tile", "16",
                    "--max_tiles_per_gaussian", "16", "--max_entries", "4096"])
    assert (a.obs_mode, a.tile, a.max_tiles_per_gaussian, a.max_entries) \
        == ("rgb", 16, 16, 4096)


def _bad(obj0, obj1, goal):
    return ((np.linalg.norm(obj0 - obj1, axis=-1) < 0.1)
            | (np.linalg.norm(obj0 - goal, axis=-1) < 0.15))


def test_reset_ranges_and_rejection_rule():
    env = AlignFr3Env(num_envs=256, device="cpu")
    draws = env.episode_draws_for(seed=3)
    assert draws.shape == (256, 38)
    assert float(draws.min()) >= 0.0 and float(draws.max()) < 1.0
    env.reset(seed=3)
    w = env.state.world
    p = w.a_pos.numpy()
    xo = X_OFFSET
    assert (p[:, 0, 0] >= xo - 0.2).all() and (p[:, 0, 0] <= xo - 0.15).all()
    assert (p[:, 0, 1] >= 0.1).all() and (p[:, 0, 1] <= 0.2).all()
    assert (p[:, 2, 0] >= xo - 0.25).all() and (p[:, 2, 0] <= xo - 0.05).all()
    assert (p[:, 2, 1] >= -0.2).all() and (p[:, 2, 1] <= -0.1).all()
    assert (p[:, 1, 0] >= xo - 0.25).all() and (p[:, 1, 0] <= xo + 0.0001).all()
    assert (p[:, 1, 1] >= 0.1).all() and (p[:, 1, 1] <= 0.2).all()
    np.testing.assert_allclose(p[:, :, 2], np.tile([0.065, 0.05, 0.068],
                                                   (256, 1)), atol=1e-7)
    # the goal is never within 0.15 of the green can in these ranges, so
    # every accepted red can keeps 0.1 from the green one
    assert not _bad(p[:, 0], p[:, 1], p[:, 2]).any()
    assert len(np.unique(p[:, 0, 0])) > 200
    np.testing.assert_array_equal(
        w.qpos.numpy(), np.tile(env.state.prev_target.numpy()[:1], (256, 1)))
    assert w.contact_lam.shape == (256, 180, 6)
    # the same seed gives the same episode, another seed another
    env2 = AlignFr3Env(num_envs=256, device="cpu")
    env2.reset(seed=3)
    assert torch.equal(env2.state.world.a_pos, w.a_pos)
    env2.reset(seed=4)
    assert not torch.equal(env2.state.world.a_pos, w.a_pos)


@pytest.mark.parametrize("case", ["accepted_at_once", "third_round",
                                  "never_accepted"])
def test_initialize_episode_from_given_draws(case):
    """The sampler is a pure function of its draws.  Inside [0, 1) the
    AlignFr3 ranges never reject (the first try sits >= 0.1 off in x), so
    the rejection rounds are driven with a draw from outside."""
    env = AlignFr3Env(num_envs=1, device="cpu")
    xo = X_OFFSET
    u = np.full((1, 38), 0.5, np.float32)
    green = np.array([xo - 0.175, 0.15, 0.065])
    on_green = (0.375, 0.5)         # a round's draws that hit the green can
    if case != "accepted_at_once":
        u[0, 4] = -1.0              # first try 0.05 from the green can: bad
        rounds = 2 if case == "third_round" else 16
        for r in range(rounds):
            u[0, 6 + 2 * r], u[0, 7 + 2 * r] = on_green
        if case == "third_round":
            u[0, 10], u[0, 11] = 1.0 - 1e-6, 0.5     # accepted
            u[0, 12::2], u[0, 13::2] = on_green      # later rounds ignored
    ep = env._initialize_episode(torch.as_tensor(u))
    p = ep.a_pos.numpy()[0]
    np.testing.assert_allclose(p[0], green, atol=1e-6)
    np.testing.assert_allclose(p[2], [xo - 0.15, -0.15, 0.068], atol=1e-6)
    if case == "accepted_at_once":
        np.testing.assert_allclose(p[1], [green[0] + 0.125, 0.15, 0.05],
                                   atol=1e-6)
        assert not _bad(p[0], p[1], p[2])
    elif case == "third_round":
        np.testing.assert_allclose(p[1], [xo - 0.05, 0.15, 0.05], atol=1e-5)
        assert not _bad(p[0], p[1], p[2])
    else:
        # 16 bad rounds: the last sample stands, as the bounded loop of
        # the JAX package leaves it
        np.testing.assert_allclose(p[1, :2], green[:2], atol=1e-5)
        assert _bad(p[0], p[1], p[2])
    assert ep.qpos.shape == (1, 9) and ep.a_quat.shape == (1, 3, 4)
    np.testing.assert_allclose(np.linalg.norm(ep.a_quat.numpy(), axis=-1),
                               1.0, atol=1e-6)


def _tree(obs, prefix=""):
    out = {}
    for k, v in obs.items():
        if isinstance(v, dict):
            out.update(_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_reset_quats_match_jax(pair):
    jenv, tenv = pair
    jenv.reset(seed=0)
    tenv.reset(seed=0)
    np.testing.assert_allclose(tenv.state.world.a_quat.numpy(),
                               np.asarray(jenv.state.world.a_quat), atol=1e-6)
    np.testing.assert_array_equal(tenv.state.world.qpos.numpy(),
                                  np.asarray(jenv.state.world.qpos))


@pytest.fixture(scope="module")
def stepped(pair):
    """Both envs step once from the JAX env's reset state, bridged."""
    jenv, tenv = pair
    jobs0, _ = jenv.reset(seed=5)
    js = jenv.state
    fields = dict(world=jax_world_to_numpy(js.world),
                  elapsed=np.asarray(js.elapsed),
                  prev_target=np.asarray(js.prev_target), task={})
    tenv.reset(seed=0)
    tenv._state = env_state_from_numpy(fields, device="cpu")
    act = np.random.default_rng(6).uniform(-1, 1, (B, 8)).astype(np.float32)
    jout = jenv.step(jnp.asarray(act))
    tout = tenv.step(act)
    return jout, tout, fields


def test_step_observation_tree(pair, stepped):
    jout, tout, _ = stepped
    jobs, tobs = _tree(jout[0]), _tree(tout[0])
    assert set(jobs) == set(tobs)
    assert {"agent/qpos", "extra/tcp_pose", "extra/obj_pose",
            "sensor_param/wrist_cam/extrinsic_cv"} <= set(tobs)
    for k, jv in jobs.items():
        tv = tobs[k].numpy()
        jv = np.asarray(jv)
        assert tv.shape == jv.shape, k
        assert tv.dtype == jv.dtype, (k, tv.dtype, jv.dtype)
        if jv.dtype == bool:
            np.testing.assert_array_equal(tv, jv, err_msg=k)
        else:
            assert np.abs(tv - jv).max() <= 1e-5 * max(np.abs(jv).max(), 1.0), k


def test_step_flags_reward_and_state(pair, stepped):
    jout, tout, _ = stepped
    jenv, tenv = pair
    _, jr, jterm, jtrunc, jinfo = jout
    _, tr, tterm, ttrunc, tinfo = tout
    assert set(jinfo) == set(tinfo)
    for k in jinfo:
        assert tinfo[k].dtype == torch.bool
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                      err_msg=k)
    assert tr.dtype == torch.float32 and tr.shape == (B,)
    assert np.abs(tr.numpy() - np.asarray(jr)).max() <= 1e-4
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
    assert tenv.state.elapsed.dtype == torch.int32
    np.testing.assert_array_equal(tenv.state.elapsed.numpy(),
                                  np.asarray(jenv.state.elapsed))
    assert rel_err(tenv.state.prev_target.numpy(),
                   jenv.state.prev_target) <= 1e-6
    assert rel_err(tenv.state.world.qpos.numpy(),
                   jenv.state.world.qpos) <= 1e-5
    jsd, tsd = jenv.get_state_dict(), tenv.get_state_dict()
    assert set(jsd["actors"]) == set(tsd["actors"])
    for k in jsd["actors"]:
        assert tsd["actors"][k].shape == np.asarray(jsd["actors"][k]).shape
    assert tsd["articulations"]["fr3_umi"].shape == (B, 18)


@pytest.mark.parametrize("mode", ["sparse", "none"])
def test_reward_modes(stepped, mode):
    _, _, fields = stepped
    env = tenvs.make("AlignFr3Env-v1", num_envs=B, reward_mode=mode,
                     device="cpu")
    env.reset(seed=0)
    env._state = env_state_from_numpy(fields, device="cpu")
    _, r, *_ = env.step(np.zeros(8, np.float32))
    assert r.dtype == torch.float32 and float(r.abs().max()) == 0.0


def test_env_state_bridge_round_trip(stepped):
    _, _, fields = stepped
    back = env_state_to_numpy(env_state_from_numpy(fields, device="cpu"))
    for f, v in fields["world"].items():
        np.testing.assert_array_equal(back["world"][f], v)
    np.testing.assert_array_equal(back["elapsed"], fields["elapsed"])
    np.testing.assert_array_equal(back["prev_target"], fields["prev_target"])


def test_dense_reward_branches():
    """Every term of the dense reward, on hand-made info flags."""
    env = AlignFr3Env(num_envs=4, device="cpu")
    env.reset(seed=0)
    data = env._env_data(env.state)
    f = lambda *v: torch.tensor(v)                          # noqa: E731
    info = dict(is_grasped_0=f(False, True, False, False),
                is_grasped_1=f(False, True, False, False),
                is_obj_in_box=f(False, False, True, True),
                is_obj_static=f(True, True, True, True),
                is_robot_static=f(True, True, False, True),
                success=f(False, False, False, True))
    r = env.compute_dense_reward(data, None, info).numpy()
    tcp = env.tcp_pose(data)[0].numpy()
    p0 = data["world"].a_pos[:, 0].numpy()
    pg = data["world"].a_pos[:, 2].numpy()
    reach = 1 - np.tanh(5 * np.linalg.norm(p0 - tcp, axis=-1))
    transport = 1 - np.tanh(5 * np.linalg.norm(pg - p0, axis=-1))
    want = [reach[0], reach[1] + 1 + transport[1], reach[2] + 2, 6.0]
    np.testing.assert_allclose(r, want, atol=1e-6)
    np.testing.assert_allclose(
        env.compute_normalized_dense_reward(data, None, info).numpy(),
        np.asarray(want) / 6.0, atol=1e-6)


def test_registry_and_facade():
    assert set(tenvs.registered_envs()) == set(jenvs.registered_envs()) == {
        "AlignFr3Env-v1", "PnpBoxFr3Env-v1", "PourMustardFr3Env-v1",
        "StackFr3Env-v1", "AlignXArmEnv-v1", "BananaRotationXArmEnv-v1",
        "SpoonOnBoardXArmEnv-v1", "RealFr3-v1", "RealXArm6-v1"}
    with pytest.raises(KeyError, match="unknown env id"):
        tenvs.make("NoSuchEnv-v0")
    env = tenvs.make("AlignFr3Env-v1", num_envs=3, device="cpu",
                     sim_config=dict(sim_freq=100, control_freq=50))
    assert env.scene.substeps == 2 and env.max_episode_steps == 100
    # graph=True is the default and means nothing on the CPU
    assert env.graph and not env._graphs
    g = torch.Generator().manual_seed(1)
    a1 = env.action_space_sample(g)
    a2 = env.action_space_sample(torch.Generator().manual_seed(1))
    assert torch.equal(a1, a2) and a1.shape == (3, 8)
    assert float(a1.min()) >= -1.0 and float(a1.max()) < 1.0
    env.reset(seed=0)
    env.step(a1[0])                       # one action for every env
    assert not env._graphs
    assert int(env.state.elapsed[0]) == 1
    base = tenvs.make("RealFr3-v1", num_envs=2, device="cpu")
    obs, _ = base.reset(seed=0)
    assert obs["agent"]["qpos"].shape == (2, 9)
    assert base.state.world.a_pos.shape == (2, 0, 3)


def test_default_device_is_the_card():
    import inspect

    from gsworld_tpu_torch.envs.base import GsBaseEnv
    from gsworld_tpu_torch.physics.builders import make_scene
    from gsworld_tpu_torch.rollout.random_actions import build
    for fn in (GsBaseEnv.__init__, make_scene, build, env_state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # describing an env touches no device: this runs without a card
    env = AlignFr3Env(num_envs=2)
    assert env.device.type == "cuda" and env.actor_names[0].startswith("dtc")
