"""The env axis split across devices (gsworld_tpu_torch.dist) on the CPU,
held against the port's unsharded loop and against JAX's sharding over
conftest's virtual CPU devices:

  * the mesh primitives, case for case JAX's tests/test_dist.py: a leaf
    splits by rows when its leading size divides by the mesh, else it is
    replicated; the port's row blocks are JAX's shards; gather_env_axis
    inverts the split;
  * PnpBoxFr3Env-v1 (state_dict, 4 envs) split 2 + 2 over ["cpu", "cpu"]:
    one step bit for bit the unsharded port step; ``mean_across_envs`` of
    its reward against JAX's sharded step over 2 devices from the same
    bridged state within 1e-5 (f32 physics in another operation order);
  * the AlignFr3 closed loop (4 envs, 160x120, E = 16384) split 2 + 2
    over ["cpu", "cpu"]: every observation bit for bit the unsharded port
    loop's, and its frames against JAX's render of the same state sharded
    over 2 devices (its XLA compositor, the JAX package's CPU default)
    >= 40 dB uint8 PSNR with >= 99.9% equal segmentation, the gates of
    tests/test_torch_closed_loop.py.  JAX's sharded step + render compiles
    for ~45 s on the CPU, its render alone for ~16 s: the physics of the
    split is held to JAX by the PnpBox step;
  * the scanned loop of the split (``ShardedLoop.scan_steps``) against
    the unsharded ``scan_steps``, bit for bit;
  * ``rollout_fps(shard=True)`` on a CPU env, the process group (gloo
    through a file store, one and two processes), and the sharded loop
    with JAX unavailable.

Shards hold 2 envs each: on the CPU a batch of one takes other matrix
product routines than a batch of two or more (the physics' batched
matrix-vector products round another way, ~1e-9 after a step), so a
1-env shard is not bit for bit an env of the whole batch; from 2 envs on
every row rounds alike.
"""

import dataclasses
import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsworld_tpu import envs as jenvs
from gsworld_tpu.dist import mesh as JM
from gsworld_tpu.envs.base import EnvState as JEnvState
from gsworld_tpu.render.camera import RasterConfig as JCfg
from gsworld_tpu.wrapper.gs_env import GSWorldWrapper as JWrapper
from gsworld_tpu_torch import envs
from gsworld_tpu_torch.dist import mesh as M
from gsworld_tpu_torch.dist.sharded import ShardedLoop
from gsworld_tpu_torch.envs.base import env_state_to_numpy
from gsworld_tpu_torch.physics.world import WORLD_FIELDS
from gsworld_tpu_torch.rollout.random_actions import (
    build,
    rollout_fps,
    scan_steps,
)
from torch_physics_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    numpy_to_jax_world,
    obs_tree,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, B = 160, 120, 4
SCALE = 0.02
E = 16384
STEPS = 1
SEED = 2
PSNR_MIN = 40.0
SEG_MIN = 0.999
MEAN_TOL = 1e-5
CPU2 = ["cpu", "cpu"]


def _psnr_u8(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _assert_trees_equal(got, want, what=""):
    """Nested dicts of tensors (or two tensors) equal bit for bit."""
    if torch.is_tensor(want):
        got, want = {"": got}, {"": want}
    got, want = obs_tree(got), obs_tree(want)
    assert set(got) == set(want), what
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), (what, k)


def _assert_states_equal(got, want):
    for f in WORLD_FIELDS:
        a, b = getattr(got.world, f), getattr(want.world, f)
        assert (a is None) == (b is None), f
        assert a is None or torch.equal(a, b), f
    assert torch.equal(got.elapsed, want.elapsed)
    assert torch.equal(got.prev_target, want.prev_target)
    _assert_trees_equal(got.task, want.task, "task")


def _jax_state(state):
    """The port's EnvState as a JAX EnvState (its key is unused by a
    step)."""
    f = env_state_to_numpy(state)
    return JEnvState(world=numpy_to_jax_world(f["world"]),
                     key=jnp.zeros((len(f["elapsed"]), 2), jnp.uint32),
                     elapsed=jnp.asarray(f["elapsed"]),
                     prev_target=jnp.asarray(f["prev_target"]),
                     task={k: jnp.asarray(v) for k, v in f["task"].items()})


# ------------------------------------------------------------------ #
# mesh primitives (tests/test_dist.py's cases)
# ------------------------------------------------------------------ #

def test_env_mesh_spans_devices():
    m = M.env_mesh(["cpu"] * 4)
    assert m.shape["env"] == len(m) == 4 and m.axis_name == "env"
    assert all(d == torch.device("cpu") for d in m)
    assert M.env_sharding(m).split and not M.replicated(m).split
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.env_mesh()            # no card: no silent CPU mesh
    else:
        assert len(M.env_mesh()) == torch.cuda.device_count()


@pytest.mark.parametrize("n", [2, 4])
def test_shard_env_axis_matches_jax(n):
    m = M.env_mesh(["cpu"] * n)
    jm = JM.env_mesh(jax.devices()[:n])
    x = np.arange(n * 4 * 3, dtype=np.float32).reshape(n * 4, 3)
    parts = M.shard_env_axis(torch.as_tensor(x), m)
    xs = JM.shard_env_axis(jnp.asarray(x), jm)
    assert len(xs.sharding.device_set) == n == len(parts)
    shards = sorted(xs.addressable_shards, key=lambda s: s.index[0].start)
    for got, s in zip(parts, shards):
        np.testing.assert_array_equal(got.numpy(), np.asarray(s.data))
    # a leaf whose leading size does not divide, or is 0, is replicated
    for y in (np.ones(3, np.float32), np.ones((0, 2), np.float32)):
        if y.shape[0] % n and y.shape[0]:
            ys = JM.shard_env_axis(jnp.asarray(y), jm)
            assert ys.sharding.is_fully_replicated
        for got in M.shard_env_axis(torch.as_tensor(y), m):
            np.testing.assert_array_equal(got.numpy(), y)


def test_gather_env_axis_inverts_the_split():
    rng = np.random.default_rng(0)
    state = envs.make("PnpBoxFr3Env-v1", num_envs=4, device="cpu")
    state.reset(seed=3)
    tree = dict(state=state.state,
                t=(torch.as_tensor(rng.normal(size=(4, 2))),
                   torch.tensor(2.0), None, "tag"))
    for n in (1, 2, 4):
        parts = M.shard_env_axis(tree, M.env_mesh(["cpu"] * n))
        assert len(parts) == n
        assert parts[-1]["state"].world.qpos.shape[0] == 4 // n
        back = M.gather_env_axis(parts, "cpu")
        _assert_states_equal(back["state"], tree["state"])
        assert torch.equal(back["t"][0], tree["t"][0])
        assert back["t"][1:] == tree["t"][1:]


# ------------------------------------------------------------------ #
# PnpBox: the split physics step
# ------------------------------------------------------------------ #

def test_pnp_sharded_step_matches_unsharded_and_jax():
    env = envs.make("PnpBoxFr3Env-v1", num_envs=B, obs_mode="state_dict",
                    device="cpu")
    loop = ShardedLoop(env, M.env_mesh(CPU2))
    obs, _ = env.reset(seed=1)
    s_obs, _ = loop.reset(seed=1)
    _assert_trees_equal(s_obs, obs, "reset")
    _assert_states_equal(loop.state, env.state)
    start = _jax_state(env.state)
    a = loop.action_space_sample()
    assert torch.equal(a, env.action_space_sample())   # same generator seed
    out = env.step(a)
    s_out = loop.step(a)
    for k, (x, y) in enumerate(zip(s_out, out)):
        _assert_trees_equal(x, y, k)
    _assert_states_equal(loop.state, env.state)
    mean = M.mean_across_envs(list(s_out[1].tensor_split(2)))
    assert torch.equal(mean, M.mean_across_envs(out[1]))

    jenv = jenvs.make("PnpBoxFr3Env-v1", num_envs=B, obs_mode="state_dict")
    jm = JM.env_mesh(jax.devices()[:2])

    @jax.jit
    def jstep(s, act):
        return JM.mean_across_envs(jenv._step_fn(s, act)[2])

    jmean = jstep(JM.shard_env_axis(start, jm),
                  JM.shard_env_axis(jnp.asarray(a.numpy()), jm))
    assert abs(float(mean) - float(jmean)) <= MEAN_TOL, (float(mean),
                                                         float(jmean))


def test_sharded_loop_refuses_what_it_cannot_split():
    env = envs.make("PnpBoxFr3Env-v1", num_envs=3, device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        ShardedLoop(env, M.env_mesh(CPU2))
    from gsworld_tpu_torch.envs.tasks.tabletop.franka.pnp_box import (
        PnpBoxFr3Env)
    with pytest.raises(ValueError, match="envs.make"):
        ShardedLoop(PnpBoxFr3Env(num_envs=2, device="cpu"),
                    M.env_mesh(CPU2))


# ------------------------------------------------------------------ #
# the AlignFr3 closed loop
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def align():
    """The unsharded port loop and its split over ["cpu", "cpu"], each
    reset(SEED) and stepped STEPS times with the same actions, drawn as
    rollout_fps draws them."""
    env, w = build("AlignFr3Env-v1", B, "fr3_align", 120, 40, W, H,
                   synthetic_scale=SCALE, obs_mode="rgb+segmentation",
                   max_entries=E, device="cpu")
    loop = ShardedLoop(w, M.env_mesh(CPU2))
    outs = [(w.reset(seed=SEED)[0], loop.reset(seed=SEED)[0])]
    gen = torch.Generator().manual_seed(SEED)
    for _ in range(STEPS):
        a = env.action_space_sample(gen)
        outs.append((w.step(a), loop.step(a)))
    return env, w, loop, outs


def test_sharded_loop_equals_unsharded_loop(align):
    env, w, loop, outs = align
    assert len(loop.shards) == 2 and loop.shards[1].num_envs == B // 2
    _assert_trees_equal(outs[0][1], outs[0][0], "reset")
    for i, (want, got) in enumerate(outs[1:]):
        _assert_trees_equal(got[0], want[0], f"step {i} obs")
        for k in range(1, 5):
            _assert_trees_equal(got[k], want[k], f"step {i} output {k}")
    _assert_states_equal(loop.state, env.state)
    # the frames follow the state
    rgb = outs[-1][1][0]["sensor_data"]["right_cam"]["rgb"]
    assert rgb.shape == (B, H, W, 3) and rgb.float().std() > 5.0


def test_sharded_frames_match_jax_sharded_render(align):
    env, _, loop, outs = align
    jenv = jenvs.make("AlignFr3Env-v1", num_envs=B,
                      obs_mode="rgb+segmentation")
    jenv.cameras = [dataclasses.replace(c, width=W, height=H)
                    for c in jenv.cameras]
    jw = JWrapper(jenv, "fr3_align",
                  raster_config=JCfg(backend="xla", width=W, height=H,
                                     tile=32, max_tiles_per_gaussian=64,
                                     max_entries=E, cull_alpha=True),
                  synthetic_sizes=dict(n_background=int(120_000 * SCALE),
                                       n_per_link=int(6_000 * SCALE),
                                       n_per_object=int(6_000 * SCALE)))
    jm = JM.env_mesh(jax.devices()[:2])
    jout = jw._jit_render(JM.shard_env_axis(_jax_state(loop.state), jm))
    got = outs[-1][1][0]["sensor_data"]
    for cam in ("wrist_cam", "right_cam"):
        rgb = got[cam]["rgb"].numpy()
        jrgb = np.asarray(jout[cam]["rgb"])
        assert rgb.shape == jrgb.shape == (B, H, W, 3)
        for e in range(B):
            p = _psnr_u8(rgb[e], jrgb[e])
            assert p >= PSNR_MIN, f"{cam} env {e}: PSNR {p:.1f} dB"
        seg = got[cam]["segmentation"].numpy()
        agree = np.mean(seg == np.asarray(jout[cam]["segmentation"]))
        assert agree >= SEG_MIN, f"{cam}: segmentation agreement {agree}"


def test_rollout_fps_shard_on_cpu(align):
    """On a CPU env the mesh is the CPU: the loop's first step again."""
    _, w, _, outs = align
    fps, spf, last = rollout_fps(w, 1, seed=SEED, warmup=0, shard=True)
    assert fps > 0 and spf > 0
    assert last.shape == (B, H, W, 3) and last.dtype == np.uint8
    want = outs[1][0][0]["sensor_data"][w.env.cameras[0].name]["rgb"]
    np.testing.assert_array_equal(last, want.numpy())


def test_sharded_scan_equals_unsharded_scan(align):
    """The split's scanned loop: env i of the unsharded scan, bit for bit
    (frames of env 0 at every step and every env's state)."""
    env, w, loop, _ = align
    saved = [env._state] + [s.env._state for s in loop.shards]
    try:
        acts = env.action_space_sample(torch.Generator().manual_seed(5),
                                       steps=2)
        want = scan_steps(w, acts)[0]
        got = loop.scan_steps(acts)[0]
        assert got.shape == (2, H, W, 3) and got.dtype == torch.uint8
        assert torch.equal(got, want)
        _assert_states_equal(loop.state, env.state)
    finally:
        env._state = saved[0]
        for s, st in zip(loop.shards, saved[1:]):
            s.env._state = st


# ------------------------------------------------------------------ #
# the process group
# ------------------------------------------------------------------ #

def test_init_distributed_and_all_reduce(tmp_path, caplog):
    import torch.distributed as dist
    with caplog.at_level(logging.WARNING):
        M.init_distributed(init_method="env://", rank=0, world_size=1)
    assert "did NOT form" in caplog.text and not dist.is_initialized()
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(6, 3)),
                        dtype=torch.float32)
    local = M.mean_across_envs(list(x.tensor_split(3)))
    M.init_distributed(init_method=f"file://{tmp_path}/store", rank=0,
                       world_size=1)
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        reduced = M.mean_across_envs(list(x.tensor_split(3)))
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(reduced, local, rtol=0, atol=0)
    torch.testing.assert_close(local, x.mean(0), rtol=0, atol=1e-6)


def test_mean_across_processes(tmp_path):
    """Two processes, two envs each: every process gets the mean over all
    four envs."""
    code = textwrap.dedent("""
        import sys
        import torch
        from gsworld_tpu_torch.dist.mesh import init_distributed, \\
            mean_across_envs
        rank, store = int(sys.argv[1]), sys.argv[2]
        init_distributed(init_method="file://" + store, rank=rank,
                         world_size=2)
        x = torch.arange(8, dtype=torch.float32).reshape(4, 2)
        print(mean_across_envs(x[2 * rank:2 * rank + 2]).tolist())
        torch.distributed.destroy_process_group()
    """)
    store = str(tmp_path / "store2")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), store],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "[3.0, 4.0]"


def test_sharded_loop_runs_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        from gsworld_tpu_torch.dist.mesh import env_mesh
        from gsworld_tpu_torch.dist.sharded import ShardedLoop
        from gsworld_tpu_torch.rollout.random_actions import build, \\
            rollout_fps
        env, w = build("AlignFr3Env-v1", 2, "fr3_align", 120, 40, 64, 48,
                       synthetic_scale=0.003, obs_mode="rgb+segmentation",
                       device="cpu")
        loop = ShardedLoop(w, env_mesh(["cpu", "cpu"]))
        obs, _ = loop.reset(seed=0)
        for _ in range(2):
            obs, *_ = loop.step(loop.action_space_sample())
        assert obs["sensor_data"]["right_cam"]["rgb"].shape == (2, 48, 64, 3)
        fps, _, last = rollout_fps(w, 1, warmup=0, shard=True)
        assert fps > 0 and last.shape == (2, 48, 64, 3)
        _, _, frames = rollout_fps(w, 1, warmup=0, shard=True,
                                   use_scan=True)
        assert frames.shape == (1, 48, 64, 3)
        bad = [m for m in sys.modules
               if m == "gsworld_tpu" or m.startswith("gsworld_tpu.")
               or m == "flax" or m.startswith("flax.")]
        assert not bad, bad
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")
