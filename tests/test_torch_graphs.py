"""The port's compiled programs on the CPU: the reset split into its host
layout and its device tail, densify at JAX's fixed shapes, and the CUDA
graph classes of the render, the resets, the collision check and densify.

On the CPU nothing captures, so the graph classes are built here with a
stand-in for ``utils.cuda_graph.capture`` (patched in these tests only)
whose ``replay()`` runs the captured body again and writes what it
returns into the capture's outputs, as a replay rewrites a graph's static
outputs.  Each class then returns the eager results bit for bit, leaves a
call's outputs as they were after the next call, copies its inputs
rather than aliasing them, and leaves the caller's inputs as they were.
Scenes are tiny (2 envs, 160x120).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsworld_tpu.gs import synthetic as jsynthetic
from gsworld_tpu.gs.model import GaussianScene as JScene
from gsworld_tpu.gs.model import scene_from_splats as j_scene_from_splats
from gsworld_tpu.train3dgs import densify as jdensify
from gsworld_tpu_torch import envs as tenvs
from gsworld_tpu_torch.core.maths import quat_normalize, quat_rotate
from gsworld_tpu_torch.envs.base import EnvState, _clone_state
from gsworld_tpu_torch.gs.model import (
    SCENE_FIELDS,
    GaussianScene,
    scene_from_numpy,
    scene_to_numpy,
)
from gsworld_tpu_torch.physics.world import (
    WORLD_FIELDS,
    WorldState,
    contact_row_count,
)
from gsworld_tpu_torch.render.camera import RasterConfig
from gsworld_tpu_torch.rollout.planner.rrt import make_collision_checker
from gsworld_tpu_torch.train3dgs import densify
from gsworld_tpu_torch.train3dgs import train as ttrain
from gsworld_tpu_torch.train3dgs.optim import adam_init, zero_rows
from gsworld_tpu_torch.utils import cuda_graph
from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper, world_poses
from torch_physics_common import one_torch_thread  # noqa: F401 (autouse)

W, H, B = 160, 120, 2
SIZES = dict(n_background=2400, n_per_link=120, n_per_object=400)
LOOPS = {
    "fr3": ("AlignFr3Env-v1", "fr3_align", {}),
    "xarm_dr": ("AlignXArmEnv-v1", "xarm6_align",
                {"domain_randomization": True}),
}


def _leaves(x):
    out = []
    cuda_graph.tree_map(out.append, x)
    return out


def _assert_trees_equal(got, want):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


class _Replayed:
    """Stand-in CUDA graph: ``replay()`` runs the captured body again and
    copies what it returns into the outputs of the capture."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        for dst, src in zip(_leaves(self.out), _leaves(self.body())):
            dst.copy_(src)


def _stand_in_capture(body, warm, device, what, pool=None):
    warm()
    out = body()
    return _Replayed(body, out), out


@pytest.fixture
def stand_in(monkeypatch):
    """``utils.cuda_graph.capture`` (and train.py's import of it) replaced
    by the stand-in."""
    monkeypatch.setattr(cuda_graph, "capture", _stand_in_capture)
    monkeypatch.setattr(ttrain, "capture", _stand_in_capture)


def _loop(name, graph=True):
    env_id, cfg, kw = LOOPS[name]
    env = tenvs.make(env_id, num_envs=B, obs_mode="rgb+segmentation",
                     device="cpu", graph=graph, **kw)
    env.cameras = [dataclasses.replace(c, width=W, height=H)
                   for c in env.cameras]
    env.human_render_cameras = [dataclasses.replace(c, width=W, height=H)
                                for c in env.human_render_cameras]
    wrapper = GSWorldWrapper(
        env, cfg, raster_config=RasterConfig(width=W, height=H,
                                             max_entries=16384),
        synthetic_sizes=SIZES, device="cpu")
    return env, wrapper


# ---------------------------------------------------------------------- #
# (a) the reset: host layout, then device tail
# ---------------------------------------------------------------------- #


def _reset_before_split(env, draws, dr_draws):
    """``GsBaseEnv._reset_fn`` as it was before the split, in one piece."""
    scene = env.scene
    host = draws.device
    ep = env._initialize_episode(draws)
    Bn, A = env.num_envs, scene.actors.num
    n_la = max(len(env._la_pairs), 1)
    f32 = dict(dtype=torch.float32, device=host)
    root_pos = torch.tensor(env._root_pose(), **f32).expand(Bn, 3).clone()
    root_quat = torch.zeros((Bn, 4), **f32)
    root_quat[:, 0] = 1.0
    world = WorldState(
        qpos=ep.qpos, qvel=torch.zeros((Bn, env.agent.model.dof), **f32),
        root_pos=root_pos, root_quat=root_quat,
        a_pos=ep.a_pos, a_quat=ep.a_quat,
        a_lin=torch.zeros((Bn, A, 3), **f32),
        a_ang=torch.zeros((Bn, A, 3), **f32),
        la_forces=torch.zeros((Bn, n_la, 3), **f32),
        contact_lam=torch.zeros((Bn, contact_row_count(scene), 6), **f32),
        a_friction=scene.tensors.a_friction.to(host).expand(Bn, A).clone(),
        a_scale=torch.ones((Bn, A), **f32))
    world, task = env._randomize_world(world, ep.task, dr_draws)
    dev = env.device
    world = WorldState(**{f: (None if getattr(world, f) is None
                              else getattr(world, f).to(dev))
                          for f in WORLD_FIELDS})
    state = EnvState(world=world,
                     elapsed=torch.zeros(Bn, dtype=torch.int32, device=dev),
                     prev_target=world.qpos.clone(),
                     task={k: v.to(dev) for k, v in task.items()})
    return state, env._observations(state, env._env_data(state))[0]


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_reset_is_layout_then_tail(name):
    """``_reset_fn``, its host layout followed by its device tail, and
    ``reset(seed)`` give the unsplit reset's state and observation bit for
    bit (AlignFr3, and AlignXArm with domain randomization); the tail
    leaves the state it reads as it was."""
    env_id, _, kw = LOOPS[name]
    env = tenvs.make(env_id, num_envs=B, obs_mode="rgb+segmentation",
                     device="cpu", **kw)
    draws = env.reset_draws(7)
    want = _reset_before_split(env, *draws)
    state = env._reset_layout(*draws)
    kept = _clone_state(state)
    obs = env._reset_tail(state)
    _assert_trees_equal(state, kept)
    _assert_trees_equal((state, obs), want)
    _assert_trees_equal(env._reset_fn(*draws), want)
    obs, _ = env.reset(seed=7)
    _assert_trees_equal((env.state, obs), want)
    if kw:
        assert set(env.state.task) == {"obj_color", "cam_pose_noise"}


# ---------------------------------------------------------------------- #
# (b) densify at fixed shapes
# ---------------------------------------------------------------------- #


def _densify_sliced(scene, ds, noise, grad_threshold=2e-4,
                    min_opacity=0.005, percent_dense=0.01, scene_extent=3.0,
                    max_screen_size=0.0):
    """``densify_and_prune`` as it was before the fixed shapes: the number
    of new Gaussians read on the host and the rankings sliced to it."""
    N = scene.num_gaussians
    avg_grad = ds.grad_accum / ds.denom.clamp_min(1.0)
    scale_max = torch.exp(scene.log_scales).max(dim=-1).values
    opacity = 1.0 / (1.0 + torch.exp(-scene.logit_opacities))
    high_grad = (avg_grad > grad_threshold) & ds.alive
    small = scale_max <= percent_dense * scene_extent
    want_clone = high_grad & small
    want_split = high_grad & ~small
    prune = ds.alive & (opacity < min_opacity)
    if max_screen_size > 0:
        prune = prune | (ds.max_radii > max_screen_size) | \
            (scale_max > 0.1 * scene_extent)
    alive = ds.alive & ~prune
    req = want_clone | want_split
    score = torch.where(req & alive, avg_grad,
                        torch.full_like(avg_grad, -math.inf))
    src = torch.argsort(-score, stable=True)
    dst = torch.argsort(alive.to(torch.int32), stable=True)
    n_new = int(torch.minimum((~alive).sum(), (score > -math.inf).sum()))
    src, dst = src[:n_new], dst[:n_new]
    split = want_split[src][:, None]
    scales = torch.exp(scene.log_scales[src])
    disp = quat_rotate(quat_normalize(scene.quats[src]),
                       noise[:n_new] * scales)
    new = {f: getattr(scene, f)[src] for f in SCENE_FIELDS}
    new["means"] = torch.where(split, new["means"] + disp, new["means"])
    new["log_scales"] = torch.where(split, new["log_scales"] - math.log(1.6),
                                    new["log_scales"])
    out = {}
    for f in SCENE_FIELDS:
        x = getattr(scene, f).clone()
        x[dst] = new[f]
        out[f] = x
    shrink = want_split & alive
    out["log_scales"] = torch.where(shrink[:, None],
                                    out["log_scales"] - math.log(1.6),
                                    out["log_scales"])
    alive2 = alive.clone()
    alive2[dst] = True
    changed = prune | shrink
    changed[dst] = True
    z = torch.zeros(N, dtype=torch.float32)
    return GaussianScene(**out), densify.DensifyState(
        alive=alive2, grad_accum=z, denom=z.clone(),
        max_radii=z.clone()), changed


# requests: 40 for 35 free slots (the budget binds), 12 for 35, none
DENSIFY_CASES = {"exceed": 40, "short": 12, "none": 0}


def _densify_case(n_req, capacity=130, n_alive=100):
    """``n_alive`` Gaussians in ``capacity`` slots, 5 of them pruned (low
    opacity), the first ``n_req`` with a gradient above the threshold
    (clones and splits) -> (numpy scene fields, numpy densify state)."""
    splats = jsynthetic.make_blob(np.random.default_rng(3), n_alive,
                                  [0, 0, 0], 0.4, [0.7, 0.3, 0.2], 0,
                                  log_scale_mean=-2.5)
    jsc = jdensify.pad_scene_capacity(j_scene_from_splats(splats), capacity)
    jsc = jsc.replace(logit_opacities=jsc.logit_opacities.at[40:45].set(-8.0))
    fields = {f: np.array(getattr(jsc, f)) for f in SCENE_FIELDS}
    rng = np.random.default_rng(4)
    acc = np.zeros(capacity, np.float32)
    acc[:n_req] = rng.uniform(1e-3, 1e-2, n_req)
    acc[60:70] = 1e-5
    live = np.arange(capacity) < n_alive
    ds = dict(alive=live, grad_accum=acc,
              denom=np.where(live, 2.0, 0.0).astype(np.float32),
              max_radii=rng.uniform(0, 9, capacity).astype(np.float32))
    return fields, ds


def _ds(ds):
    return densify.DensifyState(**{k: torch.tensor(v) for k, v in ds.items()})


@pytest.mark.parametrize("case", sorted(DENSIFY_CASES))
def test_fixed_shape_densify_matches_sliced_and_jax(case):
    """The fixed-shape pass equals the sliced one bit for bit (scene,
    densify state, changed rows) where requests exceed the dead slots,
    fall short of them and where there are none; and stays within 1e-6 of
    JAX's pass on the same split noise (alive and changed identical)."""
    n_req = DENSIFY_CASES[case]
    fields, dsf = _densify_case(n_req)
    noise = torch.randn((130, 3), generator=torch.Generator().manual_seed(5))
    got = densify.densify_and_prune(scene_from_numpy(fields, device="cpu"),
                                    _ds(dsf), noise=noise)
    want = _densify_sliced(scene_from_numpy(fields, device="cpu"), _ds(dsf),
                           noise)
    _assert_trees_equal(got, want)
    n_new = min(n_req, 35)
    assert int(got[1].alive.sum()) == 95 + n_new
    assert got[2][40:45].all() and int(got[2].sum()) >= 5 + n_new

    key = jax.random.PRNGKey(0)
    jsc2, jds2, jchanged = jdensify.densify_and_prune(
        JScene(**{f: jnp.asarray(v) for f, v in fields.items()}),
        jdensify.DensifyState(**{k: jnp.asarray(v) for k, v in dsf.items()}),
        key)
    _, sub = jax.random.split(key)
    jnoise = torch.as_tensor(np.array(jax.random.normal(sub, (130, 3))))
    sc2, ds2, changed = densify.densify_and_prune(
        scene_from_numpy(fields, device="cpu"), _ds(dsf), noise=jnoise)
    assert np.array_equal(ds2.alive.numpy(), np.asarray(jds2.alive))
    assert np.array_equal(changed.numpy(), np.asarray(jchanged))
    port = scene_to_numpy(sc2)
    for f in SCENE_FIELDS:
        a = np.asarray(getattr(jsc2, f), np.float64)
        scale = max(np.abs(a).max(), 1e-12)
        np.testing.assert_allclose(port[f].astype(np.float64) / scale,
                                   a / scale, atol=1e-6, rtol=0, err_msg=f)


# ---------------------------------------------------------------------- #
# (c) the graph classes, with the stand-in capture
# ---------------------------------------------------------------------- #


def _check_graph(call, eager, inputs_k, inputs_next, graph_inputs):
    """``call(*inputs)`` against ``eager(*inputs)`` on two inputs: bit for
    bit, call k's outputs unchanged by call k + 1, the graph's static
    inputs not the caller's tensors, the caller's inputs unmutated."""
    kept_in = cuda_graph.clone_tree((inputs_k, inputs_next))
    out_k = call(*inputs_k)
    _assert_trees_equal(out_k, eager(*inputs_k))
    kept_out = cuda_graph.clone_tree(out_k)
    out_next = call(*inputs_next)
    _assert_trees_equal(out_next, eager(*inputs_next))
    _assert_trees_equal(out_k, kept_out)
    _assert_trees_equal((inputs_k, inputs_next), kept_in)
    theirs = {t.data_ptr() for t in _leaves((inputs_k, inputs_next))}
    assert not theirs & {t.data_ptr() for t in _leaves(graph_inputs)}
    assert not {t.data_ptr() for t in _leaves(out_k)} & {
        t.data_ptr() for t in _leaves(out_next)}


def _two_states(env, wrapper):
    wrapper.reset(seed=1)
    s0 = _clone_state(env.state)
    wrapper.step(env.action_space_sample())
    return s0, _clone_state(env.state)


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_render_and_reset_graphs(stand_in, name):
    """The renderer's graphs (sensor cameras and the human view), the
    env's reset graph and the wrapper's reset graph (device tail and
    render) against their eager functions (``_check_graph``)."""
    env, wrapper = _loop(name)
    r = wrapper.renderer
    s0, s1 = _two_states(env, wrapper)
    p0, p1 = (world_poses(s.world, s.task) for s in (s0, s1))
    for cams in (None, env.human_render_cameras):
        g = r._capture_render(p0, cams)
        _check_graph(g, lambda p: (r._render(p, cams), r.last_overflow),
                     (p0,), (p1,), g.inputs)
    g = env._capture_reset(s0)
    _check_graph(g, env._reset_tail, (s0,), (s1,), g.inputs)
    g = wrapper._capture_reset(s0)
    _check_graph(g, wrapper._reset_and_render, (s0,), (s1,), g.inputs)
    with pytest.raises(ValueError):
        g(p0)                          # another structure is refused


def test_collision_check_graphs(stand_in, monkeypatch):
    """The checker through its graphs (one per batch size, the numpy batch
    copied in) against the eager checker."""
    env, wrapper = _loop("fr3")
    wrapper.reset(seed=2)
    w = env.state.world
    args = (w.a_pos[0], w.a_quat[0], w.root_pos[0], w.root_quat[0])
    check = make_collision_checker(env)
    rng = np.random.default_rng(0)
    lim = env.agent.model.qlimits
    batches = [lim[:, 0] + (lim[:, 1] - lim[:, 0]) * rng.random((m, len(lim)))
               for m in (5, 7, 5)]
    eager = [check(q, *args) for q in batches]
    assert any(e.any() for e in eager) and not all(e.all() for e in eager)
    monkeypatch.setattr(env, "_graphed", lambda: True)
    _check_graph(check, lambda q, *a: eager[0] if q is batches[0]
                 else eager[1], (batches[0], *args), (batches[1], *args), ())
    assert sorted(check.graphs) == [5, 7]
    g = check.graphs[5]
    assert not {t.data_ptr() for t in args} & {
        t.data_ptr() for t in _leaves(g.inputs)}
    assert torch.equal(check(batches[2], *args), eager[2])
    assert sorted(check.graphs) == [5, 7]


def _train_state(fields, dsf):
    scene = cuda_graph.clone_tree(scene_from_numpy(fields, device="cpu"))
    opt = adam_init(scene)
    gen = torch.Generator().manual_seed(9)
    for m in (*opt.mu.values(), *opt.nu.values()):
        m.copy_(torch.rand(m.shape, generator=gen))
    return ttrain.TrainState(scene=scene, ds=_ds(dsf), opt_state=opt, step=0)


def test_densify_graph(stand_in):
    """The densify graph (densify, the moments' reset and the write into
    the state's own tensors, the split noise from the generator) against
    the eager pass on the same state, twice in a row."""
    fields, dsf = _densify_case(DENSIFY_CASES["exceed"])
    eager, graphed = _train_state(fields, dsf), _train_state(fields, dsf)
    kw = dict(grad_threshold=2e-4, percent_dense=0.01, scene_extent=3.0)
    # the stand-in runs the body at capture, which a capture does not:
    # put the state back as it was
    before = ttrain._clone_train_state(graphed)
    g = ttrain.DensifyGraph(graphed, **kw)
    for dst, src in zip(_leaves(graphed), _leaves(before)):
        dst.copy_(src)
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    for k in range(2):
        sc, ds, changed = densify.densify_and_prune(eager.scene, eager.ds,
                                                    gens[0], **kw)
        zero_rows(eager.opt_state, changed)
        ttrain._write_state(eager, sc, ds)
        g(graphed, gens[1])
        _assert_trees_equal(graphed, eager)
        if k == 0:
            # a grad statistic for the second pass
            for st in (eager, graphed):
                st.ds.grad_accum[:20] = 5e-3
                st.ds.denom[:20] = 1.0
    with pytest.raises(ValueError):
        g(eager, gens[1])


# ---------------------------------------------------------------------- #
# (d) the entry points on the CPU and with graph=False
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("graph", [True, False])
def test_entry_points_build_no_graph_on_cpu(monkeypatch, graph):
    """``render_graph`` and both ``reset_graph``s refuse a CPU env with
    ``ValueError``, as ``step_graph`` does; a CPU env with ``graph`` on or
    off resets, steps and renders eagerly and builds no graph."""
    env, wrapper = _loop("fr3", graph=graph)

    def refuse(*a, **k):
        raise AssertionError("a graph was built")

    monkeypatch.setattr(env, "_capture_reset", refuse)
    monkeypatch.setattr(wrapper, "_capture_reset", refuse)
    monkeypatch.setattr(wrapper.renderer, "_capture_render", refuse)
    wrapper.reset(seed=0)
    env.reset(seed=0)
    wrapper.step(env.action_space_sample())
    wrapper.render_current_step()
    wrapper.render()
    make_collision_checker(env)(np.zeros((3, env.agent.model.dof)),
                                env.state.world.a_pos[0],
                                env.state.world.a_quat[0],
                                env.state.world.root_pos[0],
                                env.state.world.root_quat[0])
    st = env.state
    with pytest.raises(ValueError):
        wrapper.renderer.render_graph(world_poses(st.world, st.task))
    with pytest.raises(ValueError):
        wrapper.reset_graph(st)
    with pytest.raises(ValueError):
        env.reset_graph(st)
    with pytest.raises(ValueError):
        wrapper.step_graph(env.action_space_sample())
    assert env._reset_graph is None and wrapper._reset_graph is None
    assert not wrapper.renderer._render_graphs
    assert env.graph_pool() is None
