"""Parity of the port's 3DGS training path (gsworld_tpu_torch.train3dgs,
gs.pcd_init, real2sim.pipeline) with the JAX reference on the CPU: loss,
learning-rate schedule, Adam against optax, densify/prune, point-cloud
init, one whole train step against JAX make_train_step on its XLA
backend, and a reconstruction run through the entry point.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's kernel wrappers take their plain PyTorch versions.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsworld_tpu.gs import pcd_init as jpcd
from gsworld_tpu.gs import synthetic as jsynthetic
from gsworld_tpu.gs.model import GaussianScene as JScene
from gsworld_tpu.gs.model import scene_from_splats as j_scene_from_splats
from gsworld_tpu.render.camera import RasterConfig as JCfg
from gsworld_tpu.render.camera import make_camera as j_make_camera
from gsworld_tpu.train3dgs import densify as jdensify
from gsworld_tpu.train3dgs import loss as jloss
from gsworld_tpu.train3dgs import optim as joptim
from gsworld_tpu.train3dgs import train as jtrain
from gsworld_tpu_torch.gs.model import (
    SCENE_FIELDS,
    scene_from_numpy,
    scene_to_numpy,
    scene_to_splats,
)
from gsworld_tpu_torch.gs.pcd_init import C0, create_from_pcd
from gsworld_tpu_torch.real2sim.pipeline import (
    train_from_colmap_model,
    write_scene_config,
)
from gsworld_tpu_torch.render.camera import RasterConfig, make_camera
from gsworld_tpu_torch.train3dgs import densify
from gsworld_tpu_torch.train3dgs.loss import gs_loss, l1_loss, psnr, ssim
from gsworld_tpu_torch.train3dgs.optim import (
    TRAINABLE,
    OptimizationParams,
    adam_init,
    adam_step,
    expon_lr_schedule,
    learning_rates,
    zero_rows,
)
from gsworld_tpu_torch.train3dgs.train import (
    TrainState,
    make_train_step,
    render_trainable,
)
from torch_physics_common import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _splats(n, seed, log_scale_mean=-2.5):
    rng = np.random.default_rng(seed)
    return jsynthetic.make_blob(rng, n, [0, 0, 0], 0.4, [0.7, 0.3, 0.2], 0,
                                log_scale_mean=log_scale_mean)


def _fields(jscene):
    return {f: np.array(getattr(jscene, f)) for f in SCENE_FIELDS}


def _jscene(fields):
    return JScene(**{f: jnp.asarray(v) for f, v in fields.items()})


def _assert_fields(port_scene, jfields, rtol, fields=SCENE_FIELDS):
    """Each field within ``rtol`` of the JAX one, relative to its max."""
    got = scene_to_numpy(port_scene)
    for f in fields:
        a, b = jfields[f].astype(np.float64), got[f].astype(np.float64)
        scale = max(np.abs(a).max(), 1e-12)
        np.testing.assert_allclose(b / scale, a / scale, atol=rtol,
                                   rtol=0, err_msg=f)


def _cam(ang, dist=2.0):
    w2c = np.eye(4, dtype=np.float32)
    c, s = np.cos(ang), np.sin(ang)
    w2c[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
    w2c[2, 3] = dist
    return j_make_camera(w2c, 0.5, 0.5), make_camera(torch.as_tensor(w2c),
                                                     0.5, 0.5)


class TestLoss:
    def test_ssim_and_loss_match_jax(self):
        """Values and image gradients of ssim and gs_loss agree with JAX
        at 1e-5 (f32 convolutions summed in another order)."""
        rng = np.random.default_rng(0)
        a = rng.random((30, 41, 3)).astype(np.float32)
        b = np.clip(a + 0.15 * rng.normal(size=a.shape), 0, 1).astype(
            np.float32)
        for jf, tf in ((jloss.ssim, ssim), (jloss.gs_loss, gs_loss),
                       (jloss.l1_loss, l1_loss), (jloss.psnr, psnr)):
            v_j, g_j = jax.value_and_grad(jf)(jnp.asarray(a), jnp.asarray(b))
            x = torch.as_tensor(a).requires_grad_()
            v_p = tf(x, torch.as_tensor(b))
            v_p.backward()
            assert abs(float(v_j) - float(v_p.detach())) <= 1e-5 * max(
                1.0, abs(float(v_j))), jf.__name__
            g_j = np.asarray(g_j)
            scale = np.abs(g_j).max()
            np.testing.assert_allclose(x.grad.numpy() / scale, g_j / scale,
                                       atol=1e-5, err_msg=jf.__name__)
        assert float(ssim(torch.as_tensor(a), torch.as_tensor(a))) == \
            pytest.approx(1.0, abs=1e-5)

    def test_expon_schedule_endpoints(self):
        s = expon_lr_schedule(1.6e-4, 1.6e-6, 1000)
        assert s(0) == pytest.approx(1.6e-4, rel=1e-12)
        assert s(1000) == pytest.approx(1.6e-6, rel=1e-12)
        assert s(5000) == pytest.approx(1.6e-6, rel=1e-12)
        j = joptim.expon_lr_schedule(1.6e-4, 1.6e-6, 1000, delay_steps=100)
        p = expon_lr_schedule(1.6e-4, 1.6e-6, 1000, delay_steps=100)
        for step in (0, 50, 100, 500, 1000):
            assert p(step) == pytest.approx(float(j(step)), rel=1e-6)


class TestOptim:
    def test_adam_matches_optax_with_row_reset(self):
        """Five steps with given gradients, the moments of some rows zeroed
        after the third (as densify does), against optax.multi_transform of
        optax.adam: every field within 1e-6 of its max."""
        params = OptimizationParams(position_lr_max_steps=8)
        fields = _fields(j_scene_from_splats(_splats(50, 1)))
        jsc = _jscene(fields)
        tx = joptim.make_optimizer(params)
        opt = tx.init(jsc)
        scene = scene_from_numpy(fields, device="cpu")
        state = adam_init(scene)
        lrs = learning_rates(params)
        rng = np.random.default_rng(2)
        changed = rng.random(50) < 0.3
        for step in range(5):
            g = {f: rng.normal(size=fields[f].shape).astype(np.float32)
                 * 10.0 ** rng.uniform(-6, 0) for f in TRAINABLE}
            g_scene = jsc.replace(
                **{f: jnp.asarray(v) for f, v in g.items()},
                semantics=jnp.zeros_like(jsc.semantics),
                slot_ids=jnp.zeros_like(jsc.slot_ids))
            upd, opt = tx.update(g_scene, opt, jsc)
            jsc = jsc.replace(**{f: getattr(jsc, f) + getattr(upd, f)
                                 for f in TRAINABLE})
            adam_step(scene, {f: torch.as_tensor(v) for f, v in g.items()},
                      state, lrs)
            if step == 2:
                opt = jtrain._zero_changed_rows(opt, jnp.asarray(changed), 50)
                zero_rows(state, torch.as_tensor(changed))
        assert state.count == 5
        _assert_fields(scene, _fields(jsc), 1e-6)


class TestDensify:
    def _case(self):
        """100 alive Gaussians in 130 slots; 40 high-gradient requests
        (clones and splits) for 30 + 5 pruned free slots, so the budget
        binds."""
        jsc = jdensify.pad_scene_capacity(
            j_scene_from_splats(_splats(100, 3)), 130)
        jsc = jsc.replace(
            logit_opacities=jsc.logit_opacities.at[40:45].set(-8.0))
        rng = np.random.default_rng(4)
        acc = np.zeros(130, np.float32)
        acc[:40] = rng.uniform(1e-3, 1e-2, 40)
        acc[60:70] = 1e-5
        ds_fields = dict(alive=np.arange(130) < 100, grad_accum=acc,
                         denom=np.where(np.arange(130) < 100, 2.0, 0.0
                                        ).astype(np.float32),
                         max_radii=rng.uniform(0, 9, 130).astype(np.float32))
        return jsc, ds_fields

    def test_pad_scene_capacity_matches_jax(self):
        fields = _fields(j_scene_from_splats(_splats(20, 5)))
        want = _fields(jdensify.pad_scene_capacity(_jscene(fields), 32))
        got = densify.pad_scene_capacity(
            scene_from_numpy(fields, device="cpu"), 32)
        _assert_fields(got, want, 0.0)

    @pytest.mark.parametrize("max_screen_size", [0.0, 5.0])
    def test_densify_and_prune_matches_jax(self, max_screen_size):
        """With JAX's split noise handed in: alive and changed masks
        identical, every field within 1e-6 of its max; with and without
        the screen-size prune."""
        jsc, dsf = self._case()
        key = jax.random.PRNGKey(0)
        jsc2, jds2, jchanged = jdensify.densify_and_prune(
            jsc, jdensify.DensifyState(**{k: jnp.asarray(v)
                                          for k, v in dsf.items()}), key,
            max_screen_size=max_screen_size)
        _, sub = jax.random.split(key)
        noise = np.array(jax.random.normal(sub, (130, 3)))
        ds = densify.DensifyState(**{k: torch.as_tensor(v)
                                     for k, v in dsf.items()})
        sc2, ds2, changed = densify.densify_and_prune(
            scene_from_numpy(_fields(jsc), device="cpu"), ds,
            noise=torch.as_tensor(noise),
            max_screen_size=max_screen_size)
        assert np.array_equal(ds2.alive.numpy(), np.asarray(jds2.alive))
        assert np.array_equal(changed.numpy(), np.asarray(jchanged))
        if not max_screen_size:                    # the budget binds
            assert int(ds2.alive.sum()) == 130
        assert changed[40:45].all()                # pruned
        _assert_fields(sc2, _fields(jsc2), 1e-6)
        assert not ds2.grad_accum.any() and not ds2.denom.any()

    def test_split_noise_comes_from_generator(self):
        jsc, dsf = self._case()
        ds = densify.DensifyState(**{k: torch.as_tensor(v)
                                     for k, v in dsf.items()})
        runs = [densify.densify_and_prune(
            scene_from_numpy(_fields(jsc), device="cpu"), ds,
            torch.Generator().manual_seed(s))[0].means for s in (0, 0, 1)]
        assert torch.equal(runs[0], runs[1])
        assert not torch.equal(runs[0], runs[2])

    def test_reset_opacity_matches_jax(self):
        fields = _fields(j_scene_from_splats(_splats(30, 6)))
        want = _fields(jdensify.reset_opacity(_jscene(fields)))
        got = densify.reset_opacity(scene_from_numpy(fields, device="cpu"))
        _assert_fields(got, want, 0.0)


def test_create_from_pcd_matches_jax():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    sem = rng.integers(0, 5, 64).astype(np.int32)
    for cols, s in ((rng.uniform(0, 1, (64, 3)).astype(np.float32), None),
                    (np.full((64, 3), 128, np.uint8), sem), (None, None)):
        want = _fields(jpcd.create_from_pcd(pts, cols, s))
        got = create_from_pcd(pts, cols, s, device="cpu")
        _assert_fields(got, want, 1e-7)
    splats = scene_to_splats(got)
    assert splats["sh0"].shape == (64, 3, 1)
    assert splats["opacities"].shape == (64, 1)


def test_train_step_matches_jax():
    """One train step of 120 Gaussians (capacity 128) at 48x48 against JAX
    make_train_step on its XLA backend (f32 colours, the same custom-VJP
    math; max_per_tile large enough that no cap binds): loss within 1e-5,
    updated fields and densify statistics within 1e-4 relative to each
    field's max (f32 sums in another order, amplified where Adam's first
    step normalises a gradient)."""
    jcfg = JCfg(width=48, height=48, max_per_tile=256, tile_chunk=3,
                backend="xla")
    cfg = RasterConfig(width=48, height=48)
    jcam, cam = _cam(0.2)
    truth = j_scene_from_splats(_splats(120, 8))
    target = np.array(jtrain.render_trainable(
        truth, jnp.zeros((120, 2)), jcam, jcfg)[0])
    rng = np.random.default_rng(9)
    start = _fields(truth)
    start["means"] = start["means"] + 0.01 * rng.normal(
        size=(120, 3)).astype(np.float32)
    start["sh0"] = start["sh0"] + 0.3 * rng.normal(
        size=(120, 3)).astype(np.float32)
    params = OptimizationParams()

    jsc = jdensify.pad_scene_capacity(_jscene(start), 128)
    tx = joptim.make_optimizer(params)
    jstate = jtrain.TrainState(scene=jsc,
                               ds=jdensify.init_densify_state(128, 120),
                               opt_state=tx.init(jsc),
                               step=jnp.zeros((), jnp.int32))
    jstate, jl, _ = jtrain.make_train_step(jcfg, params, tx)(
        jstate, jcam, jnp.asarray(target))

    sc = densify.pad_scene_capacity(scene_from_numpy(start, device="cpu"),
                                    128)
    state = TrainState(scene=sc,
                       ds=densify.init_densify_state(128, 120, "cpu"),
                       opt_state=adam_init(sc), step=0)
    state, loss, img = make_train_step(cfg, params)(
        state, cam, torch.as_tensor(target))
    assert state.step == 1 and img.shape == (48, 48, 3)
    assert abs(float(loss) - float(jl)) <= 1e-5
    _assert_fields(state.scene, _fields(jstate.scene), 1e-4)
    for k in ("grad_accum", "denom", "max_radii"):
        a = np.asarray(getattr(jstate.ds, k))
        b = getattr(state.ds, k).numpy()
        assert np.abs(a).max() > 0, k
        np.testing.assert_allclose(b / np.abs(a).max(), a / np.abs(a).max(),
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["train", "train_from_colmap_model",
                                  "reconstruct_scene"])
def test_signature_binds_jax_calls(name):
    """A call of the JAX package's train (train3dgs), train_from_colmap_model
    or reconstruct_scene (real2sim.pipeline) binds the same way in the
    port (ROADMAP C22): JAX's parameters are the port's first ones, in
    order, with their kinds and defaults (``log_every`` in JAX's place,
    ``backend`` accepted); what the port adds comes after them, with a
    default."""
    import inspect

    from gsworld_tpu.real2sim import pipeline as jpipeline
    from gsworld_tpu_torch.real2sim import pipeline as tpipeline
    from gsworld_tpu_torch.train3dgs import train as ttrain
    jmod, tmod = ((jtrain, ttrain) if name == "train"
                  else (jpipeline, tpipeline))
    jfn, tfn = getattr(jmod, name), getattr(tmod, name)
    want = list(inspect.signature(jfn).parameters.values())
    got = list(inspect.signature(tfn).parameters.values())
    assert [(p.name, p.kind, p.default) for p in got[:len(want)]] == [
        (p.name, p.kind, p.default) for p in want]
    assert all(p.default is not inspect.Parameter.empty
               for p in got[len(want):])


def test_train_logs_jax_lines(capsys):
    """train(..., log_every=1) prints the JAX package's line at every
    iteration: ``iter {it}: loss={loss:.4f} alive={n}``."""
    from gsworld_tpu_torch.train3dgs.train import train
    cfg = RasterConfig(width=48, height=48)
    _, cam = _cam(0.2)
    truth = scene_from_numpy(_fields(j_scene_from_splats(_splats(120, 8))),
                             device="cpu")
    with torch.no_grad():
        target = render_trainable(truth, torch.zeros(120, 2), cam, cfg)[0]
    capsys.readouterr()
    scene, ds, losses = train(truth, [cam], [target], cfg, None, 128, 0,
                              3.0, 1, 2)
    lines = capsys.readouterr().out.splitlines()
    n = int(ds.alive.sum())
    assert lines == [f"iter {it}: loss={losses[it - 1]:.4f} alive={n}"
                     for it in (1, 2)]


def test_culled_gaussians_get_finite_gradients():
    """Gaussians on the camera plane (depth 0) and behind the camera are
    culled; their projection's 1/z terms must not turn their zero
    gradient into NaN (0 x inf), which Adam would write into the scene
    (ROADMAP C19).  Every gradient of a train step's render is finite, the
    culled Gaussians' zero, and the visible ones' unchanged."""
    cfg = RasterConfig(width=48, height=48)
    _, cam = _cam(0.0)                    # identity rotation, z + 2
    fields = _fields(j_scene_from_splats(_splats(40, 4, log_scale_mean=0.0)))
    fields["means"][0] = [0.3, 0.1, -2.0]       # depth exactly 0
    fields["means"][1] = [-0.2, 0.0, -2.5]      # behind the camera

    def grads(scene):
        leaves = {f: getattr(scene, f).clone().requires_grad_(True)
                  for f in TRAINABLE}
        d2d = torch.zeros((scene.num_gaussians, 2), requires_grad=True)
        img, radii = render_trainable(
            type(scene)(**{**{f: getattr(scene, f) for f in SCENE_FIELDS},
                           **leaves}), d2d, cam, cfg)
        g = torch.autograd.grad(img.square().sum(), list(leaves.values()))
        return dict(zip(TRAINABLE, g)), radii

    g, radii = grads(scene_from_numpy(fields, device="cpu"))
    assert radii[:2].tolist() == [0, 0] and (radii[2:] > 0).any()
    for f, v in g.items():
        assert torch.isfinite(v).all(), f
        assert not v[:2].any(), f
    # the visible Gaussians' gradients do not depend on the culled ones
    rest = {f: v[2:] for f, v in fields.items()}
    g_rest, _ = grads(scene_from_numpy(rest, device="cpu"))
    for f in TRAINABLE:
        torch.testing.assert_close(g[f][2:], g_rest[f], rtol=1e-5,
                                   atol=1e-7)


def test_holdout_psnr():
    """The port's counterpart of TestReconstruction.test_holdout_psnr
    (tests/test_real2sim_pipeline.py): render a synthetic blob from 5
    cameras, rebuild it from its noisy means and colours through
    train_from_colmap_model on the CPU, and check the loss falls below
    half and the held-out interior view reaches 25 dB."""
    cfg = RasterConfig(width=48, height=48)
    rng = np.random.default_rng(4)
    n = 160
    splats = jsynthetic.make_blob(rng, n, [0, 0, 0], 0.35, [0.7, 0.3, 0.2],
                                  0, log_scale_mean=-2.6)
    from gsworld_tpu_torch.gs.model import scene_from_splats
    truth = scene_from_splats(splats, device="cpu")
    cams = [_cam((i / 4 - 0.5) * 1.2)[1] for i in range(5)]
    with torch.no_grad():
        imgs = [render_trainable(truth, torch.zeros(n, 2), c, cfg)[0]
                for c in cams]
    hold = 2
    pts = splats["means"] + rng.normal(scale=5e-3, size=(n, 3))
    cols = np.clip(splats["sh0"].reshape(n, 3) * C0 + 0.5
                   + rng.normal(scale=0.02, size=(n, 3)), 0, 1)
    params = OptimizationParams(densify_from_iter=40, densify_until_iter=120,
                                densification_interval=40,
                                opacity_reset_interval=10_000)
    scene, losses = train_from_colmap_model(
        pts, cols, [c for i, c in enumerate(cams) if i != hold],
        [im for i, im in enumerate(imgs) if i != hold], cfg, params=params,
        iterations=320, capacity=2 * n, seed=0,
        device="cpu")
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert n < scene.num_gaussians <= 2 * n
    with torch.no_grad():
        out, _ = render_trainable(scene, torch.zeros(scene.num_gaussians, 2),
                                  cams[hold], cfg)
    val = float(psnr(out, imgs[hold]))
    assert val > 25.0, f"held-out PSNR {val:.1f} dB"


def test_scene_config_roundtrip(tmp_path):
    import json
    p = write_scene_config(str(tmp_path / "cfg.json"), "scene.ply",
                           semantic_labels=3)
    cfg = json.load(open(p))
    assert cfg["models"][0]["data_path"] == "scene.ply"
    assert cfg["models"][0]["semantic_labels"] == 3


def test_training_path_runs_without_jax():
    """The training path imports neither jax nor gsworld_tpu."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        from gsworld_tpu_torch.real2sim.pipeline import (
            train_from_colmap_model)
        from gsworld_tpu_torch.render.camera import RasterConfig, make_camera
        from gsworld_tpu_torch.train3dgs.optim import OptimizationParams
        rng = np.random.default_rng(0)
        pts = rng.uniform(-0.3, 0.3, (50, 3))
        w2c = torch.eye(4)
        w2c[2, 3] = 2.0
        cam = make_camera(w2c, 0.5, 0.5)
        img = np.full((32, 32, 3), 0.5, np.float32)
        params = OptimizationParams(densify_from_iter=2,
                                    densification_interval=2)
        scene, losses = train_from_colmap_model(
            pts, None, [cam], [img], RasterConfig(width=32, height=32),
            params=params, iterations=3, device="cpu")
        assert len(losses) == 3 and np.isfinite(losses).all()
        bad = [m for m in sys.modules
               if m == "gsworld_tpu" or m.startswith("gsworld_tpu.")]
        assert not bad, bad
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")
