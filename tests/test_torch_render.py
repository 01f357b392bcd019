"""Parity of the port's render stages (gsworld_tpu_torch.render) with the
JAX reference on the CPU: SH, camera bridge, projection, binning against
bin_entries_fused and compositing against composite_tiles_pallas, both
run in Pallas interpret mode, plus the literal golden rasterizer.

On the CPU the port's binning and compositor wrappers take their plain
PyTorch versions (the CUDA kernels are held against those on the card by
chip_smoke.py).  Inputs are made with numpy from a seed and fed to both
packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsworld_tpu.gs import synthetic as jsynthetic
from gsworld_tpu.gs.transform import PosedGaussians as JPosed
from gsworld_tpu.render import golden
from gsworld_tpu.render.binning import bin_entries_fused as j_bin_fused
from gsworld_tpu.render.camera import RasterConfig as JCfg
from gsworld_tpu.render.camera import cam_maniskill2gs as j_cam_bridge
from gsworld_tpu.render.camera import camera_from_opencv as j_cam_cv
from gsworld_tpu.render.camera import make_camera as j_make_camera
from gsworld_tpu.render.camera import projection_matrix as j_proj_mat
from gsworld_tpu.render.project import project_gaussians as j_project
from gsworld_tpu.render.rasterize_pallas import (
    composite_tiles_pallas,
    pack_record_columns,
)
from gsworld_tpu.render.sh import eval_sh as j_eval_sh
from gsworld_tpu_torch.gs.transform import PosedGaussians
from gsworld_tpu_torch.render import rasterize_cuda
from gsworld_tpu_torch.render.binning import bin_entries_fused, plan_emit
from gsworld_tpu_torch.render.camera import RasterConfig
from gsworld_tpu_torch.render.camera import cam_maniskill2gs
from gsworld_tpu_torch.render.camera import camera_from_opencv
from gsworld_tpu_torch.render.camera import make_camera
from gsworld_tpu_torch.render.camera import projection_matrix
from gsworld_tpu_torch.render.project import Projected, project_gaussians
from gsworld_tpu_torch.render.rasterize import render
from gsworld_tpu_torch.render.sh import eval_sh

CFG_KW = dict(width=64, height=48, max_entries=2048)


def _splats(n, seed):
    rng = np.random.default_rng(seed)
    return jsynthetic.make_blob(rng, n, [0, 0, 0], 0.5, [0.6, 0.4, 0.3], 0,
                                log_scale_mean=-3.0)


def _both(n=400, seed=0, behind=0, **kw):
    """Same scene + camera through both projections; the first ``behind``
    Gaussians are moved behind the camera.
    -> (jax Projected, port Projected, jax cfg, port cfg, splats)."""
    s = _splats(n, seed)
    s["means"][:behind, 2] = -5.0
    kw = {**CFG_KW, **kw}
    jcfg = JCfg(max_per_tile=512, tile_chunk=4, **kw)
    cfg = RasterConfig(**kw)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.0
    sh0 = s["sh0"].reshape(-1, 3)
    shN = s["shN"].reshape(-1, 45)
    jp = j_project(JPosed(jnp.asarray(s["means"]), jnp.asarray(s["scales"]),
                          jnp.asarray(s["quats"]),
                          jnp.asarray(s["opacities"].reshape(-1))),
                   j_make_camera(w2c, 0.5, 0.5), jcfg, jnp.asarray(sh0),
                   jnp.asarray(shN))
    tp = project_gaussians(
        PosedGaussians(torch.as_tensor(s["means"]),
                       torch.as_tensor(s["scales"]),
                       torch.as_tensor(s["quats"]),
                       torch.as_tensor(s["opacities"].reshape(-1))),
        make_camera(torch.as_tensor(w2c), 0.5, 0.5), cfg,
        torch.as_tensor(sh0), torch.as_tensor(shN))
    return jp, tp, jcfg, cfg, s


def _proj_from_jax(jp) -> Projected:
    """The JAX projection's arrays as the port's Projected (so binning and
    compositing are compared on identical inputs)."""
    return Projected(*(torch.as_tensor(np.array(x)) for x in jp))


def _bin1(tp, cfg):
    """Bin one frame: the port bins (F, N) batches only."""
    bins = bin_entries_fused(Projected(*(x[None] for x in tp)), cfg)
    return type(bins)(*(x[0] for x in bins))


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _segments(g, starts, t):
    return np.asarray(g)[int(starts[t]):int(starts[t + 1])]


def _assert_bins_match(jb, tb, depth, num_tiles):
    """Same starts, overflow, per-tile entry sets, and the same depth
    order (up to exact depth ties, which break differently)."""
    np.testing.assert_array_equal(np.asarray(jb.starts),
                                  tb.starts.numpy())
    assert int(jb.overflow) == int(tb.overflow)
    for t in range(num_tiles):
        gj = _segments(jb.gaussian, tb.starts, t)
        gt = _segments(tb.gaussian, tb.starts, t)
        np.testing.assert_array_equal(np.sort(gj), np.sort(gt))
        d = depth[gt]
        assert np.isfinite(d).all(), f"tile {t}: culled entry emitted"
        assert (np.diff(d) >= 0).all(), f"tile {t}: depth order broken"
        # JAX orders by the top depth bits: equal up to 2^-15 relative
        np.testing.assert_allclose(depth[gj], d, rtol=2.0 ** -15)


class TestProjection:
    def test_sh_matches_jax(self):
        rng = np.random.default_rng(3)
        sh0 = rng.normal(size=(64, 3)).astype(np.float32)
        shN = (0.3 * rng.normal(size=(64, 45))).astype(np.float32)
        d = rng.normal(size=(64, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        for degree in (0, 1, 2, 3):
            ref = np.asarray(j_eval_sh(jnp.asarray(sh0), jnp.asarray(shN),
                                       jnp.asarray(d), degree))
            got = eval_sh(torch.as_tensor(sh0), torch.as_tensor(shN),
                          torch.as_tensor(d), degree).numpy()
            # f32 sums in another order: 1e-5 relative
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    def test_camera_bridge_matches_jax(self):
        rng = np.random.default_rng(4)
        from gsworld_tpu_torch.core.maths import axis_angle_to_quat, tf_from_pq
        q = axis_angle_to_quat(torch.as_tensor(
            rng.normal(size=(3, 3)), dtype=torch.float32))
        ext = tf_from_pq(torch.as_tensor(rng.normal(size=(3, 3)),
                                         dtype=torch.float32), q)
        K = np.array([[600.0, 0, 320], [0, 610.0, 240], [0, 0, 1]],
                     np.float32)
        rigid = np.eye(4, dtype=np.float32)
        rigid[:3, :3] = tf_from_pq(torch.zeros(3), q[0])[:3, :3].numpy()
        rigid[:3, 3] = [0.1, -0.2, 0.3]
        jc = j_cam_bridge(jnp.asarray(ext.numpy()), jnp.asarray(K), 640,
                          480, jnp.asarray(rigid), jnp.float32(0.9))
        tc = cam_maniskill2gs(ext, torch.as_tensor(K), 640, 480,
                              torch.as_tensor(rigid), 0.9)
        for a, b in zip(jc, tc):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-5)
        jo = j_cam_cv(jnp.asarray(ext.numpy()[:, :3]), jnp.asarray(K), 64,
                      48)
        to = camera_from_opencv(ext[:, :3], torch.as_tensor(K), 64, 48)
        for a, b in zip(jo, to):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(
            projection_matrix(0.4, 0.3).numpy(),
            np.asarray(j_proj_mat(jnp.float32(0.4), jnp.float32(0.3))),
            rtol=1e-6)

    @pytest.mark.parametrize("seed", [0, 9])
    def test_projection_matches_jax(self, seed):
        jp, tp, _, _, _ = _both(n=500, seed=seed, max_tiles_per_gaussian=4)
        valid = np.asarray(jp.radius) > 0
        np.testing.assert_array_equal(tp.radius.numpy() > 0, valid)
        # f32 elementwise math in another operation order: 1e-5 relative
        for name in ("mean2d", "conic", "color", "opacity"):
            a = np.asarray(getattr(jp, name))[valid]
            b = getattr(tp, name).numpy()[valid]
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        np.testing.assert_allclose(tp.depth.numpy(), np.asarray(jp.depth),
                                   rtol=1e-5)
        # integer outputs of floor/ceil: exact except at rounding edges
        assert np.mean(tp.radius.numpy() == np.asarray(jp.radius)) > 0.995
        assert np.mean(tp.rect.numpy() == np.asarray(jp.rect)) > 0.995


class TestBinning:
    def test_fused_binning_matches_and_orders_by_depth(self):
        jp, _, jcfg, cfg, _ = _both(n=400, seed=13)
        # cull every 7th Gaussian and poison its row the way a real
        # projection can (inv_w blowup)
        culled = np.arange(400) % 7 == 0
        m2d = np.array(jp.mean2d)
        m2d[culled] = np.inf
        jp = jp._replace(
            mean2d=jnp.asarray(m2d),
            radius=jnp.where(culled, 0, jp.radius),
            rect=jnp.where(culled[:, None], 0, jp.rect),
            depth=jnp.where(culled, jnp.inf, jp.depth))
        jcfg = dataclasses.replace(jcfg, cull_alpha=False)
        cfg = dataclasses.replace(cfg, cull_alpha=False)
        jb = j_bin_fused(jp, jcfg, pack_record_columns(jp, None))
        tb = _bin1(_proj_from_jax(jp), cfg)
        _assert_bins_match(jb, tb, np.asarray(jp.depth), cfg.num_tiles)

    def test_cull_alpha_is_lossless_and_drops_entries(self):
        jp, _, jcfg, cfg, _ = _both(n=400, seed=21)
        tp = _proj_from_jax(jp)
        jb = j_bin_fused(jp, jcfg, pack_record_columns(jp, None))
        _assert_bins_match(jb, _bin1(tp, cfg),
                           np.asarray(jp.depth), cfg.num_tiles)
        on = _bin1(tp, cfg)
        off = _bin1(tp, dataclasses.replace(cfg, cull_alpha=False))
        assert int(on.starts[-1]) < int(off.starts[-1])
        args = (tp.mean2d, tp.conic, tp.opacity, tp.color, None)
        kw = dict(width=cfg.width, height=cfg.height, tile=cfg.tile,
                  bg=cfg.bg)
        i_on, t_on, _ = rasterize_cuda.composite_tiles_reference(
            on.starts[None], on.gaussian[None], *(a[None] for a in args[:4]),
            None, **kw)
        i_off, t_off, _ = rasterize_cuda.composite_tiles_reference(
            off.starts[None], off.gaussian[None],
            *(a[None] for a in args[:4]), None, **kw)
        # culled entries are skipped by every pixel: the same blend, up to
        # the chunk regrouping of the transmittance products
        np.testing.assert_allclose(i_on.numpy(), i_off.numpy(), atol=1e-5)
        np.testing.assert_allclose(t_on.numpy(), t_off.numpy(), atol=1e-5)

    def test_entry_cap_drops_farthest_first(self):
        jp, _, jcfg, cfg, _ = _both(n=400, seed=11)
        tp = _proj_from_jax(jp)
        full = _bin1(tp, cfg)
        total = int(full.starts[-1])
        assert total > 128
        small, jsmall = (dataclasses.replace(c, max_entries=128)
                         for c in (cfg, jcfg))
        capped = _bin1(tp, small)
        jb = j_bin_fused(jp, jsmall, pack_record_columns(jp, None))
        _assert_bins_match(jb, capped, np.asarray(jp.depth), cfg.num_tiles)
        assert int(capped.overflow) > 0
        depth = np.asarray(jp.depth)
        kept = capped.gaussian[:int(capped.starts[-1])].numpy()
        dropped = np.setdiff1d(full.gaussian[:total].numpy(), kept)
        assert depth[kept].max() <= depth[dropped].min()

    def test_fused_binning_batched_matches_per_frame(self):
        projs = [_both(n=400, seed=s)[0] for s in (1, 2, 3)]
        _, _, jcfg, cfg, _ = _both(n=400)
        batched = [np.stack([np.asarray(getattr(p, f)) for p in projs])
                   for f in projs[0]._fields]
        jbat = type(projs[0])(*(jnp.asarray(x) for x in batched))
        jb = j_bin_fused(jbat, jcfg, pack_record_columns(jbat, None))
        tb = bin_entries_fused(Projected(*(torch.as_tensor(x)
                                           for x in batched)), cfg)
        assert tb.starts.shape == (3, cfg.num_tiles + 1)
        for i in range(3):
            jbi = type(jb)(*(x[i] if x is not None and hasattr(x, "shape")
                             else x for x in jb))
            tbi = type(tb)(*(x[i] for x in tb))
            _assert_bins_match(jbi, tbi, batched[1][i], cfg.num_tiles)
            single = _bin1(_proj_from_jax(projs[i]), cfg)
            # the sort's permutation names frame i's slots as i * E + slot
            tbi = tbi._replace(perm=tbi.perm - i * cfg.max_entries)
            for a, b in zip(single, tbi):
                np.testing.assert_array_equal(a.numpy(), b.numpy())


class TestCompositor:
    def _jax_and_port(self, pack: bool, n=400, seed=11, **kw):
        jp, _, jcfg, cfg, _ = _both(n=n, seed=seed, **kw)
        sem = np.random.default_rng(3).integers(0, 900, n).astype(np.int32)
        jcfg = dataclasses.replace(jcfg, pack_records=pack)
        jb = j_bin_fused(jp, jcfg, pack_record_columns(jp, jnp.asarray(sem)),
                         carry_gid=False)
        ji, jt, js = composite_tiles_pallas(jp, jb, jcfg,
                                            semantics=jnp.asarray(sem),
                                            interpret=True)
        tp = _proj_from_jax(jp)
        tb = _bin1(tp, cfg)
        ti, tt, ts, _ = rasterize_cuda.composite_tiles(
            tb.starts[None], tb.gaussian[None], tp.mean2d[None],
            tp.conic[None], tp.opacity[None], tp.color[None],
            torch.as_tensor(sem), width=cfg.width, height=cfg.height,
            tile=cfg.tile, bg=cfg.bg)
        return (np.asarray(ji), np.asarray(jt), np.asarray(js),
                ti[0].numpy(), tt[0].numpy(), ts[0].numpy())

    def test_matches_pallas_unpacked(self):
        ji, jt, js, ti, tt, ts = self._jax_and_port(False, seed=7)
        # JAX carries colour as 10-bit fixed point over [0, 4]: half a
        # step (2e-3) per channel plus f32 blending noise
        np.testing.assert_allclose(ti, ji, atol=2.5e-3)
        np.testing.assert_allclose(tt, jt, atol=1e-4)
        # exact except where two contributors tie in weight
        assert np.mean(ts == js) > 0.999
        assert (ts == -1).any() and (ts >= 0).any()

    def test_matches_pallas_packed(self):
        ji, _, js, ti, _, ts = self._jax_and_port(True)
        assert _psnr(ti, ji) >= 40.0, _psnr(ti, ji)
        assert np.mean(ts == js) > 0.98

    def test_background_and_empty_tiles(self):
        # half the Gaussians behind the camera leaves tiles empty
        ji, jt, _, ti, tt, _ = self._jax_and_port(
            False, seed=2, bg=(0.9, 0.1, 0.3), behind=200)
        np.testing.assert_allclose(ti, ji, atol=2.5e-3)
        assert (tt == 1.0).any()

    def test_wrappers_take_no_plain_path_off_the_cpu(self):
        """Only CPU tensors take the plain versions: tensors on any other
        device go to the kernel or raise, never fall back."""
        _, tp, _, cfg, _ = _both(n=400, seed=1)
        plan = plan_emit(Projected(*(x[None] for x in tp)), cfg)
        meta = {k: (v.to("meta") if torch.is_tensor(v) else v)
                for k, v in plan.args.items()}
        with pytest.raises(ValueError, match="not supported"):
            rasterize_cuda.emit_entries(**meta)
        with pytest.raises(ValueError, match="not supported"):
            rasterize_cuda.sort_tiles(
                torch.zeros(1, 8, dtype=torch.int32, device="meta"), 9)
        with pytest.raises(ValueError, match="not supported"):
            rasterize_cuda.composite_tiles(
                *(x.to("meta") for x in (
                    torch.zeros(1, cfg.num_tiles + 1, dtype=torch.int32),
                    torch.zeros(1, 8, dtype=torch.int32), tp.mean2d[None],
                    tp.conic[None], tp.opacity[None], tp.color[None])),
                None, width=cfg.width, height=cfg.height, tile=cfg.tile,
                bg=cfg.bg)

    def test_plain_versions_count_no_launch(self):
        _, tp, _, cfg, _ = _both(n=400, seed=1)
        rasterize_cuda.reset_launch_counts()
        bins = _bin1(tp, cfg)
        rasterize_cuda.composite_tiles(
            bins.starts[None], bins.gaussian[None], tp.mean2d[None],
            tp.conic[None], tp.opacity[None], tp.color[None], None,
            width=cfg.width, height=cfg.height, tile=cfg.tile, bg=cfg.bg)
        assert rasterize_cuda.launch_counts == {"emit_entries": 0,
                                                "sort_tiles": 0,
                                                "composite_tiles": 0,
                                                "composite_bwd": 0,
                                                "sum_entry_rows": 0,
                                                "project_posed": 0,
                                                "normal_newton": 0}


class TestVsGolden:
    @pytest.mark.parametrize("seed,n,bg", [(0, 200, (0.0, 0.0, 0.0)),
                                           (5, 300, (1.0, 0.0, 0.5))])
    def test_render_matches_golden(self, seed, n, bg):
        s = _splats(n, seed)
        cfg = RasterConfig(width=64, height=48, bg=bg)
        w2c = np.eye(4, dtype=np.float32)
        w2c[2, 3] = 2.0
        out = render(
            PosedGaussians(torch.as_tensor(s["means"]),
                           torch.as_tensor(s["scales"]),
                           torch.as_tensor(s["quats"]),
                           torch.as_tensor(s["opacities"].reshape(-1))),
            make_camera(torch.as_tensor(w2c), 0.5, 0.5), cfg,
            torch.as_tensor(s["sh0"].reshape(-1, 3)),
            torch.as_tensor(s["shN"].reshape(-1, 45)))
        ref = golden.golden_render(
            s["means"], s["scales"], s["quats"], s["opacities"].reshape(-1),
            s["sh0"].reshape(-1, 3), s["shN"].reshape(-1, 45), w2c, 0.5, 0.5,
            JCfg(width=64, height=48, bg=bg))
        p = _psnr(out["rgb"].numpy(), np.clip(ref, 0, 10))
        assert p > 45.0, f"PSNR vs golden = {p:.2f}"
        assert int(out["overflow"]) == 0
