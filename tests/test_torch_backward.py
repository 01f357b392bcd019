"""The port's differentiable compositor (gsworld_tpu_torch.render
.rasterize.CompositeFunction) and its backward on the CPU, where the
wrappers take their plain PyTorch versions:

  (a) the plain backward against torch autograd through the plain
      forward, in f64;
  (b) torch.autograd.gradcheck of CompositeFunction in f64;
  (c) CompositeFunction against the JAX package's _composite_pallas_diff
      (Pallas forward and backward kernels in interpret mode) for an
      image loss and a transmittance loss;
  (d) the compositor gate of chip_smoke.py, which excuses transmittance
      stop flips and nothing else.

Inputs are made with numpy from a seed and fed to both packages.  The
backward kernel itself (csrc/composite_bwd.cu) is held against the plain
backward on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from gsworld_tpu_torch.render import rasterize_cuda as rc
from gsworld_tpu_torch.render.camera import RasterConfig
from gsworld_tpu_torch.render.project import Projected
from gsworld_tpu_torch.render.rasterize import CompositeFunction, bin_detached


def _splats2d(n, width, height, seed, tile, op_range=(0.2, 0.7),
              dtype=torch.float64):
    """``n`` random screen-space splats in one frame (1, n, ...): means in
    the frame, sigmas 1.5-5 px at random angles, colours in [0, 1]."""
    rng = np.random.default_rng(seed)
    m = rng.uniform([0, 0], [width, height], (n, 2))
    s = rng.uniform(1.5, 5.0, (n, 2))
    th = rng.uniform(0, np.pi, n)
    c, sn = np.cos(th), np.sin(th)
    cxx = c * c * s[:, 0] ** 2 + sn * sn * s[:, 1] ** 2
    cyy = sn * sn * s[:, 0] ** 2 + c * c * s[:, 1] ** 2
    cxy = c * sn * (s[:, 0] ** 2 - s[:, 1] ** 2)
    det = cxx * cyy - cxy * cxy
    conic = np.stack([cyy / det, -cxy / det, cxx / det], -1)
    r = np.ceil(3 * s.max(-1))
    gx, gy = -(-width // tile), -(-height // tile)
    rect = np.stack([np.clip(np.floor((m[:, 0] - r) / tile), 0, gx),
                     np.clip(np.floor((m[:, 1] - r) / tile), 0, gy),
                     np.clip(np.floor((m[:, 0] + r + tile - 1) / tile), 0, gx),
                     np.clip(np.floor((m[:, 1] + r + tile - 1) / tile), 0, gy)],
                    -1)
    t = lambda x, dt=dtype: torch.as_tensor(x[None], dtype=dt)  # noqa: E731
    return Projected(mean2d=t(m), depth=t(rng.uniform(1, 5, n), torch.float32),
                     conic=t(conic), color=t(rng.uniform(0, 1, (n, 3))),
                     opacity=t(rng.uniform(*op_range, n)),
                     radius=t(r, torch.int32), rect=t(rect, torch.int32))


def _bins(proj, cfg):
    return bin_detached(Projected(*(x.float() if x.is_floating_point() else x
                                    for x in proj)), cfg)


def test_plain_backward_matches_autograd_f64():
    """(a) Rows of the plain backward, scattered per Gaussian, equal torch
    autograd through the plain forward.  Both run the same f64 operations
    on the same transmittance sequence, so only summation order differs:
    1e-8 relative to each field's max."""
    W, H, tile = 40, 36, 16
    proj = _splats2d(40, W, H, seed=0, tile=tile)
    cfg = RasterConfig(width=W, height=H, tile=tile, max_entries=4096)
    bins = _bins(proj, cfg)
    assert int(bins.starts[0, -1]) > 100
    ins = [x.clone().requires_grad_() for x in
           (proj.mean2d, proj.conic, proj.opacity, proj.color)]
    bg = (0.1, 0.2, 0.3)
    img, T, _ = rc.composite_tiles_reference(
        bins.starts, bins.gaussian, *ins, None, width=W, height=H,
        tile=tile, bg=bg)
    rng = np.random.default_rng(1)
    g_img = torch.as_tensor(rng.normal(size=img.shape))
    g_T = torch.as_tensor(rng.normal(size=T.shape))
    want = torch.autograd.grad((img * g_img).sum() + (T * g_T).sum(), ins)
    rows = rc.composite_bwd_reference(
        bins.starts, bins.gaussian, proj.mean2d, proj.conic, proj.opacity,
        proj.color, img.detach(), T.detach(), g_img, g_T, width=W, height=H,
        tile=tile)
    assert rows.shape == (1, cfg.max_entries, rc.BWD_FIELDS)
    assert not rows[0, int(bins.starts[0, -1]):].any()
    acc = rc.sum_entry_rows(rows, bins.perm, bins.ends)
    got = (acc[..., 0:2], acc[..., 2:5], acc[..., 8], acc[..., 5:8])
    for name, a, b in zip(("mean2d", "conic", "opacity", "color"), want, got):
        scale = float(a.abs().max())
        assert scale > 0, name
        assert float((a - b).abs().max()) <= 1e-8 * scale, name


def test_composite_function_gradcheck_f64():
    """(b) gradcheck of CompositeFunction (plain versions on the CPU) in
    f64: 20 splats in a 32x32 frame with opacities 0.2-0.7, so no alpha
    sits at the 0.99 clamp and finite differences cross no threshold."""
    W = H = 32
    proj = _splats2d(20, W, H, seed=2, tile=32)
    cfg = RasterConfig(width=W, height=H, tile=32, max_entries=512,
                       bg=(0.3, 0.1, 0.2))
    bins = _bins(proj, cfg)
    ins = tuple(x.clone().requires_grad_() for x in
                (proj.mean2d, proj.conic, proj.opacity, proj.color))

    def f(*floats):
        return CompositeFunction.apply(*floats, bins, cfg)

    assert torch.autograd.gradcheck(f, ins, eps=1e-6, atol=1e-5, rtol=1e-3,
                                    fast_mode=True)


def _jax_and_port(n, **cfg_kw):
    """The JAX package's test scene (tests/test_pallas_kernel.py:_setup)
    with colours pre-quantised to the Pallas forward's 10-bit grid, as
    tests/test_pallas_backward.py does, so both forwards see the same
    colours; -> (JAX floats, JAX aux, JAX cfg, port floats, port bins,
    port cfg)."""
    import jax
    from gsworld_tpu.render.binning import bin_entries
    from tests.test_pallas_kernel import _setup

    proj, jcfg = _setup(n=n, **cfg_kw)
    c = jnp.round(jnp.clip(proj.color / 4.0, 0.0, 1.0) * 1023.0) \
        / 1023.0 * 4.0
    proj = proj._replace(color=c)
    floats = dict(mean2d=proj.mean2d, conic=proj.conic, color=proj.color,
                  opacity=proj.opacity)
    aux = (proj.radius, jax.lax.stop_gradient(proj.depth), proj.rect,
           bin_entries(proj, jcfg))
    cfg = RasterConfig(width=jcfg.width, height=jcfg.height, tile=jcfg.tile,
                       max_tiles_per_gaussian=jcfg.max_tiles_per_gaussian,
                       max_entries=jcfg.max_entries, bg=jcfg.bg)
    tp = Projected(*(torch.as_tensor(np.array(x))[None] for x in proj))
    bins = bin_detached(tp, cfg)
    port = {k: getattr(tp, k).clone().requires_grad_()
            for k in ("mean2d", "conic", "opacity", "color")}
    return floats, aux, jcfg, port, bins, cfg


@pytest.mark.parametrize("loss", ["image", "transmittance"])
def test_composite_function_matches_jax_pallas(loss):
    """(c) The two cases of tests/test_pallas_backward.py: gradients of
    sum(img * W) and of sum(img) + 0.5 sum(T) (with a background colour)
    agree with the Pallas kernels' at 1e-3 relative to each field's max,
    the bar the JAX package holds its own kernel to (its split-bf16
    prefix sums are the residual)."""
    import jax
    from gsworld_tpu.render.rasterize import _composite_pallas_diff

    if loss == "image":
        floats, aux, jcfg, port, bins, cfg = _jax_and_port(300)
        Wt = np.random.default_rng(3).normal(
            size=(jcfg.height, jcfg.width, 3)).astype(np.float32)

        def jloss(fp):
            img, _ = _composite_pallas_diff(jcfg, fp, aux)
            return jnp.sum(img * Wt)
    else:
        floats, aux, jcfg, port, bins, cfg = _jax_and_port(
            200, bg=(0.2, 0.5, 0.1))
        Wt = None

        def jloss(fp):
            img, T = _composite_pallas_diff(jcfg, fp, aux)
            return jnp.sum(img) + 0.5 * jnp.sum(T)

    v_j, g_j = jax.value_and_grad(jloss)(floats)
    img, T = CompositeFunction.apply(port["mean2d"], port["conic"],
                                     port["opacity"], port["color"],
                                     bins, cfg)
    if Wt is not None:
        v_p = (img[0] * torch.as_tensor(Wt)).sum()
    else:
        v_p = img.sum() + 0.5 * T.sum()
    v_p.backward()
    v_p = float(v_p.detach())
    assert abs(float(v_j) - v_p) < 1e-3 * max(1.0, abs(float(v_j)))
    for k in ("mean2d", "conic", "opacity", "color"):
        a = np.asarray(g_j[k])
        b = port[k].grad[0].numpy()
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-3,
                                   err_msg=k)


def test_compositor_gate_excuses_one_stop_flip():
    """(d) One pixel is driven onto the transmittance stop boundary: four
    splats stacked on it, the fourth taking T to 1e-4 within a few ulps.
    Two renders whose fourth opacity differs by four ulps (as two product
    orders can) stop on either side of it, so that pixel's T differs by
    ~9e-4: the plain max-abs gate would fail, and the repaired gate
    excuses exactly that pixel and holds every other one to 1e-4."""
    W = H = 16
    n = 4
    mean = np.full((n, 2), 7.0)
    conic = np.tile([1.0, 0.0, 1.0], (n, 1))
    op = np.array([0.9, 0.9, 0.9, 0.0], np.float32)
    T3 = np.float32(1.0)
    for o in op[:3]:
        T3 = np.float32(T3 * np.float32(1.0 - o))
    op[3] = np.float32(1.0) - np.float32(rc.T_EPS) / T3
    cfg = RasterConfig(width=W, height=H, tile=16, max_entries=64)
    outs = []
    for step in (+4, -4):
        o = op.copy()
        for _ in range(abs(step)):
            o[3] = np.nextafter(o[3], np.float32(np.sign(step)))
        proj = Projected(
            mean2d=torch.as_tensor(mean[None], dtype=torch.float32),
            depth=torch.arange(1, n + 1, dtype=torch.float32)[None],
            conic=torch.as_tensor(conic[None], dtype=torch.float32),
            color=torch.full((1, n, 3), 0.5),
            opacity=torch.as_tensor(o[None]),
            radius=torch.full((1, n), 4, dtype=torch.int32),
            rect=torch.tensor([[[0, 0, 1, 1]] * n], dtype=torch.int32))
        bins = bin_detached(proj, cfg)
        img, T, _ = rc.composite_tiles_reference(
            bins.starts, bins.gaussian, proj.mean2d, proj.conic,
            proj.opacity, proj.color, None, width=W, height=H, tile=16,
            bg=(0.0, 0.0, 0.0))
        outs.append((img, T))
    (ia, ta), (ib, tb) = outs
    assert float((ta - tb).abs().max()) > chip_smoke.RGB_TOL   # old gate trips
    rgb_err, t_err, excused = chip_smoke.composite_gate(ia, ta, ib, tb)
    assert int(excused.sum()) == 1 and bool(excused[0, 7, 7])
    assert float(rgb_err.max()) <= chip_smoke.RGB_TOL
    assert float(t_err.max()) <= chip_smoke.RGB_TOL
