"""The train path's sums in a fixed order, on the CPU (plain versions):

  (a) the per-Gaussian sum in slot order (rasterize_cuda.sum_entry_rows)
      of the plain backward's rows against the JAX package's
      composite_bwd_pallas (Pallas backward in interpret mode, then its
      `.at[].add`) on the same NumPy inputs;
  (b) the same sum against the index_add_ form it replaced;
  (c) the same sum, bit for bit, when the sorted order of the entries is
      permuted but each slot keeps its row: it depends on slot order only
      (and a sum in sorted order would not);
  (d) the sum against a literal float32 loop in slot order, bit for bit;
  (e) EntryBins' slot layout and sort permutation against the binning's
      own outputs;
  (f) the SSIM blur's shifted adds against the replicate-pad convolution
      they replaced, and their backward by gradcheck;
  (g) utils.determinism: one train step calls no op that adds in no fixed
      order on the card, and the audit names the ops it is meant to.

The kernels themselves (csrc/composite_bwd.cu's parts, csrc/entry_rows.cu)
are held to these plain versions bit for bit on the card by
chip_smoke.py (phase 3b), and the train step's repeats by phase 5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsworld_tpu_torch.gs import synthetic
from gsworld_tpu_torch.gs.model import scene_from_splats
from gsworld_tpu_torch.render import rasterize_cuda as rc
from gsworld_tpu_torch.render.binning import plan_emit
from gsworld_tpu_torch.render.camera import RasterConfig, make_camera
from gsworld_tpu_torch.render.project import Projected
from gsworld_tpu_torch.render.rasterize import bin_detached
from gsworld_tpu_torch.train3dgs import densify
from gsworld_tpu_torch.train3dgs.loss import _blur, _EdgeBlur, _gaussian_taps
from gsworld_tpu_torch.train3dgs.optim import OptimizationParams, adam_init
from gsworld_tpu_torch.train3dgs.train import TrainState, make_train_step
from gsworld_tpu_torch.utils.determinism import OpAudit, audit
from tests.test_torch_backward import _jax_and_port, _splats2d

FIELDS = (("mean2d", slice(0, 2)), ("conic", slice(2, 5)),
          ("color", slice(5, 8)), ("opacity", slice(8, 9)))


def _plain_rows(port, bins, cfg, g_img, g_T):
    """The plain forward and backward of the port on its bins -> rows
    (F, E, 9)."""
    p = {k: v.detach() for k, v in port.items()}
    args = (bins.starts, bins.gaussian, p["mean2d"], p["conic"],
            p["opacity"], p["color"])
    kw = dict(width=cfg.width, height=cfg.height, tile=cfg.tile)
    img, T, _ = rc.composite_tiles_reference(*args, None, bg=cfg.bg, **kw)
    return rc.composite_bwd_reference(*args, img, T, g_img, g_T, **kw)


def test_fixed_order_sum_matches_jax_pallas():
    """(a) Per-Gaussian gradients of the plain backward summed in slot
    order agree with the Pallas backward's at 1e-3 relative to each
    field's max: the bar tests/test_torch_backward.py (c) holds the port
    to against the same kernels (their split-bf16 prefix sums are the
    residual; the sum's order is far below it)."""
    from gsworld_tpu.render.rasterize import _pallas_proj
    from gsworld_tpu.render.rasterize_pallas import (composite_bwd_pallas,
                                                     composite_tiles_pallas)
    floats, aux, jcfg, port, bins, cfg = _jax_and_port(300)
    proj, ebins = _pallas_proj(floats, aux)
    img, T = composite_tiles_pallas(proj, ebins, jcfg)
    rng = np.random.default_rng(5)
    g_img = rng.normal(size=img.shape).astype(np.float32)
    g_T = (0.5 * rng.normal(size=T.shape)).astype(np.float32)
    want = composite_bwd_pallas(proj, ebins, jcfg, jnp.asarray(g_img),
                                jnp.asarray(g_T), img, T)
    rows = _plain_rows(port, bins, cfg, torch.as_tensor(g_img)[None],
                       torch.as_tensor(g_T)[None])
    acc = rc.sum_entry_rows(rows, bins.perm, bins.ends)[0]
    for name, sl in FIELDS:
        a = np.asarray(want[name]).reshape(acc.shape[0], -1)
        b = acc[:, sl].numpy()
        scale = np.abs(a).max()
        assert scale > 0, name
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-3,
                                   err_msg=name)


def _rows_and_bins(seed=0, n=60, W=64, H=48, tile=16):
    """Random f32 rows at the sorted positions of a two-frame binning of
    ``n`` splats (the frames' perm offsets differ) -> (rows, bins, n)."""
    frames = [_splats2d(n, W, H, seed=seed + f, tile=tile,
                        dtype=torch.float32) for f in range(2)]
    proj = Projected(*(torch.cat(xs) for xs in zip(*frames)))
    cfg = RasterConfig(width=W, height=H, tile=tile, max_entries=1024)
    bins = bin_detached(proj, cfg)
    rng = np.random.default_rng(seed + 7)
    E = cfg.max_entries
    rows = (rng.normal(size=(2, E, rc.BWD_FIELDS))
            * 10.0 ** rng.uniform(-3, 3, (2, E, 1))).astype(np.float32)
    live = torch.arange(E)[None] < bins.starts[:, -1:]
    rows = torch.where(live[..., None], torch.as_tensor(rows), 0.0)
    return rows, bins, n


def test_fixed_order_sum_matches_index_add():
    """(b) The slot-order sum against the index_add_ it replaced (sorted
    positions scattered by Gaussian id), on the plain backward's rows of
    the JAX test scene: within 1e-6 of each field's max (f32 sums in
    another order)."""
    _, _, _, port, bins, cfg = _jax_and_port(300)
    rng = np.random.default_rng(6)
    g_img = torch.as_tensor(rng.normal(size=(1, cfg.height, cfg.width, 3)),
                            dtype=torch.float32)
    g_T = torch.as_tensor(rng.normal(size=(1, cfg.height, cfg.width)),
                          dtype=torch.float32)
    rows = _plain_rows(port, bins, cfg, g_img, g_T)
    N = port["opacity"].shape[1]
    got = rc.sum_entry_rows(rows, bins.perm, bins.ends)
    idx = bins.gaussian.long().clamp_min(0).reshape(-1)
    old = torch.zeros((N, rc.BWD_FIELDS)).index_add_(
        0, idx, rows.reshape(-1, rc.BWD_FIELDS))[None]
    for name, sl in FIELDS:
        scale = float(old[..., sl].abs().max())
        assert scale > 0, name
        assert float((got[..., sl] - old[..., sl]).abs().max()) \
            <= 1e-6 * scale, name


def test_sum_depends_on_slot_order_only():
    """(c) Moving every entry to another sorted position, with its row
    and its slot, leaves the slot-order sum bit for bit as it was; a sum
    in sorted order (index_add_ on the CPU) changes its last bits."""
    rows, bins, n = _rows_and_bins()
    F, E, K = rows.shape
    want = rc.sum_entry_rows(rows, bins.perm, bins.ends)
    sigma = torch.as_tensor(np.random.default_rng(3).permutation(E))
    rows2 = torch.empty_like(rows)
    perm2 = torch.empty_like(bins.perm)
    rows2[:, sigma] = rows
    perm2[:, sigma] = bins.perm
    got = rc.sum_entry_rows(rows2, perm2, bins.ends)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    def sorted_order_sum(r, perm):
        slot = perm.reshape(-1)
        f = slot // E
        owner = rc.emit_owner_reference(bins.ends, E)          # (F, E)
        gid = torch.where(owner.reshape(-1)[slot] < n,
                          f * n + owner.reshape(-1)[slot], F * n)
        acc = torch.zeros((F * n + 1, K))
        return acc.index_add_(0, gid, r.reshape(-1, K))[:-1]

    a = sorted_order_sum(rows, bins.perm)
    b = sorted_order_sum(rows2, perm2)
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-3)
    assert not torch.equal(a, b)


def test_sum_is_a_float32_loop_in_slot_order():
    """(d) Each Gaussian's sum is 0.0f + row(slot ends[g-1]) + ... +
    row(slot ends[g] - 1) in float32, bit for bit, with each slot's row
    read at its sorted position."""
    rows, bins, n = _rows_and_bins(seed=4)
    F, E, K = rows.shape
    got = rc.sum_entry_rows(rows, bins.perm, bins.ends).numpy()
    r = rows.numpy()
    pos = np.empty(F * E, np.int64)
    pos[bins.perm.reshape(-1).numpy()] = np.arange(F * E)
    ends = bins.ends.numpy()
    assert (np.diff(ends, axis=1) > 1).any()
    for f in range(F):
        for g in range(n):
            acc = np.zeros(K, np.float32)
            for k in range(ends[f, g - 1] if g else 0, ends[f, g]):
                acc = acc + r.reshape(F * E, K)[pos[f * E + k]]
            assert np.array_equal(acc.view(np.int32),
                                  got[f, g].view(np.int32)), (f, g)


def test_entry_bins_carry_slot_layout_and_perm():
    """(e) ``EntryBins.ends`` is plan_emit's slot ends; ``perm`` maps each
    sorted position to its frame's slot: the emitted ids read through it
    are the sorted ids (``gid[perm] == gaussian``), and every live entry
    lies in its Gaussian's slot range."""
    W, H, tile = 64, 48, 16
    frames = [_splats2d(60, W, H, seed=10 + f, tile=tile,
                        dtype=torch.float32) for f in range(2)]
    proj = Projected(*(torch.cat(xs) for xs in zip(*frames)))
    cfg = RasterConfig(width=W, height=H, tile=tile, max_entries=1024)
    bins = bin_detached(proj, cfg)
    plan = plan_emit(proj, cfg)
    keys, gid = rc.emit_entries(**plan.args)
    F, E = gid.shape
    assert torch.equal(bins.ends, plan.args["ends"])
    assert bins.perm.shape == (F, E) and bins.perm.dtype == torch.int64
    assert torch.equal(gid.reshape(-1)[bins.perm], bins.gaussian)
    f = torch.arange(F)[:, None]
    slot = bins.perm - f * E
    assert bool(((slot >= 0) & (slot < E)).all())
    live = torch.arange(E)[None] < bins.starts[:, -1:]
    g = bins.gaussian.long().clamp_min(0)
    first = torch.where(g > 0, torch.gather(
        bins.ends, 1, (g - 1).clamp_min(0)), 0)
    last = torch.gather(bins.ends, 1, g)
    assert bool(((first <= slot) & (slot < last))[live].all())
    assert int(live.sum()) > 100


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blur_matches_replicate_pad_convolution(dtype):
    """(f) The separable blur as shifted adds equals the depthwise
    convolution over replicate-padded input it replaced (1e-6 relative
    in f32, 1e-12 in f64: sums in another order), in value and in the
    gradient of a random projection."""
    import torch.nn.functional as F
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.random((5, 23, 31)), dtype=dtype)
    w = torch.as_tensor(rng.normal(size=x.shape), dtype=dtype)
    g = torch.as_tensor(_gaussian_taps(dtype), dtype=dtype)
    c = x.shape[0]

    def conv_blur(v):
        v = F.conv2d(F.pad(v[None], (0, 0, 5, 5), mode="replicate"),
                     g.reshape(1, 1, 11, 1).repeat(c, 1, 1, 1), groups=c)
        v = F.conv2d(F.pad(v, (5, 5, 0, 0), mode="replicate"),
                     g.reshape(1, 1, 1, 11).repeat(c, 1, 1, 1), groups=c)
        return v[0]

    tol = 1e-6 if dtype == torch.float32 else 1e-12
    xa = x.clone().requires_grad_()
    xb = x.clone().requires_grad_()
    ya, yb = _blur(xa), conv_blur(xb)
    assert float((ya - yb).detach().abs().max()) <= tol
    (ya * w).sum().backward()
    (yb * w).sum().backward()
    assert float((xa.grad - xb.grad).abs().max()) <= tol * float(
        xb.grad.abs().max())


def test_blur_gradcheck_f64():
    """(f) gradcheck of one edge-padded pass along each axis in f64."""
    x = torch.as_tensor(np.random.default_rng(1).random((2, 9, 13)),
                        dtype=torch.float64).requires_grad_()
    taps = _gaussian_taps(torch.float64)
    for dim in (1, 2):
        assert torch.autograd.gradcheck(
            lambda v, d=dim: _EdgeBlur.apply(v, d, taps), (x,))


def _tiny_train_step():
    rng = np.random.default_rng(0)
    splats = synthetic.make_blob(rng, 120, [0, 0, 0], 0.4, [0.7, 0.3, 0.2],
                                 0, log_scale_mean=-2.5)
    sc = densify.pad_scene_capacity(scene_from_splats(splats, device="cpu"),
                                    128)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.0
    cam = make_camera(torch.as_tensor(w2c), 0.5, 0.5)
    state = TrainState(scene=sc,
                       ds=densify.init_densify_state(128, 120, "cpu"),
                       opt_state=adam_init(sc), step=0)
    target = torch.as_tensor(rng.random((48, 48, 3)), dtype=torch.float32)
    step = make_train_step(RasterConfig(width=48, height=48),
                           OptimizationParams())
    return lambda: step(state, cam, target)


def test_train_step_calls_no_nondeterministic_op(monkeypatch):
    """(g) One train step of 120 Gaussians at 48x48 under the audit, with
    the kernels' plain versions left out (the card runs the kernels):
    no op that adds in no fixed order on the card (the SSIM convolution
    and pad and the per-Gaussian index_add_ were such ops)."""
    mode = OpAudit()
    for name in ("emit_entries_reference", "composite_tiles_reference",
                 "pack_records_reference", "composite_bwd_reference",
                 "sum_entry_rows_reference"):
        plain = getattr(rc, name)

        def ignored(*a, _plain=plain, **k):
            with mode.ignoring():
                return _plain(*a, **k)

        monkeypatch.setattr(rc, name, ignored)
    (_, loss, _), found = audit(_tiny_train_step(), mode)
    assert found == {}
    assert np.isfinite(float(loss))
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("case", ["index_add", "replicate_pad",
                                  "conv_backward", "index_put_accumulate",
                                  "scatter_add", "reflect_pad"])
def test_audit_names_nondeterministic_ops(case):
    """(g) The audit names each kind of op it is meant to find, and
    nothing in its deterministic neighbours."""
    import torch.nn.functional as F
    x = torch.zeros(8)
    rep = torch.tensor([1, 1, 2])
    uniq = torch.tensor([1, 2, 3])
    v = torch.ones(3)
    calls = {
        "index_add": (lambda: x.clone().index_add_(0, rep, v),
                      lambda: x.clone().index_copy_(0, uniq, v)),
        "replicate_pad": (
            lambda: F.pad(x[None, None].requires_grad_(), (2, 2),
                          mode="replicate").sum().backward(),
            lambda: F.pad(x[None, None].requires_grad_(), (2, 2)
                          ).sum().backward()),
        "conv_backward": (
            lambda: F.conv1d(x[None, None].requires_grad_(),
                             torch.ones(1, 1, 3)).sum().backward(),
            lambda: (x.requires_grad_() * 2).sum().backward()),
        "index_put_accumulate": (
            lambda: x.clone().index_put_((uniq,), v, accumulate=True),
            lambda: x.clone().index_put_((uniq,), v)),
        "scatter_add": (lambda: x.clone().scatter_add_(0, uniq, v),
                        lambda: x.clone().scatter_(0, uniq, v)),
        "reflect_pad": (
            lambda: F.pad(x[None, None].requires_grad_(), (2, 2),
                          mode="reflect").sum().backward(),
            lambda: F.pad(x[None, None].requires_grad_(), (2, 2),
                          value=1.0).sum().backward()),
    }
    bad, good = calls[case]
    assert audit(bad)[1] != {}
    assert audit(good)[1] == {}
