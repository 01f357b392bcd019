"""3DGS training loop: differentiable render + Adam + density control
(port of gsworld_tpu/train3dgs/train.py).

The forward render is the render path's own (projection, binning, the
plain compositor); its backward is the plain backward compositor through
``CompositeFunction``, then autograd through the projection and SH.  The viewspace-gradient statistic for
densification is the gradient of a zero offset ``d2d`` added to the
projected means.  Dead capacity slots carry opacity logit -10 and never
render.

The reference trains eagerly: it captures no CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from benchmark.reference.gsw.gs.model import SCENE_FIELDS, GaussianScene
from benchmark.reference.gsw.gs.transform import PosedGaussians
from benchmark.reference.gsw.render.camera import GSCamera, RasterConfig
from benchmark.reference.gsw.render.rasterize import project_frames, render_projected
from benchmark.reference.gsw.train3dgs.densify import (
    DensifyState,
    accumulate_stats,
    densify_and_prune,
    init_densify_state,
    pad_scene_capacity,
    reset_opacity,
)
from benchmark.reference.gsw.train3dgs.loss import gs_loss
from benchmark.reference.gsw.train3dgs.optim import (
    TRAINABLE,
    AdamState,
    OptimizationParams,
    adam_init,
    adam_update,
    learning_rates,
    write_step_scalars,
    zero_rows,
)


class TrainState(NamedTuple):
    scene: GaussianScene
    ds: DensifyState
    opt_state: AdamState
    step: int


def render_trainable(scene: GaussianScene, d2d, cam: GSCamera,
                     cfg: RasterConfig):
    """Differentiable render of one camera -> (image (H, W, 3), radii
    (N,)); ``d2d`` (N, 2) is the zero viewspace offset whose gradient is
    the densification statistic."""
    posed = PosedGaussians(means=scene.means, log_scales=scene.log_scales,
                           quats=scene.quats,
                           logit_opacities=scene.logit_opacities)
    flat, _ = project_frames(posed, cam, cfg, scene.sh0, scene.shN)
    flat = flat._replace(mean2d=flat.mean2d + d2d)
    img, _, _, _ = render_projected(flat, cfg)
    return img[0], flat.radius[0]


def _make_update(cfg: RasterConfig, params: OptimizationParams):
    """-> ``update(state, cam, target) -> (densify state, loss, image)``:
    the forward, the backward, Adam on the state's scene fields and
    moments in place (with the scalars ``write_step_scalars`` wrote) and
    the densify statistics."""
    # the Inria backward reports dL/dmean2D in NDC units (pixel grad x
    # 0.5 W, 0.5 H), to which densify_grad_threshold is calibrated; the
    # factors' tensor is made once per device, at the first (uncaptured)
    # step
    ndc_scale = {}

    def update(state: TrainState, cam: GSCamera, target):
        scene = state.scene
        leaves = {f: getattr(scene, f).detach().requires_grad_(True)
                  for f in TRAINABLE}
        d2d = torch.zeros((scene.num_gaussians, 2), dtype=scene.means.dtype,
                          device=scene.means.device, requires_grad=True)
        img, radii = render_trainable(dataclasses.replace(scene, **leaves),
                                      d2d, cam, cfg)
        loss = gs_loss(img, target, params.lambda_dssim)
        *g_leaves, g_d2d = torch.autograd.grad(loss,
                                               [*leaves.values(), d2d])
        # dead slots stay frozen
        alive = state.ds.alive
        grads = {f: g * alive.reshape((-1,) + (1,) * (g.dim() - 1))
                 for f, g in zip(TRAINABLE, g_leaves)}
        adam_update(scene, grads, state.opt_state)
        dev = g_d2d.device
        if dev not in ndc_scale:
            ndc_scale[dev] = torch.tensor(
                [0.5 * cfg.width, 0.5 * cfg.height], dtype=g_d2d.dtype,
                device=dev)
        ds = accumulate_stats(state.ds, g_d2d * ndc_scale[dev], radii)
        return ds, loss.detach(), img.detach()

    return update


def make_train_step(cfg: RasterConfig, params: OptimizationParams):
    """-> ``train_step(state, cam, target) -> (state, loss, image)``.  The
    step updates the scene fields, the Adam moments and the densify
    statistics in place."""
    lrs = learning_rates(params)
    update = _make_update(cfg, params)

    def train_step(state: TrainState, cam: GSCamera, target):
        write_step_scalars(state.opt_state, lrs)
        ds, loss, img = update(state, cam, target)
        state.opt_state.count += 1
        return (TrainState(scene=state.scene, ds=ds,
                           opt_state=state.opt_state, step=state.step + 1),
                loss, img)

    return train_step


@torch.no_grad()
def _write_state(state: TrainState, scene: GaussianScene,
                 ds: Optional[DensifyState] = None):
    """Copy ``scene`` (and ``ds``) into the state's own tensors."""
    for f in SCENE_FIELDS:
        dst, src = getattr(state.scene, f), getattr(scene, f)
        if dst is not src:
            dst.copy_(src)
    for dst, src in zip(state.ds, ds or ()):
        dst.copy_(src)


def iteration(it: int, state: TrainState, train_step, cameras, images,
              params: OptimizationParams, gen: torch.Generator,
              **densify_kw):
    """Iteration ``it`` (1-based) of ``train``'s loop: the train step
    against camera (it - 1) mod len(cameras), then the densify pass and
    the opacity reset where the schedule has them -> (state, loss)."""
    ci = (it - 1) % len(cameras)
    state, loss, _ = train_step(state, cameras[ci], images[ci])
    if (params.densify_from_iter <= it <= params.densify_until_iter
            and it % params.densification_interval == 0):
        scene2, ds2, changed = densify_and_prune(state.scene, state.ds, gen,
                                                 **densify_kw)
        # reset the Adam moments of the rows densify rewrote only
        zero_rows(state.opt_state, changed)
        _write_state(state, scene2, ds2)
    if it % params.opacity_reset_interval == 0:
        _write_state(state, reset_opacity(state.scene))
    return state, float(loss)


def train(scene: GaussianScene, cameras: Sequence[GSCamera], images,
          cfg: RasterConfig, params: Optional[OptimizationParams] = None,
          capacity: Optional[int] = None, seed: int = 0,
          scene_extent: float = 3.0, iterations: Optional[int] = None):
    """Train ``scene`` against (cameras[i], images[i]) pairs, cycling
    through the cameras; images are (H, W, 3) tensors on the scene's
    device.  Returns (scene, densify state, losses)."""
    params = params or OptimizationParams()
    iters = iterations or params.iterations
    dev = scene.means.device
    n0 = scene.num_gaussians
    capacity = capacity or int(n0 * 2)
    scene = pad_scene_capacity(scene, capacity)
    state = TrainState(scene=scene, ds=init_densify_state(capacity, n0, dev),
                       opt_state=adam_init(scene), step=0)
    train_step = make_train_step(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses = []
    for it in range(1, iters + 1):
        state, loss = iteration(
            it, state, train_step, cameras, images, params, gen,
            grad_threshold=params.densify_grad_threshold,
            percent_dense=params.percent_dense, scene_extent=scene_extent)
        losses.append(loss)
    return state.scene, state.ds, losses
