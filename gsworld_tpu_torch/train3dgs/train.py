"""3DGS training loop: differentiable render + Adam + density control
(port of gsworld_tpu/train3dgs/train.py).

The forward render is the render path's own (projection, binning with the
emit kernel, compositor kernel); its backward is the backward kernel
(csrc/composite_bwd.cu) through ``CompositeFunction``, then autograd
through the projection and SH.  The viewspace-gradient statistic for
densification is the gradient of a zero offset ``d2d`` added to the
projected means.  Dead capacity slots carry opacity logit -10 and never
render.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch
from torch.profiler import record_function

from gsworld_tpu_torch.gs.model import GaussianScene
from gsworld_tpu_torch.gs.transform import PosedGaussians
from gsworld_tpu_torch.render.camera import GSCamera, RasterConfig
from gsworld_tpu_torch.render.rasterize import project_frames, render_projected
from gsworld_tpu_torch.train3dgs.densify import (
    DensifyState,
    accumulate_stats,
    densify_and_prune,
    init_densify_state,
    pad_scene_capacity,
    reset_opacity,
)
from gsworld_tpu_torch.train3dgs.loss import gs_loss
from gsworld_tpu_torch.train3dgs.optim import (
    TRAINABLE,
    AdamState,
    OptimizationParams,
    adam_init,
    adam_step,
    learning_rates,
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
    with record_function("gsw.project"):
        flat, _ = project_frames(posed, cam, cfg, scene.sh0, scene.shN)
        flat = flat._replace(mean2d=flat.mean2d + d2d)
    img, _, _, _ = render_projected(flat, cfg)
    return img[0], flat.radius[0]


def make_train_step(cfg: RasterConfig, params: OptimizationParams):
    """-> ``train_step(state, cam, target) -> (state, loss, image)``.  The
    step updates the scene fields and the Adam moments in place."""
    lrs = learning_rates(params)
    # the Inria backward reports dL/dmean2D in NDC units (pixel grad x
    # 0.5 W, 0.5 H), to which densify_grad_threshold is calibrated
    ndc_scale = (0.5 * cfg.width, 0.5 * cfg.height)

    def train_step(state: TrainState, cam: GSCamera, target):
        scene = state.scene
        leaves = {f: getattr(scene, f).detach().requires_grad_(True)
                  for f in TRAINABLE}
        d2d = torch.zeros((scene.num_gaussians, 2), dtype=scene.means.dtype,
                          device=scene.means.device, requires_grad=True)
        img, radii = render_trainable(dataclasses.replace(scene, **leaves),
                                      d2d, cam, cfg)
        with record_function("gsw.loss"):
            loss = gs_loss(img, target, params.lambda_dssim)
        *g_leaves, g_d2d = torch.autograd.grad(loss,
                                               [*leaves.values(), d2d])
        # dead slots stay frozen
        alive = state.ds.alive
        grads = {f: g * alive.reshape((-1,) + (1,) * (g.dim() - 1))
                 for f, g in zip(TRAINABLE, g_leaves)}
        with record_function("gsw.adam"):
            adam_step(scene, grads, state.opt_state, lrs)
        ds = accumulate_stats(state.ds, g_d2d * g_d2d.new_tensor(ndc_scale),
                              radii)
        return (TrainState(scene=scene, ds=ds, opt_state=state.opt_state,
                           step=state.step + 1),
                loss.detach(), img.detach())

    return train_step


def train(scene: GaussianScene, cameras: Sequence[GSCamera], images,
          cfg: RasterConfig, params: Optional[OptimizationParams] = None,
          capacity: Optional[int] = None, seed: int = 0,
          scene_extent: float = 3.0, iterations: Optional[int] = None,
          callback: Optional[Callable] = None):
    """Train ``scene`` against (cameras[i], images[i]) pairs, cycling
    through the cameras; images are (H, W, 3) tensors on the scene's
    device.  ``callback(it, state, loss, densified)``, when given, runs
    after every iteration.  Returns (scene, densify state, losses)."""
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
        ci = (it - 1) % len(cameras)
        state, loss, _ = train_step(state, cameras[ci], images[ci])
        losses.append(float(loss))
        densified = (params.densify_from_iter <= it
                     <= params.densify_until_iter
                     and it % params.densification_interval == 0)
        if densified:
            scene2, ds2, changed = densify_and_prune(
                state.scene, state.ds, gen,
                grad_threshold=params.densify_grad_threshold,
                percent_dense=params.percent_dense,
                scene_extent=scene_extent)
            # reset the Adam moments of the rows densify rewrote only
            zero_rows(state.opt_state, changed)
            state = state._replace(scene=scene2, ds=ds2)
        if it % params.opacity_reset_interval == 0:
            state = state._replace(scene=reset_opacity(state.scene))
        if callback is not None:
            callback(it, state, losses[-1], densified)
    return state.scene, state.ds, losses
