"""3DGS training loop: differentiable render + Adam + density control
(port of gsworld_tpu/train3dgs/train.py).

The forward render is the render path's own (projection, binning with the
emit kernel, compositor kernel); its backward is the backward kernel
(csrc/composite_bwd.cu) through ``CompositeFunction``, then autograd
through the projection and SH.  The viewspace-gradient statistic for
densification is the gradient of a zero offset ``d2d`` added to the
projected means.  Dead capacity slots carry opacity logit -10 and never
render.

On the card ``train`` replays one CUDA graph of the train step per
iteration, as the JAX package runs its jitted ``train_step``, and one
CUDA graph of each densify pass (``densify_graph``), as it runs its
jitted ``densify_and_prune``; both are ``utils.cuda_graph.FnGraph``s
that hold the TrainState they were captured on and update it in place,
and densify and the opacity reset run between replays and write into
its tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from gsworld_tpu_torch.gs.model import SCENE_FIELDS, GaussianScene
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
    adam_update,
    learning_rates,
    write_step_scalars,
    zero_rows,
)
from gsworld_tpu_torch.utils import cuda_graph
from gsworld_tpu_torch.utils.profiling import host_waits, span, stamp


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
    the densify statistics.  It reads nothing from the host, so it
    captures into a CUDA graph.  On a card it stamps the device's clock
    (``utils.profiling.stamp``) at its begin, after the loss, before Adam
    and at its end."""
    # the Inria backward reports dL/dmean2D in NDC units (pixel grad x
    # 0.5 W, 0.5 H), to which densify_grad_threshold is calibrated; the
    # factors' tensor is made once per device, at the first (uncaptured)
    # step
    ndc_scale = {}

    def update(state: TrainState, cam: GSCamera, target):
        scene = state.scene
        dev = scene.means.device
        stamp("train.begin", dev)
        leaves = {f: getattr(scene, f).detach().requires_grad_(True)
                  for f in TRAINABLE}
        d2d = torch.zeros((scene.num_gaussians, 2), dtype=scene.means.dtype,
                          device=scene.means.device, requires_grad=True)
        img, radii = render_trainable(dataclasses.replace(scene, **leaves),
                                      d2d, cam, cfg)
        loss = gs_loss(img, target, params.lambda_dssim)
        stamp("train.forward|backward", dev)
        *g_leaves, g_d2d = torch.autograd.grad(loss,
                                               [*leaves.values(), d2d])
        # dead slots stay frozen
        alive = state.ds.alive
        grads = {f: g * alive.reshape((-1,) + (1,) * (g.dim() - 1))
                 for f, g in zip(TRAINABLE, g_leaves)}
        stamp("train.backward|update", dev)
        adam_update(scene, grads, state.opt_state)
        if dev not in ndc_scale:
            ndc_scale[dev] = torch.tensor(
                [0.5 * cfg.width, 0.5 * cfg.height], dtype=g_d2d.dtype,
                device=dev)
        ds = accumulate_stats(state.ds, g_d2d * ndc_scale[dev], radii)
        stamp("train.end", dev)
        return ds, loss.detach(), img.detach()

    return update


def _held(g: cuda_graph.FnGraph, state: TrainState) -> cuda_graph.FnGraph:
    """``g``, a graph that holds the TrainState it was captured on as its
    first input; another state raises ``ValueError``."""
    if state.scene.means is not g.inputs[0].scene.means:
        raise ValueError(f"{g.what} serves the train state it was "
                         f"captured on")
    return g


def _densify(state: TrainState, noise, generator=None, **densify_kw):
    """One densify + prune pass with its reset of the rewritten rows' Adam
    moments (``densify_and_prune``, ``zero_rows``), written into the
    state's own tensors; the split noise is ``noise`` (N, 3), or drawn
    from ``generator``."""
    scene, ds, changed = densify_and_prune(state.scene, state.ds, generator,
                                           noise=noise, **densify_kw)
    zero_rows(state.opt_state, changed)
    _write_state(state, scene, ds)


def densify_graph(state: TrainState, **densify_kw) -> cuda_graph.FnGraph:
    """One densify pass of ``state`` (``_densify``) captured into one CUDA
    graph, the counterpart of the JAX package's jitted
    ``densify_and_prune``: ``graph(state, noise)`` copies the split noise
    (N, 3) into its static one and densifies the state it holds, the one
    it was captured on."""
    means = state.scene.means
    return cuda_graph.FnGraph(
        functools.partial(_densify, **densify_kw), means.device,
        (state, torch.zeros_like(means)), "the densify pass")


def make_train_step(cfg: RasterConfig, params: OptimizationParams,
                    graph: bool = True):
    """-> ``train_step(state, cam, target) -> (state, loss, image)``.  The
    step updates the scene fields, the Adam moments and the densify
    statistics in place.  With ``graph`` (the default) and a state on the
    card, the first call captures the step into one CUDA graph (the
    counterpart of the JAX package's jitted ``train_step``: the forward,
    the loss, the backward kernel, the alive mask, Adam and the densify
    statistics), which every call replays with its camera and target
    copied in; the loss and image it returns are tensors of their own.
    Such a step serves one state: the one of its first call, which the
    graph holds and updates (each step returns that state again).
    Another state raises ``ValueError``: step it with a new
    ``make_train_step``.  ``graph=False`` and the CPU step eagerly, any
    state."""
    lrs = learning_rates(params)
    update = _make_update(cfg, params)
    graphs = []

    def carried(state: TrainState, cam: GSCamera, target):
        """``update`` writing its densify state into ``state``'s."""
        with torch.enable_grad():
            ds, loss, img = update(state, cam, target)
        cuda_graph.copy_tree(state.ds, ds)
        return loss, img

    def train_step(state: TrainState, cam: GSCamera, target):
        write_step_scalars(state.opt_state, lrs)
        dev = state.scene.means.device
        if cuda_graph.graphed(graph, dev):
            if not graphs:
                graphs.append(cuda_graph.FnGraph(
                    carried, dev,
                    (state, *cuda_graph.clone_tree((cam, target))),
                    "the train step",
                    spans=dict(launch="gsw.train.launch")))
            loss, img = _held(graphs[0], state)(state, cam, target)
            ds = state.ds
        else:
            ds, loss, img = update(state, cam, target)
        state.opt_state.count += 1
        return (TrainState(scene=state.scene, ds=ds,
                           opt_state=state.opt_state, step=state.step + 1),
                loss, img)

    return train_step


@torch.no_grad()
def _write_state(state: TrainState, scene: GaussianScene,
                 ds: Optional[DensifyState] = None):
    """Copy ``scene`` (and ``ds``) into the state's own tensors, which a
    train-step graph reads."""
    for f in SCENE_FIELDS:
        dst, src = getattr(state.scene, f), getattr(scene, f)
        if dst is not src:
            dst.copy_(src)
    for dst, src in zip(state.ds, ds or ()):
        dst.copy_(src)


def train(scene: GaussianScene, cameras: Sequence[GSCamera], images,
          cfg: RasterConfig, params: Optional[OptimizationParams] = None,
          capacity: Optional[int] = None, seed: int = 0,
          scene_extent: float = 3.0, log_every: int = 0,
          iterations: Optional[int] = None, *,
          callback: Optional[Callable] = None, graph: bool = True):
    """Train ``scene`` against (cameras[i], images[i]) pairs, cycling
    through the cameras; images are (H, W, 3) tensors on the scene's
    device.  Every ``log_every`` iterations (0: never) it prints the JAX
    package's line ``iter {it}: loss={loss:.4f} alive={n}``.
    ``callback(it, state, loss, densified)``, when given, runs after
    every iteration.  On the card with ``graph`` (the default) every
    iteration replays one CUDA graph of the train step
    (``make_train_step``), each densify pass replays one CUDA graph
    (``densify_graph``, captured at the first pass), and densify and the
    opacity reset write into the state both graphs hold between replays;
    ``graph=False`` steps and densifies eagerly.  Returns (scene,
    densify state, losses)."""
    params = params or OptimizationParams()
    iters = iterations or params.iterations
    dev = scene.means.device
    n0 = scene.num_gaussians
    capacity = capacity or int(n0 * 2)
    scene = pad_scene_capacity(scene, capacity)
    state = TrainState(scene=scene, ds=init_densify_state(capacity, n0, dev),
                       opt_state=adam_init(scene), step=0)
    train_step = make_train_step(cfg, params, graph=graph)
    gen = torch.Generator(device=dev).manual_seed(seed)
    densify_kw = dict(grad_threshold=params.densify_grad_threshold,
                      percent_dense=params.percent_dense,
                      scene_extent=scene_extent)
    graphed = cuda_graph.graphed(graph, dev)
    densify_g = None

    losses = []
    for it in range(1, iters + 1):
        with span("gsw.train.iter"):
            ci = (it - 1) % len(cameras)
            state, loss, _ = train_step(state, cameras[ci], images[ci])
            with span("gsw.train.loss_read"):
                host_waits("loss_read", loss.device)
                losses.append(float(loss))
            densified = (params.densify_from_iter <= it
                         <= params.densify_until_iter
                         and it % params.densification_interval == 0)
            if densified and graphed:
                if densify_g is None:
                    densify_g = densify_graph(state, **densify_kw)
                means = state.scene.means
                _held(densify_g, state)(state, torch.randn(
                    means.shape, generator=gen, dtype=means.dtype,
                    device=dev))
            elif densified:
                _densify(state, None, gen, **densify_kw)
            if it % params.opacity_reset_interval == 0:
                _write_state(state, reset_opacity(state.scene))
        if log_every and it % log_every == 0:
            print(f"iter {it}: loss={losses[-1]:.4f} "
                  f"alive={int(state.ds.alive.sum())}", flush=True)
        if callback is not None:
            callback(it, state, losses[-1], densified)
    return state.scene, state.ds, losses
