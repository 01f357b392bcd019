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
iteration (``TrainStepGraph``), as the JAX package runs its jitted
``train_step``, and one CUDA graph of each densify pass
(``DensifyGraph``), as it runs its jitted ``densify_and_prune``; densify
and the opacity reset run between replays and write into the train-step
graph's buffers.
"""

from __future__ import annotations

import dataclasses
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
from gsworld_tpu_torch.utils.cuda_graph import capture, device_guard
from gsworld_tpu_torch.utils.profiling import count, host_waits, span, stamp


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


def _clone_train_state(state: TrainState) -> TrainState:
    opt = state.opt_state
    return TrainState(
        scene=GaussianScene(**{f: getattr(state.scene, f).clone()
                               for f in SCENE_FIELDS}),
        ds=DensifyState(*(x.clone() for x in state.ds)),
        opt_state=AdamState(mu={k: v.clone() for k, v in opt.mu.items()},
                            nu={k: v.clone() for k, v in opt.nu.items()},
                            count=opt.count, scalars=opt.scalars.clone()),
        step=state.step)


class TrainStepGraph:
    """One train step (``_make_update``'s ``update``) captured into one
    CUDA graph, the counterpart of the JAX package's jitted
    ``train_step``: the forward (emit and compositor kernels), the loss,
    ``torch.autograd.grad`` through the backward kernel, the alive mask,
    Adam and the densify statistics.

    Its static buffers are the tensors of the TrainState it was captured
    on (scene fields, Adam moments and scalars, densify statistics), which
    every replay updates in place, and a camera and a target image, which
    each call copies in.  What changes them outside the graph (densify,
    an opacity reset, the step's Adam scalars) writes into those tensors.
    ``loss`` and ``img`` are static outputs, overwritten by every replay;
    a call returns clones of them.

    Captured by ``utils.cuda_graph.capture``, as ``envs.base.StepGraph``
    is, after WARMUP steps on a clone of the state (which build the
    kernels and fill the lazy caches and leave the state as it was).  A
    failed capture raises: nothing falls back to the eager step."""

    WARMUP = 2

    def __init__(self, update, state: TrainState, cam: GSCamera, target):
        self.device = state.scene.means.device
        self.state = state
        self.cam = GSCamera(*(x.clone() for x in cam))
        self.target = target.clone()

        def warm():
            s = _clone_train_state(state)
            for _ in range(self.WARMUP):
                s = s._replace(ds=update(s, self.cam, self.target)[0])

        def body():
            ds, loss, img = update(state, self.cam, self.target)
            for dst, src in zip(state.ds, ds):
                dst.copy_(src)
            return loss, img

        self.graph, (self.loss, self.img) = capture(
            body, warm, self.device, "the train step")

    def __call__(self, state: TrainState, cam: GSCamera, target):
        """One step of the state it was captured on against (``cam``,
        ``target``) -> (densify state, loss, image); the loss and the
        image in tensors of their own, as the eager step returns them."""
        if state.scene.means is not self.state.scene.means:
            raise ValueError("a train-step graph steps the state it was "
                             "captured on")
        with torch.cuda.device(self.device):
            for dst, src in zip(self.cam, cam):
                dst.copy_(src)
            self.target.copy_(target)
            with span("gsw.train.launch"):
                self.graph.replay()
            count("graph.replays", "the train step")
            return self.state.ds, self.loss.clone(), self.img.clone()


class DensifyGraph:
    """One densify + prune pass with its reset of the rewritten rows' Adam
    moments, written into the TrainState's own tensors
    (``densify_and_prune``, ``zero_rows`` and ``_write_state``), captured
    into one CUDA graph: the counterpart of the JAX package's jitted
    ``densify_and_prune``.  Its static input is the split noise (N, 3),
    which each call fills from ``generator`` with the very draw the eager
    pass makes.  It serves the state it was captured on.

    Captured by ``utils.cuda_graph.capture`` after WARMUP passes on a
    clone of the state (which leave the state as it was); the capture
    itself changes nothing, so one call is one pass.  A failed capture
    raises: nothing falls back to the eager pass."""

    WARMUP = 2

    def __init__(self, state: TrainState, **densify_kw):
        self.device = state.scene.means.device
        self.state = state
        means = state.scene.means
        self.noise = torch.zeros((means.shape[0], 3), dtype=means.dtype,
                                 device=self.device)

        def densify(st: TrainState):
            scene, ds, changed = densify_and_prune(
                st.scene, st.ds, noise=self.noise, **densify_kw)
            zero_rows(st.opt_state, changed)
            _write_state(st, scene, ds)

        def warm():
            s = _clone_train_state(state)
            for _ in range(self.WARMUP):
                densify(s)

        with torch.no_grad():
            self.graph, _ = capture(lambda: densify(state), warm,
                                    self.device, "the densify pass")

    def __call__(self, state: TrainState, generator: torch.Generator):
        """One densify pass of the state it was captured on, its split
        noise drawn from ``generator``."""
        if state.scene.means is not self.state.scene.means:
            raise ValueError("a densify graph densifies the state it was "
                             "captured on")
        with device_guard(self.device):
            self.noise.copy_(torch.randn(
                self.noise.shape, generator=generator,
                dtype=self.noise.dtype, device=self.device))
            self.graph.replay()
        count("graph.replays", "the densify pass")


def make_train_step(cfg: RasterConfig, params: OptimizationParams,
                    graph: bool = True):
    """-> ``train_step(state, cam, target) -> (state, loss, image)``.  The
    step updates the scene fields, the Adam moments and the densify
    statistics in place.  With ``graph`` (the default) and a state on the
    card, the first call captures the step into a ``TrainStepGraph`` and
    every call replays it; the loss and image it returns are tensors of
    their own.  Such a step serves one state: the one of its first call,
    whose tensors the graph updates (each step returns that state again).
    Another state raises ``ValueError``: step it with a new
    ``make_train_step``.  ``graph=False`` and the CPU step eagerly, any
    state."""
    lrs = learning_rates(params)
    update = _make_update(cfg, params)
    captured = []

    def train_step(state: TrainState, cam: GSCamera, target):
        write_step_scalars(state.opt_state, lrs)
        if graph and state.scene.means.is_cuda:
            if not captured:
                captured.append(TrainStepGraph(update, state, cam, target))
            ds, loss, img = captured[0](state, cam, target)
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
    (``TrainStepGraph``), each densify pass replays one CUDA graph
    (``DensifyGraph``, captured at the first pass), and densify and the
    opacity reset write into the train step's buffers between replays;
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
    densify_graph = None

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
            if densified and graph and dev.type == "cuda":
                if densify_graph is None:
                    densify_graph = DensifyGraph(state, **densify_kw)
                densify_graph(state, gen)
            elif densified:
                scene2, ds2, changed = densify_and_prune(
                    state.scene, state.ds, gen, **densify_kw)
                # reset the Adam moments of the rows densify rewrote only
                zero_rows(state.opt_state, changed)
                _write_state(state, scene2, ds2)
            if it % params.opacity_reset_interval == 0:
                _write_state(state, reset_opacity(state.scene))
        if log_every and it % log_every == 0:
            print(f"iter {it}: loss={losses[-1]:.4f} "
                  f"alive={int(state.ds.alive.sum())}", flush=True)
        if callback is not None:
            callback(it, state, losses[-1], densified)
    return state.scene, state.ds, losses
