"""The 3DGS training cell's inputs and check.

The inputs are the benchmark's, made from ``--seed`` and handed to both
sides: the truth scene (the reference's synthetic scene of the
configuration, drawn with a seed of the run), the look-at cameras (as
world-to-camera matrices and intrinsics), the target images (the
reference's own render of the truth from each camera) and the noisy
point cloud that training starts from.

The reference follows two stretches of the training.  The first three
steps, from those inputs alone: its own initial Gaussians
(``create_from_pcd`` of the points), its own forward render (projection,
binning, the plain compositor), the loss (L1 + SSIM), the backward
through the plain backward compositor and the per-Gaussian sums, and
Adam.  The numbers compared are the loss of each step, each leaf's
gradient norm at the first step (as the optimizer got it: its first
moment after one step over 1 - beta1), and each leaf's change after
three steps, each taken by the worst leaf as the gap of the two sides'
norms over the reference's norm of that leaf or of the median leaf,
whichever is larger.  Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the change: Adam moves
them by round-off alone.

The late stretch, around the first opacity reset: the reference cannot
rebuild thousands of iterations, so it starts from the program's own
state after a seeded iteration a few before the reset (scene, densify
statistics, Adam moments), and runs the iterations up to the one after
it: train steps under the decayed position learning rate, a densify
pass and the reset.  Compared: each iteration's loss, each leaf's change
over the stretch (by the worst leaf, as above) and the rows alive on one
side only.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import seed_rng
from benchmark.reference.closed_loop import precision

TRAINABLE = ("means", "sh0", "shN", "log_scales", "quats", "logit_opacities")
B1 = 0.9          # Adam's first-moment decay (the reference trainer's)
STILL = 1e-3      # a leaf whose gradient is under this share of the median


def look_at_w2c(n: int, arc_deg: float, sim2gs) -> List[np.ndarray]:
    """World->camera matrices (GS frame) of ``n`` cameras on a horizontal
    arc of ``arc_deg`` degrees in front of the robot, 1.1 m from a point
    0.35 m ahead of its base and 0.3 m up, 0.4 m above that point and
    looking at it."""
    sim2gs = np.asarray(sim2gs, np.float64)

    def to_gs(p):
        return sim2gs[:3, :3] @ p + sim2gs[:3, 3]

    target = to_gs(np.array([0.35, 0.0, 0.3]))
    up = sim2gs[:3, :3] @ np.array([0.0, 0.0, 1.0])
    up /= np.linalg.norm(up)
    out = []
    for i in range(n):
        th = math.radians(arc_deg) * (i / max(n - 1, 1) - 0.5)
        eye = to_gs(np.array([0.35 + 1.1 * math.cos(th),
                              1.1 * math.sin(th), 0.70]))
        fwd = (target - eye) / np.linalg.norm(target - eye)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        w2c = np.eye(4)
        w2c[:3, :3] = np.stack([right, down, fwd])
        w2c[:3, 3] = -w2c[:3, :3] @ eye
        out.append(w2c)
    return out


class Inputs:
    """The training inputs of one seed, on ``device``."""

    def __init__(self, config: dict, seed: int, device):
        from benchmark.reference.gsw import constants, envs
        from benchmark.reference.gsw.gs.scene_factory import get_scene
        from benchmark.reference.gsw.gs.transform import PosedGaussians
        from benchmark.reference.gsw.physics.spec_io import \
            load_surface_points
        from benchmark.reference.gsw.render.camera import (
            RasterConfig, camera_from_opencv)
        from benchmark.reference.gsw.render.rasterize import render
        self.device = torch.device(device)
        r = config["raster"]
        self.width, self.height = r["width"], r["height"]
        self.cfg = RasterConfig(width=r["width"], height=r["height"],
                                tile=r["tile"],
                                max_tiles_per_gaussian=r[
                                    "max_tiles_per_gaussian"],
                                max_entries=r["max_entries"])
        env = envs.make(config["env_id"], num_envs=1, device=self.device)
        model = env.agent.model
        objs = [n for n in env.actor_names
                if n in constants.sim2gs_object_transforms]
        try:
            surface = load_surface_points(env.robot_uids)
        except FileNotFoundError:
            surface = None
        rng = seed_rng(seed, "truth")
        truth, _, _ = get_scene(
            config["scene"], model, constants.robot_scan_qpos[env.robot_uids],
            objs, link_names=list(model.link_names),
            synthetic_seed=int(rng.integers(0, 2 ** 31 - 1)),
            synthetic_sizes=config["synthetic_sizes"], surface_points=surface,
            device=self.device)
        _, sim2gs = constants.robot_calibration(config["scene"])
        views = config["views"]
        K = np.array(constants.rs_d435i_rgb_k, np.float64)
        K[0] *= self.width / 640.0
        K[1] *= self.height / 480.0
        self.K = K.astype(np.float32)
        self.w2c = [w.astype(np.float32) for w in
                    look_at_w2c(views["count"], views["arc_deg"], sim2gs)]
        hold = views["count"] // 2      # held out: never trained on
        self.train_ids = [i for i in range(views["count"]) if i != hold]
        posed = PosedGaussians(truth.means, truth.log_scales, truth.quats,
                               truth.logit_opacities)
        with torch.no_grad(), precision(False):
            self.images = [render(
                posed, camera_from_opencv(
                    torch.as_tensor(w, device=self.device), self.K,
                    self.width, self.height),
                self.cfg, truth.sh0, truth.shN)["rgb"].contiguous()
                for w in self.train_w2c()]
        means = truth.means.cpu().numpy()
        self.points = means + rng.normal(scale=config["init"]["point_noise"],
                                         size=means.shape)
        c0 = 0.28209479177387814
        self.colors = np.clip(truth.sh0.cpu().numpy() * c0 + 0.5 + rng.normal(
            scale=config["init"]["color_noise"], size=means.shape), 0.0, 1.0)
        self.capacity = int(config["init"]["capacity_factor"] * len(means))
        self.densify_seed = int(rng.integers(0, 2 ** 31 - 1))

    def train_w2c(self) -> List[np.ndarray]:
        return [self.w2c[i] for i in self.train_ids]


def leaf_norms(fields: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            fields.items()}


class Readings(dict):
    """One side's readings.  The first three steps: ``loss`` (3 floats),
    ``grad`` and ``change`` ({leaf: norm}).  The late stretch: ``loss``
    (one float per iteration), ``end`` ({leaf: tensor on the host}) and
    ``alive`` (the alive mask on the host) after its last iteration."""


def bf16_round_(x: torch.Tensor) -> torch.Tensor:
    return x.copy_(x.to(torch.bfloat16).to(x.dtype))


def densify_kw(config: dict, params) -> dict:
    return dict(grad_threshold=params.densify_grad_threshold,
                percent_dense=params.percent_dense,
                scene_extent=float(config["scene_extent"]))


def densified(params, it: int) -> bool:
    """Whether the schedule has a densify pass at iteration ``it``."""
    return (params.densify_from_iter <= it <= params.densify_until_iter
            and it % params.densification_interval == 0)


def run_iterations(config: dict, inputs: Inputs, state, first: int,
                   last: int, gen: torch.Generator, lower: str = "",
                   on_step=None):
    """The reference's training iterations ``first``..``last`` of
    ``state`` (the train step against the cycled views, densify and the
    opacity reset on the schedule) -> (state, the losses).

    ``lower="bf16"`` computes them one precision step below float32, for
    the control: the trainable leaves and the target images held in
    bfloat16 (rounded to it before every step), the arithmetic staying
    float32."""
    from benchmark.reference.gsw.render.camera import camera_from_opencv
    from benchmark.reference.gsw.train3dgs.optim import OptimizationParams
    from benchmark.reference.gsw.train3dgs.train import (iteration,
                                                         make_train_step)
    dev = inputs.device
    params = OptimizationParams(**config["optimization"])
    cams = [camera_from_opencv(torch.as_tensor(w, device=dev), inputs.K,
                               inputs.width, inputs.height)
            for w in inputs.train_w2c()]
    images = inputs.images
    if lower == "bf16":
        images = [bf16_round_(im.clone()) for im in images]
    step = make_train_step(inputs.cfg, params)
    losses = []
    with precision(False):
        for it in range(first, last + 1):
            if lower == "bf16":
                with torch.no_grad():
                    for f in TRAINABLE:
                        bf16_round_(getattr(state.scene, f))
            state, loss = iteration(it, state, step, cams, images, params,
                                    gen, **densify_kw(config, params))
            losses.append(loss)
            if on_step is not None:
                on_step(it, state)
    return state, losses


def reference_steps(config: dict, inputs: Inputs, steps: int = 3,
                    lower: str = "") -> Readings:
    """The reference's first ``steps`` training iterations from
    ``inputs``: its own initial Gaussians, then ``run_iterations``."""
    from benchmark.reference.gsw.gs.pcd_init import create_from_pcd
    from benchmark.reference.gsw.train3dgs.densify import (
        init_densify_state, pad_scene_capacity)
    from benchmark.reference.gsw.train3dgs.optim import adam_init
    from benchmark.reference.gsw.train3dgs.train import TrainState
    dev = inputs.device
    scene = create_from_pcd(inputs.points, inputs.colors, device=dev)
    n0 = scene.num_gaussians
    scene = pad_scene_capacity(scene, inputs.capacity)
    state = TrainState(scene=scene,
                       ds=init_densify_state(inputs.capacity, n0, dev),
                       opt_state=adam_init(scene), step=0)
    before = {f: getattr(scene, f).clone() for f in TRAINABLE}
    out = Readings()

    def on_step(it, st):
        if it == 1:
            out["grad"] = {f: v / (1.0 - B1) for f, v in leaf_norms(
                st.opt_state.mu).items()}

    gen = torch.Generator(device=dev).manual_seed(inputs.densify_seed)
    state, out["loss"] = run_iterations(config, inputs, state, 1, steps,
                                        gen, lower, on_step)
    out["change"] = leaf_norms({f: getattr(state.scene, f) - before[f]
                                for f in TRAINABLE})
    return out


def reference_late(config: dict, inputs: Inputs, snap: dict,
                   lower: str = "") -> Readings:
    """The reference's late stretch: from the program's state after
    iteration ``snap["it"]`` (``snap``: its scene, densify statistics
    and Adam state, on the host), the iterations up to ``snap["end"]``.
    The densify passes' generator is worked out from the inputs' seed:
    one (N, 3) normal draw for each pass before the stretch."""
    from benchmark.reference.gsw.gs.model import GaussianScene
    from benchmark.reference.gsw.train3dgs.densify import DensifyState
    from benchmark.reference.gsw.train3dgs.optim import (AdamState,
                                                         OptimizationParams)
    from benchmark.reference.gsw.train3dgs.train import TrainState
    dev = inputs.device
    params = OptimizationParams(**config["optimization"])
    scene = GaussianScene(**{f: t.to(dev) for f, t in snap["scene"].items()})
    opt = AdamState(mu={f: t.to(dev) for f, t in snap["mu"].items()},
                    nu={f: t.to(dev) for f, t in snap["nu"].items()},
                    count=snap["count"],
                    scalars=torch.ones(2 + len(TRAINABLE),
                                       dtype=torch.float32, device=dev))
    state = TrainState(scene=scene,
                       ds=DensifyState(*(t.to(dev) for t in snap["ds"])),
                       opt_state=opt, step=snap["count"])
    gen = torch.Generator(device=dev).manual_seed(inputs.densify_seed)
    n = scene.num_gaussians
    for it in range(1, snap["it"] + 1):
        if densified(params, it):
            torch.randn((n, 3), generator=gen, dtype=scene.means.dtype,
                        device=dev)
    state, losses = run_iterations(config, inputs, state, snap["it"] + 1,
                                   snap["end"], gen, lower)
    return Readings(loss=losses,
                    end={f: getattr(state.scene, f).detach().cpu()
                         for f in TRAINABLE},
                    alive=state.ds.alive.cpu())


def gaps(got: Readings, want: Readings) -> Dict[str, float]:
    """The numbers compared of the first three steps: ``loss_gap``,
    ``grad_gap``, ``change_gap``."""
    loss = max(abs(a - b) / max(abs(b), 1e-12)
               for a, b in zip(got["loss"], want["loss"]))
    g_med = float(np.median(list(want["grad"].values())))
    grad = max(abs(got["grad"][k] - v) / max(v, g_med, 1e-30)
               for k, v in want["grad"].items())
    moved = [k for k, v in want["grad"].items() if v >= STILL * g_med]
    c_med = float(np.median([want["change"][k] for k in moved]))
    change = max(abs(got["change"][k] - want["change"][k])
                 / max(want["change"][k], c_med, 1e-30) for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def late_gaps(got: Readings, want: Readings, snap: dict) -> Dict[str, float]:
    """The numbers compared of the late stretch: ``late_loss_gap`` (the
    widest relative gap of an iteration's loss), ``late_change_gap`` (each
    leaf's change over the stretch, by the worst leaf, as ``gaps`` takes
    it) and ``late_alive_flips`` (rows alive on one side only)."""
    loss = max(abs(a - b) / max(abs(b), 1e-12)
               for a, b in zip(got["loss"], want["loss"]))
    start = snap["scene"]
    norm = {side: leaf_norms({f: r["end"][f] - start[f] for f in TRAINABLE})
            for side, r in (("got", got), ("want", want))}
    med = float(np.median(list(norm["want"].values())))
    change = max(abs(norm["got"][k] - v) / max(v, med, 1e-30)
                 for k, v in norm["want"].items())
    flips = int((got["alive"] != want["alive"]).sum())
    return {"late_loss_gap": loss, "late_change_gap": change,
            "late_alive_flips": float(flips)}


def projected(inputs: Inputs, scene, view: int):
    """The reference's projection of a scene's Gaussians (read from its
    fields) from training view ``view`` -> (Projected (1, N, ...), the
    raster config)."""
    from benchmark.reference.gsw.gs.transform import PosedGaussians
    from benchmark.reference.gsw.render.camera import camera_from_opencv
    from benchmark.reference.gsw.render.rasterize import project_frames
    cam = camera_from_opencv(
        torch.as_tensor(inputs.train_w2c()[view], device=inputs.device),
        inputs.K, inputs.width, inputs.height)
    with torch.no_grad(), precision(False):
        posed = PosedGaussians(scene.means.detach().clone(),
                               scene.log_scales.detach().clone(),
                               scene.quats.detach().clone(),
                               scene.logit_opacities.detach().clone())
        flat, _ = project_frames(posed, cam, inputs.cfg,
                                 scene.sh0.detach().clone(),
                                 scene.shN.detach().clone())
    return flat, inputs.cfg
