"""The closed loop's check: the reference steps and renders from the
inputs of sampled steps and resets of a run, and the numbers compared
are the gaps between what the program's timed path produced and what the
reference produced.

A step is followed from the program's own state before it (a loop of
contacts diverges in a few steps from rounding alone, so no independent
trajectory could be compared): the reference takes that state and the
step's action and computes the step whole (controller targets, the
rigid-body step with its contacts, FK, task state, reward, the flags),
and renders the new state of a few sampled envs from every camera
(FK, the Gaussians' repose, the camera bridge, projection, binning under
the configuration's caps, the compositor: RGB and segmentation).  A
reset is checked from its seed alone: the reference lays out the episode
from its own draws and renders it, so the start is checked with no
program state at all.

The program's outputs are read only to be judged.  Everything the
reference computes with is its own: the physics tables, the scene, the
cameras.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import torch

RGB_OFF = 16   # uint8 levels: a pixel is off when a channel differs more


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products in full float32 (the configuration's
    precision) or, for the control, in TF32."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


@dataclasses.dataclass
class Sample:
    """What the program's timed path produced at one step or reset, as
    the program returned it: ``before`` and ``after`` are its env
    states (read by field name), ``obs`` its observation dict."""

    kind: str                      # "step" or "reset"
    seed: Optional[int]            # a reset's seed
    before: Any                    # a step's state before it
    action: Optional[torch.Tensor]
    after: Any
    obs: Dict[str, Any]
    reward: Optional[torch.Tensor] = None
    terminated: Optional[torch.Tensor] = None
    truncated: Optional[torch.Tensor] = None


def leaves(state) -> Dict[str, torch.Tensor]:
    """Every tensor of an env state, by name (read by field name, so the
    program's state and the reference's read alike)."""
    out = {}
    for f in dataclasses.fields(state.world):
        v = getattr(state.world, f.name)
        if v is not None:
            out[f"world.{f.name}"] = v
    out["elapsed"] = state.elapsed
    out["prev_target"] = state.prev_target
    for k in sorted(state.task):
        out[f"task.{k}"] = state.task[k]
    return out


class LoopReference:
    """The reference env and renderer of a closed-loop configuration."""

    def __init__(self, config: dict, num_envs: int, device, tf32=False):
        from benchmark.reference.gsw import envs
        from benchmark.reference.gsw.render.camera import RasterConfig
        from benchmark.reference.gsw.wrapper.gs_env import GSWorldWrapper
        self.device = torch.device(device)
        self.tf32 = tf32
        r = config["raster"]
        env = envs.make(config["env_id"], num_envs=num_envs,
                        obs_mode=config["obs_mode"],
                        control_mode=config["control_mode"],
                        sim_config=dict(sim_freq=config["sim_freq"],
                                        control_freq=config["control_freq"]),
                        device=self.device)
        env.cameras = [dataclasses.replace(c, width=r["width"],
                                           height=r["height"])
                       for c in env.cameras]
        self.env = env
        self.wrapper = GSWorldWrapper(
            env, config["scene"],
            raster_config=RasterConfig(
                width=r["width"], height=r["height"], tile=r["tile"],
                max_tiles_per_gaussian=r["max_tiles_per_gaussian"],
                max_entries=r["max_entries"]),
            synthetic_sizes=config["synthetic_sizes"], device=self.device)

    def state_from(self, state):
        """The reference's own EnvState holding copies of a program
        state's tensors."""
        from benchmark.reference.gsw.envs.base import EnvState
        from benchmark.reference.gsw.physics.world import WorldState
        w = state.world
        return EnvState(
            world=WorldState(**{f.name: (None if getattr(w, f.name) is None
                                         else getattr(w, f.name).clone())
                                for f in dataclasses.fields(w)}),
            elapsed=state.elapsed.clone(),
            prev_target=state.prev_target.clone(),
            task={k: v.clone() for k, v in state.task.items()})

    @torch.no_grad()
    def run(self, sample: Sample, envs: List[int]) -> dict:
        """The reference's step (or reset) of ``sample``'s inputs, and its
        render of ``envs`` -> dict of what the program's sample holds."""
        from benchmark.reference.gsw.wrapper.gs_env import world_poses
        env = self.env
        with precision(self.tf32):
            out = {}
            if sample.kind == "reset":
                state = env._reset_layout(*env.reset_draws(sample.seed))
            else:
                (state, _, out["reward"], out["terminated"],
                 out["truncated"], _) = env._step_fn(
                    self.state_from(sample.before),
                    sample.action.to(self.device))
            poses = world_poses(state.world, state.task)
            idx = torch.as_tensor(envs, device=self.device)
            sub = type(poses)(**{
                f.name: (None if getattr(poses, f.name) is None
                         else getattr(poses, f.name)[idx])
                for f in dataclasses.fields(poses)})
            out["frames"] = self.wrapper.renderer.render(sub)
            out["state"] = state
        return out


def frames_of(obs: dict, envs: List[int]) -> Dict[str, dict]:
    """The program's frames of ``envs``: {camera: {"rgb", "segmentation"}}."""
    idx = torch.as_tensor(envs)
    out = {}
    for cam, d in obs["sensor_data"].items():
        out[cam] = {k: v[idx.to(v.device)] for k, v in d.items()}
    return out


class Tally:
    """The numbers compared, accumulated over a run's samples.

    ``state_gap``: the worst leaf of the step's outputs (every state
    field, the reward, the terminated and truncated flags): for a float
    leaf the largest gap between the two sides over the reference's
    largest value in that leaf or in the median leaf, whichever is
    larger; for an integer or flag leaf the share of its values that
    differ.  ``rgb_mae``: the mean gap of the sampled frames' uint8 RGB,
    in levels; ``rgb_off_pct``: the share of their pixels with a channel
    more than RGB_OFF levels apart; ``seg_off_pct``: the share whose
    segmentation label differs."""

    def __init__(self):
        self.state_gap = 0.0
        self.abs_sum = 0.0
        self.values = 0
        self.off = 0
        self.seg_off = 0
        self.pixels = 0

    def add(self, got: dict, want: dict) -> None:
        """``got``: {"state", "frames", and for a step "reward",
        "terminated", "truncated"} of one side; ``want``: the
        reference's."""
        g, w = leaves(got["state"]), leaves(want["state"])
        if sorted(g) != sorted(w):
            raise ValueError(f"state fields {sorted(g)} vs {sorted(w)}")
        for k in ("reward", "terminated", "truncated"):
            if k in want:
                g[k], w[k] = got[k], want[k]
        floats = {k: v for k, v in w.items() if v.is_floating_point()}
        scales = {k: float(v.abs().max()) if v.numel() else 0.0
                  for k, v in floats.items()}
        median = float(torch.tensor(sorted(scales.values())).median()) \
            if scales else 0.0
        for k, v in w.items():
            p = g[k].to(v.device)
            if not v.numel():
                continue
            if k in floats:
                if not bool(torch.isfinite(p).all()):
                    gap = float("inf")
                else:
                    gap = float((p.to(v.dtype) - v).abs().max()) / max(
                        scales[k], median, 1e-12)
            else:
                gap = float((p != v).float().mean())
            self.state_gap = max(self.state_gap, gap)
        for cam, wf in want["frames"].items():
            gf = got["frames"][cam]
            a = gf["rgb"].to(wf["rgb"].device).to(torch.int16)
            b = wf["rgb"].to(torch.int16)
            diff = (a - b).abs()
            self.abs_sum += float(diff.sum(dtype=torch.float64))
            self.values += diff.numel()
            self.off += int((diff.amax(dim=-1) > RGB_OFF).sum())
            self.pixels += diff[..., 0].numel()
            if "segmentation" in wf:
                self.seg_off += int((gf["segmentation"].to(
                    wf["segmentation"].device) != wf["segmentation"]).sum())

    def numbers(self) -> Dict[str, float]:
        px = max(self.pixels, 1)
        return {"state_gap": self.state_gap,
                "rgb_mae": self.abs_sum / max(self.values, 1),
                "rgb_off_pct": 100.0 * self.off / px,
                "seg_off_pct": 100.0 * self.seg_off / px}


def program_side(sample: Sample, envs: List[int]) -> dict:
    out = {"state": sample.after, "frames": frames_of(sample.obs, envs)}
    if sample.kind == "step":
        out.update(reward=sample.reward, terminated=sample.terminated,
                   truncated=sample.truncated)
    return out


def compare(samples: List[Sample], envs: List[int], ref: LoopReference,
            control: Optional[LoopReference] = None):
    """-> (the program's numbers, the control's numbers or None): each
    side against the reference on every sample."""
    prog, ctrl = Tally(), (Tally() if control is not None else None)
    for s in samples:
        want = ref.run(s, envs)
        prog.add(program_side(s, envs), want)
        if control is not None:
            ctrl.add(control.run(s, envs), want)
        del want
    return prog.numbers(), (ctrl.numbers() if ctrl is not None else None)


def projected(ref: LoopReference, state, envs: List[int]):
    """The reference's projections of ``envs`` of a program state, from
    every camera, as the render bins them -> (Projected (F, N, ...), the
    raster config)."""
    from benchmark.reference.gsw.render.rasterize import project_frames
    from benchmark.reference.gsw.wrapper.gs_env import world_poses
    st = ref.state_from(state)
    poses = world_poses(st.world, st.task)
    idx = torch.as_tensor(envs, device=ref.device)
    sub = type(poses)(**{f.name: (None if getattr(poses, f.name) is None
                                  else getattr(poses, f.name)[idx])
                         for f in dataclasses.fields(poses)})
    r = ref.wrapper.renderer
    with torch.no_grad(), precision(False):
        posed, cams = r.frames(sub)
        tint = r.color_tint(sub.obj_color)
        flat, _ = project_frames(posed, cams, r.raster_config, r.scene.sh0,
                                 r.scene.shN,
                                 None if tint is None else tint[:, None])
    return flat, r.raster_config
