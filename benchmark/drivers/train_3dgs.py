"""3DGS training through the program's own loop, ``train3dgs.train.train``,
under the reference trainer's schedule: one ``TrainStepGraph`` replay per
iteration (forward render, L1 + SSIM, the backward compositor and the
per-Gaussian sums, Adam, the densify statistics), the loss read back each
iteration, a ``DensifyGraph`` replay on the schedule and the opacity
reset.  The driver sees the loop only through its ``callback``, which
runs after every iteration; it ends the loop by raising from there.

Set-up makes the inputs from ``--seed`` (``reference/train_3dgs.py``:
truth scene, cameras, target images, point cloud) and hands them to
``train``.  Its first iterations are set-up too: the first three
capture the train-step graph and give the readings of the check's first
stretch; the first densify pass (iteration 500) captures the densify
graph.  The window opens after that pass and runs until ``--seconds``
have passed; with ``--trace 1`` it is the next ``trace_iters``
iterations under the profiler.  The loop then goes on, untimed, until
the check's late stretch is done, should the window close before it.

The late stretch: the program's state after a seeded iteration one to
three before the first opacity reset (iteration 3000), copied to the
host, and the losses and state up to the iteration after the reset.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import harness as H
from benchmark.reference.train_3dgs import (TRAINABLE, B1, Inputs,
                                            Readings, densified, gaps,
                                            late_gaps, leaf_norms,
                                            reference_late, reference_steps)

FIRST_STEPS = 3


class _Stop(Exception):
    """Ends ``train``'s loop from its callback."""


def host(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` on the host (a copy on the CPU too)."""
    return x.detach().to("cpu", copy=True)


def host_state(state, full: bool) -> dict:
    """A TrainState's scene (every field) and alive mask on the host and,
    with ``full``, its densify statistics and Adam state too."""
    from gsworld_tpu_torch.gs.model import SCENE_FIELDS
    out = {"scene": {f: host(getattr(state.scene, f)) for f in SCENE_FIELDS},
           "alive": host(state.ds.alive)}
    if full:
        opt = state.opt_state
        out.update(ds=[host(x) for x in state.ds],
                   mu={f: host(v) for f, v in opt.mu.items()},
                   nu={f: host(v) for f, v in opt.nu.items()},
                   count=int(opt.count))
    return out


class Driver:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.device = torch.device(device)
        self.attempted = 0
        self.failed = 0

    # --- the program ---------------------------------------------------

    def setup(self):
        self.prepare(self.seed)

    def prepare(self, seed: int):
        """The inputs of ``seed``, the program's cameras, targets and
        initial Gaussians, and where the late stretch lies."""
        from gsworld_tpu_torch.gs.pcd_init import create_from_pcd
        from gsworld_tpu_torch.render.camera import (RasterConfig,
                                                     camera_from_opencv)
        from gsworld_tpu_torch.train3dgs.densify import pad_scene_capacity
        from gsworld_tpu_torch.train3dgs.optim import OptimizationParams
        self.seed = seed
        self.release()
        dev = self.device
        self.inputs = inp = Inputs(self.config, seed, dev)
        r = self.config["raster"]
        self.cfg = RasterConfig(
            width=r["width"], height=r["height"], tile=r["tile"],
            max_tiles_per_gaussian=r["max_tiles_per_gaussian"],
            max_entries=r["max_entries"])
        self.params = p = OptimizationParams(**self.config["optimization"])
        self.cams = [camera_from_opencv(torch.as_tensor(w, device=dev),
                                        inp.K, inp.width, inp.height)
                     for w in inp.train_w2c()]
        self.images = [im.clone() for im in inp.images]
        self.scene = create_from_pcd(inp.points, inp.colors, device=dev)
        padded = pad_scene_capacity(self.scene, inp.capacity)
        self.initial = {f: host(getattr(padded, f)) for f in TRAINABLE}
        del padded
        # the window opens after the first densify pass
        self.opens = next(it for it in range(1, p.iterations + 1)
                          if densified(p, it))
        late = self.traffic["late"]
        reset = p.opacity_reset_interval
        back = H.seed_rng(seed, "late").integers(late["back"][0],
                                                 late["back"][1] + 1)
        self.late_from = reset - int(back)
        self.late_end = reset + int(late["after"])
        if not self.opens < self.late_from:
            raise H.BenchError("the late stretch lies before the window")
        self.readings = Readings(loss=[])
        self.late = Readings(loss=[])
        self.snap = None

    def window(self, rec, seconds: float, trace: bool = False):
        """Run ``train`` on the inputs; its callback opens the window
        after the first densify pass and closes it (see the module's
        docstring)."""
        from gsworld_tpu_torch.train3dgs.train import train
        self.rec, self.seconds, self.trace = rec, seconds, trace
        self.is_open = self.closed = False
        self.traced_cams = []
        self.t_call = time.perf_counter()
        try:
            train(self.scene, self.cams, self.images, self.cfg, self.params,
                  capacity=self.inputs.capacity,
                  seed=self.inputs.densify_seed,
                  scene_extent=float(self.config["scene_extent"]),
                  callback=self.callback)
        except _Stop:
            pass
        if self.is_open:        # the schedule ran out inside the window
            self.close()
        self.attempted = len(rec.calls)
        rec.work["iters"] = len(rec.calls)

    def callback(self, it: int, state, loss: float, densify: bool):
        now = time.perf_counter()
        rec = self.rec
        if it <= FIRST_STEPS:
            self.read_first(it, state, loss)
        if it == self.opens:
            self.open(now)
        elif self.is_open:
            rec.calls.append(now - self.t_last)
            self.t_last = now
            if self.trace:
                self.traced_cams.append((it - 1) % len(self.cams))
                if len(rec.calls) == int(self.traffic["trace_iters"]):
                    self.close_trace(state)
            elif now >= self.deadline:
                self.close()
        if it == self.late_from:
            self.snap = dict(host_state(state, full=True), it=it,
                             end=self.late_end)
        elif self.late_from < it <= self.late_end:
            self.late["loss"].append(loss)
            if it == self.late_end:
                end = host_state(state, full=False)
                self.late.update(end={f: end["scene"][f] for f in TRAINABLE},
                                 alive=end["alive"])
        if self.closed and it >= self.late_end:
            raise _Stop

    def read_first(self, it: int, state, loss: float):
        """The check's readings of the first three iterations."""
        self.readings["loss"].append(loss)
        if it == 1:
            self.readings["grad"] = {f: v / (1.0 - B1) for f, v in
                                     leaf_norms(state.opt_state.mu).items()}
        if it == FIRST_STEPS:
            self.readings["change"] = leaf_norms(
                {f: host(getattr(state.scene, f)) - self.initial[f]
                 for f in TRAINABLE})

    def open(self, now: float):
        self.rec.setup_s += now - self.t_call
        self.is_open = True
        if self.trace:
            from benchmark.trace import Traced
            self.traced = Traced().__enter__()
        else:
            self.deadline = now + self.seconds
        self.t_start = self.t_last = time.perf_counter()

    def close(self):
        self.sync()
        self.rec.window_s = time.perf_counter() - self.t_start
        self.is_open, self.closed = False, True

    def close_trace(self, state):
        self.traced.__exit__(None, None, None)
        self.rec.trace = self.traced.data(len(self.rec.calls))
        self.rec.window_s = self.rec.trace.window_s
        self.traced = None
        # what the roofline's work count projects: the traced scene
        self.traced_scene = {f: host(getattr(state.scene, f))
                             for f in TRAINABLE}
        self.is_open, self.closed = False, True

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def release(self):
        self.scene = self.cams = self.images = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check -----------------------------------------------------

    def numbers(self, control: bool = False) -> dict:
        """The numbers compared: the program's against the reference and,
        with ``control``, the control's (the reference with its leaves
        and targets in bfloat16) against the reference."""
        self.release()
        want = reference_steps(self.config, self.inputs, FIRST_STEPS)
        late = reference_late(self.config, self.inputs, self.snap)
        out = {"program": {**gaps(self.readings, want),
                           **late_gaps(self.late, late, self.snap)},
               "control": None}
        if control:
            out["control"] = {
                **gaps(reference_steps(self.config, self.inputs,
                                       FIRST_STEPS, "bf16"), want),
                **late_gaps(reference_late(self.config, self.inputs,
                                           self.snap, "bf16"),
                            late, self.snap)}
        return out

    def check(self):
        """-> [(name, value, limit)]: the program's first three steps and
        its late stretch against the reference's."""
        numbers = self.numbers()["program"]
        limits = self.traffic["check"]["limits"]
        return [(k, numbers[k], float(limits[k])) for k in limits]

    def read_seed(self, seed: int, seconds: float, control: bool):
        """Readings of one seed for the limits: a run of ``seconds`` (the
        loop goes on to the late stretch), then the numbers compared."""
        self.prepare(seed)
        self.window(H.Record(cell=self.cell, seed=seed), seconds)
        return {"seed": seed, "late_from": self.late_from,
                **self.numbers(control)}
