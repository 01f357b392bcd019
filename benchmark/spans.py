"""The program's own recording, read once per ``--trace 1`` run: its host
spans, counters and device stamps (``gsworld_tpu_torch/utils/
profiling.py``) over a stretch of the cell's own work.

The stretch runs in a child process that sets the cell up again from
the run's seed and never profiles (``python3 -m benchmark.spans``): in a
process that captures CUDA graphs the profiler leaves CUPTI attached
when it stops (torch sets ``TEARDOWN_CUPTI=0`` there), and every later
graph launch carries its cost.  The readings are cached in
``rec.notes["spans"]``; the readers ``benchmark/metrics/loop_*`` and
``train_*`` take theirs from there.

Loop cells: ``driver.reset(keep=False)``, then closed-loop steps through
``driver.step()`` under ``recording()`` for STRETCH_S seconds (at least
MIN_STEPS, at most what the stamp ring holds), reset every episode as
the window does; each step next to a reset is left out.  Training:
``train()`` on the driver's own inputs for TRAIN_ITERS iterations under
``recording()``; iterations TRAIN_SKIP + 1 on are read.  A stretch that
captures any graph, or loses stamps to the ring's overrun, gives no
readings.  A program without the recording (``profiling.recording``)
gives none either, and nothing raises.

    python3 -m benchmark.spans --workload <cell> --seed <n> [--cost <rounds>]

sets the cell up, prints the readings with the attribution of the
device's gaps to host spans and, with ``--cost``, the host time per
step or iteration of the same stretch with and without the recording, in
turns.
"""

from __future__ import annotations

import statistics
import time
from pathlib import Path
from typing import Dict, List, Optional

STRETCH_S = 5.0
MIN_STEPS = 8
STAMPS_PER_STEP = 3        # begin, physics|render, end
TRAIN_ITERS = 110
TRAIN_SKIP = 10
NS_PER_MS = 1e6
CHILD_TIMEOUT_S = 600
ROOT = Path(__file__).resolve().parent.parent


def profiling():
    """The program's profiling module where it has the recording, else
    None."""
    try:
        from gsworld_tpu_torch.utils import profiling as P
    except ImportError:
        return None
    return P if hasattr(P, "recording") else None


def readings(rec) -> Dict[str, float]:
    """The metrics of the run's stretch (once per run; ``{}`` where there
    is nothing to read: no traced window, no card, a program without the
    recording, or a child that failed)."""
    if "spans" not in rec.notes:
        d, P = rec.driver, profiling()
        out = {}
        if (rec.trace is not None and d is not None and P is not None
                and d.device.type == "cuda"):
            out = in_fresh_process(d.cell.name, rec.seed)
        rec.notes["spans"] = out
    return rec.notes["spans"]


def in_fresh_process(cell: str, seed: int,
                     timeout: float = CHILD_TIMEOUT_S) -> Dict[str, float]:
    """The stretch's metrics from ``python3 -m benchmark.spans`` run as a
    child process on the same cell and seed; ``{}``, with the child's
    last error lines on stderr, where it fails."""
    import json
    import subprocess
    import sys
    cmd = [sys.executable, "-m", "benchmark.spans", "--workload", cell,
           "--seed", str(seed)]
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        print(f"benchmark.spans: no result in {timeout} s", file=sys.stderr)
        return {}
    for line in reversed(p.stdout.splitlines()):
        if p.returncode == 0 and line.startswith("{"):
            return json.loads(line)["metrics"]
    print(f"benchmark.spans: exit {p.returncode}\n"
          + "\n".join(p.stderr.splitlines()[-20:]), file=sys.stderr)
    return {}


def measure(d, P, steps: Optional[int] = None, record: bool = True) -> dict:
    """Run the driver's stretch -> {"metrics": ..., "notes": ...}; a loop
    stretch takes ``steps`` steps where given, else STRETCH_S seconds."""
    if d.cell.config["driver"] == "train_3dgs":
        return train_stretch(d, P, record=record)
    return loop_stretch(d, P, steps, record=record)


def _recording(P, record: bool):
    import contextlib
    return P.recording() if record else contextlib.nullcontext()


def _mean_ms(xs) -> float:
    return statistics.fmean(xs) / NS_PER_MS


def _quartiles_ms(xs) -> List[float]:
    if len(xs) < 2:
        return [x / NS_PER_MS for x in xs]
    q = statistics.quantiles(xs, n=4)
    return [min(xs) / NS_PER_MS] + [v / NS_PER_MS for v in q] + [
        max(xs) / NS_PER_MS]


def loop_stretch(d, P, steps: Optional[int] = None,
                 record: bool = True) -> dict:
    """``steps`` closed-loop steps, or where None as many as STRETCH_S
    seconds take (at least MIN_STEPS, at most the stamp ring's room)."""
    episode = int(d.traffic["episode_steps"])
    most = (P.RING_SLOTS - 2) // STAMPS_PER_STEP
    d.reset(keep=False)
    after_reset, deltas = [], []
    t0 = time.perf_counter()

    def more(i):
        if steps is not None:
            return i < steps
        return i < most and (i < MIN_STEPS
                             or time.perf_counter() - t0 < STRETCH_S)

    with _recording(P, record) as rec:
        i = 0
        while more(i):
            reset = i == 0
            if d.steps_in_episode >= episode:
                d.reset(keep=False)
                reset = True
            before = P.counters.snapshot()
            d.step()
            deltas.append(P.since(before, P.counters.snapshot()))
            after_reset.append(reset)
            i += 1
    wall = time.perf_counter() - t0
    steps = i
    # a step next to a reset: the first after it, or the last before it
    kept = [not after_reset[i]
            and not (i + 1 < steps and after_reset[i + 1])
            for i in range(steps)]
    out = {"metrics": {}, "notes": {"steps": steps, "wall_s": wall}}
    if record:
        out = loop_readings(rec, kept, deltas)
        out["notes"].update(steps=steps, wall_s=wall)
        out["recording"] = rec
    return out


def _ancestor(by_seq, s, name: str):
    while s is not None and s.name != name:
        s = by_seq.get(s.parent)
    return s


def captured(counts: Dict[str, int]) -> bool:
    return any(k.startswith("graph.captures/") and v
               for k, v in counts.items())


def syncs(counts: Dict[str, int]) -> int:
    return sum(v for k, v in counts.items() if k.startswith("host.sync/"))


def lost(counts: Dict[str, int]) -> int:
    return counts.get("stamps/lost", 0)


def replays(counts: Dict[str, int], n: int) -> Dict[str, float]:
    """{graph: replays per step} of ``counts`` over ``n`` steps."""
    pre = "graph.replays/"
    return {k[len(pre):]: v / n for k, v in counts.items()
            if k.startswith(pre)}


def loop_readings(rec, kept: List[bool], deltas: List[dict]) -> dict:
    """A loop stretch's recording -> metrics of its kept steps, and notes:
    the host's step period, the device's, per-step quartiles and the
    attribution of the device's gaps."""
    notes = {"kept": sum(kept), "dropped_spans": rec.dropped}
    out = {"metrics": {}, "notes": notes}
    dev = rec.device_spans()
    counts = rec.counts()
    notes["stamps_lost"] = lost(counts)
    if captured(counts) or lost(counts) or not any(kept):
        return out
    moved: Dict[str, int] = {}
    for d in (d for d, k in zip(deltas, kept) if k):
        for key, v in d.items():
            moved[key] = moved.get(key, 0) + v
    notes["graph_replays_per_step"] = replays(moved, sum(kept))
    m = out["metrics"]
    steps = sorted((s for s in rec.spans if s.name == "gsw.step"),
                   key=lambda s: s.seq)
    if len(steps) != len(kept):
        return out
    keep = {s.seq for s, k in zip(steps, kept) if k}
    by_seq = {s.seq: s for s in rec.spans}
    launches = {getattr(_ancestor(by_seq, s, "gsw.step"), "seq", None): s
                for s in rec.spans if s.name == "gsw.step.launch"}
    launch = [s.end_ns - s.start_ns for q, s in launches.items()
              if q in keep]
    if launch:
        m["loop_launch_ms"] = _mean_ms(launch)
        notes["launch_ms_quartiles"] = _quartiles_ms(launch)
    m["loop_host_syncs"] = syncs(moved) / sum(kept)
    phys = [x for x in dev if x.name == "loop.physics"]
    rend = [x for x in dev if x.name == "loop.render"]
    betw = [x for x in dev if x.name == "loop.between"]
    n = len(steps)
    if not (len(phys) == len(rend) == n and len(betw) == n - 1):
        notes["device_spans"] = [len(phys), len(rend), len(betw), n]
        return out
    idx = [i for i in range(1, n) if kept[i]]
    if not idx:
        return out
    dur = [[x.end_ns - x.start_ns for x in xs] for xs in (phys, rend)]
    between = [betw[i - 1].end_ns - betw[i - 1].start_ns for i in idx]
    m["loop_physics_ms"] = _mean_ms([dur[0][i] for i in idx])
    m["loop_render_ms"] = _mean_ms([dur[1][i] for i in idx])
    m["loop_between_ms"] = _mean_ms(between)
    host = [steps[i].start_ns - steps[i - 1].start_ns for i in idx]
    device = [dur[0][i] + dur[1][i] + b for i, b in zip(idx, between)]
    notes.update(
        host_period_ms=_mean_ms(host), device_period_ms=_mean_ms(device),
        period_gap_pct=100.0 * (statistics.fmean(device)
                                / statistics.fmean(host) - 1.0),
        host_period_ms_quartiles=_quartiles_ms(host),
        physics_ms_quartiles=_quartiles_ms([dur[0][i] for i in idx]),
        render_ms_quartiles=_quartiles_ms([dur[1][i] for i in idx]),
        between_ms_quartiles=_quartiles_ms(between),
        anchor_error_us=rec.anchor_error_ns / 1e3,
        causal_margin_us=causal_margin(
            [launches[steps[i].seq].start_ns for i in idx if steps[i].seq
             in launches], [phys[i] for i in idx if steps[i].seq
                            in launches],
            [steps[i].start_ns for i in idx], [rend[i - 1] for i in idx]),
        gaps=gap_table(rec, [betw[i - 1] for i in idx]))
    return out


def causal_margin(launch_starts, begins, next_starts, ends) -> List[float]:
    """How far the anchor's placement keeps cause before effect (us; each
    at least minus the anchor's error where it is sound): the least of a
    graph's first stamp less its host launch's start, and the least of
    the host's next call less the graph's last stamp (the host waits for
    the graph before it calls again)."""
    a = [b.start_ns - t for t, b in zip(launch_starts, begins)]
    b = [t - e.end_ns for t, e in zip(next_starts, ends)]
    return [min(a) / 1e3 if a else None, min(b) / 1e3 if b else None]


def gap_table(rec, spans) -> Dict[str, list]:
    """Where the host was in the device spans ``spans`` from one graph's
    end to the next begin: {innermost host span at a gap's midpoint
    (``attribute_gaps``): [gaps, mean ms, total ms]} under "midpoint",
    and {innermost host span: total ms of the gaps it covered} under
    "covered"."""
    P = profiling()
    chosen = set(spans)
    mid: Dict[str, list] = {}
    for g in rec.attribute_gaps():
        if g.span in chosen:
            a = mid.setdefault(g.host, [0, 0.0])
            a[0] += 1
            a[1] += (g.span.end_ns - g.span.start_ns) / NS_PER_MS
    covered: Dict[str, float] = {}
    for d in spans:
        near = [s for s in rec.spans
                if s.start_ns < d.end_ns and s.end_ns > d.start_ns]
        cuts = sorted({d.start_ns, d.end_ns} | {
            t for s in near for t in (s.start_ns, s.end_ns)
            if d.start_ns < t < d.end_ns})
        for a, b in zip(cuts, cuts[1:]):
            host = P.innermost(near, (a + b) // 2)
            covered[host] = covered.get(host, 0.0) + (b - a) / NS_PER_MS
    return {"midpoint": {k: [n, t / n, t] for k, (n, t) in
                         sorted(mid.items(), key=lambda kv: -kv[1][1])},
            "covered": dict(sorted(covered.items(), key=lambda kv: -kv[1]))}


def train_stretch(d, P, iters: int = TRAIN_ITERS, skip: int = TRAIN_SKIP,
                  record: bool = True) -> dict:
    from gsworld_tpu_torch.train3dgs.train import train
    snaps, clock = {}, {}

    def callback(it, state, loss, densified):
        if it in (skip, iters):
            snaps[it] = P.counters.snapshot()
            clock[it] = time.perf_counter()

    with _recording(P, record) as rec:
        train(d.scene, d.cams, d.images, d.cfg, d.params,
              capacity=d.inputs.capacity, seed=d.inputs.densify_seed,
              scene_extent=float(d.config["scene_extent"]),
              iterations=iters, callback=callback)
    wall = clock[iters] - clock[skip]
    out = {"metrics": {}, "notes": {}}
    if record:
        out = train_readings(rec, P.since(snaps[skip], snaps[iters]),
                             iters, skip)
        out["recording"] = rec
    out["notes"].update(iters=iters - skip, wall_s=wall)
    return out


def train_readings(rec, counts: Dict[str, int], iters: int,
                   skip: int) -> dict:
    """A training stretch's recording and the counters that moved over
    its read iterations (``skip`` + 1 .. ``iters``) -> metrics and
    notes."""
    n = iters - skip
    notes = {"dropped_spans": rec.dropped}
    out = {"metrics": {}, "notes": notes}
    dev = rec.device_spans()
    notes["stamps_lost"] = lost(rec.counts())
    if captured(counts) or notes["stamps_lost"]:
        return out
    notes["graph_replays_per_iter"] = replays(counts, n)
    m = out["metrics"]
    m["train_host_syncs"] = syncs(counts) / n
    its = sorted((s for s in rec.spans if s.name == "gsw.train.iter"),
                 key=lambda s: s.seq)
    parts = {k: [x for x in dev if x.name == f"train.{k}"][-n:]
             for k in ("forward", "backward", "update", "between")}
    if len(its) != iters or any(len(v) != n for v in parts.values()):
        notes["device_spans"] = {k: len(v) for k, v in parts.items()}
        return out
    # the first read iteration's device work lies inside its host span
    first = its[skip]
    if not (first.start_ns <= parts["forward"][0].start_ns <= first.end_ns
            + rec.anchor_error_ns):
        notes["misplaced"] = True
        return out
    for k, v in parts.items():
        m[f"train_{k}_ms"] = _mean_ms([x.end_ns - x.start_ns for x in v])
        notes[f"{k}_ms_quartiles"] = _quartiles_ms(
            [x.end_ns - x.start_ns for x in v])
    read = its[skip:]
    host = [b.start_ns - a.start_ns for a, b in zip(read, read[1:])]
    by_seq = {s.seq: s for s in rec.spans}
    launches = {getattr(_ancestor(by_seq, s, "gsw.train.iter"), "seq",
                        None): s.start_ns
                for s in rec.spans if s.name == "gsw.train.launch"}
    notes.update(host_period_ms=_mean_ms(host),
                 anchor_error_us=rec.anchor_error_ns / 1e3,
                 causal_margin_us=causal_margin(
                     [launches.get(s.seq) for s in read],
                     parts["forward"], [s.start_ns for s in read[1:]],
                     parts["update"][:-1]),
                 gaps=gap_table(rec, parts["between"]))
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    from benchmark import harness as H

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--cost", type=int, default=0,
                   help="rounds of the stretch without and with the "
                        "recording, in turns")
    args = p.parse_args(argv)
    try:
        H.set_cache_dirs()
        cell = H.find_cell(args.workload)
        H.require_cards(cell.chips)
        P = profiling()
        if P is None:
            raise H.BenchError("the program has no recording")
        d = H.driver_module(cell.config["driver"]).Driver(cell, args.seed)
        d.setup()
        result = {"cell": cell.name, "seed": args.seed, **measure(d, P)}
        del result["recording"]
        steps = result["notes"].get("steps")
        cost = {"off": [], "on": []}
        for r in range(args.cost):
            for record in ((False, True) if r % 2 == 0 else (True, False)):
                notes = measure(d, P, steps, record=record)["notes"]
                per = notes.get("steps") or notes.get("iters")
                cost["on" if record else "off"].append(
                    1e3 * notes["wall_s"] / per)
        if args.cost:
            result["cost_ms_per_call"] = cost
    except H.BenchError as e:
        print(f"benchmark.spans: {e}", file=sys.stderr)
        return 2
    import torch
    result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
