"""The reset's own recording, read once per ``--trace 1`` run of a loop
cell that lists the reset's metrics: the program's host spans, counters
and device stamps (``gsworld_tpu_torch/utils/profiling.py``) over a
stretch of RESETS resets through the cell's driver (``driver.reset``,
``GSWorldWrapper.reset``: the host layout with its domain randomization,
then the reset graph's replay).

As in ``benchmark/spans.py``, whose helpers it shares, the stretch runs
in a child process that sets the cell up again from the run's seed and
never profiles (``python3 -m benchmark.reset_spans``).  The readings are
cached in ``rec.notes["reset_spans"]``; the readers
``benchmark/metrics/loop_reset_ms.py`` and ``loop_reset_layout_ms.py``
take theirs from there.  A stretch that captures a graph, or loses
stamps, gives no readings; a program without the reset's spans or stamps
gives none either, and nothing raises.

    python3 -m benchmark.reset_spans --workload <cell> --seed <n>

sets the cell up and prints the readings, with the randomization's draws
per reset (``dr.draws/*``) and the reset's launch among the notes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

from benchmark.spans import (
    _mean_ms,
    _quartiles_ms,
    _recording,
    captured,
    lost,
    profiling,
    replays,
)

RESETS = 8
CHILD_TIMEOUT_S = 600
ROOT = Path(__file__).resolve().parent.parent


def readings(rec) -> Dict[str, float]:
    """The metrics of the run's reset stretch (once per run; ``{}`` where
    there is nothing to read: no traced window, no card, a program
    without the recording, or a child that failed)."""
    if "reset_spans" not in rec.notes:
        d, P = rec.driver, profiling()
        out = {}
        if (rec.trace is not None and d is not None and P is not None
                and d.device.type == "cuda"):
            out = in_fresh_process(d.cell.name, rec.seed)
        rec.notes["reset_spans"] = out
    return rec.notes["reset_spans"]


def in_fresh_process(cell: str, seed: int,
                     timeout: float = CHILD_TIMEOUT_S) -> Dict[str, float]:
    """The stretch's metrics from ``python3 -m benchmark.reset_spans`` run
    as a child process on the same cell and seed; ``{}``, with the
    child's last error lines on stderr, where it fails."""
    import json
    import subprocess
    import sys
    cmd = [sys.executable, "-m", "benchmark.reset_spans", "--workload",
           cell, "--seed", str(seed)]
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        print(f"benchmark.reset_spans: no result in {timeout} s",
              file=sys.stderr)
        return {}
    for line in reversed(p.stdout.splitlines()):
        if p.returncode == 0 and line.startswith("{"):
            return json.loads(line)["metrics"]
    print(f"benchmark.reset_spans: exit {p.returncode}\n"
          + "\n".join(p.stderr.splitlines()[-20:]), file=sys.stderr)
    return {}


def reset_stretch(d, P, resets: int = RESETS, record: bool = True) -> dict:
    """``resets`` resets through the driver -> {"metrics": ..., "notes":
    ...}.  Each starts on an idle card, as the loop's reset does after a
    step that waited for its observations: the layout's copy to the card
    would otherwise wait for the reset before it."""
    with _recording(P, record) as rec:
        for _ in range(resets):
            d.reset(keep=False)
            d.sync()
    out = {"metrics": {}, "notes": {"resets": resets}}
    if record:
        out = reset_readings(rec, resets)
    return out


def reset_readings(rec, resets: int) -> dict:
    """A reset stretch's recording -> metrics and notes: the host layout's
    span (``gsw.reset.layout``), the device's reset from its ``reset.begin``
    to its ``reset.end`` stamp (``loop.reset``), the reset graph's launch
    and the randomization's draws, each per reset."""
    counts = rec.counts()
    notes = {"resets": resets, "dropped_spans": rec.dropped,
             "stamps_lost": lost(counts)}
    out = {"metrics": {}, "notes": notes}
    if captured(counts) or lost(counts):
        return out
    notes["graph_replays_per_reset"] = replays(counts, resets)
    notes["dr_draws_per_reset"] = sum(
        v for k, v in counts.items() if k.startswith("dr.draws/")) / resets
    by_name: Dict[str, List[int]] = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append(s.end_ns - s.start_ns)
    if len(by_name.get("gsw.reset", [])) != resets:
        return out
    m = out["metrics"]
    for name in ("gsw.reset", "gsw.reset.layout", "gsw.reset.launch"):
        if len(by_name.get(name, [])) == resets:
            notes[f"{name}_ms_quartiles"] = _quartiles_ms(by_name[name])
    if len(by_name.get("gsw.reset.layout", [])) == resets:
        m["loop_reset_layout_ms"] = _mean_ms(by_name["gsw.reset.layout"])
    dev = [x.end_ns - x.start_ns for x in rec.device_spans()
           if x.name == "loop.reset"]
    if len(dev) == resets:
        m["loop_reset_ms"] = _mean_ms(dev)
        notes["device_ms_quartiles"] = _quartiles_ms(dev)
    else:
        notes["device_spans"] = len(dev)
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    from benchmark import harness as H

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
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
        result = {"cell": cell.name, "seed": args.seed,
                  **reset_stretch(d, P)}
    except H.BenchError as e:
        print(f"benchmark.reset_spans: {e}", file=sys.stderr)
        return 2
    import torch
    result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
