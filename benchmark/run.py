"""One run of one cell of the benchmark.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell's driver (build, scene, inputs from ``--seed``, every
graph the window replays, warm-up), measures for ``--seconds``, then
checks what the window produced against the plain reference, and prints
one JSON line last: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device`` (and ``breakdown`` with ``--trace 1``), and the numbers
compared with their limits under ``checks``.  Without a card, or with
JAX or the JAX package loaded once the check has run, it stops with an
error and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()   # set-up is timed from here to the window

import argparse  # noqa: E402
import sys  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None):
    """Set up, measure and check one cell -> (result dict, checks).  The
    card check is the caller's (``main``); tests drive this on the CPU."""
    from benchmark import harness as H

    t0 = T0 if t0 is None else t0
    driver = H.driver_module(cell.config["driver"]).Driver(
        cell, seed, device=device)
    driver.setup()
    rec = H.Record(cell=cell, seed=seed, setup_s=time.perf_counter() - t0,
                   driver=driver)
    driver.window(rec, seconds, trace=trace)
    rec.peak_bytes = driver.peak_bytes()
    metrics = H.read_metrics(cell.per_layer if trace else cell.end_to_end,
                             rec)
    result = {"attempted": driver.attempted, "failed": driver.failed,
              "metrics": metrics}
    if device == "cuda":
        result["device"] = H.device_info(cell.chips, rec.peak_bytes,
                                         rec.trace)
    if trace and rec.trace is not None:
        result["breakdown"] = rec.trace.breakdown()
    rec.driver = None
    checks = driver.check()
    result = {"correct": not H.failed(checks), **result}
    return result, checks


def main(argv=None) -> int:
    from benchmark import harness as H

    args = parse_args(argv)
    try:
        H.set_cache_dirs()
        cell = H.find_cell(args.workload)
        H.require_cards(cell.chips)
        result, checks = run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace))
        # last of all, after the readers and the check have run too
        bad = H.forbidden_modules()
        if bad:
            raise H.BenchError(f"JAX or the JAX package was loaded: {bad}")
    except H.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    H.print_result(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
