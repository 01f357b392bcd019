"""Readings for the limits of a cell's check: the program's numbers on
many seeds, and the control's, in one process on the card.

    python3 -m benchmark.control --workload <cell> --seeds 12 --control 3 --seconds 3

The control is the reference put in the program's place and computed one
precision step below the configuration's float32: the closed loop's with
TF32 matrix products, the training's with its leaves and targets held in
bfloat16 (each driver's ``read_seed``).  For each seed the program runs
a short window of the cell's own traffic (a fresh episode; for training,
a fresh run up to the check's late stretch), and the numbers the check
compares are printed, one JSON line per seed: the program's against the
reference, and for the first ``--control`` seeds the control's against
the reference on the same samples.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def main(argv=None) -> int:
    from benchmark import faults
    from benchmark import harness as H

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    p.add_argument("--fault", choices=sorted(faults.FAULTS),
                   help="plant this fault in the program first: its "
                        "readings are the fault's")
    args = p.parse_args(argv)
    H.set_cache_dirs()
    cell = H.find_cell(args.workload)
    H.require_cards(cell.chips)
    with contextlib.ExitStack() as stack:
        if args.fault:
            stack.enter_context(faults.FAULTS[args.fault]())
        driver = H.driver_module(cell.config["driver"]).Driver(
            cell, args.first_seed)
        driver.setup()
        for i in range(args.seeds):
            t0 = time.perf_counter()
            out = driver.read_seed(args.first_seed + 7919 * i, args.seconds,
                                   i < args.control)
            out["read_s"] = time.perf_counter() - t0
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
