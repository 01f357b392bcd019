"""Repeats ``chip_smoke.py`` phases 7a and 7b on one GPU with every
training iteration of 7b's scan checked for non-finite numbers, to catch
the rare non-finite Gaussian of the trained scan (ROADMAP C19).

    python3 gsworld_tpu_torch/tools/scan_train_checks.py [--repeats N]

Per iteration it checks, and prints the first time each is seen in a
repeat: the gradient of every trained field (rows of the Gaussians that
carry a non-finite value, with their fields), the alive rows densify
leaves with a non-finite field, and the alive rows of the state after
the step.  Per repeat it prints ok or the failure, with what was seen.
Each check reads the device, so the timings of 7b are not the smoke's.
"""

import argparse
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def bad_rows(x, alive=None):
    """Rows (leading axis) of ``x`` with a non-finite value, and alive."""
    import torch
    rows = ~torch.isfinite(x).reshape(x.shape[0], -1).all(dim=-1)
    return rows if alive is None else rows & alive


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from gsworld_tpu_torch.gs.model import SCENE_FIELDS
    from gsworld_tpu_torch.real2sim import pipeline
    from gsworld_tpu_torch.train3dgs import train as T

    cs.phase_device()
    cs.phase_build()
    seen, it_now = {}, [0]

    def report(key, text):
        if key not in seen:
            seen[key] = it_now[0]
            print(f"iteration {it_now[0]}: {text}", flush=True)

    adam_update, densify = T.adam_update, T.densify_and_prune

    def checked_adam(scene, grads, opt_state):
        for f, g in grads.items():
            rows = bad_rows(g)
            if rows.any():
                idx = rows.nonzero()[:3, 0]
                report(("grad", f), f"non-finite gradient of {f} in "
                       f"{int(rows.sum())} rows, e.g. {idx.tolist()}: "
                       + "; ".join(f"{h} {getattr(scene, h)[idx].tolist()}"
                                   for h in SCENE_FIELDS))
        return adam_update(scene, grads, opt_state)

    def checked_densify(scene, ds, *a, **kw):
        out = densify(scene, ds, *a, **kw)
        for f in SCENE_FIELDS:
            v = getattr(out[0], f)
            if v.is_floating_point() and bad_rows(v, out[1].alive).any():
                report(("densify", f), f"densify left alive rows with a "
                       f"non-finite {f}")
        return out

    def train(*a, **kw):
        def after(it, state, loss, densified):
            it_now[0] = it + 1
            for f in SCENE_FIELDS:
                v = getattr(state.scene, f)
                rows = (bad_rows(v, state.ds.alive) if v.is_floating_point()
                        else None)
                if rows is not None and rows.any():
                    report(("state", f), f"{int(rows.sum())} alive rows "
                           f"with a non-finite {f} (loss {loss})")
        kw["callback"] = after
        kw["graph"] = False      # the checks read the host every step
        it_now[0] = 1
        return train_plain(*a, **kw)

    train_plain = pipeline.train
    T.adam_update, T.densify_and_prune = checked_adam, checked_densify
    pipeline.train = train
    failed = 0
    for r in range(args.repeats):
        seen.clear()
        t0 = time.perf_counter()
        try:
            cs.phase_scans()
            print(f"repeat {r}: ok in {time.perf_counter() - t0:.1f} s; "
                  f"seen {seen}", flush=True)
        except Exception as e:      # a repeat's failure is the finding
            failed += 1
            traceback.print_exc()
            print(f"repeat {r}: FAILED {type(e).__name__}: {e}; seen "
                  f"{seen}", flush=True)
    print(f"{failed} of {args.repeats} repeats failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
