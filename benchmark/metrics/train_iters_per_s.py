"""Training rate (iters/s): every training iteration the window
completed, with the densify passes and opacity resets that fall among
them, over the window's seconds, host clock."""


def read(rec):
    iters = rec.work.get("iters")
    if not iters or rec.window_s <= 0:
        return None
    return iters / rec.window_s
