"""The training iteration on the device (ms): the union of the device's
operations over the traced window (the train step's graph, the loss read
back) over the iterations in it, which hold no densify pass."""


def read(rec):
    t = rec.trace
    if t is None or t.calls <= 0 or t.busy_s <= 0:
        return None
    return 1e3 * t.busy_s / t.calls
