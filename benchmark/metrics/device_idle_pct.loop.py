"""The device's idle share (%) of the closed loop's traced window: 100
less the union of every device operation's interval over the window."""


def read(rec):
    t = rec.trace
    if t is None or "env_steps" not in rec.work or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
