"""Closed-loop rate (env-steps/s): every env-step the window completed
(steps times envs, resets at episode ends inside the window) over the
window's seconds, host clock."""


def read(rec):
    steps = rec.work.get("env_steps")
    if not steps or rec.window_s <= 0:
        return None
    return steps / rec.window_s
