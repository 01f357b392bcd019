"""The env step alone (ms): replays of the env's own step graph
(``GsBaseEnv.step``: controller, physics, FK, task state, reward, no
render) from the state the traced window reached, between two CUDA
events."""

from benchmark.timing import cuda_ms

REPS = 10


def read(rec):
    d = rec.driver
    env = getattr(d, "env", None)
    if rec.trace is None or env is None or env.device.type != "cuda":
        return None
    action = d.next_action()
    return cuda_ms(lambda: env.step(action), REPS, warmup=1)
