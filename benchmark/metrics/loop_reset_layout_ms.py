"""The reset's host layout (ms): the mean ``gsw.reset.layout`` span
(``GsBaseEnv._reset_layout``: the episode's draws laid out on the CPU,
the domain randomization's ``_randomize_world``, one copy to the card),
over a stretch of resets recorded by the program
(``benchmark/reset_spans.py``)."""

from benchmark.reset_spans import readings


def read(rec):
    return readings(rec).get("loop_reset_layout_ms")
