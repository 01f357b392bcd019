"""The train step graph's backward (ms): from its *forward|backward*
stamp to its *backward|update* stamp (the backward compositor, the
per-Gaussian sums, autograd through projection and SH, the alive mask),
over the read iterations of the program's recorded stretch
(``benchmark/spans.py``)."""

from benchmark.spans import readings


def read(rec):
    return readings(rec).get("train_backward_ms")
