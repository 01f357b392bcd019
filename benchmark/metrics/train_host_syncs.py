"""Operations per training iteration that make the host wait for the
card: the program's ``host.sync/*`` counters over the read iterations of
its recorded stretch (``benchmark/spans.py``)."""

from benchmark.spans import readings


def read(rec):
    return readings(rec).get("train_host_syncs")
