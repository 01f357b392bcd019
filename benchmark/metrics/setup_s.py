"""Set-up time (s): process start to the first timed call (imports, the
kernel build or its cached library, the scene and inputs, every graph
the window replays and the warm-up), host clock."""


def read(rec):
    return rec.setup_s
