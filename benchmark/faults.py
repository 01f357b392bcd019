"""Faults planted in the program, to read what the check makes of them:
on the card by ``python3 -m benchmark.control --fault <name>`` (the
training cell's upper readings), on the CPU by the tests.  Each is a
context manager that patches the program while it is open; plant it
before the program's graphs are captured."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def half_batch():
    """The training loss over half of the image's rows (the mean over
    them): half of the batch left out."""
    from gsworld_tpu_torch.train3dgs import train
    loss = train.gs_loss

    def half(render, target, lambda_dssim=0.2):
        h = render.shape[0] // 2
        return loss(render[:h], target[:h], lambda_dssim)

    with patched(train, "gs_loss", half):
        yield


@contextlib.contextmanager
def altered_image():
    """The compositor's image altered where it is produced (+0.1)."""
    from gsworld_tpu_torch.render import rasterize
    composite = rasterize.composite_tiles

    def altered(*args, **kw):
        img, T, seg, rec = composite(*args, **kw)
        return img + 0.1, T, seg, rec

    with patched(rasterize, "composite_tiles", altered):
        yield


FAULTS = {"half_batch": half_batch, "altered_image": altered_image}
