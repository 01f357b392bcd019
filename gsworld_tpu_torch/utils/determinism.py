"""Which ops of a call add in no fixed order on the card.

``audit(fn)`` runs ``fn()`` once under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and under
:class:`OpAudit`, a dispatch mode that sees every aten op the call runs,
forward and backward, and names:

  * the ops PyTorch has no deterministic CUDA kernel for (the mode warns
    for each; ``warn_only`` lets the call run on, so all are listed);
  * the ops of the kinds the train path could reach whose CUDA kernel
    adds with atomics, or picks a cuDNN algorithm, unless that mode is on:
    the mode quietly swaps in another kernel for them, so its warnings
    alone miss them.  These are the scatter- and index-adds, ``index_put_``
    / ``put_`` with ``accumulate``, the convolutions and the replicate and
    reflect pads' backwards (the SSIM blur was a convolution after a
    replicate pad).

The port's own kernels (``render/rasterize_cuda.py``, called through
ctypes) are not aten ops: what they add and in which order is written in
their sources (``csrc/``).
"""

from __future__ import annotations

import collections
import contextlib
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops whose CUDA kernel adds in no fixed order whatever the arguments
ALWAYS = frozenset({
    "index_add", "index_add_", "scatter_add", "scatter_add_",
    "convolution", "_convolution", "convolution_backward",
    "cudnn_convolution", "replication_pad1d_backward",
    "replication_pad2d_backward", "replication_pad3d_backward",
    "reflection_pad1d_backward", "reflection_pad2d_backward",
    "reflection_pad3d_backward",
})
# ops that add into their destination when their 4th argument (or the
# ``accumulate`` keyword) is true
ACCUMULATE = frozenset({"index_put", "index_put_", "_index_put_impl",
                        "_index_put_impl_", "put", "put_"})


def nondeterministic(func, args, kwargs):
    """-> why the aten op ``func`` on these arguments adds in no fixed
    order on the card, or None."""
    name = func.overloadpacket.__name__
    if name in ALWAYS:
        return str(func)
    if name in ACCUMULATE and (kwargs.get("accumulate")
                               or (len(args) > 3 and args[3] is True)):
        return f"{func} (accumulate)"
    return None


class OpAudit(TorchDispatchMode):
    """Counts, by name and reason, the aten ops run under it that add in
    no fixed order on the card (``nondeterministic``) in ``found``, and
    every aten op it sees in ``ops``.
    ``ignoring()`` leaves out what runs inside it (the CPU tests wrap the
    kernels' plain versions in it: on the card the kernels run)."""

    def __init__(self):
        super().__init__()
        self.found = collections.Counter()
        self.ops = 0
        self._ignore = 0

    @contextlib.contextmanager
    def ignoring(self):
        self._ignore += 1
        try:
            yield
        finally:
            self._ignore -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._ignore:
            self.ops += 1
            why = nondeterministic(func, args, kwargs)
            if why:
                self.found[why] += 1
        return func(*args, **kwargs)


def audit(fn, mode: OpAudit | None = None):
    """Run ``fn()`` once under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` (without its filling of uninitialised memory) and
    under ``mode`` (a new ``OpAudit`` by default) -> (fn's result,
    {reason: count}): the ops of the call that are not deterministic on
    the card, by the mode's warnings and by the audit.  The previous
    settings are restored."""
    import torch.utils.deterministic as det
    mode = mode or OpAudit()
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with mode:
                out = fn()
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        det.fill_uninitialized_memory = fill
    found = collections.Counter(mode.found)
    for w in caught:
        text = str(w.message)
        if "deterministic" in text:
            found["warning: " + text.splitlines()[0][:200]] += 1
    return out, dict(found)
