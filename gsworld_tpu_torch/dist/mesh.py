"""The env axis split across devices (port of gsworld_tpu/dist/mesh.py).

Envs are embarrassingly parallel: nothing crosses from one env to another
but metric reductions.  JAX shards one program over a device mesh; here
an :class:`EnvMesh` is an ordered tuple of devices, a batched tree is cut
into one tree per device (``shard_env_axis``), each device steps its own
rows, and the results come back in env order (``gather_env_axis``).

    mesh = env_mesh()                          # every visible card
    parts = shard_env_axis(state, mesh)        # one tree per device
    state = gather_env_axis(parts, mesh[0])    # rows back in env order

A mesh may name a device more than once: ``env_mesh(["cpu", "cpu"])``
makes two shards on the CPU (the tests), ``["cuda:0", "cuda:0"]`` two on
one card.  Across processes, call :func:`init_distributed` first; then
:func:`mean_across_envs` all-reduces over the process group.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ENV_AXIS = "env"


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """An ordered tuple of devices along the axis ``axis_name``; shard i
    holds the i-th block of rows."""

    devices: Tuple[torch.device, ...]
    axis_name: str = ENV_AXIS

    @property
    def shape(self):
        """``{axis_name: number of shards}``, as a JAX mesh's."""
        return {self.axis_name: len(self.devices)}

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, i) -> torch.device:
        return self.devices[i]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tree's leaves go on a mesh: rows split along the env axis
    (``split``) or the whole leaf on every device."""

    mesh: EnvMesh
    split: bool


def init_distributed(**kwargs) -> None:
    """Join a process group (no-op in one process): the keyword arguments
    go to ``torch.distributed.init_process_group``, whose backend defaults
    to ``nccl`` where a card is visible and ``gloo`` where none is.

    Errors are logged, not swallowed silently: in a multi-process run a
    group that failed to form means that every later collective hangs or
    sees one process, which is much harder to diagnose than this warning.
    """
    kwargs.setdefault("backend",
                      "nccl" if torch.cuda.is_available() else "gloo")
    try:
        dist.init_process_group(**kwargs)
    except (RuntimeError, ValueError) as e:
        logging.getLogger(__name__).warning(
            "torch.distributed.init_process_group skipped: %s (fine in one "
            "process; in a multi-process run this means the process group "
            "did NOT form)", e)


def env_mesh(devices: Optional[Sequence] = None) -> EnvMesh:
    """A mesh over ``devices`` (names or ``torch.device``s, repeats
    allowed), by default every visible CUDA device; raises where there is
    none."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("env_mesh(): no CUDA device is visible; "
                               "name the devices (e.g. ['cpu'])")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("env_mesh(): no devices given")
    return EnvMesh(devices)


def env_sharding(mesh: EnvMesh) -> Placement:
    """Placement of leaves with a leading env axis: rows split."""
    return Placement(mesh, split=True)


def replicated(mesh: EnvMesh) -> Placement:
    """Placement of a leaf held whole by every device."""
    return Placement(mesh, split=False)


def _is_node(x) -> bool:
    return (isinstance(x, (dict, list, tuple))
            or (dataclasses.is_dataclass(x) and not isinstance(x, type)))


def _tree_map(fn, trees: Sequence[Any]):
    """``fn(leaves)`` at every leaf position of the equally shaped
    ``trees`` (dicts, lists, tuples, named tuples and dataclass instances
    such as ``EnvState`` and ``WorldState``; anything else is a leaf)."""
    t0 = trees[0]
    if not _is_node(t0):
        return fn(list(trees))
    if isinstance(t0, dict):
        return type(t0)((k, _tree_map(fn, [t[k] for t in trees]))
                        for k in t0)
    if isinstance(t0, (list, tuple)):
        items = [_tree_map(fn, [t[i] for t in trees])
                 for i in range(len(t0))]
        return type(t0)(*items) if hasattr(t0, "_fields") else type(t0)(items)
    return dataclasses.replace(t0, **{
        f.name: _tree_map(fn, [getattr(t, f.name) for t in trees])
        for f in dataclasses.fields(t0) if f.init})


def _splits(x, n: int) -> bool:
    """True where a leaf splits over ``n`` shards: a tensor whose leading
    size is above 0 and divides by ``n`` (JAX's rule)."""
    return (isinstance(x, torch.Tensor) and x.ndim >= 1
            and x.shape[0] > 0 and x.shape[0] % n == 0)


def shard_env_axis(tree, mesh: EnvMesh) -> List[Any]:
    """One tree per mesh device: a tensor leaf whose leading size divides
    by ``len(mesh)`` is cut into contiguous row blocks, block i moved to
    device i; any other tensor leaf is copied whole to every device;
    leaves that are not tensors are shared."""
    n = len(mesh)

    def put(x, i):
        if not isinstance(x, torch.Tensor):
            return x
        if _splits(x, n):
            return x.tensor_split(n)[i].to(mesh[i])
        return x.to(mesh[i])

    return [_tree_map(lambda leaves, i=i: put(leaves[0], i), [tree])
            for i in range(n)]


def gather_env_axis(trees: Sequence[Any], device):
    """The inverse of :func:`shard_env_axis` for trees whose tensor leaves
    carry the env axis (states, observations, actions, rewards): each
    tensor leaf of rank >= 1 is the shards' blocks concatenated in mesh
    order on ``device``; scalar tensors and other leaves are the first
    tree's."""
    device = torch.device(device)

    def cat(leaves):
        x = leaves[0]
        if isinstance(x, torch.Tensor) and x.ndim >= 1:
            return torch.cat([t.to(device) for t in leaves])
        return x.to(device) if isinstance(x, torch.Tensor) else x

    return _tree_map(cat, list(trees))


def mean_across_envs(x):
    """The mean over all envs (the leading axis) of a tensor, or of a list
    of per-shard tensors: the shards' sums over the total count, on the
    first shard's device.  In an initialized process group the sums and
    counts are all-reduced first, so every process gets the mean over
    every process's envs."""
    parts = [x] if isinstance(x, torch.Tensor) else list(x)
    dev = parts[0].device
    total = sum(p.to(torch.float32).sum(dim=0).to(dev) for p in parts)
    count = torch.tensor(float(sum(p.shape[0] for p in parts)), device=dev)
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(total)
        dist.all_reduce(count)
    return total / count
