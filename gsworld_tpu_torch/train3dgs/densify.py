"""Adaptive density control with a static capacity and an alive mask
(port of gsworld_tpu/train3dgs/densify.py).

Reference behaviour (Inria densify_and_prune): every
``densification_interval`` steps between densify_from_iter and
densify_until_iter, Gaussians whose mean viewspace gradient exceeds 2e-4
are cloned (small ones) or split with scale / 1.6 (large ones); Gaussians
with opacity < 0.005 are pruned; opacity is clamped down to 0.01 every
opacity_reset_interval.

The scene keeps a fixed capacity: pruning clears the alive mask, and new
Gaussians are written into dead slots (requests ranked by gradient,
budgeted by the number of free slots), exactly as the JAX package does.
Every shape is fixed and nothing is read on the host, as in the JAX
package's jitted pass, so the pass captures into a CUDA graph
(``train3dgs/train.py:densify_graph``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from gsworld_tpu_torch.core.maths import (
    inverse_sigmoid,
    quat_normalize,
    quat_rotate,
)
from gsworld_tpu_torch.gs.model import SCENE_FIELDS, GaussianScene


class DensifyState(NamedTuple):
    alive: torch.Tensor       # (N,) bool
    grad_accum: torch.Tensor  # (N,) sum of viewspace grad norms
    denom: torch.Tensor       # (N,) observation counts
    max_radii: torch.Tensor   # (N,) max screen radius seen


def init_densify_state(n_capacity: int, n_alive: int,
                       device="cuda") -> DensifyState:
    alive = torch.arange(n_capacity, device=device) < n_alive
    z = torch.zeros(n_capacity, dtype=torch.float32, device=device)
    return DensifyState(alive=alive, grad_accum=z, denom=z.clone(),
                        max_radii=z.clone())


def accumulate_stats(ds: DensifyState, mean2d_grad, radii) -> DensifyState:
    """Per-render statistics update (visible Gaussians only)."""
    seen = radii > 0
    gnorm = torch.linalg.norm(mean2d_grad, dim=-1)
    return DensifyState(
        alive=ds.alive,
        grad_accum=ds.grad_accum + torch.where(seen, gnorm,
                                               torch.zeros_like(gnorm)),
        denom=ds.denom + seen.to(torch.float32),
        max_radii=torch.maximum(ds.max_radii, radii.to(torch.float32)))


def pad_scene_capacity(scene: GaussianScene, capacity: int) -> GaussianScene:
    """Append dead slots up to ``capacity``: log-scale -10, opacity logit
    -10 (alpha ~5e-5 < 1/255, so they never render), quaternion w = 1,
    everything else zero."""
    n = scene.num_gaussians
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} Gaussians")
    fill = dict(log_scales=-10.0, logit_opacities=-10.0)

    def pad(name):
        x = getattr(scene, name)
        tail = torch.full((capacity - n,) + x.shape[1:], fill.get(name, 0),
                          dtype=x.dtype, device=x.device)
        if name == "quats":
            tail[:, 0] = 1.0
        return torch.cat([x, tail])

    return GaussianScene(**{f: pad(f) for f in SCENE_FIELDS})


def densify_and_prune(scene: GaussianScene, ds: DensifyState,
                      generator: Optional[torch.Generator] = None,
                      grad_threshold: float = 2e-4,
                      min_opacity: float = 0.005,
                      percent_dense: float = 0.01,
                      scene_extent: float = 3.0,
                      max_screen_size: float = 0.0,
                      noise: Optional[torch.Tensor] = None):
    """One densify + prune pass at fixed capacity.

    The split displacement is ``noise`` (N, 3) when given, else standard
    normal draws from ``generator``.  Returns (scene, densify state with
    cleared statistics, ``changed`` (N,) bool: rows rewritten, pruned or
    shrunk, whose optimizer moments the caller resets)."""
    N = scene.num_gaussians
    avg_grad = ds.grad_accum / ds.denom.clamp_min(1.0)
    scale_max = torch.exp(scene.log_scales).max(dim=-1).values
    opacity = 1.0 / (1.0 + torch.exp(-scene.logit_opacities))

    high_grad = (avg_grad > grad_threshold) & ds.alive
    small = scale_max <= percent_dense * scene_extent
    want_clone = high_grad & small
    want_split = high_grad & ~small

    prune = ds.alive & (opacity < min_opacity)
    if max_screen_size > 0:
        prune = prune | (ds.max_radii > max_screen_size) | \
            (scale_max > 0.1 * scene_extent)
    alive = ds.alive & ~prune

    # requests (clones and splits) ranked by gradient take the dead slots
    # in index order, as many as there are: rank position i fires (takes
    # dead slot dst[i] for request src[i]) below the device count n_new
    req = want_clone | want_split
    score = torch.where(req & alive, avg_grad,
                        torch.full_like(avg_grad, -math.inf))
    src = torch.argsort(-score, stable=True)
    dst = torch.argsort(alive.to(torch.int32), stable=True)
    n_new = torch.minimum((~alive).sum(), (score > -math.inf).sum())
    take = torch.arange(N, device=alive.device) < n_new

    if noise is None:
        noise = torch.randn((N, 3), generator=generator,
                            dtype=scene.means.dtype, device=scene.means.device)
    split = want_split[src][:, None]
    scales = torch.exp(scene.log_scales[src])
    disp = quat_rotate(quat_normalize(scene.quats[src]), noise * scales)
    new = {f: getattr(scene, f)[src] for f in SCENE_FIELDS}
    new["means"] = torch.where(split, new["means"] + disp, new["means"])
    new["log_scales"] = torch.where(split, new["log_scales"] - math.log(1.6),
                                    new["log_scales"])

    # positions that do not fire write their slot's own row back
    out = {}
    for f in SCENE_FIELDS:
        x = getattr(scene, f).clone()
        fire = take.reshape((-1,) + (1,) * (x.dim() - 1))
        x[dst] = torch.where(fire, new[f], x[dst])
        out[f] = x
    # split originals shrink in place
    shrink = want_split & alive
    out["log_scales"] = torch.where(shrink[:, None],
                                    out["log_scales"] - math.log(1.6),
                                    out["log_scales"])
    alive2 = alive.clone()
    alive2[dst] = alive[dst] | take
    changed = prune | shrink
    changed[dst] = changed[dst] | take

    z = torch.zeros(N, dtype=torch.float32, device=alive.device)
    return GaussianScene(**out), DensifyState(
        alive=alive2, grad_accum=z, denom=z.clone(),
        max_radii=z.clone()), changed


def reset_opacity(scene: GaussianScene, max_opacity: float = 0.01
                  ) -> GaussianScene:
    """Clamp opacities down to ``max_opacity``."""
    cap = inverse_sigmoid(torch.tensor(max_opacity))
    return dataclasses.replace(
        scene, logit_opacities=torch.minimum(scene.logit_opacities,
                                             cap.to(scene.logit_opacities)))
