"""Per-parameter-group Adam for 3DGS training (port of
gsworld_tpu/train3dgs/optim.py).

Hyperparameters are the reference's OptimizationParams: position lr
1.6e-4 -> 1.6e-6 exponential decay over 30k steps, feature lr 2.5e-3
(f_rest / 20), opacity 2.5e-2, scaling 5e-3, rotation 1e-3; Adam b1 0.9,
b2 0.999, eps 1e-15.  ``semantics`` and ``slot_ids`` are frozen.

The Adam reproduces ``optax.adam(lr, 0.9, 0.999, eps=1e-15)`` under
``optax.multi_transform`` as the JAX package builds it: the learning rate
of step k (0-based) is ``lr(k)``, the bias correction uses k + 1, and eps
is added outside the square root.  It is a small explicit Adam over a
dict of moment tensors, and it updates the scene fields and the moments
in place (densify resets single rows of the moments, which this keeps
simple).

The step's bias corrections and learning rates are device scalars
(``AdamState.scalars``) that ``write_step_scalars`` fills before the
update, so the update itself (``adam_update``) reads nothing from the
host and replays from a CUDA graph (``train.TrainStepGraph``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from gsworld_tpu_torch.gs.model import GaussianScene
from gsworld_tpu_torch.utils.profiling import host_waits

TRAINABLE = ("means", "sh0", "shN", "log_scales", "quats", "logit_opacities")
B1, B2, EPS = 0.9, 0.999, 1e-15


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    """The reference's OptimizationParams (training subset)."""

    iterations: int = 30_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 2.5e-2
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 2e-4


def expon_lr_schedule(lr_init, lr_final, max_steps, delay_mult=0.01,
                      delay_steps=0) -> Callable[[int], float]:
    """The Inria get_expon_lr_func: log-linear interpolation with a
    delayed sine warm-up multiplier."""

    def schedule(step):
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(math.log(lr_init) * (1 - t)
                            + math.log(lr_final) * t)
        if delay_steps > 0:
            delay_rate = delay_mult + (1 - delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
        else:
            delay_rate = 1.0
        return delay_rate * log_lerp

    return schedule


def learning_rates(params: OptimizationParams
                   ) -> Dict[str, Callable[[int], float]]:
    """Learning-rate schedule of each trainable field (the reference's
    spatial_lr_scale is 1 wherever the JAX package trains)."""
    pos = expon_lr_schedule(params.position_lr_init,
                            params.position_lr_final,
                            params.position_lr_max_steps,
                            params.position_lr_delay_mult)

    def const(lr):
        return lambda step: lr

    return dict(means=pos, sh0=const(params.feature_lr),
                shN=const(params.feature_lr / 20.0),
                log_scales=const(params.scaling_lr),
                quats=const(params.rotation_lr),
                logit_opacities=const(params.opacity_lr))


@dataclasses.dataclass
class AdamState:
    mu: Dict[str, torch.Tensor]   # first moments, per trainable field
    nu: Dict[str, torch.Tensor]   # second moments
    count: int = 0                # steps taken
    # f32 on the moments' device: the step's two bias corrections, then
    # the learning rate of each field of TRAINABLE
    scalars: Optional[torch.Tensor] = None


def adam_init(scene: GaussianScene) -> AdamState:
    return AdamState(
        mu={f: torch.zeros_like(getattr(scene, f)) for f in TRAINABLE},
        nu={f: torch.zeros_like(getattr(scene, f)) for f in TRAINABLE},
        scalars=torch.ones(2 + len(TRAINABLE), dtype=torch.float32,
                           device=scene.means.device))


def write_step_scalars(state: AdamState,
                       lrs: Dict[str, Callable[[int], float]]):
    """Write the device scalars of step ``state.count``: the bias
    corrections 1 - b^(k + 1) and each field's ``lrs[f](k)``.  On the card
    the copy is queued from pinned memory, so it waits for nothing; the
    pinned buffer is allocated anew each step, which waits for the card
    (``host.sync/pinned_alloc``)."""
    k = state.count
    vals = torch.tensor([1.0 - B1 ** (k + 1), 1.0 - B2 ** (k + 1)]
                        + [lrs[f](k) for f in TRAINABLE],
                        dtype=torch.float32)
    if state.scalars.is_cuda:
        host_waits("pinned_alloc", state.scalars.device)
        vals = vals.pin_memory()
    state.scalars.copy_(vals, non_blocking=True)


@torch.no_grad()
def adam_update(scene: GaussianScene, grads: Dict[str, torch.Tensor],
                state: AdamState):
    """The Adam update of the step whose scalars ``write_step_scalars``
    wrote, on every trainable field, in place (fields and moments); it
    reads nothing from the host."""
    bc1, bc2 = state.scalars[0], state.scalars[1]
    for i, f in enumerate(TRAINABLE):
        g = grads[f]
        mu = state.mu[f].mul_(B1).add_((1.0 - B1) * g)
        nu = state.nu[f].mul_(B2).add_((1.0 - B2) * (g * g))
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        getattr(scene, f).sub_(state.scalars[2 + i] * upd)


def adam_step(scene: GaussianScene, grads: Dict[str, torch.Tensor],
              state: AdamState, lrs: Dict[str, Callable[[int], float]]):
    """One Adam step on every trainable field, in place (fields, moments,
    scalars and count)."""
    write_step_scalars(state, lrs)
    adam_update(scene, grads, state)
    state.count += 1


@torch.no_grad()
def zero_rows(state: AdamState, changed: torch.Tensor):
    """Zero both moments of the rows flagged ``changed`` (N,) bool, in
    place; the step count is kept."""
    keep = (~changed).to(next(iter(state.mu.values())).dtype)
    for m in (*state.mu.values(), *state.nu.values()):
        m.mul_(keep.reshape((-1,) + (1,) * (m.dim() - 1)))
