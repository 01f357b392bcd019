"""Batched rigid / scaled reposing of Gaussians (port of
gsworld_tpu/gs/transform.py).

Reference semantics, order scale -> rotate -> translate:
  * positions:    x' = R (s x) + t
  * log-scales:   s' = inverse_sigmoid(exp(s_log) * s) on scaled (object)
                  slots — the reference's logit-not-log quirk, kept for
                  parity — else unchanged
  * orientations: q' = quat_multiply(q_R, q / |q|) * |q|
  * opacities:    unchanged
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.gsw.core.maths import (
    inverse_sigmoid,
    matrix_to_quat,
    quat_compose_preserving_norm,
)
from benchmark.reference.gsw.gs.model import GaussianScene


class SlotTransforms(NamedTuple):
    """Per-env, per-slot transform stack: R (..., S, 3, 3), t (..., S, 3),
    scale (..., S); ``apply_scale`` (S,) bool marks object slots."""

    R: torch.Tensor
    t: torch.Tensor
    scale: torch.Tensor
    apply_scale: torch.Tensor


class PosedGaussians(NamedTuple):
    """World-space Gaussians; leading env axes from the transform stack."""

    means: torch.Tensor            # (..., N, 3)
    log_scales: torch.Tensor       # (..., N, 3)
    quats: torch.Tensor            # (..., N, 4)
    logit_opacities: torch.Tensor  # (..., N)


def transform_gaussians(means, log_scales, quats, logit_opacities,
                        R=None, t=None, scale=None):
    """The reference's transform of one set of Gaussians (N, ...), scale
    -> rotate -> translate; ``R`` (..., 3, 3), ``t`` (..., 3) and ``scale``
    (...) broadcast over leading axes, and each that is None is skipped
    (``scale=None`` is the links' rigid repose).  -> (means, log_scales,
    quats, logit_opacities)."""
    if scale is not None:
        s = torch.as_tensor(scale, dtype=means.dtype,
                            device=means.device)[..., None, None]
        means = means * s
        # inverse_sigmoid, not log: the reference's rule, copied as it is
        # (JAX's transform_gaussians does the same)
        log_scales = inverse_sigmoid(torch.exp(log_scales) * s)
    if R is not None:
        means = (R[..., None, :, :] @ means[..., None])[..., 0]
        quats = quat_compose_preserving_norm(
            matrix_to_quat(R)[..., None, :], quats)
    if t is not None:
        means = means + torch.as_tensor(t, dtype=means.dtype,
                                        device=means.device)[..., None, :]
    return means, log_scales, quats, logit_opacities


def repose_scene(scene: GaussianScene, slots: SlotTransforms
                 ) -> PosedGaussians:
    """Repose every Gaussian by its slot transform (slot 0 must be the
    identity).  Stack shapes (B, S, ...) give outputs with a leading (B,).
    Slot rotations become quaternions once per slot; the per-Gaussian work
    is componentwise."""
    sid = scene.slot_ids
    q_slot = matrix_to_quat(slots.R)[..., sid, :]          # (..., N, 4)
    qw, qx, qy, qz = q_slot.unbind(-1)
    tx, ty, tz = slots.t[..., sid, :].unbind(-1)
    s = slots.scale[..., sid]                              # (..., N)
    scaled = slots.apply_scale[sid]                        # (N,)

    eff_s = torch.where(scaled, s, torch.ones_like(s))
    mx = scene.means[:, 0] * eff_s
    my = scene.means[:, 1] * eff_s
    mz = scene.means[:, 2] * eff_s
    log_scales = torch.where(
        scaled[:, None],
        inverse_sigmoid(torch.exp(scene.log_scales) * s[..., None]),
        scene.log_scales.expand(s.shape + (3,)))

    # v' = v + 2 w (qv x v) + 2 qv x (qv x v), then translate
    cx = qy * mz - qz * my
    cy = qz * mx - qx * mz
    cz = qx * my - qy * mx
    means = torch.stack([
        mx + 2.0 * (qw * cx + qy * cz - qz * cy) + tx,
        my + 2.0 * (qw * cy + qz * cx - qx * cz) + ty,
        mz + 2.0 * (qw * cz + qx * cy - qy * cx) + tz,
    ], dim=-1)

    gw, gx, gy, gz = scene.quats.unbind(-1)
    norm = torch.sqrt(gw * gw + gx * gx + gy * gy + gz * gz)
    inv = 1.0 / norm.clamp_min(1e-12)
    nw, nx, ny, nz = gw * inv, gx * inv, gy * inv, gz * inv
    quats = torch.stack([
        (qw * nw - qx * nx - qy * ny - qz * nz) * norm,
        (qw * nx + qx * nw + qy * nz - qz * ny) * norm,
        (qw * ny - qx * nz + qy * nw + qz * nx) * norm,
        (qw * nz + qx * ny - qy * nx + qz * nw) * norm,
    ], dim=-1)
    opac = scene.logit_opacities.expand(s.shape)
    return PosedGaussians(means=means, log_scales=log_scales, quats=quats,
                          logit_opacities=opac)


def identity_slots(num_slots: int, apply_scale, batch_shape=(),
                   device="cuda") -> SlotTransforms:
    """Identity transform stack (batch_shape + (num_slots,)), the static
    default; ``apply_scale`` (num_slots,) marks the object slots."""
    shape = tuple(batch_shape) + (num_slots,)
    f32 = dict(dtype=torch.float32, device=device)
    return SlotTransforms(
        R=torch.eye(3, **f32).expand(shape + (3, 3)),
        t=torch.zeros(shape + (3,), **f32),
        scale=torch.ones(shape, **f32),
        apply_scale=torch.as_tensor(apply_scale, dtype=torch.bool,
                                    device=device))
