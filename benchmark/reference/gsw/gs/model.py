"""Gaussian scene tensors plus the static slot layout (port of
gsworld_tpu/gs/model.py).

Every Gaussian carries a slot id: an index into a small per-env transform
stack (slot 0 = static background; one slot per robot link; one per
dynamic object).  Reposing gathers the slot transform per Gaussian; the
base scene is never copied per env.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

SH_REST_COEFFS = 15  # degree-3 SH: (3+1)^2 - 1


@dataclasses.dataclass
class GaussianScene:
    """Structure of arrays, N Gaussians.  Storage conventions of the PLY
    layout: log-space scales, logit opacities, wxyz quats (not
    necessarily unit), channel-major ``shN`` (N, 45)."""

    means: torch.Tensor            # (N, 3) f32
    sh0: torch.Tensor              # (N, 3) f32
    shN: torch.Tensor              # (N, 45) f32
    log_scales: torch.Tensor       # (N, 3) f32
    quats: torch.Tensor            # (N, 4) f32 wxyz
    logit_opacities: torch.Tensor  # (N,) f32
    semantics: torch.Tensor        # (N,) i32
    slot_ids: torch.Tensor         # (N,) i64 index into the transform stack

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]


SCENE_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianScene))


@dataclasses.dataclass(frozen=True)
class SlotLayout:
    """Named movable parts -> transform-stack slots.  Slot 0 is the
    identity/static slot; ``scaled`` marks object slots, whose repose runs
    the reference's ``inverse_sigmoid(exp(s) * k)`` scale rule."""

    names: Tuple[str, ...]
    scaled: Tuple[bool, ...]
    link_slots: Tuple[int, ...]     # in link order
    object_slots: Dict[str, int]    # actor name -> slot

    @property
    def num_slots(self) -> int:
        return len(self.names)

    def slot_of(self, name: str) -> int:
        return self.names.index(name)


def _labels_of(entry: Union[int, Sequence[int]]) -> List[int]:
    return list(entry) if isinstance(entry, (list, tuple)) else [int(entry)]


def build_slot_ids(
    semantics: np.ndarray,
    gs_semantics: Dict[str, Union[int, Sequence[int]]],
    link_names: Sequence[str],
    object_labels: Dict[str, int],
) -> Tuple[np.ndarray, SlotLayout]:
    """Assign a transform slot to every Gaussian from its semantic label:
    one slot per link (in ``link_names`` order), then one per object.
    Unclaimed labels (including -1) stay in slot 0."""
    semantics = np.asarray(semantics, np.int32)
    names: List[str] = [""]
    scaled: List[bool] = [False]
    slot_ids = np.zeros(semantics.shape[0], np.int32)
    link_slots: List[int] = []
    for link in link_names:
        slot = len(names)
        names.append(link)
        scaled.append(False)
        link_slots.append(slot)
        if link in gs_semantics:
            labels = np.asarray(_labels_of(gs_semantics[link]), np.int32)
            slot_ids[np.isin(semantics, labels)] = slot
    object_slots: Dict[str, int] = {}
    for actor, label in object_labels.items():
        slot = len(names)
        names.append(actor)
        scaled.append(True)
        object_slots[actor] = slot
        slot_ids[semantics == np.int32(label)] = slot
    return slot_ids, SlotLayout(names=tuple(names), scaled=tuple(scaled),
                                link_slots=tuple(link_slots),
                                object_slots=object_slots)


def scene_from_numpy(fields: Mapping[str, np.ndarray],
                     device="cuda") -> GaussianScene:
    """Scene from numpy arrays keyed by the GaussianScene field names
    (e.g. ``np.asarray`` of each field of a JAX scene), so both packages
    render the same weights."""
    missing = set(SCENE_FIELDS) - set(fields)
    if missing:
        raise KeyError(f"scene fields missing: {sorted(missing)}")

    def t(name, dtype):
        return torch.as_tensor(np.array(fields[name]), dtype=dtype,
                               device=device).contiguous()

    n = np.asarray(fields["means"]).shape[0]
    f32 = torch.float32
    return GaussianScene(
        means=t("means", f32),
        sh0=t("sh0", f32).reshape(n, 3),
        shN=t("shN", f32).reshape(n, 45),
        log_scales=t("log_scales", f32),
        quats=t("quats", f32),
        logit_opacities=t("logit_opacities", f32).reshape(n),
        semantics=t("semantics", torch.int32),
        slot_ids=t("slot_ids", torch.int64))


def scene_from_splats(splats: Dict[str, np.ndarray],
                      slot_ids: Optional[np.ndarray] = None,
                      device="cuda") -> GaussianScene:
    """Scene from a splat dict (PLY layout keys, as gs/synthetic.py makes)."""
    n = splats["means"].shape[0]
    if slot_ids is None:
        slot_ids = np.zeros(n, np.int32)
    return scene_from_numpy(dict(
        means=splats["means"], sh0=splats["sh0"], shN=splats["shN"],
        log_scales=splats["scales"], quats=splats["quats"],
        logit_opacities=splats["opacities"], semantics=splats["semantics"],
        slot_ids=slot_ids), device=device)


def scene_to_numpy(scene: GaussianScene) -> Dict[str, np.ndarray]:
    """Every field as a numpy array keyed by its name (inverse of
    :func:`scene_from_numpy`)."""
    return {f: getattr(scene, f).detach().cpu().numpy() for f in SCENE_FIELDS}


def scene_to_splats(scene: GaussianScene) -> Dict[str, np.ndarray]:
    """Splat dict in the PLY layout (inverse of :func:`scene_from_splats`,
    without slot ids)."""
    a = scene_to_numpy(scene)
    n = scene.num_gaussians
    return {
        "means": a["means"],
        "sh0": a["sh0"].reshape(n, 3, 1),
        "shN": a["shN"].reshape(n, 3, 15),
        "scales": a["log_scales"],
        "quats": a["quats"],
        "opacities": a["logit_opacities"].reshape(n, 1),
        "semantics": a["semantics"],
    }


def concatenate_scenes(scenes: Sequence[GaussianScene]) -> GaussianScene:
    """Merge scenes by concatenating every field (order kept), as
    GaussianModelMerger.merge_models (gaussian_merger.py:213-274); the
    scenes share one device."""
    return GaussianScene(**{f: torch.cat([getattr(s, f) for s in scenes])
                            for f in SCENE_FIELDS})
