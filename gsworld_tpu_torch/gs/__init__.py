"""Gaussian scenes: tensors, slot layout, reposing, PLY scans, merging."""

from gsworld_tpu_torch.gs.model import (  # noqa: F401
    GaussianScene,
    SlotLayout,
    build_slot_ids,
    concatenate_scenes,
    scene_from_splats,
    scene_to_splats,
)
from gsworld_tpu_torch.gs.transform import (  # noqa: F401
    PosedGaussians,
    SlotTransforms,
    identity_slots,
    repose_scene,
    transform_gaussians,
)
