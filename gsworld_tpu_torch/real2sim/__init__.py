"""real2sim: the scene reconstruction toolchain (port of
gsworld_tpu/real2sim).

Pipeline (the reference's colmap_and_gs.sh flow):
  1. sfm.run_sfm            — COLMAP SfM (host tool)
  2. aruco_scale            — metric scaling from an ArUco marker
  3. pipeline               — 3DGS training on the card
                              (train_from_colmap_model, reconstruct_scene)
  4. urdf_pcd               — robot scan-pose labelled point cloud
  5. alignment              — Umeyama + scaled ICP -> sim2gs matrix
  6. label_transfer         — per-Gaussian semantic labels for the scan
"""

from gsworld_tpu_torch.real2sim import (  # noqa: F401
    alignment,
    aruco_scale,
    colmap_io,
    label_transfer,
    urdf_pcd,
)
