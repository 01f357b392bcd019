"""COLMAP SfM runner (port of gsworld_tpu/real2sim/sfm.py).

Parity port of real2sim/scripts/sfm.py:22-151: feature_extractor (single
PINHOLE camera) -> exhaustive_matcher -> mapper
(ba_global_function_tolerance=1e-6) -> model_converter to TXT.  Shells out
to the colmap binary and raises a clear error when it is not installed
(COLMAP is an offline host tool).
"""

from __future__ import annotations

import os
import shutil
import subprocess


def _colmap(command: str = "colmap") -> str:
    path = shutil.which(command)
    if path is None:
        raise FileNotFoundError(
            "colmap binary not found; install COLMAP to run SfM "
            "(the rest of the real2sim pipeline accepts any COLMAP text "
            "model directory)")
    return path


def run_sfm(image_dir: str, workspace: str,
            camera_model: str = "PINHOLE",
            single_camera: bool = True,
            ba_global_function_tolerance: float = 1e-6,
            verbose: bool = False,
            colmap_command: str = "colmap") -> str:
    """Run the full SfM pipeline; -> the TXT model directory
    (``<workspace>/sparse_txt``).

    ``colmap_command`` names the binary (looked up on PATH).  The JAX
    package's ``run_sfm`` has no such parameter, though its
    ``reconstruct_scene`` passes one, so there SfM raises TypeError
    before COLMAP is looked for (ROADMAP C14); the port takes it."""
    colmap = _colmap(colmap_command)
    os.makedirs(workspace, exist_ok=True)
    db = os.path.join(workspace, "database.db")
    sparse = os.path.join(workspace, "sparse")
    txt = os.path.join(workspace, "sparse_txt")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(txt, exist_ok=True)

    def run(args):
        kw = {} if verbose else dict(stdout=subprocess.DEVNULL,
                                     stderr=subprocess.DEVNULL)
        subprocess.run(args, check=True, **kw)

    run([colmap, "feature_extractor",
         "--database_path", db, "--image_path", image_dir,
         "--ImageReader.camera_model", camera_model,
         "--ImageReader.single_camera", "1" if single_camera else "0"])
    run([colmap, "exhaustive_matcher", "--database_path", db])
    run([colmap, "mapper",
         "--database_path", db, "--image_path", image_dir,
         "--output_path", sparse,
         "--Mapper.ba_global_function_tolerance",
         str(ba_global_function_tolerance)])
    run([colmap, "model_converter",
         "--input_path", os.path.join(sparse, "0"),
         "--output_path", txt, "--output_type", "TXT"])
    return txt
