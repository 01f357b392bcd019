"""gsworld_tpu_torch — the PyTorch + CUDA port of gsworld_tpu.

The JAX package ``gsworld_tpu`` stays in the repository as the reference;
this package is held against it by the tests in ``tests/test_torch_*.py``.
It imports ``torch`` and never ``jax`` or ``gsworld_tpu``, and loads no
module of the JAX package: the calibration data is the port's own copy
(``constants.py``, held equal to the JAX package's by
``tests/test_torch_constants.py``), and robot specs are read from the
JSON/NPZ data files under ``gsworld_tpu/assets/``.  Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU.

Subpackage map (module names follow the JAX package):
  core/      quaternion and SE(3) math
  physics/   robot spec loading and forward kinematics
  envs/      static task descriptions (agents, cameras, actor names)
  gs/        Gaussian scene tensors, synthetic scenes, slot reposing
  render/    camera bridge, projection, binning, compositing; the CUDA
             kernels live in ``csrc/`` and are bound in
             ``render/rasterize_cuda.py``
  wrapper/   GSWorldRenderer: FK -> slots -> repose -> render, batched over
             envs x cameras
  train3dgs/ 3DGS training: loss, per-group Adam, densify/prune, trainer
  real2sim/  train_from_colmap_model: point cloud + posed images -> scene

Ported so far: the GS render half of the AlignFr3 step and 3DGS training
(the differentiable render).  Physics, the closed loop, planning and the
COLMAP / real-scan I/O are still to port (ROADMAP.md).
"""

__version__ = "0.1.0"
