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
  physics/   robot specs (JSON+NPZ, or URDF), kinematics, IK, dynamics,
             contacts and the world step
  envs/      agents, controllers and the task envs
  gs/        Gaussian scene tensors, PLY I/O, real-scan merging, synthetic
             scenes, slot reposing
  render/    camera bridge, projection, binning, compositing; the CUDA
             kernels live in ``csrc/`` and are bound in
             ``render/rasterize_cuda.py``
  wrapper/   GSWorldRenderer and GSWorldWrapper: FK -> slots -> repose ->
             render, batched over envs x cameras, in the env step
  rollout/   the random-action closed loop, the motion planners and
             scripted solutions, demo recording, replay and collection
  dist/      the env axis split over devices: the mesh, the split and
             gather of batched state, the cross-env mean, the sharded loop
  train3dgs/ 3DGS training: loss, per-group Adam, densify/prune, trainer
  real2sim/  COLMAP text I/O and SfM, ArUco scale, 3DGS reconstruction,
             the robot's point cloud, Umeyama + ICP, label transfer
  utils/     env-state checkpoints, the CUDA graph capture, and the
             recording: host spans, counters and device stamps that
             replay with the graphs (profiling.py)
  tools/     timing and fidelity scripts for the card, and the robot-spec
             extraction

The JAX functions left without a counterpart, and why, are listed in
ROADMAP.md (A11).
"""

__version__ = "0.1.0"
