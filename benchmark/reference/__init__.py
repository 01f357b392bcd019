"""The plain reference that decides ``correct``.

``gsw/`` is a frozen copy of gsworld_tpu_torch's eager modules as of
commit e3f5779 (the env, its physics and controller, FK and the
Gaussians' repose, the camera bridge, projection, SH, binning and the
compositor, the 3DGS loss, Adam and densify), renamed, with every CUDA
kernel replaced by its plain PyTorch version.  It runs eagerly only: it
captures no CUDA graph, builds and launches no kernel of its own and
imports nothing of ``gsworld_tpu_torch``.  It rebuilds its own physics
tables, scene and cameras from the same raw files and seeds the program
reads; it takes nothing the program made.  Later changes to the program
leave it as it is, so it holds every later PR to the semantics of that
commit.

Being a copy, it shares any fault the port had at that commit.  Its
witness is the JAX package: the port's own CPU tests against JAX, run
with this copy in the port's place, pass for every part the cells name
(PERF.md gives the readings).

``closed_loop.py`` and ``train_3dgs.py`` step it from the inputs a run
hands both sides and compare what the run's timed path produced.
"""
