"""The benchmark of gsworld_tpu_torch, the PyTorch and CUDA port.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root of the checkout names the cells, the
configurations and the metrics.  Everything of one configuration, one
traffic mix or one metric sits in a file of its own that the harness finds
by its name:

  configs/<config>.json    the configuration as it is run; ``driver``
                           names the kind of run
  traffic/<traffic>.json   a traffic mix's parameters
  drivers/<driver>.py      one kind of run (the closed loop, training)
  metrics/<metric>.py      one metric's reader
  reference/               the plain reference that decides ``correct``

Nothing here imports ``jax`` or the JAX package ``gsworld_tpu``; the
reference imports nothing of ``gsworld_tpu_torch`` either.
"""
