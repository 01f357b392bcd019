"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level names (``gsworld_tpu_torch``, the port, is allowed),
and the reference imports nothing of the port either.  Each check runs
in a fresh interpreter."""

import subprocess
import sys

from benchmark import harness as H

RUN_MODULES = """
import importlib, pkgutil, sys
import benchmark.run, benchmark.control, benchmark.reference
from benchmark import harness as H
for p in sorted((H.BENCH_DIR / "drivers").glob("*.py")):
    importlib.import_module("benchmark.drivers." + p.stem)
for p in sorted((H.BENCH_DIR / "metrics").glob("*.py")):
    H.reader(p.stem)
for m in pkgutil.walk_packages(benchmark.reference.__path__,
                               "benchmark.reference."):
    importlib.import_module(m.name)
from gsworld_tpu_torch import envs
from gsworld_tpu_torch.wrapper import gs_env
print(sorted({m.split(".")[0] for m in sys.modules}))
"""

REFERENCE_ONLY = """
import importlib, pkgutil, sys
import benchmark.reference
for m in pkgutil.walk_packages(benchmark.reference.__path__,
                               "benchmark.reference."):
    importlib.import_module(m.name)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def top_levels(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_nothing_the_benchmark_runs_imports_jax():
    names = top_levels(RUN_MODULES)
    assert "gsworld_tpu_torch" in names and "benchmark" in names
    assert not names & set(H.FORBIDDEN), names & set(H.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    names = top_levels(REFERENCE_ONLY)
    assert "benchmark" in names
    assert not names & (set(H.FORBIDDEN) | {"gsworld_tpu_torch"})


def test_jax_loaded_by_the_check_stops_the_run(monkeypatch, capsys):
    """A module of JAX's name that turns up as late as the check (after
    the window and the readers) still stops the run with no result."""
    import types

    from benchmark import run

    def run_cell(cell, *a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True}, []

    monkeypatch.setattr(run, "run_cell", run_cell)
    monkeypatch.setattr(H, "require_cards", lambda chips: None)
    assert run.main(["--workload", "fr3_align_loop.e1", "--seed", "1",
                     "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
