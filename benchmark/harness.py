"""What every run shares: finding a cell's files by name, the cache
directories, the card check, the check that no JAX was loaded, the run
record that the metric readers read, and the result line."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gsworld_tpu")
# the build and kernel caches, each at a fixed path inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
              "TRITON_CACHE_DIR": ".bench_cache/triton",
              "CUDA_CACHE_PATH": ".bench_cache/cuda"}


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


def set_cache_dirs(root: Path = ROOT) -> None:
    """Point every build and kernel cache into the checkout (the port's
    own kernel library builds under ``gsworld_tpu_torch/_build``, inside
    it too); keep ``transformers``-style libraries from loading JAX."""
    for var, rel in CACHE_DIRS.items():
        path = root / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise BenchError(f"{path} is missing") from None


@dataclasses.dataclass
class Cell:
    """One cell as BENCHMARK.json and its files state it."""

    name: str
    entry: dict             # its entry under "workloads"
    config_entry: dict      # its configuration's entry under "configs"
    config: dict            # the configuration's file
    traffic: dict           # benchmark/traffic/<traffic>.json
    end_to_end: List[dict]  # the end-to-end metrics it reports
    per_layer: List[dict]   # the per-layer metrics it reports

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """Resolve a cell by its name: BENCHMARK.json's entry, its
    configuration's file, its traffic file and its metrics."""
    spec = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise BenchError(f"no cell {name!r} in BENCHMARK.json; cells: "
                         f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config_entry = configs[entry["config"]]
    return Cell(
        name=name, entry=entry, config_entry=config_entry,
        config=load_json(root / config_entry["file"]),
        traffic=load_json(root / "benchmark" / "traffic"
                          / f"{entry['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)])


def driver_module(kind: str):
    """benchmark/drivers/<kind>.py: one kind of run."""
    if not (BENCH_DIR / "drivers" / f"{kind}.py").exists():
        raise BenchError(f"no driver benchmark/drivers/{kind}.py")
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str, root: Path = ROOT):
    """benchmark/metrics/<metric>.py (a name may hold dots): the module
    whose ``read(record)`` gives the metric's value, or None where the
    run found nothing to read."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    if not path.exists():
        raise BenchError(f"no reader benchmark/metrics/{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def require_cards(chips: int) -> None:
    """A run measures the card: without one (or with fewer than the cell
    asks for) it stops, and nothing falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark runs on the card "
                         "only")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} are visible")


def forbidden_modules() -> List[str]:
    """Modules in this process whose top-level name is JAX's or the JAX
    package's (the whole name before the first dot: ``gsworld_tpu_torch``
    is the port and allowed)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers.  Times in seconds."""

    cell: Cell
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0           # the measured window (host clock)
    calls: List[float] = dataclasses.field(default_factory=list)
    #                                 each timed call of the window
    work: Dict[str, float] = dataclasses.field(default_factory=dict)
    #                                 work completed: "env_steps", "iters"
    peak_bytes: int = 0
    trace: Any = None               # trace.TraceData of a --trace 1 run
    driver: Any = None              # the driver, while it holds the program
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


def read_metrics(metrics: List[dict], record: Record) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(count: int, peak_bytes: int, trace=None) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def checks_line(checks: List[Tuple[str, float, float]]) -> Dict[str, dict]:
    return {name: {"value": value, "limit": limit}
            for name, value, limit in checks}


def print_result(result: dict, checks) -> None:
    """The checks as the last lines on standard error, and the result as
    the last line on standard output, its checks under the last key."""
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = checks_line(checks)
    print(json.dumps(result), flush=True)


def failed(checks) -> bool:
    return any(not (value <= limit) for _, value, limit in checks)


def seed_rng(seed: int, stream: str):
    """A NumPy generator for one use (``stream``) of ``seed``: any whole
    number, however large, gives its own draws for each use."""
    import numpy as np
    return np.random.default_rng(
        [abs(int(seed)), int(seed < 0)] + [ord(c) for c in stream])


def episode_seed(rng) -> int:
    return int(rng.integers(0, 2 ** 31 - 1))
