"""The build of the port's hand-written CUDA kernels, their C interface,
their launch counts, and the argument checks their wrappers share.

The wrappers live with the code that calls them:

  * ``render/rasterize_cuda.py``: the render's and training's kernels
    (csrc/emit.cu, sort_tiles.cu, composite.cu, composite_bwd.cu,
    entry_rows.cu, project.cu);
  * ``physics/world.py:normal_newton``: the contact solver's normal
    Newton stage (csrc/contact_newton.cu);
  * ``utils/profiling.py:stamp``: the device stamps (csrc/stamp.cu).

Build: at first use the sources in ``csrc/`` are compiled with ``nvcc``
for ``sm_90a``, one process per source, all started together, and
linked into one shared library with a plain C interface under
``_build/`` (listed in .gitignore), named by a hash of the sources, the
headers and the flags, and bound with ctypes.  Each C entry returns
``cudaGetLastError()`` after its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

from gsworld_tpu_torch.utils.profiling import counters

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
SOURCES = ("emit.cu", "sort_tiles.cu", "composite.cu", "composite_bwd.cu",
           "entry_rows.cu", "stamp.cu", "project.cu", "contact_newton.cu")
# --fmad=false: every f32 product rounds on its own, as in the plain
# PyTorch versions, so kernel and plain version agree to the last bits
# (the alpha cull's threshold compare is the sensitive one)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of each kernel since the last reset (the counter registry's
# ``kernel_launches`` group); the plain versions do not count
launch_counts = counters.group("kernel_launches", (
    "emit_entries", "sort_tiles", "composite_tiles", "composite_bwd",
    "sum_entry_rows", "project_posed", "normal_newton"))


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


class _Library:
    """The loaded kernel library (one per process)."""

    lib: Optional[ctypes.CDLL] = None
    build_log: str = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def compile_library(sources, defines=()) -> Path:
    """Compile the CUDA ``sources`` (paths; headers beside them) with
    NVCC_FLAGS and a ``-D`` for each of ``defines``, one ``nvcc -c`` per
    source, all started together, and link them into one shared library
    under ``_build/``, unless a build of the same sources, headers and
    flags is there.  -> its path."""
    sources = [Path(p) for p in sources]
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources + sorted({q for p in sources
                                  for q in p.parent.glob("*.cuh")}):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    so_path = BUILD_DIR / f"libgsw_kernels_{h.hexdigest()[:16]}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{i}_{p.stem}.o")
                for i, p in enumerate(sources)]
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", o, str(p)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(sources, objs)]
        _Library.build_log = "".join(proc.communicate()[0] for proc in procs)
        rcs = [proc.returncode for proc in procs]
        lib = os.path.join(tmp, "lib.so")
        if not any(rcs):
            link = subprocess.run([nvcc, *flags[:2], "-shared", "-o", lib,
                                   *objs], capture_output=True, text=True)
            _Library.build_log += link.stdout + link.stderr
            rcs.append(link.returncode)
        if any(rcs):
            raise RuntimeError(f"nvcc failed ({rcs}):\n"
                               + _Library.build_log)
        os.replace(lib, so_path)
    return so_path


def bind_emit(lib: ctypes.CDLL):
    """Declare the C interface of csrc/emit.cu on a loaded library."""
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gsw_emit_entries.argtypes = [P] * 8 + [I] * 7 + [Fl, P]
    lib.gsw_emit_entries.restype = I
    lib.gsw_error_string.argtypes = [I]
    lib.gsw_error_string.restype = ctypes.c_char_p


def build_kernels() -> ctypes.CDLL:
    """Compile (if not already built) and load the kernel library."""
    if _Library.lib is not None:
        return _Library.lib
    lib = ctypes.CDLL(str(compile_library([CSRC_DIR / n for n in SOURCES])))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    LL = ctypes.c_longlong
    bind_emit(lib)
    lib.gsw_sort_tiles_temp_bytes.argtypes = [I, I, P]
    lib.gsw_sort_tiles_temp_bytes.restype = I
    lib.gsw_sort_tiles.argtypes = ([P, ctypes.c_size_t] + [P] * 4
                                   + [I, I, P, P])
    lib.gsw_sort_tiles.restype = I
    lib.gsw_composite_tiles.argtypes = [P] * 11 + [I] * 8 + [Fl] * 5 + [P]
    lib.gsw_composite_tiles.restype = I
    lib.gsw_composite_bwd_parts.argtypes = [I]
    lib.gsw_composite_bwd_parts.restype = I
    lib.gsw_composite_bwd.argtypes = [P] * 7 + [I] * 8 + [Fl, P]
    lib.gsw_composite_bwd.restype = I
    lib.gsw_sum_entry_rows.argtypes = [P] * 6 + [I] * 3 + [P]
    lib.gsw_sum_entry_rows.restype = I
    lib.gsw_stamp.argtypes = [P, I, I, P]
    lib.gsw_stamp.restype = I
    lib.gsw_stamp_on_flag.argtypes = [P, P, I, I, LL, P]
    lib.gsw_stamp_on_flag.restype = I
    lib.gsw_project_posed.argtypes = [P] * 23 + [I] * 9 + [Fl, P]
    lib.gsw_project_posed.restype = I
    lib.gsw_normal_newton.argtypes = ([P, LL, LL, LL] + [P] * 5 + [I] * 4
                                      + [P])
    lib.gsw_normal_newton.restype = I
    lib.gsw_normal_newton_max_rows.argtypes = [I]
    lib.gsw_normal_newton_max_rows.restype = I
    _Library.lib = lib
    return lib


def build_log() -> str:
    """nvcc's output (ptxas register / shared-memory report) of the build
    made in this process, empty when the library was already built."""
    return _Library.build_log


def check(lib, rc: int, name: str):
    """Raise on a C entry's nonzero return (a CUDA error code)."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.gsw_error_string(rc).decode()} ({rc})")


def require(t: torch.Tensor, name: str, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cuda_device(t: torch.Tensor, name: str) -> torch.device:
    """``t``'s device where it is a card, else raise: the kernels' wrappers
    take no other."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device} are not supported "
                         "(CPU takes the plain version, CUDA the kernel)")
    return t.device
