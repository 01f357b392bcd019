"""The hand-written CUDA kernels of the render and training paths, their
plain PyTorch versions, the build, and launch counts.

  * ``emit_entries``    <- gsworld_tpu/render/rasterize_pallas.py:_emit_kernel
                           (csrc/emit.cu)
  * ``composite_tiles`` <- gsworld_tpu/render/rasterize_pallas.py:_segment_kernel
                           (csrc/composite.cu)
  * ``composite_bwd``   <- gsworld_tpu/render/rasterize_pallas.py:_bwd_kernel
                           (csrc/composite_bwd.cu)
  * ``sum_entry_rows``  <- the scatter-add after it in composite_bwd_pallas
                           (csrc/entry_rows.cu; an XLA scatter in JAX, not
                           a Pallas kernel)
  * ``gsw_stamp``       <- none: the device stamps of utils/profiling.py
                           (csrc/stamp.cu)

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (the CPU tests), a CUDA tensor launches the kernel or raises.
Nothing on the CUDA path falls back to the plain version.

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

import numpy as np
import torch

from gsworld_tpu_torch.utils.profiling import counters

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
SOURCES = ("emit.cu", "composite.cu", "composite_bwd.cu", "entry_rows.cu",
           "stamp.cu")
# --fmad=false: every f32 product rounds on its own, as in the plain
# PyTorch versions, so kernel and plain version agree to the last bits
# (the alpha cull's threshold compare is the sensitive one)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

ALPHA_MIN = 1.0 / 255.0
LOG_ALPHA_MIN = float(np.log(np.float32(ALPHA_MIN)))
ALPHA_MAX = 0.99
T_EPS = 1e-4
COLOR_MAX = 4.0   # colours clamp to [0, COLOR_MAX] (the JAX record range)
PLAIN_CHUNK = 64  # entries per step of the plain compositor

# launches of each kernel since the last reset (the counter registry's
# ``kernel_launches`` group); the plain versions do not count
launch_counts = counters.group("kernel_launches", (
    "emit_entries", "composite_tiles", "composite_bwd", "sum_entry_rows"))


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
    bind_emit(lib)
    lib.gsw_composite_tiles.argtypes = [P] * 11 + [I] * 8 + [Fl] * 5 + [P]
    lib.gsw_composite_tiles.restype = I
    lib.gsw_composite_bwd_parts.argtypes = [I]
    lib.gsw_composite_bwd_parts.restype = I
    lib.gsw_composite_bwd.argtypes = [P] * 7 + [I] * 8 + [Fl, P]
    lib.gsw_composite_bwd.restype = I
    lib.gsw_sum_entry_rows.argtypes = [P] * 5 + [I] * 3 + [P]
    lib.gsw_sum_entry_rows.restype = I
    lib.gsw_stamp.argtypes = [P, I, I, P]
    lib.gsw_stamp.restype = I
    lib.gsw_stamp_on_flag.argtypes = [P, P, I, I, ctypes.c_longlong, P]
    lib.gsw_stamp_on_flag.restype = I
    _Library.lib = lib
    return lib


def build_log() -> str:
    """nvcc's output (ptxas register / shared-memory report) of the build
    made in this process, empty when the library was already built."""
    return _Library.build_log


def _check(lib, rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.gsw_error_string(rc).decode()} ({rc})")


def _require(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device} are not supported "
                         "(CPU takes the plain version, CUDA the kernel)")
    return t.device


# --------------------------------------------------------------------- #
# emit
# --------------------------------------------------------------------- #

def _box_max_power(mx, my, A, B, C, tx, ty, tile: int):
    """Exact max of the splat exponent over tile (tx, ty)'s pixel box
    (plain version of emit.cu:box_max_power, same f32 operation order)."""
    tpx = (tx * tile).to(torch.float32)
    tpy = (ty * tile).to(torch.float32)
    dx0 = tpx - mx
    dx1 = tpx + float(tile - 1) - mx
    dy0 = tpy - my
    dy1 = tpy + float(tile - 1) - my
    inside = (dx0 <= 0.0) & (dx1 >= 0.0) & (dy0 <= 0.0) & (dy1 >= 0.0)
    As = A.clamp_min(1e-12)
    Cs = C.clamp_min(1e-12)

    def q(ddx, ddy):
        return -0.5 * (A * ddx * ddx + C * ddy * ddy) - B * ddx * ddy

    ex0 = q(dx0, torch.clamp(-B * dx0 / Cs, dy0, dy1))
    ex1 = q(dx1, torch.clamp(-B * dx1 / Cs, dy0, dy1))
    ey0 = q(torch.clamp(-B * dy0 / As, dx0, dx1), dy0)
    ey1 = q(torch.clamp(-B * dy1 / As, dx0, dx1), dy1)
    pw = torch.maximum(torch.maximum(ex0, ex1), torch.maximum(ey0, ey1))
    return torch.where(inside, torch.zeros_like(pw), pw)


def emit_owner_reference(ends, E: int):
    """The slot-to-owner search of the emit kernel in plain PyTorch:
    ``ends`` (F, N) int32 holds, per frame, the inclusive running sum over
    Gaussian ids of the kept entry counts, so Gaussian g owns slots
    [ends[g-1], ends[g]).  -> (F, E) int64, the owner of every slot: the
    first g with ``ends[g] > slot``, which skips Gaussians without entries
    (they share their end with their predecessor); N for the slots at or
    past the frame's total ``ends[:, -1]``."""
    F = ends.shape[0]
    slots = torch.arange(E, device=ends.device, dtype=ends.dtype)
    return torch.searchsorted(ends.contiguous(),
                              slots.expand(F, E).contiguous(), right=True)


def emit_slots(ends, rect, mean2d, conic, opacity, *, E: int, tile: int):
    """Every kept slot of the emit stage, enumerated in plain PyTorch:
    (frame, slot, cull score, (tile x, tile y, flat Gaussian index)), in
    (frame, slot) order.  The cull score is ``box max power +
    log(opacity)``; the alpha cull keeps a slot when it is >=
    LOG_ALPHA_MIN, so ``score - LOG_ALPHA_MIN`` tells borderline entries
    apart when kernel and plain version disagree."""
    N = ends.shape[1]
    owner = emit_owner_reference(ends, E)
    f, slot = torch.nonzero(owner < N, as_tuple=True)
    g = owner[f, slot]
    first = torch.where(g > 0, ends[f, (g - 1).clamp_min(0)].long(),
                        torch.zeros_like(g))
    d = slot - first
    gi = f * N + g
    r = rect.reshape(-1, 4)[gi].long()
    w = (r[:, 2] - r[:, 0]).clamp_min(1)
    dy = d // w
    tx, ty = r[:, 0] + d - dy * w, r[:, 1] + dy
    m = mean2d.reshape(-1, 2)[gi]
    c = conic.reshape(-1, 3)[gi]
    pw = _box_max_power(m[:, 0], m[:, 1], c[:, 0], c[:, 1], c[:, 2],
                        tx, ty, tile)
    lop = torch.log(opacity.reshape(-1)[gi].clamp_min(1e-12))
    return f, slot, pw + lop, (tx, ty, gi)


def emit_entries_reference(ends, rect, mean2d, conic, opacity, depth, *,
                           E: int, gx: int, T: int, tile: int,
                           cull_alpha: bool):
    """Plain PyTorch version of the emit kernel (same inputs/outputs as
    :func:`emit_entries`)."""
    F, N = ends.shape
    dev = ends.device
    f, slot, score, (tx, ty, gi) = emit_slots(
        ends, rect, mean2d, conic, opacity, E=E, tile=tile)
    tile_id = ty * gx + tx
    if cull_alpha:
        tile_id = torch.where(score >= LOG_ALPHA_MIN, tile_id,
                              torch.full_like(tile_id, T))
    dbits = depth.reshape(-1)[gi].contiguous().view(torch.int32).long()
    key = ((f * (T + 1) + tile_id) << 32) | dbits
    fr = torch.arange(F, device=dev, dtype=torch.int64)
    keys = (((fr * (T + 1) + T) << 32) | 0x7F800000)[:, None].expand(
        F, E).contiguous()
    gid = torch.full((F, E), -1, dtype=torch.int32, device=dev)
    flat = f * E + slot
    keys.view(-1)[flat] = key
    gid.view(-1)[flat] = (gi - f * N).to(torch.int32)
    return keys, gid


def emit_entries_launcher(ends, rect, mean2d, conic, opacity, depth, *,
                          E: int, gx: int, T: int, tile: int,
                          cull_alpha: bool, lib=None):
    """Check the CUDA inputs of :func:`emit_entries`, build the kernels if
    need be and allocate the outputs -> (launch, keys, gid).  ``launch()``
    queues the emit kernel on the current stream, writing ``keys`` and
    ``gid``, and counts one launch; it does nothing else, so a timer can
    queue it many times back to back.  ``lib`` is another build of
    csrc/emit.cu to launch from (the instrumented one of
    tools/emit_times.py)."""
    dev = _cuda_device(ends, "emit_entries")
    F, N = ends.shape
    i32, f32 = torch.int32, torch.float32
    for name, t, dt, shp in (
            ("ends", ends, i32, (F, N)), ("rect", rect, i32, (F, N, 4)),
            ("mean2d", mean2d, f32, (F, N, 2)),
            ("conic", conic, f32, (F, N, 3)),
            ("opacity", opacity, f32, (F, N)), ("depth", depth, f32, (F, N))):
        _require(t, name, dt, shp, dev)
    if F * (T + 1) >= 2 ** 31:
        raise ValueError("frame/tile key does not fit 32 bits")
    if gx >= 2 ** 16 or T >= gx * 2 ** 15:
        raise ValueError("tile coordinates do not fit 16 bits")
    if E >= 2 ** 30:
        raise ValueError("slot indices do not fit the kernel's int32")
    if rect.data_ptr() % 16 or mean2d.data_ptr() % 8:
        raise ValueError("rect and mean2d must start on 16 and 8 bytes")
    lib = lib or build_kernels()
    with torch.cuda.device(dev):
        keys = torch.empty((F, E), dtype=torch.int64, device=dev)
        gid = torch.empty((F, E), dtype=i32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
    args = (ends.data_ptr(), rect.data_ptr(), mean2d.data_ptr(),
            conic.data_ptr(), opacity.data_ptr(), depth.data_ptr(),
            keys.data_ptr(), gid.data_ptr(), F, N, E, gx, T, tile,
            int(cull_alpha), LOG_ALPHA_MIN, stream)

    def launch():
        with torch.cuda.device(dev):     # the stream's device is current
            _check(lib, lib.gsw_emit_entries(*args), "emit_entries")
        launch_counts["emit_entries"] += 1

    return launch, keys, gid


def emit_entries(ends, rect, mean2d, conic, opacity, depth, *, E: int,
                 gx: int, T: int, tile: int, cull_alpha: bool):
    """Expand Gaussians into per-(tile, Gaussian) entries, slots laid out
    in Gaussian order.

    Args (F frames, N Gaussians): ``ends`` (F, N) int32, the inclusive
    running sum over Gaussian ids of the entry counts the budget kept
    (Gaussian g owns slots [ends[g-1], ends[g]), row-major over its tile
    rect; ``ends[:, -1] <= E`` is the frame's total); ``rect`` (F, N, 4)
    int32; ``mean2d`` (F, N, 2), ``conic`` (F, N, 3), ``opacity``/``depth``
    (F, N) f32.
    Returns ``keys`` (F, E) int64 = ((f (T+1) + tile) << 32) | depth bits
    (tile = T for culled and unused slots) and ``gid`` (F, E) int32
    (-1 in unused slots)."""
    kw = dict(E=E, gx=gx, T=T, tile=tile, cull_alpha=cull_alpha)
    if ends.device.type == "cpu":
        return emit_entries_reference(ends, rect, mean2d, conic, opacity,
                                      depth, **kw)
    launch, keys, gid = emit_entries_launcher(ends, rect, mean2d, conic,
                                              opacity, depth, **kw)
    launch()
    return keys, gid


# --------------------------------------------------------------------- #
# composite
# --------------------------------------------------------------------- #

def _tiles_to_image(x, F, gy, gx, tile, H, W):
    """(F, T, P, ...) per-tile pixels -> (F, H, W, ...)."""
    rest = x.shape[3:]
    x = x.reshape((F, gy, gx, tile, tile) + rest)
    x = x.permute((0, 1, 3, 2, 4) + tuple(range(5, 5 + len(rest))))
    return x.reshape((F, gy * tile, gx * tile) + rest)[:, :H, :W]


def _image_to_tiles(x, gy, gx, tile):
    """(F, H, W, ...) -> (F, T, P, ...) per-tile pixels, zero beyond the
    image (inverse of :func:`_tiles_to_image`)."""
    F, H, W = x.shape[:3]
    rest = x.shape[3:]
    pad = x.new_zeros((F, gy * tile, gx * tile) + rest)
    pad[:, :H, :W] = x
    pad = pad.reshape((F, gy, tile, gx, tile) + rest)
    pad = pad.permute((0, 1, 3, 2, 4) + tuple(range(5, 5 + len(rest))))
    return pad.reshape((F, gy * gx, tile * tile) + rest)


# The two plain compositors (forward and backward) share these steps, so
# that both rebuild the same transmittance sequence from the same
# operations.

def _tile_pixels(T, gx, tile, width, height, dev, dtype):
    """Pixel coordinates (1, T, P, 1) of every tile and the (T, P) mask of
    pixels beyond the image."""
    P = tile * tile
    lp = torch.arange(P, device=dev)
    tid = torch.arange(T, device=dev)
    pxi = (tid % gx)[:, None] * tile + (lp % tile)[None, :]      # (T, P)
    pyi = (tid // gx)[:, None] * tile + (lp // tile)[None, :]
    return (pxi.to(dtype)[None, :, :, None], pyi.to(dtype)[None, :, :, None],
            (pxi >= width) | (pyi >= height))


def _chunk_splats(c0, s, e, gaussian, m2, cn, op_all, px, py):
    """Entries [s + c0, s + c0 + PLAIN_CHUNK) of every tile against every
    pixel of the tile.  Returns the flat entry index (F, T, C), its
    in-segment mask, the flat Gaussian index and the per-(pixel, entry)
    terms (F, T, P, C) of the blend."""
    F = s.shape[0]
    N = op_all.shape[0] // F
    ar = torch.arange(PLAIN_CHUNK, device=s.device)
    j = s[..., None] + c0 + ar                                    # (F,T,C)
    inseg = j < e[..., None]
    jj = torch.where(inseg, j, torch.zeros_like(j))
    g = torch.gather(gaussian.long(), 1, jj.reshape(F, -1)).reshape(jj.shape)
    g = torch.where(inseg, g, torch.zeros_like(g))
    gi = (torch.arange(F, device=s.device) * N)[:, None, None] + g
    mx, my = m2[gi, 0][:, :, None], m2[gi, 1][:, :, None]        # (F,T,1,C)
    A, B, C = (cn[gi, k][:, :, None] for k in range(3))
    op = op_all[gi][:, :, None]
    dx = mx - px
    dy = my - py
    power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    G = torch.exp(power)
    alpha = torch.clamp_max(op * G, ALPHA_MAX)
    contrib = inseg[:, :, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    a = torch.where(contrib, alpha, torch.zeros_like(alpha))
    return j, inseg, gi, dict(dx=dx, dy=dy, A=A, B=B, C=C, power=power, G=G,
                              alpha=alpha, contrib=contrib, a=a)


def _transmit(Tr, done, a):
    """One chunk of the front-to-back transmittance walk: T before each
    entry, the stop mask (pixel done before or at the entry), and the walk
    state (T, done) after the chunk."""
    T_incl = Tr[..., None] * torch.cumprod(1.0 - a, dim=-1)
    stop = (T_incl < T_EPS) | done[..., None]                    # (F,T,P,C)
    T_excl = torch.cat([Tr[..., None], T_incl[..., :-1]], dim=-1)
    Tr = torch.where(stop, Tr[..., None].expand_as(T_incl),
                     T_incl).min(dim=-1).values
    return T_excl, stop, Tr, stop.any(dim=-1)


def composite_tiles_reference(starts, gaussian, mean2d, conic, opacity,
                              color, semantics, *, width: int, height: int,
                              tile: int, bg):
    """Plain PyTorch version of the compositor (same inputs/outputs as
    :func:`composite_tiles`): entries in chunks of PLAIN_CHUNK, vectorised
    over all tiles and pixels; transmittance by cumulative product.  Works
    in the dtype of ``mean2d`` (f64 for gradient checks)."""
    F, N = opacity.shape
    T = starts.shape[1] - 1
    gx = -(-width // tile)
    gy = -(-height // tile)
    dev, dt = mean2d.device, mean2d.dtype
    P = tile * tile
    px, py, outside = _tile_pixels(T, gx, tile, width, height, dev, dt)

    s = starts[:, :T].long()
    e = starts[:, 1:].long()
    Tr = torch.ones((F, T, P), dtype=dt, device=dev)
    acc = torch.zeros((F, T, P, 3), dtype=dt, device=dev)
    best_w = torch.zeros((F, T, P), dtype=dt, device=dev)
    best_sem = torch.full((F, T, P), -1, dtype=torch.int64, device=dev)
    done = outside[None].expand(F, T, P).clone()
    m2 = mean2d.reshape(F * N, 2)
    cn = conic.reshape(F * N, 3)
    op_all = opacity.reshape(F * N)
    col_all = color.reshape(F * N, 3).clamp(0.0, COLOR_MAX)
    maxlen = int((e - s).max()) if T > 0 else 0
    for c0 in range(0, maxlen, PLAIN_CHUNK):
        _, _, gi, sp = _chunk_splats(c0, s, e, gaussian, m2, cn, op_all,
                                     px, py)
        T_excl, stop, Tr_next, done = _transmit(Tr, done, sp["a"])
        a = sp["a"]
        w = torch.where(stop, torch.zeros_like(a), a * T_excl)
        acc = acc + torch.einsum("ftpc,ftck->ftpk", w, col_all[gi])
        if semantics is not None:
            g = gi - (torch.arange(F, device=dev) * N)[:, None, None]
            sem = semantics.long()[g][:, :, None, :].expand_as(w)
            wmax = w.max(dim=-1).values
            cand = torch.where((w == wmax[..., None]) & (w > 0), sem,
                               torch.full_like(sem, -2 ** 62)
                               ).max(dim=-1).values
            take = (wmax > best_w) | ((wmax == best_w) & (cand > best_sem))
            best_w = torch.where(take, wmax, best_w)
            best_sem = torch.where(take, cand, best_sem)
        Tr = Tr_next
        if bool(done.all()):
            break
    bg_t = torch.as_tensor(bg, dtype=dt, device=dev)
    rgb = acc + Tr[..., None] * bg_t
    img = _tiles_to_image(rgb, F, gy, gx, tile, height, width)
    T_img = _tiles_to_image(Tr, F, gy, gx, tile, height, width)
    seg = None
    if semantics is not None:
        seg = torch.where(best_w > T_EPS, best_sem, torch.full_like(
            best_sem, -1)).to(torch.int32)
        seg = _tiles_to_image(seg, F, gy, gx, tile, height, width)
    return img.contiguous(), T_img.contiguous(), (
        seg.contiguous() if seg is not None else None)


def walk_counts(starts, gaussian, mean2d, conic, opacity, *, width: int,
                height: int, tile: int):
    """What the front-to-back walk of the compositors does per pixel, in
    the plain compositor's own chunk steps: ``walked`` entries of the
    pixel's tile tested, up to and including the one where the pixel
    stops (or to the tile's end); ``exps`` of them with power <= 0 (an
    exp evaluated); ``blended`` of them that pass the alpha test before
    the stop (the forward's blend, the backward's gradient terms).
    Returns a dict of (F, H, W) int64 tensors.  The work of both
    compositor kernels on these inputs, for their bounds."""
    F, N = opacity.shape
    T = starts.shape[1] - 1
    gx = -(-width // tile)
    gy = -(-height // tile)
    dev, dt = mean2d.device, mean2d.dtype
    P = tile * tile
    px, py, outside = _tile_pixels(T, gx, tile, width, height, dev, dt)
    s = starts[:, :T].long()
    e = starts[:, 1:].long()
    Tr = torch.ones((F, T, P), dtype=dt, device=dev)
    done = outside[None].expand(F, T, P).clone()
    m2 = mean2d.reshape(F * N, 2)
    cn = conic.reshape(F * N, 3)
    op_all = opacity.reshape(F * N)
    counts = {k: torch.zeros((F, T, P), dtype=torch.int64, device=dev)
              for k in ("walked", "exps", "blended")}
    maxlen = int((e - s).max()) if T > 0 else 0
    for c0 in range(0, maxlen, PLAIN_CHUNK):
        _, inseg, _, sp = _chunk_splats(c0, s, e, gaussian, m2, cn, op_all,
                                        px, py)
        _, stop, Tr_next, done_next = _transmit(Tr, done, sp["a"])
        stopped_before = torch.cat([done[..., None], stop[..., :-1]], dim=-1)
        tested = inseg[:, :, None, :] & ~stopped_before
        counts["walked"] += tested.sum(dim=-1)
        counts["exps"] += (tested & (sp["power"] <= 0.0)).sum(dim=-1)
        counts["blended"] += (sp["contrib"] & ~stop).sum(dim=-1)
        Tr, done = Tr_next, done_next
        if bool(done.all()):
            break
    return {k: _tiles_to_image(v, F, gy, gx, tile, height, width).contiguous()
            for k, v in counts.items()}


RECORD_FIELDS = 12  # per sorted entry: mx, my, A, B, C, opacity, r, g, b
#                    (clamped to [0, COLOR_MAX]), the semantic id's bits
#                    (-1 without semantics), log(max(opacity, 1e-12)) for
#                    the cull, a zero pad: 48 bytes
SUB_TILE = 16       # the kernels' sub-tile side (csrc/composite_common.cuh)
CULL_ABS = 1e-3     # their cull margin, in log alpha: absolute part
CULL_REL = 4e-6     # and the part relative to the exponent's terms


def pack_records_reference(starts, gaussian, mean2d, conic, opacity, color,
                           semantics):
    """Plain PyTorch version of the compositors' record gather: (F, E,
    RECORD_FIELDS) f32, the records of entries [0, starts[f, T]) of each
    frame in sorted order, zero beyond."""
    F, N = opacity.shape
    E = gaussian.shape[1]
    dev = mean2d.device
    live = torch.arange(E, device=dev)[None, :] < starts[:, -1:].long()
    g = torch.where(live, gaussian.long(), torch.zeros_like(gaussian.long()))
    gi = ((torch.arange(F, device=dev) * N)[:, None] + g).reshape(-1)
    sem = (semantics.to(torch.int32)[g.reshape(-1)] if semantics is not None
           else torch.full((F * E,), -1, dtype=torch.int32, device=dev))
    rec = torch.cat([
        mean2d.reshape(-1, 2)[gi], conic.reshape(-1, 3)[gi],
        opacity.reshape(-1, 1)[gi],
        color.reshape(-1, 3)[gi].clamp(0.0, COLOR_MAX),
        sem.view(torch.float32)[:, None],
        torch.log(opacity.reshape(-1, 1)[gi].clamp_min(1e-12)),
        torch.zeros((F * E, 1), dtype=torch.float32, device=dev)], dim=1)
    return torch.where(live.reshape(-1, 1), rec,
                       torch.zeros_like(rec)).reshape(F, E, RECORD_FIELDS)


def subtile_keep_reference(rec, x0, x1, y0, y1):
    """Plain PyTorch copy of the kernels' sub-tile cull
    (composite_common.cuh:subtile_keep), in its f32 order: whether each
    record (..., RECORD_FIELDS) may reach alpha >= 1/255 at some pixel of
    the box [x0, x1] x [y0, y1] (broadcast against the records).  False
    only when no pixel of the box accepts it."""
    mx, my, A, B, C = rec[..., :5].unbind(-1)
    lop = rec[..., 10]
    f32 = dict(dtype=torch.float32, device=rec.device)
    x0, x1, y0, y1 = (torch.as_tensor(v, **f32) for v in (x0, x1, y0, y1))
    bounded = (A > 0.0) & (C > 0.0) & (A * C - B * B > 0.0)
    dx0, dx1, dy0, dy1 = x0 - mx, x1 - mx, y0 - my, y1 - my
    inside = (dx0 <= 0.0) & (dx1 >= 0.0) & (dy0 <= 0.0) & (dy1 >= 0.0)

    def q(ddx, ddy):
        return -0.5 * (A * ddx * ddx + C * ddy * ddy) - B * ddx * ddy

    iA, iC = 1.0 / A, 1.0 / C
    ex0 = q(dx0, torch.minimum(torch.maximum(-B * dx0 * iC, dy0), dy1))
    ex1 = q(dx1, torch.minimum(torch.maximum(-B * dx1 * iC, dy0), dy1))
    ey0 = q(torch.minimum(torch.maximum(-B * dy0 * iA, dx0), dx1), dy0)
    ey1 = q(torch.minimum(torch.maximum(-B * dy1 * iA, dx0), dx1), dy1)
    pmax = torch.where(inside, torch.zeros_like(ex0), torch.maximum(
        torch.maximum(ex0, ex1), torch.maximum(ey0, ey1)))
    ax = torch.maximum(dx0.abs(), dx1.abs())
    ay = torch.maximum(dy0.abs(), dy1.abs())
    M = A * ax * ax + C * ay * ay + 2.0 * B.abs() * ax * ay
    culled = pmax + lop < LOG_ALPHA_MIN - (CULL_ABS + CULL_REL * M)
    return ~bounded | ~culled


def composite_tiles(starts, gaussian, mean2d, conic, opacity, color,
                    semantics, *, width: int, height: int, tile: int, bg):
    """Front-to-back alpha compositing of the sorted entry stream.

    Args: ``starts`` (F, T+1) int32 per-tile segment starts into
    ``gaussian`` (F, E) int32 sorted entries' Gaussian ids; ``mean2d``
    (F, N, 2), ``conic`` (F, N, 3), ``opacity`` (F, N), ``color`` (F, N, 3)
    f32; ``semantics`` (N,) int32 or None.
    Returns (img (F, H, W, 3), T (F, H, W), seg (F, H, W) int32 or None,
    records (F, E, RECORD_FIELDS)): the sorted entries' records that the
    kernel walked, which :func:`composite_bwd` takes to read the same
    rows."""
    if mean2d.device.type == "cpu":
        return composite_tiles_reference(
            starts, gaussian, mean2d, conic, opacity, color, semantics,
            width=width, height=height, tile=tile, bg=bg) + (
                pack_records_reference(starts, gaussian, mean2d, conic,
                                       opacity, color, semantics),)
    dev = _cuda_device(mean2d, "composite_tiles")
    with torch.cuda.device(dev):     # the stream's device is current
        F, N = opacity.shape
        T = starts.shape[1] - 1
        E = gaussian.shape[1]
        gx = -(-width // tile)
        if T != gx * (-(-height // tile)):
            raise ValueError(f"starts has {T} tiles, expected "
                             f"{gx * (-(-height // tile))}")
        i32, f32 = torch.int32, torch.float32
        for name, t, dt, shp in (
                ("starts", starts, i32, (F, T + 1)),
                ("gaussian", gaussian, i32, (F, E)),
                ("mean2d", mean2d, f32, (F, N, 2)),
                ("conic", conic, f32, (F, N, 3)),
                ("opacity", opacity, f32, (F, N)),
                ("color", color, f32, (F, N, 3))):
            _require(t, name, dt, shp, dev)
        if semantics is not None:
            _require(semantics, "semantics", i32, (N,), dev)
        lib = build_kernels()
        rec = torch.empty((F, E, RECORD_FIELDS), dtype=f32, device=dev)
        img = torch.empty((F, height, width, 3), dtype=f32, device=dev)
        T_img = torch.empty((F, height, width), dtype=f32, device=dev)
        seg = (torch.empty((F, height, width), dtype=i32, device=dev)
               if semantics is not None else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsw_composite_tiles(
            starts.data_ptr(), gaussian.data_ptr(), mean2d.data_ptr(),
            conic.data_ptr(), opacity.data_ptr(), color.data_ptr(),
            semantics.data_ptr() if semantics is not None else None,
            rec.data_ptr(), img.data_ptr(), T_img.data_ptr(),
            seg.data_ptr() if seg is not None else None,
            F, N, E, T, gx, tile, width, height,
            float(bg[0]), float(bg[1]), float(bg[2]), COLOR_MAX, LOG_ALPHA_MIN,
            stream)
        _check(lib, rc, "composite_tiles")
        launch_counts["composite_tiles"] += 1
        return img, T_img, seg, rec


# --------------------------------------------------------------------- #
# composite backward
# --------------------------------------------------------------------- #

BWD_FIELDS = 9  # per-entry row: d mean2d (2), d conic (3), d colour (3),
#                 d opacity (1), as the JAX backward records


def composite_bwd_reference(starts, gaussian, mean2d, conic, opacity, color,
                            img, T_img, img_ct, T_ct, *, width: int,
                            height: int, tile: int):
    """Plain PyTorch version of the compositor backward (same inputs and
    output as :func:`composite_bwd`), in the dtype of ``mean2d``.

    Walks the entries in PLAIN_CHUNK steps exactly as
    :func:`composite_tiles_reference` does, so the transmittance sequence
    and the stop mask are the forward's.  Per (pixel, entry), with the
    pixel's RGB cotangent g and r = g . c (colour clamped as the forward
    reads it):
        w    = alpha T_excl                       (0 once stopped)
        s    = S_total - prefix(w r),  S_total = g . rgb_out + T_fin tct
        ebar = T_excl r - s / (1 - alpha)         (live contributors only)
    and the entry's row sums over its tile's pixels:
        d colour  = sum w g
        d opacity = sum ebar e^power                [alpha < 0.99]
        q = ebar alpha [alpha < 0.99] is the cotangent of power, which
        gives d mean2d = -sum q (A dx + B dy, C dy + B dx) and
        d conic = -sum q (dx^2 / 2, dx dy, dy^2 / 2).
    The colour gradient passes the [0, COLOR_MAX] clamp straight through,
    as the JAX backward does; the two differ only for colours above the
    clamp."""
    F, N = opacity.shape
    T = starts.shape[1] - 1
    E = gaussian.shape[1]
    gx = -(-width // tile)
    gy = -(-height // tile)
    dev, dt = mean2d.device, mean2d.dtype
    P = tile * tile
    px, py, outside = _tile_pixels(T, gx, tile, width, height, dev, dt)
    gct = _image_to_tiles(img_ct, gy, gx, tile)                  # (F,T,P,3)
    tct = _image_to_tiles(T_ct, gy, gx, tile)                    # (F,T,P)
    S_total = ((gct * _image_to_tiles(img, gy, gx, tile)).sum(dim=-1)
               + _image_to_tiles(T_img, gy, gx, tile) * tct)

    s = starts[:, :T].long()
    e = starts[:, 1:].long()
    Tr = torch.ones((F, T, P), dtype=dt, device=dev)
    pref = torch.zeros((F, T, P), dtype=dt, device=dev)
    done = outside[None].expand(F, T, P).clone()
    m2 = mean2d.reshape(F * N, 2)
    cn = conic.reshape(F * N, 3)
    op_all = opacity.reshape(F * N)
    col_all = color.reshape(F * N, 3).clamp(0.0, COLOR_MAX)
    out = torch.zeros((F * E, BWD_FIELDS), dtype=dt, device=dev)
    fE = (torch.arange(F, device=dev) * E)[:, None, None]
    maxlen = int((e - s).max()) if T > 0 else 0
    for c0 in range(0, maxlen, PLAIN_CHUNK):
        j, inseg, gi, sp = _chunk_splats(c0, s, e, gaussian, m2, cn, op_all,
                                         px, py)
        a, alpha = sp["a"], sp["alpha"]
        T_excl, stop, Tr, done = _transmit(Tr, done, a)
        live = sp["contrib"] & ~stop
        zero = torch.zeros_like(a)
        w = torch.where(live, a * T_excl, zero)
        r = torch.einsum("ftpk,ftck->ftpc", gct, col_all[gi])
        pre = pref[..., None] + torch.cumsum(w * r, dim=-1)
        ebar = torch.where(live, T_excl * r - (S_total[..., None] - pre)
                           / (1.0 - a), zero)
        unclamped = alpha < ALPHA_MAX
        q = torch.where(unclamped, ebar * alpha, zero)
        dx, dy = sp["dx"], sp["dy"]
        A, B, C = sp["A"], sp["B"], sp["C"]
        rows = torch.cat([
            torch.stack([
                -(q * (A * dx + B * dy)).sum(dim=2),
                -(q * (C * dy + B * dx)).sum(dim=2),
                -0.5 * (q * dx * dx).sum(dim=2),
                -(q * dx * dy).sum(dim=2),
                -0.5 * (q * dy * dy).sum(dim=2)], dim=-1),
            torch.einsum("ftpc,ftpk->ftck", w, gct),
            torch.where(unclamped, ebar * sp["G"], zero).sum(dim=2)[..., None],
        ], dim=-1)                                              # (F,T,C,9)
        out[(fE + j)[inseg]] = rows[inseg]
        pref = pre[..., -1]
        if bool(done.all()):
            break
    return out.reshape(F, E, BWD_FIELDS)


def composite_bwd(starts, gaussian, mean2d, conic, opacity, color, img,
                  T_img, img_ct, T_ct, *, width: int, height: int, tile: int,
                  records):
    """Gradients of the compositor per sorted entry.

    Args: the compositor's inputs (``starts`` (F, T+1) int32, ``gaussian``
    (F, E) int32, ``mean2d`` (F, N, 2), ``conic`` (F, N, 3), ``opacity``
    (F, N), ``color`` (F, N, 3)), its outputs ``img`` (F, H, W, 3) and
    ``T_img`` (F, H, W), and their cotangents ``img_ct``, ``T_ct`` of the
    same shapes; ``records``, the fourth output of :func:`composite_tiles`
    (the kernel reads the entries from them; the plain version ignores
    them).
    Returns (F, E, 9) rows [d mean2d (2), d conic (3), d colour (3),
    d opacity] per sorted entry, zero beyond the live segments; the
    per-Gaussian gradient is their sum per Gaussian
    (:func:`sum_entry_rows`).  On the card each of a tile's S sub-tile
    blocks writes its part of an entry's row into a part of its own, and
    the parts are added here in the order 0 .. S-1: the same inputs give
    the same bits every time."""
    if mean2d.device.type == "cpu":
        return composite_bwd_reference(
            starts, gaussian, mean2d, conic, opacity, color, img, T_img,
            img_ct, T_ct, width=width, height=height, tile=tile)
    dev = _cuda_device(mean2d, "composite_bwd")
    with torch.cuda.device(dev):     # the stream's device is current
        F, N = opacity.shape
        T = starts.shape[1] - 1
        E = gaussian.shape[1]
        gx = -(-width // tile)
        if T != gx * (-(-height // tile)):
            raise ValueError(f"starts has {T} tiles, expected "
                             f"{gx * (-(-height // tile))}")
        i32, f32 = torch.int32, torch.float32
        for name, t, dt, shp in (
                ("starts", starts, i32, (F, T + 1)),
                ("gaussian", gaussian, i32, (F, E)),
                ("mean2d", mean2d, f32, (F, N, 2)),
                ("conic", conic, f32, (F, N, 3)),
                ("opacity", opacity, f32, (F, N)),
                ("color", color, f32, (F, N, 3)),
                ("img", img, f32, (F, height, width, 3)),
                ("T_img", T_img, f32, (F, height, width)),
                ("img_ct", img_ct, f32, (F, height, width, 3)),
                ("T_ct", T_ct, f32, (F, height, width))):
            _require(t, name, dt, shp, dev)
        _require(records, "records", f32, (F, E, RECORD_FIELDS), dev)
        lib = build_kernels()
        S = lib.gsw_composite_bwd_parts(tile)     # sub-tiles per tile
        parts = torch.zeros((F, S, E, BWD_FIELDS), dtype=f32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsw_composite_bwd(
            starts.data_ptr(), records.data_ptr(), img.data_ptr(),
            T_img.data_ptr(), img_ct.data_ptr(), T_ct.data_ptr(),
            parts.data_ptr(), F, E, S, T, gx, tile, width, height,
            LOG_ALPHA_MIN, stream)
        _check(lib, rc, "composite_bwd")
        launch_counts["composite_bwd"] += 1
        out = parts[:, 0]
        for q in range(1, S):
            out = out + parts[:, q]
        return out.contiguous()


# --------------------------------------------------------------------- #
# per-Gaussian sum of the entry rows
# --------------------------------------------------------------------- #

def sum_entry_rows_reference(rows, perm, ends):
    """Plain PyTorch version of :func:`sum_entry_rows` (same inputs and
    output), adding in the kernel's order: the rows are gathered to slot
    order, then step k < the largest count adds each Gaussian's k-th
    slot's row (+0.0 past its count, which changes no sum)."""
    F, E, K = rows.shape
    N = ends.shape[1]
    dev = rows.device
    pos = torch.empty((F * E,), dtype=torch.int64, device=dev)
    pos[perm.reshape(-1)] = torch.arange(F * E, device=dev)
    slot_rows = rows.reshape(F * E, K)[pos].reshape(F, E, K)
    ends = ends.long()
    first = torch.nn.functional.pad(ends[:, :-1], (1, 0))
    cnt = ends - first
    acc = torch.zeros((F, N, K), dtype=rows.dtype, device=dev)
    zero = torch.zeros((), dtype=rows.dtype, device=dev)
    for k in range(int(cnt.max()) if cnt.numel() else 0):
        idx = (first + k).clamp_max(E - 1)
        r = torch.gather(slot_rows, 1, idx[..., None].expand(F, N, K))
        acc = acc + torch.where((k < cnt)[..., None], r, zero)
    return acc


def sum_entry_rows(rows, perm, ends):
    """Per-Gaussian sums (F, N, K) of the per-entry rows ``rows`` (F, E, K)
    f32 at sorted positions, in a fixed order: Gaussian g adds the rows of
    its slots ``ends[g-1] .. ends[g] - 1`` in slot order, each read at its
    sorted position.  ``perm`` (F, E) int64 is the key sort's permutation
    (sorted position -> f * E + slot) and ``ends`` (F, N) int32 the
    inclusive slot ends (both from ``EntryBins``).  The same inputs give
    the same bits every time, as the JAX package's scatter-add does; an
    ``index_add_`` on the card adds in no fixed order.  On the card one
    launch of csrc/entry_rows.cu; on the CPU the plain version."""
    if rows.device.type == "cpu":
        return sum_entry_rows_reference(rows, perm, ends)
    dev = _cuda_device(rows, "sum_entry_rows")
    with torch.cuda.device(dev):     # the stream's device is current
        F, E, K = rows.shape
        N = ends.shape[1]
        if K != BWD_FIELDS:
            raise ValueError(f"rows have {K} fields, expected {BWD_FIELDS}")
        _require(rows, "rows", torch.float32, (F, E, K), dev)
        _require(perm, "perm", torch.int64, (F, E), dev)
        _require(ends, "ends", torch.int32, (F, N), dev)
        if E >= 2 ** 31:
            raise ValueError("slot indices do not fit the kernel's int32")
        lib = build_kernels()
        pos = torch.empty((F, E), dtype=torch.int32, device=dev)
        out = torch.empty((F, N, K), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsw_sum_entry_rows(rows.data_ptr(), perm.data_ptr(),
                                    ends.data_ptr(), pos.data_ptr(),
                                    out.data_ptr(), F, N, E, stream)
        _check(lib, rc, "sum_entry_rows")
        launch_counts["sum_entry_rows"] += 1
        return out
