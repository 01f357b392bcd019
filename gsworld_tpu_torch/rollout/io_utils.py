"""Episode IO: recursive HDF5 (de)serialization, video/frame export (port
of gsworld_tpu/rollout/io_utils.py).

``h5py`` and ``PIL`` are imported inside the functions that use them: a
machine without them can still record videos and JSON.  Frames go to mp4
through the ``ffmpeg`` binary when it is on PATH, else to ``<path>.npz``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Any, Dict

import numpy as np


def dump_dict_to_hdf5(group, data: Dict[str, Any]):
    """Recursively write a nested dict of arrays/scalars to an HDF5 group."""
    for key, value in data.items():
        key = str(key)
        if isinstance(value, dict):
            sub = group.create_group(key)
            dump_dict_to_hdf5(sub, value)
        elif isinstance(value, (np.ndarray, list, tuple)):
            arr = np.asarray(value)
            kw = {}
            if arr.dtype == np.uint8 and arr.ndim >= 3:
                kw = dict(compression="gzip", compression_opts=4)
            group.create_dataset(key, data=arr, **kw)
        elif isinstance(value, (int, float, bool, np.generic)):
            group.attrs[key] = value
        elif isinstance(value, str):
            group.attrs[key] = value
        elif value is None:
            continue
        else:
            group.create_dataset(key, data=np.asarray(value))


def load_hdf5_to_dict(group) -> Dict[str, Any]:
    import h5py
    out: Dict[str, Any] = {}
    for key, value in group.items():
        if isinstance(value, h5py.Group):
            out[key] = load_hdf5_to_dict(value)
        else:
            out[key] = value[()]
    for key, value in group.attrs.items():
        out[key] = value
    return out


def save_dict_to_hdf5(path: str, data: Dict[str, Any]):
    import h5py
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        dump_dict_to_hdf5(f, data)


def load_hdf5(path: str) -> Dict[str, Any]:
    import h5py
    with h5py.File(path, "r") as f:
        return load_hdf5_to_dict(f)


def save_images_to_mp4(frames, path: str, fps: int = 30):
    """(T, H, W, 3) uint8 -> mp4 via the ffmpeg rawvideo pipe.  Falls back
    to <path>.npz without ffmpeg; returns the path written."""
    frames = np.ascontiguousarray(np.asarray(frames, np.uint8))
    t, h, w, _ = frames.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        np.savez_compressed(path + ".npz", frames=frames, fps=fps)
        return path + ".npz"
    cmd = [ffmpeg, "-y", "-loglevel", "error", "-f", "rawvideo",
           "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", str(fps),
           "-i", "-", "-pix_fmt", "yuv420p", "-vcodec", "libx264", path]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
    proc.stdin.write(frames.tobytes())
    proc.stdin.close()
    proc.wait()
    return path


def save_images_to_dir(frames, out_dir: str, prefix: str = "frame"):
    """Dump frames as PNGs."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    for i, fr in enumerate(np.asarray(frames, np.uint8)):
        Image.fromarray(fr).save(os.path.join(out_dir, f"{prefix}_{i:05d}.png"))
    return out_dir


class NumpyEncoder(json.JSONEncoder):
    """JSON of numpy scalars and arrays."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)
