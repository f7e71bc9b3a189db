"""The port's host voxelizer: ``voxelizer.cpp`` (a copy of the JAX
package's, threaded over the batch) loaded with ctypes.

The library is built with ``g++`` at first use into
``agplace_tpu_torch/_build/libvoxelizer.so`` (listed in ``.gitignore``),
written to a process-private temp path and renamed atomically, and rebuilt
when the source is newer.  A missing compiler or a failed build raises:
there is no quiet numpy fallback (``data.voxels.voxelize_plain`` is the
plain version, for the tests).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "voxelizer.cpp")
LIB_PATH = os.path.join(os.path.dirname(_DIR), "_build", "libvoxelizer.so")
CXX = "g++"

_lib: Optional[ctypes.CDLL] = None


def build(lib_path: str = LIB_PATH) -> str:
    """Compile the voxelizer if ``lib_path`` is missing or older than the
    source; returns the path.  Raises RuntimeError when the compiler is
    missing or the build fails."""
    if (os.path.exists(lib_path)
            and os.path.getmtime(lib_path) >= os.path.getmtime(SRC)):
        return lib_path
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the port's host voxelizer is "
                           f"built from {SRC} at first use")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [cxx, "-O3", "-shared", "-fPIC", "-o", tmp, SRC, "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            raise RuntimeError(f"voxelizer build failed ({' '.join(cmd)}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded voxelizer (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        handle.voxelize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
        ]
        handle.voxelize_batch.restype = None
        _lib = handle
    return _lib


def voxelize_batch(points: np.ndarray, quant_size: float, capacity: int,
                   grid_radius: int, n_threads: int = 8):
    """[B, P, 3] float32 (NaN-padded) -> (coords [B, cap, 3] int32, mask
    [B, cap] bool): the lexicographically smallest ``capacity`` unique
    voxel coordinates per cloud, ascending, clamped to the grid."""
    if grid_radius > 512:
        # pack() offsets each coordinate by +512 into 10 bits
        raise ValueError(f"grid_radius {grid_radius} > 512: exceeds the "
                         f"10-bit packed-key range of the voxelizer")
    pts = np.ascontiguousarray(points, dtype=np.float32)
    b, p, _ = pts.shape
    coords = np.empty((b, capacity, 3), np.int32)
    mask = np.empty((b, capacity), np.uint8)
    lib().voxelize_batch(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b, p,
        quant_size, capacity, grid_radius,
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    return coords, mask.astype(bool)
