"""Build and load the port's CUDA kernels (route (b): ``nvcc`` into one
shared library with a plain C interface, loaded with ctypes).

The library is built at first use from ``agplace_tpu_torch/csrc/*.cu`` into
``agplace_tpu_torch/_build/`` (listed in ``.gitignore``): one ``nvcc -c``
per source, all started together, then one link, written to a
process-private temp path and renamed atomically.  It is rebuilt when any
source is newer than it.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libagplace_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every one returns cudaError_t as int)
_SIGNATURES = {
    # batch, n_steps, dt, act, then the 6 fields of ode_step.OdeTiling
    "agp_ode_euler": [_P] * 4 + [_I] * 2 + [_F] + [_I] * 7 + [_P],
    "agp_ode_wide": [_P] * 4 + [_I] * 2 + [_F] + [_I] * 7 + [_P],
    # x, w, b, out, scratch, batch, n_steps, dt, act, then the 5 fields of
    # ode_step.OdeGridTiling
    "agp_ode_grid": [_P] * 5 + [_I] * 2 + [_F] + [_I] * 6 + [_P],
    "agp_ode_grid_resident": [_I] * 3,  # returns a count, not an error
    # z, zo, then the 20 fields of bev_down.Down0Tiling
    "agp_bev_down": [_P] * 9 + [_I] * 22 + [_P],
    # epi, z, then the 17 fields of bev_block_sm.Conv3x3Tiling
    "agp_conv3x3": [_P] * 7 + [_I] * 19 + [_P],
    "agp_block_eca": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    # ..., B, X, Y, Zcin, Zcout, z, gather
    "agp_block_combine_ds": [_P] * 8 + [_I] * 7 + [_P],
    "agp_block_combine_id": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # z, zo, k0, Z*C0, then the 22 fields of bev_head.HeadTiling
    "agp_bev_head": [_P] * 10 + [_I] * 26 + [_P],
    # inst, then the 38 fields of zband.ZbandTiling: the z-banded GEMM of
    # K2, K3 and K4 off their sm90 tiles
    "agp_zband": [_P] * 10 + [_I] * 39 + [_P],
    # conv0 of K4's off-preset instance: the 31 fields of
    # bev_head.Conv0Tiling
    "agp_head_conv0": [_P] * 6 + [_I] * 31 + [_P],
    # B, H, W, C, then the 9 fields of stem_pool.StemPoolTiling
    "agp_stem_pool": [_P] * 4 + [_I] * 13 + [_P],
    "agp_block_bm_conv1": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "agp_block_bm_conv2_pool": [_P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _P],
    "agp_block_bm_eca": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    "agp_block_bm_combine": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "agp_down_concat": [_P] * 12 + [_I] * 7 + [_P],
    # z, zo, then the 18 fields of probe_down_v2.DownConcatTiling
    "agp_down_concat_sm90": [_P] * 12 + [_I] * 20 + [_P],
    # epi, chunk, z, then the 20 fields of probe_block_sm_v2.ConcatConvTiling
    "agp_p1_conv_sm90": [_P] * 7 + [_I] * 23 + [_P],
    "agp_p1_smem_bytes": [_I],  # returns bytes, not an error code
    # x, r, y, scale, bias, scale_d, bias_d, n_vec, cv, fp32, res, then
    # bn_act.bn_act_grid's grid and block
    "agp_bn_act": [_P] * 7 + [_L] + [_I] * 5 + [_P],
    # qkv, out, B, N, H, then the 4 fields of attention.AttentionTiling
    "agp_attention": [_P] * 2 + [_I] * 7 + [_P],
    # x, r, gamma, beta, out, operand, rows, C, eps, keep_sum, then
    # residual_layer_norm.ln_grid's grid and block
    "agp_residual_layer_norm": [_P] * 6 + [_L, _I, _F] + [_I] * 3 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of agplace_tpu_torch "
                       "are built from source with nvcc (CUDA toolkit)")


def _nvcc_cmd(*args: str) -> list:
    """An nvcc command with the port's flags (sm_90a, C++17, -O3, PIC)."""
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
            *args]


def build(force: bool = False) -> str:
    """Compile the kernels if the library is missing or stale; returns its
    path.  Raises RuntimeError when nvcc is missing or the build fails."""
    srcs = _sources()
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= max(map(os.path.getmtime,
                                                      srcs))):
        return LIB_PATH
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    cus = [s for s in srcs if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o")
            for s in cus]
    tmp = f"{LIB_PATH}.{tag}"
    compiles = [_nvcc_cmd("-c", "-Xptxas", "-v", "-o", o, s)
                for s, o in zip(cus, objs)]
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
    try:
        done = _run_all(compiles)
        _run(link)
        with open(os.path.join(BUILD_DIR, "ptxas.log"), "w") as f:
            f.write("".join(done))
        os.replace(tmp, LIB_PATH)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.unlink(path)
    return LIB_PATH


def _run_all(cmds) -> list:
    """Run build commands all at once; their stderr, or raise.
    subprocess.run kills its own nvcc on a timeout."""
    with ThreadPoolExecutor(len(cmds)) as pool:
        return list(pool.map(_run, cmds))


def _run(cmd) -> str:
    """Run one build command; its stderr (ptxas's report), or raise."""
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}\n{res.stderr}")
    return res.stderr


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def call(name: str, *args) -> None:
    """Launch C entry ``name`` on the current stream; raise on a CUDA
    error.  Tensors are passed as device pointers."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(), name)(*conv, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """Dispatch decision of every kernel wrapper: False when all inputs lie
    on the CPU (the plain version runs), True when all lie on one CUDA
    device (the kernel runs).  Anything else raises, as does a CUDA input
    that needs a gradient: the wrappers are forward-only, and K1's
    gradient goes through ``ode_step.euler_ode`` (an autograd Function,
    whose forward runs without grad mode)."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel inputs on mixed or unsupported devices: "
                         f"{sorted(map(str, devs))}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the CUDA kernels are forward-only: call them "
                           "under torch.inference_mode() / no_grad(), or "
                           "K1 through ode_step.euler_ode for a gradient")
    return True


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` dense and 16-byte aligned, for every operand a kernel reads by
    16-byte vectors, ``cp.async``, bulk copies or TMA: ``t`` itself when it
    is, else a copy (a contiguous view at a storage offset that is not a
    multiple of 16 bytes is copied too; ``.contiguous()`` would return it
    as it is)."""
    if t.data_ptr() % 16 == 0:
        return t.contiguous()
    return t.clone(memory_format=torch.contiguous_format)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
