"""Bring-up smoke of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two serving paths (``agplace_tpu_torch.serving.PlaceIndex``
on ``kitti360_config()`` in bf16, full width, seeded random weights), its
evaluation path (``agplace_tpu_torch.evaluate``: Recall@N of a synthetic
world, with the same towers) and its training path
(``agplace_tpu_torch.train.loop.train`` on ``kitti360_config()`` in fp32) on
the card and checks every hand-written kernel of the port:

* the default configuration: K1 (FCODE), K2 (BEV stage 0), K3 (ECA blocks);
* the fused-stem / fused-head configuration (``bev_pallas_head``,
  ``stem_pallas`` and ``db.stem_pallas`` set): K4 replaces K2, and K5 runs
  the stem tail of both ResNet towers;
* ``nuscenes_config()`` with ``bev_pallas_head`` set: K4 at the z = 8
  widths, in one MM forward at the full grid;
* the two probe entry points (``scripts/probe_torch_down_v2.py`` and
  ``scripts/probe_torch_block_sm_v2.py``): P2 against K2 and P1 against K3.
K6 has no path; only its parity is checked.

1. device check (raises without CUDA) and the card's name / power limit;
2. kernel build from ``agplace_tpu_torch/csrc`` (one nvcc per source, in
   parallel, sm_90a), and a check that each wgmma kernel holds ``HGMMA``
   in ``cuobjdump -sass``, by function: K3's and K6's two conv phases
   each, K2's down0 GEMM, K4, P2 and P1's two conv phases at each chunk;
3. [parity] each kernel against its plain PyTorch version on the card at
   its main-path shapes, with CUDA-event timings of both (median of 20):
   K1 at B = 32 and 128 and the ragged 1 and 33, relu and tanh (timed at
   32 and 128, also by the profiler's device time, ``device_ms``: its
   launch is shorter than the host's enqueue); K2, K4 and P2 at [32,128,128,4], K2 also at z = 8 (the
   nuScenes and default configs' widths, Zo*C2 = 256); K2's down0 GEMM
   alone (``down0_gemm``) and K4's kernel alone (``head_gemm``: the output
   mask precomputed) at b32 and b128, K4 alone also at the z = 8 widths
   ([32,128,128,8] -> 256) and the z = 16 widths (``synthetic_config()``:
   [32,32,32,16] -> 512), each against its plain version there (10 calls
   queued per timing), with the GEMM's byte-bound share beside a
   cuDNN yardstick
   (``F.conv2d`` of down0 alone on the activated map, bf16, channels_last,
   stride 2) and K4's TFLOP/s and bound; K3 at its four block shapes at b32
   and b128, each of its two conv phases also against its plain version
   and timed beside a cuDNN yardstick (``F.conv2d``, bf16, channels_last,
   the conv alone; 10 calls queued per timing), with TFLOP/s and share of
   bound; P1 at
   K3's four b32 shapes at chunks 1, 3 and 9 (also by ``device_ms``; its
   two conv phases each against their plain version and timed by
   ``device_ms``); P2 also by ``device_ms``, and its kernel alone
   (``down_concat_gemm`` on precomputed parity planes) at b32 and b128
   against its plain version, beside its byte bound; K5 bit-equal at
   [32,128,128,64] and [128,128,128,64] (timed also by ``device_ms``,
   beside ``F.max_pool2d`` alone on the activated map), an all-negative
   case, a view at storage offset 1, a ragged last band ([32,100,64,64]),
   rows split into column tiles ([1,8,512,64]), C = 8 and (3,14,12,8); K6
   at [32,64,64,128] and [32,16,16,512] (timed also by ``device_ms``; its
   two conv phases on the Hopper kernel each against its plain version,
   timed beside cuDNN's convs), and at Z*C = 64 and 96 (the wmma implicit
   GEMM), zero off the mask.  A bf16 kernel may differ from its plain version
   (isolated ulp flips of the summation order) in at most 1e-3 (K2, K4,
   P2) or 0.15 (K3, K6, P1) of the non-zero outputs; P2 is held to K2 and
   P1 to K3's plain version within the same limits (the same rounding
   points); K4 against K2 (at z = 4 and 8) and K6 against K3's plain
   version, on the same inputs, must differ in more than 0.25 (their
   rounding points differ), so a kernel with the other's rounding fails;
4. [serving] the default path: a 512-tile aerial gallery and three search
   requests (1, 7 and 32 queries, k=5); [serving-fused] the fused path: its
   own 128-tile gallery and three requests.  Each checks shapes, a planted
   top-1 hit, and exact launch counts (reset just before the path, read
   just after it): per MM forward 3 x K1, 4 x K3 and 1 x K2 (default) or
   1 x K4 + 1 x K5 (fused); per aerial-tower forward 1 x K5 per map type
   (fused only).  ``add_tiles`` embeds the gallery in padded batches of
   ``infer_batch_size`` (32): ceil(tiles / 32) tower forwards, and each
   request of <= 32 queries is one MM forward;
5. [slice] / [slice-fused] 4 query embeddings on the card vs the same module
   and weights on the CPU (plain versions); [nuscenes-fused] one MM forward
   of ``nuscenes_config()`` with ``bev_pallas_head`` set at its full 128 x
   128 x 8 grid, batch 2: exact launch counts (K1 x3, K3 x4, K4 x1) and
   the embeddings against the CPU run;
6. [eval] ``evaluate.evaluate`` (hard_resize) on the card with the default
   path's towers: ``SyntheticDataset`` of 512 tiles and 256 queries at
   256 px, clouds of 30,000 points (22,500 real), ``infer_batch_size`` 32,
   so 16 aerial-tower and 8 MM forwards (exact launch counts); recalls
   finite, in [0, 100] and non-decreasing; on ``evaluate``'s own
   descriptors (its closures keep what they return): 4 queries' and 4
   tiles' against the CPU, the card's search against the CPU's (the same
   indices wherever neighbouring distances are more than 1e-5 of their
   scale apart), ``evaluate``'s recalls equal to ``evaluate_features`` on
   the CPU; the wall time of its gallery pass and of the rest, the search
   alone, one more ``evaluate`` under the profiler (its kernels' device
   total) and 4 batches rendered with nothing sent to the card; a gallery
   row duplicated into a ``PlaceIndex`` comes right after its original;
   [eval-crops] 32 queries' five crops in one MM forward at batch 160,
   nearest_crop and maj_voting from that pass over [eval]'s gallery
   (exact launch counts), one query's 5 crop rows against the CPU;
   [eval-fused] ``evaluate`` with the fused towers on 128 tiles and 64
   queries (K4, K5), exact launch counts, that run's descriptors against
   the CPU;
7. [timing] MM forward of both configurations at batch 32 and 128
   (synchronised latency and back-to-back throughput), on the same inputs;
8. [probe] the probe entry points' ``run()`` at b32: the stage-0 A/B (P2
   vs K2) and the block0 A/B (P1 vs K3) at chunks 1, 3 and 9, each v2
   checked against v1 and both timed in the cold-L2 regime; exact launch
   counts: one P2 or P1 launch per v2 call, one K2 or K3 per v1 call;
9. [train-k1] K1's autograd Function (``ode_step.euler_ode``: the kernel
   forward, JAX's backward in torch ops) against autograd through
   ``euler_ode_plain`` on the card, B = 1, 16, 33, 128, relu and tanh:
   y, gx, gw, gb within TRAIN_K1_TOL, and the device ms of forward plus
   backward of both;
10. [train-step] one train step at the full width of ``kitti360_config()``
    (fp32, 2 triplets of 2 negatives) on the card against the CPU with the
    same weights and batch: the loss, every gradient leaf (against its
    bf16 noise, the CPU step with fp32 BEV convs), the parameters after
    the update, the new BN statistics; exact launch counts (K1 3, K2-K6
    0);
11. [train] ``train()`` at the preset's full batch (16 x (2 + 10)),
    partial_sep mining over 128 tiles and 128 queries, 6 steps, one epoch,
    evaluation on 64 tiles and 32 queries: finite losses, exact launch
    counts of the steps (K1 3 per step, nothing else), the mining and
    evaluation passes' launches, the step wall time between step starts,
    the last step's device time by kernel class and busy share under the
    profiler, the peak device memory; the checkpoint restores the trained
    parameters, and ``PlaceIndex.from_checkpoint`` answers one request.
    Checkpoints go to ``_runs/`` (git-ignored) and are removed after.

Every phase raises on failure.  The second-to-last line is the per-kernel
JSON record (``launches`` summed over the nine paths, split in
``launches_by_path``; ``bound_ms`` / ``bound_by`` computed from this run's
inputs by ``bound``; ``library_ms`` the yardstick for part of the work
where there is one: cuDNN's convs for K3's, K6's and P1's conv phases
and K2's and P2's down0 GEMM, ``F.max_pool2d`` for K5; null for the
kernels no single PyTorch call computes), the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

IMAGE = 256
N_TILES = 512  # default path's gallery
N_TILES_FUSED = 128
N_EVAL_Q = 256  # [eval]: queries over the default path's N_TILES tiles
N_EVAL_CROP_Q = 32  # [eval-crops]: one MM forward of 5 x 32 crops
N_EVAL_FUSED_Q = 64  # [eval-fused]: queries over N_TILES_FUSED tiles
N_POINTS = 30000
CHUNKS = (1, 3, 9)  # P1's taps per concatenated group
# |kernel - plain| <= atol * max|plain| + rtol * |plain| elementwise, the
# mean error <= mean_tol * max|plain|, and the two differ at all on at most
# a share `frac` of the non-zero outputs (``differ``).
K1_TOL = dict(rtol=1e-4, atol=1e-5, mean=1e-6, frac=1.0)  # fp32 sum order
# bf16: kernel and plain round at the same points, but the conv
# accumulation order differs (wmma tiles vs cuDNN), so isolated 1-ulp bf16
# flips remain; in the residual add relu(g*att + r) such a flip of a large
# g lands on a small output (cancellation), hence the scale-relative atol.
# A systematic error would show in the mean, which must stay tiny.  A
# kernel that rounds at other points (K2's points in K4, K3's in K6) stays
# inside those bounds but changes far more outputs: `frac` catches it.
# ECA blocks (K3, K6, P1): a flip in conv1's rounded output moves many
# conv2 sums, so 9.8e-4 to 5.2e-2 of the non-zero outputs differ at the
# main-path shapes (H100, measured); other rounding points: 0.43-0.47.
KBF16_TOL = dict(rtol=2e-2, atol=1e-2, mean=1e-4, frac=0.15)
# BEV stage 0 (K2, K4, P2): conv0 sums bf16 weights over a 0/1 grid,
# exact in fp32, so only the down0 sum order differs: 0 to 5.7e-5 of the
# non-zero outputs (H100, measured); K2's rounding points in K4: 0.69.
KSTAGE0_TOL = dict(KBF16_TOL, frac=1e-3)
# One K3 conv phase against its plain version: the same rounding points,
# another summation order, so only isolated 1-ulp flips (2.1e-5 to 9.8e-4
# of the non-zero outputs at the main-path shapes on an H100 80GB HBM3);
# the masked pool sums those values in fp32 in another order (within
# 1.3e-4 of its largest magnitude there).
KCONV_TOL = dict(KBF16_TOL, frac=1e-2)
KPOOL_TOL = dict(rtol=0.0, atol=5e-3, mean=5e-4, frac=1.0)
# K5: the same fp32 multiply and add, one round, an exact max: bit-equal
EXACT = dict(rtol=0.0, atol=0.0, mean=0.0, frac=0.0)
# K4 against K2 and K6 against K3's plain version (not a kernel and its
# plain version): they round at different points, so many outputs differ
# by a bf16 ulp or two.  The difference stays below ROUNDING_TOL of the
# output's scale, and more than ROUNDING_MIN_DIFFER of the non-zero
# outputs differ, above each `frac` limit: those limits tell the rounding
# points apart.
ROUNDING_TOL = 5e-2
ROUNDING_MIN_DIFFER = 0.25
# GPU (kernels, cuDNN bf16) vs CPU (plain versions) embeddings: bf16 flips
# propagate through ~30 layers; bound the error by the embedding's scale
SLICE_TOL = 5e-2
# Training.  [train-k1]: K1's Function against autograd through the plain
# version on the card, both fp32; the kernel's forward sums in another
# order (K1_TOL), and the backward's reverse loop accumulates gx, gw, gb in
# another order than autograd does: each within TRAIN_K1_TOL of its scale.
TRAIN_K1_TOL = 1e-4
# [train-step]: the card against the CPU, fp32 model, each run twice from
# the same weights: as configured (BEV convs in bf16) and as a twin with
# those convs in fp32.  bf16 flips (as in the GPU-vs-CPU embeddings) move
# the loss by a fraction of TRAIN_LOSS_TOL.  The fp32 twins: every
# gradient leaf within TRAIN_FP32_TOL of its scale, no allowance for
# noise (measured on the H100: median 1.2e-5, all but two leaves within
# 2.4e-3, and in the image tower's last block 0.0197 (layer3_1.bn1.bias)
# and 0.0109 (its conv1): the card's convs sum in another order, and the
# block's 512 samples per channel leave its sums open to single elements
# that fall on the other side of a ReLU).  A leaf zero in exact
# arithmetic (the CPU twin's below TRAIN_ZERO_REL of its tower's largest:
# the biases of the convs before a train-mode BN) is below that floor on
# the card too.  As configured: a
# leaf whose bf16 noise on the CPU (the reference: its bf16 leaf against
# its fp32 twin's) is at most TRAIN_NOISE_CAP is held within
# TRAIN_GRAD_TOL plus TRAIN_NOISE times that noise; the rest by the twins
# alone (``phase_train_step``).  The BN statistics within TRAIN_STATS_TOL
# of their scale.
TRAIN_LOSS_TOL = 5e-3
TRAIN_FP32_TOL = 5e-2
TRAIN_ZERO_REL = 1e-6
TRAIN_GRAD_TOL = 2e-2
TRAIN_NOISE_CAP = 5e-2
TRAIN_NOISE = 3.0
TRAIN_STATS_TOL = 2e-2
# The least time of a kernel's work (``bound``): the larger of its
# operations over the card's peak for their type and its bytes (each input
# read once, each output written once) over the memory rate.  Published
# dense peaks of one H100 SXM at 700 W: bf16 tensor cores, fp32 outside
# them, HBM3.  Convolutions count the products of the 3-D convs
# (``conv_flops``), not the folded kernels' structural zeros.
PEAK_BF16, PEAK_FP32, HBM_BYTES_S = 989e12, 67e12, 3.35e12
# The wgmma kernels, by a part of their mangled names: each must hold HGMMA
SM90_KERNELS = {"K3 conv phase 1": "conv3x3_sm90_kernelILi0E",
                "K3 conv phase 2": "conv3x3_sm90_kernelILi1E",
                "K6 conv phase 1": "conv3x3_sm90_kernelILi2E",
                "K6 conv phase 2": "conv3x3_sm90_kernelILi3E",
                "K2 down0 GEMM": "down0_sm90_kernel",
                "K4 fused head": "head_sm90_kernel",
                "P2 concat GEMM": "down_concat_sm90_kernel",
                **{f"P1 conv phase {ph + 1} chunk {ch}":
                   f"p1_sm90_kernelILi{ch}ELi{ph}E"
                   for ch in CHUNKS for ph in (0, 1)}}


# What the kernels line carries beside its required keys, where a kernel's
# [parity] record has it: times by chunk, shape or batch, sub-records of the
# kernel alone and its conv phases, the library call's label
RECORD_KEYS = ("ms_by_chunk", "plain_ms_by_chunk", "device_ms_by_chunk",
               "conv_phases_device_ms_by_chunk", "chunk3_ms_by_shape",
               "chunk3_conv_phases_device_ms_by_shape", "library_ms_is",
               "ms_by_shape", "b128", "conv_phases", "probe_ab", "gemm",
               "queued", "z8", "z16", "ms_b128", "plain_ms_b128",
               "queued_ms", "queued_ms_b128", "device_ms", "device_ms_b128",
               "library_device_ms", "library_device_ms_b128",
               "bound_ms_b128", "conv_phases_device_ms", "train_k1")


def log(*a):
    print(*a, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median device time of ``fn`` in ms (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def queued_ms(fn, n: int = 10) -> float:
    """Device ms per call of ``fn`` with ``n`` calls queued back to back
    between two events (median of 20): the host's enqueue overlaps the
    device's work, so a kernel of 0.05 ms or more is timed by the device."""
    def calls():
        for _ in range(n):
            fn()
    return cuda_ms(calls) / n


def device_ms(fn, n: int = 50) -> float:
    """Mean device time per call of ``fn``'s kernels (``torch.profiler``
    over ``n`` calls after one warm-up): for a kernel shorter than the
    host's enqueue of one call, whose CUDA-event timings are the host's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return profiled_ms(prof) / n


def profiled_ms(prof) -> float:
    """Device ms of every kernel a ``torch.profiler`` run recorded."""
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if total <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return total / 1e3


def lidar(rng, n: int) -> np.ndarray:
    """Spinning-scanner clouds (HDL-64 elevation FOV, log-uniform range to
    100 m, ground truncation at sensor height) as ``bench.py`` makes them."""
    az = rng.uniform(0, 2 * np.pi, (n, N_POINTS))
    elev = np.deg2rad(rng.uniform(-24.9, 2.0, (n, N_POINTS)))
    r = np.exp(rng.uniform(np.log(2.0), np.log(100.0), (n, N_POINTS)))
    return np.stack([r * np.cos(elev) * np.cos(az),
                     r * np.cos(elev) * np.sin(az),
                     np.maximum(r * np.sin(elev), -1.73)],
                    axis=-1).astype(np.float32)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, n_bytes: int, peak: float = PEAK_BF16) -> dict:
    """The least time in ms for ``flops`` operations at ``peak`` and
    ``n_bytes`` at the memory rate, and which of the two sets it."""
    ops_ms, bytes_ms = flops / peak * 1e3, n_bytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def conv_flops(cells: int, w, z_in: int, z_out: int) -> float:
    """2 x output cells x the products of the 3-D conv whose folded kernel
    is ``w`` [k, k, z_in*cin, z_out*cout].  The fold holds a k*k*cin*cout
    block for each (zi, zo) pair the 3-D kernel reaches and zeros elsewhere
    (at z_in = 4: 14 of 16 blocks for conv0's 5 taps, 4 of 8 for down0's
    z pairing; at z = 2 the 3x3x3 kernels are dense, the 1x1 residual 2 of
    4); only the non-zero blocks are work."""
    k1, k2, zci, zco = w.shape
    blocks = w.reshape(k1 * k2, z_in, zci // z_in, z_out, zco // z_out)
    live = int((blocks.ne(0).sum(dim=(0, 2, 4)) > 0).sum())
    return 2.0 * cells * live * k1 * k2 * (zci // z_in) * (zco // z_out)


def block_bound(x, mask, w1, w2, s1, b1, s2, b2, w_eca, z, wd=None,
                scale_d=None, bias_d=None) -> dict:
    """An ECA block's bound (K3, K6, P1): its convs' operations against x,
    the mask, the parameters and the output once."""
    extra = () if wd is None else (wd, scale_d, bias_d)
    cells = x.shape[0] * x.shape[1] * x.shape[2]
    out_bytes = cells * w2.shape[3] * 2
    return bound(sum(conv_flops(cells, w, z, z) for w in (w1, w2)
                     + extra[:1]),
                 nbytes(x, mask, w1, w2, s1, b1, s2, b2, w_eca, *extra)
                 + out_bytes)


def add_bound(rec: dict, other: dict) -> None:
    """Sum the bounds of several shapes into ``rec``."""
    rec["bound_ms"] = rec.get("bound_ms", 0.0) + other["bound_ms"]
    rec["bound_by"] = other["bound_by"]


def differ(got, want) -> float:
    """Share of the outputs that either version leaves non-zero (the
    masked-off and relu-clamped zeros agree trivially) on which the two
    differ at all."""
    got, want = got.float(), want.float()
    live = (got != 0) | (want != 0)
    return float((got != want).sum()) / max(int(live.sum()), 1)


def compare(name, got, want, tol) -> dict:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = float(want.abs().max())
    bad = int((err > tol["atol"] * scale + tol["rtol"] * want.abs()).sum())
    frac = differ(got, want)
    ok = (bad == 0 and float(err.mean()) <= tol["mean"] * scale
          and frac <= tol["frac"] and bool(torch.isfinite(got).all()))
    rec = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
           "frac_differ": frac, "ok": ok}
    log(f"  {name}: max_abs_err={rec['max_abs_err']:.3g} "
        f"mean_abs_err={rec['mean_abs_err']:.3g} differ={frac:.3g} "
        f"scale={scale:.3g} outside_tol={bad} tol={tol} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return rec


def rounding_apart(name, got, other) -> dict:
    """``got`` against a version that rounds at other points: within
    ROUNDING_TOL of the scale, and at least ROUNDING_MIN_DIFFER of the
    elements differ."""
    d = (got.float() - other.float()).abs()
    scale = float(other.float().abs().max())
    rec = {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
           "frac_differ": differ(got, other)}
    log(f"  {name} (same inputs, different rounding points): "
        f"max_abs_err={rec['max_abs_err']:.3g} mean_abs_err="
        f"{rec['mean_abs_err']:.3g} differ={rec['frac_differ']:.3g} "
        f"scale={scale:.3g} (bounds: max <= {ROUNDING_TOL} x scale, "
        f"differ >= {ROUNDING_MIN_DIFFER})")
    if rec["max_abs_err"] > ROUNDING_TOL * scale:
        raise AssertionError(f"{name}: disagree beyond their rounding")
    if rec["frac_differ"] < ROUNDING_MIN_DIFFER:
        raise AssertionError(f"{name}: too few outputs differ to tell the "
                             f"rounding points apart")
    return rec


# --------------------------------------------------------------- phases
def phase_build():
    from agplace_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.lib()
    log(f"[build] {_build.LIB_PATH} in {time.perf_counter() - t0:.1f} s")
    with open(f"{_build.BUILD_DIR}/ptxas.log") as f:
        for line in f:
            if "Used" in line or "spill" in line and "0 bytes" not in line:
                log("  ptxas:", line.strip())
    sass = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()),
                                        "cuobjdump"), "-sass",
                           _build.LIB_PATH], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    per_fn = {}
    for section in sass.split("Function : ")[1:]:
        fn = section.split(None, 1)[0]
        per_fn[fn] = section.count("HGMMA")
    log(f"[build] cuobjdump -sass: {sum(per_fn.values())} HGMMA (wgmma) "
        f"instructions in {sum(1 for n in per_fn.values() if n)} kernels")
    for label, key in SM90_KERNELS.items():
        n = sum(c for fn, c in per_fn.items() if key in fn)
        log(f"  {label}: {n} HGMMA")
        if n == 0:
            raise AssertionError(f"{label} ({key}) holds no wgmma")


def conv_phases(name, args, z):
    """K3's two conv phases at one block shape, each against its plain
    version (the same conv + BN epilogue in PyTorch), timed beside the
    cuDNN yardstick: ``F.conv2d`` in bf16, channels_last, on the same folded
    weights (the conv alone; the port never calls it)."""
    import torch.nn.functional as F
    from agplace_tpu_torch.ops import bev_block_sm

    x, mask, w1, w2, s1, b1, s2, b2 = args[:8]
    cells = x.shape[0] * x.shape[1] * x.shape[2]
    h = bev_block_sm.conv_phase(x, mask, w1, s1, b1, z, pool=False)
    h_want = bev_block_sm.conv_phase_plain(x, mask, w1, s1, b1, z, False)
    g, pool = bev_block_sm.conv_phase(h, mask, w2, s2, b2, z, pool=True)
    g_want, pool_want = bev_block_sm.conv_phase_plain(h, mask, w2, s2, b2,
                                                      z, True)
    compare(f"K3 conv phase 1 {name}", h, h_want, KCONV_TOL)
    compare(f"K3 conv phase 2 {name}", g, g_want, KCONV_TOL)
    compare(f"K3 conv phase 2 pool {name}", pool, pool_want, KPOOL_TOL)
    out = {}
    for label, src, w, s, b, pool_ in (("conv1", x, w1, s1, b1, False),
                                       ("conv2_pool", h, w2, s2, b2, True)):
        wb = w.to(torch.bfloat16)  # the model's folded weights are bf16
        ms = queued_ms(lambda: bev_block_sm.conv_phase(src, mask, wb, s, b,
                                                       z, pool=pool_))
        xc = src.permute(0, 3, 1, 2)  # NHWC storage: channels_last NCHW
        wc = wb.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        cudnn = queued_ms(lambda: F.conv2d(xc, wc, padding=1))
        flops = conv_flops(cells, w, z, z)
        outs = cells * w.shape[3] * 2 + (x.shape[0] * w.shape[3] * 4
                                         if pool_ else 0)
        bnd = bound(flops, nbytes(src, mask, w, s, b) + outs)
        out[label] = dict(ms=ms, cudnn_ms=cudnn, tflops=flops / ms / 1e9,
                          share_of_bound=bnd["bound_ms"] / ms, **bnd)
        log(f"  K3 {label} {name}: {ms:.4f} ms = {flops / ms / 1e9:.1f} "
            f"TFLOP/s ({100 * flops / ms / 1e9 / (PEAK_BF16 / 1e12):.1f} % "
            f"of the bf16 peak), bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}), share {bnd['bound_ms'] / ms:.3f}; cuDNN "
            f"conv alone {cudnn:.4f} ms = {flops / cudnn / 1e9:.1f} TFLOP/s")
    return out


def p1_conv_phases(name, args, z, chunk):
    """P1's two conv phases at one block shape and chunk, each against its
    plain version (``concat_conv_phase_plain``: the concat conv rounded
    once, K3's epilogues); returns their device time per call of both
    (the profiler, 50 calls)."""
    from agplace_tpu_torch.ops import probe_block_sm_v2 as p1

    x, mask, w1, w2, s1, b1, s2, b2 = args[:8]
    h = p1.concat_conv_phase(x, mask, w1, s1, b1, z, False, chunk)
    g, pool = p1.concat_conv_phase(h, mask, w2, s2, b2, z, True, chunk)
    g_want, pool_want = p1.concat_conv_phase_plain(h, mask, w2, s2, b2, z,
                                                   True, chunk)
    compare(f"P1 conv phase 1 {name}", h, p1.concat_conv_phase_plain(
        x, mask, w1, s1, b1, z, False, chunk), KCONV_TOL)
    compare(f"P1 conv phase 2 {name}", g, g_want, KCONV_TOL)
    compare(f"P1 conv phase 2 pool {name}", pool, pool_want, KPOOL_TOL)

    def both():
        hh = p1.concat_conv_phase(x, mask, w1, s1, b1, z, False, chunk)
        p1.concat_conv_phase(hh, mask, w2, s2, b2, z, True, chunk)

    return device_ms(both)


def k6_conv_phases(name, args, z):
    """K6's two conv phases on the Hopper kernel (instances 2 and 3) at one
    block shape, each against its plain version (``bm_conv_phase_plain``:
    the fp32 epilogues), timed together by the profiler's device time beside
    the cuDNN yardstick (``F.conv2d`` of both, bf16, channels_last, the
    convs alone; 10 calls queued per timing)."""
    import torch.nn.functional as F
    from agplace_tpu_torch.ops import bev_block, bev_block_sm as bsm

    x, mask, w1, w2, s1, b1, s2, b2 = args[:8]
    h = bsm.conv3x3_launch(x, mask, w1, s1, b1, bsm.EPI_F32_RELU_MASK, z)
    g, pool = bsm.conv3x3_launch(h, mask, w2, s2, b2, bsm.EPI_F32_POOL, z)
    g_want, pool_want = bev_block.bm_conv_phase_plain(h, mask, w2, s2, b2,
                                                      z, pool=True)
    compare(f"K6 conv phase 1 {name}", h, bev_block.bm_conv_phase_plain(
        x, mask, w1, s1, b1, z, pool=False), KCONV_TOL)
    compare(f"K6 conv phase 2 {name}", g, g_want, KCONV_TOL)
    compare(f"K6 conv phase 2 pool {name}", pool, pool_want, KPOOL_TOL)

    def both():
        hh = bsm.conv3x3_launch(x, mask, w1, s1, b1, bsm.EPI_F32_RELU_MASK, z)
        bsm.conv3x3_launch(hh, mask, w2, s2, b2, bsm.EPI_F32_POOL, z)

    xc, hc = x.permute(0, 3, 1, 2), h.permute(0, 3, 1, 2)  # channels_last
    wc1, wc2 = (w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last) for w in (w1, w2))
    cudnn = queued_ms(lambda: (F.conv2d(xc, wc1, padding=1),
                               F.conv2d(hc, wc2, padding=1)))
    dms = device_ms(both)
    log(f"  K6 conv phases {name}: {dms:.4f} ms of device time; cuDNN convs "
        f"alone {cudnn:.4f} ms")
    return dict(device_ms=dms, cudnn_ms=cudnn)


def stage0_inputs(args, mask):
    """K2's / K4's arguments with another occupancy grid (the weights and
    affines of ``args``)."""
    return (mask.to(torch.bfloat16), mask, *args[2:])


def down0_alone(args, mask, z):
    """K2's down0 GEMM alone (conv0's output precomputed), held to its plain
    version and timed with 10 calls queued, beside its byte bound and the
    cuDNN yardstick: ``F.conv2d`` of down0 on the activated map (BN0 + relu
    + mask applied beforehand), bf16, channels_last, stride 2."""
    import torch.nn.functional as F
    from agplace_tpu_torch.data.voxels import me_down_align
    from agplace_tpu_torch.ops import bev_down
    from agplace_tpu_torch.sparse import bev_grid as bg

    feats, mask, w0, s0, b0, wd, sd, bd = stage0_inputs(args, mask)
    k0 = int(w0.shape[0])
    g0 = bg.bev_conv2d(feats, w0, 1, (k0 // 2,) * 2,
                       (k0 // 2,) * 2).contiguous()
    lo_z, hi_z, _ = me_down_align(z)
    m_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z)).contiguous()
    wb = wd.to(torch.bfloat16)
    gemm_args = (g0, mask, s0, b0, wb, sd, bd, m_out)
    got = bev_down.down0_gemm(*gemm_args, z=z)
    want, _ = bev_down.down0_plain(g0, mask, s0, b0, wb, sd, bd, z=z)
    bsz = g0.shape[0]
    rec = compare(f"K2 down0 GEMM alone b{bsz}", got, want, KSTAGE0_TOL)
    ms = queued_ms(lambda: bev_down.down0_gemm(*gemm_args, z=z))
    h = bg.mask_bev(torch.relu(g0 * s0.to(g0.dtype) + b0.to(g0.dtype)),
                    mask, z)
    hc = h.permute(0, 3, 1, 2)  # NHWC storage: channels_last NCHW
    wc = wb.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    cudnn = queued_ms(lambda: F.conv2d(hc, wc, stride=2))
    bnd = bound(conv_flops(got.shape[0] * got.shape[1] * got.shape[2], wd,
                           z, 2),
                nbytes(g0, mask, s0, b0, wb, sd, bd, m_out, got))
    log(f"  K2 down0 GEMM alone b{bsz}: {ms:.4f} ms; bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), share "
        f"{bnd['bound_ms'] / ms:.3f} = {nbytes(g0, got) / ms / 1e9:.2f} TB/s "
        f"of g in + out; cuDNN down0 alone {cudnn:.4f} ms")
    return dict(ms=ms, cudnn_ms=cudnn, share_of_bound=bnd["bound_ms"] / ms,
                max_abs_err=rec["max_abs_err"],
                frac_differ=rec["frac_differ"], **bnd)


def down_concat_alone(args, mask, z):
    """P2's kernel alone (``down_concat_gemm`` on precomputed parity
    planes and output mask) held to its plain version, timed with 10 calls
    queued and by the profiler's device time, beside its byte bound (the
    four planes, the mask and parameters in, the output out)."""
    from agplace_tpu_torch.data.voxels import me_down_align
    from agplace_tpu_torch.ops import probe_down_v2
    from agplace_tpu_torch.sparse import bev_grid as bg

    feats, mask, w0, s0, b0, wd, sd, bd = stage0_inputs(args, mask)
    planes = [p.contiguous() for p in probe_down_v2.parity_planes(feats, w0)]
    lo_z, hi_z, _ = me_down_align(z)
    m_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z)).contiguous()
    wb = wd.to(torch.bfloat16)
    gemm_args = (mask, s0, b0, wb, sd, bd, m_out)
    got = probe_down_v2.down_concat_gemm(planes, *gemm_args, z=z)
    want = probe_down_v2.down_concat_gemm_plain(planes, *gemm_args, z=z)
    bsz = mask.shape[0]
    rec = compare(f"P2 kernel alone b{bsz}", got, want, KSTAGE0_TOL)
    ms = queued_ms(lambda: probe_down_v2.down_concat_gemm(planes, *gemm_args,
                                                          z=z))
    dms = device_ms(lambda: probe_down_v2.down_concat_gemm(
        planes, *gemm_args, z=z))
    bnd = bound(conv_flops(got.shape[0] * got.shape[1] * got.shape[2], wd,
                           z, 2),
                nbytes(*planes, mask, s0, b0, wb, sd, bd, m_out, got))
    log(f"  P2 kernel alone b{bsz}: {ms:.4f} ms ({dms:.4f} ms of device "
        f"time); bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), share "
        f"{bnd['bound_ms'] / dms:.3f} = "
        f"{nbytes(*planes, got) / dms / 1e9:.2f} TB/s of planes in + out")
    return dict(ms=ms, device_ms=dms,
                share_of_bound=bnd["bound_ms"] / dms,
                max_abs_err=rec["max_abs_err"],
                frac_differ=rec["frac_differ"], **bnd)


def head_alone(args, mask, z):
    """K4's kernel (``head_gemm``: the output mask precomputed) against its
    plain version, 10 calls queued per timing: TFLOP/s and share of the
    bf16 peak (the 3-D convs' products, ``conv_flops``), the bound of the
    same work and the plain version's time."""
    from agplace_tpu_torch.data.voxels import me_down_align
    from agplace_tpu_torch.ops import bev_head
    from agplace_tpu_torch.sparse import bev_grid as bg

    ins = stage0_inputs(args, mask)
    lo_z, hi_z, _ = me_down_align(z)
    m_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z)).contiguous()
    bsz, x, y = mask.shape[:3]
    shape = f"[{bsz},{x},{y},{z}]->{ins[5].shape[3]}"
    got = bev_head.head_gemm(*ins, m_out, z=z)
    rec = compare(f"K4 kernel alone {shape}", got,
                  bev_head.head_plain(*ins, z=z)[0], KSTAGE0_TOL)
    ms = queued_ms(lambda: bev_head.head_gemm(*ins, m_out, z=z))
    pms = cuda_ms(lambda: bev_head.head_plain(*ins, z=z))
    cells = bsz * x * y
    flops = (conv_flops(cells, ins[2], z, z)
             + conv_flops(cells // 4, ins[5], z, 2))
    bnd = bound(flops, nbytes(*ins, m_out, got))
    tflops = flops / ms / 1e9
    log(f"  K4 kernel alone {shape}: {ms:.4f} ms; {tflops:.1f} TFLOP/s = "
        f"{100 * tflops / (PEAK_BF16 / 1e12):.1f} % of the bf16 peak; bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), share "
        f"{bnd['bound_ms'] / ms:.3f}; plain {pms:.4f} ms")
    return dict(ms=ms, plain_ms=pms, tflops=tflops,
                share_of_peak=tflops / (PEAK_BF16 / 1e12),
                share_of_bound=bnd["bound_ms"] / ms,
                max_abs_err=rec["max_abs_err"],
                frac_differ=rec["frac_differ"], **bnd)


def phase_parity(dev, masks, masks128, mask16):
    """Each kernel vs its plain version at its main-path shapes (b32; K1,
    K2's GEMM, K3 and K4 also at b128; K2 and K4 also at the z = 8 widths,
    K4 at the z = 16 widths on ``mask16``)."""
    from agplace_tpu_torch.ops import (bev_block, bev_block_sm, bev_down,
                                       bev_head, ode_step, probe_block_sm_v2,
                                       probe_down_v2, stem_pool)
    from agplace_tpu_torch.sparse.bev_grid import (fold_w2_k2s2,
                                                   fold_w2_stride1)

    g = torch.Generator(device="cpu").manual_seed(1)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(dev)

    def affine(c, z):
        s = torch.rand(c, generator=g) + 0.5
        b = torch.randn(c, generator=g) * 0.1
        return s.repeat(z).to(dev), b.repeat(z).to(dev)

    results = {}
    # K1: x [B, 256] fp32, 10 Euler steps, relu (the slice) and tanh, at
    # the serving batches 32 and 128 and at ragged ones (1, 33: a last row
    # tile of one row); timed at 32 and 128 (relu)
    w, b = randn(256, 256, std=1 / 16), randn(256, std=0.1)
    k1 = {"max_abs_err": 0.0, "frac_differ": 0.0, "library_ms": None}
    for bsz in (32, 128, 1, 33):
        x = randn(bsz, 256)
        for act in ("relu", "tanh"):
            args = (x, w, b, 10, 0.1, act)
            rec = compare(f"K1 fused_euler_ode {act} [{bsz},256]",
                          ode_step.fused_euler_ode(*args),
                          ode_step.euler_ode_plain(*args), K1_TOL)
            k1["max_abs_err"] = max(k1["max_abs_err"], rec["max_abs_err"])
            k1["frac_differ"] = max(k1["frac_differ"], rec["frac_differ"])
        if bsz not in (32, 128):
            continue
        args = (x, w, b, 10, 0.1, "relu")
        ms = cuda_ms(lambda: ode_step.fused_euler_ode(*args))
        pms = cuda_ms(lambda: ode_step.euler_ode_plain(*args))
        qms = queued_ms(lambda: ode_step.fused_euler_ode(*args))
        dms = device_ms(lambda: ode_step.fused_euler_ode(*args))
        log(f"  K1 relu b{bsz}: kernel {ms:.4f} ms ({qms:.4f} ms with 10 "
            f"calls queued, {dms:.4f} ms of device time), plain "
            f"{pms:.4f} ms")
        tag = "" if bsz == 32 else "_b128"
        k1.update({f"ms{tag}": ms, f"plain_ms{tag}": pms,
                   f"queued_ms{tag}": qms, f"device_ms{tag}": dms})
        if bsz == 32:  # 10 steps of x @ W (fp32, outside the tensor
            # cores); x, W, b read once, the result written once
            k1.update(bound(10 * 2.0 * bsz * w.numel(), nbytes(x, w, b, x),
                            PEAK_FP32))
    results["fused_euler_ode"] = k1

    # K2 at b32 KITTI: [32,128,128,4] occupancy, conv0 5x5 -> 4x64, down0
    m0 = masks[0]
    z0, c1 = 4, 64
    feats = m0.to(torch.bfloat16)
    args = (feats, m0, fold_w2_stride1(randn(5, 5, 5, 1, c1, std=0.25), z0),
            *affine(c1, z0),
            fold_w2_k2s2(randn(2, 2, 2, c1, c1, std=0.09), z0),
            *affine(c1, 2))
    out, mo = bev_down.fused_conv0_down0(*args, z=z0)
    ref, mr = bev_down.conv0_down0_plain(*args, z=z0)
    if not torch.equal(mo, mr):
        raise AssertionError("K2 output masks differ")
    rec = compare("K2 fused_conv0_down0 [32,128,128,4]->[32,64,64,128]",
                  out, ref, KSTAGE0_TOL)
    rec["ms"] = cuda_ms(lambda: bev_down.fused_conv0_down0(*args, z=z0))
    rec["plain_ms"] = cuda_ms(lambda: bev_down.conv0_down0_plain(*args,
                                                                 z=z0))
    log(f"  K2: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms "
        f"(both include the cuDNN conv0)")
    # the stage's work: conv0 over every full-resolution cell, down0 over
    # every output cell; the occupancy grid in, the output map and mask out
    stage0 = bound(conv_flops(m0.shape[0] * m0.shape[1] * m0.shape[2],
                              args[2], z0, z0)
                   + conv_flops(out.shape[0] * out.shape[1] * out.shape[2],
                                args[5], z0, 2),
                   nbytes(*args, out, mo))
    rec.update(stage0)
    rec["gemm"] = {f"b{m.shape[0]}": down0_alone(args, m, z0)
                   for m in (m0, masks128[0])}
    rec["library_ms"] = rec["gemm"][f"b{m0.shape[0]}"]["cudnn_ms"]
    # K2 at the widths of nuscenes_config() and the default config (z = 8:
    # Z*C1 = 512 -> Zo*C2 = 256, two N tiles a patch), on KITTI's occupancy
    # doubled along z
    m8, z8 = m0.repeat_interleave(2, dim=-1), 8
    args8 = (m8.to(torch.bfloat16), m8,
             fold_w2_stride1(randn(5, 5, 5, 1, c1, std=0.25), z8),
             *affine(c1, z8),
             fold_w2_k2s2(randn(2, 2, 2, c1, c1, std=0.09), z8),
             *affine(c1, 4))
    out8, mo8 = bev_down.fused_conv0_down0(*args8, z=z8)
    ref8, mr8 = bev_down.conv0_down0_plain(*args8, z=z8)
    if not torch.equal(mo8, mr8):
        raise AssertionError("K2 z=8 output masks differ")
    rec["z8"] = compare("K2 fused_conv0_down0 z=8 [32,128,128,8]->"
                        "[32,64,64,256]", out8, ref8, KSTAGE0_TOL)
    rec["z8"]["ms"] = cuda_ms(lambda: bev_down.fused_conv0_down0(*args8,
                                                                 z=z8))
    log(f"  K2 z=8: kernel {rec['z8']['ms']:.4f} ms (the cuDNN conv0 "
        f"included)")
    del ref8
    results["fused_conv0_down0"] = rec

    # K4 on K2's inputs: conv0 inside the kernel, fp32 epilogues
    out4, mo4 = bev_head.fused_head(*args, z=z0)
    ref4, mr4 = bev_head.head_plain(*args, z=z0)
    if not (torch.equal(mo4, mr4) and torch.equal(mo4, mo)):
        raise AssertionError("K4 output masks differ")
    rec = compare("K4 fused_head [32,128,128,4]->[32,64,64,128]", out4, ref4,
                  KSTAGE0_TOL)
    rec["ms"] = cuda_ms(lambda: bev_head.fused_head(*args, z=z0))
    rec["plain_ms"] = cuda_ms(lambda: bev_head.head_plain(*args, z=z0))
    log(f"  K4: kernel {rec['ms']:.4f} ms (conv0 inside), plain "
        f"{rec['plain_ms']:.4f} ms (fp32 cuDNN convs)")
    rec["vs_k2"] = rounding_apart("K4 vs K2", out4, out)
    rec.update(stage0, library_ms=None)  # K2's function
    rec["queued"] = {f"b{m.shape[0]}": head_alone(args, m, z0)
                     for m in (m0, masks128[0])}
    # K4 at the widths of the z = 8 presets (nuscenes_config(), Config():
    # Z*C0 = 8, Z*C1 = 512 -> Zo*C2 = 256, two N tiles, W0 streamed) on
    # K2's z = 8 inputs, and of the z = 16 preset (synthetic_config():
    # 32 x 32 x 16, 1024 -> 512, four N tiles) on its voxelized clouds
    rec["z8"] = head_alone(args8, m8, z8)
    rec["z8"]["vs_k2"] = rounding_apart(
        "K4 vs K2 z=8", bev_head.fused_head(*args8, z=z8)[0], out8)
    del args8, out8
    z16 = mask16.shape[-1]
    args16 = (mask16.to(torch.bfloat16), mask16,
              fold_w2_stride1(randn(5, 5, 5, 1, c1, std=0.25), z16),
              *affine(c1, z16),
              fold_w2_k2s2(randn(2, 2, 2, c1, c1, std=0.09), z16),
              *affine(c1, z16 // 2))
    rec["z16"] = head_alone(args16, mask16, z16)
    results["fused_head"] = rec

    # P2 on K2's inputs: four parity convs, one concat GEMM, K2's rounding
    out_p2, mo_p2 = probe_down_v2.fused_down_concat(*args, z=z0)
    ref_p2, mr_p2 = probe_down_v2.down_concat_plain(*args, z=z0)
    if not (torch.equal(mo_p2, mr_p2) and torch.equal(mo_p2, mo)):
        raise AssertionError("P2 output masks differ")
    rec = compare("P2 fused_down_concat [32,128,128,4]->[32,64,64,128]",
                  out_p2, ref_p2, KSTAGE0_TOL)
    rec["vs_k2"] = compare("P2 vs K2 (same inputs, same rounding points)",
                           out_p2, out, KSTAGE0_TOL)
    rec["ms"] = cuda_ms(lambda: probe_down_v2.fused_down_concat(*args,
                                                                z=z0))
    rec["device_ms"] = device_ms(lambda: probe_down_v2.fused_down_concat(
        *args, z=z0))
    rec["plain_ms"] = cuda_ms(lambda: probe_down_v2.down_concat_plain(
        *args, z=z0))
    log(f"  P2: kernel {rec['ms']:.4f} ms ({rec['device_ms']:.4f} ms of "
        f"device time), plain {rec['plain_ms']:.4f} ms (all include the "
        f"four cuDNN parity convs)")
    rec.update(stage0)  # K2's function
    rec["gemm"] = {f"b{m.shape[0]}": down_concat_alone(args, m, z0)
                   for m in (m0, masks128[0])}
    # the yardstick for the kernel's part: cuDNN's down0 alone on the
    # activated map, timed with K2's GEMM above (the same function of the
    # same map)
    for key, k2_gemm in results["fused_conv0_down0"]["gemm"].items():
        rec["gemm"][key]["cudnn_ms"] = k2_gemm["cudnn_ms"]
    rec["library_ms"] = rec["gemm"][f"b{m0.shape[0]}"]["cudnn_ms"]
    results["fused_down_concat"] = rec

    # K5: the stem conv output at b32 and b128 (256 px images), timed by
    # CUDA events and by the profiler's device time beside the yardstick
    # for part of its work, F.max_pool2d alone on the activated bf16 map in
    # channels-last; bit-equal also at a ragged last band, rows split into
    # column tiles, C = 8, an odd item count and a misaligned view
    import torch.nn.functional as F

    b32 = masks[0].shape[0]
    hw = IMAGE // 2  # the stem conv's output
    k5 = {"max_abs_err": 0.0, "frac_differ": 0.0}
    for i, (bsz, h, w, c) in enumerate((
            (b32, hw, hw, 64), (4 * b32, hw, hw, 64), (b32, 100, 64, 64),
            (1, 8, 512, 64), (2, 16, 16, 8), (3, 14, 12, 8))):
        x = (randn(bsz, h, w, c) * 2).to(torch.bfloat16)
        sc = (torch.rand(c, generator=g) + 0.5).to(dev)
        bi = randn(c, std=0.5)
        shape = f"[{bsz},{h},{w},{c}]->[{bsz},{h // 2},{w // 2},{c}]"
        rec = compare(f"K5 fused_affine_relu_maxpool {shape}",
                      stem_pool.fused_affine_relu_maxpool(x, sc, bi),
                      stem_pool.stem_pool_plain(x, sc, bi), EXACT)
        k5["max_abs_err"] = max(k5["max_abs_err"], rec["max_abs_err"])
        if i > 1:  # the b32 and b128 stem shapes are timed
            continue
        if i == 0:  # every pre-relu value negative: exactly zero
            xn, bn = -x.abs(), -bi.abs() - 0.5
            neg = stem_pool.fused_affine_relu_maxpool(xn, sc, bn)
            compare(f"K5 negative-bias {shape}", neg,
                    stem_pool.stem_pool_plain(xn, sc, bn), EXACT)
            if bool(neg.any()):
                raise AssertionError("K5 negative-bias case is not zero")
            # a contiguous view 2 bytes past 16-byte alignment: copied
            xo = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
            compare(f"K5 at storage offset 1 {shape}",
                    stem_pool.fused_affine_relu_maxpool(xo, sc, bi),
                    stem_pool.stem_pool_plain(x, sc, bi), EXACT)
        ms = cuda_ms(lambda: stem_pool.fused_affine_relu_maxpool(x, sc, bi))
        dms = device_ms(lambda: stem_pool.fused_affine_relu_maxpool(x, sc,
                                                                    bi))
        pms = cuda_ms(lambda: stem_pool.stem_pool_plain(x, sc, bi))
        y = stem_pool.stem_pool_plain(x, torch.ones_like(sc),
                                      torch.zeros_like(bi))
        ycl = y.permute(0, 3, 1, 2)  # NHWC storage: channels_last NCHW
        lms = cuda_ms(lambda: F.max_pool2d(ycl, 3, 2, 1))
        ldms = device_ms(lambda: F.max_pool2d(ycl, 3, 2, 1))
        # bytes: the map in, the pooled map out
        bnd = bound(0.0, nbytes(x, sc, bi) + x.numel() // 2)
        log(f"  K5 b{bsz}: kernel {ms:.4f} ms ({dms:.4f} ms of device "
            f"time; bound {bnd['bound_ms']:.4f} ms, share "
            f"{bnd['bound_ms'] / dms:.3f} = "
            f"{(nbytes(x) + x.numel() // 2) / dms / 1e9:.2f} TB/s), plain "
            f"{pms:.4f} ms; F.max_pool2d alone on the activated map "
            f"{lms:.4f} ms ({ldms:.4f} ms of device time)")
        if i == 0:
            k5.update(ms=ms, device_ms=dms, plain_ms=pms, library_ms=lms,
                      library_device_ms=ldms, **bnd)
        else:
            k5.update(ms_b128=ms, device_ms_b128=dms, plain_ms_b128=pms,
                      library_device_ms_b128=ldms,
                      bound_ms_b128=bnd["bound_ms"])
    results["fused_affine_relu_maxpool"] = k5

    # K3 at the four slice shapes (z = 2 after down0) and block0 at b128,
    # each conv phase timed beside its cuDNN yardstick; P1 on K3's b32
    # inputs at each chunk
    def block_args(mask, cin, c, z=2):
        bsz, xy = mask.shape[0], mask.shape[1]
        xin = randn(bsz, xy, xy, z, cin).to(torch.bfloat16)
        xin = torch.where(mask[..., None], xin, 0).reshape(bsz, xy, xy,
                                                           z * cin)
        kw = {}
        if cin != c:
            sd, bd = affine(c, z)
            kw = dict(wd=fold_w2_stride1(randn(1, 1, 1, cin, c,
                                               std=(2 / cin) ** .5), z),
                      scale_d=sd, bias_d=bd)
        args = (xin, mask,
                fold_w2_stride1(randn(3, 3, 3, cin, c,
                                      std=(2 / (27 * cin)) ** .5), z),
                fold_w2_stride1(randn(3, 3, 3, c, c,
                                      std=(2 / (27 * c)) ** .5), z),
                *affine(c, z), *affine(c, z), randn(3 if c == 64 else 5))
        return args, kw

    k3 = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
          "frac_differ": 0.0, "library_ms": 0.0, "ms_by_shape": {},
          "conv_phases": {}}
    p1 = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
          "frac_differ": 0.0, "ms_by_chunk": dict.fromkeys(CHUNKS, 0.0),
          "plain_ms_by_chunk": dict.fromkeys(CHUNKS, 0.0),
          "device_ms_by_chunk": dict.fromkeys(CHUNKS, 0.0),
          "conv_phases_device_ms_by_chunk": dict.fromkeys(CHUNKS, 0.0),
          "vs_k3_plain_frac_differ": 0.0, "chunk3_ms_by_shape": {},
          "chunk3_conv_phases_device_ms_by_shape": {}}
    shapes = ((1, 64, 64, "block0_0"), (2, 64, 128, "block1_0"),
              (3, 128, 256, "block2_0"), (3, 256, 256, "ffn_vox_0"))
    for mask, cin, c, name in (
            [(masks[i], cin, c, name) for i, cin, c, name in shapes]
            + [(masks128[i], cin, c, name + "_b128")
               for i, cin, c, name in shapes]):
        z = 2
        args, kw = block_args(mask, cin, c, z)
        bsz, xy, zci = args[0].shape[0], args[0].shape[1], args[0].shape[3]
        shape = f"[{bsz},{xy},{xy},{zci}]->{z * c}"
        k3_plain = bev_block_sm.eca_block_plain(*args, z=z, **kw)
        rec = compare(f"K3 fused_eca_block_sm {name} {shape}",
                      bev_block_sm.fused_eca_block_sm(*args, z=z, **kw),
                      k3_plain, KBF16_TOL)
        ms = cuda_ms(lambda: bev_block_sm.fused_eca_block_sm(*args, z=z,
                                                             **kw))
        pms = cuda_ms(lambda: bev_block_sm.eca_block_plain(*args, z=z,
                                                           **kw))
        bnd = block_bound(*args, z, **kw)
        log(f"  K3 {name}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), share of bound "
            f"{bnd['bound_ms'] / ms:.3f}")
        phases = conv_phases(name, args, z)
        k3["conv_phases"][name] = phases
        k3["ms_by_shape"][name] = ms
        k3["max_abs_err"] = max(k3["max_abs_err"], rec["max_abs_err"])
        k3["frac_differ"] = max(k3["frac_differ"], rec["frac_differ"])
        if name.endswith("_b128"):  # not in the b32 sums
            k3.setdefault("b128", {})[name[:-5]] = dict(ms=ms, plain_ms=pms,
                                                        **bnd)
            continue
        k3["ms"] += ms
        k3["plain_ms"] += pms
        k3["library_ms"] += sum(ph["cudnn_ms"] for ph in phases.values())
        add_bound(k3, bnd)
        add_bound(p1, bnd)  # P1 computes K3's function
        for ch in CHUNKS:
            kwc = dict(kw, chunk=ch)
            got = probe_block_sm_v2.fused_eca_block_concat(*args, z=z, **kwc)
            rec = compare(f"P1 fused_eca_block_concat chunk {ch} {name} "
                          f"{shape}", got,
                          probe_block_sm_v2.eca_block_concat_plain(
                              *args, z=z, **kwc), KBF16_TOL)
            vs = compare(f"P1 chunk {ch} vs K3's plain version {name} "
                         f"(same rounding points)", got, k3_plain,
                         KBF16_TOL)
            ms_c = cuda_ms(lambda: probe_block_sm_v2.fused_eca_block_concat(
                *args, z=z, **kwc))
            dms_c = device_ms(lambda: probe_block_sm_v2.
                              fused_eca_block_concat(*args, z=z, **kwc))
            pms_c = cuda_ms(lambda: probe_block_sm_v2.eca_block_concat_plain(
                *args, z=z, **kwc))
            ph_ms = p1_conv_phases(f"chunk {ch} {name}", args, z, ch)
            log(f"  P1 chunk {ch} {name}: kernel {ms_c:.4f} ms ({dms_c:.4f} "
                f"ms of device time, its conv phases {ph_ms:.4f}), plain "
                f"{pms_c:.4f} ms (K3 kernel {ms:.4f} ms: "
                f"{'faster' if ms < ms_c else 'NOT faster'})")
            p1["ms_by_chunk"][ch] += ms_c
            p1["plain_ms_by_chunk"][ch] += pms_c
            p1["device_ms_by_chunk"][ch] += dms_c
            p1["conv_phases_device_ms_by_chunk"][ch] += ph_ms
            if ch == 3:
                p1["chunk3_ms_by_shape"][name] = ms_c
                p1["chunk3_conv_phases_device_ms_by_shape"][name] = ph_ms
            p1["max_abs_err"] = max(p1["max_abs_err"], rec["max_abs_err"])
            p1["frac_differ"] = max(p1["frac_differ"], rec["frac_differ"])
            p1["vs_k3_plain_frac_differ"] = max(
                p1["vs_k3_plain_frac_differ"], vs["frac_differ"])
    results["fused_eca_block_sm"] = k3
    p1["ms"], p1["plain_ms"] = p1["ms_by_chunk"][3], \
        p1["plain_ms_by_chunk"][3]  # the default chunk, four shapes
    p1["device_ms"] = p1["device_ms_by_chunk"][3]
    p1["conv_phases_device_ms"] = p1["conv_phases_device_ms_by_chunk"][3]
    # P1 computes K3's function: K3's cuDNN conv phases (both convs alone,
    # the same inputs) are the yardstick for its conv part
    p1["library_ms"] = k3["library_ms"]
    p1["library_ms_is"] = "yardstick for part: cuDNN's two conv phases"
    results["fused_eca_block_concat"] = p1

    # K6 (no model path): identity blocks at a stage-0 and a stage-2 shape
    # (Z*C = 128 and 512: the conv phases on the Hopper kernel, each also
    # against its plain version and beside the cuDNN yardstick), timed by
    # CUDA events and the profiler's device time; Z*C = 64 and 96 (the
    # wmma implicit GEMM's widths) compared only
    k6 = {"ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0,
          "conv_phases_device_ms": 0.0, "library_ms": 0.0,
          "max_abs_err": 0.0, "frac_differ": 0.0}
    for mask, c in ((masks[1], 64), (masks[3], 256), (masks[1][:4], 32),
                    (masks[2][:4], 48)):
        z = 2
        bsz, xy = mask.shape[0], mask.shape[1]
        xin = randn(bsz, xy, xy, z, c).to(torch.bfloat16)
        xin = torch.where(mask[..., None], xin, 0).reshape(bsz, xy, xy,
                                                           z * c)
        ws = [fold_w2_stride1(randn(3, 3, 3, c, c, std=(2 / (27 * c)) ** .5),
                              z).to(torch.bfloat16) for _ in range(2)]
        args = (xin, mask, *ws, *affine(c, z), *affine(c, z),
                randn(3 if c == 64 else 5))
        shape = f"[{bsz},{xy},{xy},{z * c}]"
        out6 = bev_block.fused_eca_block(*args, z=z)
        rec = compare(f"K6 fused_eca_block {shape}", out6,
                      bev_block.eca_block_bm_plain(*args, z=z), KBF16_TOL)
        rounding_apart(f"K6 vs K3's plain version {shape}", out6,
                       bev_block_sm.eca_block_plain(*args, z=z))
        mzc = mask.repeat_interleave(c, dim=-1)
        if bool(out6[~mzc].any()):
            raise AssertionError(f"K6 {shape}: non-zero outputs off the "
                                 f"mask")
        k6["max_abs_err"] = max(k6["max_abs_err"], rec["max_abs_err"])
        k6["frac_differ"] = max(k6["frac_differ"], rec["frac_differ"])
        if z * c % 128:
            continue
        ms = cuda_ms(lambda: bev_block.fused_eca_block(*args, z=z))
        dms = device_ms(lambda: bev_block.fused_eca_block(*args, z=z))
        pms = cuda_ms(lambda: bev_block.eca_block_bm_plain(*args, z=z))
        phases = k6_conv_phases(shape, args, z)
        bnd = block_bound(*args, z)
        log(f"  K6 {shape}: kernel {ms:.4f} ms ({dms:.4f} ms of device "
            f"time, its conv phases {phases['device_ms']:.4f}; bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), share "
            f"{bnd['bound_ms'] / dms:.3f}), plain {pms:.4f} ms")
        k6["ms"] += ms
        k6["device_ms"] += dms
        k6["conv_phases_device_ms"] += phases["device_ms"]
        k6["library_ms"] += phases["cudnn_ms"]
        k6["plain_ms"] += pms
        add_bound(k6, bnd)
    results["fused_eca_block"] = k6
    return results


def seed_bn(module, rng):
    """Non-trivial BN affines and running statistics, from numpy."""
    from agplace_tpu_torch.models.norm import BatchNorm2D

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm2D):
                c = m.weight.shape[0]
                for t, a in ((m.weight, rng.uniform(0.5, 1.5, c)),
                             (m.bias, rng.normal(0, 0.1, c)),
                             (m.running_mean, rng.normal(0, 0.1, c)),
                             (m.running_var, rng.uniform(0.5, 1.5, c))):
                    t.copy_(torch.from_numpy(a.astype(np.float32)))


class Tiles:
    """Synthetic aerial gallery: tile i is a seeded [1, 256, 256, 3] map."""

    def __init__(self, n):
        self.database_num = n

    def load_db_maps(self, i):
        rng = np.random.default_rng(10_000 + i)
        return rng.standard_normal((1, IMAGE, IMAGE, 3)).astype(np.float32)


def expected_launches(cfg, n_tiles, n_requests):
    """Launch counts of one serving run: ``add_tiles`` embeds the gallery in
    padded batches of ``infer_batch_size``, so ceil(n_tiles / bs) aerial-
    tower forwards; each request of <= bs queries is one MM forward."""
    mm = cfg.model.mm
    db_forwards = -(-n_tiles // cfg.train.infer_batch_size)
    head = mm.bev_pallas_head
    return {"fused_euler_ode": 3 * n_requests,
            "fused_conv0_down0": 0 if head else n_requests,
            "fused_eca_block_sm": 4 * n_requests,
            "fused_head": n_requests if head else 0,
            "fused_affine_relu_maxpool":
                (n_requests if mm.stem_pallas else 0)
                + (db_forwards * cfg.data.nmap if cfg.model.db.stem_pallas
                   else 0),
            "fused_eca_block": 0, "fused_eca_block_concat": 0,
            "fused_down_concat": 0}


def phase_serving(cfg, dev, n_tiles, label):
    from agplace_tpu_torch import ops
    from agplace_tpu_torch.infer import build_towers
    from agplace_tpu_torch.serving import PlaceIndex

    mm, db = build_towers(cfg, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    seed_bn(mm, rng)
    seed_bn(db, rng)
    cpu_mm, cpu_db = copy.deepcopy(mm), copy.deepcopy(db)
    idx = PlaceIndex(cfg, (mm.to(dev), db.to(dev)), device=dev)

    requests = []
    for n in (1, 7, 32):
        requests.append((rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(
            np.float32), lidar(rng, n)))

    ops.reset_launches()  # ---- the path: gallery + three requests
    t0 = time.perf_counter()
    n_rows = idx.add_tiles(Tiles(n_tiles))
    torch.cuda.synchronize()
    t_gallery = time.perf_counter() - t0
    answers = []
    t0 = time.perf_counter()
    for images, points in requests:
        answers.append(idx.search(images, points, k=5))
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    counts = ops.launches()  # ---- read just after the path
    log(f"[{label}] gallery {n_rows} tiles in {t_gallery:.2f} s; 3 requests "
        f"in {t_search:.2f} s (host prep included); launches {counts}")
    if n_rows != n_tiles:
        raise AssertionError(f"gallery holds {n_rows} rows")
    for (images, _), (d, i) in zip(requests, answers):
        n = images.shape[0]
        if d.shape != (n, 5) or i.shape != (n, 5):
            raise AssertionError(f"search shapes {d.shape} {i.shape}")
        if not (np.isfinite(d).all() and ((i >= 0) & (i < n_tiles)).all()):
            raise AssertionError("non-finite distances or bad indices")
    want = expected_launches(cfg, n_tiles, len(requests))
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")

    images, points = requests[1]
    q = idx.embed(images[:1], points[:1])
    planted = idx.add_descriptors(q) - 1
    d, i = idx.search(images[:1], points[:1], k=5)
    log(f"[{label}] planted row {planted}: top-1 {i[0, 0]} d={d[0, 0]:.3g}")
    if i[0, 0] != planted:
        raise AssertionError("planted descriptor is not the top-1 hit")
    return (mm, db), (cpu_mm, cpu_db), requests, counts


def phase_slice_parity(cfg, mm, cpu_mm, requests, dev, label):
    from agplace_tpu_torch.data.voxels import prepare_query_vox

    images, points = requests[2]
    images, points = images[:4], points[:4]
    with torch.inference_mode():
        gpu = mm(torch.from_numpy(images).to(dev),
                 prepare_query_vox(cfg, points, dev))["embedding"].cpu()
        cpu = cpu_mm(torch.from_numpy(images),
                     prepare_query_vox(cfg, points, "cpu"))["embedding"]
    err = float((gpu - cpu).abs().max())
    scale = float(cpu.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(gpu, cpu).min())
    ok = bool(torch.isfinite(gpu).all()) and err <= SLICE_TOL * scale
    log(f"[{label}] GPU vs CPU embedding (4 queries): max_abs_err={err:.4g} "
        f"(scale {scale:.4g}, tol {SLICE_TOL} x scale), min cosine "
        f"{cos:.6f} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("GPU embedding disagrees with the CPU run")


def phase_nuscenes_fused(dev):
    """One MM forward of ``nuscenes_config()`` with ``bev_pallas_head`` set,
    in bf16 at its full widths and its full 128 x 128 x 8 grid, batch 2:
    K4 takes the z = 8 stage 0 (Z*C0 = 8 -> Zo*C2 = 256).  Exact launch
    counts (reset just before the forward, read just after it): K1 x3, K3
    x4, K4 x1, nothing else; the embeddings match the CPU run of the same
    module and weights."""
    import dataclasses

    from agplace_tpu_torch import nuscenes_config, ops
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.infer import build_towers

    cfg = nuscenes_config()
    mc = dataclasses.replace(cfg.model.mm, bev_pallas_head=True)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, mm=mc, compute_dtype="bfloat16"))
    rng = np.random.default_rng(7)
    mm, _ = build_towers(cfg, "cpu", torch.Generator().manual_seed(0))
    seed_bn(mm, rng)
    cpu_mm = copy.deepcopy(mm)
    mm.to(dev)
    images = rng.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    points = lidar(rng, 2)
    vox = prepare_query_vox(cfg, points, dev)
    if tuple(vox.mask.shape[1:]) != tuple(mc.vox_grid_extent):
        raise AssertionError(f"nuScenes grid {tuple(vox.mask.shape)}")
    with torch.inference_mode():
        ops.reset_launches()  # ---- the path: one MM forward
        gpu = mm(torch.from_numpy(images).to(dev), vox)["embedding"]
        torch.cuda.synchronize()
        counts = ops.launches()  # ---- read just after the path
        cpu = cpu_mm(torch.from_numpy(images),
                     prepare_query_vox(cfg, points, "cpu"))["embedding"]
    want = dict.fromkeys(counts, 0)
    want.update(fused_euler_ode=3, fused_eca_block_sm=4, fused_head=1)
    log(f"[nuscenes-fused] launches {counts}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    gpu = gpu.cpu()
    err = float((gpu - cpu).abs().max())
    scale = float(cpu.abs().max())
    ok = (gpu.shape == (2, 256) and bool(torch.isfinite(gpu).all())
          and err <= SLICE_TOL * scale)
    log(f"[nuscenes-fused] GPU vs CPU embedding (2 queries, grid "
        f"{'x'.join(map(str, mc.vox_grid_extent))}): max_abs_err={err:.4g} "
        f"(scale {scale:.4g}, tol {SLICE_TOL} x scale) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("nuScenes GPU embedding disagrees with the CPU")
    return counts


def phase_timing(cfg, models, dev, name):
    """MM forward of each configuration on the same inputs, in the order
    A B B A per batch size (the voxel grid does not depend on the flags)."""
    from agplace_tpu_torch.data.voxels import prepare_query_vox

    rng = np.random.default_rng(5)
    labels = list(models)
    for bsz in (32, 128):
        images = torch.from_numpy(rng.standard_normal(
            (bsz, IMAGE, IMAGE, 3)).astype(np.float32)).to(dev)
        vox = prepare_query_vox(cfg, lidar(rng, bsz), dev)
        runs = {k: [] for k in labels}
        for label in labels + labels[::-1]:
            mm = models[label]

            def back_to_back():
                for _ in range(10):
                    mm(images, vox)

            with torch.inference_mode():
                # latency: one forward, synchronised, median of 10
                ms = cuda_ms(lambda: mm(images, vox), warmup=3, iters=10)
                # throughput: 10 forwards queued back to back, so the
                # host's launch work overlaps the device's; median of 5
                tput_ms = cuda_ms(back_to_back, warmup=1, iters=5) / 10
            runs[label].append((ms, tput_ms))
            log(f"[timing] MM forward b{bsz} {label}: latency {ms:.3f} ms; "
                f"back-to-back {tput_ms:.3f} ms/forward = "
                f"{bsz / tput_ms * 1e3:.1f} desc/s ({name})")
        for label, r in runs.items():
            ms, tput = (statistics.mean(v) for v in zip(*r))
            log(f"[timing] MM forward b{bsz} {label}, mean of 2: latency "
                f"{ms:.3f} ms; back-to-back {tput:.3f} ms/forward = "
                f"{bsz / tput * 1e3:.1f} desc/s")


def phase_probe(dev):
    """The probe entry points at b32: P2 vs K2, and P1 vs K3 at each chunk.
    Launch counts are exact: each v1 / v2 call of a ``run()`` is one
    launch of K2 / P2 or K3 / P1."""
    from agplace_tpu_torch import ops

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import probe_torch_block_sm_v2
    import probe_torch_down_v2

    ops.reset_launches()  # ---- the path: both entry points
    down = probe_torch_down_v2.run(dev)
    blocks = [probe_torch_block_sm_v2.run(dev, chunk=ch) for ch in CHUNKS]
    counts = ops.launches()  # ---- read just after the path
    want = dict.fromkeys(counts, 0)
    want.update(fused_conv0_down0=down["calls"]["v1"],
                fused_down_concat=down["calls"]["v2"],
                fused_eca_block_sm=sum(r["calls"]["v1"] for r in blocks),
                fused_eca_block_concat=sum(r["calls"]["v2"] for r in blocks))
    log(f"[probe] launches {counts}")
    if not all(want[k] for k in ("fused_conv0_down0", "fused_down_concat",
                                 "fused_eca_block_sm",
                                 "fused_eca_block_concat")):
        raise AssertionError(f"a kernel of the probe path never ran: {want}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    for rec, limit in [(down, KSTAGE0_TOL["frac"])] + [
            (r, KBF16_TOL["frac"]) for r in blocks]:
        what = (f"block0 chunk {rec['chunk']} P1 vs K3" if "chunk" in rec
                else "stage 0 P2 vs K2")
        log(f"[probe] {what}: v1_shipped {rec['v1_shipped']:.4f} ms, "
            f"v2_concat {rec['v2_concat']:.4f} ms (cold L2); max_abs "
            f"{rec['max_abs']:.3g}, differ {rec['frac_differ']:.3g} (limit "
            f"{limit}); {json.dumps(rec)}")
        if not rec["frac_differ"] <= limit:
            raise AssertionError(f"{what}: v2 disagrees with v1")
    return counts, down, blocks


def eval_dataset(cfg, n_db, n_q, crops=False):
    """The synthetic world at the full input sizes: 256 px images, clouds
    of ``N_POINTS`` points (a quarter NaN padding), seed 0, so every eval
    phase sees the same first ``n_db`` tiles.  ``crops``: five crops per
    query, as a folder dataset cuts them (the query image resized to 1.2x
    the crop, then the four corners and the centre)."""
    from agplace_tpu_torch.data.synthetic import SyntheticDataset
    from agplace_tpu_torch.evaluate import resize_bilinear

    class CropQueries(SyntheticDataset):
        def load_query_crops(self, idx, crop):
            big = int(crop * 1.2)
            img = resize_bilinear(self.load_query_image(idx), (big, big))
            o, c = big - crop, (big - crop) // 2
            return np.stack([img[y:y + crop, x:x + crop] for y, x in
                             ((0, 0), (0, o), (o, 0), (o, o), (c, c))])

    return (CropQueries if crops else SyntheticDataset)(
        n_db=n_db, n_q=n_q, image_size=IMAGE, nmap=cfg.data.nmap,
        n_points=N_POINTS, seed=0)


def check_recalls(label, recalls, text):
    ok = (np.isfinite(recalls).all() and (recalls >= 0).all()
          and (recalls <= 100).all() and (np.diff(recalls) >= 0).all())
    log(f"[{label}] {text} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: recalls {recalls}")


def check_descriptors(label, what, gpu, cpu):
    """Card descriptors against the CPU run of the same module."""
    err = float(np.abs(gpu - cpu).max())
    scale = float(np.abs(cpu).max())
    ok = bool(np.isfinite(gpu).all()) and err <= SLICE_TOL * scale
    log(f"[{label}] GPU vs CPU {what}: max_abs_err={err:.4g} (scale "
        f"{scale:.4g}, tol {SLICE_TOL} x scale) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: {what} disagree with the CPU")


def cpu_descriptors(cfg, ds, cpu_towers, n):
    """The first ``n`` queries' and tiles' descriptors from the CPU copies
    of the towers (the kernels' plain versions)."""
    from agplace_tpu_torch.data.base import collate_cache_db, collate_cache_q
    from agplace_tpu_torch.infer import compute_dtype

    cpu_mm, cpu_db = cpu_towers
    images, vox = collate_cache_q(ds, range(n), cfg, "cpu",
                                  compute_dtype(cfg))
    with torch.inference_mode():
        q = cpu_mm(torch.from_numpy(images), vox)["embedding"]
        db = cpu_db(torch.from_numpy(collate_cache_db(ds, range(n))))
    return q.float().numpy(), db.float().numpy()


def run_evaluate(cfg, ds, towers, dev):
    """The path: ``evaluate(cfg, ds, ...)`` on the card, launch counts reset
    just before it and read just after.  Its closures keep what they
    return, so the checks read the descriptors ``evaluate`` itself used;
    the dataset stamps its first query load, where the gallery pass has
    ended (its descriptors fetched).  Returns (recalls, text, counts,
    query and tile descriptors as numpy, wall s of evaluate, wall s of its
    gallery pass)."""
    from agplace_tpu_torch import ops
    from agplace_tpu_torch.evaluate import evaluate
    from agplace_tpu_torch.infer import make_infer_fns

    def keeping(fn, out):
        def call(*args):
            out.append(fn(*args))
            return out[-1]
        return call

    q_out, db_out, first_q = [], [], []
    load = ds.load_query_image

    def stamped(i):
        if not first_q:
            first_q.append(time.perf_counter())
        return load(i)

    ds.load_query_image = stamped
    embed_q, embed_db = make_infer_fns(*towers)
    ops.reset_launches()  # ---- the path: evaluate
    t0 = time.perf_counter()
    recalls, text = evaluate(cfg, ds, keeping(embed_q, q_out),
                             keeping(embed_db, db_out), device=dev)
    t_eval = time.perf_counter() - t0
    counts = ops.launches()  # ---- read just after the path
    ds.load_query_image = load
    q = torch.cat(q_out)[:ds.queries_num].float().cpu().numpy()
    db = torch.cat(db_out)[:ds.database_num].float().cpu().numpy()
    return recalls, text, counts, q, db, t_eval, first_q[0] - t0


def phase_eval(cfg, towers, cpu_towers, dev):
    """[eval]: ``evaluate`` with hard_resize on the card, 512 tiles and 256
    queries at ``infer_batch_size`` 32: 16 aerial-tower and 8 MM forwards,
    exact launch counts (``run_evaluate``).  On ``evaluate``'s own
    descriptors: 4 queries' and 4 tiles' against the CPU; the card's search
    against the CPU's; ``evaluate``'s recalls against ``evaluate_features``
    on the CPU.  Then one more ``evaluate`` under the profiler (its device
    total), 4 batches rendered with nothing sent to the card (the host's
    share), and a gallery row duplicated into the index comes second,
    after its original."""
    from agplace_tpu_torch.data.base import collate_cache_db, collate_cache_q
    from agplace_tpu_torch.evaluate import (evaluate, evaluate_features,
                                            search)
    from agplace_tpu_torch.infer import make_infer_fns
    from agplace_tpu_torch.serving import PlaceIndex
    from torch.profiler import ProfilerActivity, profile

    ds = eval_dataset(cfg, N_TILES, N_EVAL_Q)
    bs = cfg.train.infer_batch_size
    recalls, text, counts, q, db, t_eval, t_gallery = run_evaluate(
        cfg, ds, towers, dev)
    want = expected_launches(cfg, ds.database_num, -(-ds.queries_num // bs))
    log(f"[eval] evaluate(hard_resize) of {ds.queries_num} queries over "
        f"{ds.database_num} tiles in {t_eval:.3f} s; launches {counts}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    check_recalls("eval", recalls, text)
    cq, cdb = cpu_descriptors(cfg, ds, cpu_towers, 4)
    check_descriptors("eval", "descriptors of 4 queries", q[:4], cq)
    check_descriptors("eval", "descriptors of 4 tiles", db[:4], cdb)

    # the search on the card against the CPU's, on evaluate's descriptors
    k = max(cfg.eval.recall_values)
    t0 = time.perf_counter()
    d, i = search(q, db, k, dev)
    t_search = time.perf_counter() - t0
    d_cpu, i_cpu = search(q, db, k, "cpu")
    r_cpu = evaluate_features(cfg, ds, q, db, device="cpu")[0]
    tol = 1e-5 * float(np.abs(d_cpu).max())
    gap = np.diff(d_cpu, axis=1) > tol
    apart = np.ones(i_cpu.shape, bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    d_err = float(np.abs(d - d_cpu).max())
    ok = ((i[apart] == i_cpu[apart]).all() and d_err <= tol
          and (recalls == r_cpu).all())
    log(f"[eval] card vs CPU search: indices equal at {int(apart.sum())} of "
        f"{apart.size} places whose neighbours are over {tol:.3g} apart "
        f"(all equal: {bool((i == i_cpu).all())}), max distance error "
        f"{d_err:.3g}; evaluate's recalls {recalls.tolist()} vs "
        f"evaluate_features on the CPU {r_cpu.tolist()} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's search disagrees with the CPU's")

    # the device's share: evaluate once more, every kernel profiled
    embed_q, embed_db = make_infer_fns(*towers)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate(cfg, ds, embed_q, embed_db, device=dev)
        t_prof = time.perf_counter() - t0
    busy = profiled_ms(prof) / 1e3
    # the host's share: 4 batches rendered (the clouds voxelized) with
    # nothing sent to the card
    n_b = 4
    t0 = time.perf_counter()
    for s in range(0, n_b * bs, bs):
        collate_cache_db(ds, range(s, s + bs))
    h_db = (time.perf_counter() - t0) / n_b
    t0 = time.perf_counter()
    for s in range(0, n_b * bs, bs):
        collate_cache_q(ds, range(s, s + bs), cfg, "cpu")
    h_q = (time.perf_counter() - t0) / n_b
    nb_db, nb_q = -(-ds.database_num // bs), -(-ds.queries_num // bs)
    log(f"[eval] wall times of evaluate: gallery pass {t_gallery:.3f} s "
        f"({nb_db} batches of {bs} tiles), then the query pass with its "
        f"host prep, the search and Recall@N {t_eval - t_gallery:.3f} s "
        f"({nb_q} batches); the search alone {t_search:.4f} s (k={k})")
    log(f"[eval] device: evaluate under the profiler {t_prof:.3f} s wall, "
        f"{busy:.4f} s of kernels (busy {busy / t_prof:.3f}); host alone: "
        f"rendering {h_db:.4f} s per batch of {bs} tiles ({n_b} timed; x "
        f"{nb_db} = {h_db * nb_db:.3f} s), rendering and voxelizing "
        f"{h_q:.4f} s per batch of {bs} queries (x {nb_q} = "
        f"{h_q * nb_q:.3f} s)")

    idx = PlaceIndex(cfg, None, device=dev)
    idx.add_descriptors(db)
    dup = idx.add_descriptors(db[37:38]) - 1
    _, hit = idx.search_descriptors(db[37:38], 3)
    log(f"[eval] row 37 duplicated as row {dup}: top-3 {hit[0].tolist()}")
    if hit[0, :2].tolist() != [37, dup]:
        raise AssertionError("a tie did not come out lowest index first")
    return counts, db


def phase_eval_crops(cfg, towers, cpu_towers, db, dev):
    """[eval-crops]: 32 queries' five crops in one MM forward at batch 160
    (exact launch counts), nearest_crop and maj_voting from that one
    embed pass over [eval]'s gallery, and one query's 5 crop rows against
    the CPU."""
    import dataclasses

    from agplace_tpu_torch import ops
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.embed import batched_embed_q_crops
    from agplace_tpu_torch.evaluate import evaluate_features
    from agplace_tpu_torch.infer import compute_dtype, make_infer_fns

    ds = eval_dataset(cfg, N_TILES, N_EVAL_CROP_Q, crops=True)
    if not np.array_equal(ds.db_eastnorth,
                          eval_dataset(cfg, N_TILES, 1).db_eastnorth):
        raise AssertionError("the crop queries' world has other tiles")
    embed_q, _ = make_infer_fns(*towers)
    bs = cfg.train.infer_batch_size
    ops.reset_launches()  # ---- the path: one crop pass, two merges
    t0 = time.perf_counter()
    q = batched_embed_q_crops(ds, range(ds.queries_num), embed_q, bs, cfg,
                              dev)
    t_query = time.perf_counter() - t0
    results = {}
    for method in ("nearest_crop", "maj_voting"):
        c = cfg.replace(eval=dataclasses.replace(cfg.eval,
                                                 test_method=method))
        results[method] = evaluate_features(c, ds, q, db, device=dev)
    counts = ops.launches()  # ---- read just after the path
    want = expected_launches(cfg, 0, -(-ds.queries_num // bs))
    log(f"[eval-crops] {q.shape[0]} crop descriptors ({ds.queries_num} "
        f"queries x 5, batch {5 * bs}) in {t_query:.3f} s (host prep "
        f"included); launches {counts}")
    if counts != want or q.shape != (5 * ds.queries_num, 256):
        raise AssertionError(f"launch counts {counts} != {want}, or crop "
                             f"descriptors {q.shape}")
    for method, (recalls, text) in results.items():
        check_recalls(f"eval-crops {method}", recalls, text)
    crops = ds.load_query_crops(0, cfg.data.q_resize)
    pts = np.repeat(ds.load_query_points(0)[None], 5, axis=0)
    with torch.inference_mode():
        cpu = cpu_towers[0](torch.from_numpy(crops), prepare_query_vox(
            cfg, pts, "cpu", compute_dtype(cfg)))["embedding"]
    check_descriptors("eval-crops", "query 0's 5 crop rows", q[:5],
                      cpu.float().numpy())
    return counts


def phase_eval_fused(cfg, towers, cpu_towers, dev):
    """[eval-fused]: ``evaluate`` with the fused configuration's towers on
    128 tiles and 64 queries (K4 and K5 on the eval path), exact launch
    counts, 4 queries' and 4 tiles' descriptors of that run against the
    CPU."""
    ds = eval_dataset(cfg, N_TILES_FUSED, N_EVAL_FUSED_Q)
    bs = cfg.train.infer_batch_size
    recalls, text, counts, q, db, t_eval, _ = run_evaluate(cfg, ds, towers,
                                                           dev)
    want = expected_launches(cfg, ds.database_num, -(-ds.queries_num // bs))
    log(f"[eval-fused] evaluate(hard_resize) of {ds.queries_num} queries "
        f"over {ds.database_num} tiles in {t_eval:.3f} s; launches {counts}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    check_recalls("eval-fused", recalls, text)
    cq, cdb = cpu_descriptors(cfg, ds, cpu_towers, 4)
    check_descriptors("eval-fused", "descriptors of 4 queries", q[:4], cq)
    check_descriptors("eval-fused", "descriptors of 4 tiles", db[:4], cdb)
    return counts


# ------------------------------------------------------------ training
def phase_train_k1(dev):
    """[train-k1]: K1's autograd Function (the kernel forward, JAX's
    backward in torch ops) against autograd through ``euler_ode_plain``,
    both on the card, fp32, at B = 1, 16, 33, 128, relu and tanh; the
    device ms of forward plus backward of each (the profiler's,
    ``device_ms``).  Returns the record for the kernels line."""
    from agplace_tpu_torch.ops import ode_step

    rng = np.random.default_rng(7)
    rec = {"tol": TRAIN_K1_TOL, "by_case": {}}
    for act in ("relu", "tanh"):
        for b in (1, 16, 33, 128):
            x = torch.from_numpy(rng.standard_normal((b, 256)).astype(
                np.float32)).to(dev).requires_grad_()
            w = torch.from_numpy((rng.standard_normal((256, 256)) / 16)
                                 .astype(np.float32)).to(dev).requires_grad_()
            bias = torch.from_numpy(rng.normal(0, 0.1, 256).astype(
                np.float32)).to(dev).requires_grad_()
            g = torch.from_numpy(rng.standard_normal((b, 256)).astype(
                np.float32)).to(dev)

            def fwd_bwd(fn):
                y = fn(x, w, bias, 10, 0.1, act)
                return (y, *torch.autograd.grad(y, (x, w, bias), g))

            got = fwd_bwd(ode_step.euler_ode)
            want = fwd_bwd(ode_step.euler_ode_plain)
            errs = {}
            for name, a, e in zip(("y", "gx", "gw", "gb"), got, want):
                errs[name] = float((a - e).detach().abs().max()) / float(
                    e.detach().abs().max())
            ms = device_ms(lambda: fwd_bwd(ode_step.euler_ode), n=20)
            plain = device_ms(lambda: fwd_bwd(ode_step.euler_ode_plain),
                              n=20)
            ok = all(v <= TRAIN_K1_TOL for v in errs.values())
            log(f"[train-k1] B={b} {act}: max error over scale "
                + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
                + f" (tol {TRAIN_K1_TOL}); forward + backward device "
                f"{ms:.4f} ms, autograd through the plain version "
                f"{plain:.4f} ms {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[train-k1] B={b} {act}: the Function "
                                     f"disagrees with autograd")
            rec["by_case"][f"{act} b{b}"] = dict(errs, fwd_bwd_device_ms=ms,
                                                 plain_fwd_bwd_device_ms=plain)
    return rec


def train_world(cfg, n_db, n_q, seed):
    from agplace_tpu_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(n_db=n_db, n_q=n_q, image_size=IMAGE,
                            nmap=cfg.data.nmap, n_points=N_POINTS, seed=seed)


def train_cfg(**train_kw):
    """``kitti360_config()``: fp32 activations (the training default), no
    pretrained-weight source (random init from the seed)."""
    import dataclasses

    from agplace_tpu_torch import kitti360_config

    cfg = kitti360_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, pretrained=False),
        train=dataclasses.replace(cfg.train, **train_kw))


def _grads(state):
    return {n: (None if p.grad is None else p.grad.detach().float().cpu())
            for n, p in state.named_parameters()}


def _leaf_err(got, want, ref=None):
    scale = float((want if ref is None else ref).abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale > 0 else diff


def phase_train_step(dev):
    """[train-step]: one step at the full width of ``kitti360_config()``
    with 2 triplets of 2 negatives, on the card against the CPU (the
    kernels' plain versions) with the same weights and the same collated
    batch: the loss, every gradient leaf, the parameters after the update
    and the new BN statistics.  The BEV convs round to bf16, and a weight
    gradient of a conv before a train-mode BN is dominated by that
    rounding (the BN takes out the mean of the terms it sums), so each
    device also steps a twin with those convs in fp32, and the twins are
    held to each other with no allowance for noise (the module header's
    TRAIN_* constants).  Exact launch counts: K1 3, K2-K6 0."""
    from agplace_tpu_torch import ops
    from agplace_tpu_torch.data.base import collate_train
    from agplace_tpu_torch.data.pipeline import prefetch_to_device
    from agplace_tpu_torch.train.mining import TripletMiner
    from agplace_tpu_torch.train.step import init_state, make_train_step

    def fp32_bev(st):
        for m in st.mm.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float32
        return st

    cfg = train_cfg(train_batch_size=2, negs_num_per_query=2)
    ds = train_world(cfg, 64, 16, 0)
    rng = np.random.default_rng(3)
    rows = TripletMiner(cfg, ds, "cpu").mine_random(rng, 2)
    host = collate_train(ds, rows, cfg, rng)
    gpu = init_state(cfg, dev, seed=0)
    seed_bn(gpu.mm, np.random.default_rng(4))
    seed_bn(gpu.db, np.random.default_rng(5))
    copies = []
    for where in (dev, "cpu", "cpu"):
        st = init_state(cfg, where, seed=0)
        st.mm.load_state_dict(gpu.mm.state_dict())
        st.db.load_state_dict(gpu.db.state_dict())
        copies.append(st)
    gpu32, cpu16, cpu32 = copies
    fp32_bev(gpu32)
    fp32_bev(cpu32)
    step = make_train_step(cfg)
    (batch,) = prefetch_to_device([host], dev)
    ops.reset_launches()  # ---- the path: one step on the card
    t0 = time.perf_counter()
    m = step(gpu, batch)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    counts = ops.launches()  # ---- read just after the path
    m32 = step(gpu32, batch)
    (cpu_batch,) = prefetch_to_device([host], "cpu")
    t0 = time.perf_counter()
    m_cpu = [step(st, cpu_batch) for st in (cpu16, cpu32)]
    t_cpu = (time.perf_counter() - t0) / 2
    want = dict.fromkeys(counts, 0)
    want["fused_euler_ode"] = 3
    log(f"[train-step] one step on the card {t_step * 1e3:.1f} ms (the "
        f"first, unwarmed), on the CPU {t_cpu * 1e3:.1f} ms; launches "
        f"{counts}")
    if counts != want:
        raise AssertionError(f"[train-step] launch counts {counts} != {want}")
    for tag, a, c in (("", m, m_cpu[0]), (" (fp32 BEV convs)", m32,
                                          m_cpu[1])):
        loss, loss_cpu = float(a["loss"]), float(c["loss"])
        loss_err = abs(loss - loss_cpu) / abs(loss_cpu)
        log(f"[train-step] loss{tag} card {loss:.6f} CPU {loss_cpu:.6f}: "
            f"relative error {loss_err:.3g} (tol {TRAIN_LOSS_TOL})")
        if not (np.isfinite(loss) and loss_err <= TRAIN_LOSS_TOL):
            raise AssertionError("[train-step] loss disagrees with the CPU")
    g_gpu, g_cpu = _grads(gpu), _grads(cpu16)
    g_gpu32, g_cpu32 = _grads(gpu32), _grads(cpu32)
    floor = {}
    for name, c in g_cpu32.items():
        if c is not None:
            tower = name.split(".")[0]
            floor[tower] = max(floor.get(tower, 0.0), float(c.abs().max()))
    floor = {t: TRAIN_ZERO_REL * v for t, v in floor.items()}
    errs32, errs16, zero = [], [], []
    for name, c32 in g_cpu32.items():
        got = (g_gpu32[name], g_gpu[name], g_cpu[name])
        if c32 is None or any(g is None for g in got):
            if not (c32 is None and all(g is None for g in got)):
                raise AssertionError(f"[train-step] {name}: a gradient on "
                                     f"some runs only")
            continue
        a32, a16, c16 = got
        lim = floor[name.split(".")[0]]
        if float(c32.abs().max()) < lim:  # zero in exact arithmetic
            zero.append((max(float(a32.abs().max()),
                             float(a16.abs().max())) / lim, name))
            continue
        errs32.append((_leaf_err(a32, c32), name))
        noise = _leaf_err(c16, c32, c16)
        if noise <= TRAIN_NOISE_CAP:
            bound = TRAIN_GRAD_TOL + TRAIN_NOISE * noise
            errs16.append((_leaf_err(a16, c16) / bound, name))
    errs32.sort(reverse=True)
    errs16.sort(reverse=True)
    n32, n16 = len(errs32), len(errs16)
    log(f"[train-step] fp32 twins: {n32} gradient leaves, error over scale "
        f"median {errs32[n32 // 2][0]:.3g}, the worst "
        + ", ".join(f"{nm} {e:.3g}" for e, nm in errs32[:5])
        + f" (tol {TRAIN_FP32_TOL}); {len(zero)} zero in exact arithmetic, "
        f"on the card at most {max(zero)[0] if zero else 0:.3g} of the "
        f"floor ({TRAIN_ZERO_REL} of their tower's largest)")
    log(f"[train-step] as configured: {n16} of {n32} leaves with a CPU bf16 "
        f"noise <= {TRAIN_NOISE_CAP}, held within {TRAIN_GRAD_TOL} + "
        f"{TRAIN_NOISE} x that noise; closest to their bounds: "
        + ", ".join(f"{nm} {e:.3f}" for e, nm in errs16[:3]))
    if errs32[0][0] > TRAIN_FP32_TOL:
        raise AssertionError(f"[train-step] fp32-twin gradient of "
                             f"{errs32[0][1]}: error {errs32[0][0]:.3g} of "
                             f"scale > {TRAIN_FP32_TOL}")
    if zero and max(zero)[0] >= 1.0:
        raise AssertionError(f"[train-step] gradient of {max(zero)[1]}: "
                             f"zero on the CPU, not on the card")
    if errs16 and errs16[0][0] > 1.0:
        raise AssertionError(f"[train-step] gradient of {errs16[0][1]} "
                             f"outside its bound")
    if n16 < n32 // 2:
        raise AssertionError("[train-step] too few leaves held as "
                             "configured")
    # parameters where the gradient's sign and size are sure (Adam's first
    # step is about -lr * sign(g)), and the new BN statistics
    lr = gpu.opt.per_param(gpu.opt.lr)
    bad_p, sure, total, stat_err = 0, 0, 0, 0.0
    sd_gpu = {**{f"mm.{k}": v for k, v in gpu.mm.state_dict().items()},
              **{f"db.{k}": v for k, v in gpu.db.state_dict().items()}}
    sd_cpu = {**{f"mm.{k}": v for k, v in cpu16.mm.state_dict().items()},
              **{f"db.{k}": v for k, v in cpu16.db.state_dict().items()}}
    for name, t in sd_gpu.items():
        a, c = t.float().cpu(), sd_cpu[name].float()
        if name.endswith(("running_mean", "running_var")):
            stat_err = max(stat_err, _leaf_err(a, c))
        elif name in lr:
            g, gc = g_gpu[name], g_cpu[name]
            if g is None:
                continue
            ok = (gc.abs() > 1e-6) & ((g - gc).abs() < 1e-2 * gc.abs())
            sure += int(ok.sum())
            total += ok.numel()
            tol = 5e-2 * lr[name].cpu() + 1e-6
            bad_p += int(((a - c).abs() > tol)[ok].sum())
    log(f"[train-step] parameters after the update: {bad_p} of {sure} "
        f"compared elements ({sure / total:.3f} of the trained ones, where "
        f"the gradient is sure) off by more than 5 % of their learning "
        f"rate; BN statistics max error {stat_err:.3g} of scale (tol "
        f"{TRAIN_STATS_TOL})")
    if bad_p or sure < 0.3 * total or stat_err > TRAIN_STATS_TOL:
        raise AssertionError("[train-step] the update or the statistics "
                             "disagree with the CPU")
    return counts


def _step_recorder(train_mod, n_steps, rec):
    """Wrap ``make_train_step`` as ``train`` imports it: each call's start
    on the host clock, a sync before the last step, whose device work
    runs under the profiler, and a sync after it (the loop fetches the
    round's losses there anyway)."""
    from torch.profiler import ProfilerActivity, profile

    real = train_mod.make_train_step

    def make(cfg):
        step = real(cfg)

        def timed(state, batch):
            rec["starts"].append(time.perf_counter())
            if len(rec["starts"]) < n_steps:
                return step(state, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = step(state, batch)
                torch.cuda.synchronize()
            rec["profiled_wall_s"] = time.perf_counter() - t0
            rec["prof"] = prof
            return out
        return timed
    return make


def phase_train(dev):
    """[train]: ``train()`` at the preset's full batch (16 triplets of 10
    negatives: 16 queries and 176 aerial tiles per step), partial_sep
    mining over a 128-tile, 128-query world, one round of 96 queries (6
    steps), one epoch, evaluation on 64 tiles and 32 queries of the next
    seed, a checkpoint, then a restore and ``PlaceIndex.from_checkpoint``
    answering one request."""
    import shutil

    from agplace_tpu_torch import ops
    from agplace_tpu_torch.serving import PlaceIndex
    from agplace_tpu_torch.train import loop
    from agplace_tpu_torch.train.checkpoint import CheckpointManager
    from agplace_tpu_torch.train.mining import TripletMiner
    from agplace_tpu_torch.train.step import init_state

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    from profile_torch_mm import classify

    save_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "_runs", "chip_smoke_train")
    shutil.rmtree(save_dir, ignore_errors=True)
    cfg = train_cfg(queries_per_epoch=96, cache_refresh_rate=96,
                    neg_samples_num=128, epochs_num=1,
                    checkpoint_after_epoch=-1, save_dir=save_dir)
    n_steps = 96 // cfg.train.train_batch_size
    train_ds = train_world(cfg, 128, 128, 0)
    test_ds = train_world(cfg, 64, 32, 1)

    # launch counts of the mining and evaluation passes, read around them
    parts = {"mining": dict.fromkeys(ops.launches(), 0),
             "eval": dict.fromkeys(ops.launches(), 0)}

    def counted(fn, part):
        def call(*a, **kw):
            before = ops.launches()
            out = fn(*a, **kw)
            for k, v in ops.launches().items():
                parts[part][k] += v - before[k]
            return out
        return call

    rec = {"starts": []}
    real = (TripletMiner.mine, loop.evaluate, loop.make_train_step)
    TripletMiner.mine = counted(TripletMiner.mine, "mining")
    loop.evaluate = counted(loop.evaluate, "eval")
    loop.make_train_step = _step_recorder(loop, n_steps, rec)
    torch.cuda.reset_peak_memory_stats()
    try:
        ops.reset_launches()  # ---- the path: train()
        t0 = time.perf_counter()
        out = loop.train(cfg, train_ds, test_ds, device=dev)
        t_train = time.perf_counter() - t0
        counts = ops.launches()  # ---- read just after the path
    finally:
        TripletMiner.mine, loop.evaluate, loop.make_train_step = real
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = out["history"][0]
    losses = hist["losses"]
    steps = {k: counts[k] - parts["mining"][k] - parts["eval"][k]
             for k in counts}
    log(f"[train] train() in {t_train:.2f} s: {out['state'].step} steps "
        f"of 16 x (2 + 10); phases {json.dumps(out['phase_times'])}; "
        f"peak device memory {peak:.2f} GiB")
    log(f"[train] launches: all {counts}; mining {parts['mining']}; "
        f"steps {steps}; evaluation {parts['eval']}")
    log(f"[train] losses {losses}; recalls {hist['recalls'].tolist()}")
    starts = rec["starts"]
    walls = [(b - a) * 1e3 for a, b in zip(starts[1:], starts[2:])]
    log(f"[train] step wall ms (host clock between step starts, steps 2-"
        f"{n_steps - 1}): median {statistics.median(walls):.1f}, min "
        f"{min(walls):.1f}, max {max(walls):.1f} = "
        f"{16e3 / statistics.median(walls):.2f} triplets/s")
    by_class = {}
    for evt in rec["prof"].key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            key = classify(evt.key)
            by_class[key] = by_class.get(key, 0.0) + \
                evt.self_device_time_total / 1e3
    dev_ms = sum(by_class.values())
    wall_ms = rec["profiled_wall_s"] * 1e3
    log(f"[train] the last step alone under the profiler (synchronised "
        f"before and after, batch already on the card): wall {wall_ms:.1f} "
        f"ms, device {dev_ms:.1f} ms, busy {dev_ms / wall_ms:.3f}; device "
        f"ms by class " + json.dumps({k: round(v, 3) for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])}))
    want_steps = dict.fromkeys(counts, 0)
    want_steps["fused_euler_ode"] = 3 * n_steps
    if (out["state"].step != n_steps or len(losses) != n_steps
            or not np.isfinite(losses).all()):
        raise AssertionError(f"[train] steps {out['state'].step}, losses "
                             f"{losses}")
    if steps != want_steps:
        raise AssertionError(f"[train] the steps' launches {steps} != "
                             f"{want_steps}")
    if not all(parts["mining"][k] and parts["eval"][k] for k in
               ("fused_euler_ode", "fused_conv0_down0",
                "fused_eca_block_sm")):
        raise AssertionError("[train] an eval kernel did not run in mining "
                             "or evaluation")
    check_recalls("train", hist["recalls"], "evaluation after the epoch")

    ckpt = CheckpointManager(save_dir)
    name = ckpt.latest()
    restored, meta = ckpt.restore(name, init_state(cfg, dev, seed=123))
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        out["state"].named_parameters(), restored.named_parameters()))
    log(f"[train] checkpoint {name} ({os.path.getsize(os.path.join(save_dir, name)) / 2 ** 20:.0f} MiB) restored: "
        f"parameters equal {same}, epoch {meta['epoch_num']}")
    if not same:
        raise AssertionError("[train] the restored parameters differ")
    idx = PlaceIndex.from_checkpoint(cfg, save_dir, "best_model", dev)
    idx.add_tiles(test_ds)
    d, i = idx.search(test_ds.load_query_image(0)[None],
                      test_ds.load_query_points(0)[None], k=5)
    log(f"[train] from_checkpoint: {idx._n_rows} tiles, one request "
        f"-> top-5 {i[0].tolist()}")
    if not (np.isfinite(d).all() and ((i >= 0) & (i < 64)).all()):
        raise AssertionError("[train] from_checkpoint answered badly")
    shutil.rmtree(save_dir, ignore_errors=True)
    return counts


def main() -> None:
    import dataclasses

    # the port first: outside a checkout of the repository this fails
    # before anything is printed
    from agplace_tpu_torch import kitti360_config, synthetic_config
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.sparse.bev_grid import mask_down

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this smoke needs an NVIDIA GPU")
    name = card()
    log(name)
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    phase_build()

    cfg = kitti360_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bfloat16"))
    rng = np.random.default_rng(42)
    masks = {}
    for bsz in (32, 128):
        masks[bsz] = [prepare_query_vox(cfg, lidar(rng, bsz), dev).mask]
        for pz in ((0, 0), (1, 1), (1, 1)):  # ME z pairing at z=4, then 2
            masks[bsz].append(mask_down(masks[bsz][-1], (0, 0), (0, 0), pz))
    mask16 = prepare_query_vox(synthetic_config(), lidar(rng, 32), dev).mask
    log("[parity] kernel vs plain on the card (b32 main-path shapes)")
    with torch.inference_mode():
        parity = phase_parity(dev, masks[32], masks[128], mask16)

    # ---- the default path: K1, K2, K3
    towers, cpu_towers, requests, counts = phase_serving(cfg, dev, N_TILES,
                                                         "serving")
    (mm, _), (cpu_mm, _) = towers, cpu_towers
    phase_slice_parity(cfg, mm, cpu_mm, requests, dev, "slice")
    # ---- the fused-stem / fused-head path: K1, K3, K4, K5
    mc = dataclasses.replace(cfg.model.mm, bev_pallas_head=True,
                             stem_pallas=True)
    dc = dataclasses.replace(cfg.model.db, stem_pallas=True)
    cfg_f = cfg.replace(model=dataclasses.replace(cfg.model, mm=mc, db=dc))
    towers_f, cpu_towers_f, requests_f, counts_f = phase_serving(
        cfg_f, dev, N_TILES_FUSED, "serving-fused")
    (mm_f, _), (cpu_mm_f, _) = towers_f, cpu_towers_f
    phase_slice_parity(cfg_f, mm_f, cpu_mm_f, requests_f, dev,
                       "slice-fused")
    # ---- nuScenes with the fused head at its full grid: K1, K3, K4
    counts_n = phase_nuscenes_fused(dev)
    # ---- the evaluation path: default (K1, K2, K3), crops, fused (K4, K5)
    counts_e, db_feats = phase_eval(cfg, towers, cpu_towers, dev)
    counts_c = phase_eval_crops(cfg, towers, cpu_towers, db_feats, dev)
    counts_ef = phase_eval_fused(cfg_f, towers_f, cpu_towers_f, dev)
    phase_timing(cfg, {"default": mm, "fused": mm_f}, dev, name)
    # ---- the probe entry points: P2 vs K2, P1 vs K3
    with torch.inference_mode():
        counts_p, down, blocks = phase_probe(dev)
    parity["fused_down_concat"]["probe_ab"] = {
        k: down[k] for k in ("v1_shipped", "v2_concat")}
    parity["fused_eca_block_concat"]["probe_ab"] = {
        r["chunk"]: {k: r[k] for k in ("v1_shipped", "v2_concat")}
        for r in blocks}
    # ---- training: K1's Function, one step against the CPU, train()
    parity["fused_euler_ode"]["train_k1"] = phase_train_k1(dev)
    counts_ts = phase_train_step(dev)
    counts_t = phase_train(dev)

    sources = {
        "fused_euler_ode": ("agplace_tpu_torch/csrc/ode_step.cu",
                            "agplace_tpu/ops/pallas/ode_step.py:70"),
        "fused_conv0_down0": ("agplace_tpu_torch/csrc/bev_down.cu",
                              "agplace_tpu/ops/pallas/bev_down.py:108"),
        "fused_eca_block_sm": ("agplace_tpu_torch/csrc/conv3x3_sm90.cu",
                               "agplace_tpu/ops/pallas/bev_block_sm.py:175"),
        "fused_head": ("agplace_tpu_torch/csrc/bev_head.cu",
                       "agplace_tpu/ops/pallas/bev_head.py:166"),
        "fused_affine_relu_maxpool": ("agplace_tpu_torch/csrc/stem_pool.cu",
                                      "agplace_tpu/ops/pallas/stem_pool.py:"
                                      "109"),
        "fused_eca_block": ("agplace_tpu_torch/csrc/bev_block.cu",
                            "agplace_tpu/ops/pallas/bev_block.py:127"),
        "fused_eca_block_concat": (
            "agplace_tpu_torch/csrc/probe_block_sm_v2.cu",
            "scripts/probe_block_sm_v2.py:178"),
        "fused_down_concat": ("agplace_tpu_torch/csrc/probe_down_v2.cu",
                              "scripts/probe_down_v2.py:143"),
    }
    kernels = [dict({"name": k, "route": "cuda", "source": src,
                     "replaces": rep,
                     "launches": (counts[k] + counts_f[k] + counts_n[k]
                                  + counts_p[k] + counts_e[k] + counts_c[k]
                                  + counts_ef[k] + counts_ts[k]
                                  + counts_t[k]),
                     "launches_by_path": {"default": counts[k],
                                          "fused": counts_f[k],
                                          "nuscenes_fused": counts_n[k],
                                          "probe": counts_p[k],
                                          "eval": counts_e[k],
                                          "eval_crops": counts_c[k],
                                          "eval_fused": counts_ef[k],
                                          "train_step": counts_ts[k],
                                          "train": counts_t[k]},
                     "max_abs_err": parity[k]["max_abs_err"],
                     "frac_differ": parity[k]["frac_differ"],
                     "ms": parity[k]["ms"],
                     "plain_ms": parity[k]["plain_ms"],
                     "bound_ms": parity[k]["bound_ms"],
                     "bound_by": parity[k]["bound_by"],
                     "library_ms": parity[k]["library_ms"]},
                    **{x: parity[k][x] for x in RECORD_KEYS
                       if x in parity[k]})
               for k, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
