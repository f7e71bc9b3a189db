"""Bring-up smoke of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (``agplace_tpu_torch.serving.PlaceIndex`` on
``kitti360_config()`` in bf16, full width, seeded random weights) on the
card and checks every hand-written kernel of that path:

1. device check (raises without CUDA) and the card's name / power limit;
2. kernel build from ``agplace_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernel parity: each kernel against its plain PyTorch version on the card
   at every slice shape, with CUDA-event timings of both (median of 20);
4. serving: a 512-tile aerial gallery, three search requests (1, 7 and 32
   queries, k=5), output checks, launch counts of the main path (3 x K1,
   1 x K2, 4 x K3 per MM forward), and a planted top-1 hit;
5. slice parity: 4 query embeddings on the card vs the same module and
   weights on the CPU (plain versions);
6. timing: MM forward at batch 32 and 128 (synchronised latency and
   back-to-back throughput).

Every phase raises on failure.  The second-to-last line is the per-kernel
JSON record, the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

IMAGE = 256
N_TILES = 512
N_POINTS = 30000
# |kernel - plain| <= atol * max|plain| + rtol * |plain| elementwise, and
# the mean error <= mean_tol * max|plain|.
K1_TOL = dict(rtol=1e-4, atol=1e-5, mean=1e-6)  # fp32, summation order only
# bf16: kernel and plain round at the same points, but the conv
# accumulation order differs (wmma tiles vs cuDNN), so isolated 1-ulp bf16
# flips remain; in the residual add relu(g*att + r) such a flip of a large
# g lands on a small output (cancellation), hence the scale-relative atol.
# A systematic error would show in the mean, which must stay tiny.
KBF16_TOL = dict(rtol=2e-2, atol=1e-2, mean=1e-4)
# GPU (kernels, cuDNN bf16) vs CPU (plain versions) embeddings: bf16 flips
# propagate through ~30 layers; bound the error by the embedding's scale
SLICE_TOL = 5e-2


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


def compare(name, got, want, tol) -> dict:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = float(want.abs().max())
    bad = int((err > tol["atol"] * scale + tol["rtol"] * want.abs()).sum())
    ok = (bad == 0 and float(err.mean()) <= tol["mean"] * scale
          and bool(torch.isfinite(got).all()))
    rec = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
           "ok": ok}
    log(f"  {name}: max_abs_err={rec['max_abs_err']:.3g} "
        f"mean_abs_err={rec['mean_abs_err']:.3g} scale={scale:.3g} "
        f"outside_tol={bad} tol={tol} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
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


def phase_parity(dev, masks):
    """Each kernel vs its plain version at the slice shapes (b32)."""
    from agplace_tpu_torch.ops import bev_block_sm, bev_down, ode_step
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
    # K1: x [32, 256] fp32, 10 Euler steps; relu (the slice) and tanh
    x = randn(32, 256)
    w, b = randn(256, 256, std=1 / 16), randn(256, std=0.1)
    k1 = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    for act in ("relu", "tanh"):
        args = (x, w, b, 10, 0.1, act)
        rec = compare(f"K1 fused_euler_ode {act} [32,256]",
                      ode_step.fused_euler_ode(*args),
                      ode_step.euler_ode_plain(*args), K1_TOL)
        ms = cuda_ms(lambda: ode_step.fused_euler_ode(*args))
        pms = cuda_ms(lambda: ode_step.euler_ode_plain(*args))
        log(f"  K1 {act}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
        if act == "relu":
            k1.update(ms=ms, plain_ms=pms)
        k1["max_abs_err"] = max(k1["max_abs_err"], rec["max_abs_err"])
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
                  out, ref, KBF16_TOL)
    rec["ms"] = cuda_ms(lambda: bev_down.fused_conv0_down0(*args, z=z0))
    rec["plain_ms"] = cuda_ms(lambda: bev_down.conv0_down0_plain(*args,
                                                                 z=z0))
    log(f"  K2: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms "
        f"(both include the cuDNN conv0)")
    results["fused_conv0_down0"] = rec

    # K3 at the four slice shapes (z = 2 after down0)
    k3 = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    for mask, cin, c, name in ((masks[1], 64, 64, "block0_0"),
                               (masks[2], 64, 128, "block1_0"),
                               (masks[3], 128, 256, "block2_0"),
                               (masks[3], 256, 256, "ffn_vox_0")):
        z = 2
        bsz, xy = mask.shape[0], mask.shape[1]
        xin = randn(bsz, xy, xy, z, cin).to(torch.bfloat16)
        xin = torch.where(mask[..., None], xin, 0).reshape(bsz, xy, xy,
                                                           z * cin)
        k_eca = 3 if c == 64 else 5
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
                *affine(c, z), *affine(c, z), randn(k_eca))
        shape = f"[{bsz},{xy},{xy},{z * cin}]->{z * c}"
        rec = compare(f"K3 fused_eca_block_sm {name} {shape}",
                      bev_block_sm.fused_eca_block_sm(*args, z=z, **kw),
                      bev_block_sm.eca_block_plain(*args, z=z, **kw),
                      KBF16_TOL)
        ms = cuda_ms(lambda: bev_block_sm.fused_eca_block_sm(*args, z=z,
                                                             **kw))
        pms = cuda_ms(lambda: bev_block_sm.eca_block_plain(*args, z=z,
                                                           **kw))
        log(f"  K3 {name}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
        k3["ms"] += ms
        k3["plain_ms"] += pms
        k3["max_abs_err"] = max(k3["max_abs_err"], rec["max_abs_err"])
    results["fused_eca_block_sm"] = k3
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


def phase_serving(cfg, dev):
    from agplace_tpu_torch import ops
    from agplace_tpu_torch.infer import build_towers
    from agplace_tpu_torch.serving import PlaceIndex

    mm, db = build_towers(cfg, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    seed_bn(mm, rng)
    seed_bn(db, rng)
    cpu_mm = copy.deepcopy(mm)
    idx = PlaceIndex(cfg, (mm.to(dev), db.to(dev)))

    requests = []
    for n in (1, 7, 32):
        requests.append((rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(
            np.float32), lidar(rng, n)))

    ops.reset_launches()  # ---- the main path: gallery + three requests
    t0 = time.perf_counter()
    n_rows = idx.add_tiles(Tiles(N_TILES))
    torch.cuda.synchronize()
    t_gallery = time.perf_counter() - t0
    answers = []
    t0 = time.perf_counter()
    for images, points in requests:
        answers.append(idx.search(images, points, k=5))
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    counts = ops.launches()  # ---- read just after the main path
    log(f"[serving] gallery {n_rows} tiles in {t_gallery:.2f} s; 3 requests "
        f"in {t_search:.2f} s (host prep included); launches {counts}")
    if n_rows != N_TILES:
        raise AssertionError(f"gallery holds {n_rows} rows")
    for (images, _), (d, i) in zip(requests, answers):
        n = images.shape[0]
        if d.shape != (n, 5) or i.shape != (n, 5):
            raise AssertionError(f"search shapes {d.shape} {i.shape}")
        if not (np.isfinite(d).all() and ((i >= 0) & (i < N_TILES)).all()):
            raise AssertionError("non-finite distances or bad indices")
    forwards = len(requests)  # each request fits one padded batch of 32
    want = {"fused_euler_ode": 3 * forwards, "fused_conv0_down0": forwards,
            "fused_eca_block_sm": 4 * forwards}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")

    images, points = requests[1]
    q = idx.embed(images[:1], points[:1])
    planted = idx.add_descriptors(q) - 1
    d, i = idx.search(images[:1], points[:1], k=5)
    log(f"[serving] planted row {planted}: top-1 {i[0, 0]} d={d[0, 0]:.3g}")
    if i[0, 0] != planted:
        raise AssertionError("planted descriptor is not the top-1 hit")
    return mm, cpu_mm, requests, counts


def phase_slice_parity(cfg, mm, cpu_mm, requests, dev):
    from agplace_tpu_torch.data.voxels import prepare_query_vox

    images, points = requests[2]
    images, points = images[:4], points[:4]
    with torch.inference_mode():
        gpu = mm(torch.from_numpy(images).to(dev),
                 prepare_query_vox(cfg, points, dev))["embedding"].cpu()
        cpu = cpu_mm(torch.from_numpy(images),
                     prepare_query_vox(cfg, points))["embedding"]
    err = float((gpu - cpu).abs().max())
    scale = float(cpu.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(gpu, cpu).min())
    ok = bool(torch.isfinite(gpu).all()) and err <= SLICE_TOL * scale
    log(f"[slice] GPU vs CPU embedding (4 queries): max_abs_err={err:.4g} "
        f"(scale {scale:.4g}, tol {SLICE_TOL} x scale), min cosine "
        f"{cos:.6f} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("GPU embedding disagrees with the CPU run")


def phase_timing(cfg, mm, dev, name):
    from agplace_tpu_torch.data.voxels import prepare_query_vox

    rng = np.random.default_rng(5)
    for bsz in (32, 128):
        images = torch.from_numpy(rng.standard_normal(
            (bsz, IMAGE, IMAGE, 3)).astype(np.float32)).to(dev)
        vox = prepare_query_vox(cfg, lidar(rng, bsz), dev)
        def back_to_back():
            for _ in range(10):
                mm(images, vox)

        with torch.inference_mode():
            # latency: one forward, synchronised, median of 10
            ms = cuda_ms(lambda: mm(images, vox), warmup=3, iters=10)
            # throughput: 10 forwards queued back to back, so the host's
            # launch work overlaps the device's; median of 5 such runs
            tput_ms = cuda_ms(back_to_back, warmup=1, iters=5) / 10
        log(f"[timing] MM forward b{bsz}: latency {ms:.3f} ms; "
            f"back-to-back {tput_ms:.3f} ms/forward = "
            f"{bsz / tput_ms * 1e3:.1f} desc/s ({name})")


def main() -> None:
    import dataclasses

    # the port first: outside a checkout of the repository this fails
    # before anything is printed
    from agplace_tpu_torch import kitti360_config
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
    m = prepare_query_vox(cfg, lidar(rng, 32), dev).mask
    masks = [m]
    for pz in ((0, 0), (1, 1), (1, 1)):  # ME z pairing at z=4, then z=2
        masks.append(mask_down(masks[-1], (0, 0), (0, 0), pz))
    log("[parity] kernel vs plain on the card (b32 slice shapes)")
    with torch.inference_mode():
        parity = phase_parity(dev, masks)

    mm, cpu_mm, requests, counts = phase_serving(cfg, dev)
    phase_slice_parity(cfg, mm, cpu_mm, requests, dev)
    phase_timing(cfg, mm, dev, name)

    sources = {
        "fused_euler_ode": ("agplace_tpu_torch/csrc/ode_step.cu",
                            "agplace_tpu/ops/pallas/ode_step.py:70"),
        "fused_conv0_down0": ("agplace_tpu_torch/csrc/bev_down.cu",
                              "agplace_tpu/ops/pallas/bev_down.py:108"),
        "fused_eca_block_sm": ("agplace_tpu_torch/csrc/bev_block_sm.cu",
                               "agplace_tpu/ops/pallas/bev_block_sm.py:175"),
    }
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[k],
                "max_abs_err": parity[k]["max_abs_err"],
                "ms": parity[k]["ms"], "plain_ms": parity[k]["plain_ms"]}
               for k, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
