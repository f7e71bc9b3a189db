"""Bring-up smoke of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two serving paths (``agplace_tpu_torch.serving.PlaceIndex``
on ``kitti360_config()`` in bf16, full width, seeded random weights), its
evaluation path (``agplace_tpu_torch.evaluate``: Recall@N of a synthetic
world, with the same towers), its training path
(``agplace_tpu_torch.train.loop.train`` on ``kitti360_config()`` in fp32),
the int8 and HTTP serving, the KITTI-360-AG and nuScenes-AG readers on
seeded trees, the ``serve`` / ``test`` entry points, and the MM's option
tail (the dense and sparse voxel backends, the midpoint / rk4 / dopri5
integrators, the FPN's top-down pass and blocks, the fusion options, the
graph-ODE and SDE / CDE library, sparse training), the model families
(GeoLoc, MinkLoc, the other image branches), pretrained-backbone grafts,
AnyLoc, the metric losses, the folder dataset and the whole flag front
end on the card and checks every hand-written kernel of the port:

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
    Checkpoints go to ``_runs/`` (git-ignored) and are removed after;
12. [serve-int8] a gallery of 1,048,576 seeded unit rows, 32 queries at
    k = 5: the int8 path's int32 cross term, quantized queries and top-64
    candidates (approximate distances bit-equal) on the card equal the
    CPU's on a 4,096-row slice; its final (d, i) equal the fp32 path's on every
    query without an audit miss; ms per search and peak device memory of
    both galleries, ``upload_count``, ``audit_stats`` at ``audit_rate`` 1;
    [serve-http] two in-process HTTP nodes of 65,536 rows each behind
    ``ShardedSearchClient``: the merge equals the flat index; ms per
    request;
13. [data-kitti360] a KITTI-360-AG tree written under ``_runs/``
    (``scripts/write_torch_trees.py``: 2 drives of 80 frames 1 m apart,
    1198 x 320 PNG queries, 320 x 320 tiles, 30,000-point clouds):
    ``train()`` at ``kitti360_config()`` for 2 steps on its reader and the
    evaluation after it (exact step launches, K1-K3 in mining and
    evaluation), the reader's host ms per batch on one thread and through
    the ``Prefetcher``'s threads; [data-kitti360-fused] the
    fused towers at the real aspect (256 x 958 queries) against the CPU
    (K4; K5 in the aerial tower, and in the MM only at an even stem map);
14. [data-nuscenes] a nuScenes-AG tree (cached index, six 455 x 256 JPEG
    cameras, 64 samples and tiles) and ``evaluate`` at
    ``nuscenes_config()``: exact launch counts (K2 at z = 8), 2 queries and
    tiles against the CPU;
15. [serve-cli] ``python -m agplace_tpu_torch.serve build``, then at once
    ``serve search --resume``, ``serve search --queries --quant int8``,
    ``serve http`` with a fan-out ``serve search`` and ``test --resume``,
    as subprocesses on the card on [data-kitti360]'s checkpoint: each
    exits 0 and answers as the in-process index (their launches are not
    counted).  The whole wall time is logged.

16. [mm-backends] the MM at b32 on the ``dense`` and ``sparse`` voxel
    backends beside ``bev`` (one set of weights, the sparse backend's
    reshaped), on LiDAR clouds cropped to the grid extent: exact launch
    counts (bev: K1 3, K2 1, K3 4; dense and sparse: K1 3 only), each
    backend against its CPU run and against the card's bev MM, ms per
    forward (CUDA events, median of 20) and peak device memory of each;
17. [mm-ode] the MM at b32 with ``odeint_method`` midpoint, rk4 and dopri5
    beside Euler: K1 0 times, each against its CPU run, dopri5's accepted
    steps per FCODE equal on the card and the CPU, ms per forward of each;
18. [mm-options] at b8: ``voxfe_ntd`` 1 and 2 and the basic / ASPP /
    ConvNeXt blocks on each backend, ``drop`` image / pc (on the BEV grid
    and the sparse voxels), ``final_fusetype`` cat / catadd, ``addorg``,
    ``stg2_useproj=False``: exact launch counts and each against its CPU
    run (``num_top_down`` = 3 is refused, as JAX's FPNs fail there);
19. [ode-lib] QKVAttention and BeltramiODE on the stage-2 image tokens
    [32, 256, 256] (and with repeated tokens: top-k ties), the top-k tie
    order, ``odeint_adjoint``'s gradients against direct backprop,
    ``sdeint_euler`` at sigma = 0 against Euler, ``cdeint`` euler / rk4:
    card against CPU;
20. [sync-free] ``quantize``, ``sort_by_key``, ``downsample_coords``,
    ``build_neighbor_table`` and a dopri5 FCODE under
    ``torch.cuda.set_sync_debug_mode("error")``; ``quantize`` equals the
    host voxelizer;
21. [train-sparse] ``train()`` at 16 x (2 + 10), fp32, 2 steps on the
    sparse backend with rk4: finite losses, parameters moved, no kernel
    launched by the steps, step wall time, peak device memory;
22. [geoloc] the headline GeoLoc (ResNet-50 conv4 + NetVLAD x 64,
    65,536-d, fp32 as JAX's factory builds it) as both towers behind a
    ``PlaceIndex`` of 512 tiles, requests of 1, 7 and 32 queries, a
    planted top-1 hit, zero launches, 2 queries and 2 tiles against the
    CPU, ms per forward and peak memory at b32 and b128;
23. [geoloc-train] ``train()`` with those towers at 16 x (2 + 10): the
    dataset NetVLAD init on the card (its k-means against the CPU's from
    the same rows), 4 steps, finite losses, parameters moved, zero
    launches, step wall time, peak memory; ``PlaceIndex.from_checkpoint``
    answers one request;
24. [geoloc-families] every other backbone and head at b8 (ViT-B/16 and
    CCT-14 at full depth, CCT's products in the run's bf16): zero
    launches, 2 images against the CPU, ms per forward;
25. [mm-imgfe] the MM beside a ResNet-50 DBVanilla2D behind a 512-tile
    ``PlaceIndex``, default and fused (exact launch counts, K5 on the
    ResNet-50 stem), against the CPU, ms per aerial forward beside
    ResNet-18's; the squeezenet11 MM and the convnext_tiny /
    squeezenet11 aerial towers at b8;
26. [minkloc] MinkLoc and MinkLocMultimodal at b32 on the cropped clouds:
    zero launches, 2 samples against the CPU, ms per forward;
    [family-cli] (run before [serve-cli], on [data-kitti360]'s tree)
    ``train --modelq geoloc --modeldb geoloc --backbone resnet50conv4
    --aggregation netvlad`` for 2 steps, then ``serve build`` and ``serve
    search --resume`` as subprocesses: each exits 0 and the search
    answers as the in-process index;
27. [pretrained] seeded torchvision-layout ResNet-18 / ResNet-50 and an
    HF-layout ViT-B/16 (``scripts/write_torch_weights.py``) in a
    temporary directory outside the tree, reached through
    ``--pretrained_path``: ``init_state`` of ``kitti360_config()`` on the
    card grafts the MM's and the aerial tower's ResNet-18 branches, every
    grafted leaf bit-equal to the file's tensor; ``train()`` 2 steps at
    16 x (2 + 10), fp32, from them (finite losses, step wall time, peak
    memory); one b32 MM + aerial forward of the grafted towers in the
    default and the fused configurations: exact launch counts, each
    launch of K1-K5 held to its plain version on the same inputs with
    [parity]'s tolerances (``held_to_plain``), the embeddings to the CPU;
    GeoLoc with ``resnet50conv4`` + NetVLAD and ``vit`` at 256 px
    grafted on both towers (ViT's table resized to 257 tokens, its CLS
    row kept, every kept layer bit-equal) and one b8 forward each;
28. [anyloc] ``DinoV2ExtractFeatures`` at JAX's default widths (ViT-B/14,
    768 / 12 / 12), 224 px, b32, facet value at layer 11: ms per forward,
    4 images against the CPU (ANYLOC_TOL); ``VLAD(32, hard, cosine)``
    fitted on the card on 64 images' patch descriptors (16,384 x 768),
    its k-means against the CPU's from the same rows (the first step's
    distances within KMEANS_TOL, its assignments parted only at near
    ties; the card's objective within VLAD_OBJ_TOL of the CPU's float32
    and float64 fits); the VLADs of 64 database and 32 query images
    (noisy copies; query 0 an exact one) against the CPU's on the same
    centres (VLAD_TOL, labels parted only at near ties) and through
    ``get_top_k_recall``: query 0 top-1; one b8 forward at ViT-g/14's
    widths (1536, 40 blocks, 24 heads, layer 31, GELU MLP as JAX builds
    it): ms and peak memory;
29. [tail] ``batch_hard_triplet_loss`` at N = 1024, 256-d, value and
    gradient against the CPU (METRIC_TOL, METRIC_GRAD_TOL); ``get_flops``
    of the b32 MM forward (the convs and matmuls PyTorch dispatches: the
    hand-written kernels are not counted) beside the CPU's plain path at
    b4; a seeded folder tree (``write_torch_trees.folder_tree``: 64 JPEG
    tiles, 32 queries) through ``FolderDataset`` and ``evaluate`` with
    GeoLoc towers on the card: recalls sane, zero launches, 2 queries
    against the CPU;
30. [flags] ``python -m agplace_tpu_torch.train`` as a subprocess on the
    card for 1 step with ``--odeint_method dopri5 --odeint_rtol 1e-3
    --odeint_atol 1e-3 --dopri5_max_steps 16 --horizontal_flip true
    --patience 3``: exit 0, a finite loss, each flag in its field;
31. [widths] K1-K4 off the preset widths: one MM forward of each of five
    configurations of ``kitti360_config()`` at full width (256 px, 128 x
    128 x z, bf16): W1 (b32) ``--vox_grid_extent 128 128 5`` with a
    1024-wide fusion (ResNet-50 image branch, voxel planes 64 128 1024:
    K1's grid instance), W2 (b32) the fused route at z = 6 with voxel
    planes 24 128 and a 128-wide fusion (K4's window+zband), W3 (b8) z =
    32, W4 (b4) z = 72, W5 (b4) the fused route at z = 40
    (``WIDTHS_CONFIGS``); each inside ``held_to_plain`` (every K1-K5
    launch compared with its plain version at its own shapes, none
    missed), exact launch counts, the launches of each instance
    (``ops.instance_launches``) against the rules' replay on the CPU, one
    query against the CPU run (SLICE_TOL), and each instance no preset
    runs timed alone on its first launch's arguments (CUDA events, median
    of 20; K1 and K4's window conv0 also by the profiler) beside its plain
    version, its bound and cuDNN's convs where they compute a product of
    it; then [widths lone], each launch counted and held to its plain
    version: K3 at z = 20, C = 212 and K1 at D = 1024, 1536, 2048 (grid)
    and 3072 (wide), b32.  Each instance [widths] launched gets a row of
    its own in the kernels line (``instance_rows``);
32. [multi-gpu] the multi-GPU layer (``agplace_tpu_torch/parallel``,
    ``retrieval/sharded.py``) in processes of its own, this script run
    as ``chip_smoke.py --multi-gpu-rank ...``: one rank over NCCL
    (``RANK=0 WORLD_SIZE=1``: ``bootstrap``, ``make_mesh``'s explicit
    1 x 1 mesh, ``sharded_l2_topk`` against ``l2_topk``, one all-reduce),
    and two ranks over gloo sharing ``cuda:0`` (NCCL refuses two ranks on
    one card) held to the single-device runs of this process: one
    data-parallel train step at 16 x (1 + 1 + 10), fp32 twin, split 8 + 8
    (loss rtol 1e-4 / atol 1e-5, parameters atol 5e-4, BN running
    statistics 1e-4: JAX's ``tests/test_parallel.py`` tolerances; the
    applied gradient within MG_GRAD_TOL of its largest element); the
    data-parallel embeds of 512 tiles and 256 queries (MG_EMBED_TOL of
    scale) and ``evaluate`` with a data and a gallery mesh (recalls
    equal), each K1-K3 launch of the step, the embeds and ``evaluate``
    held to its plain version at the rank's shapes (``held_to_plain``,
    [parity]'s tolerances); ``sharded_l2_topk`` over 1,048,575 x 256 rows (512 MiB per
    rank, one sentinel row) at k = 5 (indices equal, distances 1e-4) and
    on 10 rows at k = 12 and 16 (faiss's padding); the sharded int8
    candidates holding the exact top-5; ``PlaceIndex(gallery_mesh=,
    quant="int8")`` answering as the fp32 single-device index.  The
    ranks' launch counts (K1 in the step, K1-K3 in the embeds) are held
    to the expected counts and summed as the ``multi_gpu`` path.  NCCL at
    more than one rank and traffic between cards stay unchecked (one
    card).

Every phase raises on failure.  The second-to-last line is the per-kernel
JSON record (``launches`` summed over the paths, split in
``launches_by_path``; K1-K4's [widths] launches by instance in
``launches_by_instance_in_widths``, their timings under ``widths``; then
one row per instance [widths] launched, named ``kernel/instance``, with
its own source, its launches in [widths] and [widths lone] and the times
of its first launch alone; ``bound_ms`` / ``bound_by`` computed from this
run's inputs by ``bound``; ``library_ms`` the yardstick for part of the
work where there is one: cuDNN's convs for K3's, K6's and P1's conv
phases, K2's and P2's down0 GEMM and K4's window+zband (conv0 on the
dense fold and down0), ``F.max_pool2d`` for K5; null for the kernels no
single PyTorch call computes), the last line ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import collections
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
SM90_KERNELS = {"zband K2 down0": "zband_sm90_kernelILi1ELb1ELi0E",
                "zband K3 conv phase 1": "zband_sm90_kernelILi0ELb0ELi0E",
                "zband K3 conv phase 2": "zband_sm90_kernelILi0ELb0ELi1E",
                "zband K4 down0": "zband_sm90_kernelILi1ELb0ELi2E",
                "K3 conv phase 1": "conv3x3_sm90_kernelILi0E",
                "K3 conv phase 2": "conv3x3_sm90_kernelILi1E",
                "K6 conv phase 1": "conv3x3_sm90_kernelILi2E",
                "K6 conv phase 2": "conv3x3_sm90_kernelILi3E",
                "K2 down0 GEMM": "down0_sm90_kernel",
                "K4 fused head": "head_sm90_kernel",
                "K4 window conv0": "head_conv0_sm90_kernel",
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
               "bound_ms_b128", "conv_phases_device_ms", "train_k1",
               "widths")


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
    over up to ``n`` calls after one warm-up): for a kernel shorter than
    the host's enqueue of one call, whose CUDA-event timings are the
    host's.  The calls are as many as fit PROFILE_SPAN_MS by CUDA
    events, at least 3 (the tracer drops more events in longer profiles),
    and of several profiles the one with the most device events is read
    (``profile_calls``)."""
    fn()
    torch.cuda.synchronize()
    per_call = cuda_ms(fn, warmup=0, iters=3)
    n = max(3, min(n, int(PROFILE_SPAN_MS / max(per_call, 1e-3))))
    return profiled_ms(profile_calls(fn, n)) / n


# A profile may record fewer device events than its calls launched: the
# tracer drops some (once in a whole smoke on an H100 none at all; the lone
# K3's 12.8 ms read 5.5-9.0; 50 calls of one kernel gave 21, 45 and 50
# events; 5 calls of a cuDNN conv 30, 9, 30, 9, ...; every other profile
# may record nothing: 0, 13, 0, 13), and no count taken in other profiles
# is a yardstick (5 calls of the P2 probe gave 65 events, then 62 four
# times; two profiles may agree on a partial count).  Dropping only takes
# events away, so of PROFILE_TRIES profiles the one with the most device
# events is read, each let settle PROFILE_SETTLE_S before it stops;
# ``device_ms`` keeps a profile's calls to about PROFILE_SPAN_MS (the
# drops above came in profiles of 10-35 ms).
PROFILE_TRIES, PROFILE_SETTLE_S, PROFILE_SPAN_MS = 4, 0.05, 5.0


def profile_once(fn, n: int):
    """The ``torch.profiler`` run (device activity) of ``n`` calls of
    ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
    return prof


def device_events(prof) -> int:
    """The device events (kernels, copies, fills) a profile recorded."""
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def profile_calls(fn, n: int):
    """Of PROFILE_TRIES profiles of ``n`` calls of ``fn``, the one with the
    most device events (none of the others holds an event it lacks, as far
    as counts tell: the tracer only drops); raises if it has no device
    time."""
    profs = [profile_once(fn, n) for _ in range(PROFILE_TRIES)]
    counts = [device_events(p) for p in profs]
    best = profs[counts.index(max(counts))]
    if profiled_total(best) <= 0:
        raise RuntimeError(f"none of {PROFILE_TRIES} profiles of {n} calls "
                           f"recorded device time: {counts} device events")
    return best


def profiled_total(prof) -> float:
    """Device microseconds of every event a profile recorded."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def profiled_ms(prof) -> float:
    """Device ms of every kernel a ``torch.profiler`` run recorded."""
    total = profiled_total(prof)
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


def live_blocks(w, z_in: int, z_out: int) -> int:
    """The non-zero (zi, zo) blocks of a folded kernel ``w`` [k, k,
    z_in*cin, z_out*cout].  The fold holds a k*k*cin*cout block for each
    (zi, zo) pair the 3-D kernel reaches and zeros elsewhere (at z_in = 4:
    14 of 16 blocks for conv0's 5 taps, 4 of 8 for down0's z pairing; at
    z = 2 the 3x3x3 kernels are dense, the 1x1 residual 2 of 4; at z = 72,
    3 of 72 per output slab)."""
    k1, k2, zci, zco = w.shape
    blocks = w.reshape(k1 * k2, z_in, zci // z_in, z_out, zco // z_out)
    return int((blocks.ne(0).sum(dim=(0, 2, 4)) > 0).sum())


def conv_flops(cells: int, w, z_in: int, z_out: int) -> float:
    """2 x output cells x the products of the 3-D conv whose folded kernel
    is ``w``: only the fold's non-zero blocks (``live_blocks``) are work."""
    k1, k2, zci, zco = w.shape
    return (2.0 * cells * live_blocks(w, z_in, z_out) * k1 * k2
            * (zci // z_in) * (zco // z_out))


def fold_bytes(w, z_in: int, z_out: int) -> int:
    """The bytes of a folded kernel's non-zero blocks: the zero blocks are
    no data the conv needs, whatever reads them."""
    k1, k2, zci, zco = w.shape
    return (live_blocks(w, z_in, z_out) * k1 * k2 * (zci // z_in)
            * (zco // z_out) * w.element_size())


def stage0_bytes(args, z: int, *outs) -> int:
    """K2's / K4's inputs (``args``: feats, mask, w0, s0, b0, wd, sd, bd,
    the two folds by their live blocks) and ``outs`` once."""
    from agplace_tpu_torch.data.voxels import me_down_align

    return (nbytes(*args[:2], *args[3:5], *args[6:], *outs)
            + fold_bytes(args[2], z, z)
            + fold_bytes(args[5], z, me_down_align(z)[2]))


def block_bound(x, mask, w1, w2, s1, b1, s2, b2, w_eca, z, wd=None,
                scale_d=None, bias_d=None) -> dict:
    """An ECA block's bound (K3, K6, P1): its convs' operations against x,
    the mask, the parameters (the folds by their live blocks) and the
    output once."""
    folds = (w1, w2) if wd is None else (w1, w2, wd)
    extra = () if wd is None else (scale_d, bias_d)
    cells = x.shape[0] * x.shape[1] * x.shape[2]
    out_bytes = cells * w2.shape[3] * 2
    return bound(sum(conv_flops(cells, w, z, z) for w in folds),
                 nbytes(x, mask, s1, b1, s2, b2, w_eca, *extra)
                 + sum(fold_bytes(w, z, z) for w in folds) + out_bytes)


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
        bnd = bound(flops, nbytes(src, mask, s, b) + fold_bytes(w, z, z)
                    + outs)
        out[label] = dict(ms=ms, cudnn_ms=cudnn, tflops=flops / ms / 1e9,
                          share_of_bound=bnd["bound_ms"] / ms, **bnd)
        inst = bev_block_sm.conv3x3_instance(int(src.shape[3]),
                                             int(w.shape[3]), z)
        if inst == "zband":  # its kernel alone beside the pad
            epi = (bev_block_sm.EPI_BF16_POOL if pool_
                   else bev_block_sm.EPI_BF16_RELU_MASK)

            def pad(src=src, wb=wb, s=s, b=b):
                return bev_block_sm.pad_phase(src, wb, s, b, z)

            padded = pad()
            out[label].update(instance_alone(
                f"K3 {label} {name} zband",
                lambda: bev_block_sm.conv_phase_launch(*padded, mask, epi, z,
                                                       inst), pad))
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
                           z, me_down_align(z)[2]),
                nbytes(g0, mask, s0, b0, sd, bd, m_out, got)
                + fold_bytes(wb, z, me_down_align(z)[2]))
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
                nbytes(*planes, mask, s0, b0, sd, bd, m_out, got)
                + fold_bytes(wb, z, 2))
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
             + conv_flops(cells // 4, ins[5], z, me_down_align(z)[2]))
    bnd = bound(flops, stage0_bytes(ins, z, m_out, got))
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
                   stage0_bytes(args, z0, out, mo))
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


# fused_bn_act's launches on each main-path run that checks them, by path
# (``check_epilogues``): the kernels line's launches of its row
EPILOGUES = {}


def trunk_epilogues(cfg, n_tiles, n_requests):
    """fused_bn_act's launches in the run ``expected_launches`` counts: a
    ResNet trunk forward has one eval epilogue per BN of a block (two a
    BasicBlock, three a Bottleneck) and the stem's, unless K5 takes it."""
    from agplace_tpu_torch.models import resnet

    def per_forward(arch, layers, k5):
        if arch not in resnet.RESNET_SPECS:
            return 0
        block, sizes, _ = resnet.RESNET_SPECS[arch]
        per_block = 2 if block is resnet.BasicBlock else 3
        return (not k5) + per_block * sum(sizes[:len(layers)])

    mm, db = cfg.model.mm, cfg.model.db
    db_forwards = -(-n_tiles // cfg.train.infer_batch_size) * cfg.data.nmap
    return (n_requests * per_forward(mm.imgfe, mm.imgfe_layers,
                                     mm.stem_pallas)
            + db_forwards * per_forward(db.image_fe, db.image_fe_layers,
                                        db.stem_pallas))


def check_epilogues(label, n, cfg, n_tiles, n_requests):
    """The epilogue kernel's launches ``n`` of a path, read just after it:
    every eval epilogue of every trunk forward, none on the eager chain."""
    want = trunk_epilogues(cfg, n_tiles, n_requests)
    log(f"[{label}] fused_bn_act launches {n} (want {want})")
    if n != want:
        raise AssertionError(f"[{label}] fused_bn_act launches {n} != "
                             f"{want}")
    EPILOGUES[label] = n


def bn_act_cells():
    """The benchmark's embed cells: each one's batch and the epilogues a
    trunk forward launches at its image size (``resnet18_epilogues``)."""
    from agplace_tpu_torch.ops import bn_act
    from portbench.harness import cell as cells

    out = {}
    for w in cells.benchmark()["workloads"]:
        c = cells.load(w["name"])
        if c.mix == "embed":
            out[c.name] = (c.params["batch"],
                           bn_act.resnet18_epilogues(*c.params["image_hw"]))
    return out


def phase_bn_act(dev) -> dict:
    """The ResNet epilogue kernel at every map and instance of the
    benchmark's embed cells: bit-equal to the eager chain it replaces
    (raw bits), timed by the profiler's device time beside that chain and
    its byte bound (the maps read and written once); per cell the sums over
    one trunk forward.  Returns the kernels line's row; its launches are
    the main paths' (``EPILOGUES``), filled in by ``main``."""
    from agplace_tpu_torch.ops import bn_act

    g = torch.Generator(device=dev).manual_seed(7)
    rec = {"name": "fused_bn_act", "route": "cuda",
           "source": "agplace_tpu_torch/csrc/bn_act.cu",
           "replaces": "the eager BN / residual / relu chain of "
                       "agplace_tpu_torch/models/resnet.py (no TPU kernel: "
                       "XLA fuses it into the conv)",
           "max_abs_err": 0.0, "frac_differ": 0.0, "by_cell": {}}
    for cell, (batch, epis) in bn_act_cells().items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0}
        uses = collections.Counter(epis)  # ([H, W, C], instance) -> n
        for h, w, c in dict.fromkeys(m for m, _ in epis):
            x = torch.randn(batch, h, w, c, generator=g, device=dev,
                            dtype=torch.bfloat16)
            r = torch.randn(batch, h, w, c, generator=g, device=dev,
                            dtype=torch.bfloat16)
            s, sd = (torch.rand(2, c, generator=g, device=dev) * 2 - 0.7)
            b, bd = torch.randn(2, c, generator=g, device=dev)
            for inst in range(3):
                n = uses[((h, w, c), inst)]
                if not n:
                    continue
                args = (x, s, b, *((None, None), (r, None),
                                   (r, (sd, bd)))[inst])
                got = bn_act.fused_bn_act(*args)
                if not torch.equal(got.view(torch.int16),
                                   bn_act.bn_act_plain(*args).view(
                                       torch.int16)):
                    raise AssertionError(f"fused_bn_act {cell} [{h},{w},"
                                         f"{c}] instance {inst}: not "
                                         f"bit-equal to the eager chain")
                del got
                moved = nbytes(x) * (2 if inst == 0 else 3)
                ms = device_ms(lambda: bn_act.fused_bn_act(*args), n=10)
                pms = device_ms(lambda: bn_act.bn_act_plain(*args), n=10)
                bnd = bound(0.0, moved)["bound_ms"]
                log(f"  fused_bn_act {cell} [{batch},{h},{w},{c}] instance "
                    f"{inst} x{n}: {ms:.4f} ms by device "
                    f"({moved / ms / 1e9:.3f} TB/s, share {bnd / ms:.3f}), "
                    f"eager chain {pms:.4f} ms")
                tot["ms"] += n * ms
                tot["plain_ms"] += n * pms
                tot["bound_ms"] += n * bnd
                tot["bytes"] += n * moved
            del x, r
        tot["tb_s"] = tot["bytes"] / tot["ms"] / 1e9
        tot["share"] = tot["bound_ms"] / tot["ms"]
        log(f"  fused_bn_act {cell}, one forward's {len(epis)} epilogues: "
            f"{tot['ms']:.4f} ms ({tot['tb_s']:.3f} TB/s, share "
            f"{tot['share']:.3f}), eager chain {tot['plain_ms']:.4f} ms")
        rec["by_cell"][cell] = tot
    k = rec["by_cell"]["kitti360-embed-b128"]
    rec.update(ms=k["ms"], plain_ms=k["plain_ms"], library_ms=k["plain_ms"],
               bound_ms=k["bound_ms"], bound_by="bytes", share=k["share"])
    return rec


def phase_serving(cfg, dev, n_tiles, label):
    from agplace_tpu_torch import ops
    from agplace_tpu_torch.infer import build_towers
    from agplace_tpu_torch.serving import PlaceIndex

    from agplace_tpu_torch.ops import bn_act

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
    bn_act.fused_bn_act.launches = 0
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
    n_epi = bn_act.fused_bn_act.launches
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
    check_epilogues(label, n_epi, cfg, n_tiles, len(requests))

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
    fused_bn_act's launches, query and tile descriptors as numpy, wall s
    of evaluate, wall s of its gallery pass)."""
    from agplace_tpu_torch import ops
    from agplace_tpu_torch.evaluate import evaluate
    from agplace_tpu_torch.infer import make_infer_fns
    from agplace_tpu_torch.ops import bn_act

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
    bn_act.fused_bn_act.launches = 0
    t0 = time.perf_counter()
    recalls, text = evaluate(cfg, ds, keeping(embed_q, q_out),
                             keeping(embed_db, db_out), device=dev)
    t_eval = time.perf_counter() - t0
    counts = ops.launches()  # ---- read just after the path
    counts_epi = bn_act.fused_bn_act.launches
    ds.load_query_image = load
    q = torch.cat(q_out)[:ds.queries_num].float().cpu().numpy()
    db = torch.cat(db_out)[:ds.database_num].float().cpu().numpy()
    return recalls, text, counts, counts_epi, q, db, t_eval, first_q[0] - t0


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
    recalls, text, counts, n_epi, q, db, t_eval, t_gallery = run_evaluate(
        cfg, ds, towers, dev)
    n_fwd = -(-ds.queries_num // bs)
    want = expected_launches(cfg, ds.database_num, n_fwd)
    log(f"[eval] evaluate(hard_resize) of {ds.queries_num} queries over "
        f"{ds.database_num} tiles in {t_eval:.3f} s; launches {counts}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    check_epilogues("eval", n_epi, cfg, ds.database_num, n_fwd)
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
    from agplace_tpu_torch.ops import bn_act

    ds = eval_dataset(cfg, N_TILES, N_EVAL_CROP_Q, crops=True)
    if not np.array_equal(ds.db_eastnorth,
                          eval_dataset(cfg, N_TILES, 1).db_eastnorth):
        raise AssertionError("the crop queries' world has other tiles")
    embed_q, _ = make_infer_fns(*towers)
    bs = cfg.train.infer_batch_size
    ops.reset_launches()  # ---- the path: one crop pass, two merges
    bn_act.fused_bn_act.launches = 0
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
    n_epi = bn_act.fused_bn_act.launches
    want = expected_launches(cfg, 0, -(-ds.queries_num // bs))
    log(f"[eval-crops] {q.shape[0]} crop descriptors ({ds.queries_num} "
        f"queries x 5, batch {5 * bs}) in {t_query:.3f} s (host prep "
        f"included); launches {counts}")
    if counts != want or q.shape != (5 * ds.queries_num, 256):
        raise AssertionError(f"launch counts {counts} != {want}, or crop "
                             f"descriptors {q.shape}")
    check_epilogues("eval-crops", n_epi, cfg, 0, -(-ds.queries_num // bs))
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
    recalls, text, counts, n_epi, q, db, t_eval, _ = run_evaluate(
        cfg, ds, towers, dev)
    n_fwd = -(-ds.queries_num // bs)
    want = expected_launches(cfg, ds.database_num, n_fwd)
    log(f"[eval-fused] evaluate(hard_resize) of {ds.queries_num} queries "
        f"over {ds.database_num} tiles in {t_eval:.3f} s; launches {counts}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    check_epilogues("eval-fused", n_epi, cfg, ds.database_num, n_fwd)
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

    def make(cfg, mesh=None):
        step = real(cfg, mesh)

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


# ---- serving extras, the real readers and the entry points --------------

SERVE_ROWS = 1 << 20  # [serve-int8]: 1 GiB of fp32 rows, 256 MiB of int8
HTTP_ROWS = 1 << 17  # [serve-http]: two nodes of 65,536 rows each
N_SERVE_Q = 32
KITTI_FRAMES = 80  # per drive, 2 drives, 1 m apart: 2 steps of 16 queries
NUSC_QUERIES = 64  # [data-nuscenes]: 64 samples and 64 tiles
# The int8 path's final distances come from its exact host re-rank; the
# fp32 path's from the card's fp32 matmul: the two agree to fp32 rounding
SERVE_D_TOL = 1e-5


def unit_rows(n, seed, dev):
    """[n, 256] L2-normalised rows made on the card from a seed, on the
    host as float32 numpy."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, 256), generator=g, device=dev)
    return torch.nn.functional.normalize(x, dim=1).cpu().numpy()


def near_queries(gallery, n, seed):
    """``n`` unit queries, each a gallery row plus noise (norm ~0.3)."""
    rng = np.random.default_rng(seed)
    q = gallery[rng.choice(len(gallery), n, replace=False)] + 0.02 * \
        rng.standard_normal((n, gallery.shape[1])).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def ties_aside(i, i_ref, d_ref, gap=1e-4):
    """Rows of ``i`` and ``i_ref`` equal wherever the reference's
    neighbouring distances are more than ``gap`` apart: the count of
    queries where they differ elsewhere."""
    d = np.asarray(d_ref, np.float64)
    with np.errstate(invalid="ignore"):  # inf - inf past the rows
        close = np.zeros(d.shape, bool)
        close[:, 1:] |= np.diff(d, axis=1) < gap
        close[:, :-1] |= np.diff(d, axis=1) < gap
    return int(((i != i_ref) & ~close).any(axis=1).sum())


def timed_searches(idx, q, k, n=20):
    """Median host ms of ``n`` searches (each ends in a host fetch)."""
    idx.search_descriptors(q, k)
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        idx.search_descriptors(q, k)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def phase_serve_int8(dev):
    """[serve-int8]: 1,048,576 seeded unit rows, 32 queries near gallery
    rows, k = 5.  The int8 cross term on the card equals the CPU's on a
    4,096-row slice; the int8 path's final (d, i) equal the fp32 path's on
    every query without an audit miss (indices, distances within
    SERVE_D_TOL); ms per search of both paths, the peak device memory
    while each gallery is built and searched, ``upload_count``, and
    ``audit_stats`` of one search at ``audit_rate`` 1."""
    from agplace_tpu_torch.retrieval import knn
    from agplace_tpu_torch.serving import PlaceIndex

    t0 = time.perf_counter()
    gal = unit_rows(SERVE_ROWS, 11, dev)
    q = near_queries(gal, N_SERVE_Q, 12)
    log(f"[serve-int8] {SERVE_ROWS} x 256 rows made in "
        f"{time.perf_counter() - t0:.2f} s")

    db_i8, scale, sq = knn.quantize_rows(gal[:4096])
    q_i8, _ = knn.quantize_queries(torch.from_numpy(q))
    q_i8_card, _ = knn.quantize_queries(torch.from_numpy(q).to(dev))
    cross_cpu = knn.int8_cross(q_i8, torch.from_numpy(db_i8))
    cross = knn.int8_cross(q_i8.to(dev), torch.from_numpy(db_i8).to(dev))
    cand = [knn.l2_candidates_int8(*(torch.from_numpy(a).to(d) for a in
                                     (q, db_i8, scale[:, 0], sq)), 64)
            for d in (dev, "cpu")]
    same = [torch.equal(cross.cpu(), cross_cpu),
            torch.equal(q_i8_card.cpu(), q_i8),
            torch.equal(cand[0][0].cpu(), cand[1][0]),
            torch.equal(cand[0][1].cpu(), cand[1][1])]
    log(f"[serve-int8] card vs CPU on a 4,096-row slice: the int32 cross "
        f"term [32, 4096] equal {same[0]}; the quantized queries equal "
        f"{same[1]}; the top-64 candidates' approximate distances "
        f"bit-equal {same[2]}, indices equal {same[3]}")
    if not all(same):
        raise AssertionError("[serve-int8] the int8 scan differs from the "
                             "CPU's")

    out = {}
    for quant in (None, "int8"):
        label = quant or "fp32"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        idx = PlaceIndex(None, device=dev, quant=quant)
        idx.add_descriptors(gal)
        t0 = time.perf_counter()
        d, i = idx.search_descriptors(q, 5)  # builds the device gallery
        t_first = time.perf_counter() - t0
        ms = timed_searches(idx, q, 5)
        gallery = (idx._quant_gallery if quant else (idx._gallery,))
        held = sum(t.numel() * t.element_size() for t in gallery)
        peak = torch.cuda.max_memory_allocated() - base
        log(f"[serve-{label}] gallery on the card {held / 2 ** 20:.1f} MiB,"
            f" peak device memory over building and searching "
            f"{peak / 2 ** 20:.1f} MiB; first search (upload) "
            f"{t_first * 1e3:.1f} ms, then {ms:.3f} ms per search of 32 "
            f"queries at k = 5 (median of 20, host clock); upload_count "
            f"{idx.upload_count}")
        if idx.upload_count != 1:
            raise AssertionError(f"[serve-{label}] {idx.upload_count} "
                                 f"uploads")
        out[label] = (d, i, idx if quant else None)
        del idx, gallery  # the fp32 rows leave the card before int8's
    d32, i32, _ = out["fp32"]
    d8, i8, idx8 = out["int8"]
    idx8.audit_rate = 1.0
    t0 = time.perf_counter()
    idx8.search_descriptors(q, 5)
    log(f"[serve-int8] one audited search in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms: audit_stats "
        f"{idx8.audit_stats}")
    missed = (d32 < d8 - 1e-4).any(axis=1)  # the audit's rule, vs the card
    clean = ~missed
    bad = ties_aside(i8[clean], i32[clean], d32[clean])
    err = float(np.abs(d8[clean] - d32[clean]).max())
    log(f"[serve-int8] int8 vs fp32 final (d, i): {int(missed.sum())} "
        f"queries with a candidate miss (audit: "
        f"{idx8.audit_stats['miss_queries']}); on the other "
        f"{int(clean.sum())}: {bad} differ in indices, max |d| error "
        f"{err:.3g} (tol {SERVE_D_TOL})")
    if (bad or err > SERVE_D_TOL
            or idx8.audit_stats["miss_queries"] != int(missed.sum())):
        raise AssertionError("[serve-int8] int8 and fp32 answers differ")


def phase_serve_http(dev):
    """[serve-http]: two in-process nodes (``serving_http``) of 65,536 rows
    each on the card behind ``ShardedSearchClient``; 32 queries at k = 5
    equal the flat index's; ms per request (median of 10)."""
    import threading

    from agplace_tpu_torch.serving import PlaceIndex
    from agplace_tpu_torch.serving_http import (ShardedSearchClient,
                                                make_http_server)

    gal = unit_rows(HTTP_ROWS, 13, dev)
    pos = np.random.default_rng(14).uniform(0, 1e4, (HTTP_ROWS, 2))
    q = near_queries(gal, N_SERVE_Q, 15)
    flat = PlaceIndex(None, device=dev)
    flat.add_descriptors(gal, positions=pos)
    d_ref, i_ref, p_ref = flat.locate_descriptors(q, 5)
    servers = []
    try:
        for half in (slice(0, HTTP_ROWS // 2), slice(HTTP_ROWS // 2, None)):
            node = PlaceIndex(None, device=dev)
            node.add_descriptors(gal[half], positions=pos[half])
            srv = make_http_server(node)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            servers.append(srv)
        client = ShardedSearchClient(
            ["http://%s:%d" % s.server_address for s in servers])
        d, i, p = client.search(q, 5)
        ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            client.search(q, 5)
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    bad = ties_aside(i, i_ref, d_ref)
    err = float(np.abs(d - d_ref).max())
    log(f"[serve-http] 2 nodes x {HTTP_ROWS // 2} rows: {len(client)} rows;"
        f" {statistics.median(ms):.2f} ms per request of 32 queries at "
        f"k = 5 (median of 10, min {min(ms):.2f}); merge vs the flat index:"
        f" {bad} queries differ in indices, max |d| error {err:.3g}")
    if bad or err > SERVE_D_TOL or not np.array_equal(
            p[i == i_ref], p_ref[i == i_ref]):
        raise AssertionError("[serve-http] the merge differs from the flat "
                             "index")


def runs_dir(name):
    import shutil

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_runs",
                        name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def write_trees():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import write_torch_trees

    return write_torch_trees


def phase_data_kitti360(dev):
    """[data-kitti360]: a KITTI-360-AG tree under ``_runs/`` (2 drives of
    80 frames 1 m apart; 1198 x 320 PNG queries, 320 x 320 satellite and
    roadmap tiles, 30,000-point clouds), ``train()`` at
    ``kitti360_config()`` (16 x (1 + 1 + 10), fp32) for 2 steps on its
    reader, then its evaluation of the test split (24 queries, 24 tiles);
    the host time of the reader per batch; launch counts of the steps
    (K1 3 each), mining and evaluation (K1, K2, K3).  Then, with the fused
    towers in bf16, one MM forward of 2 test queries at the real aspect
    (256 x 958) and one aerial-tower forward of 2 tiles, against the CPU
    (K4; K5 in the aerial tower, and in the MM only if its stem map is
    even).  Returns (counts, fused counts, tree, save dir)."""
    import dataclasses

    from agplace_tpu_torch import ops
    from agplace_tpu_torch.data.base import (collate_cache_db,
                                             collate_cache_q, collate_train)
    from agplace_tpu_torch.data.pipeline import Prefetcher
    from agplace_tpu_torch.infer import build_towers
    from agplace_tpu_torch.train import loop
    from agplace_tpu_torch.train.cli import build_datasets
    from agplace_tpu_torch.train.mining import TripletMiner

    root = runs_dir("chip_smoke_kitti360")
    tree, save_dir = os.path.join(root, "KITTI-360"), os.path.join(root,
                                                                   "run")
    t0 = time.perf_counter()
    write_trees().kitti360_tree(tree, frames=KITTI_FRAMES)
    log(f"[data-kitti360] tree of 2 x {KITTI_FRAMES} frames written in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = train_cfg(queries_per_epoch=32, cache_refresh_rate=32,
                    epochs_num=1, checkpoint_after_epoch=-1,
                    save_dir=save_dir)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataroot=tree))
    train_ds, test_ds = build_datasets(cfg)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, neg_samples_num=train_ds.database_num))
    log(f"[data-kitti360] train: {train_ds.queries_num} queries / "
        f"{train_ds.database_num} tiles; test: {test_ds.queries_num} / "
        f"{test_ds.database_num}; query image "
        f"{train_ds.load_query_image(0).shape}")
    rng = np.random.default_rng(0)
    trip = np.stack([rng.choice(train_ds.database_num, 12, replace=False)
                     for _ in range(16)])
    trip[:, 0] = rng.choice(train_ds.queries_num, 16, replace=False)
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        collate_train(train_ds, trip, cfg, rng)
        ms.append((time.perf_counter() - t0) * 1e3)
    n_workers = cfg.data.num_workers
    batches = [trip] * (2 * n_workers)
    t0 = time.perf_counter()
    for _ in Prefetcher(batches, lambda t: collate_train(
            train_ds, t, cfg, np.random.default_rng(0)), n_workers):
        pass
    par_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    log(f"[data-kitti360] reader: one training batch (16 queries, 176 tiles"
        f", 16 clouds voxelized) collated on one host thread in "
        f"{min(ms):.0f} ms ({ms}); {len(batches)} batches through the "
        f"Prefetcher's {n_workers} threads: {par_ms:.0f} ms per batch")

    parts = {"mining": dict.fromkeys(ops.launches(), 0),
             "eval": dict.fromkeys(ops.launches(), 0)}

    def counted(fn, part):
        def call(*a, **kw):
            before = ops.launches()
            result = fn(*a, **kw)
            for k, v in ops.launches().items():
                parts[part][k] += v - before[k]
            return result
        return call

    real = (TripletMiner.mine, loop.evaluate)
    TripletMiner.mine = counted(TripletMiner.mine, "mining")
    loop.evaluate = counted(loop.evaluate, "eval")
    try:
        ops.reset_launches()  # ---- the path: train() on the reader
        t0 = time.perf_counter()
        out = loop.train(cfg, train_ds, test_ds, device=dev)
        t_train = time.perf_counter() - t0
        counts = ops.launches()  # ---- read just after the path
    finally:
        TripletMiner.mine, loop.evaluate = real
    hist = out["history"][0]
    steps = {k: counts[k] - parts["mining"][k] - parts["eval"][k]
             for k in counts}
    phases = out["phase_times"]
    log(f"[data-kitti360] train() in {t_train:.2f} s: {out['state'].step} "
        f"steps of 16 x (2 + 10), {phases['train'] / 2 * 1e3:.0f} ms per "
        f"step (collation waits included), mining {phases['mining']:.2f} s,"
        f" evaluation {phases['eval']:.2f} s; losses {hist['losses']}; "
        f"recalls {hist['recalls'].tolist()}")
    log(f"[data-kitti360] launches: all {counts}; mining {parts['mining']};"
        f" steps {steps}; evaluation {parts['eval']}")
    want_steps = dict.fromkeys(counts, 0)
    want_steps["fused_euler_ode"] = 3 * 2
    if out["state"].step != 2 or not np.isfinite(hist["losses"]).all():
        raise AssertionError(f"[data-kitti360] {out['state'].step} steps")
    if steps != want_steps:
        raise AssertionError(f"[data-kitti360] steps' launches {steps}")
    if not all(parts[p][k] for p in parts for k in
               ("fused_euler_ode", "fused_conv0_down0",
                "fused_eca_block_sm")):
        raise AssertionError("[data-kitti360] an eval kernel did not run")
    check_recalls("data-kitti360", hist["recalls"], "evaluation recalls")

    # the fused towers at the real aspect: K4, and K5 where it may run
    mc = dataclasses.replace(cfg.model.mm, bev_pallas_head=True,
                             stem_pallas=True)
    dc = dataclasses.replace(cfg.model.db, stem_pallas=True)
    cfg_f = cfg.replace(model=dataclasses.replace(
        cfg.model, mm=mc, db=dc, compute_dtype="bfloat16"))
    mm, db = build_towers(cfg_f, "cpu", torch.Generator().manual_seed(3))
    seed_bn(mm, np.random.default_rng(3))
    seed_bn(db, np.random.default_rng(4))
    cpu_mm, cpu_db = copy.deepcopy(mm), copy.deepcopy(db)
    mm.to(dev)
    db.to(dev)
    images, vox = collate_cache_q(test_ds, [0, 1], cfg_f, dev,
                                  torch.bfloat16)
    maps = collate_cache_db(test_ds, [0, 1])
    stem_w = (images.shape[2] - 1) // 2 + 1
    with torch.inference_mode():
        ops.reset_launches()  # ---- the path: MM + aerial tower forwards
        gq = mm(torch.from_numpy(images).to(dev), vox)["embedding"]
        gd = db(torch.from_numpy(maps).to(dev))
        torch.cuda.synchronize()
        counts_f = ops.launches()  # ---- read just after the path
        cq = cpu_mm(torch.from_numpy(images), collate_cache_q(
            test_ds, [0, 1], cfg_f, "cpu", torch.bfloat16)[1])["embedding"]
        cd = cpu_db(torch.from_numpy(maps))
    want = dict.fromkeys(counts_f, 0)
    want.update(fused_euler_ode=3, fused_eca_block_sm=4, fused_head=1,
                fused_affine_relu_maxpool=cfg_f.data.nmap
                + (stem_w % 2 == 0))
    log(f"[data-kitti360-fused] query images {images.shape} (stem map "
        f"{(images.shape[1] - 1) // 2 + 1} x {stem_w}: K5 "
        f"{'runs' if stem_w % 2 == 0 else 'is gated off, as in JAX'} in "
        f"the MM); launches {counts_f}")
    if counts_f != want:
        raise AssertionError(f"[data-kitti360-fused] launches {counts_f} "
                             f"!= {want}")
    check_descriptors("data-kitti360-fused", "query embeddings "
                      f"({images.shape[1]} x {images.shape[2]})",
                      gq.float().cpu().numpy(), cq.float().numpy())
    check_descriptors("data-kitti360-fused", "tile descriptors",
                      gd.float().cpu().numpy(), cd.float().numpy())
    return counts, counts_f, tree, save_dir


def phase_data_nuscenes(dev):
    """[data-nuscenes]: a nuScenes-AG tree (cached index JSON, 6 cameras of
    455 x 256 JPEG in the ``_size256`` dirs, 30,000-point clouds, 64
    samples and 64 tiles of the test split) and ``evaluate`` on it at
    ``nuscenes_config()`` (fp32, 128 x 128 x 8 grid, 192 x 2046
    panoramas): exact launch counts (K1, K2 at z = 8, K3); 2 queries' and
    2 tiles' descriptors against the CPU."""
    import dataclasses
    import shutil

    from agplace_tpu_torch import nuscenes_config
    from agplace_tpu_torch.data.nuscenes import NuScenesDataset
    from agplace_tpu_torch.infer import build_towers

    root = runs_dir("chip_smoke_nuscenes")
    t0 = time.perf_counter()
    write_trees().nuscenes_tree(root, queries=NUSC_QUERIES)
    cfg = nuscenes_config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataroot=root))
    ds = NuScenesDataset(cfg, "test")
    log(f"[data-nuscenes] tree written and read in "
        f"{time.perf_counter() - t0:.1f} s: {ds.queries_num} queries, "
        f"{ds.database_num} tiles; panorama {ds.load_query_image(0).shape}")
    mm, db = build_towers(cfg, "cpu", torch.Generator().manual_seed(5))
    seed_bn(mm, np.random.default_rng(5))
    seed_bn(db, np.random.default_rng(6))
    cpu_towers = (copy.deepcopy(mm), copy.deepcopy(db))
    towers = (mm.to(dev), db.to(dev))
    recalls, text, counts, n_epi, q, dbf, t_eval, t_gal = run_evaluate(
        cfg, ds, towers, dev)
    n_fwd = -(-ds.queries_num // cfg.train.infer_batch_size)
    want = expected_launches(cfg, ds.database_num, n_fwd)
    log(f"[data-nuscenes] evaluate in {t_eval:.2f} s (gallery pass "
        f"{t_gal:.2f} s): {text}; launches {counts}")
    if counts != want:
        raise AssertionError(f"[data-nuscenes] launches {counts} != {want}")
    check_epilogues("data-nuscenes", n_epi, cfg, ds.database_num, n_fwd)
    check_recalls("data-nuscenes", recalls, "recalls")
    cq, cd = cpu_descriptors(cfg, ds, cpu_towers, 2)
    check_descriptors("data-nuscenes", "2 queries' descriptors", q[:2], cq)
    check_descriptors("data-nuscenes", "2 tiles' descriptors", dbf[:2], cd)
    shutil.rmtree(root, ignore_errors=True)
    return counts


def cli(*args, wait=True):
    """``python -m agplace_tpu_torch.<args>`` from the checkout; with
    ``wait`` its (stdout, stderr) once it exits 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.Popen([sys.executable, "-m", *args], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    return finish(p, args) if wait else p


def finish(p, args, timeout=300):
    out, err = p.communicate(timeout=timeout)
    if p.returncode != 0:
        raise AssertionError(f"[serve-cli] {' '.join(args[:2])} exited "
                             f"{p.returncode}: {err[-2000:]}")
    return out, err


def check_rows(label, out, d, i, pos):
    """The search lines against the in-process answers (indices aside
    where distances tie within 1e-4, distances within 1e-4)."""
    rows = [json.loads(line) for line in out.strip().splitlines()]
    got_i = np.array([r["indices"] for r in rows])
    got_d = np.array([[np.inf if v is None else v for v in r["sq_distances"]]
                      for r in rows])
    bad = ties_aside(got_i, i, d)
    err = float(np.abs(got_d - d).max())
    ok = (len(rows) == len(i) and bad == 0 and err <= 1e-4
          and all(len(r["east_north"]) == i.shape[1] for r in rows))
    log(f"[serve-cli] {label}: {len(rows)} lines, {bad} differ in indices, "
        f"max |d| error {err:.3g} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[serve-cli] {label} disagrees")


def phase_serve_cli(dev, tree, save_dir):
    """[serve-cli]: the entry points as subprocesses on the card, on the
    checkpoint [data-kitti360] wrote: ``serve build``, then at once
    ``serve search --resume``, ``serve search --queries --quant int8``,
    ``serve http`` with a fan-out ``serve search`` over it, and ``test
    --resume``; each exits 0 and answers as the in-process index (its
    launches are not counted)."""
    import shutil
    import socket

    from agplace_tpu_torch.config import parse_arguments
    from agplace_tpu_torch.embed import batched_embed_q
    from agplace_tpu_torch.evaluate import evaluate
    from agplace_tpu_torch.infer import make_infer_fns
    from agplace_tpu_torch.serving import PlaceIndex
    from agplace_tpu_torch.train.checkpoint import load_towers
    from agplace_tpu_torch.train.cli import build_datasets

    data = ["--dataset", "kitti360", "--dataroot", tree, "--save_dir",
            save_dir, "--resume", "best_model"]
    gal, qpath = (os.path.join(save_dir, f) for f in ("g.npz", "q.npy"))
    t0 = time.perf_counter()
    out, _ = cli("agplace_tpu_torch.serve", "build", "--gallery_out", gal,
                 *data)
    t_build = time.perf_counter() - t0
    built = json.loads(out.strip().splitlines()[-1])

    cfg, _ = parse_arguments(data)
    _, test_ds = build_datasets(cfg)
    idx = PlaceIndex.from_checkpoint(cfg, save_dir, "best_model", dev)
    idx.load_gallery(gal)
    q = batched_embed_q(test_ds, list(range(test_ds.queries_num)),
                        idx._embed_q, cfg.train.infer_batch_size, cfg, dev)
    np.save(qpath, q)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = {
        "search --resume": cli("agplace_tpu_torch.serve", "search",
                               "--gallery", gal, "--k", "5", *data,
                               wait=False),
        "search --quant int8": cli("agplace_tpu_torch.serve", "search",
                                   "--gallery", gal, "--queries", qpath,
                                   "--k", "5", "--quant", "int8",
                                   wait=False),
        "test --resume": cli("agplace_tpu_torch.test", *data, wait=False),
        "http": cli("agplace_tpu_torch.serve", "http", "--gallery", gal,
                    "--port", str(port), wait=False)}
    try:
        ready = json.loads(procs["http"].stdout.readline())
        client_out, _ = cli("agplace_tpu_torch.serve", "search", "--gallery",
                            f"http://127.0.0.1:{port}", "--queries", qpath,
                            "--k", "5")
    finally:
        procs["http"].terminate()
        procs["http"].wait(timeout=60)
    outs = {k: finish(p, k.split())[0] for k, p in procs.items()
            if k != "http"}
    log(f"[serve-cli] build in {t_build:.1f} s -> {built}; the other four "
        f"processes at once in {time.perf_counter() - t0:.1f} s; http node "
        f"{ready}")
    with np.load(gal) as z:
        feats = z["feats"]
    towers, _ = load_towers(cfg, save_dir, "best_model", dev)
    ref = PlaceIndex(cfg, towers, dev)
    ref.add_tiles(test_ds)
    err = float(np.abs(feats - ref._host_gallery()).max())
    log(f"[serve-cli] build's gallery vs the in-process add_tiles: max "
        f"|err| {err:.3g}")
    if built["rows"] != test_ds.database_num or err > 1e-4:
        raise AssertionError("[serve-cli] build's gallery differs")
    check_rows("search --resume", outs["search --resume"],
               *idx.locate_descriptors(q, 5))
    check_rows("search --queries --quant int8", outs["search --quant int8"],
               *PlaceIndex.from_gallery(gal, device=dev, quant="int8")
               .locate_descriptors(q, 5))
    check_rows("http node + fan-out search", client_out,
               *PlaceIndex.from_gallery(gal, device=dev)
               .locate_descriptors(q, 5))
    _, text = evaluate(cfg, test_ds, *make_infer_fns(*towers), device=dev)
    got = outs["test --resume"].strip().splitlines()[-1]
    log(f"[serve-cli] test --resume: {got!r}; in-process evaluate: "
        f"{text!r}")
    if got != text:
        raise AssertionError("[serve-cli] test --resume's recalls differ")
    shutil.rmtree(os.path.dirname(save_dir), ignore_errors=True)


# ---- the MM's option tail: voxel backends, integrators, options ----------

# [mm-backends] .. [mm-options] hold the card's run against the CPU run of
# the same module on the first OPT_CPU_Q queries of the batch (eval mode is
# per sample; the CPU runs the plain versions), at SLICE_TOL of the
# embedding's scale, as [slice].  The backends against the card's bev MM
# with the same weights: each layout sums its bf16 convs in another order
# (the CPU tests hold the three to 2e-2 of the outputs' scale), BACKEND_TOL.
OPT_CPU_Q = 2
BACKEND_TOL = 5e-2
OPT_BATCH = 8  # [mm-options]
# [ode-lib]: fp32 on both devices, TF32 off: summation order only
# (measured up to 6.3e-7 of scale on the H100).  BeltramiODE's kNN graph:
# a neighbour within rounding of the k-th similarity can swap places,
# moving that token's row, and a repeated token's similarities to itself
# and to its copy are two GEMM sums that need not round alike; at most
# BELTRAMI_ROWS of the rows may be off by more than ODE_LIB_TOL (measured
# 0.27 % of the rows for distinct tokens, 0.81 % for repeated ones).
ODE_LIB_TOL = 1e-4
BELTRAMI_ROWS = 5e-2
OPTION_VARIANTS = (
    ("bev ntd1 basic", dict(voxfe_ntd=1, voxfe_block="basic")),
    ("bev ntd2 aspp", dict(voxfe_ntd=2, voxfe_block="aspp")),
    ("bev convnext", dict(voxfe_block="convnext")),
    ("dense ntd1 basic", dict(voxfe_backend="dense", voxfe_ntd=1,
                              voxfe_block="basic")),
    ("dense ntd2 aspp", dict(voxfe_backend="dense", voxfe_ntd=2,
                             voxfe_block="aspp")),
    ("dense convnext", dict(voxfe_backend="dense", voxfe_block="convnext")),
    ("sparse ntd1 basic", dict(voxfe_backend="sparse", voxfe_ntd=1,
                               voxfe_block="basic")),
    ("sparse ntd2 aspp", dict(voxfe_backend="sparse", voxfe_ntd=2,
                              voxfe_block="aspp")),
    ("sparse convnext", dict(voxfe_backend="sparse",
                             voxfe_block="convnext")),
    ("drop image", dict(drop="image")),
    ("drop pc", dict(drop="pc")),
    ("drop pc sparse", dict(voxfe_backend="sparse", drop="pc")),
    ("final cat", dict(final_fusetype="cat")),
    ("final catadd", dict(final_fusetype="catadd",
                          final_type=("shalloworg", "stg2vox"))),
    ("addorg", dict(output_type=("image", "vox", "addorg"))),
    ("stg2 no proj", dict(stg2_useproj=False)),
)


def option_cfg(base, **over):
    """``base`` with ``over`` on ``model.mm`` (``ode`` a dict of fields)."""
    import dataclasses

    mm_over = dict(over)
    ode = mm_over.pop("ode", None)
    if ode:
        mm_over["ode"] = dataclasses.replace(base.model.mm.ode, **ode)
    return base.replace(model=dataclasses.replace(
        base.model, mm=dataclasses.replace(base.model.mm, **mm_over)))


def build_mm(cfg, dev, seed=0, state=None):
    """``cfg``'s MM in eval mode, seeded weights and non-trivial BN
    statistics (or ``state``), as ``build_towers`` places it: (card copy,
    CPU copy)."""
    from agplace_tpu_torch.infer import compute_dtype, init_weights
    from agplace_tpu_torch.models.mm import MM

    mm = MM(cfg.model.mm, dtype=compute_dtype(cfg))
    if state is None:
        init_weights(mm, torch.Generator().manual_seed(seed))
        seed_bn(mm, np.random.default_rng(seed))
    else:
        mm.load_state_dict(state)
    mm.eval()
    cpu = copy.deepcopy(mm)
    mm.to(dev)
    for p in mm.parameters():
        if p.ndim == 4:
            p.data = p.data.contiguous(memory_format=torch.channels_last)
    return mm, cpu


def sparse_state(grid_state):
    """The bev / dense weights in the sparse backend's layout: [k,k,k,cin,
    cout] kernels as [k^3, cin, cout], 1x1 as [cin, cout], the transposed
    convs' taps flipped (JAX's dense one reads tap 1 - a where its sparse
    one reads tap a)."""
    out = {}
    for k, t in grid_state.items():
        if k.endswith("kernel") and t.ndim == 5:
            if ".tconv" in k:
                t = t.flip(0, 1, 2)
            t = t.reshape(-1, *t.shape[3:])
            if t.shape[0] == 1:
                t = t[0]
        out[k] = t
    return out


def expected_mm(cfg, n):
    """K1..K6 launches of ``n`` eval forwards of ``cfg``'s MM on a grid
    whose stage 0 the kernels take: K1 per FCODE where JAX's gate is open
    (uniform Euler, ``use_pallas``); on the bev backend K2 (K4 with
    ``bev_pallas_head``) once at stage 0 and K3 per ECA block of the FPN
    plus stage 2's voxel refine; K5 in a ResNet stem with ``stem_pallas``
    in bf16; nothing else."""
    from agplace_tpu_torch import ops
    from agplace_tpu_torch.ode.integrators import fixed_steps

    m, o = cfg.model.mm, cfg.model.mm.ode
    uniform = abs(fixed_steps(o.step_size) * o.step_size - 1.0) < 1e-9
    k1 = (len(m.imgfe_planes) * len(o.diff_type.split("_"))
          if "shallow" in m.output_type and o.use_pallas
          and o.method == "euler" and uniform else 0)
    bev = m.voxfe_backend == "bev"
    k3 = ((sum(m.voxfe_layers) if m.voxfe_block == "eca" else 0)
          + m.stg2nlayers) if bev else 0
    head = bev and m.bev_pallas_head
    stem = (m.stem_pallas and m.imgfe.startswith("resnet")
            and cfg.model.compute_dtype == "bfloat16")
    want = dict.fromkeys(ops.launches(), 0)
    want.update(fused_euler_ode=n * k1,
                fused_conv0_down0=n * int(bev and not head),
                fused_head=n * int(head), fused_eca_block_sm=n * k3,
                fused_affine_relu_maxpool=n * int(stem))
    return want


def counted_forward(label, cfg, mm, images, vox):
    """One eval forward on the card with the launch counts reset just
    before and read just after; they must equal ``expected_mm``."""
    from agplace_tpu_torch import ops

    with torch.inference_mode():
        ops.reset_launches()  # ---- the path: one MM forward
        out = mm(images, vox)
        torch.cuda.synchronize()
        counts = ops.launches()  # ---- read just after the path
    want = expected_mm(cfg, 1)
    if counts != want:
        raise AssertionError(f"[{label}] launch counts {counts} != {want}")
    if not all(bool(torch.isfinite(v).all()) for v in out.values()):
        raise AssertionError(f"[{label}] non-finite outputs")
    return out, counts


def against_cpu(label, cfg, gpu_out, cpu_mm, images, points,
                keys=("embedding",), q=OPT_CPU_Q):
    """The card's outputs for the first ``q`` queries against the CPU run
    of the same module on those queries."""
    from agplace_tpu_torch.data.voxels import prepare_query_vox

    with torch.inference_mode():
        cpu = cpu_mm(torch.from_numpy(images[:q]),
                     prepare_query_vox(cfg, points[:q], "cpu"))
    worst = 0.0
    for k in keys:
        g, c = gpu_out[k][:q].float().cpu(), cpu[k].float()
        if g.shape != c.shape:
            raise AssertionError(f"[{label}] {k} {tuple(g.shape)} vs "
                                 f"{tuple(c.shape)}")
        worst = max(worst, float((g - c).abs().max() / c.abs().max()))
    if worst > SLICE_TOL:
        raise AssertionError(f"[{label}] card vs CPU {worst:.3g} of scale "
                             f"> {SLICE_TOL}")
    return worst


def mm_inputs(seed, n, cfg):
    """``n`` query images and LiDAR-like clouds, cropped to the grid extent
    (the condition of JAX's backend-equivalence tests)."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(np.float32)
    points = lidar(rng, n)
    half = np.array(cfg.model.mm.vox_grid_extent) // 2 * cfg.data.quant_size
    inside = np.all((points >= -half) & (points < half), axis=-1)
    return images, np.where(inside[..., None], points, np.nan), float(
        1 - inside.mean())


def phase_mm_backends(cfg, dev, name):
    """[mm-backends]: the MM at b32 on the dense and sparse backends
    beside bev (one set of weights; sparse's reshaped), on clouds cropped
    to the extent: exact launch counts, each against its CPU run and
    against the card's bev MM, and the ms per forward (CUDA events, median
    of 20) and peak memory of each."""
    from agplace_tpu_torch.data.voxels import prepare_query_vox

    images, points, cut = mm_inputs(21, 32, cfg)
    bev, bev_cpu = build_mm(cfg, dev)
    state = bev_cpu.state_dict()
    img = torch.from_numpy(images).to(dev)
    outs, counts, rec = {}, {}, {}
    for backend in ("bev", "dense", "sparse"):
        c = option_cfg(cfg, voxfe_backend=backend)
        if backend == "bev":
            mm, cpu_mm = bev, bev_cpu
        else:
            mm, cpu_mm = build_mm(c, dev, state=sparse_state(state)
                                  if backend == "sparse" else state)
        vox = prepare_query_vox(c, points, dev)
        outs[backend], counts[backend] = counted_forward(
            f"mm-backends {backend}", c, mm, img, vox)
        err = against_cpu(f"mm-backends {backend}", c, outs[backend],
                          cpu_mm, images, points)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            ms = cuda_ms(lambda: mm(img, vox), warmup=2, iters=20)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        rec[backend] = {"ms": ms, "peak_gib": peak, "cpu_err": err}
        del mm, cpu_mm
    for backend in ("dense", "sparse"):
        e = outs[backend]["embedding"].float()
        b = outs["bev"]["embedding"].float()
        rec[backend]["vs_bev"] = float((e - b).abs().max() / b.abs().max())
        if rec[backend]["vs_bev"] > BACKEND_TOL:
            raise AssertionError(f"[mm-backends] {backend} vs bev "
                                 f"{rec[backend]['vs_bev']:.3g} of scale")
    log(f"[mm-backends] b32, bf16, KITTI-360 widths, {cut:.4%} of the "
        f"points outside the extent (dropped): " + json.dumps(
            {k: {x: round(y, 6) for x, y in v.items()}
             for k, v in rec.items()}) + f" ({name}); launches "
        + json.dumps(counts))
    total = dict.fromkeys(counts["bev"], 0)
    for c in counts.values():
        for k, v in c.items():
            total[k] += v
    return total


def phase_mm_ode(cfg, dev, name):
    """[mm-ode]: the MM at b32 with midpoint, rk4 and dopri5 beside Euler
    (K1): K1 launches 0 times; each against its CPU run; dopri5's accepted
    steps per FCODE on the card equal the CPU's on the same batch (its
    error estimate is a mean over the whole batch, so both run the same
    OPT_CPU_Q queries)."""
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.models.fusion import FCODE

    images, points, _ = mm_inputs(22, 32, cfg)
    img = torch.from_numpy(images).to(dev)
    vox = prepare_query_vox(cfg, points, dev)
    total, rec = None, {}
    for method in ("euler", "midpoint", "rk4", "dopri5"):
        c = option_cfg(cfg, ode={"method": method})
        mm, cpu_mm = build_mm(c, dev)
        out, counts = counted_forward(f"mm-ode {method}", c, mm, img, vox)
        if method != "euler":
            total = counts if total is None else {
                k: total[k] + v for k, v in counts.items()}
        with torch.inference_mode():
            ms = cuda_ms(lambda: mm(img, vox), warmup=2, iters=20)
        rec[method] = {"ms": ms}
        if method == "euler":
            continue
        q = OPT_CPU_Q
        with torch.inference_mode():
            small = mm(img[:q], prepare_query_vox(c, points[:q], dev))
        rec[method]["cpu_err"] = against_cpu(f"mm-ode {method}", c, small,
                                             cpu_mm, images, points)
        if method == "dopri5":
            steps = [[int(f.accepted_steps) for f in m.modules()
                      if isinstance(f, FCODE)] for m in (mm, cpu_mm)]
            rec[method]["accepted_steps_card_cpu"] = steps
            if steps[0] != steps[1]:
                raise AssertionError(f"[mm-ode] dopri5 accepted steps "
                                     f"{steps[0]} on the card, {steps[1]} "
                                     f"on the CPU")
        del mm, cpu_mm
    log(f"[mm-ode] b32 ms per forward and card vs CPU ({name}): "
        + json.dumps(rec))
    return total


def phase_mm_options(cfg, dev):
    """[mm-options]: each option of OPTION_VARIANTS at b8, exact launch
    counts, against its CPU run."""
    from agplace_tpu_torch.data.voxels import prepare_query_vox

    images, points, _ = mm_inputs(23, OPT_BATCH, cfg)
    img = torch.from_numpy(images).to(dev)
    total, rec = None, {}
    for label, over in OPTION_VARIANTS:
        c = option_cfg(cfg, **over)
        mm, cpu_mm = build_mm(c, dev)
        out, counts = counted_forward(f"mm-options {label}", c, mm, img,
                                      prepare_query_vox(c, points, dev))
        total = counts if total is None else {
            k: total[k] + v for k, v in counts.items()}
        rec[label] = {"cpu_err": round(against_cpu(
            f"mm-options {label}", c, out, cpu_mm, images, points), 6),
            "dim": out["embedding"].shape[-1],
            "k1_k2_k3": [counts[k] for k in ("fused_euler_ode",
                                             "fused_conv0_down0",
                                             "fused_eca_block_sm")]}
        del mm, cpu_mm
    log("[mm-options] b8: " + json.dumps(rec))
    return total


def phase_ode_lib(cfg, dev, mm):
    """[ode-lib]: QKVAttention and BeltramiODE on the stage-2 image map's
    tokens of the default MM ([32, 256, 256], fp32), a Beltrami case with
    repeated tokens (ties in its top-k), the top-k's tie order, the
    adjoint's gradients against direct backprop, sdeint_euler with sigma =
    0 against Euler, cdeint (euler and rk4): each against the CPU."""
    from agplace_tpu_torch.config import ODEConfig
    from agplace_tpu_torch.infer import init_weights
    from agplace_tpu_torch.models.fusion import (BeltramiODE, QKVAttention,
                                                 topk_lowest_index)
    from agplace_tpu_torch.ode import integrators, sde

    rng = np.random.default_rng(24)
    images = rng.standard_normal((32, IMAGE, IMAGE, 3)).astype(np.float32)
    with torch.inference_mode():
        fmap, _ = mm.image_fe(torch.from_numpy(images).to(dev))
    tokens = fmap.float().reshape(32, -1, fmap.shape[-1]).clone()
    rec = {}

    def both(label, fn, fn_cpu, *args, rows=False):
        """``fn`` on the card against ``fn_cpu`` on the CPU; ``rows``: the
        share of output rows off by more than ODE_LIB_TOL of the scale
        (BeltramiODE: a neighbour within rounding of the k-th similarity
        can swap places) must stay within BELTRAMI_ROWS."""
        with torch.no_grad():
            g = fn(*[a.to(dev) for a in args]).cpu()
            c = fn_cpu(*[a.cpu() for a in args])
        diff = (g - c).abs() / c.abs().max()
        rec[label] = float(diff.max())
        bad = float((diff.amax(dim=-1) > ODE_LIB_TOL).float().mean())
        if rows:
            rec[label + " rows off"] = bad
        if (bad > (BELTRAMI_ROWS if rows else 0.0)
                or not bool(torch.isfinite(g).all())):
            raise AssertionError(f"[ode-lib] {label}: {rec}")

    gen = torch.Generator().manual_seed(24)
    qkv = QKVAttention(256)
    bel = BeltramiODE(256, k=16, ode=ODEConfig())
    for mod in (qkv, bel):
        init_weights(mod, gen)
    qkv_cpu, bel_cpu = copy.deepcopy(qkv), copy.deepcopy(bel)
    qkv.to(dev)
    bel.to(dev)
    both("qkv [32,256,256]", qkv, qkv_cpu, tokens)
    both("beltrami [32,256,256]", bel, bel_cpu, tokens, rows=True)
    dup = tokens.clone()
    half = dup.shape[1] // 2
    dup[:, half:2 * half] = dup[:, :half]  # every token twice: ties
    both("beltrami ties", bel, bel_cpu, dup, rows=True)
    ties = torch.from_numpy(rng.integers(0, 4, (64, 256)).astype(
        np.float32))
    _, i_gpu = topk_lowest_index(ties.to(dev), 16)
    _, i_cpu = topk_lowest_index(ties, 16)
    stable = torch.sort(-ties, dim=1, stable=True).indices[:, :16]
    if not (torch.equal(i_gpu.cpu(), i_cpu) and torch.equal(i_cpu, stable)):
        raise AssertionError("[ode-lib] top-k ties not lowest index first")

    w0 = torch.from_numpy((rng.standard_normal((256, 256)) * 0.06).astype(
        np.float32))
    x0 = torch.from_numpy(rng.standard_normal((32, 256)).astype(np.float32))

    def adjoint_grads(device):
        w, x = (t.to(device).clone().requires_grad_(True)
                for t in (w0, x0))
        out = integrators.odeint_adjoint(
            lambda p, t, y: torch.tanh(y @ p[0]), (w,), x, step_size=0.05,
            method="rk4")
        (out ** 2).sum().backward()
        w2, x2 = (t.to(device).clone().requires_grad_(True)
                  for t in (w0, x0))
        out = integrators.odeint_fixed(lambda t, y: torch.tanh(y @ w2), x2,
                                       step_size=0.05, method="rk4")
        (out ** 2).sum().backward()
        return [v.grad.cpu() for v in (w, x, w2, x2)]

    g_dev, g_cpu = adjoint_grads(dev), adjoint_grads("cpu")
    for i, what in enumerate(("adjoint gw", "adjoint gx", "direct gw",
                              "direct gx")):
        rec[f"{what} card vs cpu"] = float(
            (g_dev[i] - g_cpu[i]).abs().max() / g_cpu[i].abs().max())
    rec["adjoint vs direct gw"] = float(
        (g_dev[0] - g_dev[2]).abs().max() / g_dev[2].abs().max())
    if (max(v for k, v in rec.items() if "card vs cpu" in k) > ODE_LIB_TOL
            or not torch.allclose(g_dev[0], g_dev[2], rtol=0.01, atol=1e-4)
            or not torch.allclose(g_dev[1], g_dev[3], rtol=0.01,
                                  atol=1e-4)):
        raise AssertionError(f"[ode-lib] adjoint gradients {rec}")

    mu = lambda y: torch.tanh(y @ w0.to(y.device))  # noqa: E731
    x_dev = x0.to(dev)
    det = sde.sdeint_euler(mu, lambda y: 0 * y, x_dev,
                           torch.Generator(dev).manual_seed(0))
    eul = integrators.odeint_fixed(lambda t, y: mu(y), x_dev, step_size=0.1)
    rec["sdeint sigma=0 vs euler"] = float(
        (det - eul).abs().max() / eul.abs().max())
    if rec["sdeint sigma=0 vs euler"] > ODE_LIB_TOL:
        raise AssertionError(f"[ode-lib] sdeint vs Euler {rec}")
    wc = torch.from_numpy((rng.standard_normal((64, 64 * 4)) * 0.1).astype(
        np.float32))
    path = torch.from_numpy(np.cumsum(rng.standard_normal((32, 8, 4)),
                                      axis=1).astype(np.float32))
    z0 = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    for method in ("euler", "rk4"):
        def cde(z, p, m=method):
            return sde.cdeint(lambda v: torch.tanh(v @ wc.to(v.device))
                              .reshape(*v.shape[:-1], 64, 4), z, p, m)
        both(f"cdeint {method}", cde, cde, z0, path)
    log("[ode-lib] card vs CPU, fractions of scale: " + json.dumps(
        {k: float(f"{v:.3g}") for k, v in rec.items()}))


def phase_sync_free(dev):
    """The device geometry and dopri5 queue their work without a host sync
    (``set_sync_debug_mode("error")``): ``quantize`` of 32 LiDAR clouds,
    ``sort_by_key``, ``downsample_coords``, ``build_neighbor_table`` and a
    dopri5 FCODE forward; then ``quantize`` equals the host voxelizer."""
    from agplace_tpu_torch.config import ODEConfig
    from agplace_tpu_torch.data.voxels import batched_from_pointclouds
    from agplace_tpu_torch.infer import init_weights
    from agplace_tpu_torch.models.fusion import FCODE
    from agplace_tpu_torch.sparse import voxels

    rng = np.random.default_rng(25)
    pts = lidar(rng, 32)
    fc = FCODE(256, "relu", ODEConfig(method="dopri5"))
    init_weights(fc, torch.Generator().manual_seed(0))
    fc.to(dev)
    pts_dev = torch.from_numpy(pts).to(dev)
    x = torch.from_numpy(rng.standard_normal((32, 256)).astype(
        np.float32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sv = voxels.quantize(pts_dev, 2.0, 8192)
        svs, keys = voxels.sort_by_key(sv)
        oc, om = voxels.downsample_coords(svs, 2)
        table = voxels.build_neighbor_table(
            svs, keys, oc, om, voxels.kernel_offsets(2, 1, dev))
        with torch.no_grad():
            y = fc(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host = batched_from_pointclouds(pts, 2.0, 8192)
    same = all(torch.equal(getattr(sv, f).cpu(), getattr(host, f))
               for f in ("coords", "mask"))
    log(f"[sync-free] quantize, sort_by_key, downsample_coords, "
        f"build_neighbor_table {tuple(table.shape)} and a dopri5 FCODE "
        f"({int(fc.accepted_steps)} accepted steps) ran with no host sync; "
        f"quantize equals the host voxelizer: {same} "
        f"({int(sv.mask.sum())} voxels in 32 clouds)")
    if not same or not bool(torch.isfinite(y).all()):
        raise AssertionError("[sync-free] quantize differs from the host "
                             "voxelizer, or the FCODE is not finite")


def phase_train_sparse(dev):
    """[train-sparse]: ``train()`` at the preset's batch (16 x (2 + 10),
    fp32) for 2 steps on the sparse backend with rk4: finite losses,
    parameters moved, no kernel launched by the steps (rk4 closes K1's
    gate, the sparse backend runs no BEV kernel), the step wall time and
    peak device memory."""
    import shutil

    from agplace_tpu_torch import ops
    from agplace_tpu_torch.train import loop

    save_dir = runs_dir("chip_smoke_train_sparse")
    cfg = train_cfg(queries_per_epoch=32, cache_refresh_rate=32,
                    neg_samples_num=64, epochs_num=1,
                    checkpoint_after_epoch=-1, save_dir=save_dir)
    cfg = option_cfg(cfg, voxfe_backend="sparse", ode={"method": "rk4"})
    train_ds = train_world(cfg, 64, 64, 2)
    test_ds = train_world(cfg, 32, 16, 3)
    rec = {"starts": []}
    real = loop.make_train_step
    before = {}

    def make(c, mesh=None):
        step = real(c, mesh)

        def timed(state, batch):
            if not before:
                before.update({n: p.detach().clone() for n, p in
                               state.mm.named_parameters()})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.reset_launches()
            out = step(state, batch)
            torch.cuda.synchronize()
            rec["starts"].append(time.perf_counter() - t0)
            rec.setdefault("launches", []).append(ops.launches())
            return out
        return timed

    loop.make_train_step = make
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out = loop.train(cfg, train_ds, test_ds, device=dev)
        t_train = time.perf_counter() - t0
    finally:
        loop.make_train_step = real
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = out["history"][0]["losses"]
    moved = sum(not torch.equal(p, before[n])
                for n, p in out["state"].mm.named_parameters())
    zero = dict.fromkeys(ops.launches(), 0)
    log(f"[train-sparse] train() in {t_train:.2f} s, {out['state'].step} "
        f"steps of 16 x (2 + 10) on the sparse backend with rk4: step wall "
        f"ms {[round(s * 1e3, 1) for s in rec['starts']]}, losses {losses}, "
        f"{moved} of {len(before)} MM parameters moved, peak device memory "
        f"{peak:.2f} GiB")
    if (out["state"].step != 2 or not np.isfinite(losses).all()
            or moved < len(before) // 2
            or any(c != zero for c in rec["launches"])):
        raise AssertionError(f"[train-sparse] steps {out['state'].step}, "
                             f"losses {losses}, moved {moved}, launches "
                             f"{rec['launches']}")
    shutil.rmtree(save_dir, ignore_errors=True)



# ---- the factory's other towers: GeoLoc, MinkLoc, the image branches -----

GEO_TILES = 512
FAMILY_BATCH = 8  # [geoloc-families], [mm-imgfe]'s other branches
FAMILY_CPU = 2  # images each family's card run is held to on the CPU
# [geoloc-train]: k-means of the same descriptors from the same initial
# rows on the card and on the CPU; fp32, TF32 off, so only the distance
# products' summation order differs (an assignment flips only at a tie)
KMEANS_TOL = 1e-4
GEO_FAMILIES = (
    ("resnet101conv4", "gem"), ("resnet18conv5", "rmac"),
    ("vgg16", "crn"), ("alexnet", "spoc"), ("vit", "cls"), ("vit", "gem"),
    ("cct384", "seqpool"), ("resnet50conv4", "mac"),
    ("resnet50conv4", "convap"), ("resnet50conv4", "cosplace"),
    ("resnet50conv4", "mixvpr"), ("resnet50conv4", "rrm"),
    ("resnet50conv4", "crn"),
)


def family_cfg(base, mm=None, db=None, **model):
    """``base`` with ``model`` fields and ``model.mm`` / ``model.db``
    overrides."""
    import dataclasses

    m = base.model
    return base.replace(model=dataclasses.replace(
        m, mm=dataclasses.replace(m.mm, **(mm or {})),
        db=dataclasses.replace(m.db, **(db or {})), **model))


def geoloc_cfg(base, **over):
    """The headline: DVGLB's ResNet-50 conv4 + NetVLAD (64 clusters) as
    both towers."""
    kw = dict(modelq="geoloc", backbone="resnet50conv4",
              aggregation="netvlad", netvlad_clusters=64)
    kw.update(over)
    return family_cfg(base, db=dict(modeldb="geoloc"), **kw)


def family_towers(cfg, dev, seed=0, query_only=False):
    """``cfg``'s towers as ``build_towers`` places them, seeded weights
    and non-trivial BN statistics: ((card query, card aerial), (CPU query,
    CPU aerial)); an absent aerial tower (or with ``query_only``) is
    None."""
    from agplace_tpu_torch.infer import (build_towers, compute_dtype,
                                         init_weights)
    from agplace_tpu_torch.models.factory import make_query_model

    g = torch.Generator().manual_seed(seed)
    if query_only:
        towers = (make_query_model(cfg, compute_dtype(cfg)), None)
        init_weights(towers[0], g)
        towers[0].eval()
    else:
        towers = build_towers(cfg, "cpu", g)
    rng = np.random.default_rng(seed)
    for t in towers:
        if t is not None:
            seed_bn(t, rng)
    cpu = tuple(None if t is None else copy.deepcopy(t) for t in towers)
    card_towers = []
    for t in towers:
        if t is not None:
            t.to(dev)
            for p in t.parameters():
                if p.ndim == 4:
                    p.data = p.data.contiguous(
                        memory_format=torch.channels_last)
        card_towers.append(t)
    return tuple(card_towers), cpu


def zero_launches(label, counts):
    if any(counts.values()):
        raise AssertionError(f"[{label}] kernels launched: {counts}")


def held_to_cpu(label, gpu, cpu, tol=SLICE_TOL):
    """max |card - CPU| over max |CPU| within ``tol``; returns it."""
    gpu, cpu = gpu.float().cpu(), cpu.float()
    if gpu.shape != cpu.shape or not bool(torch.isfinite(gpu).all()):
        raise AssertionError(f"[{label}] {tuple(gpu.shape)} vs "
                             f"{tuple(cpu.shape)} or non-finite")
    err = float((gpu - cpu).abs().max() / cpu.abs().max())
    if err > tol:
        raise AssertionError(f"[{label}] card vs CPU {err:.3g} of scale > "
                             f"{tol}")
    return err


def timed_forward(fn, iters=20):
    """(ms per call, CUDA events, median of ``iters``; peak device memory
    of the calls in GiB above what was allocated before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = cuda_ms(fn, warmup=2, iters=iters)
    return ms, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def phase_geoloc(base, dev, name):
    """[geoloc]: the headline GeoLoc towers (kitti360_config(), resnet50
    conv4 + NetVLAD, 65,536-d) behind a ``PlaceIndex`` of 512 tiles and
    requests of 1, 7 and 32 queries, a planted top-1 hit, zero launches;
    2 queries and 2 tiles against the CPU run; ms per forward (CUDA
    events, median of 20) and peak memory at b32 and b128."""
    from agplace_tpu_torch import ops
    from agplace_tpu_torch.serving import PlaceIndex

    cfg = geoloc_cfg(base)
    (q, db), (cpu_q, cpu_db) = family_towers(cfg, dev)
    idx = PlaceIndex(cfg, (q, db), device=dev)
    rng = np.random.default_rng(30)
    requests = [rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(
        np.float32) for n in (1, 7, 32)]
    ops.reset_launches()  # ---- the path: gallery + three requests
    t0 = time.perf_counter()
    n_rows = idx.add_tiles(Tiles(GEO_TILES))
    torch.cuda.synchronize()
    t_gallery = time.perf_counter() - t0
    t0 = time.perf_counter()
    answers = [idx.search(images, k=5) for images in requests]
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    counts = ops.launches()  # ---- read just after the path
    zero_launches("geoloc", counts)
    if n_rows != GEO_TILES or idx.dim != 65536:
        raise AssertionError(f"[geoloc] {n_rows} rows of {idx.dim}")
    for images, (d, i) in zip(requests, answers):
        n = images.shape[0]
        if d.shape != (n, 5) or not (np.isfinite(d).all() and (
                (i >= 0) & (i < GEO_TILES)).all()):
            raise AssertionError("[geoloc] bad search answers")
    planted = idx.add_descriptors(idx.embed(requests[1][:1])) - 1
    d, i = idx.search(requests[1][:1], k=5)
    if i[0, 0] != planted:
        raise AssertionError("[geoloc] planted descriptor is not top-1")
    images = torch.from_numpy(requests[2][:FAMILY_CPU])
    tiles = torch.from_numpy(np.stack([Tiles(2).load_db_maps(j)
                                       for j in range(FAMILY_CPU)]))
    with torch.inference_mode():
        err_q = held_to_cpu("geoloc query", q(images.to(dev)), cpu_q(images))
        err_d = held_to_cpu("geoloc tile", db(tiles.to(dev)), cpu_db(tiles))
    rec = {}
    for b in (32, 128):
        x = torch.from_numpy(np.random.default_rng(b).standard_normal(
            (b, IMAGE, IMAGE, 3)).astype(np.float32)).to(dev)
        rec[b] = timed_forward(lambda: q(x))
        del x
    log(f"[geoloc] {name}: resnet50conv4 + NetVLAD x 64 (65,536-d), fp32 "
        f"(JAX's factory gives GeoLoc no dtype); gallery of {n_rows} tiles "
        f"in {t_gallery:.2f} s, 3 requests in {t_search:.2f} s, planted "
        f"row top-1, launches 0; card vs CPU: queries {err_q:.3g}, tiles "
        f"{err_d:.3g} of scale; ms per forward at {IMAGE} px (CUDA events, "
        f"median of 20) and peak GiB: " + json.dumps(
            {f"b{b}": {"ms": round(ms, 3), "peak_gib": round(pk, 3)}
             for b, (ms, pk) in rec.items()}))
    del idx, q, db
    return counts


def phase_geoloc_train(dev, name):
    """[geoloc-train]: ``train()`` with the headline towers in fp32 at the
    preset's 16 x (2 + 10): the dataset NetVLAD init on the card (and its
    k-means against the CPU's from the same initial rows on the same
    descriptors), 4 steps, finite losses, parameters moved, zero launches,
    step wall time and peak memory; then ``PlaceIndex.from_checkpoint``
    answers one request."""
    import shutil

    from agplace_tpu_torch import ops
    from agplace_tpu_torch.retrieval.kmeans import kmeans
    from agplace_tpu_torch.serving import PlaceIndex
    from agplace_tpu_torch.train import loop

    save_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "_runs", "chip_smoke_geoloc_train")
    shutil.rmtree(save_dir, ignore_errors=True)
    cfg = geoloc_cfg(train_cfg(queries_per_epoch=64, cache_refresh_rate=64,
                               neg_samples_num=128, epochs_num=1,
                               checkpoint_after_epoch=-1,
                               save_dir=save_dir))
    n_steps = 64 // cfg.train.train_batch_size
    train_ds = train_world(cfg, 128, 128, 0)
    test_ds = train_world(cfg, 64, 32, 1)

    # the init's k-means on the card and on the CPU: the same descriptors
    # (the card backbone's, 100 of each of 8 training queries, normalised
    # as the init does), the same initial rows
    (q, _), _ = family_towers(cfg, dev)
    images = np.stack([train_ds.load_query_image(i) for i in range(8)])
    with torch.inference_mode():
        maps = q.backbone(torch.from_numpy(images).to(dev))[0]
    flat = maps.float().cpu().flatten(1, 2)[:, :100]
    descs = (flat / flat.norm(dim=-1, keepdim=True).clamp(min=1e-12)
             ).reshape(-1, flat.shape[-1])
    init_idx = torch.randperm(len(descs), generator=torch.Generator()
                              .manual_seed(0))[:64]
    c_gpu, a_gpu = kmeans(descs.to(dev), 64, init_idx=init_idx)
    c_cpu, a_cpu = kmeans(descs, 64, init_idx=init_idx)
    km_err = held_to_cpu("geoloc-train k-means", c_gpu, c_cpu, KMEANS_TOL)
    km_flips = int((a_gpu.cpu() != a_cpu).sum())
    del q, maps

    rec = {"starts": []}
    real = loop.make_train_step
    # step starts on the host clock; n_steps + 1: no step under the
    # profiler (its start-up alone took ~7 s on the card)
    loop.make_train_step = _step_recorder(loop, n_steps + 1, rec)
    torch.cuda.reset_peak_memory_stats()
    try:
        ops.reset_launches()  # ---- the path: train()
        t0 = time.perf_counter()
        out = loop.train(cfg, train_ds, test_ds, device=dev)
        t_train = time.perf_counter() - t0
        counts = ops.launches()  # ---- read just after the path
    finally:
        loop.make_train_step = real
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    zero_launches("geoloc-train", counts)
    state = out["state"]
    losses = out["history"][0]["losses"]
    if (state.step != n_steps or len(losses) != n_steps
            or not np.isfinite(losses).all()):
        raise AssertionError(f"[geoloc-train] steps {state.step}, losses "
                             f"{losses}")
    fresh, _ = family_towers(cfg, dev)  # the same seed: the initial weights
    moved = sum(not torch.equal(a, b) for (_, a), b in zip(
        state.mm.named_parameters(), fresh[0].parameters()))
    centroids_set = not torch.equal(state.mm.aggregation.netvlad.centroids,
                                    fresh[0].aggregation.netvlad.centroids)
    del fresh
    if moved < 100 or not centroids_set:
        raise AssertionError(f"[geoloc-train] {moved} leaves moved, "
                             f"centroids set {centroids_set}")
    starts = rec["starts"]
    walls = [(b - a) * 1e3 for a, b in zip(starts[1:], starts[2:])]
    idx = PlaceIndex.from_checkpoint(cfg, save_dir, "best_model", dev)
    idx.add_tiles(test_ds)
    d, i = idx.search(test_ds.load_query_image(0)[None], k=5)
    if not (np.isfinite(d).all() and ((i >= 0) & (i < 64)).all()):
        raise AssertionError("[geoloc-train] from_checkpoint answered badly")
    log(f"[geoloc-train] {name}: k-means of 800 card descriptors, card vs "
        f"CPU from the same 64 rows: centroids {km_err:.3g} of scale, "
        f"{km_flips} assignments differ; train() in {t_train:.2f} s "
        f"(NetVLAD init, mining, {n_steps} steps of "
        f"{cfg.train.train_batch_size} x (2 + "
        f"{cfg.train.negs_num_per_query}), "
        f"evaluation; phases {json.dumps(out['phase_times'])}), losses "
        f"{losses}, {moved} parameter leaves moved, launches 0; step wall "
        f"ms (host clock between step starts, steps 2-{n_steps - 1}) "
        f"{[round(w, 1) for w in walls]}; peak device memory "
        f"{peak:.2f} GiB; from_checkpoint top-5 {i[0].tolist()}")
    shutil.rmtree(save_dir, ignore_errors=True)
    return counts


def phase_geoloc_families(base, dev, name):
    """[geoloc-families]: each other backbone and head at b8 (ViT-B/16 and
    CCT-14 at full depth), zero launches, 2 images against the CPU, ms per
    forward (median of 10)."""
    from agplace_tpu_torch import ops

    rng = np.random.default_rng(31)
    x = rng.standard_normal((FAMILY_BATCH, IMAGE, IMAGE, 3)).astype(
        np.float32)
    rec, total = {}, None
    for backbone, agg in GEO_FAMILIES:
        cfg = geoloc_cfg(base, backbone=backbone, aggregation=agg)
        (q, _), (cpu_q, _) = family_towers(cfg, dev)
        xg = torch.from_numpy(x).to(dev)
        with torch.inference_mode():
            ops.reset_launches()  # ---- the path: one forward
            out = q(xg)
            torch.cuda.synchronize()
            counts = ops.launches()  # ---- read just after the path
            err = held_to_cpu(f"geoloc {backbone} {agg}", out[:FAMILY_CPU],
                              cpu_q(torch.from_numpy(x[:FAMILY_CPU])))
        zero_launches(f"geoloc-families {backbone} {agg}", counts)
        ms, _ = timed_forward(lambda: q(xg), iters=10)
        rec[f"{backbone}+{agg}"] = {"dim": int(out.shape[1]),
                                    "cpu_err": round(err, 8),
                                    "ms_b8": round(ms, 3)}
        total = counts if total is None else {
            k: total[k] + v for k, v in counts.items()}
        del q, cpu_q, xg
    log(f"[geoloc-families] {name}: b{FAMILY_BATCH} at {IMAGE} px, fp32 "
        f"(CCT in the compute dtype), launches 0: " + json.dumps(rec))
    return total


def db_forward_counted(label, db, maps, cpu_db, want):
    from agplace_tpu_torch import ops

    with torch.inference_mode():
        ops.reset_launches()  # ---- the path: one aerial-tower forward
        out = db(maps)
        torch.cuda.synchronize()
        counts = ops.launches()  # ---- read just after the path
        err = held_to_cpu(label, out[:FAMILY_CPU],
                          cpu_db(maps[:FAMILY_CPU].cpu()))
    if counts != want:
        raise AssertionError(f"[{label}] launch counts {counts} != {want}")
    return counts, err


def phase_mm_imgfe(base, dev, name):
    """[mm-imgfe]: the MM beside a ResNet-50 DBVanilla2D behind a
    ``PlaceIndex`` of 512 tiles, default and fused (exact launch counts:
    K5 once per map type per fused aerial forward, on the ResNet-50 stem),
    2 queries and 2 tiles against the CPU, ms per aerial-tower forward at
    b32 beside resnet18's; then at b8 the MM with the squeezenet11 image
    branch (default and fused: no K5, no ResNet stem) and the
    convnext_tiny / squeezenet11 aerial towers (no launch)."""
    from agplace_tpu_torch.data.voxels import prepare_query_vox

    out_counts = []
    r50 = family_cfg(base, db=dict(image_fe="resnet50"))
    r50_f = family_cfg(base, mm=dict(bev_pallas_head=True, stem_pallas=True),
                       db=dict(image_fe="resnet50", stem_pallas=True))
    tiles = torch.from_numpy(np.stack([Tiles(2).load_db_maps(j)
                                       for j in range(FAMILY_CPU)]))
    tile_err, aerial = {}, {}
    for label, cfg in (("mm-imgfe", r50), ("mm-imgfe-fused", r50_f)):
        (mm, db), (cpu_mm, cpu_db), requests, counts = phase_serving(
            cfg, dev, N_TILES, label)
        phase_slice_parity(cfg, mm, cpu_mm, requests, dev, label)
        with torch.inference_mode():
            tile_err[label] = held_to_cpu(label, db(tiles.to(dev)),
                                          cpu_db(tiles))
        out_counts.append(counts)
        aerial[label] = db
        del mm, cpu_mm, cpu_db
    for label, cfg in (("resnet18", base), ("resnet18 fused", family_cfg(
            base, db=dict(stem_pallas=True)))):
        aerial[label] = family_towers(cfg, dev)[0][1]
    x = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (32, 1, IMAGE, IMAGE, 3)).astype(np.float32)).to(dev)
    db_ms = {k: timed_forward(lambda: db(x)) for k, db in aerial.items()}
    del aerial, db, x

    # the other image branches at b8
    images, points, _ = mm_inputs(33, FAMILY_BATCH, base)
    maps = torch.from_numpy(np.random.default_rng(34).standard_normal(
        (FAMILY_BATCH, 1, IMAGE, IMAGE, 3)).astype(np.float32)).to(dev)
    sq = dict(imgfe="squeezenet11", imgfe_planes=(128, 256, 256),
              imgfe_dim=256)
    other = {}
    for label, cfg, want in (
            ("mm squeezenet11", family_cfg(base, mm=sq), None),
            ("mm squeezenet11 fused", family_cfg(
                base, mm=dict(sq, bev_pallas_head=True, stem_pallas=True)),
             {"fused_euler_ode": 3, "fused_eca_block_sm": 4,
              "fused_head": 1})):
        (mm, _), (cpu_mm, _) = family_towers(cfg, dev)
        vox = prepare_query_vox(cfg, points, dev)
        if want is None:
            out, counts = counted_forward(label, cfg, mm, torch.from_numpy(
                images).to(dev), vox)
        else:
            from agplace_tpu_torch import ops

            with torch.inference_mode():
                ops.reset_launches()  # ---- the path: one MM forward
                out = mm(torch.from_numpy(images).to(dev), vox)
                torch.cuda.synchronize()
                counts = ops.launches()  # ---- read just after the path
            full = dict.fromkeys(counts, 0)
            full.update(want)
            if counts != full:
                raise AssertionError(f"[{label}] launch counts {counts} "
                                     f"!= {full}")
        other[label] = against_cpu(label, cfg, out, cpu_mm, images, points,
                                   keys=("imagevec_org", "embedding"))
        out_counts.append(counts)
        del mm, cpu_mm
    for fe in ("convnext_tiny", "squeezenet11"):
        cfg = family_cfg(base, db=dict(image_fe=fe))
        (_, db), (_, cpu_db) = family_towers(cfg, dev)
        counts, other[f"db {fe}"] = db_forward_counted(
            f"mm-imgfe db {fe}", db, maps, cpu_db,
            dict.fromkeys(out_counts[0], 0))
        out_counts.append(counts)
        del db, cpu_db
    log(f"[mm-imgfe] {name}: ResNet-50 aerial tiles card vs CPU "
        f"{json.dumps({k: round(v, 8) for k, v in tile_err.items()})}; "
        f"aerial-tower ms per b32 forward (bf16, CUDA events, median of "
        f"20) and peak GiB: " + json.dumps(
            {k: {"ms": round(ms, 3), "peak_gib": round(pk, 3)}
             for k, (ms, pk) in db_ms.items()})
        + f"; b{FAMILY_BATCH} card vs CPU: "
        + json.dumps({k: round(v, 8) for k, v in other.items()}))
    total = dict.fromkeys(out_counts[0], 0)
    for c in out_counts:
        for k, v in c.items():
            total[k] += v
    return total


def phase_minkloc(base, dev, name):
    """[minkloc]: MinkLoc and MinkLocMultimodal (features_dim 256, planes
    (32, 64, 64)) at b32 on [mm-backends]' cropped clouds, zero launches,
    2 samples against the CPU, ms per forward."""
    from agplace_tpu_torch import ops
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.models.factory import query_apply

    images, points, _ = mm_inputs(21, 32, base)
    rec, total = {}, None
    for modelq in ("minkloc", "minkloc_multimodal"):
        cfg = family_cfg(base, modelq=modelq)
        (q, _), (cpu_q, _) = family_towers(cfg, dev, query_only=True)
        vox = prepare_query_vox(cfg, points, dev)
        img = torch.from_numpy(images).to(dev)
        with torch.inference_mode():
            ops.reset_launches()  # ---- the path: one forward
            out = query_apply(q, img, vox)["embedding"]
            torch.cuda.synchronize()
            counts = ops.launches()  # ---- read just after the path
            cpu = query_apply(cpu_q, torch.from_numpy(images[:FAMILY_CPU]),
                              prepare_query_vox(cfg, points[:FAMILY_CPU],
                                                "cpu"))["embedding"]
        zero_launches(f"minkloc {modelq}", counts)
        err = held_to_cpu(f"minkloc {modelq}", out[:FAMILY_CPU], cpu)
        ms, pk = timed_forward(lambda: query_apply(q, img, vox), iters=10)
        rec[modelq] = {"dim": int(out.shape[1]), "cpu_err": round(err, 8),
                       "ms_b32": round(ms, 3), "peak_gib": round(pk, 3)}
        total = counts if total is None else {
            k: total[k] + v for k, v in counts.items()}
        del q, cpu_q
    log(f"[minkloc] {name}: b32, KITTI-360 clouds cropped to the extent, "
        f"launches 0: " + json.dumps(rec))
    return total


def phase_family_cli(dev, tree):
    """[family-cli]: ``train --modelq geoloc --modeldb geoloc --backbone
    resnet50conv4 --aggregation netvlad`` for 2 steps on the
    [data-kitti360] tree, then ``serve build`` and ``serve search
    --resume`` as subprocesses on the card; each exits 0 and the search
    answers as the in-process index."""
    from agplace_tpu_torch.config import parse_arguments
    from agplace_tpu_torch.embed import batched_embed_q
    from agplace_tpu_torch.serving import PlaceIndex
    from agplace_tpu_torch.train.cli import build_datasets

    save_dir = runs_dir("chip_smoke_family_cli")
    family = ["--modelq", "geoloc", "--modeldb", "geoloc", "--backbone",
              "resnet50conv4", "--aggregation", "netvlad"]
    data = ["--dataset", "kitti360", "--dataroot", tree, "--save_dir",
            save_dir, *family]
    t0 = time.perf_counter()
    cli("agplace_tpu_torch.train", *data, "--pretrained", "false",
        "--queries_per_epoch", "32", "--cache_refresh_rate", "32",
        "--epochs_num", "1")
    t_train = time.perf_counter() - t0
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        epoch = json.loads(f.readline())
    if epoch["steps"] != 2 or not np.isfinite(epoch["losses"]).all():
        raise AssertionError(f"[family-cli] train: {epoch}")
    data += ["--resume", "best_model"]
    gal = os.path.join(save_dir, "g.npz")
    t0 = time.perf_counter()
    cli("agplace_tpu_torch.serve", "build", "--gallery_out", gal, *data)
    out, _ = cli("agplace_tpu_torch.serve", "search", "--gallery", gal,
                 "--k", "5", *data)
    t_serve = time.perf_counter() - t0
    cfg, _ = parse_arguments(data)
    _, test_ds = build_datasets(cfg)
    idx = PlaceIndex.from_checkpoint(cfg, save_dir, "best_model", dev)
    idx.load_gallery(gal)
    q = batched_embed_q(test_ds, list(range(test_ds.queries_num)),
                        idx._embed_q, cfg.train.infer_batch_size, cfg, dev)
    log(f"[family-cli] train (2 steps, geoloc resnet50conv4 + NetVLAD, "
        f"losses {epoch['losses']}, recalls {epoch['recalls']}) in "
        f"{t_train:.1f} s; serve build + search in {t_serve:.1f} s; "
        f"descriptors {q.shape}")
    check_rows("family-cli search --resume", out,
               *idx.locate_descriptors(q, 5))
    import shutil

    shutil.rmtree(save_dir, ignore_errors=True)


# ---- the single-device tail: pretrained grafts, AnyLoc, the rest --------

PRE_ARCHS = ("resnet18", "resnet50", "vit")  # the seeded weight files
PRE_STEPS = 2  # [pretrained]: train() steps of 16 x (2 + 10)
ANYLOC_IMAGE = 224
ANYLOC_BATCH = 32
ANYLOC_CPU = 4  # images the card's DINOv2 forward is held to on the CPU
VLAD_DB, VLAD_Q = 64, 32  # 64 x 256 patches = 16,384 descriptors
# AnyLoc runs fp32 with TF32 off: the card and the CPU differ only in
# their summation orders
ANYLOC_TOL = 1e-4
# [anyloc]: the k-means objective of the card's fit against the CPU's
# float32 and float64 fits from the same rows, relative (their
# assignments part at a near tie and then follow other paths; measured
# 5e-5 on an H100)
VLAD_OBJ_TOL = 2e-4
# [anyloc]: the VLADs of the card and the CPU on the same centres, of
# scale (measured 4.6e-7 on an H100)
VLAD_TOL = 2e-6
METRIC_N = 1024
METRIC_TOL, METRIC_GRAD_TOL = 1e-5, 1e-4
FOLDER_DB, FOLDER_Q = 64, 32
# AnyLoc's public setting: ViT-g/14's widths at its layer 31, facet value
VIT_G = dict(hidden=1536, depth=40, heads=24, layer=31)


def plain_checks():
    """Each of K1-K5's wrappers paired with its plain version, its
    argument preparation and the tolerance of [parity]."""
    from agplace_tpu_torch.ops import (bev_block_sm, bev_down, bev_head,
                                       ode_step, stem_pool)

    bf16 = torch.bfloat16

    def k1(a, k):
        return ode_step.euler_ode_plain(*a, **k)

    def k2(a, k):
        return bev_down.conv0_down0_plain(a[0].to(bf16), *a[1:], **k)

    def k3(a, k):
        return bev_block_sm.eca_block_plain(a[0].to(bf16), *a[1:], **k)

    def k4(a, k):
        return bev_head.head_plain(*a, **k)

    def k5(a, k):
        return stem_pool.stem_pool_plain(a[0].to(bf16), *a[1:], **k)

    return ((ode_step, "fused_euler_ode", k1, K1_TOL),
            (bev_down, "fused_conv0_down0", k2, KSTAGE0_TOL),
            (bev_block_sm, "fused_eca_block_sm", k3, KBF16_TOL),
            (bev_head, "fused_head", k4, KSTAGE0_TOL),
            (stem_pool, "fused_affine_relu_maxpool", k5, EXACT))


class held_to_plain:
    """While active, every launch of K1-K5 is followed by its plain
    version on the same inputs on the card, and the two are compared with
    [parity]'s tolerances (the worst error by kernel in ``worst``, the
    launches compared in ``checked``).  The plain calls launch no kernel:
    the counts are the path's own.  With ``keep`` (a dict), the arguments
    of each instance's first launch are kept there under (kernel,
    instance), the instance read from the wrapper's ``instances``."""

    def __init__(self, label, keep=None):
        self.label, self.worst, self.checked, self.saved = label, {}, {}, []
        self.keep = keep

    def __enter__(self):
        for mod, name, plain, tol in plain_checks():
            real = getattr(mod, name)

            def wrapper(*a, _real=real, _plain=plain, _tol=tol,
                        _name=name, **k):
                before = dict(getattr(_real, "instances", {}))
                out = _real(*a, **k)
                if self.keep is not None:
                    for inst, n in getattr(_real, "instances", {}).items():
                        if n > before[inst]:
                            self.keep.setdefault((_name, inst), (a, k))
                ref = _plain(a, k)
                got, want = ((out[0], ref[0]) if isinstance(out, tuple)
                             else (out, ref))
                rec = compare(f"[{self.label}] {_name} (a launch)", got,
                              want, _tol)
                self.worst[_name] = max(self.worst.get(_name, 0.0),
                                        rec["max_abs_err"])
                self.checked[_name] = self.checked.get(_name, 0) + 1
                return out

            wrapper.launches = real.launches
            if hasattr(real, "instances"):  # one dict, counted by the real
                wrapper.instances = real.instances
            wrapper.__name__ = name
            setattr(mod, name, wrapper)
            self.saved.append((mod, name, real))
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            real.launches = getattr(mod, name).launches
            setattr(mod, name, real)
        return False


def weights_dir():
    """Seeded state_dicts of ``PRE_ARCHS`` in their shipping layouts
    (``scripts/write_torch_weights.py``) in a temporary directory outside
    the tree; (directory, {arch: state_dict})."""
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import write_torch_weights

    path = tempfile.mkdtemp(prefix="agp_weights_")
    write_torch_weights.write(path, PRE_ARCHS)
    return path, {a: torch.load(os.path.join(path, f"{a}-seeded.pth"),
                                weights_only=True) for a in PRE_ARCHS}


def resnet_port_key(key):
    """A torchvision ResNet entry's name in the port's ``ResNetFeatures``:
    ``layer2.1.conv1.weight`` -> ``layer2_1.conv1.weight``, the downsample
    pair -> ``downsample_conv`` / ``downsample_bn``."""
    parts = key.split(".")
    if parts[0].startswith("layer"):
        parts[:2] = [f"{parts[0]}_{parts[1]}"]
    name = ".".join(parts)
    return (name.replace("downsample.0.", "downsample_conv.")
            .replace("downsample.1.", "downsample_bn."))


def check_resnet_graft(label, tower, prefix, sd, stages):
    """Every entry of the torchvision dict inside the tower's ``stages``
    is bit-equal to the port's tensor (OIHW convs and BN vectors keep
    torchvision's layout); returns the count."""
    ours = tower.state_dict()
    n = 0
    for k, v in sd.items():
        if k.startswith("fc.") or (k.startswith("layer")
                                   and int(k[5]) > stages):
            continue
        got = ours[f"{prefix}.{resnet_port_key(k)}"].detach().cpu()
        if not torch.equal(got.contiguous(), v):
            raise AssertionError(f"[{label}] {prefix}.{k} not grafted")
        n += 1
    return n


def check_vit_graft(label, backbone, sd, n_tokens):
    """The HF ViT-B/16 dict in the port's ``ViTBackbone``: every kept
    layer bit-equal (q / k / v kernels [768, 12, 64], out [12, 64, 768]),
    the positional table resized to ``n_tokens`` with its CLS row kept."""
    d, h = 768, 12
    pos = backbone.pos.detach().cpu()
    if tuple(pos.shape) != (1, n_tokens, d) or not torch.equal(
            pos[0, 0], sd["embeddings.position_embeddings"][0, 0]):
        raise AssertionError(f"[{label}] pos {tuple(pos.shape)}")
    want = {"cls": sd["embeddings.cls_token"],
            "embed.weight": sd["embeddings.patch_embeddings.projection."
                               "weight"],
            "ln_f.weight": sd["layernorm.weight"]}
    for i in range(backbone.n_layers):
        src = f"encoder.layer.{i}"
        for f in ("query", "key", "value"):
            w = sd[f"{src}.attention.attention.{f}.weight"]
            want[f"attn_{i}.{f}.kernel"] = w.T.reshape(d, h, d // h)
        want[f"attn_{i}.out.kernel"] = sd[
            f"{src}.attention.output.dense.weight"].T.reshape(h, d // h, d)
        want[f"mlp1_{i}.weight"] = sd[f"{src}.intermediate.dense.weight"]
        want[f"ln2_{i}.bias"] = sd[f"{src}.layernorm_after.bias"]
    ours = backbone.state_dict()
    for k, v in want.items():
        if not torch.equal(ours[k].detach().cpu().contiguous(),
                           v.contiguous()):
            raise AssertionError(f"[{label}] backbone.{k} not grafted")
    return len(want)


def pretrained_cfg(base, wdir, **model):
    import dataclasses

    return base.replace(model=dataclasses.replace(
        base.model, pretrained=True, pretrained_path=wdir, **model))


def phase_pretrained(base, dev, name, wdir, sds):
    """[pretrained]: seeded torchvision-layout ResNet-18 / ResNet-50 and an
    HF-layout ViT-B/16 behind ``--pretrained_path``.  ``init_state`` of
    ``kitti360_config()`` on the card grafts the MM's and the aerial
    tower's ResNet-18 branches (every leaf bit-equal to the dict's);
    ``train()`` takes 2 steps at 16 x (2 + 10) from them (finite losses,
    step wall time, peak memory); the grafted towers' b32 eval forward in
    the default and fused configurations launches K1-K5 with [serving]'s
    counts per forward, each launch held to its plain version on the same
    inputs, the embeddings to the CPU; GeoLoc with ``resnet50conv4`` and
    ``vit`` at 256 px grafted (ViT's table resized to 257 tokens) and one
    forward each."""
    import dataclasses
    import shutil

    from agplace_tpu_torch import ops
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.train import loop
    from agplace_tpu_torch.train.step import init_state

    # the graft on the card: kitti360_config(), fp32
    cfg = pretrained_cfg(train_cfg(), wdir)
    t0 = time.perf_counter()
    mm, db = init_state(cfg, dev).towers
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    stages = len(cfg.model.mm.imgfe_layers)
    n_mm = check_resnet_graft("pretrained", mm, "image_fe.fe",
                              sds["resnet18"], stages)
    n_db = sum(check_resnet_graft(
        "pretrained", db, f"fe_{i}.fe", sds["resnet18"],
        len(cfg.model.db.image_fe_layers))
        for i in range(1 if cfg.model.db.share_dbfe else cfg.data.nmap))
    del mm, db

    # train() from the grafted towers
    save_dir = runs_dir("chip_smoke_pretrained")
    cfg_t = pretrained_cfg(train_cfg(
        queries_per_epoch=16 * PRE_STEPS, cache_refresh_rate=16 * PRE_STEPS,
        neg_samples_num=64, epochs_num=1, checkpoint_after_epoch=-1,
        save_dir=save_dir), wdir)
    walls = []
    real = loop.make_train_step

    def make(c, mesh=None):
        step = real(c, mesh)

        def timed(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            return out
        return timed

    loop.make_train_step = make
    torch.cuda.reset_peak_memory_stats()
    try:
        out = loop.train(cfg_t, train_world(cfg_t, 64, 64, 4),
                         train_world(cfg_t, 32, 16, 5), device=dev)
    finally:
        loop.make_train_step = real
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = out["history"][0]["losses"]
    if out["state"].step != PRE_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"[pretrained] train: {losses}")
    shutil.rmtree(save_dir, ignore_errors=True)
    del out
    log(f"[pretrained] {name}: init_state grafted {n_mm} MM and {n_db} "
        f"aerial-tower leaves of the ResNet-18 file, each bit-equal, in "
        f"{t_init:.2f} s; train() {PRE_STEPS} steps of 16 x (2 + 10) fp32 "
        f"from them: losses {losses}, step wall ms "
        f"{[round(w, 1) for w in walls]} (synchronised), peak "
        f"{peak:.2f} GiB")

    # the grafted towers' eval forward, default and fused, bf16
    bf = base.replace(model=dataclasses.replace(base.model,
                                                compute_dtype="bfloat16"))
    fused = bf.replace(model=dataclasses.replace(
        bf.model, mm=dataclasses.replace(bf.model.mm, bev_pallas_head=True,
                                         stem_pallas=True),
        db=dataclasses.replace(bf.model.db, stem_pallas=True)))
    rng = np.random.default_rng(15)
    images = rng.standard_normal((32, IMAGE, IMAGE, 3)).astype(np.float32)
    points = lidar(rng, 32)
    maps = rng.standard_normal((32, 1, IMAGE, IMAGE, 3)).astype(np.float32)
    total = None
    for label, c in (("pretrained-default", bf), ("pretrained-fused",
                                                   fused)):
        mm, db = init_state(pretrained_cfg(c, wdir), dev).towers
        mm.eval()
        db.eval()
        cpu_mm, cpu_db = copy.deepcopy(mm).cpu(), copy.deepcopy(db).cpu()
        vox = prepare_query_vox(c, points, dev)
        with torch.inference_mode(), held_to_plain(label) as held:
            ops.reset_launches()  # ---- the path: one MM + one aerial fwd
            q = mm(torch.from_numpy(images).to(dev), vox)["embedding"]
            t = db(torch.from_numpy(maps).to(dev))
            torch.cuda.synchronize()
            counts = ops.launches()  # ---- read just after the path
        want = expected_launches(c, 32, 1)
        if counts != want:
            raise AssertionError(f"[{label}] launches {counts} != {want}")
        with torch.inference_mode():
            err_q = held_to_cpu(label, q[:4], cpu_mm(
                torch.from_numpy(images[:4]),
                prepare_query_vox(c, points[:4], "cpu"))["embedding"])
            err_t = held_to_cpu(label, t[:2],
                                cpu_db(torch.from_numpy(maps[:2])))
        log(f"[{label}] b32: launches {counts}; each launch against its "
            f"plain version, worst max_abs_err {held.worst}; card vs CPU "
            f"embeddings {err_q:.3g} (queries), {err_t:.3g} (tiles) of "
            f"scale")
        total = counts if total is None else {
            k: total[k] + v for k, v in counts.items()}
        del mm, db, cpu_mm, cpu_db

    # GeoLoc's backbone on both towers
    x = torch.from_numpy(images[:8]).to(dev)
    n_tokens = (IMAGE // 16) ** 2 + 1  # 257 at 256 px
    for bb, agg, arch in (("resnet50conv4", "netvlad", "resnet50"),
                          ("vit", "cls", "vit")):
        c = pretrained_cfg(geoloc_cfg(train_cfg(), backbone=bb,
                                      aggregation=agg), wdir)
        q, d = init_state(c, dev).towers
        q.eval()
        if arch == "vit":
            n = sum(check_vit_graft("pretrained", t.get_submodule(p),
                                    sds["vit"], n_tokens)
                    for t, p in ((q, "backbone"), (d, "net.backbone")))
        else:
            n = sum(check_resnet_graft("pretrained", t, p, sds[arch], 3)
                    for t, p in ((q, "backbone"), (d, "net.backbone")))
        with torch.inference_mode():
            ops.reset_launches()
            y = q(x)
            torch.cuda.synchronize()
            zero_launches(f"pretrained geoloc {bb}", ops.launches())
        if not bool(torch.isfinite(y).all()) or y.shape[0] != 8:
            raise AssertionError(f"[pretrained] geoloc {bb}: {y.shape}")
        log(f"[pretrained] geoloc {bb} + {agg}: {n} grafted leaves checked "
            f"on both towers (positional table "
            f"{tuple(q.backbone.pos.shape)}); b8 forward {tuple(y.shape)}"
            if arch == "vit" else
            f"[pretrained] geoloc {bb} + {agg}: {n} grafted leaves "
            f"checked on both towers; b8 forward {tuple(y.shape)}")
        del q, d
    return total


def seeded_module(module, dev, seed):
    """``module`` on ``dev`` with seeded flax-scale weights, LayerNorms
    away from the identity; drawn on the card for the large ones."""
    g = torch.Generator(device=dev).manual_seed(seed)
    module.to(dev)
    with torch.no_grad():
        for n, p in module.named_parameters():
            leaf = n.rsplit(".", 1)[-1]
            if p.ndim == 1 and leaf == "weight":
                p.uniform_(0.5, 1.5, generator=g)
            elif p.ndim == 1:
                p.normal_(0.0, 0.1, generator=g)
            elif leaf in ("cls", "pos"):
                p.normal_(0.0, 0.02, generator=g)
            else:  # OIHW conv, [out, in] dense, [in, heads, hd] heads
                p.normal_(0.0, p[0].numel() ** -0.5, generator=g)
    return module.eval()


def parted_at_near_ties(label, card_s, cpu_s, pick=torch.argmin):
    """The rows of [N, K] scores whose best column (``pick``) differs
    between the card and the CPU, as a CPU mask.  Raises unless each is a
    near tie: its two columns' CPU scores within twice the largest
    card-vs-CPU difference of a score, the most that rounding alone can
    turn."""
    card_s = card_s.float().cpu()
    a_card, a_cpu = pick(card_s, dim=-1), pick(cpu_s, dim=-1)
    parted = a_card != a_cpu
    rows = parted.nonzero().flatten()
    if rows.numel():
        gap = float((cpu_s[rows, a_card[rows]]
                     - cpu_s[rows, a_cpu[rows]]).abs().max())
        if gap > 2 * float((card_s - cpu_s).abs().max()):
            raise AssertionError(f"[{label}] {rows.numel()} rows part, by "
                                 f"up to {gap:.3g}: not a near tie")
    return parted


def kmeans_objective(points, centres, assign) -> float:
    """Mean squared distance of each point to its assigned centre."""
    return float(((points - centres[assign]) ** 2).sum(-1).mean())


def phase_anyloc(dev, name):
    """[anyloc]: JAX's default ``DinoV2ExtractFeatures`` (ViT-B/14, 768 /
    12 / 12) at 224 px, b32, facet value at layer 11: ms per forward, 4
    images against the CPU; ``VLAD(32, hard, cosine)`` fitted on the card
    on 64 images' patch descriptors (16,384 x 768; its k-means against the
    CPU's and a float64 CPU fit from the same rows), VLADs of 64 database
    and 32 query images (noisy copies of database images; query 0 an
    exact one) against the CPU's on the same centres and through
    ``get_top_k_recall``: the planted match at top-1; one b8 forward at
    ViT-g/14's widths (1536, 40 blocks, 24 heads, layer 31, facet value,
    GELU MLP as JAX builds it): ms and peak memory."""
    from agplace_tpu_torch.models.anyloc import (DinoV2ExtractFeatures,
                                                 VLAD, get_top_k_recall)
    from agplace_tpu_torch.models.anyloc import _norm as anyloc_norm
    from agplace_tpu_torch.retrieval.kmeans import kmeans
    from agplace_tpu_torch.retrieval.knn import pairwise_sq_l2

    ex = seeded_module(DinoV2ExtractFeatures(facet="value"), dev, 0)
    rng = np.random.default_rng(16)
    db_imgs = rng.standard_normal((VLAD_DB, ANYLOC_IMAGE, ANYLOC_IMAGE,
                                   3)).astype(np.float32)
    src = np.arange(VLAD_Q) * 2
    q_imgs = db_imgs[src] + np.float32(0.05) * rng.standard_normal(
        (VLAD_Q, ANYLOC_IMAGE, ANYLOC_IMAGE, 3)).astype(np.float32)
    q_imgs[0] = db_imgs[0]
    x = torch.from_numpy(db_imgs[:ANYLOC_BATCH]).to(dev)
    ms, peak = timed_forward(lambda: ex(x), iters=10)
    with torch.inference_mode():
        got = ex(x[:ANYLOC_CPU])
        err = held_to_cpu("anyloc dinov2", got, copy.deepcopy(ex).cpu()(
            torch.from_numpy(db_imgs[:ANYLOC_CPU])), ANYLOC_TOL)

        def descs(imgs):
            out = [ex(torch.from_numpy(imgs[i:i + ANYLOC_BATCH]).to(dev))
                   for i in range(0, len(imgs), ANYLOC_BATCH)]
            return torch.cat(out)  # [N, patches, 768]

        d_db, d_q = descs(db_imgs), descs(q_imgs)
    n_patch = (ANYLOC_IMAGE // 14) ** 2
    if d_db.shape != (VLAD_DB, n_patch, 768):
        raise AssertionError(f"[anyloc] descriptors {tuple(d_db.shape)}")
    train = d_db.reshape(-1, 768)
    init = torch.randperm(train.shape[0],
                          generator=torch.Generator().manual_seed(0))[:32]
    vlad = VLAD(32, dist_mode="cosine", vlad_mode="hard", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vlad.fit(train, init_idx=init)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    v_db, v_q = vlad.generate_multi(d_db), vlad.generate_multi(d_q)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    # k-means against the CPU from the same rows of the same (twice
    # normalised, as ``fit`` does) descriptors: the first Lloyd step's
    # distances (summation order only) within KMEANS_TOL, its assignments
    # parted only at near ties; the two full fits, whose assignments then
    # follow other paths, by their objective and the share of assignments
    # that differ.  The CPU's fit in float64 from the same rows is the
    # second witness: rounding alone parts the paths there too
    fit = anyloc_norm(anyloc_norm(train))
    fit_cpu = fit.cpu()
    d_card = pairwise_sq_l2(fit, fit[init.to(dev)])
    d_cpu = pairwise_sq_l2(fit_cpu, fit_cpu[init])
    err_d = held_to_cpu("anyloc k-means distances", d_card, d_cpu,
                        KMEANS_TOL)
    step1 = int(parted_at_near_ties("anyloc k-means step 1", d_card,
                                    d_cpu).sum())
    cc, a_cpu = kmeans(fit_cpu, 32, init_idx=init)
    cc64, a_64 = kmeans(fit_cpu.double(), 32, init_idx=init)
    a_card = torch.argmin(pairwise_sq_l2(fit, vlad.c_centers), dim=-1)
    obj_card = kmeans_objective(fit, vlad.c_centers, a_card)
    obj_cpu = kmeans_objective(fit_cpu, cc, a_cpu)
    obj_64 = kmeans_objective(fit_cpu.double(), cc64, a_64)
    parted = float((a_card.cpu() != a_cpu).float().mean())
    parted_64 = float((a_64 != a_cpu).float().mean())
    if max(abs(obj_card - obj_cpu) / obj_cpu,
           abs(obj_card - obj_64) / obj_64) > VLAD_OBJ_TOL:
        raise AssertionError(f"[anyloc] k-means objective {obj_card} on the "
                             f"card, {obj_cpu} on the CPU, {obj_64} in "
                             f"float64")
    # ``generate`` on the card against the CPU on the card's centres: its
    # hard labels (from the raw descriptors, per image, as ``generate``
    # takes them) part only at near ties, and the VLADs of the images
    # where none parts within VLAD_TOL
    descs_all = torch.cat([d_db, d_q])
    v_card = torch.cat([v_db, v_q])
    cpu_vlad = VLAD(32, dist_mode="cosine", vlad_mode="hard", device="cpu")
    cpu_vlad.c_centers = vlad.c_centers.cpu()
    v_cpu = cpu_vlad.generate_multi(descs_all.cpu())
    c_unit = anyloc_norm(vlad.c_centers)
    same = torch.tensor([not bool(parted_at_near_ties(
        "anyloc VLAD labels", anyloc_norm(d) @ c_unit.T,
        anyloc_norm(d.cpu()) @ c_unit.cpu().T, torch.argmax).any())
        for d in descs_all])
    if not bool(same.any()):
        raise AssertionError("[anyloc] every image has a parted label")
    err_v = held_to_cpu("anyloc VLAD", v_card[same.to(dev)], v_cpu[same],
                        VLAD_TOL)
    gt = [np.array([s]) for s in src]
    _, idx, recalls = get_top_k_recall([1, 5], v_db, v_q, gt)
    if v_db.shape != (VLAD_DB, 32 * 768) or idx[0, 0] != 0:
        raise AssertionError(f"[anyloc] VLAD {tuple(v_db.shape)}, query 0 "
                             f"-> {idx[0].tolist()}")
    del ex, x, d_db, d_q, descs_all
    torch.cuda.empty_cache()
    with torch.device(dev):  # 1.1 B parameters: made on the card
        big = DinoV2ExtractFeatures(facet="value", **VIT_G)
    big = seeded_module(big, dev, 1)
    xb = torch.from_numpy(db_imgs[:8]).to(dev)
    ms_g, peak_g = timed_forward(lambda: big(xb), iters=5)
    with torch.inference_mode():
        yb = big(xb)
    if yb.shape != (8, n_patch, VIT_G["hidden"]) or not bool(
            torch.isfinite(yb).all()):
        raise AssertionError(f"[anyloc] ViT-g/14 {tuple(yb.shape)}")
    n_params = sum(p.numel() for p in big.parameters())
    log(f"[anyloc] {name}: DINOv2 ViT-B/14 value@11 at {ANYLOC_IMAGE} px "
        f"b{ANYLOC_BATCH}: {ms:.3f} ms per forward (CUDA events, median "
        f"of 10), peak {peak:.2f} GiB, card vs CPU {err:.3g} of scale; "
        f"VLAD(32, hard, cosine) fit on {train.shape[0]} x 768 in "
        f"{t_fit:.3f} s (k-means vs CPU: distances {err_d:.3g} of scale, "
        f"{step1} first-step assignments parted at near ties; objective "
        f"{obj_card:.6g} card / {obj_cpu:.6g} CPU / {obj_64:.6g} CPU "
        f"float64, {parted:.4f} of the assignments differ card vs CPU, "
        f"{parted_64:.4f} CPU float64 vs float32), {VLAD_DB} + {VLAD_Q} "
        f"VLADs ({v_db.shape[1]}-d) in {t_gen:.3f} s, card vs CPU on the "
        f"same centres {err_v:.3g} of scale over {int(same.sum())} images "
        f"({int((~same).sum())} with a label parted at a near tie left "
        f"out); recalls {recalls}, "
        f"query 0 top-1 {idx[0, 0]}; ViT-g/14 widths ({n_params / 1e9:.2f} "
        f"B parameters) value@31 b8: {ms_g:.3f} ms per forward (median of "
        f"5), peak {peak_g:.2f} GiB")
    del big, xb, yb
    torch.cuda.empty_cache()


def phase_tail(base, dev, name, mm):
    """[tail]: the batch-hard metric losses at N = 1024, 256-d, with their
    gradients, card against CPU; ``get_flops`` of the b32 MM forward
    (the convs and matmuls PyTorch dispatches: the hand-written kernels'
    work is not counted, as XLA counts no custom call) beside the CPU's
    plain path at b4; a seeded folder tree through ``FolderDataset`` and
    ``evaluate`` with GeoLoc towers (ResNet-18 conv4 + GeM) on the card,
    2 queries against the CPU."""
    import shutil
    import tempfile

    from agplace_tpu_torch import ops
    from agplace_tpu_torch.data.folder_dataset import FolderDataset
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.evaluate import evaluate
    from agplace_tpu_torch.infer import make_infer_fns
    from agplace_tpu_torch.train.metric_losses import (
        batch_hard_triplet_loss, masks_from_eastnorth)
    from agplace_tpu_torch.utils.flops import get_flops

    rng = np.random.default_rng(17)
    emb = rng.standard_normal((METRIC_N, 256)).astype(np.float32)
    pos, neg = masks_from_eastnorth(rng.uniform(0, 400, (METRIC_N, 2)))
    res = {}
    for where in (dev, "cpu"):
        x = torch.from_numpy(emb).to(where).requires_grad_()
        loss, stats = batch_hard_triplet_loss(
            x, torch.from_numpy(pos).to(where),
            torch.from_numpy(neg).to(where))
        loss.backward()
        res[str(where)] = (loss.detach(), x.grad, stats)
    (l_card, g_card, stats), (l_cpu, g_cpu, _) = res[str(dev)], res["cpu"]
    err_l = held_to_cpu("tail metric loss", l_card[None], l_cpu[None],
                        METRIC_TOL)
    err_g = held_to_cpu("tail metric grad", g_card, g_cpu, METRIC_GRAD_TOL)
    n_trip = int(stats["num_triplets"])

    images = rng.standard_normal((32, IMAGE, IMAGE, 3)).astype(np.float32)
    points = lidar(rng, 32)
    vox = prepare_query_vox(base, points, dev)
    xg = torch.from_numpy(images).to(dev)
    flops = get_flops(mm, xg, vox)
    cpu_mm = copy.deepcopy(mm).cpu()
    flops_cpu = get_flops(cpu_mm, torch.from_numpy(images[:4]),
                          prepare_query_vox(base, points[:4], "cpu"))
    del cpu_mm

    root = tempfile.mkdtemp(prefix="agp_folder_")
    write_trees().folder_tree(root, n_db=FOLDER_DB, n_q=FOLDER_Q,
                              size=320, split="test")
    cfg = geoloc_cfg(base, backbone="resnet18conv4", aggregation="gem")
    ds = FolderDataset(cfg, root, "test")
    (q, d), (cpu_q, _) = family_towers(cfg, dev)
    ops.reset_launches()  # ---- the path: evaluate on the folder tree
    t0 = time.perf_counter()
    recalls, text = evaluate(cfg, ds, *make_infer_fns(q, d), device=dev)
    t_eval = time.perf_counter() - t0
    counts = ops.launches()  # ---- read just after the path
    zero_launches("tail folder evaluate", counts)
    check_recalls("tail folder", recalls, text)
    imgs = torch.from_numpy(np.stack([ds.load_query_image(i)
                                      for i in range(2)]))
    with torch.inference_mode():
        err_f = held_to_cpu("tail folder queries", q(imgs.to(dev)),
                            cpu_q(imgs))
    shutil.rmtree(root, ignore_errors=True)
    log(f"[tail] {name}: batch-hard loss at N = {METRIC_N}, 256-d "
        f"({n_trip} anchors with a positive and a negative): card vs CPU "
        f"loss {err_l:.3g}, gradient {err_g:.3g} of scale; get_flops of "
        f"the b32 MM forward {flops:.4g} on the card (dispatched convs and "
        f"matmuls; K1-K3 not counted), {flops_cpu:.4g} for b4 on the CPU "
        f"(plain path, all counted); folder tree {ds.database_num} tiles / "
        f"{ds.queries_num} queries: evaluate {t_eval:.2f} s, {text}, "
        f"launches 0, 2 queries vs CPU {err_f:.3g}")
    del q, d, cpu_q
    return counts


def phase_flags(dev):
    """[flags]: ``python -m agplace_tpu_torch.train`` runs 1 step on the
    card with dopri5 and its tolerances, ``--horizontal_flip`` and
    ``--patience``, flags the port refused before; each lands in its
    field."""
    from agplace_tpu_torch import config

    save_dir = runs_dir("chip_smoke_flags")
    flags = ["--odeint_method", "dopri5", "--odeint_rtol", "1e-3",
             "--odeint_atol", "1e-3", "--dopri5_max_steps", "16",
             "--horizontal_flip", "true", "--patience", "3"]
    args = ["--dataset", "synthetic", "--train_batch_size", "4",
            "--negs_num_per_query", "2", "--queries_per_epoch", "4",
            "--cache_refresh_rate", "4", "--neg_samples_num", "16",
            "--epochs_num", "1", "--pretrained", "false", "--save_dir",
            save_dir, *flags]
    cfg, _ = config.parse_arguments(args)
    o = cfg.model.mm.ode
    if (o.method, o.rtol, o.atol, o.dopri5_max_steps, cfg.train.patience,
            cfg.data.horizontal_flip) != ("dopri5", 1e-3, 1e-3, 16, 3,
                                          True):
        raise AssertionError(f"[flags] parsed {o}")
    t0 = time.perf_counter()
    cli("agplace_tpu_torch.train", *args)
    t_run = time.perf_counter() - t0
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        epoch = json.loads(f.readline())
    if epoch["steps"] != 1 or not np.isfinite(epoch["losses"]).all():
        raise AssertionError(f"[flags] train: {epoch}")
    import shutil

    shutil.rmtree(save_dir, ignore_errors=True)
    log(f"[flags] train {' '.join(flags)}: 1 step on the card, loss "
        f"{epoch['losses']}, {t_run:.1f} s")


# ---- the multi-GPU layer -----------------------------------------------

# ---- [widths]: K1-K4 at widths off the presets --------------------------

# Five configurations of kitti360_config() (bf16, 256 px, 128 x 128 x z)
# that together reach every instance the presets do not: W1, the default
# route at z = 5 with a 1024-wide fusion (K2 at 320 -> 192 on the z-banded
# instance, K3 at z = 3, K1 at D = 1024 on its grid instance); W2, the
# fused route
# at z = 6 with planes (24, 128) and a 128-wide fusion (K4 at Z*C0 = 6 on
# its window+zband instance, K3 at C = 24 and 24 -> 128, K1 at D = 128);
# W3, z = 32 (K2 at Z*C1 = 2048 -> 1024); W4, the default route at z = 72
# with planes (60, 128, 256) (K2 at Z*C1 = 4320 -> 2160, C1 = 60: every
# slab padded; K3's block0 at z = 36, C = 60); W5, the fused route at z =
# 40 with planes (108, 128, 256) (K4's conv0 over 40 occupancy channels to
# Z*C1 = 4320, C1 = 108, its down0 to Zo = 20; K3's block0 at z = 20, C =
# 108).  JAX's MM adds the last image and voxel vectors to the fusion
# width with no projection (fusion.py:136-146), so the image branch
# (resnet50 at W1, two ResNet-18 stages at W2) and the last voxel plane
# end at stg2fuse_dim (256 at W3-W5, KITTI-360's).
WIDTHS_CONFIGS = (
    ("W1", 32, dict(vox_grid_extent=(128, 128, 5), imgfe="resnet50",
                    imgfe_planes=(256, 512, 1024), imgfe_dim=1024,
                    voxfe_planes=(64, 128, 1024), voxfe_dim=1024,
                    stg2fuse_dim=1024)),
    ("W2", 32, dict(bev_pallas_head=True, stem_pallas=True,
                    vox_grid_extent=(128, 128, 6), voxfe_planes=(24, 128),
                    voxfe_layers=(1, 1), voxfe_dim=128, imgfe_layers=(2, 2),
                    imgfe_planes=(64, 128), imgfe_dim=128,
                    stg2fuse_dim=128)),
    ("W3", 8, dict(vox_grid_extent=(128, 128, 32))),
    ("W4", 4, dict(vox_grid_extent=(128, 128, 72),
                   voxfe_planes=(60, 128, 256))),
    ("W5", 4, dict(bev_pallas_head=True, stem_pallas=True,
                   vox_grid_extent=(128, 128, 40),
                   voxfe_planes=(108, 128, 256))),
)
WIDTHS_CPU_Q = 1  # queries each configuration's card run is held to on CPU
# [widths]' lone launches: K3 at Z*C > 4096 (z = 20, C = 212: its CPU run
# would cost ~1.3 TFLOP a conv a query), b8 on 64 x 64, identity residual;
# K1's grid instance at D = 1024, 1536 and 2048 and its wide one at 3072,
# b32
LONE_K3 = dict(z=20, c=212, b=8, xy=64)
LONE_K1 = (1024, 1536, 2048, 3072)


class rules_replay:
    """While active, each call of K1-K4's wrappers is first named by its
    rule (``ode_instance``, ``down0_instance``, ``block_instance``,
    ``head_instance``) from its arguments' shapes alone, then runs as it
    would (on the CPU: the plain version, which counts nothing).  The
    names are counted in ``counts``, by kernel and instance, as
    ``ops.instance_launches`` counts the card's launches."""

    def __init__(self):
        self.counts, self.saved = {}, []

    def __enter__(self):
        from agplace_tpu_torch.ops import (bev_block_sm, bev_down, bev_head,
                                           ode_step)

        rules = {
            (ode_step, "fused_euler_ode"):
                lambda a, k: ode_step.ode_instance(*a[0].shape),
            (bev_down, "fused_conv0_down0"):
                lambda a, k: bev_down.down0_instance(
                    int(a[2].shape[3]), int(a[5].shape[3]), k["z"]),
            (bev_block_sm, "fused_eca_block_sm"):
                lambda a, k: bev_block_sm.block_instance(
                    int(a[0].shape[3]), int(a[3].shape[3]), k["z"]),
            (bev_head, "fused_head"):
                lambda a, k: bev_head.head_instance(
                    int(a[0].shape[3]), int(a[2].shape[0]),
                    int(a[2].shape[3]), int(a[5].shape[3]), k["z"]),
        }
        for (mod, name), rule in rules.items():
            real = getattr(mod, name)

            def wrapper(*a, _real=real, _rule=rule, _name=name, **k):
                inst = _rule(a, k)
                by = self.counts.setdefault(_name, {})
                by[inst] = by.get(inst, 0) + 1
                return _real(*a, **k)

            wrapper.launches = real.launches
            wrapper.instances = real.instances
            wrapper.__name__ = name
            setattr(mod, name, wrapper)
            self.saved.append((mod, name, real))
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)
        return False


def widths_new(name, inst, a) -> bool:
    """Whether an instance at these arguments is one no preset runs: K1
    at a D other than 256 (each D its own compiled width, or the wide
    instance's), the z-banded instances of K2-K4 (K3's pair with one
    z-banded phase too)."""
    if name == "fused_euler_ode":
        return int(a[0].shape[1]) != 256
    return "zband" in inst


def instance_alone(label, kern, pad=None, yardstick=None) -> dict:
    """A z-banded launch alone on its padded operands: its time (CUDA
    events around one synchronised call, median of 20), its device time
    (the profiler), the pad's time (the copy that pads every z-slab to 8k
    channels; where no slab needs it, its unpadded tensors pass through),
    and ``yardstick``'s (one cuDNN call of the same folded conv)."""
    rec = dict(kernel_ms=cuda_ms(kern), kernel_device_ms=device_ms(kern))
    if pad is not None:
        rec["pad_ms"] = cuda_ms(pad)
    if yardstick is not None:
        rec["cudnn_ms"] = cuda_ms(yardstick)
    log(f"  {label} alone: {rec['kernel_ms']:.4f} ms ({rec['kernel_device_ms']:.4f}"
        f" ms of device time)" + (f", the pad {rec['pad_ms']:.4f} ms"
                                  if pad is not None else "")
        + (f", cuDNN's conv {rec['cudnn_ms']:.4f} ms"
           if yardstick is not None else ""))
    return rec


def k2_zband_alone(a, z):
    """K2's z-banded down0 alone: the pad (``bev_down.pad_down0``) and the
    kernel on the padded operands (conv0's output precomputed)."""
    import torch.nn.functional as F
    from agplace_tpu_torch.data.voxels import me_down_align
    from agplace_tpu_torch.ops import bev_down, zband
    from agplace_tpu_torch.sparse import bev_grid as bg

    feats, mask, w0, s0, b0, wd, sd, bd = stage0_inputs(a, a[1])
    k0 = int(w0.shape[0])
    g0 = bg.bev_conv2d(feats, w0, 1, (k0 // 2,) * 2,
                       (k0 // 2,) * 2).contiguous()
    lo_z, hi_z, _ = me_down_align(z)
    m_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z)).contiguous()
    wb = wd.to(torch.bfloat16)

    def pad():
        return bev_down.pad_down0(g0, s0, b0, wb, sd, bd, z=z)

    g, s0p, b0p, wdp, sdp, bdp = pad()
    h = bg.mask_bev(torch.relu(g0 * s0.to(g0.dtype) + b0.to(g0.dtype)),
                    mask, z).permute(0, 3, 1, 2)
    wc = wb.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return instance_alone(
        f"K2 zband [{g0.shape[0]},{g0.shape[1]},{g0.shape[2]},{z}]",
        lambda: zband.zband_conv(zband.INST_K2, g, wdp, sdp, bdp, m_out, z,
                                 mask_in=mask, s_in=s0p, b_in=b0p), pad,
        lambda: F.conv2d(h, wc, stride=2))


def k4_window_alone(a, z):
    """K4's window+zband instance alone, each half on its padded operands:
    the pad (``bev_head.pad_head``); conv0 on the window GEMM
    (``head_conv0``) by events and by device, held to its plain form,
    beside its bound (the fold's live blocks, feats and h once) and
    cuDNN's conv0 on the dense fold (``F.conv2d`` of feats with w0, bf16,
    channels_last: the conv alone, no epilogue); the z-banded down0 on
    conv0's output beside cuDNN's down0 on the same map."""
    import torch.nn.functional as F
    from agplace_tpu_torch.data.voxels import me_down_align
    from agplace_tpu_torch.ops import bev_head, zband
    from agplace_tpu_torch.sparse import bev_grid as bg

    feats, mask, w0, s0, b0, wd, sd, bd = stage0_inputs(a, a[1])
    lo_z, hi_z, _ = me_down_align(z)
    m_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z)).contiguous()
    k0 = int(w0.shape[0])

    def pad():
        return bev_head.pad_head(w0, s0, b0, wd, sd, bd, z=z)

    w0p, s0p, b0p, wdp, sdp, bdp = pad()
    h = bev_head.head_conv0(feats, mask, w0p, s0p, b0p, z=z)
    shape = f"[{h.shape[0]},{h.shape[1]},{h.shape[2]},{z}]"
    want = bg.bev_conv2d(feats.float(), w0p.float(), 1, (k0 // 2,) * 2,
                         (k0 // 2,) * 2, torch.float32)
    want = bg.mask_bev(torch.relu(want * s0p + b0p), mask, z).to(
        torch.bfloat16)
    cmp = compare(f"K4 window conv0 {shape}", h, want, KSTAGE0_TOL)
    hc = h.permute(0, 3, 1, 2)
    wc = wdp.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    rec = instance_alone(
        f"K4 zband down0 {shape}",
        lambda: zband.zband_conv(zband.INST_K4_DOWN, h, wdp, sdp, bdp, m_out,
                                 z), pad, lambda: F.conv2d(hc, wc, stride=2))

    def conv0():
        return bev_head.head_conv0(feats, mask, w0p, s0p, b0p, z=z)

    fc = feats.permute(0, 3, 1, 2)
    w0c = w0.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)

    def cudnn():
        return F.conv2d(fc, w0c, padding=k0 // 2)

    cells = feats.shape[0] * feats.shape[1] * feats.shape[2]
    bnd = bound(conv_flops(cells, w0, z, z),
                nbytes(feats, mask, s0, b0) + fold_bytes(w0, z, z)
                + cells * int(w0.shape[3]) * 2)
    c0 = dict(ms=cuda_ms(conv0), device_ms=device_ms(conv0),
              cudnn_ms=cuda_ms(cudnn), cudnn_device_ms=device_ms(cudnn),
              max_abs_err=cmp["max_abs_err"],
              frac_differ=cmp["frac_differ"], **bnd)
    c0["share_of_bound"] = bnd["bound_ms"] / c0["device_ms"]
    log(f"  K4 window conv0 alone {shape}: {c0['ms']:.4f} ms "
        f"({c0['device_ms']:.4f} ms of device time), bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), share "
        f"{c0['share_of_bound']:.3f}; cuDNN's conv0 on the dense fold "
        f"{c0['cudnn_ms']:.4f} ms ({c0['cudnn_device_ms']:.4f} ms device)")
    rec["conv0"] = c0
    return rec


def widths_alone(name, inst, a, k):
    """One instance alone on the arguments of its first launch in the
    forward: the wrapper and its plain version timed with CUDA events
    (median of 20; K1 also by the profiler's device time, its launch being
    shorter than the host's enqueue), the bound of its work (the folds'
    live blocks), where one cuDNN call computes a product of it, that
    call's time, and the z-banded kernel alone beside the pad."""
    from agplace_tpu_torch.data.voxels import me_down_align
    from agplace_tpu_torch.ops import bev_block_sm, bev_down, bev_head, \
        ode_step

    label = f"{name} {inst}"
    if name == "fused_euler_ode":
        x, w, b = a[:3]
        ms = cuda_ms(lambda: ode_step.fused_euler_ode(*a, **k))
        dms = device_ms(lambda: ode_step.fused_euler_ode(*a, **k))
        pms = cuda_ms(lambda: ode_step.euler_ode_plain(*a, **k))
        bnd = bound(a[3] * 2.0 * x.shape[0] * w.numel(),
                    nbytes(x, w, b, x), PEAK_FP32)
        rec = dict(shape=list(x.shape), ms=ms, device_ms=dms, plain_ms=pms,
                   library_ms=None, **bnd)
        log(f"  {label} [{x.shape[0]},{x.shape[1]}]: {ms:.4f} ms "
            f"({dms:.4f} ms of device time), plain {pms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        return rec
    z = k["z"]
    if name == "fused_eca_block_sm":
        x, w1, w2 = a[0], a[2], a[3]
        wd, sd, bd = (k.get(n) for n in ("wd", "scale_d", "bias_d"))
        ms = cuda_ms(lambda: bev_block_sm.fused_eca_block_sm(*a, **k))
        pms = cuda_ms(lambda: bev_block_sm.eca_block_plain(*a, **k))
        phases = conv_phases(f"{label} z={z}", a, z)
        pad_ms = cuda_ms(lambda: bev_block_sm.pad_block(
            x.to(torch.bfloat16), w1, w2, *a[4:8], z, wd, sd, bd))
        bnd = block_bound(*a, **k)
        rec = dict(shape=[*x.shape, int(w2.shape[3])], ms=ms,
                   plain_ms=pms, pad_ms=pad_ms,
                   library_ms=sum(ph["cudnn_ms"] for ph in phases.values()),
                   library_ms_is="cuDNN's two 3x3 convs alone",
                   conv_phases=phases, **bnd)
        log(f"  {label} {rec['shape']} z={z}: {ms:.4f} ms (the block's pad "
            f"{pad_ms:.4f} ms), plain {pms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), share "
            f"{bnd['bound_ms'] / ms:.3f}")
        return rec
    mask = a[1]
    if name == "fused_conv0_down0":
        ms = cuda_ms(lambda: bev_down.fused_conv0_down0(*a, **k))
        pms = cuda_ms(lambda: bev_down.conv0_down0_plain(*a, **k))
        gemm = down0_alone(a, mask, z)
        gemm.update(k2_zband_alone(a, z))
        rec = dict(shape=[*a[0].shape, int(a[5].shape[3])], ms=ms,
                   plain_ms=pms, gemm=gemm, library_ms=gemm["cudnn_ms"],
                   library_ms_is="cuDNN's down0 conv alone (the GEMM's "
                                 "product)",
                   bound_ms=gemm["bound_ms"], bound_by=gemm["bound_by"])
        log(f"  {label} {rec['shape']} z={z}: {ms:.4f} ms with conv0, "
            f"plain {pms:.4f} ms")
        return rec
    head = head_alone(a, mask, z)
    halves = k4_window_alone(a, z)
    head.update(shape=[*a[0].shape, int(a[5].shape[3])],
                library_ms=halves["conv0"]["cudnn_ms"]
                + halves["cudnn_ms"],
                library_ms_is="cuDNN's conv0 on the dense fold and its "
                              "down0, each alone, no epilogues (a yardstick "
                              "for both convs)",
                zo=me_down_align(z)[2], conv0=halves.pop("conv0"),
                down0=halves)
    return head


def phase_widths_lone(dev):
    """[widths] lone launches, each against its plain version on the card:
    K3 at z = 20, C = 212 (Z*C = 4240 past 4096; its CPU run would cost
    ~1.3 TFLOP a conv a query): one conv phase of each kind and one whole
    block, timed as [widths]' instances are; K1 at D = 1024, 1536 and
    2048 (its grid instance) and 3072 (its wide one), b32.  Returns the
    records and the launches of each instance (each lone launch counted
    from 0, the timing calls not)."""
    from agplace_tpu_torch import ops
    from agplace_tpu_torch.ops import bev_block_sm, ode_step
    from agplace_tpu_torch.sparse.bev_grid import fold_w2_stride1

    g = torch.Generator(device=dev).manual_seed(7)
    z, c, bsz, xy = (LONE_K3[n] for n in ("z", "c", "b", "xy"))
    mask = torch.rand(bsz, xy, xy, z, generator=g, device=dev) < 0.3
    x = torch.randn(bsz, xy, xy, z, c, generator=g, device=dev)
    x = torch.where(mask[..., None], x, 0).reshape(bsz, xy, xy, z * c).to(
        torch.bfloat16)

    def fold():
        kern = torch.randn(3, 3, 3, c, c, generator=g, device=dev)
        return fold_w2_stride1(kern * (2 / (27 * c)) ** .5, z).to(
            torch.bfloat16)

    def affine():
        s = torch.rand(c, generator=g, device=dev) + 0.5
        b = torch.randn(c, generator=g, device=dev) * 0.1
        return s.repeat(z), b.repeat(z)

    args = (x, mask, fold(), fold(), *affine(), *affine(),
            torch.randn(5, generator=g, device=dev))
    label = f"[widths lone] K3 [{bsz},{xy},{xy},{z * c}] z={z} C={c}"
    counts = {}

    def count(by_kernel):
        for k, by in by_kernel.items():
            for i, n in by.items():
                if n:
                    counts.setdefault(k, {}).setdefault(i, 0)
                    counts[k][i] += n

    with torch.inference_mode():
        ops.reset_launches()  # ---- the lone launch, counted
        got = bev_block_sm.fused_eca_block_sm(*args, z=z)
        torch.cuda.synchronize()
        count(ops.instance_launches())
        cmp = compare(f"{label} block", got,
                      bev_block_sm.eca_block_plain(*args, z=z), KBF16_TOL)
        k3 = widths_alone("fused_eca_block_sm", bev_block_sm.block_instance(
            z * c, z * c, z), args, dict(z=z))
        k3.update(instance=bev_block_sm.block_instance(z * c, z * c, z),
                  max_abs_err=cmp["max_abs_err"],
                  frac_differ=cmp["frac_differ"])
        k1 = {}
        for d in LONE_K1:
            xd = torch.randn(32, d, generator=g, device=dev)
            wd = torch.randn(d, d, generator=g, device=dev) / d ** .5
            bd = torch.randn(d, generator=g, device=dev) * 0.1
            a = (xd, wd, bd, 10, 0.1, "relu")
            ops.reset_launches()  # ---- the lone launch, counted
            got = ode_step.fused_euler_ode(*a)
            torch.cuda.synchronize()
            count(ops.instance_launches())
            cmp = compare(f"[widths lone] K1 [32,{d}]", got,
                          ode_step.euler_ode_plain(*a), K1_TOL)
            inst = ode_step.ode_instance(32, d)
            k1[f"D{d}"] = widths_alone("fused_euler_ode", inst, a, {})
            k1[f"D{d}"].update(instance=inst, max_abs_err=cmp["max_abs_err"])
    return {"fused_eca_block_sm": k3, "fused_euler_ode": k1}, counts


def phase_widths(base, dev):
    """[widths]: one MM forward of each of WIDTHS_CONFIGS on the card at
    full width inside ``held_to_plain`` (every K1-K4 launch compared with
    its plain version at its own shapes), exact launch counts, the launches
    of each instance, the output against the CPU run of the same module,
    and each instance the presets do not reach timed alone on its first
    launch's arguments; then the lone launches (``phase_widths_lone``)."""
    from agplace_tpu_torch import ops
    from agplace_tpu_torch.data.voxels import prepare_query_vox

    log(f"[widths] K1-K4 off the preset widths: {len(WIDTHS_CONFIGS)} MM "
        f"forwards")
    out_counts, records = [], {}
    for label, bsz, flags in WIDTHS_CONFIGS:
        t0 = time.perf_counter()
        cfg = option_cfg(base, **flags)
        mm, cpu_mm = build_mm(cfg, dev)
        images, points, _ = mm_inputs(40, bsz, cfg)
        vox = prepare_query_vox(cfg, points, dev)
        keep = {}
        with held_to_plain(f"widths {label}", keep) as held:
            out, counts = counted_forward(f"widths {label}", cfg, mm,
                                          torch.from_numpy(images).to(dev),
                                          vox)
            instances = ops.instance_launches()
        # every launch of K1-K5 compared, none missed
        held_names = [n for _, n, _, _ in plain_checks()]
        checked = {n: held.checked.get(n, 0) for n in held_names}
        if checked != {n: counts[n] for n in held_names}:
            raise AssertionError(f"[widths {label}] launches held to their "
                                 f"plain versions {checked} != {counts}")
        t_cpu = time.perf_counter()
        with rules_replay() as named:  # the CPU's query, instances named
            err = against_cpu(f"widths {label}", cfg, out, cpu_mm, images,
                              points, q=WIDTHS_CPU_Q)
        cpu_s = time.perf_counter() - t_cpu
        card = {k: {i: n for i, n in by.items() if n}
                for k, by in instances.items() if any(by.values())}
        if named.counts != card:
            raise AssertionError(f"[widths {label}] instances launched "
                                 f"{card} != the rules' replay on the CPU "
                                 f"{named.counts}")
        fwd_s = time.perf_counter() - t0
        log(f"  [widths {label}] b{bsz} {flags}: launches {counts}; by "
            f"instance {instances}; all held to plain (worst "
            f"{held.worst}); the rules' CPU replay names the same; card vs "
            f"CPU {err:.3g} of scale; {fwd_s:.1f} s ({cpu_s:.1f} s of them "
            f"the CPU's query)")
        alone = {}
        with torch.inference_mode():
            for (kname, inst), (a, k) in sorted(keep.items()):
                if widths_new(kname, inst, a):
                    alone[f"{kname}/{inst}"] = widths_alone(kname, inst, a,
                                                            k)
        records[label] = dict(batch=bsz, flags={f: list(v) if isinstance(
            v, tuple) else v for f, v in flags.items()},
            launches=counts, instances=instances, held=checked,
            worst=held.worst, cpu_err=err, cpu_s=cpu_s, alone=alone)
        out_counts.append((counts, instances))
        del mm, cpu_mm, out, keep, vox
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lone, lone_counts = phase_widths_lone(dev)
    log(f"  [widths lone] launches by instance {lone_counts}; "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return out_counts, records, lone, lone_counts


# The source of each instance K1-K4 run off their preset ones
INSTANCE_SOURCES = {
    ("fused_euler_ode", "grid"): "agplace_tpu_torch/csrc/ode_grid.cu",
    ("fused_euler_ode", "wide"): "agplace_tpu_torch/csrc/ode_wide.cu",
    ("fused_conv0_down0", "zband"): "agplace_tpu_torch/csrc/zband_sm90.cu",
    ("fused_eca_block_sm", "zband"): "agplace_tpu_torch/csrc/zband_sm90.cu",
    ("fused_eca_block_sm", "zband+sm90"):
        "agplace_tpu_torch/csrc/zband_sm90.cu",
    ("fused_head", "window+zband"):
        "agplace_tpu_torch/csrc/head_conv0_sm90.cu",
}


def instance_rows(parity, widths, instances_w, lone_counts, sources):
    """The kernels line's row of each instance of INSTANCE_SOURCES that
    [widths] launched (its MM forwards, then its lone launches): launches
    by path, the times, bound and library call of the first record of it
    alone, its worst error against its plain version where it ran."""
    rows = []
    for (k, inst), src in INSTANCE_SOURCES.items():
        n_w = (instances_w.get(k) or {}).get(inst, 0)
        n_l = lone_counts.get(k, {}).get(inst, 0)
        if not n_w + n_l:
            continue
        alone, err = None, 0.0
        for label, rec in widths.items():
            if (rec["instances"].get(k) or {}).get(inst):
                alone = alone or rec["alone"].get(f"{k}/{inst}")
                err = max(err, rec["worst"].get(k) or 0.0)
        lone = parity[k].get("widths", {}).get("lone", {})
        lone = lone.values() if k == "fused_euler_ode" else [lone]
        for rec in lone:
            if rec.get("instance") == inst:
                alone = alone or rec
                err = max(err, rec["max_abs_err"])
        if alone is None:
            raise AssertionError(f"[widths] {k}/{inst} ran but was never "
                                 f"timed alone")
        rows.append(dict(
            name=f"{k}/{inst}", route="cuda", source=src,
            replaces=sources[k][1], launches=n_w + n_l,
            launches_by_path={"widths": n_w, "widths_lone": n_l},
            max_abs_err=err, ms=alone["ms"], plain_ms=alone["plain_ms"],
            bound_ms=alone["bound_ms"], bound_by=alone["bound_by"],
            library_ms=alone.get("library_ms"),
            **{x: alone[x] for x in ("device_ms", "library_ms_is",
                                     "conv0", "shape") if x in alone}))
    return rows


MG_WORLD = 2  # gloo ranks sharing cuda:0
MG_ROWS = SERVE_ROWS - 1  # one sentinel row pads the gallery to 2 blocks
MG_NCCL_ROWS = 1 << 16
MG_TRAIN_Q = 16  # one step of 16 x (1 + 1 + 10)
MG_STATS_TOL = 1e-4  # JAX's tests/test_parallel.py:73-84 tolerances
MG_LOSS_RTOL, MG_LOSS_ATOL = 1e-4, 1e-5
MG_PARAM_ATOL = 5e-4
# the applied gradient of the data-parallel step against one device's,
# over its largest element (measured 1.32e-3 on an H100: cuDNN's fp32
# convs, TF32 off, at half the batch; the worst leaf, a conv's before a
# train-mode BN whose terms cancel, 0.0238 of its own scale)
MG_GRAD_TOL = 5e-3
# the data-parallel descriptors against one device's, of scale: the same
# kernels on the same card, bf16 convs at b16 against b32 (measured
# 3.81e-4 / 4.98e-4 on an H100)
MG_EMBED_TOL = 5e-3
MG_D_TOL = 1e-4


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mg_train_inputs(dev):
    """(cfg, the host batch, the fp32-twin state on ``dev``): the preset
    in fp32 with its BEV convs in fp32 too, 16 random-mined triplets of a
    seeded world, the towers from the preset's seed; the same in every
    process."""
    from agplace_tpu_torch.data.base import collate_train
    from agplace_tpu_torch.train.mining import TripletMiner
    from agplace_tpu_torch.train.step import init_state

    cfg = train_cfg()
    world = train_world(cfg, 64, 64, 0)
    rows = TripletMiner(cfg, world, "cpu").mine_random(
        np.random.default_rng(0), MG_TRAIN_Q)
    batch = collate_train(world, rows, cfg, np.random.default_rng(1))
    state = init_state(cfg, dev)
    for tower in state.towers:
        for mod in tower.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = torch.float32
    return cfg, batch, state


def mg_search_inputs(dev):
    """(gallery [MG_ROWS, 256], 32 near queries, a 10-row gallery and 3
    queries) as host float32, made on ``dev`` from seeds."""
    gal = unit_rows(MG_ROWS, 11, dev)
    small = unit_rows(13, 15, dev)
    return gal, near_queries(gal, N_SERVE_Q, 12), small[:10], small[10:]


def mg_timed(fn, n=10):
    """(the last result, median ms of ``n`` synchronised calls)."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(ms)


def mg_rank_nccl(out, dev):
    """One rank over NCCL: the sharded search of an explicit 1 x 1 mesh
    (its all-gathers run on NCCL at world size 1) against ``l2_topk``,
    and one all-reduce."""
    import torch.distributed as dist

    from agplace_tpu_torch.config import MeshConfig
    from agplace_tpu_torch.parallel.mesh import all_reduce_sum, make_mesh
    from agplace_tpu_torch.retrieval import knn
    from agplace_tpu_torch.retrieval.sharded import (shard_gallery,
                                                     sharded_l2_topk)

    g = make_mesh(MeshConfig(data_parallel=1, gallery_parallel=1))
    gal = unit_rows(MG_NCCL_ROWS, 13, dev)
    q = torch.from_numpy(near_queries(gal, N_SERVE_Q, 14)).to(dev)
    d, i = sharded_l2_topk(g, q, shard_gallery(g, gal, device=dev), 5)
    d0, i0 = knn.l2_topk(q, torch.from_numpy(gal).to(dev), 5)
    total = all_reduce_sum(torch.full((4,), 2.0, device=dev), g.axis(None))
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "mesh": g.shape, "equal": bool(torch.equal(i, i0)),
            "d_err": float((d - d0).abs().max()), "total": total.tolist()}


def mg_rank_gloo(out, dev):
    """One of the gloo ranks: the data-parallel step, the data-parallel
    embeds and ``evaluate``, the sharded searches; launch counts reset
    just before each path and read just after.  The step is taken three
    times from the same state: a warm-up, the timed one, and the path's
    run, in which every kernel launch is held to its plain version at
    this rank's shapes (``held_to_plain``), as it is in the embeds and
    ``evaluate``."""
    import contextlib
    import dataclasses

    from agplace_tpu_torch import kitti360_config, ops
    from agplace_tpu_torch.config import MeshConfig
    from agplace_tpu_torch.data.pipeline import prefetch_to_device
    from agplace_tpu_torch.embed import batched_embed_db, batched_embed_q
    from agplace_tpu_torch.evaluate import evaluate
    from agplace_tpu_torch.infer import build_towers, make_infer_fns
    from agplace_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                                 resolve_data_mesh,
                                                 resolve_gallery_mesh)
    from agplace_tpu_torch.retrieval.sharded import (
        shard_gallery, sharded_l2_candidates_int8, sharded_l2_topk)
    from agplace_tpu_torch.serving import PlaceIndex
    from agplace_tpu_torch.train.step import TOWER_INPUTS, make_train_step

    res = {"held": {}, "checked": {}}
    # ---- the data-parallel step (a warm-up, the timed step, the path)
    for run in ("warm", "timed", "step"):
        cfg_t, batch, state = mg_train_inputs(dev)
        mesh = resolve_data_mesh(cfg_t.mesh, (
            cfg_t.train.train_batch_size, cfg_t.train.infer_batch_size))
        step = make_train_step(cfg_t, mesh)
        part = next(prefetch_to_device([batch], dev, sharding=(
            batch_sharding(mesh, keys=TOWER_INPUTS))))
        torch.cuda.synchronize()
        with (held_to_plain(f"multi-gpu {run}") if run == "step"
              else contextlib.nullcontext()) as held:
            ops.reset_launches()  # ---- the path: one data-parallel step
            t0 = time.perf_counter()
            m = step(state, part)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launches()  # ---- read just after
        if run == "timed":
            res["step_ms"] = ms
    res["counts_step"] = counts
    res["held"]["step"], res["checked"]["step"] = held.worst, held.checked
    res.update(dp=mesh.shape["data"], rows=int(part["query_image"].shape[0]),
               loss=float(m["loss"]),
               state={k: v.cpu() for k, v in state.state_dict()["mm"].items()},
               state_db={k: v.cpu() for k, v in
                         state.state_dict()["db"].items()},
               mu=state.opt.mu.cpu())
    del state, step, part, batch
    torch.cuda.empty_cache()

    # ---- the data-parallel embeds and evaluate (the smoke's towers)
    cfg = kitti360_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bfloat16"))
    mm, db = build_towers(cfg, dev)
    sd = torch.load(os.path.join(out, "towers.pt"), weights_only=False)
    mm.load_state_dict(sd["mm"])
    db.load_state_dict(sd["db"])
    eq, edb = make_infer_fns(mm, db)
    ds = eval_dataset(cfg, N_TILES, N_EVAL_Q)
    bs = cfg.train.infer_batch_size
    dmesh = resolve_data_mesh(cfg.mesh, (cfg.train.train_batch_size, bs))
    gmesh = resolve_gallery_mesh(MeshConfig(gallery_parallel=-1))
    torch.cuda.synchronize()
    with held_to_plain("multi-gpu embeds") as held:
        ops.reset_launches()  # ---- the path: embeds and evaluate
        t0 = time.perf_counter()
        res["db"] = batched_embed_db(ds, range(N_TILES), edb, bs, dev, dmesh)
        res["q"] = batched_embed_q(ds, range(N_EVAL_Q), eq, bs, cfg, dev,
                                   dmesh)
        res["embed_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["recalls"] = evaluate(cfg, ds, eq, edb, device=dev, mesh=dmesh,
                                  gallery_mesh=gmesh)[0]
        res["eval_s"] = time.perf_counter() - t0
        res["counts_eval"] = ops.launches()  # ---- read just after
    res["held"]["eval"], res["checked"]["eval"] = held.worst, held.checked
    res["meshes"] = (dmesh.shape, gmesh.shape)
    del mm, db, eq, edb
    torch.cuda.empty_cache()

    # ---- the sharded searches
    gal, q, small, small_q = mg_search_inputs(dev)
    g = make_mesh(MeshConfig(data_parallel=1, gallery_parallel=MG_WORLD))
    qt = torch.from_numpy(q).to(dev)
    sh = shard_gallery(g, gal, device=dev)
    res["shard_mib"] = sh.numel() * sh.element_size() / 2 ** 20
    (d, i), res["search_ms"] = mg_timed(
        lambda: sharded_l2_topk(g, qt, sh, 5, n_rows=MG_ROWS))
    res["topk"] = (d.cpu().numpy(), i.cpu().numpy())
    del sh
    small_sh = shard_gallery(g, small, device=dev)
    res["window"] = {k: tuple(t.cpu().numpy() for t in sharded_l2_topk(
        g, torch.from_numpy(small_q).to(dev), small_sh, k, n_rows=10))
        for k in (12, 16)}
    idx = PlaceIndex(None, device=dev, quant="int8", gallery_mesh=g)
    idx.add_descriptors(gal)
    res["int8"] = idx.search_descriptors(q, 5)
    res["int8_ms"] = timed_searches(idx, q, 5)
    res["cand"] = sharded_l2_candidates_int8(
        g, qt, idx._device_gallery_int8(), 20)[1].cpu().numpy()
    res["uploads"] = idx.upload_count
    return res


def multi_gpu_rank(case, out, dev, backend) -> None:
    """A rank of [multi-gpu] (``chip_smoke.py --multi-gpu-rank CASE OUT
    DEVICE BACKEND``, its rank in torchrun's variables): joins the group
    through ``parallel.bootstrap`` and writes its results to
    ``OUT/CASE_rankN.pt``."""
    import torch.distributed as dist

    from agplace_tpu_torch.parallel.bootstrap import initialize_distributed

    dev = torch.device(dev)
    if not initialize_distributed(backend=backend, device=dev):
        raise SystemExit("multi_gpu_rank: no coordinator in the environment")
    res = (mg_rank_nccl if case == "nccl" else mg_rank_gloo)(out, dev)
    torch.save(res, os.path.join(out, f"{case}_rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def mg_start(case, world, out, dev, backend):
    """``world`` rank processes of ``case`` (torchrun's variables, every
    rank on ``dev``)."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(world),
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multi-gpu-rank", case,
         out, str(dev), backend], env=dict(env, RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def mg_results(case, procs, out, timeout=600):
    """Each rank's results; a rank that fails or outlasts ``timeout``
    fails the phase (every rank is stopped)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"[multi-gpu] {case} ranks exited "
                             f"{[p.returncode for p in procs]}:\n"
                             + "\n".join(o[-3000:] for o in outs))
    return [torch.load(os.path.join(out, f"{case}_rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def phase_multi_gpu(cfg, towers, dev, name):
    """[multi-gpu]: the single-device references in this process, then the
    NCCL rank and the two gloo ranks (module docstring, item 31).  Returns
    the ranks' launch counts summed (the ``multi_gpu`` path)."""
    import shutil

    from agplace_tpu_torch import ops
    from agplace_tpu_torch.data.pipeline import prefetch_to_device
    from agplace_tpu_torch.embed import batched_embed_db, batched_embed_q
    from agplace_tpu_torch.evaluate import evaluate
    from agplace_tpu_torch.infer import make_infer_fns
    from agplace_tpu_torch.retrieval import knn
    from agplace_tpu_torch.serving import PlaceIndex
    from agplace_tpu_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    out = runs_dir("chip_smoke_multi_gpu")
    mm, db = towers
    torch.save({"mm": mm.state_dict(), "db": db.state_dict()},
               os.path.join(out, "towers.pt"))

    # ---- single-device references (W = 1)
    for warm in (True, False):
        cfg_t, batch, state = mg_train_inputs(dev)
        whole = next(prefetch_to_device([batch], dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = make_train_step(cfg_t)(state, whole)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    ref_loss = float(m["loss"])
    ref_sd = {t: {k: v.cpu() for k, v in sd.items()}
              for t, sd in state.state_dict().items() if t in ("mm", "db")}
    names, sizes, b1 = state.opt.names, state.opt.sizes, state.opt.b1
    ref_grads = (state.opt.mu / (1 - b1)).cpu().split(sizes)
    grad_scale = max(float(g.abs().max()) for g in ref_grads)
    del state, whole, batch
    eq, edb = make_infer_fns(mm, db)
    ds = eval_dataset(cfg, N_TILES, N_EVAL_Q)
    bs = cfg.train.infer_batch_size
    ref_db = batched_embed_db(ds, range(N_TILES), edb, bs, dev)
    ref_q = batched_embed_q(ds, range(N_EVAL_Q), eq, bs, cfg, dev)
    ref_recalls = evaluate(cfg, ds, eq, edb, device=dev)[0]
    gal, q, small, small_q = mg_search_inputs(dev)
    qt = torch.from_numpy(q).to(dev)
    full = torch.from_numpy(gal).to(dev)
    (d_ref, i_ref), search_ms = mg_timed(lambda: knn.l2_topk(qt, full, 5))
    d_ref, i_ref = d_ref.cpu().numpy(), i_ref.cpu().numpy()
    del full
    win_ref = {k: tuple(t.cpu().numpy() for t in knn.l2_topk(
        torch.from_numpy(small_q).to(dev), torch.from_numpy(small).to(dev),
        k)) for k in (12, 16)}
    idx32 = PlaceIndex(None, device=dev)
    idx32.add_descriptors(gal)
    d32, i32 = idx32.search_descriptors(q, 5)
    del idx32, gal
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase

    # ---- the ranks: NCCL at world size 1, then two gloo ranks on cuda:0
    t0 = time.perf_counter()
    nccl = mg_results("nccl", mg_start("nccl", 1, out, dev, "nccl"), out)[0]
    t_nccl = time.perf_counter() - t0
    log(f"[multi-gpu] NCCL, one rank (RANK=0 WORLD_SIZE=1) in "
        f"{t_nccl:.1f} s: backend {nccl['backend']}, world "
        f"{nccl['world']}, explicit mesh {nccl['mesh']}; sharded_l2_topk "
        f"over {MG_NCCL_ROWS} rows = l2_topk: indices equal "
        f"{nccl['equal']}, max |d| error {nccl['d_err']:.3g}; all-reduce "
        f"{nccl['total']}")
    if not (nccl["backend"] == "nccl" and nccl["world"] == 1
            and nccl["equal"] and nccl["d_err"] <= MG_D_TOL
            and nccl["total"] == [2.0] * 4):
        raise AssertionError(f"[multi-gpu] the NCCL rank: {nccl}")
    t0 = time.perf_counter()
    ranks = mg_results("gloo", mg_start("gloo", MG_WORLD, out, dev, "gloo"),
                       out)
    t_gloo = time.perf_counter() - t0

    # ---- the step against the single-device step
    for r, got in enumerate(ranks):
        loss_ok = abs(got["loss"] - ref_loss) <= MG_LOSS_ATOL \
            + MG_LOSS_RTOL * abs(ref_loss)
        p_err, s_err = 0.0, 0.0
        for tower, sd in (("mm", got["state"]), ("db", got["state_db"])):
            for k, v in sd.items():
                want = ref_sd[tower][k]
                if k.endswith(("running_mean", "running_var")):
                    s_err = max(s_err, float(((v - want).abs() / (
                        MG_STATS_TOL + MG_STATS_TOL * want.abs())).max()))
                elif v.is_floating_point():
                    p_err = max(p_err, float((v - want).abs().max()))
        # the applied gradient's error over its largest element; each
        # leaf's over its own scale too (reported: a leaf whose terms
        # cancel, such as a conv's before a train-mode BN, shows the
        # convs' reassociation many times over)
        leaf = [(float((a - b).abs().max()), float(b.abs().max()), n)
                for a, b, n in zip((got["mu"] / (1 - b1)).split(sizes),
                                   ref_grads, names)]
        top = max(leaf)
        g_err = top[0] / grad_scale
        worst = max(leaf, key=lambda t: t[0] / max(
            t[1], TRAIN_ZERO_REL * grad_scale))
        log(f"[multi-gpu] rank {r}: data-parallel step ({got['dp']} ranks, "
            f"{got['rows']} of {MG_TRAIN_Q} queries here) vs one device: "
            f"loss {got['loss']:.7g} vs {ref_loss:.7g}, parameters max |d| "
            f"{p_err:.3g} (atol {MG_PARAM_ATOL}), BN statistics "
            f"{s_err:.3g} of the 1e-4 allowance, applied gradient "
            f"{g_err:.3g} of its largest element (tol {MG_GRAD_TOL}) in "
            f"{top[2]} (its own scale {top[1] / grad_scale:.3g} of the "
            f"largest); the worst leaf over its own scale {worst[2]} "
            f"{worst[0] / max(worst[1], 1e-30):.3g}")
        if not (loss_ok and got["dp"] == MG_WORLD and p_err <= MG_PARAM_ATOL
                and s_err <= 1.0 and g_err <= MG_GRAD_TOL):
            raise AssertionError(f"[multi-gpu] rank {r}: the step differs")
    same = all(torch.equal(a, ranks[1]["state"][k])
               for k, a in ranks[0]["state"].items())
    log(f"[multi-gpu] the two ranks' query towers after the step bit-equal: "
        f"{same}")
    if not same:
        raise AssertionError("[multi-gpu] the ranks' states differ")

    # ---- the embeds and evaluate against one device
    for r, got in enumerate(ranks):
        errs = [float(np.abs(got[key] - ref).max()) / float(np.abs(ref).max())
                for key, ref in (("db", ref_db), ("q", ref_q))]
        ok = (got["db"].shape == ref_db.shape and got["q"].shape
              == ref_q.shape and max(errs) <= MG_EMBED_TOL
              and np.array_equal(got["recalls"], ref_recalls))
        log(f"[multi-gpu] rank {r}: meshes {got['meshes']}; data-parallel "
            f"descriptors of {N_TILES} tiles and {N_EVAL_Q} queries vs one "
            f"device's: max error {errs[0]:.3g} and {errs[1]:.3g} of scale "
            f"(tol {MG_EMBED_TOL}); embeds {got['embed_s']:.2f} s, evaluate "
            f"{got['eval_s']:.2f} s (each launch held to its plain version "
            f"meanwhile); recalls {got['recalls'].tolist()} vs one device "
            f"{ref_recalls.tolist()} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[multi-gpu] rank {r}: the data-parallel "
                                 f"embeds or evaluate differ")

    # ---- the searches against one device
    for r, got in enumerate(ranks):
        d, i = got["topk"]
        ok = (np.array_equal(i, i_ref)
              and float(np.abs(d - d_ref).max()) <= MG_D_TOL)
        for k, (dw, iw) in got["window"].items():
            ok &= (np.array_equal(iw, win_ref[k][1])
                   and (iw[:, 10:] == -1).all()
                   and np.isinf(dw[:, 10:]).all())
        held = all(set(i_ref[j]) <= set(got["cand"][j].tolist())
                   for j in range(len(i_ref)))
        d8, i8 = got["int8"]
        missed = int((d32 < d8 - 1e-4).any(axis=1).sum())
        bad = ties_aside(i8, i32, d32)
        err8 = float(np.abs(d8 - d32).max())
        log(f"[multi-gpu] rank {r}: sharded_l2_topk over {MG_ROWS} x 256 "
            f"rows ({got['shard_mib']:.0f} MiB here) at k = 5 = l2_topk: "
            f"{ok}; padding window k = 12, 16 on 10 rows: faiss padding; "
            f"int8 candidates hold the exact top-5: {held}; "
            f"PlaceIndex(gallery_mesh, int8) vs the fp32 single-device "
            f"index: {missed} candidate misses, {bad} queries apart, max "
            f"|d| {err8:.3g}, {got['uploads']} upload")
        if not (ok and held and not missed and not bad
                and err8 <= SERVE_D_TOL and got["uploads"] == 1):
            raise AssertionError(f"[multi-gpu] rank {r}: the sharded "
                                 f"search differs")
    log(f"[multi-gpu] ms at W = 1 (this process) and W = 2 (two gloo ranks "
        f"sharing one card, so NOT scaling figures): train step "
        f"{step_ms:.1f} vs {[round(g['step_ms'], 1) for g in ranks]}; "
        f"exact search of 32 queries over {MG_ROWS} rows {search_ms:.3f} "
        f"vs {[round(g['search_ms'], 3) for g in ranks]}; int8 index "
        f"search {[round(g['int8_ms'], 3) for g in ranks]} ({name})")

    # ---- the launches: K1 in the step, K1-K3 in the embeds
    counts = dict.fromkeys(ops.launches(), 0)
    want_step = dict.fromkeys(counts, 0)
    want_step["fused_euler_ode"] = 3
    n_fwd = 2 * -(-N_EVAL_Q // bs)  # the embeds' and evaluate's queries
    want_eval = expected_launches(cfg, N_TILES, n_fwd)
    for r, got in enumerate(ranks):
        if got["counts_step"] != want_step or got["counts_eval"] != \
                want_eval:
            raise AssertionError(
                f"[multi-gpu] rank {r} launches: step {got['counts_step']} "
                f"!= {want_step}, embeds {got['counts_eval']} != "
                f"{want_eval}")
        # every launch of both paths was held to its plain version in the
        # rank (a disagreement there fails the rank)
        for path in ("step", "eval"):
            launched = {k: n for k, n in got[f"counts_{path}"].items() if n}
            log(f"[multi-gpu] rank {r} {path}: {got['checked'][path]} of "
                f"the launches {launched} held to their plain versions, "
                f"worst max_abs_err {got['held'][path]}")
            if got["checked"][path] != launched:
                raise AssertionError(
                    f"[multi-gpu] rank {r} {path}: launches {launched} but "
                    f"{got['checked'][path]} held to their plain versions")
        for k in counts:
            counts[k] += got["counts_step"][k] + got["counts_eval"][k]
    log(f"[multi-gpu] launches over both ranks {counts}; references "
        f"{t_ref:.1f} s, NCCL rank {t_nccl:.1f} s, gloo ranks "
        f"{t_gloo:.1f} s; unchecked on one card: NCCL at more than one "
        f"rank, traffic between cards")
    shutil.rmtree(out, ignore_errors=True)
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
    t_start = time.perf_counter()
    name = card()
    log(name)
    dev = torch.device("cuda")
    import PIL
    import PIL.features

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; the readers' Pillow "
        f"{PIL.__version__} (jpg {PIL.features.check('jpg')}, zlib "
        f"{PIL.features.check('zlib')})")
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
        log("[bn-act] the ResNet epilogue kernel at the cells' maps")
        bn_act_row = phase_bn_act(dev)

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
    # ---- serving extras, the real readers and the entry points
    phase_serve_int8(dev)
    phase_serve_http(dev)
    counts_k, counts_kf, tree, save_dir = phase_data_kitti360(dev)
    counts_ns = phase_data_nuscenes(dev)
    phase_family_cli(dev, tree)  # needs [data-kitti360]'s tree
    phase_serve_cli(dev, tree, save_dir)
    # ---- the MM's option tail: backends, integrators, options, training
    counts_mb = phase_mm_backends(cfg, dev, name)
    counts_mo = phase_mm_ode(cfg, dev, name)
    counts_mx = phase_mm_options(cfg, dev)
    phase_ode_lib(cfg, dev, mm)
    phase_sync_free(dev)
    phase_train_sparse(dev)
    # ---- the factory's other towers: GeoLoc, MinkLoc, the image branches
    counts_g = phase_geoloc(cfg, dev, name)
    counts_gt = phase_geoloc_train(dev, name)
    counts_gf = phase_geoloc_families(cfg, dev, name)
    counts_mi = phase_mm_imgfe(cfg, dev, name)
    counts_ml = phase_minkloc(cfg, dev, name)
    # ---- the single-device tail: pretrained grafts, AnyLoc, the rest
    import shutil

    wdir, sds = weights_dir()
    try:
        counts_pre = phase_pretrained(cfg, dev, name, wdir, sds)
    finally:
        shutil.rmtree(wdir, ignore_errors=True)
    del sds
    phase_anyloc(dev, name)
    counts_tl = phase_tail(cfg, dev, name, mm)
    phase_flags(dev)
    # ---- K1-K4 off the preset widths: W1-W3
    widths_counts, widths, lone, lone_counts = phase_widths(cfg, dev)
    counts_w = {k: sum(c[k] for c, _ in widths_counts) for k in counts}
    instances_w = {}
    for _, inst in widths_counts:
        for k, by in inst.items():
            for i, n in by.items():
                instances_w.setdefault(k, {}).setdefault(i, 0)
                instances_w[k][i] += n
    for k in instances_w:
        parity[k]["widths"] = {
            label: {a: r for a, r in rec["alone"].items()
                    if a.startswith(k + "/")}
            | {"launches": rec["launches"][k],
                                   "instances": rec["instances"][k],
                                   "worst_vs_plain": rec["worst"].get(k),
                                   "cpu_err": rec["cpu_err"],
                                   "batch": rec["batch"],
                                   "flags": rec["flags"]}
            for label, rec in widths.items()}
    for k, rec in lone.items():
        parity[k].setdefault("widths", {})["lone"] = rec
    # ---- the multi-GPU layer: NCCL at one rank, two gloo ranks
    counts_mg = phase_multi_gpu(cfg, towers, dev, name)

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
                                  + counts_t[k] + counts_k[k]
                                  + counts_kf[k] + counts_ns[k]
                                  + counts_mb[k] + counts_mo[k]
                                  + counts_mx[k] + counts_g[k]
                                  + counts_gt[k] + counts_gf[k]
                                  + counts_mi[k] + counts_ml[k]
                                  + counts_pre[k] + counts_tl[k]
                                  + counts_w[k] + counts_mg[k]),
                     "launches_by_path": {"default": counts[k],
                                          "fused": counts_f[k],
                                          "nuscenes_fused": counts_n[k],
                                          "probe": counts_p[k],
                                          "eval": counts_e[k],
                                          "eval_crops": counts_c[k],
                                          "eval_fused": counts_ef[k],
                                          "train_step": counts_ts[k],
                                          "train": counts_t[k],
                                          "data_kitti360": counts_k[k],
                                          "data_kitti360_fused":
                                              counts_kf[k],
                                          "data_nuscenes": counts_ns[k],
                                          "mm_backends": counts_mb[k],
                                          "mm_ode": counts_mo[k],
                                          "mm_options": counts_mx[k],
                                          "geoloc": counts_g[k],
                                          "geoloc_train": counts_gt[k],
                                          "geoloc_families": counts_gf[k],
                                          "mm_imgfe": counts_mi[k],
                                          "minkloc": counts_ml[k],
                                          "pretrained": counts_pre[k],
                                          "tail": counts_tl[k],
                                          "widths": counts_w[k],
                                          "multi_gpu": counts_mg[k]},
                     "max_abs_err": parity[k]["max_abs_err"],
                     "frac_differ": parity[k]["frac_differ"],
                     "ms": parity[k]["ms"],
                     "plain_ms": parity[k]["plain_ms"],
                     "bound_ms": parity[k]["bound_ms"],
                     "bound_by": parity[k]["bound_by"],
                     "library_ms": parity[k]["library_ms"],
                     "launches_by_instance_in_widths":
                         instances_w.get(k)},
                    **{x: parity[k][x] for x in RECORD_KEYS
                       if x in parity[k]})
               for k, (src, rep) in sources.items()]
    kernels += instance_rows(parity, widths, instances_w, lone_counts,
                             sources)
    bn_act_row.update(launches=sum(EPILOGUES.values()),
                      launches_by_path=dict(EPILOGUES))
    if not bn_act_row["launches"]:
        raise AssertionError("no main path launched fused_bn_act")
    kernels.append(bn_act_row)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s of wall time "
        f"(after imports)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-gpu-rank"]:
        multi_gpu_rank(*sys.argv[2:6])
    else:
        main()
