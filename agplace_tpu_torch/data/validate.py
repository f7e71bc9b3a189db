"""Dataset-layout validator (``agplace_tpu/data/validate.py``).

When real KITTI-360-AG / nuScenes-AG data is first mounted, the most likely
failure is a layout mismatch surfacing as a FileNotFoundError deep inside
the dataset walk.  This module checks the expected on-disk layout up front,
prints what is present/missing, and dry-builds the port's readers; it
exits 1 when anything required is missing.

Usage::

    python -m agplace_tpu_torch.data.validate --dataset kitti360 --dataroot /data/kitti360ag
    python -m agplace_tpu_torch.data.validate --dataset nuscenes --dataroot /data/nuscenesag

Expected layouts (reference walk, cited per check):

KITTI-360-AG  (``datasets_ws_kitti360.py:45-67,500-607``)::

    <dataroot>/
      data_poses/<drive>/oxts/data/*.txt            lat lon ... per line
      data_3d_voxel0.5/<drive>/velodyne_points/data/*.bin
      data_2d_raw_resize320/<drive>/image_00/data_rect/*.png
      data_2d_cat0203/<drive>/image_0203/data_rgb/*.png   (fisheye cat)
      data_aerial_1_20_320_satellite/<drive>/*@east@north@lat@lon@*.png
      data_aerial_1_20_320_roadmap/<drive>/*.png

    with <drive> in the 7 ``2013_05_28_drive_XXXX_sync`` sequences.

nuScenes-AG  (``datasets_ws_nuscenes.py:551-634,741-752,861-901``)::

    <dataroot>/
      v1.0-trainval/*.json   (train)  or  v1.0-test/*.json  (test)
      samples/CAM_*/...jpg and the pre-resized samples/CAM_*_size256/
      samples/LIDAR_TOP_voxel1/...npy   (pre-voxelised clouds)
      aerial_<version>_<location>_1_20_320_<maptype>/*@east@north@...png
      (4 locations; Boston tiles carry the 1.5 degree rotation already)

    plus (optional, devkit-free fast path) a prebuilt
    agplace_index_<version>_<split>.json from ``nuscenes.build_index``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List


class _Report:
    def __init__(self) -> None:
        self.errors: List[str] = []
        self.warnings: List[str] = []

    def ok(self, msg: str) -> None:
        print(f"  [ok]      {msg}")

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)
        print(f"  [warn]    {msg}")

    def missing(self, msg: str) -> None:
        self.errors.append(msg)
        print(f"  [MISSING] {msg}")


def _count_files(d: str) -> int:
    try:
        return len(os.listdir(d))
    except OSError:
        return -1


def _check_dir(rep: _Report, path: str, what: str,
               required: bool = True) -> bool:
    n = _count_files(path)
    if n < 0:
        (rep.missing if required else rep.warn)(f"{what}: {path}")
        return False
    rep.ok(f"{what}: {n} files ({path})")
    return True


def _check_aerial_name(rep: _Report, d: str) -> None:
    """Aerial tiles encode UTM in the name: *@east@north@... — KITTI-360
    names carry lat/lon too (``datasets_ws_kitti360.py:592-596``), nuScenes
    names only east/north (``datasets_ws_nuscenes.py:869-871``)."""
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return
    if not names:
        rep.missing(f"aerial dir is empty: {d}")
        return
    name = names[0]
    parts = name.rsplit(".", 1)[0].split("@")
    try:
        east, north = float(parts[1]), float(parts[2])
    except (IndexError, ValueError):
        rep.missing(
            f"aerial tile name not '*@east@north@...': {name!r} in {d}")
        return
    if not (1e4 < abs(east) < 1e6 and 1e5 < abs(north) < 1e7):
        rep.warn(f"aerial UTM out of plausible range: east={east} "
                 f"north={north} ({name!r})")
    else:
        rep.ok(f"aerial tile name parses: east={east:.0f} north={north:.0f}")


def validate_kitti360(dataroot: str, rep: _Report, dry_build: bool = True,
                      maptypes=("satellite", "roadmap")) -> None:
    from agplace_tpu_torch.data.kitti360 import (
        SELECT_LOCATIONS, _AERIAL_DIR, _IMAGE_RESIZE_DIR)

    print(f"KITTI-360-AG layout check under {dataroot}")
    if not os.path.isdir(dataroot):
        rep.missing(f"dataroot does not exist: {dataroot}")
        return

    present = []
    for loc in SELECT_LOCATIONS:
        print(f" drive {loc}:")
        if not os.path.isdir(os.path.join(dataroot, "data_poses", loc)):
            rep.warn(f"drive absent (skipped by the walk): {loc}")
            continue
        present.append(loc)
        dirs = {
            "poses": os.path.join(dataroot, "data_poses", loc, "oxts/data"),
            "lidar voxel0.5": os.path.join(
                dataroot, "data_3d_voxel0.5", loc, "velodyne_points/data"),
            "cam00 resize320": os.path.join(
                dataroot, _IMAGE_RESIZE_DIR, loc, "image_00/data_rect"),
            "fisheye cat0203": os.path.join(
                dataroot, "data_2d_cat0203", loc, "image_0203/data_rgb"),
        }
        for maptype in maptypes:
            dirs[f"aerial {maptype}"] = os.path.join(
                dataroot, _AERIAL_DIR.format(maptype=maptype), loc)
        oks = {k: _check_dir(rep, d, k) for k, d in dirs.items()}
        if oks.get("aerial satellite"):
            _check_aerial_name(rep, dirs["aerial satellite"])
        # stem alignment: pose/pc/cat0203 counterparts for sampled images
        if oks.get("cam00 resize320"):
            names = sorted(os.listdir(dirs["cam00 resize320"]))
            sample = names[:: max(1, len(names) // 5)][:5]
            for name in sample:
                stem = name.rsplit(".", 1)[0]
                for what, d, suf in (
                        ("pose", dirs["poses"], ".txt"),
                        ("lidar", dirs["lidar voxel0.5"], ".bin"),
                        ("cat0203", dirs["fisheye cat0203"], ".png")):
                    p = os.path.join(d, stem + suf)
                    if oks.get({"pose": "poses",
                                "lidar": "lidar voxel0.5",
                                "cat0203": "fisheye cat0203"}[what]) \
                            and not os.path.exists(p):
                        rep.missing(f"{loc}: {what} missing for image "
                                    f"stem {stem}: {p}")

    if not present:
        rep.missing("no drives present at all — wrong dataroot?")
        return
    if dry_build:
        _dry_build("kitti360", dataroot, rep)


def validate_nuscenes(dataroot: str, rep: _Report, dry_build: bool = True,
                      maptypes=("satellite", "roadmap"),
                      splits=("train", "test")) -> None:
    from agplace_tpu_torch.data.nuscenes import LOCATIONS, _AERIAL_FMT

    print(f"nuScenes-AG layout check under {dataroot}")
    if not os.path.isdir(dataroot):
        rep.missing(f"dataroot does not exist: {dataroot}")
        return

    for split in splits:
        version = "v1.0-trainval" if split == "train" else "v1.0-test"
        print(f" split {split} ({version}):")
        idx_path = os.path.join(dataroot,
                                f"agplace_index_{version}_{split}.json")
        has_index = os.path.exists(idx_path)
        if has_index:
            rep.ok(f"prebuilt index: {idx_path} (devkit not needed)")
        meta = os.path.join(dataroot, version)
        if os.path.isdir(meta):
            for j in ("sample.json", "scene.json", "log.json",
                      "ego_pose.json", "sample_data.json"):
                if os.path.exists(os.path.join(meta, j)):
                    rep.ok(f"devkit table {version}/{j}")
                else:
                    (rep.warn if has_index else rep.missing)(
                        f"devkit table absent: {version}/{j}")
        elif not has_index:
            rep.missing(
                f"neither a prebuilt index ({idx_path}) nor devkit "
                f"metadata ({meta}) present — the index cannot be built")
        for location in LOCATIONS:
            d = os.path.join(dataroot, _AERIAL_FMT.format(
                version=version, location=location, maptype=maptypes[0]))
            if _check_dir(rep, d, f"aerial {maptypes[0]} {location}",
                          required=False):
                _check_aerial_name(rep, d)
            for maptype in maptypes[1:]:
                _check_dir(rep, os.path.join(dataroot, _AERIAL_FMT.format(
                    version=version, location=location, maptype=maptype)),
                    f"aerial {maptype} {location}", required=False)

    # sensor dirs: the pre-resized cams and pre-voxelised lidar
    samples = os.path.join(dataroot, "samples")
    if os.path.isdir(samples):
        subdirs = sorted(os.listdir(samples))
        cams = [d for d in subdirs
                if d.startswith("CAM_") and not d.endswith("_size256")]
        for cam in cams:
            resized = os.path.join(samples, cam + "_size256")
            if os.path.isdir(resized):
                rep.ok(f"pre-resized cam dir samples/{cam}_size256 "
                       f"({_count_files(resized)} files)")
            else:
                rep.missing(f"pre-resized cam dir absent: samples/"
                            f"{cam}_size256 (reference loads cams from the "
                            f"_size256 dirs, datasets_ws_nuscenes.py:607)")
        vox = os.path.join(samples, "LIDAR_TOP_voxel1")
        if os.path.isdir(vox):
            rep.ok(f"pre-voxelised lidar samples/LIDAR_TOP_voxel1 "
                   f"({_count_files(vox)} files)")
        else:
            rep.missing("pre-voxelised lidar dir absent: samples/"
                        "LIDAR_TOP_voxel1 (*.npy per sweep, "
                        "datasets_ws_nuscenes.py:565-568)")
    else:
        rep.missing(f"samples/ dir absent: {samples}")

    if dry_build:
        _dry_build("nuscenes", dataroot, rep, splits=splits)


def _dry_build(dataset: str, dataroot: str, rep: _Report,
               splits=("train", "test")) -> None:
    """Instantiate the port's reader (index walk + radius ground truth) and
    report counts: the code path ``python -m agplace_tpu_torch.train``
    runs first."""
    import dataclasses

    from agplace_tpu_torch.config import kitti360_config, nuscenes_config

    cfg = kitti360_config() if dataset == "kitti360" else nuscenes_config()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, dataroot=dataroot))
    for split in splits:
        try:
            if dataset == "kitti360":
                from agplace_tpu_torch.data.kitti360 import KITTI360Dataset

                ds = KITTI360Dataset(cfg, split=split)
            else:
                from agplace_tpu_torch.data.nuscenes import NuScenesDataset

                ds = NuScenesDataset(cfg, split=split)
        except Exception as e:  # noqa: BLE001 — report, do not crash
            rep.missing(f"dry-build {split} failed: {type(e).__name__}: {e}")
            continue
        n_with_pos = sum(1 for p in ds.hard_positives_per_query if len(p))
        rep.ok(f"dry-build {split}: {ds.queries_num} queries, "
               f"{ds.database_num} db tiles, {n_with_pos} queries with a "
               f"hard positive (<{cfg.data.train_positives_dist_threshold}"
               f" m)")
        if ds.queries_num and not n_with_pos:
            rep.warn(f"{split}: NO query has a hard positive — UTM frames "
                     f"of queries and tiles likely disagree")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", required=True,
                    choices=["kitti360", "nuscenes"])
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--maptype", default="satellite_roadmap",
                    help="'_'-separated map types (reference --maptype)")
    ap.add_argument("--no-build", action="store_true",
                    help="layout checks only, skip the dataset dry-build")
    ap.add_argument("--splits", default="train_test",
                    help="nuScenes only: '_'-separated splits to check")
    args = ap.parse_args(argv)

    rep = _Report()
    maptypes = tuple(args.maptype.split("_"))
    if args.dataset == "kitti360":
        validate_kitti360(args.dataroot, rep, dry_build=not args.no_build,
                          maptypes=maptypes)
    else:
        validate_nuscenes(args.dataroot, rep, dry_build=not args.no_build,
                          maptypes=maptypes,
                          splits=tuple(args.splits.split("_")))

    print()
    if rep.errors:
        print(f"FAILED: {len(rep.errors)} missing/broken, "
              f"{len(rep.warnings)} warnings")
        return 1
    print(f"LAYOUT OK ({len(rep.warnings)} warnings)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
