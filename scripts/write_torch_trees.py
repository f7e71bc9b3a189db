"""Seeded KITTI-360-AG and nuScenes-AG dataset trees on disk, in the layouts
the readers walk (``agplace_tpu_torch/data/{kitti360,nuscenes}.py``), for
the port's tests and ``chip_smoke.py``:

    python3 scripts/write_torch_trees.py kitti360 DIR [--frames 80]
    python3 scripts/write_torch_trees.py nuscenes DIR [--queries 64]

KITTI-360-AG: drives of ``frames`` frames whose oxts poses step
``step_m`` metres north a frame (about a real drive's spacing at its
frame rate), drive d starting 1.1 km north of drive d - 1; per frame a
query image (the ``data_2d_raw_resize320`` size by default: 1198 x 320), a
LiDAR-like ``.bin`` cloud and an aerial tile per map type named
``@east@north@lat@lon@`` from the frame's pose.  nuScenes-AG: ``queries``
samples of one location spaced ``step_m`` metres east, with the six
cameras in the pre-resized ``_size256`` dirs (JPEG), pre-voxelised
``LIDAR_TOP_voxel1`` clouds, the cached index JSON the reader loads (no
devkit), and one aerial tile per sample, 1.5 m from it.  Images are smooth
seeded noise (upsampled coarse noise), so they compress like photographs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from agplace_tpu_torch.data.geo import from_latlon  # noqa: E402
from agplace_tpu_torch.data.kitti360 import (  # noqa: E402
    _AERIAL_DIR, _IMAGE_RESIZE_DIR, SELECT_LOCATIONS)
from agplace_tpu_torch.data.nuscenes import (  # noqa: E402
    _AERIAL_FMT, _CAM_OF, ego_to_utm)

_M_PER_DEG_LAT = 111_320.0


def smooth_image(rng, h: int, w: int) -> Image.Image:
    coarse = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3),
                          dtype=np.uint8)
    return Image.fromarray(coarse).resize((w, h), Image.BILINEAR)


def lidar(rng, n: int) -> np.ndarray:
    """[n, 3] float32: a spinning 32-beam sensor's returns, 2-60 m."""
    az = rng.uniform(0, 2 * np.pi, n)
    elev = np.deg2rad(rng.uniform(-24.9, 2.0, n))
    r = np.exp(rng.uniform(np.log(2.0), np.log(60.0), n))
    return np.stack([r * np.cos(elev) * np.cos(az),
                     r * np.cos(elev) * np.sin(az),
                     np.maximum(r * np.sin(elev), -1.73)],
                    axis=-1).astype(np.float32)


def kitti360_tree(root: str, drives: int = 2, frames: int = 80,
                  image_hw=(320, 1198), tile: int = 320,
                  n_points: int = 30000, step_m: float = 1.0,
                  maptypes=("satellite", "roadmap"), cat0203: bool = False,
                  seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    for d, loc in enumerate(SELECT_LOCATIONS[:drives]):
        dirs = {"pose": f"data_poses/{loc}/oxts/data",
                "pc": f"data_3d_voxel0.5/{loc}/velodyne_points/data",
                "img": f"{_IMAGE_RESIZE_DIR}/{loc}/image_00/data_rect",
                "cat": f"data_2d_cat0203/{loc}/image_0203/data_rgb"}
        dirs.update({m: f"{_AERIAL_DIR.format(maptype=m)}/{loc}"
                     for m in maptypes})
        if not cat0203:
            del dirs["cat"]
        for sub in dirs.values():
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        lat0, lon0 = 48.98 + 0.01 * d, 8.43
        for i in range(frames):
            stem = f"{i:010d}"
            lat, lon = lat0 + i * step_m / _M_PER_DEG_LAT, lon0
            with open(os.path.join(root, dirs["pose"], stem + ".txt"),
                      "w") as f:
                f.write(f"{lat!r} {lon!r} 110.0 0 0 0")
            img = smooth_image(rng, *image_hw)
            img.save(os.path.join(root, dirs["img"], stem + ".png"),
                     compress_level=1)
            if cat0203:
                img.save(os.path.join(root, dirs["cat"], stem + ".png"),
                         compress_level=1)
            lidar(rng, n_points).tofile(
                os.path.join(root, dirs["pc"], stem + ".bin"))
            e, n, _, _ = from_latlon(lat, lon)
            name = f"img@{float(e):.2f}@{float(n):.2f}@{lat!r}@{lon!r}@.png"
            for m in maptypes:
                smooth_image(rng, tile, tile).save(
                    os.path.join(root, dirs[m], name), compress_level=1)
    return root


def nuscenes_tree(root: str, split: str = "test", queries: int = 64,
                  cam_hw=(256, 455), tile: int = 320,
                  n_points: int = 30000, step_m: float = 4.0,
                  location: str = "boston-seaport",
                  maptypes=("satellite", "roadmap"), seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    version = "v1.0-trainval" if split == "train" else "v1.0-test"
    lidar_dir = os.path.join(root, "samples", "LIDAR_TOP_voxel1")
    os.makedirs(lidar_dir, exist_ok=True)
    for cam in _CAM_OF.values():
        os.makedirs(os.path.join(root, "samples", cam + "_size256"),
                    exist_ok=True)
    tile_dirs = {m: os.path.join(root, _AERIAL_FMT.format(
        version=version, location=location, maptype=m)) for m in maptypes}
    for d in tile_dirs.values():
        os.makedirs(d, exist_ok=True)
    index = []
    for qi in range(queries):
        paths = {}
        for cam in _CAM_OF.values():
            smooth_image(rng, *cam_hw).save(os.path.join(
                root, "samples", cam + "_size256", f"q{qi}.jpg"), quality=90)
            paths[cam] = f"samples/{cam}/q{qi}.jpg"
        np.save(os.path.join(lidar_dir, f"q{qi}.npy"), lidar(rng, n_points))
        paths["LIDAR_TOP"] = f"samples/LIDAR_TOP/q{qi}.pcd.bin"
        east, north = map(float, ego_to_utm(location,
                                            np.array([step_m * qi, 0.0])))
        index.append({
            "token": f"tok{qi}", "prev": f"tok{qi - 1}" if qi else "",
            "next": f"tok{qi + 1}" if qi + 1 < queries else "",
            "location": location, "east": east, "north": north,
            "paths": paths})
        for m, d in tile_dirs.items():
            smooth_image(rng, tile, tile).save(os.path.join(
                d, f"tile@{east + 1.5!r}@{north!r}@x@.png"),
                compress_level=1)
    with open(os.path.join(root, f"agplace_index_{version}_{split}.json"),
              "w") as f:
        json.dump({"version": version, "split": split, "queries": index}, f)
    return root


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dataset", choices=["kitti360", "nuscenes"])
    ap.add_argument("root")
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--queries", type=int, default=64)
    args = ap.parse_args(argv)
    if args.dataset == "kitti360":
        kitti360_tree(args.root, frames=args.frames)
    else:
        nuscenes_tree(args.root, queries=args.queries)
    print(args.root)


if __name__ == "__main__":
    main()
