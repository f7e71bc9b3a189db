"""KITTI-360-AG dataset (``agplace_tpu/data/kitti360.py``).

The index: a walk over the drive sequences present under ``dataroot``
(oxts lat/lon -> UTM, ``@east@north@lat@lon@`` aerial tile names, the
``train_ratio`` split and the ``traindownsample`` stride of the training
split) and the radius ground truth.  The items: numpy [H, W, 3] float32
query images (short side ``q_resize``, mean .5 / std .22), NaN-padded point
clouds of ``4 * vox_max_points`` rows, and [NMAP, H, W, 3] aerial tiles
(centre crop, resize), all decoded on the host with PIL.  The colour
jitter of the training split draws from an unseeded generator, as the JAX
reader does.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.data.base import PlaceDataset
from agplace_tpu_torch.data.geo import from_latlon
from agplace_tpu_torch.data.transforms import (
    center_crop,
    color_jitter,
    load_image_rgb,
    normalize,
    resize,
)
from agplace_tpu_torch.retrieval.knn import radius_neighbors

# drive sequences on the default path (datasets_ws_kitti360.py:43-67)
SELECT_LOCATIONS = [
    "2013_05_28_drive_0000_sync",
    "2013_05_28_drive_0003_sync",
    "2013_05_28_drive_0004_sync",
    "2013_05_28_drive_0005_sync",
    "2013_05_28_drive_0006_sync",
    "2013_05_28_drive_0007_sync",
    "2013_05_28_drive_0010_sync",
]

_AERIAL_DIR = "data_aerial_1_20_320_{maptype}"  # scale 1, zoom 20, size 320
_IMAGE_RESIZE_DIR = "data_2d_raw_resize320"


class KITTI360Dataset(PlaceDataset):
    def __init__(self, cfg: Config, split: str = "train",
                 train_queries: bool = False, rng_seed: int = 0):
        assert split in ("train", "test")
        self.cfg = cfg
        self.split = split
        self.is_train_transform = split == "train"
        dataroot = cfg.data.dataroot
        tr = cfg.data.train_ratio
        down = cfg.data.traindownsample
        log = logging.getLogger("kitti360")

        # only drives present on disk (the full dataset has all 7; partial
        # checkouts and test fixtures may have fewer)
        locations = [
            loc for loc in SELECT_LOCATIONS
            if os.path.isdir(os.path.join(dataroot, "data_poses", loc))
        ]
        if len(locations) < len(SELECT_LOCATIONS):
            log.warning("only %d/%d drives present under %s",
                        len(locations), len(SELECT_LOCATIONS), dataroot)

        self.queries_infos: List[Dict] = []
        q_utms = []
        for loc in locations:
            qpcdir = os.path.join(dataroot, "data_3d_voxel0.5", loc,
                                  "velodyne_points/data")
            qposedir = os.path.join(dataroot, "data_poses", loc, "oxts/data")
            qimage00dir = os.path.join(dataroot, _IMAGE_RESIZE_DIR, loc,
                                       "image_00/data_rect")
            qimage0203dir = os.path.join(dataroot, "data_2d_cat0203", loc,
                                         "image_0203/data_rgb")
            names = sorted(os.listdir(qimage0203dir)) \
                if os.path.isdir(qimage0203dir) \
                else sorted(os.listdir(qimage00dir))
            if split == "train":
                names = names[: int(len(names) * tr)]
            else:
                names = names[int(len(names) * tr):]
            kept = 0
            for i, name in enumerate(names):
                if split == "train" and i % down != 0:
                    continue
                stem = name.rsplit(".", 1)[0]
                posepath = os.path.join(qposedir, stem + ".txt")
                with open(posepath) as f:
                    pose = f.readline().split(" ")
                lat, lon = float(pose[0]), float(pose[1])
                east, north, _, _ = from_latlon(lat, lon)
                self.queries_infos.append({
                    "east": float(east), "north": float(north),
                    "qimage00path": os.path.join(qimage00dir, stem + ".png"),
                    "qimage0203path": os.path.join(qimage0203dir,
                                                   stem + ".png"),
                    "qpcpath": os.path.join(qpcdir, stem + ".bin"),
                    "location": loc,
                })
                q_utms.append([east, north])
                kept += 1
            log.info("%s: %d query samples", loc, kept)
        self.q_eastnorth = np.asarray(q_utms, np.float64).reshape(-1, 2)

        self.database_infos: List[Dict] = []
        db_utms = []
        for loc in locations:
            sat_dir = os.path.join(
                dataroot, _AERIAL_DIR.format(maptype="satellite"), loc)
            names = sorted(os.listdir(sat_dir))
            if split == "train":
                names = names[: int(len(names) * tr)]
            else:
                names = names[int(len(names) * tr):]
            for i, name in enumerate(names):
                if split == "train" and i % down != 0:
                    continue
                parts = name.rsplit(".", 1)[0].split("@")
                east, north = float(parts[1]), float(parts[2])
                info = {"east": east, "north": north, "location": loc}
                for maptype in cfg.data.maptype:
                    info[f"db_{maptype}_path"] = os.path.join(
                        dataroot, _AERIAL_DIR.format(maptype=maptype), loc,
                        name)
                self.database_infos.append(info)
                db_utms.append([east, north])
        self.db_eastnorth = np.asarray(db_utms, np.float64).reshape(-1, 2)

        self.database_num = len(self.database_infos)
        self.queries_num = len(self.queries_infos)
        self.soft_positives_per_query = radius_neighbors(
            self.q_eastnorth, self.db_eastnorth,
            cfg.data.val_positive_dist_threshold)
        self.hard_positives_per_query = radius_neighbors(
            self.q_eastnorth, self.db_eastnorth,
            cfg.data.train_positives_dist_threshold)

    # item loaders ---------------------------------------------------------
    def load_query_image(self, idx: int) -> np.ndarray:
        cam = self.cfg.data.camnames[0]
        key = "qimage00path" if cam == "00" else "qimage0203path"
        img = load_image_rgb(self.queries_infos[idx][key])
        img = resize(img, self.cfg.data.q_resize)
        if self.is_train_transform and self.cfg.data.q_jitter > 0:
            d = self.cfg.data
            img = color_jitter(img, d.q_jitter, np.random.default_rng(),
                               brightness=d.brightness, contrast=d.contrast,
                               saturation=d.saturation, hue_strength=d.hue)
        # KITTI-360 normalisation: mean .5 / std .22 (kitti360:244)
        return normalize(img, self.cfg.data.norm_mean, self.cfg.data.norm_std)

    def load_query_points(self, idx: int) -> np.ndarray:
        path = self.queries_infos[idx]["qpcpath"]
        pc = np.fromfile(path, dtype=np.float32).reshape(-1, 3)
        cap = 4 * self.cfg.data.vox_max_points
        if len(pc) > cap:
            sel = np.random.default_rng(idx).choice(len(pc), cap,
                                                    replace=False)
            pc = pc[sel]
        out = np.full((cap, 3), np.nan, np.float32)
        out[: len(pc)] = pc
        return out

    def load_db_maps(self, idx: int) -> np.ndarray:
        info = self.database_infos[idx]
        maps = []
        for maptype in self.cfg.data.maptype:
            img = load_image_rgb(info[f"db_{maptype}_path"])
            img = center_crop(img, self.cfg.data.db_cropsize)
            img = resize(img, self.cfg.data.db_resize)
            if self.is_train_transform and self.cfg.data.db_jitter > 0:
                d = self.cfg.data
                img = color_jitter(img, d.db_jitter,
                                   np.random.default_rng(),
                                   brightness=d.brightness,
                                   contrast=d.contrast,
                                   saturation=d.saturation,
                                   hue_strength=d.hue)
            maps.append(normalize(img, self.cfg.data.norm_mean,
                                  self.cfg.data.norm_std))
        return np.stack(maps)
