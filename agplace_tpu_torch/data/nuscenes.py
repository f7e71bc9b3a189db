"""nuScenes-AG dataset (``agplace_tpu/data/nuscenes.py``).

The index: v1.0-trainval (train) / v1.0-test (test) over 4 locations, a
per-city UTM anchor plus the ego-pose offset (Boston's rotated 1.5 degrees
clockwise), aerial tiles from ``aerial_{version}_{location}_1_20_320_
{maptype}`` dirs.  The nuscenes-devkit is imported only in ``build_index``,
which writes what the readers need to a JSON index in ``dataroot``; every
later run reads that file.

The items: the surround cameras of ``camnames`` from the pre-resized
``_size256`` dirs, short side ``nuscenes_cam_resize``, ImageNet
normalisation, concatenated along the width into a panorama [h, w*ncam,
3]; LiDAR from the pre-voxelised ``.npy`` (``LIDAR_TOP_voxel1``), NaN-padded.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.data.base import PlaceDataset
from agplace_tpu_torch.data.geo import from_latlon
from agplace_tpu_torch.data.transforms import load_image_rgb, normalize, resize
from agplace_tpu_torch.retrieval.knn import radius_neighbors

LOCATIONS = [
    "singapore-onenorth",
    "singapore-hollandvillage",
    "singapore-queenstown",
    "boston-seaport",
]

# per-city UTM anchor latlon (datasets_ws_nuscenes.py:494-506)
_ANCHORS = {
    "boston-seaport": (42.336849169438615, -71.05785369873047),
    "singapore-onenorth": (1.2882100868743724, 103.78475189208984),
    "singapore-hollandvillage": (1.2993652317780957, 103.78217697143555),
    "singapore-queenstown": (1.2782562240223188, 103.76741409301758),
}

_CAM_OF = {
    "f": "CAM_FRONT", "fl": "CAM_FRONT_LEFT", "fr": "CAM_FRONT_RIGHT",
    "b": "CAM_BACK", "bl": "CAM_BACK_LEFT", "br": "CAM_BACK_RIGHT",
}

_AERIAL_FMT = "aerial_{version}_{location}_1_20_320_{maptype}"


def ego_to_utm(location: str, ego_xy: np.ndarray) -> np.ndarray:
    """Ego translation -> UTM east/north (``:489-522``).  Boston poses are
    rotated 1.5° clockwise before the anchor offset."""
    xy = np.asarray(ego_xy, np.float64).copy()
    if location == "boston-seaport":
        deg = 1.5
        r = np.array([
            [np.cos(np.pi / 180 * deg), -np.sin(np.pi / 180 * deg)],
            [np.sin(np.pi / 180 * deg), np.cos(np.pi / 180 * deg)],
        ])
        xy = xy @ r
    east0, north0, _, _ = from_latlon(*_ANCHORS[location])
    return xy + np.array([float(east0), float(north0)])


def build_index(dataroot: str, split: str, traindownsample: int = 4,
                out_path: Optional[str] = None) -> Dict:
    """One-time devkit pass -> JSON index (queries with per-sensor file
    paths + UTM; requires nuscenes-devkit, which is NOT needed afterwards).
    """
    from nuscenes.nuscenes import NuScenes  # devkit only here

    version = "v1.0-trainval" if split == "train" else "v1.0-test"
    nusc = NuScenes(version=version, dataroot=dataroot, verbose=False)
    queries = []
    for isample, sample in enumerate(nusc.sample):
        if split == "train" and isample % traindownsample != 0:
            continue
        scene = nusc.get("scene", sample["scene_token"])
        location = nusc.get("log", scene["log_token"])["location"]
        if location not in LOCATIONS:
            continue
        ego = nusc.get("ego_pose", sample["data"]["LIDAR_TOP"])
        east, north = ego_to_utm(location, np.array(ego["translation"][:2]))
        paths = {}
        for sensor in ["LIDAR_TOP"] + list(_CAM_OF.values()):
            data = nusc.get("sample_data", sample["data"][sensor])
            paths[sensor] = data["filename"]
        queries.append({
            "token": sample["token"], "prev": sample["prev"],
            "next": sample["next"], "location": location,
            "east": float(east), "north": float(north), "paths": paths,
        })
    index = {"version": version, "split": split, "queries": queries}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(index, f)
    return index


def get_seq_sample_tokens(queries_by_token: Dict[str, Dict], token: str,
                          seq_len: int, current_frame_type: str = "new"
                          ) -> List[str]:
    """Temporal sample-token chains (``datasets_ws_nuscenes.py:650-724``):
    'new' = the token is the newest frame (walk prev), 'old' = oldest (walk
    next), 'mid' = centred.  Chains saturate at scene boundaries, exactly as
    the reference (empty prev/next repeats the current token)."""

    def step(tok: str, key: str) -> str:
        nxt = queries_by_token.get(tok, {}).get(key, "")
        return nxt if nxt and nxt in queries_by_token else tok

    if current_frame_type == "new":
        out = [token]
        for _ in range(seq_len - 1):
            out.insert(0, step(out[0], "prev"))
        return out
    if current_frame_type == "old":
        out = [token]
        for _ in range(seq_len - 1):
            out.append(step(out[-1], "next"))
        return out
    if current_frame_type == "mid":
        out = [token]
        for _ in range(seq_len // 2):
            out.insert(0, step(out[0], "prev"))
        for _ in range(seq_len // 2):
            out.append(step(out[-1], "next"))
        return out
    raise NotImplementedError(current_frame_type)


class NuScenesDataset(PlaceDataset):
    def __init__(self, cfg: Config, split: str = "train",
                 index: Optional[Dict] = None):
        assert split in ("train", "test")
        self.cfg = cfg
        self.split = split
        dataroot = cfg.data.dataroot
        version = "v1.0-trainval" if split == "train" else "v1.0-test"
        log = logging.getLogger("nuscenes")

        if index is None:
            cached = os.path.join(dataroot,
                                  f"agplace_index_{version}_{split}.json")
            if os.path.exists(cached):
                with open(cached) as f:
                    index = json.load(f)
            else:
                index = build_index(dataroot, split,
                                    cfg.data.traindownsample, cached)
        self.queries_infos = index["queries"]
        self.q_eastnorth = np.array(
            [[q["east"], q["north"]] for q in self.queries_infos],
            np.float64).reshape(-1, 2)

        self.database_infos: List[Dict] = []
        db_utms = []
        for location in LOCATIONS:
            sat_dir = os.path.join(dataroot, _AERIAL_FMT.format(
                version=version, location=location, maptype="satellite"))
            if not os.path.isdir(sat_dir):
                continue
            names = sorted(os.listdir(sat_dir))
            for i, name in enumerate(names):
                if split == "train" and i % cfg.data.traindownsample != 0:
                    continue
                parts = name.rsplit(".", 1)[0].split("@")
                east, north = float(parts[1]), float(parts[2])
                info = {"east": east, "north": north, "location": location}
                for maptype in cfg.data.maptype:
                    info[f"db_{maptype}_path"] = os.path.join(
                        dataroot, _AERIAL_FMT.format(
                            version=version, location=location,
                            maptype=maptype), name)
                self.database_infos.append(info)
                db_utms.append([east, north])
        self.db_eastnorth = np.asarray(db_utms, np.float64).reshape(-1, 2)

        self.database_num = len(self.database_infos)
        self.queries_num = len(self.queries_infos)
        log.info("nuscenes %s: %d queries, %d db tiles", split,
                 self.queries_num, self.database_num)
        self.soft_positives_per_query = radius_neighbors(
            self.q_eastnorth, self.db_eastnorth,
            cfg.data.val_positive_dist_threshold)
        self.hard_positives_per_query = radius_neighbors(
            self.q_eastnorth, self.db_eastnorth,
            cfg.data.train_positives_dist_threshold)

    # item loaders ---------------------------------------------------------
    def _resized_cam_path(self, rel: str) -> str:
        parts = rel.split("/")
        parts[-2] += "_size256"  # pre-resized dirs (:607)
        return os.path.join(self.cfg.data.dataroot, "/".join(parts))

    def load_query_image(self, idx: int) -> np.ndarray:
        """Width-concatenated panorama over ``camnames`` (:634)."""
        info = self.queries_infos[idx]
        cams = []
        for cam in self.cfg.data.camnames:
            path = self._resized_cam_path(info["paths"][_CAM_OF[cam]])
            img = load_image_rgb(path)
            img = resize(img, self.cfg.data.nuscenes_cam_resize)
            cams.append(normalize(img, self.cfg.data.norm_mean,
                                  self.cfg.data.norm_std))
        return np.concatenate(cams, axis=1)  # [h, w*ncam, 3]

    def load_query_points(self, idx: int) -> np.ndarray:
        rel = self.queries_infos[idx]["paths"]["LIDAR_TOP"]
        rel = rel.replace(".pcd.bin", ".npy")
        parts = rel.split("/")
        parts[-2] += "_voxel1"  # pre-voxelised (:565-568)
        path = os.path.join(self.cfg.data.dataroot, "/".join(parts))
        pc = np.load(path, allow_pickle=True).astype(np.float32)
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
            # nuScenes db: resize to (256, 256), ImageNet stats, no crop
            # (datasets_ws_nuscenes.py:284-307)
            img = resize(img, (self.cfg.data.db_resize,
                               self.cfg.data.db_resize))
            maps.append(normalize(img, self.cfg.data.norm_mean,
                                  self.cfg.data.norm_std))
        return np.stack(maps)
