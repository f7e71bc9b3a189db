"""Host input prep for the query tower — numpy twins of the JAX package's
collate-side voxel code, returning torch tensors on the caller's device.

* ``batched_from_pointclouds``   <- ``agplace_tpu/sparse/voxels.py:284-321``
* ``me_down_align``              <- ``agplace_tpu/sparse/voxels.py:234-247``
* ``rasterize_from_voxels_host`` <- ``agplace_tpu/sparse/bev_grid.py:73-100``
* ``prepare_query_vox``          <- ``agplace_tpu/data/base.py:101-118``

All the work is on the host: the port's native voxelizer
(``agplace_tpu_torch/native``, ``voxelize_plain`` is its numpy plain
version) and one fancy-index write for the raster; only the finished arrays
cross to the device, which is the card unless the caller passes ``"cpu"``.
Outputs are exactly equal to the JAX package's (tested in
``tests/test_torch_port_slice.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from agplace_tpu_torch import native
from agplace_tpu_torch.config import Config
from agplace_tpu_torch.device import resolve_device

GRID_RADIUS = 64  # static half-extent of the occupancy grid, in voxels


@dataclass
class SparseVoxels:
    """Padded voxel set: coords [B, N, 3] int32, feats [B, N, C], mask
    [B, N] bool, and the tensor stride (JAX's ``SparseVoxels``; the device
    geometry is ``sparse/voxels.py``)."""

    coords: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor
    stride: int = 1

    @property
    def capacity(self) -> int:
        return self.coords.shape[1]

    @property
    def channels(self) -> int:
        return self.feats.shape[-1]

    def replace(self, **kw) -> "SparseVoxels":
        return dataclasses.replace(self, **kw)


def me_down_align(cells: int) -> Tuple[int, int, int]:
    """(lo, hi, out_cells) for a k=2 s=2 downsample of a dense dim under
    MinkowskiEngine floor semantics: ME parents pair cells (2m - lo,
    2m + 1 - lo) with lo = (cells // 2) % 2, so a plain stride-2 conv needs
    ``lo`` cells of low padding and ``hi`` of high padding."""
    lo = (cells // 2) % 2
    hi = (cells + lo) % 2
    return lo, hi, (cells + lo + hi) // 2


def voxelize_plain(points: np.ndarray, quant_size: float, capacity: int):
    """The voxelizer's plain numpy version (the tests hold the native one to
    it): per cloud the lexicographically smallest ``capacity`` unique
    voxel coordinates, ascending, clamped to the grid."""
    pts = np.asarray(points, dtype=np.float32)
    b = pts.shape[0]
    finite = np.all(np.isfinite(pts), axis=-1)
    coords_all = np.floor(np.nan_to_num(pts) / quant_size).astype(np.int32)
    np.clip(coords_all, -GRID_RADIUS + 1, GRID_RADIUS - 1, out=coords_all)
    out_coords = np.zeros((b, capacity, 3), np.int32)
    out_mask = np.zeros((b, capacity), bool)
    for i in range(b):
        c = coords_all[i][finite[i]]
        if len(c):
            uniq = np.unique(c, axis=0)
            k = min(len(uniq), capacity)
            out_coords[i, :k] = uniq[:k]
            out_mask[i, :k] = True
    return out_coords, out_mask


def _voxelize(points: np.ndarray, quant_size: float, capacity: int):
    return native.voxelize_batch(points, quant_size, capacity, GRID_RADIUS)


def batched_from_pointclouds(points: np.ndarray, quant_size: float,
                             capacity: int, device=None) -> SparseVoxels:
    """Metric point clouds [B, P, 3] (NaN-padded) -> quantised, padded
    ``SparseVoxels`` with constant-1 features."""
    coords, mask = _voxelize(points, quant_size, capacity)
    feats = mask[..., None].astype(np.float32)
    return SparseVoxels(coords=torch.from_numpy(coords).to(device),
                        feats=torch.from_numpy(feats).to(device),
                        mask=torch.from_numpy(mask).to(device), stride=1)


def _raster_np(coords: np.ndarray, m: np.ndarray, stride: int,
               extent: Tuple[int, int, int]) -> np.ndarray:
    x, y, z = extent
    b = coords.shape[0]
    c = coords // max(stride, 1)
    ii = np.clip(c[..., 0] + x // 2, 0, x - 1)
    jj = np.clip(c[..., 1] + y // 2, 0, y - 1)
    kk = np.clip(c[..., 2] + z // 2, 0, z - 1)
    bidx = np.broadcast_to(np.arange(b)[:, None], m.shape)
    mask = np.zeros((b, x, y, z), bool)
    mask[bidx[m], ii[m], jj[m], kk[m]] = True
    return mask


def rasterize_from_voxels_host(sv: SparseVoxels,
                               extent: Tuple[int, int, int],
                               dtype: Optional[torch.dtype] = None,
                               device=None):
    """Occupancy raster of ``sv`` as a folded ``BEVGrid`` (feats [B,X,Y,Z]
    = the constant-1 voxel features at C=1, mask [B,X,Y,Z] bool)."""
    mask = _raster_np(sv.coords.cpu().numpy(), sv.mask.cpu().numpy(),
                      sv.stride, extent)
    return _grid(mask, sv.stride, dtype, device)


def _grid(mask: np.ndarray, stride: int, dtype, device):
    from agplace_tpu_torch.sparse.bev_grid import BEVGrid

    m = torch.from_numpy(mask).to(device)
    return BEVGrid(feats=m.to(dtype or torch.float32), mask=m,
                   z=mask.shape[-1], stride=stride)


def prepare_query_vox(cfg: Config, pts: np.ndarray, device="cuda",
                      dtype: Optional[torch.dtype] = None):
    """Point clouds [B, P, 3] -> the query tower's voxel input, built on the
    host and moved to ``device`` (the card; ``"cpu"`` keeps it on the host,
    and without a card anything else raises).  The live MM + BEV
    configuration gets the folded occupancy grid (``BEVGrid``); every other
    configuration the padded ``SparseVoxels``."""
    device = resolve_device(device)
    m = cfg.model
    if not (m.modelq == "mm" and m.mm.voxfe_backend == "bev"
            and "vox" in m.mm.output_type):
        return batched_from_pointclouds(pts, cfg.data.quant_size,
                                        cfg.data.vox_max_points, device)
    coords, mask = _voxelize(pts, cfg.data.quant_size,
                             cfg.data.vox_max_points)
    return _grid(_raster_np(coords, mask, 1, m.mm.vox_grid_extent), 1,
                 dtype, device)
