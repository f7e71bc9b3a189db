"""Device geometry of padded sparse-voxel sets (``agplace_tpu/sparse/
voxels.py``), the MinkowskiEngine replacement: dedup, downsampling and
neighbour lookup on packed int32 keys, all at static shapes.

``SparseVoxels`` itself and the host collate (voxelizer, ``me_down_align``)
live in ``data/voxels.py``.  Keys pack three 10-bit coordinate fields
(|coord| < 512) into one int32; masked rows get ``INVALID_KEY``, which
sorts after every valid key.

``jnp.unique(size=capacity, fill_value=INVALID_KEY)`` has no torch
counterpart (``torch.unique``'s length depends on the data, a host sync),
so ``unique_keys`` is a stable sort, a first-occurrence flag, a cumsum and a
scatter into a static-capacity buffer padded with ``INVALID_KEY``: keys
ascending, truncated at the capacity, as JAX's.  Nothing here reads a value
back to the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from agplace_tpu_torch.data.voxels import GRID_RADIUS, SparseVoxels

COORD_BOUND = 512  # per-axis coordinate bound after quantisation
_SHIFT = 10  # bits per axis
INVALID_KEY = 2 ** 30 - 1  # sorts after every valid key


def pack_coords(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[..., 3] int32 -> packed int32 key (lexicographic order preserved);
    masked-out rows -> INVALID_KEY."""
    s = coords.to(torch.int32) + COORD_BOUND
    key = (s[..., 0] << (2 * _SHIFT)) | (s[..., 1] << _SHIFT) | s[..., 2]
    return torch.where(mask, key, INVALID_KEY).to(torch.int32)


def unpack_coords(keys: torch.Tensor) -> torch.Tensor:
    lim = 2 ** _SHIFT - 1
    return torch.stack([(keys >> (2 * _SHIFT)) & lim, (keys >> _SHIFT) & lim,
                        keys & lim], dim=-1) - COORD_BOUND


def unique_keys(keys: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of ``keys`` [B, P]: its distinct values ascending in a
    [B, capacity] buffer padded (and truncated) as ``jnp.unique(k,
    size=capacity, fill_value=INVALID_KEY)``; and the mask of valid keys."""
    b = keys.shape[0]
    s, _ = torch.sort(keys, dim=1, stable=True)
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    pos = torch.cumsum(first, dim=1) - 1
    # repeats and what lies beyond the capacity all go to one dropped slot
    slot = torch.where(first & (pos < capacity), pos, capacity)
    out = torch.full((b, capacity + 1), INVALID_KEY, dtype=torch.int32,
                     device=keys.device)
    out.scatter_(1, slot, s.to(torch.int32))
    uniq = out[:, :capacity]
    return uniq, uniq != INVALID_KEY


def quantize(points: torch.Tensor, quant_size: float, capacity: int,
             mask: torch.Tensor = None) -> SparseVoxels:
    """``ME.sparse_quantize`` on the device: floor-divide metric points
    [B, P, 3] by ``quant_size``, clamp to the occupancy grid (+-63),
    deduplicate, pad to ``capacity``; constant-1 features."""
    b, p, _ = points.shape
    coords = torch.floor(points / quant_size).to(torch.int32)
    coords = torch.clamp(coords, -GRID_RADIUS + 1, GRID_RADIUS - 1)
    if mask is None:
        mask = torch.ones((b, p), dtype=torch.bool, device=points.device)
    uniq, out_mask = unique_keys(pack_coords(coords, mask), capacity)
    out_coords = torch.where(out_mask[..., None], unpack_coords(uniq), 0)
    return SparseVoxels(coords=out_coords.to(torch.int32),
                        feats=out_mask[..., None].float(), mask=out_mask,
                        stride=1)


def kernel_offsets(kernel_size: int, stride_units: int,
                   device=None) -> torch.Tensor:
    """ME kernel offsets of a cubic kernel in coordinate units of the input
    stride, int32 [k^3, 3]: odd k centred {-(k//2) .. k//2}, even k
    forward {0 .. k-1}.  Built on ``device`` by kernels (no host copy)."""
    if kernel_size % 2 == 1:
        r = torch.arange(-(kernel_size // 2), kernel_size // 2 + 1,
                         device=device)
    else:
        r = torch.arange(0, kernel_size, device=device)
    grid = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1)
    return (grid.reshape(-1, 3) * stride_units).to(torch.int32)


def sort_by_key(sv: SparseVoxels) -> Tuple[SparseVoxels, torch.Tensor]:
    """Rows sorted by packed key (padding last, stable); returns the sorted
    set and its keys [B, N]."""
    keys = pack_coords(sv.coords, sv.mask)
    keys_s, order = torch.sort(keys, dim=-1, stable=True)
    coords_s = torch.gather(sv.coords, 1, order[..., None].expand(-1, -1, 3))
    feats_s = torch.gather(sv.feats, 1, order[..., None].expand(
        -1, -1, sv.feats.shape[-1]))
    return (SparseVoxels(coords=coords_s, feats=feats_s,
                         mask=keys_s != INVALID_KEY, stride=sv.stride),
            keys_s)


def lookup(sorted_keys: torch.Tensor, query_keys: torch.Tensor
           ) -> torch.Tensor:
    """Row of each query key in ``sorted_keys`` [B, N] by binary search, or
    -1 where absent -> int32 [B, M]."""
    pos = torch.searchsorted(sorted_keys.contiguous(),
                             query_keys.contiguous())
    pos = torch.clamp(pos, 0, sorted_keys.shape[1] - 1)
    hit = torch.gather(sorted_keys, 1, pos) == query_keys
    return torch.where(hit & (query_keys != INVALID_KEY), pos,
                       -1).to(torch.int32)


def _flat_cell(coords: torch.Tensor, radius: int) -> torch.Tensor:
    d = 2 * radius
    s = torch.clamp(coords + radius, 0, d - 1).to(torch.int64)
    return (s[..., 0] * d + s[..., 1]) * d + s[..., 2]


def _in_grid(coords: torch.Tensor, valid: torch.Tensor, radius: int):
    return valid & (coords.abs() < radius).all(dim=-1)


def build_point_grid(coords: torch.Tensor, mask: torch.Tensor,
                     radius: int = GRID_RADIUS) -> torch.Tensor:
    """Per-sample occupancy grid: grid[b, flat(c)] = row of the point at
    coordinate c, or -1 -> int32 [B, (2 radius)^3].  Rows that are masked
    or outside the grid all go to one extra slot, dropped after the
    scatter (the only slot where writes collide)."""
    d3 = (2 * radius) ** 3
    b, n, _ = coords.shape
    flat = torch.where(_in_grid(coords, mask, radius),
                       _flat_cell(coords, radius), d3)
    rows = torch.arange(n, dtype=torch.int32,
                        device=coords.device).expand(b, n)
    grid = torch.full((b, d3 + 1), -1, dtype=torch.int32,
                      device=coords.device)
    grid.scatter_(1, flat, rows)
    return grid[:, :d3]


def grid_lookup(grid: torch.Tensor, query_coords: torch.Tensor,
                query_valid: torch.Tensor, radius: int = GRID_RADIUS
                ) -> torch.Tensor:
    """Rows of the query coordinates [B, ..., 3] in the grid's point set
    (-1 where absent or invalid) -> int32 [B, ...]."""
    inb = _in_grid(query_coords, query_valid, radius)
    flat = torch.where(inb, _flat_cell(query_coords, radius), 0)
    got = torch.gather(grid, 1, flat.reshape(flat.shape[0], -1))
    return torch.where(inb, got.reshape(flat.shape), -1)


def build_neighbor_table(sv_sorted: SparseVoxels, sorted_keys: torch.Tensor,
                         out_coords: torch.Tensor, out_mask: torch.Tensor,
                         offsets) -> torch.Tensor:
    """Kernel map: for each output point and kernel offset the input row
    (or -1) -> int32 [B, N_out, K], by one occupancy-grid scatter and one
    gather.  ``offsets`` [K, 3] (``kernel_offsets`` on the coordinates'
    device, or anything ``torch.as_tensor`` takes, copied there).
    ``sorted_keys`` is unused (kept for JAX's signature)."""
    del sorted_keys
    grid = build_point_grid(sv_sorted.coords, sv_sorted.mask)
    off = torch.as_tensor(offsets).to(out_coords.device)
    nbr = out_coords[:, :, None, :] + off[None, None]  # [B, No, K, 3]
    valid = out_mask[:, :, None].expand(nbr.shape[:-1])
    return grid_lookup(grid, nbr, valid)


def downsample_coords(sv: SparseVoxels, factor: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Output coordinates of a stride-``factor`` conv: the distinct
    floor-aligned coarser coordinates (ME stride semantics), ascending, at
    the same capacity -> (coords [B, N, 3], mask [B, N])."""
    step = sv.stride * factor
    coarse = torch.div(sv.coords, step, rounding_mode="floor") * step
    uniq, out_mask = unique_keys(pack_coords(coarse, sv.mask), sv.capacity)
    out_coords = torch.where(out_mask[..., None], unpack_coords(uniq), 0)
    return out_coords.to(torch.int32), out_mask


def check_top_down(num_top_down: int, n_stages: int) -> None:
    """The FPNs build 0 <= num_top_down < n_stages top-down levels.  At
    num_top_down == n_stages JAX's three FPNs fail (their last level writes
    out_maps[-(n_stages + 1)], an IndexError), so the port refuses it."""
    if not 0 <= num_top_down < n_stages:
        raise NotImplementedError(
            f"num_top_down={num_top_down} with {n_stages} stages: the FPN "
            f"builds 0 .. {n_stages - 1} top-down levels (JAX's fails at "
            f"{n_stages})")


def masked_global_avg(sv: SparseVoxels) -> torch.Tensor:
    """``ME.MinkowskiGlobalAvgPooling``: per-sample mean over valid rows
    -> [B, C] in the feats dtype."""
    m = sv.mask[..., None].to(sv.feats.dtype)
    s = (sv.feats * m).sum(dim=1)
    n = torch.clamp(m.sum(dim=1), min=1.0)
    return s / n


def masked_global_max(sv: SparseVoxels) -> torch.Tensor:
    """``ME.MinkowskiGlobalMaxPooling``."""
    neg = torch.finfo(sv.feats.dtype).min
    return torch.where(sv.mask[..., None], sv.feats, neg).amax(dim=1)
