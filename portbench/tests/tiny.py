"""Tiny CPU versions of the cells: the program's plain versions (no card),
small grids and images, a short window."""

from __future__ import annotations

import argparse

from portbench.harness import cell as cells

TINY_CONFIG = {"model.mm.vox_grid_extent": [16, 16, 4],
               "data.vox_max_points": 256,
               "train.train_batch_size": 2,
               "train.negs_num_per_query": 2}
# the comparison's limits at the tiny size, from its own readings on the
# CPU (program / control): descriptors 0.0136-0.0140 / 0.098-0.106; train
# loss 2.6e-4 / 2.2e-4 (half the batch: 0.139), first gradient 0.002 /
# 0.045, the median leaf's change 1.4e-4 / 2.6e-3 (a state left unchanged:
# 0.96).  A tiny grid averages fewer cells, so its gaps read wider than the
# card's at the cells' sizes.
TINY_LIMITS = {"embed": {"desc_rel_err": 0.04},
               "train": {"loss_gap": 0.01, "grad_gap": 0.02,
                         "grad_gap_nonvox": 0.02, "step_gap_median": 0.02}}
TINY_PARAMS = {"batch": 2, "pool": 2, "image_hw": [64, 96],
               "tile_hw": [64, 64], "points": 2000, "check_rows": 3,
               "profile_units": 1, "area_m": 60.0}


def args(workload: str, seed: int = 3, seconds: float = 0.2,
         trace: int = 0):
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)


def tiny_cell(name: str):
    cell = cells.load(name)
    cell.traffic["params"].update(
        {k: v for k, v in TINY_PARAMS.items()
         if k in cell.params or k in ("batch",)})
    if cell.params.get("tower") == "aerial":
        cell.traffic["params"]["image_hw"] = [64, 64]
    cell.limits = dict(TINY_LIMITS[cell.mix])
    return cell
