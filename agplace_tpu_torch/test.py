"""Evaluation entry point (the JAX package's ``test.py``):

    python -m agplace_tpu_torch.test --dataset kitti360 --dataroot D \\
        --resume best_model
    python -m agplace_tpu_torch.test --dataset synthetic --device cpu

It restores both towers of a checkpoint of ``python -m
agplace_tpu_torch.train`` (``--resume``: a name in ``--save_dir``, or a
path), runs ``evaluate`` on the test split and prints its Recall@N line.
Random-init weights are evaluated only on the synthetic world.  It takes
the training entry point's flags (every flag of ``config.FLAG_TABLE``);
``--device`` picks the device: the card by default, which raises "no CUDA
device" without one.  Under torchrun (one process per card) the embed
passes run data-parallel and the search gallery-sharded, the meshes
resolved from ``--data_parallel`` / ``--gallery_parallel`` as in JAX's
``test.py``; launched alone, both resolve to single-device.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from agplace_tpu_torch.config import parse_arguments
from agplace_tpu_torch.device import resolve_device
from agplace_tpu_torch.evaluate import evaluate
from agplace_tpu_torch.infer import build_towers, make_infer_fns
from agplace_tpu_torch.parallel.bootstrap import (initialize_distributed,
                                                  rank_device)
from agplace_tpu_torch.parallel.mesh import resolve_meshes
from agplace_tpu_torch.train.checkpoint import load_towers
from agplace_tpu_torch.train.cli import build_datasets
from agplace_tpu_torch.train.step import check_supported
from agplace_tpu_torch.utils.common import setup_logging


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    cfg, args = parse_arguments(
        argv, extra=lambda p: p.add_argument(
            "--device", default="cuda", help="cuda (default) or cpu"))
    initialize_distributed(device=args.device)
    device = resolve_device(rank_device(args.device))
    check_supported(cfg)
    setup_logging(cfg.train.save_dir)
    log = logging.getLogger("test")
    _, test_ds = build_datasets(cfg)

    if cfg.train.resume:
        towers, epoch = load_towers(cfg, cfg.train.save_dir,
                                    cfg.train.resume, device)
        log.info("restored %s (epoch %d)", cfg.train.resume, epoch)
    elif cfg.data.dataset != "synthetic":
        # random-init weights on a real dataset give recalls that look
        # legitimate; only the synthetic smoke run may evaluate them
        raise SystemExit(
            "test.py needs --resume <checkpoint-name> (random-init eval "
            "is only allowed with --dataset synthetic)")
    else:
        towers = build_towers(cfg, device,
                              torch.Generator().manual_seed(cfg.train.seed))

    mesh, gallery_mesh = resolve_meshes(
        cfg.mesh, (cfg.train.train_batch_size, cfg.train.infer_batch_size),
        log)
    recalls, recalls_str = evaluate(cfg, test_ds, *make_infer_fns(*towers),
                                    device=device, mesh=mesh,
                                    gallery_mesh=gallery_mesh)
    log.info("Recalls on %s: %s", cfg.data.dataset, recalls_str)
    print(recalls_str)
    return recalls


if __name__ == "__main__":
    main()
