"""Training entry point (the JAX package's ``train.py``):

    python -m agplace_tpu_torch.train --dataset kitti360 --dataroot D
    python -m agplace_tpu_torch.train --dataset nuscenes --dataroot D \\
        --camnames fl_f_fr_bl_b_br
    python -m agplace_tpu_torch.train --dataset synthetic --device cpu \\
        --q_resize 32 --train_batch_size 2 --negs_num_per_query 2
    python -m agplace_tpu_torch.train --dataset kitti360 --dataroot D \\
        --modelq geoloc --modeldb geoloc --backbone resnet50conv4 \\
        --aggregation netvlad

    torchrun --nproc_per_node 4 -m agplace_tpu_torch.train \\
        --dataset kitti360 --dataroot D --data_parallel -1

It takes every flag of the JAX package's table (``config.FLAG_TABLE``),
as JAX's ``train.py``, ``test.py`` and ``serve.py`` do, and so do ``test``
and ``serve``.  ``--device`` picks the device: the card by default, which
raises "no CUDA device" without one.  Under torchrun each process is one
rank on its card (``cuda:LOCAL_RANK``; ``parallel/bootstrap.py``) and
``--data_parallel`` / ``--gallery_parallel`` resolve over the ranks as
JAX's over its devices (``parallel/mesh.py``); only rank 0 writes the
logs, the results, the metrics and the checkpoints.  Launched alone, the
world is one rank and both flags resolve to single-device.
``build_datasets`` is also the dataset front of ``python -m
agplace_tpu_torch.test`` and ``.serve``.

Each flag lands in the ``cfg`` field JAX's does.  Where JAX reads the
fields of the flags its entry points once refused here (JAX file:line),
and where the port reads them:

* ``odeint_rtol`` / ``odeint_atol`` / ``dopri5_max_steps``
  (``model.mm.ode.*``): ``agplace_tpu/models/fusion.py:77-78`` (FCODE)
  and ``:421-422`` (``BeltramiODE``); the port's ``models/fusion.py``
  FCODE and ``BeltramiODE`` pass them to dopri5 likewise.
* ``horizontal_flip`` / ``rand_perspective`` / ``random_resized_crop`` /
  ``random_rotation`` (``data.*``): ``data/folder_dataset.py:76-78`` and
  ``data/transforms.py:195-204`` (``random_query_augment``), on a folder
  dataset's training queries; the port's ``data/folder_dataset.py`` and
  ``data/transforms.py`` likewise.  No dataset of the entry points
  (kitti360, nuscenes, synthetic) reads them, in either package.
* ``read_pc`` / ``sph_size``: only the experiment name
  (``agplace_tpu/config.py:680``, the port's ``config.build_exp_name``).
* Read by no JAX module, carried in ``cfg`` only, here too:
  ``color_jitter`` (``data.color_jitter``; the readers jitter by
  ``q_jitter`` / ``db_jitter``), ``sph_jit``, ``bev_jit``, ``stg2gnn``
  and ``beltrami_k`` (JAX builds ``QKVAttention`` / ``BeltramiODE`` only
  when a caller does; no config field selects them), ``stg2_type``,
  ``sdeint_method`` / ``sdeint_size`` / ``cdeint_method`` /
  ``cdeint_size`` (``ode/sde.py`` takes its method and step from its
  caller), ``patience`` and ``checkpoint_every_epochs`` (JAX's loop
  counts ``not_improved_num`` and saves by ``checkpoint_after_epoch``),
  ``infonceloss_weight`` and ``mm_lossweight`` (the train step adds
  neither loss).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from agplace_tpu_torch.config import Config, parse_arguments


def build_datasets(cfg: Config):
    """(train, test) datasets of ``cfg.data.dataset``: the KITTI-360-AG or
    nuScenes-AG readers over ``cfg.data.dataroot``, or the synthetic world
    of the JAX entry point (64 tiles; 64 training and 32 test queries)."""
    if cfg.data.dataset == "kitti360":
        from agplace_tpu_torch.data.kitti360 import KITTI360Dataset

        return KITTI360Dataset(cfg, "train"), KITTI360Dataset(cfg, "test")
    if cfg.data.dataset == "nuscenes":
        from agplace_tpu_torch.data.nuscenes import NuScenesDataset

        return NuScenesDataset(cfg, "train"), NuScenesDataset(cfg, "test")
    if cfg.data.dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {cfg.data.dataset!r}: the port reads kitti360, "
            f"nuscenes and synthetic")
    from agplace_tpu_torch.data.synthetic import SyntheticDataset

    kw = dict(n_db=64, image_size=cfg.data.q_resize, nmap=cfg.data.nmap)
    return (SyntheticDataset(n_q=64, seed=cfg.train.seed, **kw),
            SyntheticDataset(n_q=32, seed=cfg.train.seed + 1, **kw))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    cfg, args = parse_arguments(
        argv, extra=lambda p: p.add_argument(
            "--device", default="cuda",
            help="cuda (default) or cpu"))
    from agplace_tpu_torch.device import resolve_device
    from agplace_tpu_torch.parallel.bootstrap import (initialize_distributed,
                                                      rank_device)
    from agplace_tpu_torch.parallel.mesh import rank
    from agplace_tpu_torch.train.loop import train
    from agplace_tpu_torch.utils.common import ResultsLogger, setup_logging

    initialize_distributed(device=args.device)
    device = resolve_device(rank_device(args.device))
    train_ds, test_ds = build_datasets(cfg)
    main_rank = rank() == 0
    if main_rank:
        setup_logging(cfg.train.save_dir)
    log = logging.getLogger("main")
    log.info("config: %s", cfg)
    results = (ResultsLogger(cfg.exp_name, f"{cfg.train.save_dir}/results")
               if main_rank else None)
    log.info("train: %d queries / %d tiles; test: %d queries / %d tiles",
             train_ds.queries_num, train_ds.database_num,
             test_ds.queries_num, test_ds.database_num)
    out = train(cfg, train_ds, test_ds, results_logger=results,
                device=device)
    best = out["best"]
    log.info("Best: R@1 = %.1f   R@5 = %.1f   R@10 = %.1f   epoch = %d",
             best[0], best[1], best[2], best[3])
    if main_rank:
        results.info(f"Best: R@1={best[0]:.1f} R@5={best[1]:.1f} "
                     f"R@10={best[2]:.1f} epoch={best[3]}")
        results.end()
    return out
