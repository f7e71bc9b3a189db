"""Training entry point (the JAX package's ``train.py``):

    python -m agplace_tpu_torch.train --dataset kitti360 --dataroot D
    python -m agplace_tpu_torch.train --dataset nuscenes --dataroot D \\
        --camnames fl_f_fr_bl_b_br
    python -m agplace_tpu_torch.train --dataset synthetic --device cpu \\
        --q_resize 32 --train_batch_size 2 --negs_num_per_query 2
    python -m agplace_tpu_torch.train --dataset kitti360 --dataroot D \\
        --modelq geoloc --modeldb geoloc --backbone resnet50conv4 \\
        --aggregation netvlad

It takes the JAX package's flags (``config.FLAG_TABLE``) for the fields
the training path and the readers read (``HONOURED``); any other flag of
that table raises.  ``--device`` picks the device: the card by default,
which raises "no CUDA device" without one.  ``build_datasets`` is also the
dataset front of ``python -m agplace_tpu_torch.test`` and ``.serve``.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from agplace_tpu_torch.config import Config, parse_arguments

HONOURED = frozenset("""
dataset dataroot camnames traindownsample train_ratio db_cropsize db_resize
q_jitter db_jitter brightness contrast saturation hue norm_mean norm_std
nuscenes_cam_resize val_positive_dist_threshold
train_positives_dist_threshold q_resize maptype quant_size vox_max_points pc_rot_aug_deg num_workers
modelq modeldb features_dim backbone aggregation netvlad_clusters
fc_output_dim l2 trunc_te freeze_te share_qdb compute_dtype pretrained
pretrained_path
mm_imgfe mm_imgfe_layers mm_imgfe_planes mm_imgfe_dim mm_voxfe_layers
mm_voxfe_planes mm_voxfe_ntd mm_voxfe_dim mm_voxfe_block voxfe_backend
bev_pallas bev_pallas_head bev_fused_down stem_pallas dbstem_pallas
vox_grid_extent stg2fuse_dim output_type output_l2 final_type
final_fusetype final_l2 image_weight image_learnweight vox_weight
vox_learnweight shallow_weight shallow_learnweight imagevoxorg_weight
imagevoxorg_learnweight shalloworg_weight shalloworg_learnweight
stg2imagevox_weight stg2imagevox_learnweight stg2fuse_weight
stg2fuse_learnweight stg2nlayers stg2fuse_type stg2_useproj drop
dbimage_fe dbimage_fe_layers share_dbfe
diff_type diff_direction odeint_method odeint_size use_pallas
epochs_num train_batch_size infer_batch_size queries_per_epoch
cache_refresh_rate neg_samples_num negs_num_per_query mining optim lr lrpc
lrdb lr_crn_layer lr_crn_net seed train_modelq train_modeldb save_dir
resume checkpoint_after_epoch profile_steps
criterion margin tripletloss_weight otherloss_type otherloss_weight
recall_values test_method majority_weight pca_dim
data_parallel gallery_parallel exp_name
""".split())


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
        argv, HONOURED, extra=lambda p: p.add_argument(
            "--device", default="cuda",
            help="cuda (default) or cpu"))
    from agplace_tpu_torch.device import resolve_device
    from agplace_tpu_torch.train.loop import train
    from agplace_tpu_torch.utils.common import ResultsLogger, setup_logging

    device = resolve_device(args.device)
    train_ds, test_ds = build_datasets(cfg)
    setup_logging(cfg.train.save_dir)
    log = logging.getLogger("main")
    log.info("config: %s", cfg)
    results = ResultsLogger(cfg.exp_name, f"{cfg.train.save_dir}/results")
    log.info("train: %d queries / %d tiles; test: %d queries / %d tiles",
             train_ds.queries_num, train_ds.database_num,
             test_ds.queries_num, test_ds.database_num)
    out = train(cfg, train_ds, test_ds, results_logger=results,
                device=device)
    best = out["best"]
    log.info("Best: R@1 = %.1f   R@5 = %.1f   R@10 = %.1f   epoch = %d",
             best[0], best[1], best[2], best[3])
    results.info(f"Best: R@1={best[0]:.1f} R@5={best[1]:.1f} "
                 f"R@10={best[2]:.1f} epoch={best[3]}")
    results.end()
    return out
