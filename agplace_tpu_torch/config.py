"""The port's configuration: a copy of the frozen dataclass tree and the
dataset presets of ``agplace_tpu/config.py`` (the JAX package's), so the
port reads no module of the JAX package.  Field names and defaults are the
JAX package's, field for field (``tests/test_torch_port_isolation.py``
holds the presets equal); comments that speak of the TPU describe the
reference's kernels, whose flags the port honours with its CUDA kernels.
The flag table of the JAX package's argparse front end is copied too
(``FLAG_TABLE``, held equal to JAX's by ``tests/test_torch_port_train_loop.
py``); ``parse_arguments`` takes every flag of it, as the JAX package's
entry points do.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _tuple_int(spec: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in spec.split("_"))


def _tuple_str(spec: str) -> Tuple[str, ...]:
    return tuple(spec.split("_"))


@dataclass(frozen=True)
class DataConfig:
    """Dataset / input-pipeline configuration.

    Mirrors reference flags in ``tools/options.py:19-72`` plus the fixed-shape
    padding knobs the TPU build needs (the reference used variable-size ME
    sparse tensors; we pad to ``vox_max_points``).
    """

    dataset: str = "kitti360"  # kitti360 | nuscenes | synthetic
    dataroot: str = ""
    maptype: Tuple[str, ...] = ("satellite",)  # satellite/roadmap/terrain/hybrid
    camnames: Tuple[str, ...] = ("00",)  # kitti360: 00|0203; nuscenes: fl_f_fr_bl_b_br
    traindownsample: int = 4
    train_ratio: float = 0.85

    # geometry thresholds (metres, UTM)
    val_positive_dist_threshold: float = 25.0  # soft positives (eval GT)
    train_positives_dist_threshold: float = 10.0  # hard positives (mining)

    # image sizes / transforms
    q_resize: int = 256
    db_cropsize: int = 256
    db_resize: int = 256
    q_jitter: float = 0.0
    db_jitter: float = 0.0
    color_jitter: float = 0.0
    # DVGLB-path torchvision aug flags (tools/options.py:230-233; the
    # reference ships them parse-only — transforms commented out at
    # datasets_ws.py:516-519 — implemented here with intended semantics)
    horizontal_flip: bool = False
    rand_perspective: float = 0.0
    random_resized_crop: float = 0.0
    random_rotation: float = 0.0
    # per-component jitter strengths (reference --brightness/--contrast/
    # --saturation/--hue feeding torchvision ColorJitter); None = use the
    # uniform q_jitter/db_jitter strength for that component
    brightness: Optional[float] = None
    contrast: Optional[float] = None
    saturation: Optional[float] = None
    hue: Optional[float] = None
    # per-dataset normalisation: kitti360 uses mean .5/std .22
    # (datasets_ws_kitti360.py:244), nuscenes uses ImageNet stats
    # (datasets_ws_nuscenes.py:293).
    norm_mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    norm_std: Tuple[float, float, float] = (0.22, 0.22, 0.22)
    nuscenes_cam_resize: int = 192  # datasets_ws_nuscenes.py:608

    # point-cloud voxelisation (reference: ME.sparse_quantize, quant_size=2)
    read_pc: bool = True
    quant_size: float = 2.0
    vox_max_points: int = 8192  # static padding capacity (TPU fixed shapes)
    pc_rot_aug_deg: float = 5.0  # collate-time +-5 deg z-rotation
    # (kitti360:120-126)

    # spherical / BEV projections (ALT paths, kitti360:286-353)
    sph_size: int = 32
    sph_jit: float = 0.2
    bev_jit: float = 0.2

    num_workers: int = 8

    @property
    def nmap(self) -> int:
        return len(self.maptype)

    @property
    def ncam(self) -> int:
        return len(self.camnames)


@dataclass(frozen=True)
class ODEConfig:
    """Neural-ODE integrator settings (reference: torchdiffeq odeint calls at
    ``network_mm/ffns.py:84`` with flags ``tools/options.py:130-138``)."""

    diff_type: str = "fcode@relu"  # '_'-separated blocks of kind@activation
    diff_direction: str = "backward"  # scale traversal order in stage-1 fusion
    method: str = "euler"  # euler | midpoint | rk4 | dopri5
    step_size: float = 0.1  # fixed-step integrators: 10 steps over t in [0,1]
    rtol: float = 1e-3
    atol: float = 1e-3
    dopri5_max_steps: int = 64  # static bound for the adaptive integrator
    use_pallas: bool = True  # fused VMEM-resident Euler chain on TPU
    # SDE / CDE solver knobs (reference --sdeint_*/--cdeint_*,
    # tools/options.py:134-137; consumed by ode/sde.py)
    sdeint_method: str = "euler_maruyama"
    sdeint_size: float = 0.1
    cdeint_method: str = "euler"
    cdeint_size: float = 0.1


@dataclass(frozen=True)
class MMConfig:
    """Ground/query tower (reference ``network_mm/mm.py:31`` + flags
    ``tools/options.py:100-156``)."""

    imgfe: str = "resnet18"
    imgfe_layers: Tuple[int, ...] = (2, 2, 2)
    imgfe_planes: Tuple[int, ...] = (64, 128, 256)
    imgfe_dim: int = 256
    voxfe_layers: Tuple[int, ...] = (1, 1, 1)
    voxfe_planes: Tuple[int, ...] = (64, 128, 256)
    voxfe_ntd: int = 0  # num_top_down in MinkFPN
    voxfe_dim: int = 256
    # FPN block type: eca (live default) | basic | aspp | convnext
    # (aspp/convnext are the models_minkloc variants, DEAD in the reference)
    voxfe_block: str = "eca"
    # voxel-branch execution backend (all three share one parameter tree and
    # are pairwise equivalence-tested):
    #   "bev"    = z folded into channels, plain NHWC 2D convs — fastest on
    #              TPU (sparse/bev_grid.py; avoids the measured 3D-conv
    #              epilogue pathology, ~3x over "dense" at bench shapes)
    #   "dense"  = masked dense-grid conv3d (sparse/dense_grid.py)
    #   "sparse" = padded gather-GEMM (clouds beyond the grid extent)
    voxfe_backend: str = "bev"
    # fused Pallas kernel for eval-mode ECA blocks on the BEV backend.
    # r4: routes to the SPATIAL-MAJOR kernel (ops/pallas/bev_block_sm.py),
    # whose boundary transposes are bitcasts against the conv-native
    # {3,0,2,1} layout — the relayout copies that made the r3 batch-major
    # kernel (ops/pallas/bev_block.py) in-context neutral are gone, and
    # the full-model A/B now measures +2.4% at batch 32.  Default ON
    # (eval-mode TPU only; AGPLACE_DISABLE_PALLAS=1 forces the XLA path).
    bev_pallas: bool = True
    # Fused conv0+down0 stage-pair kernel (ops/pallas/bev_head.py): the
    # full-resolution conv0 activation — the single biggest HBM cost of
    # the voxel branch (1.97 ms of the 3.4 ms branch at bench shapes,
    # BASELINE.md r3 stage profile) — never leaves VMEM.  Eval-mode TPU
    # only; the XLA path runs elsewhere and whenever the full-res map is
    # needed (training, num_top_down == n_stages).  Default OFF: hardware-
    # parity-proven but measured SLOWER in the full forward (A/B in
    # BASELINE.md r3 — the kernel serialises against the image branch
    # XLA otherwise overlaps).
    bev_pallas_head: bool = False
    # Fused stage-0 epilogue + masked down0 (ops/pallas/bev_down.py):
    # conv0 runs as four bare XLA parity convolutions (measured free) and
    # one streaming kernel applies BN+relu+mask+down0+BN+relu+mask —
    # removing the full-resolution mask pass XLA cannot fuse (536 MB of
    # traffic at bench shapes; r4 probe).  Unlike bev_pallas_head it has
    # no shared shift planes, so it does not serialise against the image
    # branch.  Eval-mode TPU only; default ON (identical math, parity-
    # tested; AGPLACE_DISABLE_PALLAS=1 forces the XLA path).
    bev_fused_down: bool = True
    # LiDAR clouds are flat: z extent 8 voxels (±8 m at quant 2) covers the
    # KITTI/nuScenes vertical range; xy ±128 m
    vox_grid_extent: Tuple[int, int, int] = (128, 128, 8)
    stg2fuse_dim: int = 256
    output_type: Tuple[str, ...] = ("image", "vox", "shallow")
    output_l2: bool = True
    final_type: Tuple[str, ...] = (
        "imageorg",
        "voxorg",
        "shalloworg",
        "stg2image",
        "stg2vox",
    )
    final_fusetype: str = "add"  # add | cat | catadd
    final_l2: bool = False

    # component weights (tools/options.py:121-146); *_learnweight toggles
    # whether the scalar is trained.
    image_weight: float = 1.0
    image_learnweight: bool = False
    vox_weight: float = 1.0
    vox_learnweight: bool = False
    shallow_weight: float = 1.0
    shallow_learnweight: bool = False
    imagevoxorg_weight: float = 0.0
    imagevoxorg_learnweight: bool = False
    shalloworg_weight: float = 1.0
    shalloworg_learnweight: bool = False
    stg2imagevox_weight: float = 0.1
    stg2imagevox_learnweight: bool = False
    stg2fuse_weight: float = 0.0
    stg2fuse_learnweight: bool = False

    ode: ODEConfig = field(default_factory=ODEConfig)

    # stage-2 fusion block (tools/options.py:148-155)
    stg2gnn: str = "qkv"  # qkv | beltrami (graph-ODE variants)
    beltrami_k: int = 16
    stg2nlayers: int = 1
    stg2fuse_type: str = "basic"
    stg2_type: str = "full"
    stg2_useproj: bool = True

    drop: Optional[str] = None  # modality-drop ablation: 'image' | 'pc'

    # Fused BN-affine+relu+maxpool resnet stem tail
    # (ops/pallas/stem_pool.py): one VMEM pass over the full-res conv1
    # output instead of the two XLA passes.  Parity-tested
    # (tests/test_pallas_stem_pool.py + scripts/hw_parity_stem_pool.py),
    # but the FULL-forward A/B (scripts/ab_stem.py, BASELINE.md r5 stem
    # table) measures it a LOSS in context: -3.2% at b32, -12% at b128,
    # -9.5% in the DB tower — the bev_pallas_head failure mode again
    # (standalone VMEM win, serialises against work XLA otherwise
    # overlaps).  Default OFF by that measurement; eval-mode TPU + bf16
    # only when enabled.  AGPLACE_DISABLE_PALLAS=1 forces the XLA path.
    stem_pallas: bool = False


@dataclass(frozen=True)
class DBConfig:
    """Aerial/database tower (reference ``models_baseline/dbvanilla2d.py:31``)."""

    modeldb: str = "vanilla2d"
    image_fe: str = "resnet18"
    image_fe_layers: Tuple[int, ...] = (2, 2, 2)
    share_dbfe: bool = False  # share one backbone across map types
    # fused resnet stem tail — default OFF by the full-forward A/B
    # (-9.5% in this tower at eval b32; see MMConfig.stem_pallas)
    stem_pallas: bool = False


@dataclass(frozen=True)
class ModelConfig:
    modelq: str = "mm"  # query-tower family
    features_dim: int = 256
    mm: MMConfig = field(default_factory=MMConfig)
    db: DBConfig = field(default_factory=DBConfig)
    # aggregation head for the DVGLB-style GeoLocalizationNet family
    # (reference model/network.py) — gem|netvlad|spoc|mac|rmac|crn|rrm|...
    backbone: str = "resnet18conv4"
    aggregation: str = "gem"
    netvlad_clusters: int = 64
    fc_output_dim: Optional[int] = None
    l2: str = "before_pool"  # before_pool | after_pool | none
    # numerics: activation dtype for training (serving always runs bf16).
    # Default float32 for bit-level reference parity; bfloat16 is the
    # RECOMMENDED training setting on TPU — 48.1 vs 72.8 ms/step at
    # reference scale, and the r4 dtype A/B (scripts/ab_train_dtype.py,
    # 3 seeds x 7 epochs, BASELINE.md "Training dtype") found equal recall
    # trajectories (mean best R@5 38.9 both; R@1 22.2 bf16 vs 13.9 fp32 —
    # toy-scale noise favouring bf16, no quality penalty).
    compute_dtype: str = "float32"  # float32 | bfloat16 (activations)
    # pretrained backbone init (reference: torchvision pretrained resnets in
    # both towers, network_mm/image_fe.py:19,33).  Sources tried in order:
    # pretrained_path (file or dir of {arch}*.pth), $AGPLACE_WEIGHTS,
    # ~/.cache/agplace_tpu/weights, <repo>/weights, torchvision zoo.  Falls
    # back to random init with a logged warning when none exists.
    pretrained: bool = True
    pretrained_path: Optional[str] = None
    # DVGLB transformer-backbone knobs (reference --trunc_te/--freeze_te,
    # model/network.py:157-183): truncate the encoder at layer N / freeze
    # layers up to N (optimizer zero-update labels)
    trunc_te: Optional[int] = None
    freeze_te: Optional[int] = None
    # share the query tower as the db tower (reference --share_qdb,
    # train.py:193-196; only coherent for image-only query towers — the
    # reference itself crashes with MM, mm.py:165-170)
    share_qdb: bool = False


@dataclass(frozen=True)
class LossConfig:
    criterion: str = "triplet"  # triplet | sare_ind | sare_joint
    margin: float = 0.1  # tools/options.py:169
    tripletloss_weight: float = 1.0
    otherloss_type: str = "bce"  # bce | mse | l1
    otherloss_weight: float = 0.01
    infonceloss_weight: float = 0.0
    mm_lossweight: Tuple[float, ...] = (1.0, 0.0, 0.0)  # final/cloud/image


@dataclass(frozen=True)
class TrainConfig:
    epochs_num: int = 100
    train_batch_size: int = 16  # triplets per step (each = 12 samples)
    infer_batch_size: int = 32
    queries_per_epoch: int = 16000
    cache_refresh_rate: int = 4000
    neg_samples_num: int = 1000  # negative candidate pool per refresh
    negs_num_per_query: int = 10
    mining: str = "partial_sep"  # partial | partial_sep | full | full_gallery | random | msls_weighted
    # optimizer (two Adams in the reference, train.py:213-214; here one
    # labelled optax partition with the same per-group LRs)
    optim: str = "adam"
    lr: float = 1e-5  # image branch + fusion
    lrpc: float = 1e-4  # voxel branch
    lrdb: float = 1e-5  # aerial tower
    # CRN aggregation LR groups (reference --lr_crn_layer/--lr_crn_net,
    # train.py:200-210: crn params at lr_crn_layer, rest of that tower at
    # lr_crn_net)
    lr_crn_layer: float = 5e-3
    lr_crn_net: float = 5e-4
    seed: int = 0
    patience: int = 50
    train_modelq: bool = True
    train_modeldb: bool = True
    save_dir: str = "logs/default"
    resume: Optional[str] = None
    checkpoint_every_epochs: int = 1
    checkpoint_after_epoch: int = 40  # reference saves only for epoch>40
    profile_steps: int = 0  # >0: a torch.profiler trace of N steps, spans on
    loss: LossConfig = field(default_factory=LossConfig)


@dataclass(frozen=True)
class EvalConfig:
    recall_values: Tuple[int, ...] = (1, 5, 10, 20)
    test_method: str = "hard_resize"
    # hard_resize | single_query | central_crop | five_crops | nearest_crop
    # | maj_voting
    majority_weight: float = 0.01
    pca_dim: Optional[int] = None
    # single_query runs ragged original-resolution queries at batch 1 (the
    # reference's queries_infer_batch_size=1, test.py:141).  The first
    # max_query_shapes distinct shapes embed as they are; a later NEW shape
    # is resized bilinearly (antialiased when it shrinks) to the kept shape
    # nearest in log height + log width (``evaluate.resize_bilinear``), and
    # a warning is logged once.  KITTI-360/nuScenes are uniform-resolution
    # and never hit the cap.
    max_query_shapes: int = 16


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout.  The reference has no multi-device story beyond
    single-process DataParallel+SyncBN (SURVEY.md §2.5); here parallelism is a
    first-class mesh: ``data`` shards the batch (DP, BN stats pmean'd over it)
    and ``gallery`` shards the retrieval database for 100k+ tile galleries."""

    data_axis: str = "data"
    gallery_axis: str = "gallery"
    data_parallel: int = -1  # -1 = use all devices
    gallery_parallel: int = 1


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    exp_name: str = "default"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets mirroring the reference run commands (README.md:76-80)
# ---------------------------------------------------------------------------

def kitti360_config() -> Config:
    """``python train.py --dataset kitti360 --camnames 00 --epochs_num 40``."""
    return Config(
        data=DataConfig(dataset="kitti360", camnames=("00",)),
        # z extent 4 cells = +-4 m at quant 2: the HDL-64's vertical FOV
        # (+2 deg .. -24.9 deg, sensor at 1.73 m) bounds returns to this
        # band; outliers clamp to the boundary plane like the xy clamp.
        model=ModelConfig(mm=MMConfig(vox_grid_extent=(128, 128, 4))),
        train=dataclasses.replace(TrainConfig(), epochs_num=40),
        exp_name="kitti360_00",
    )


def nuscenes_config() -> Config:
    """``python train.py --dataset nuscenes --camnames fl_f_fr_bl_b_br``."""
    return Config(
        data=DataConfig(
            dataset="nuscenes",
            camnames=("fl", "f", "fr", "bl", "b", "br"),
            norm_mean=(0.485, 0.456, 0.406),
            norm_std=(0.229, 0.224, 0.225),
        ),
        train=dataclasses.replace(TrainConfig(), epochs_num=100),
        exp_name="nuscenes_6cam",
    )


def synthetic_config(
    batch_size: int = 4,
    image_size: int = 64,
    vox_max_points: int = 512,
    negs: int = 2,
) -> Config:
    """Small config for CI / smoke tests on CPU-JAX."""
    return Config(
        model=ModelConfig(
            mm=dataclasses.replace(MMConfig(),
                                   vox_grid_extent=(32, 32, 16)),
        ),
        data=DataConfig(
            dataset="synthetic",
            q_resize=image_size,
            db_resize=image_size,
            db_cropsize=image_size,
            vox_max_points=vox_max_points,
        ),
        train=dataclasses.replace(
            TrainConfig(),
            train_batch_size=batch_size,
            infer_batch_size=batch_size,
            negs_num_per_query=negs,
            queries_per_epoch=4 * batch_size,
            cache_refresh_rate=2 * batch_size,
            neg_samples_num=4 * batch_size,
            epochs_num=1,
        ),
        exp_name="synthetic",
    )


# ---------------------------------------------------------------------------
# CLI: the reference's full LIVE flag surface (tools/options.py:19-238),
# table-driven onto the frozen dataclass tree.  Every flag defaults to "not
# given" so dataset presets keep their values unless explicitly overridden.
# ---------------------------------------------------------------------------

def _str2bool(v: str) -> bool:
    """Reference-style string-boolean coercion (tools/options.py:253-263)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")


def _opt(parser):
    def parse(v: str):
        return None if v.lower() in ("none", "null", "") else parser(v)

    return parse


def _tuple_float(spec: str) -> Tuple[float, ...]:
    return tuple(float(x) for x in spec.split("_"))


_KINDS = {
    "int": int,
    "float": float,
    "str": str,
    "bool": _str2bool,
    "ints": _tuple_int,
    "strs": _tuple_str,
    "floats": _tuple_float,
    "opt_int": _opt(int),
    "opt_str": _opt(str),
    "opt_float": _opt(float),
}

# (flag, dotted config path, kind[, choices]) — reference flag names kept
# verbatim where they exist (PARITY.md carries the flag-by-flag table).
FLAG_TABLE = [
    # data (tools/options.py:19-72)
    ("dataset", "data.dataset", "str",
     ["kitti360", "nuscenes", "synthetic"]),
    ("dataroot", "data.dataroot", "str"),
    ("maptype", "data.maptype", "strs"),
    ("camnames", "data.camnames", "strs"),
    ("traindownsample", "data.traindownsample", "int"),
    ("train_ratio", "data.train_ratio", "float"),
    ("val_positive_dist_threshold", "data.val_positive_dist_threshold",
     "float"),
    ("train_positives_dist_threshold",
     "data.train_positives_dist_threshold", "float"),
    ("q_resize", "data.q_resize", "int"),
    ("db_cropsize", "data.db_cropsize", "int"),
    ("db_resize", "data.db_resize", "int"),
    ("q_jitter", "data.q_jitter", "float"),
    ("db_jitter", "data.db_jitter", "float"),
    ("color_jitter", "data.color_jitter", "float"),
    ("horizontal_flip", "data.horizontal_flip", "bool"),
    ("rand_perspective", "data.rand_perspective", "float"),
    ("random_resized_crop", "data.random_resized_crop", "float"),
    ("random_rotation", "data.random_rotation", "float"),
    ("brightness", "data.brightness", "opt_float"),
    ("contrast", "data.contrast", "opt_float"),
    ("saturation", "data.saturation", "opt_float"),
    ("hue", "data.hue", "opt_float"),
    ("norm_mean", "data.norm_mean", "floats"),
    ("norm_std", "data.norm_std", "floats"),
    ("nuscenes_cam_resize", "data.nuscenes_cam_resize", "int"),
    ("read_pc", "data.read_pc", "bool"),
    ("quant_size", "data.quant_size", "float"),
    ("vox_max_points", "data.vox_max_points", "int"),
    ("pc_rot_aug_deg", "data.pc_rot_aug_deg", "float"),
    ("sph_size", "data.sph_size", "int"),
    ("sph_jit", "data.sph_jit", "float"),
    ("bev_jit", "data.bev_jit", "float"),
    ("num_workers", "data.num_workers", "int"),
    # model selection (options.py:90-114)
    ("modelq", "model.modelq", "str",
     ["mm", "minkloc", "minkloc_multimodal", "geoloc"]),
    ("modeldb", "model.db.modeldb", "str", ["vanilla2d", "geoloc"]),
    ("features_dim", "model.features_dim", "int"),
    ("backbone", "model.backbone", "str"),
    ("aggregation", "model.aggregation", "str"),
    ("netvlad_clusters", "model.netvlad_clusters", "int"),
    ("fc_output_dim", "model.fc_output_dim", "opt_int"),
    ("l2", "model.l2", "str", ["before_pool", "after_pool", "none"]),
    ("compute_dtype", "model.compute_dtype", "str",
     ["float32", "bfloat16"]),
    ("pretrained", "model.pretrained", "bool"),
    ("pretrained_path", "model.pretrained_path", "opt_str"),
    ("trunc_te", "model.trunc_te", "opt_int"),
    ("freeze_te", "model.freeze_te", "opt_int"),
    ("share_qdb", "model.share_qdb", "bool"),
    # MM tower (options.py:100-156)
    ("mm_imgfe", "model.mm.imgfe", "str"),
    ("mm_imgfe_layers", "model.mm.imgfe_layers", "ints"),
    ("mm_imgfe_planes", "model.mm.imgfe_planes", "ints"),
    ("mm_imgfe_dim", "model.mm.imgfe_dim", "int"),
    ("mm_voxfe_layers", "model.mm.voxfe_layers", "ints"),
    ("mm_voxfe_planes", "model.mm.voxfe_planes", "ints"),
    ("mm_voxfe_ntd", "model.mm.voxfe_ntd", "int"),
    ("mm_voxfe_dim", "model.mm.voxfe_dim", "int"),
    ("mm_voxfe_block", "model.mm.voxfe_block", "str",
     ["eca", "basic", "aspp", "convnext"]),
    ("voxfe_backend", "model.mm.voxfe_backend", "str",
     ["bev", "dense", "sparse"]),
    ("bev_pallas", "model.mm.bev_pallas", "bool"),
    ("bev_pallas_head", "model.mm.bev_pallas_head", "bool"),
    ("bev_fused_down", "model.mm.bev_fused_down", "bool"),
    ("stem_pallas", "model.mm.stem_pallas", "bool"),
    ("dbstem_pallas", "model.db.stem_pallas", "bool"),
    ("vox_grid_extent", "model.mm.vox_grid_extent", "ints"),
    ("stg2fuse_dim", "model.mm.stg2fuse_dim", "int"),
    ("output_type", "model.mm.output_type", "strs"),
    ("output_l2", "model.mm.output_l2", "bool"),
    ("final_type", "model.mm.final_type", "strs"),
    ("final_fusetype", "model.mm.final_fusetype", "str",
     ["add", "cat", "catadd"]),
    ("final_l2", "model.mm.final_l2", "bool"),
    ("image_weight", "model.mm.image_weight", "float"),
    ("image_learnweight", "model.mm.image_learnweight", "bool"),
    ("vox_weight", "model.mm.vox_weight", "float"),
    ("vox_learnweight", "model.mm.vox_learnweight", "bool"),
    ("shallow_weight", "model.mm.shallow_weight", "float"),
    ("shallow_learnweight", "model.mm.shallow_learnweight", "bool"),
    ("imagevoxorg_weight", "model.mm.imagevoxorg_weight", "float"),
    ("imagevoxorg_learnweight", "model.mm.imagevoxorg_learnweight", "bool"),
    ("shalloworg_weight", "model.mm.shalloworg_weight", "float"),
    ("shalloworg_learnweight", "model.mm.shalloworg_learnweight", "bool"),
    ("stg2imagevox_weight", "model.mm.stg2imagevox_weight", "float"),
    ("stg2imagevox_learnweight", "model.mm.stg2imagevox_learnweight",
     "bool"),
    ("stg2fuse_weight", "model.mm.stg2fuse_weight", "float"),
    ("stg2fuse_learnweight", "model.mm.stg2fuse_learnweight", "bool"),
    ("stg2gnn", "model.mm.stg2gnn", "str", ["qkv", "beltrami"]),
    ("beltrami_k", "model.mm.beltrami_k", "int"),
    ("stg2nlayers", "model.mm.stg2nlayers", "int"),
    ("stg2fuse_type", "model.mm.stg2fuse_type", "str"),
    ("stg2_type", "model.mm.stg2_type", "str"),
    ("stg2_useproj", "model.mm.stg2_useproj", "bool"),
    ("drop", "model.mm.drop", "opt_str"),
    # DB tower
    ("dbimage_fe", "model.db.image_fe", "str"),
    ("dbimage_fe_layers", "model.db.image_fe_layers", "ints"),
    ("share_dbfe", "model.db.share_dbfe", "bool"),
    # ODE (options.py:130-138)
    ("diff_type", "model.mm.ode.diff_type", "str"),
    ("diff_direction", "model.mm.ode.diff_direction", "str",
     ["forward", "backward"]),
    ("odeint_method", "model.mm.ode.method", "str",
     ["euler", "midpoint", "rk4", "dopri5"]),
    ("odeint_size", "model.mm.ode.step_size", "float"),
    ("odeint_rtol", "model.mm.ode.rtol", "float"),
    ("odeint_atol", "model.mm.ode.atol", "float"),
    ("dopri5_max_steps", "model.mm.ode.dopri5_max_steps", "int"),
    ("use_pallas", "model.mm.ode.use_pallas", "bool"),
    ("sdeint_method", "model.mm.ode.sdeint_method", "str"),
    ("sdeint_size", "model.mm.ode.sdeint_size", "float"),
    ("cdeint_method", "model.mm.ode.cdeint_method", "str"),
    ("cdeint_size", "model.mm.ode.cdeint_size", "float"),
    # train (options.py:33-58)
    ("epochs_num", "train.epochs_num", "int"),
    ("train_batch_size", "train.train_batch_size", "int"),
    ("infer_batch_size", "train.infer_batch_size", "int"),
    ("queries_per_epoch", "train.queries_per_epoch", "int"),
    ("cache_refresh_rate", "train.cache_refresh_rate", "int"),
    ("neg_samples_num", "train.neg_samples_num", "int"),
    ("negs_num_per_query", "train.negs_num_per_query", "int"),
    ("mining", "train.mining", "str",
     ["partial", "partial_sep", "full", "full_gallery", "random",
      "msls_weighted"]),
    ("optim", "train.optim", "str", ["adam", "sgd"]),
    ("lr", "train.lr", "float"),
    ("lrpc", "train.lrpc", "float"),
    ("lrdb", "train.lrdb", "float"),
    ("lr_crn_layer", "train.lr_crn_layer", "float"),
    ("lr_crn_net", "train.lr_crn_net", "float"),
    ("seed", "train.seed", "int"),
    ("patience", "train.patience", "int"),
    ("train_modelq", "train.train_modelq", "bool"),
    ("train_modeldb", "train.train_modeldb", "bool"),
    ("save_dir", "train.save_dir", "str"),
    ("resume", "train.resume", "opt_str"),
    ("checkpoint_every_epochs", "train.checkpoint_every_epochs", "int"),
    ("checkpoint_after_epoch", "train.checkpoint_after_epoch", "int"),
    ("profile_steps", "train.profile_steps", "int"),
    # losses (options.py:158-170)
    ("criterion", "train.loss.criterion", "str",
     ["triplet", "sare_ind", "sare_joint"]),
    ("margin", "train.loss.margin", "float"),
    ("tripletloss_weight", "train.loss.tripletloss_weight", "float"),
    ("otherloss_type", "train.loss.otherloss_type", "str",
     ["bce", "mse", "l1"]),
    ("otherloss_weight", "train.loss.otherloss_weight", "float"),
    ("infonceloss_weight", "train.loss.infonceloss_weight", "float"),
    ("mm_lossweight", "train.loss.mm_lossweight", "floats"),
    # eval (options.py:219-226)
    ("recall_values", "eval.recall_values", "ints"),
    ("test_method", "eval.test_method", "str",
     ["hard_resize", "single_query", "central_crop", "five_crops",
      "nearest_crop", "maj_voting"]),
    ("majority_weight", "eval.majority_weight", "float"),
    ("pca_dim", "eval.pca_dim", "opt_int"),
    # mesh (no reference equivalent: its multi-device story is DataParallel)
    ("data_parallel", "mesh.data_parallel", "int"),
    ("gallery_parallel", "mesh.gallery_parallel", "int"),
    ("exp_name", "exp_name", "str"),
]


def _replace_path(cfg, dotted: str, value):
    parts = dotted.split(".")

    def rec(obj, i):
        if i == len(parts) - 1:
            return dataclasses.replace(obj, **{parts[i]: value})
        return dataclasses.replace(
            obj, **{parts[i]: rec(getattr(obj, parts[i]), i + 1)})

    return rec(cfg, 0)


def _get_path(cfg, dotted: str):
    obj = cfg
    for p in dotted.split("."):
        obj = getattr(obj, p)
    return obj


def build_exp_name(cfg: Config) -> str:
    """The reference's experiment name from the hyperparameters
    (``tools/options.py:294-307``), with tuple flags joined by '_' the way
    argparse saw them."""
    t, d = cfg.train, cfg.data
    return (f"{t.seed}_ep{t.epochs_num}_{d.dataset}"
            f"_{'_'.join(d.camnames)}_{t.cache_refresh_rate}"
            f"_{t.queries_per_epoch}_{'_'.join(d.maptype)}"
            f"_trbs{t.train_batch_size}_{t.infer_batch_size}"
            f"_{d.traindownsample}_{d.train_ratio}"
            f"_sph{d.sph_size}_pc{d.read_pc}")


def parse_arguments(argv=None, extra=None):
    """(Config, argparse namespace) from ``argv``: the preset of
    ``--dataset`` (default kitti360) with every given flag of
    ``FLAG_TABLE`` applied.  ``extra(parser)`` adds an entry point's own
    flags."""
    p = argparse.ArgumentParser(
        description="aerial-ground place recognition (the JAX package's "
                    "flag names; unset flags keep the preset's values)")
    for row in FLAG_TABLE:
        flag, _, kind = row[:3]
        choices = row[3] if len(row) > 3 else None
        p.add_argument(f"--{flag}", type=_KINDS[kind], default=None,
                       choices=choices)
    if extra is not None:
        extra(p)
    args = p.parse_args(argv)
    dataset = args.dataset or "kitti360"
    cfg = {"nuscenes": nuscenes_config,
           "synthetic": synthetic_config}.get(dataset, kitti360_config)()
    for row in FLAG_TABLE:
        val = getattr(args, row[0])
        if val is not None:
            cfg = _replace_path(cfg, row[1], val)
    if args.exp_name is None:
        cfg = dataclasses.replace(cfg, exp_name=build_exp_name(cfg))
    _validate(cfg)
    return cfg, args


def _validate(cfg: Config) -> None:
    """Cross-flag validation (the JAX package's ``_validate``)."""
    known_final = {"imageorg", "voxorg", "shalloworg", "stg2image",
                   "stg2vox", "stg2fuse"}
    bad = set(cfg.model.mm.final_type) - known_final
    if bad:
        raise ValueError(f"unknown final_type components: {sorted(bad)}")
    known_out = {"image", "vox", "shallow", "addorg"}
    bad = set(cfg.model.mm.output_type) - known_out
    if bad:
        raise ValueError(f"unknown output_type components: {sorted(bad)}")
    if cfg.data.dataset == "nuscenes":
        bad = set(cfg.data.camnames) - set("fl f fr bl b br".split())
        if bad:
            raise ValueError(f"unknown nuscenes camnames: {sorted(bad)}")
    if cfg.train.train_batch_size <= 0 or cfg.train.infer_batch_size <= 0:
        raise ValueError("batch sizes must be positive")
    if "shallow" in cfg.model.mm.output_type \
            and "addorg" in cfg.model.mm.output_type:
        raise ValueError("output_type: 'shallow' and 'addorg' are exclusive")
