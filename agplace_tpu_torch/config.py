"""The port's configuration: a copy of the frozen dataclass tree and the
dataset presets of ``agplace_tpu/config.py`` (the JAX package's), so the
port reads no module of the JAX package.  Field names and defaults are the
JAX package's, field for field (``tests/test_torch_port_isolation.py``
holds the presets equal); comments that speak of the TPU describe the
reference's kernels, whose flags the port honours with its CUDA kernels.
The JAX package's argparse front end is not copied: the port has no
command line yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


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
    profile_steps: int = 0  # >0: capture a jax.profiler trace of N steps
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
