"""The port's data layer (``agplace_tpu_torch/data/{geo,transforms,kitti360,
nuscenes,validate}.py``) held against the JAX package's on the CPU: UTM
conversion bit-equal in float64, every transform bit-equal (both decode
and resize with the same PIL calls), the KITTI-360-AG and nuScenes-AG
readers equal on the fixture trees the JAX package's tests write (infos,
coordinates, positives and every loaded item, both splits, jitter 0),
``collate_train`` equal, the MM on a KITTI-360 query at its real aspect,
and the layout validator's report and exit code equal on good and broken
layouts."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

import jax
import torch

import agplace_tpu.config as jax_config
from agplace_tpu.data import geo as jax_geo
from agplace_tpu.data import transforms as jax_tf
from agplace_tpu.data import validate as jax_validate
from agplace_tpu.data.base import collate_train as jax_collate_train
from agplace_tpu.data.base import prepare_query_vox as jax_prepare_query_vox
from agplace_tpu.data.kitti360 import KITTI360Dataset as JaxKITTI
from agplace_tpu.data.nuscenes import NuScenesDataset as JaxNuScenes
from agplace_tpu.models.mm import MM as JaxMM
from agplace_tpu.sparse import bev_grid as jax_bev
from agplace_tpu_torch import config
from agplace_tpu_torch.data import geo, transforms, validate
from agplace_tpu_torch.data.base import collate_train
from agplace_tpu_torch.data.kitti360 import KITTI360Dataset
from agplace_tpu_torch.data.nuscenes import NuScenesDataset
from agplace_tpu_torch.data.voxels import prepare_query_vox
from agplace_tpu_torch.models import resnet
from scripts.write_torch_trees import kitti360_tree
from tests.test_data import mini_kitti360  # noqa: F401  (fixture)
from tests.test_nuscenes_fixture import nusc_root  # noqa: F401  (fixture)
from tests.test_torch_port_slice import (KEYS, TOL_BF16, TOL_FP32,
                                         TOL_FP32_VOX, _close, _randomize,
                                         _tgrid, _torch_mm)
from tests.test_validate import kitti_root  # noqa: F401  (fixture)

torch.set_num_threads(1)


def _with_data(cfg, **kw):
    return cfg.replace(data=dataclasses.replace(cfg.data, **kw))


def test_from_latlon_bit_equal():
    """A grid over every zone and band, with the zone edges, the Norway
    (56-64 N, 3-12 E) and Svalbard (72-84 N) exceptions, the equator and
    the southern hemisphere."""
    lat = np.concatenate([np.linspace(-80, 84, 83),
                          [55.999999, 56.0, 63.999, 64.0, 71.9999, 72.0,
                           84.0, 0.0, -1e-9]])
    lon = np.concatenate([np.linspace(-180, 179.9, 121),
                          [2.999999, 3.0, 8.99, 9.0, 11.9999, 12.0, 20.9,
                           21.0, 32.99, 33.0, 41.9, 42.0, -6.0, 6.0]])
    la, lo = (a.ravel() for a in np.meshgrid(lat, lon))
    for args in ((la, lo), (48.98, 8.43), (-33.92487, 18.42406)):
        got, want = geo.from_latlon(*args), jax_geo.from_latlon(*args)
        for g, w in zip(got, want):
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(geo.latlon_to_zone_number(la, lo),
                                  jax_geo.latlon_to_zone_number(la, lo))
    forced = geo.from_latlon(la[:50], lo[:50], force_zone_number=32)
    for g, w in zip(forced, jax_geo.from_latlon(la[:50], lo[:50],
                                                force_zone_number=32)):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    from PIL import Image

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    d = tmp_path_factory.mktemp("img")
    paths = []
    for name, mode in (("a.png", "RGB"), ("b.jpg", "RGB"), ("c.png", "L"),
                       ("d.png", "RGBA")):
        im = Image.fromarray(arr).convert(mode)
        im.save(d / name)
        paths.append(str(d / name))
    return paths, arr.astype(np.float32) / 255.0


def _rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def test_transforms_bit_equal(image):
    from PIL import Image

    paths, img = image
    for p in paths:
        np.testing.assert_array_equal(transforms.load_image_rgb(p),
                                      jax_tf.load_image_rgb(p))
    cases = [
        ("resize", (img, 32), {}), ("resize", (img, (30, 50)), {}),
        ("resize", (img, 45), {}),
        ("resize", (img, 64), {"interpolation": Image.BICUBIC}),
        ("center_crop", (img, 40), {}), ("center_crop", (img, 60), {}),
        ("normalize", (img, (0.5, 0.4, 0.3), (0.22, 0.2, 0.25)), {}),
        ("five_crops", (img, 32), {}),
    ]
    for name, args, kw in cases:
        np.testing.assert_array_equal(getattr(transforms, name)(*args, **kw),
                                      getattr(jax_tf, name)(*args, **kw),
                                      name)
    for seed, kw in enumerate([
            {"strength": 0.3}, {"strength": 0.0},
            {"strength": 0.0, "brightness": 0.4, "hue_strength": 0.2},
            {"strength": 0.2, "contrast": 0.0, "saturation": 0.5}]):
        (ra, rb) = _rngs(seed)
        np.testing.assert_array_equal(
            transforms.color_jitter(img, rng=ra, **kw),
            jax_tf.color_jitter(img, rng=rb, **kw))
    randoms = [("random_horizontal_flip", (), {"p": 0.9}),
               ("random_rotation", (15.0,), {}),
               ("random_resized_crop", (0.5,), {}),
               ("random_perspective", (0.4,), {"p": 1.0})]
    for seed in range(3):
        for name, args, kw in randoms:
            (ra, rb) = _rngs(seed)
            got = getattr(transforms, name)(img, *args, rng=ra, **kw)
            want = getattr(jax_tf, name)(img, *args, rng=rb, **kw)
            np.testing.assert_array_equal(got, want, name)
        ours = config.kitti360_config().data
        ref = jax_config.kitti360_config().data
        aug = dict(rand_perspective=0.3, random_resized_crop=0.3,
                   random_rotation=10.0, horizontal_flip=True)
        (ra, rb) = _rngs(seed)
        np.testing.assert_array_equal(
            transforms.random_query_augment(
                img, dataclasses.replace(ours, **aug), ra),
            jax_tf.random_query_augment(
                img, dataclasses.replace(ref, **aug), rb))


def _kitti_cfgs(root, **kw):
    kw = dict(dataroot=root, q_resize=32, db_cropsize=32, db_resize=32,
              vox_max_points=128, maptype=("satellite", "roadmap"), **kw)
    return (_with_data(config.kitti360_config(), **kw),
            _with_data(jax_config.kitti360_config(), **kw))


def _nusc_cfgs(root):
    kw = dict(dataroot=root, camnames=("fl", "f", "b"),
              maptype=("satellite", "roadmap"), traindownsample=1,
              nuscenes_cam_resize=32, db_resize=48, vox_max_points=256)
    return (_with_data(config.nuscenes_config(), **kw),
            _with_data(jax_config.nuscenes_config(), **kw))


def _same_dataset(ours, ref):
    assert type(ours).__module__.startswith("agplace_tpu_torch.")
    assert (ours.queries_num, ours.database_num) == (ref.queries_num,
                                                     ref.database_num)
    assert ours.queries_infos == ref.queries_infos
    assert ours.database_infos == ref.database_infos
    for a in ("q_eastnorth", "db_eastnorth"):
        got, want = getattr(ours, a), getattr(ref, a)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    for a in ("soft_positives_per_query", "hard_positives_per_query"):
        for got, want in zip(getattr(ours, a), getattr(ref, a)):
            np.testing.assert_array_equal(got, want)
    for q in range(ours.queries_num):
        for item in ("load_query_image", "load_query_points"):
            got, want = getattr(ours, item)(q), getattr(ref, item)(q)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want, item)
    for t in range(ours.database_num):
        np.testing.assert_array_equal(ours.load_db_maps(t),
                                      ref.load_db_maps(t))


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("cam", ["00", "0203"])
def test_kitti360_reader_equals_jax(mini_kitti360, split, cam):
    ours, ref = _kitti_cfgs(mini_kitti360, camnames=(cam,))
    ds = KITTI360Dataset(ours, split)
    assert ds.queries_num == 4 and ds.database_num == 4
    _same_dataset(ds, JaxKITTI(ref, split))


def test_kitti360_point_cap_equals_jax(mini_kitti360):
    """More points than 4 * vox_max_points: the same seeded subsample."""
    ours, ref = _kitti_cfgs(mini_kitti360)
    ours, ref = (_with_data(c, vox_max_points=16) for c in (ours, ref))
    got = KITTI360Dataset(ours, "test").load_query_points(1)
    np.testing.assert_array_equal(
        got, JaxKITTI(ref, "test").load_query_points(1))
    assert got.shape == (64, 3) and np.isfinite(got).all()


def test_nuscenes_reader_equals_jax(nusc_root):
    ours, ref = _nusc_cfgs(nusc_root)
    ds = NuScenesDataset(ours, "train")
    assert ds.queries_num == 4 and ds.database_num == 8
    assert ds.load_query_image(0).shape == (32, 3 * 48, 3)
    _same_dataset(ds, JaxNuScenes(ref, "train"))


def test_nuscenes_index_helpers_equal_jax():
    from agplace_tpu.data import nuscenes as jax_nusc
    from agplace_tpu_torch.data import nuscenes

    xy = np.array([[100.0, -20.0], [3.5, 7.25]])
    for loc in nuscenes.LOCATIONS:
        np.testing.assert_array_equal(nuscenes.ego_to_utm(loc, xy),
                                      jax_nusc.ego_to_utm(loc, xy))
    chain = {f"t{i}": {"prev": f"t{i - 1}" if i else "",
                       "next": f"t{i + 1}" if i < 4 else ""}
             for i in range(5)}
    for tok in ("t0", "t2", "t4"):
        for kind in ("new", "old", "mid"):
            assert nuscenes.get_seq_sample_tokens(chain, tok, 4, kind) == \
                jax_nusc.get_seq_sample_tokens(chain, tok, 4, kind)
    with pytest.raises(NotImplementedError):
        nuscenes.get_seq_sample_tokens(chain, "t0", 2, "sideways")


def test_collate_train_equals_jax(mini_kitti360):
    ours, ref = _kitti_cfgs(mini_kitti360)
    ds, ds_j = KITTI360Dataset(ours, "train"), JaxKITTI(ref, "train")
    triplets = np.array([[0, 0, 2, 3], [3, 3, 1, 0]])
    got = collate_train(ds, triplets, ours, np.random.default_rng(4))
    want = jax_collate_train(ds_j, triplets, ref, np.random.default_rng(4))
    assert sorted(got) == sorted(want)
    for k in ("query_image", "query_eastnorth", "db_map", "db_eastnorth",
              "triplets_local"):
        np.testing.assert_array_equal(got[k], want[k], k)
    np.testing.assert_array_equal(got["vox"].mask.numpy(),
                                  np.asarray(want["vox"].mask))
    np.testing.assert_array_equal(got["vox"].feats.numpy(),
                                  np.asarray(want["vox"].feats))
    assert got["vox"].mask.any()


@pytest.fixture(scope="module")
def real_aspect(tmp_path_factory):
    """Queries stored at ``data_2d_raw_resize320``'s 1198 x 320; at
    q_resize 72 they load as 72 x 270 (KITTI-360's aspect), whose stem map
    is 36 x 135 wide (odd, as 128 x 479 is at q_resize 256)."""
    root = str(tmp_path_factory.mktemp("kitti_real"))
    kitti360_tree(root, drives=1, frames=8, tile=64, n_points=3000)
    return root


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mm_at_real_kitti360_aspect_matches(real_aspect, dtype,
                                            monkeypatch):
    grid = (32, 32, 4)
    fused = dtype == "bfloat16"
    cfgs = []
    for c in (config.kitti360_config(), jax_config.kitti360_config()):
        mm = dataclasses.replace(c.model.mm, vox_grid_extent=grid,
                                 bev_pallas_head=fused, stem_pallas=fused)
        c = _with_data(c, dataroot=real_aspect, q_resize=72)
        cfgs.append(c.replace(model=dataclasses.replace(
            c.model, mm=mm, compute_dtype=dtype)))
    ours, ref = KITTI360Dataset(cfgs[0], "test"), JaxKITTI(cfgs[1], "test")
    img = np.stack([ours.load_query_image(i) for i in range(2)])
    assert img.shape == (2, 72, 270, 3)
    np.testing.assert_array_equal(
        img, np.stack([ref.load_query_image(i) for i in range(2)]))
    pts = np.stack([ours.load_query_points(i) for i in range(2)])
    vox_j = jax_prepare_query_vox(cfgs[1], pts)
    np.testing.assert_array_equal(
        prepare_query_vox(cfgs[0], pts, "cpu").mask.numpy(),
        np.asarray(vox_j.mask))

    if fused:  # the JAX tests' idiom: its Pallas gates on the CPU
        monkeypatch.setattr(jax_bev, "_pallas_backend_ok", lambda: True)
    jdt = jax.numpy.bfloat16 if fused else jax.numpy.float32
    mm_j = JaxMM(config=cfgs[1].model.mm, train=False, dtype=jdt)
    v = _randomize(jax.jit(mm_j.init)(jax.random.PRNGKey(0), img, vox_j),
                   np.random.default_rng(1))
    want = jax.jit(mm_j.apply)(v, img, vox_j)
    stem_calls = []
    real = resnet.stem_pool.fused_affine_relu_maxpool
    monkeypatch.setattr(resnet.stem_pool, "fused_affine_relu_maxpool",
                        lambda *a: stem_calls.append(a) or real(*a))
    mm = _torch_mm(cfgs[0], v, torch.bfloat16 if fused else torch.float32)
    with torch.inference_mode():
        got = mm(torch.from_numpy(img), _tgrid(vox_j))
    assert stem_calls == []  # an odd stem map: K5's gate is off, as JAX's
    for k in KEYS:
        tol = TOL_BF16 if fused else TOL_FP32.get(k, TOL_FP32_VOX)
        _close(got[k].numpy(), want[k], tol, k)


def _break(case, root):
    from agplace_tpu.data.kitti360 import SELECT_LOCATIONS

    if case == "missing_lidar":
        shutil.rmtree(os.path.join(root, "data_3d_voxel0.5",
                                   SELECT_LOCATIONS[0]))
    elif case == "bad_aerial_name":
        d = os.path.join(root, "data_aerial_1_20_320_satellite",
                         SELECT_LOCATIONS[0])
        for name in os.listdir(d):
            os.rename(os.path.join(d, name),
                      os.path.join(d, name.replace("@", "_")))
    elif case == "missing_voxel":
        shutil.rmtree(os.path.join(root, "samples", "LIDAR_TOP_voxel1"))
    elif case == "no_index":
        os.remove(os.path.join(root,
                               "agplace_index_v1.0-trainval_train.json"))
    elif case == "wrong_root":
        return root + "_nope"
    return root


@pytest.mark.parametrize("dataset,case,args", [
    ("kitti360", "good", []),
    ("kitti360", "missing_lidar", ["--no-build"]),
    ("kitti360", "bad_aerial_name", ["--no-build"]),
    ("kitti360", "wrong_root", []),
    ("nuscenes", "good", ["--splits", "train"]),
    ("nuscenes", "good", ["--splits", "train_test", "--maptype",
                          "satellite"]),
    ("nuscenes", "missing_voxel", ["--splits", "train", "--no-build"]),
    ("nuscenes", "no_index", ["--splits", "train", "--no-build"]),
])
def test_validate_reports_as_jax(request, capsys, dataset, case, args):
    tree = request.getfixturevalue("kitti_root" if dataset == "kitti360"
                                   else "nusc_root")
    root = _break(case, tree)
    argv = ["--dataset", dataset, "--dataroot", root, *args]
    rc_j = jax_validate.main(argv)
    want = capsys.readouterr().out
    rc = validate.main(argv)
    got = capsys.readouterr().out
    assert (rc, got) == (rc_j, want)
    assert rc == (0 if case == "good" and "train_test" not in args else 1)
