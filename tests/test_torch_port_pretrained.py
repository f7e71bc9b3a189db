"""Pretrained-backbone grafting in the port held against the JAX package
on the CPU (``agplace_tpu_torch/utils/torch_convert.py``,
``train/step.apply_pretrained_backbones``).

Each case writes one ``.pth`` per architecture from a seeded torch module
in the layout the weights ship in (torchvision's names: the JAX tests'
mirrors and ``scripts/write_torch_weights.py``), then grafts it twice:
JAX's ``apply_pretrained_backbones`` into JAX's tower trees (shapes from
``jax.eval_shape``), and the port's ``init_state`` into its towers.  The
leaves JAX's graft changed, passed through the weight bridge, must equal
the port's bit for bit, the port must change no other leaf, and every
other leaf keeps its initial value.  The positional embeddings JAX
resizes with ``jax.image.resize`` are held within 1e-6 of their scale
(measured <= 1.1e-7): the port computes JAX's weight matrices exactly but
contracts them in its own order.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from agplace_tpu.train.step import (apply_pretrained_backbones as
                                    jax_apply_pretrained)
from agplace_tpu.utils import torch_convert as jax_tc
from agplace_tpu_torch.infer import build_towers
from agplace_tpu_torch.train.step import init_state
from agplace_tpu_torch.utils import torch_convert as tc
from agplace_tpu_torch.utils.convert import jax_to_state_dict
from agplace_tpu_torch.utils.image_resize import resize_weights
from scripts.write_torch_weights import randomize, seeded_state_dict
from test_backbone_converters import (_torch_alexnet_trunk, _torch_convnext,
                                      _torch_squeezenet, _torch_vgg16_trunk,
                                      _TorchCCT)
from test_models_image import _build_torch_resnet
from test_torch_port_families import configs, jax_towers, world

torch.set_num_threads(1)

POS_TOL = 1e-6


def _sd(module, prefix=""):
    return {prefix + k: v for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def checkpoint(arch, seed=0):
    """A seeded state_dict of ``arch`` in the layout it ships in: the
    names and shapes of the JAX tests' torch mirrors (or of
    ``write_torch_weights``), every value drawn from ``seed`` + 1000 (no
    value is left at a layer's default, and no stream is the towers' own
    seed-0 init, either of which could equal an initial value)."""
    seed += 1000
    if arch in ("resnet50", "vit"):  # vit: two layers of ViT-B/16, 224 px
        return seeded_state_dict(arch, seed,
                                 **({"layers": 2} if arch == "vit" else {}))
    if arch in ("resnet18", "resnet34"):
        sd = _sd(_build_torch_resnet(arch, 4))
    elif arch == "vgg16":
        sd = _sd(_torch_vgg16_trunk()[1], "features.")
    elif arch == "alexnet":
        sd = _sd(_torch_alexnet_trunk()[1], "features.")
    elif arch == "convnext_tiny":
        sd = _sd(_torch_convnext((2, 2, 2)), "features.")
    elif arch in ("squeezenet10", "squeezenet11"):
        sd = _sd(_torch_squeezenet(f"1_{arch[-1]}"), "features.")
    elif arch == "cct384":  # two layers at CCT-14's width, 64 px
        sd = _sd(_TorchCCT(384, 6, 2, n_tokens=16))
    else:
        raise KeyError(arch)
    return randomize({k: v.shape for k, v in sd.items()}, seed)


def write_weights(directory, archs):
    directory.mkdir(exist_ok=True)
    for i, arch in enumerate(archs):
        torch.save(checkpoint(arch, i), directory / f"{arch}-seeded.pth")
    return str(directory)


def port_flat(mm, db):
    out = {f"mm.{k}": v.detach().clone() for k, v in mm.state_dict().items()}
    if db is not None:
        out.update({f"db.{k}": v.detach().clone()
                    for k, v in db.state_dict().items()})
    return out


def jax_flat(cfg, qv, dv):
    mm, db = build_towers(cfg, "cpu")
    out = {f"mm.{k}": v for k, v in jax_to_state_dict(qv, mm).items()}
    if db is not None:
        out.update({f"db.{k}": v for k, v in
                    jax_to_state_dict(dv, db).items()})
    return out


def pretrained_configs(path, model=None, db=None, data=None,
                       image_size=32):
    """``configs`` with ``model.pretrained`` on, from ``path``."""
    out = []
    for c in configs(model=model, db=db, image_size=image_size):
        c = c.replace(model=dataclasses.replace(
            c.model, pretrained=True, pretrained_path=path))
        out.append(c.replace(data=dataclasses.replace(c.data, **data))
                   if data else c)
    return tuple(out)


def graft_both(tmp_path, archs, model=None, db=None, data=None,
               image_size=32):
    """(JAX before, JAX after, port before, port after) flat state
    dicts of both towers, with ``archs``' weights in a directory given
    as ``model.pretrained_path``."""
    path = write_weights(tmp_path / "w", archs)
    cfg_j, cfg = pretrained_configs(path, model, db, data, image_size)
    rng, img, maps, _ = world(0, image_size)
    if cfg.data.nmap > 1:
        maps = np.repeat(maps, cfg.data.nmap, axis=1)
    vox_j = np.zeros((2, 1, 3), np.float32)
    if cfg_j.model.modelq == "mm":
        from agplace_tpu.data.base import prepare_query_vox as jax_vox
        from test_torch_port_mm_options import cloud

        vox_j = jax_vox(cfg_j, cloud(rng, 2, n=200))
    _, qv, _, dv = jax_towers(cfg_j, rng, img, maps, vox_j)
    j_before = jax_flat(cfg, qv, dv)
    params = {"mm": qv["params"], "db": {} if dv is None else dv["params"]}
    stats = {"mm": qv.get("batch_stats", {}),
             "db": {} if dv is None else dv.get("batch_stats", {})}
    params, stats = jax_apply_pretrained(cfg_j, params, stats)
    qv = {"params": params["mm"], "batch_stats": stats["mm"]}
    if not qv["batch_stats"]:
        del qv["batch_stats"]
    if dv is not None:
        dv = {"params": params["db"], "batch_stats": stats["db"]}
        if not dv["batch_stats"]:
            del dv["batch_stats"]
    j_after = jax_flat(cfg, qv, dv)
    plain = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  pretrained=False))
    p_before = port_flat(*init_state(plain, "cpu").towers)
    p_after = port_flat(*init_state(cfg, "cpu").towers)
    return j_before, j_after, p_before, p_after


def changed(before, after):
    return {k for k in before if not torch.equal(before[k], after[k])}


def check_graft(j_before, j_after, p_before, p_after, expect_prefixes):
    grafted = changed(j_before, j_after)
    assert grafted, "JAX grafted nothing"
    assert changed(p_before, p_after) == grafted
    assert {k for k in grafted if not k.endswith(".pos")} == {
        k for k in grafted if k.startswith(expect_prefixes)
        and not k.endswith(".pos")}
    for k in grafted:
        want, got = j_after[k], p_after[k]
        if k.endswith(".pos"):
            err = (got - want).abs().max() / want.abs().max()
            assert err <= POS_TOL, (k, float(err))
        else:
            assert torch.equal(got, want), k
    return grafted


CASES = {
    # name: (archs written, model overrides, db overrides, graft prefixes)
    "mm-resnet18+db-resnet18": (["resnet18"], {}, {},
                                ("mm.image_fe.fe.", "db.fe_0.fe.")),
    "db-resnet50": (["resnet18", "resnet50"], {},
                    {"image_fe": "resnet50"},
                    ("mm.image_fe.fe.", "db.fe_0.fe.")),
    "db-resnet34": (["resnet34"], {}, {"image_fe": "resnet34"},
                    ("db.fe_0.fe.",)),
    "db-convnext": (["convnext_tiny"], {}, {"image_fe": "convnext_tiny"},
                    ("db.fe_0.fe.",)),
    "db-squeezenet10": (["squeezenet10"], {}, {"image_fe": "squeezenet10"},
                        ("db.fe_0.fe.",)),
    "db-squeezenet11": (["squeezenet11"], {}, {"image_fe": "squeezenet11"},
                        ("db.fe_0.fe.",)),
    "geoloc-resnet18conv4": (["resnet18"], {"modelq": "geoloc"},
                             {"modeldb": "geoloc"},
                             ("mm.backbone.", "db.net.backbone.")),
    "geoloc-resnet50conv4": (["resnet50"], {"modelq": "geoloc",
                                            "backbone": "resnet50conv4"},
                             {"modeldb": "geoloc"},
                             ("mm.backbone.", "db.net.backbone.")),
    "geoloc-vgg16": (["vgg16"], {"modelq": "geoloc", "backbone": "vgg16"},
                     {"modeldb": "geoloc"},
                     ("mm.backbone.", "db.net.backbone.")),
    "geoloc-alexnet": (["alexnet"], {"modelq": "geoloc",
                                     "backbone": "alexnet"},
                       {"modeldb": "geoloc"},
                       ("mm.backbone.", "db.net.backbone.")),
    "geoloc-vit": (["vit"], {"modelq": "geoloc", "backbone": "vit",
                             "trunc_te": 1}, {"modeldb": "geoloc"},
                   ("mm.backbone.", "db.net.backbone.")),
    "geoloc-cct": (["cct384"], {"modelq": "geoloc", "backbone": "cct384",
                                "aggregation": "seqpool", "trunc_te": 1},
                   {"modeldb": "geoloc"},
                   ("mm.backbone.", "db.net.backbone.")),
    "share_qdb": (["resnet18"], {"modelq": "geoloc", "share_qdb": True},
                  {}, ("mm.backbone.",)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_graft_matches_jax(tmp_path, name):
    archs, model, db, prefixes = CASES[name]
    _, _, _, p_after = out = graft_both(tmp_path, archs, model, db)
    grafted = check_graft(*out, prefixes)
    if name.startswith("db-squeezenet"):  # the fresh 1x1 head stays
        assert not any(".fc." in k for k in grafted)
    if name == "share_qdb":
        assert not any(k.startswith("db.") for k in p_after)


@pytest.mark.parametrize("share", [False, True],
                         ids=["a-branch-each", "share_dbfe"])
def test_two_map_types_graft_as_jax(tmp_path, share):
    """Two map types: each DBVanilla2D branch grafted, or the one shared
    branch under ``share_dbfe``."""
    prefixes = ("mm.image_fe.fe.", "db.fe_0.fe.") + (
        () if share else ("db.fe_1.fe.",))
    out = graft_both(tmp_path, ["resnet18"], db={"share_dbfe": share},
                     data={"maptype": ("satellite", "roadmap")})
    grafted = check_graft(*out, prefixes)
    assert any(k.startswith("db.fe_1.") for k in grafted) == (not share)


def test_resnet101_stays_random_as_in_jax(tmp_path, caplog):
    """JAX's converter table has no resnet101, so a resnet101conv4 tower
    stays random-init even beside a resnet101 file; the port keeps it."""
    path = tmp_path / "w"
    path.mkdir()
    torch.save(checkpoint("resnet50"), path / "resnet101-seeded.pth")
    assert jax_tc.load_pretrained_backbone("resnet101", str(path)) is None
    assert tc.load_pretrained_backbone("resnet101", str(path)) is None
    _, cfg = pretrained_configs(str(path), dict(modelq="geoloc",
                                                backbone="resnet101conv4"),
                                dict(modeldb="geoloc"))
    plain = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  pretrained=False))
    with caplog.at_level("WARNING", logger="train"):
        after = port_flat(*init_state(cfg, "cpu").towers)
    assert not changed(port_flat(*init_state(plain, "cpu").towers), after)
    assert any("resnet101" in r.getMessage() for r in caplog.records)


# ---------------------------------------------------------- the sources
def test_search_order_matches_jax(tmp_path, monkeypatch):
    """Explicit file, then explicit directory, then $AGPLACE_WEIGHTS,
    then ~/.cache/agplace_tpu/weights: each found in both packages."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("AGPLACE_WEIGHTS", raising=False)
    cache = tmp_path / "home" / ".cache" / "agplace_tpu" / "weights"
    env, explicit = tmp_path / "env", tmp_path / "explicit"
    for d, seed in ((cache, 0), (env, 1), (explicit, 2)):
        d.mkdir(parents=True)
        torch.save(checkpoint("resnet18", seed), d / "resnet18-x.pth")
    monkeypatch.setenv("AGPLACE_WEIGHTS", str(env))

    def first(path):
        ours = tc.find_pretrained_state_dict("resnet18", path)
        ref = jax_tc.find_pretrained_state_dict("resnet18", path)
        assert torch.equal(ours["conv1.weight"], ref["conv1.weight"])
        return ours["conv1.weight"]

    seeds = {s: checkpoint("resnet18", s)["conv1.weight"] for s in (0, 1, 2)}
    assert torch.equal(first(str(explicit / "resnet18-x.pth")), seeds[2])
    assert torch.equal(first(str(explicit)), seeds[2])
    assert torch.equal(first(None), seeds[1])
    monkeypatch.delenv("AGPLACE_WEIGHTS")
    assert torch.equal(first(None), seeds[0])


def test_probe_key_rejection_and_corrupt_file_skipped(tmp_path, caplog):
    """A file that fails to load and a file of another architecture are
    skipped, and named in the log; the next file is taken."""
    d = tmp_path / "w"
    d.mkdir()
    (d / "resnet18-a-corrupt.pth").write_bytes(b"not a checkpoint")
    torch.save(checkpoint("vgg16"), d / "resnet18-b-vgg.pth")
    torch.save({"state_dict": checkpoint("resnet18", 3)},
               d / "resnet18-c-wrapped.pth")
    with caplog.at_level("WARNING", logger="pretrained"):
        ours = tc.find_pretrained_state_dict("resnet18", str(d))
    ref = jax_tc.find_pretrained_state_dict("resnet18", str(d))
    assert torch.equal(ours["conv1.weight"], ref["conv1.weight"])
    assert torch.equal(ours["conv1.weight"],
                       checkpoint("resnet18", 3)["conv1.weight"])
    text = " ".join(r.getMessage() for r in caplog.records)
    assert "resnet18-a-corrupt.pth" in text and "resnet18-b-vgg.pth" in text
    # only the wrong files: nothing found, in both
    (d / "resnet18-c-wrapped.pth").unlink()
    assert tc.find_pretrained_state_dict("resnet18", str(d)) is None
    assert jax_tc.find_pretrained_state_dict("resnet18", str(d)) is None
    # the probe keys are JAX's
    assert tc.ARCH_KEY_PROBE == jax_tc._ARCH_KEY_PROBE


def test_no_source_warns_and_stays_random(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("AGPLACE_WEIGHTS", raising=False)
    _, cfg = pretrained_configs(str(tmp_path / "none"))
    plain = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  pretrained=False))
    with caplog.at_level(logging.WARNING, logger="train"):
        after = port_flat(*init_state(cfg, "cpu").towers)
    assert not changed(port_flat(*init_state(plain, "cpu").towers), after)
    assert sum("no pretrained resnet18" in r.getMessage()
               for r in caplog.records) == 1  # once per arch, as JAX


def test_shape_mismatch_raises_and_dropped_subtrees_counted(tmp_path):
    _, cfg = configs(model=dict(modelq="geoloc"), db=dict(modeldb="geoloc"),
                     image_size=32)
    mm, _ = build_towers(cfg, "cpu")
    params, stats = tc.convert_resnet(checkpoint("resnet18"), "resnet18", 4)
    dropped = tc.graft(mm, "backbone", params, stats)
    # the conv4 tower has 3 stages: layer4's two blocks have no place, in
    # the params and the statistics
    assert sorted(dropped) == ["backbone/layer4_0", "backbone/layer4_0",
                               "backbone/layer4_1", "backbone/layer4_1"]
    params["conv1"]["kernel"] = params["conv1"]["kernel"][:, :, :2]
    with pytest.raises(ValueError, match="shape"):
        tc.graft(mm, "backbone", params, stats)


# ---------------------------------------------- the converters and resizes
@pytest.mark.parametrize("n_tokens", [197, 257, 50, 5],
                         ids=["same", "grow-256px", "shrink-112px",
                              "shrink-32px"])
def test_vit_converter_and_pos_resize_match_jax(n_tokens):
    sd = checkpoint("vit")
    ours, _ = tc.convert_vit_b16(sd, n_tokens=n_tokens)
    ref, _ = jax_tc.convert_vit_b16(sd, n_tokens=n_tokens)
    pos, want = ours.pop("pos"), np.asarray(ref.pop("pos"))
    assert pos.shape == want.shape == (1, n_tokens, 768)
    err = np.abs(pos - want).max() / np.abs(want).max()
    assert err <= POS_TOL, err
    np.testing.assert_array_equal(pos[:, 0], want[:, 0])  # CLS kept

    def leaves(t, p=()):
        for k, v in t.items():
            yield from (leaves(v, p + (k,)) if isinstance(v, dict)
                        else [(p + (k,), v)])

    a, b = dict(leaves(ours)), dict(leaves(ref))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("m,n", [(14, 16), (16, 14), (14, 2), (4, 8)])
def test_resize_weights_equal_jax(m, n):
    from jax._src.image import scale

    for method, kernel in (("bilinear", scale._fill_triangle_kernel),
                           ("bicubic", scale._fill_keys_cubic_kernel)):
        want = np.asarray(scale.compute_weight_mat(m, n, n / m, 0.0, kernel,
                                                   True))
        np.testing.assert_array_equal(resize_weights(m, n, method), want)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "vgg16",
                                  "alexnet", "convnext_tiny",
                                  "squeezenet10", "squeezenet11"])
def test_converters_equal_jax(arch):
    sd = checkpoint(arch)
    if arch.startswith("resnet"):
        ours = tc.convert_resnet(sd, arch, 3)
        ref = jax_tc.convert_resnet(sd, arch, 3)
    elif arch == "convnext_tiny":
        ours = tc.convert_convnext_tiny(sd, (2, 2, 2))
        ref = jax_tc.convert_convnext_tiny(sd, (2, 2, 2))
    else:
        ours = tc._CONVERTERS[arch](sd)
        ref = jax_tc._CONVERTERS[arch](sd)

    def flat(t, p=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{p}/{k}") if isinstance(v, dict)
                       else {f"{p}/{k}": np.asarray(v)})
        return out

    for a, b in zip(ours, ref):
        fa, fb = flat(a), flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert fa[k].dtype == fb[k].dtype
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
