"""The port's three entry points take every flag of the JAX package's table
(``agplace_tpu_torch/train/cli.py``): each flag, given a value other than
its preset's, parses in ``python -m agplace_tpu_torch.train``, ``.test``
and ``.serve`` to the ``cfg`` JAX's ``parse_arguments`` gives (or both
raise the same error); ``--data_parallel`` / ``--gallery_parallel`` above
1 raise in all three; and the flags JAX routes into a module change that
module in the port (the ODE tolerances here, the folder dataset's query
augmentations in ``test_torch_port_tail.py``).  Exact comparisons: these
are parsed values.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import agplace_tpu.config as jax_config
from agplace_tpu_torch import config
from agplace_tpu_torch import serve as port_serve
from agplace_tpu_torch import test as port_test
from agplace_tpu_torch.models.fusion import FCODE
from agplace_tpu_torch.models.mm import MM
from agplace_tpu_torch.train import cli

BASE = ["--dataset", "synthetic"]

# a value other than the synthetic preset's, by flag (else by kind)
VALUES = {
    "dataset": "nuscenes", "maptype": "satellite_roadmap",
    "camnames": "f_b", "backbone": "resnet50conv4", "aggregation": "netvlad",
    "mm_imgfe": "resnet34", "stg2fuse_type": "add", "stg2_type": "blockadd",
    "output_type": "image_vox", "final_type": "imageorg_stg2fuse",
    "diff_type": "fcode@tanh", "dbimage_fe": "resnet34",
    "sdeint_method": "milstein", "cdeint_method": "rk4",
    "save_dir": "elsewhere", "exp_name": "named", "dataroot": "/data",
    "data_parallel": "1", "gallery_parallel": "1",
    "vox_grid_extent": "64_64_8", "drop": "image",
}
BY_KIND = {"int": "3", "float": "0.25", "opt_float": "0.25",
           "floats": "0.5_0.25_0.125", "opt_int": "7", "ints": "1_2_3",
           "strs": "a_b", "str": "x", "opt_str": "given"}


def _value(row):
    flag, path, kind = row[:3]
    if flag in VALUES:
        return VALUES[flag]
    preset = config._get_path(config.synthetic_config(), path)
    if kind == "bool":
        return "false" if preset else "true"
    if len(row) > 3:
        return next(c for c in reversed(row[3]) if c != preset)
    return BY_KIND[kind]


class _Parsed(Exception):
    def __init__(self, cfg):
        self.cfg = cfg


def _outcome(parse):
    try:
        return "ok", dataclasses.asdict(parse())
    except _Parsed as got:
        return "ok", dataclasses.asdict(got.cfg)
    except (ValueError, NotImplementedError, SystemExit) as err:
        return "raises", type(err).__name__


def _stop(cfg, *a, **k):
    raise _Parsed(cfg)


@pytest.mark.parametrize("row", config.FLAG_TABLE,
                         ids=[r[0] for r in config.FLAG_TABLE])
def test_every_flag_parses_as_jax_in_all_three_entries(row, monkeypatch):
    argv = ([] if row[0] == "dataset" else BASE) + [f"--{row[0]}",
                                                     _value(row)]
    want = _outcome(lambda: jax_config.parse_arguments(argv))
    assert want[0] == "ok", want
    monkeypatch.setattr(cli, "build_datasets", _stop)
    monkeypatch.setattr(port_test, "check_supported", _stop)
    got = {
        "train": _outcome(lambda: cli.main([*argv, "--device", "cpu"])),
        "test": _outcome(lambda: port_test.main([*argv, "--device",
                                                 "cpu"])),
        "serve": _outcome(lambda: port_serve._config(argv)),
    }
    for entry, out in got.items():
        assert out == want, entry
    if want[0] == "ok":  # the flag moved its field off the preset
        preset = config._get_path(config.synthetic_config(), row[1])
        assert config._get_path(config.parse_arguments(argv)[0],
                                row[1]) != preset or row[0] in (
            "data_parallel", "gallery_parallel", "dataset")


def test_the_table_is_honoured_whole(monkeypatch):
    """Every flag of the table at once, each off its preset: all three
    entry points parse it to JAX's ``cfg``."""
    assert config.FLAG_TABLE == jax_config._FLAG_TABLE
    argv = list(BASE)
    for row in config.FLAG_TABLE:
        if row[0] != "dataset":
            argv += [f"--{row[0]}", _value(row)]
    want = _outcome(lambda: jax_config.parse_arguments(argv))
    assert want[0] == "ok", want
    monkeypatch.setattr(cli, "build_datasets", _stop)
    monkeypatch.setattr(port_test, "check_supported", _stop)
    assert _outcome(lambda: cli.main([*argv, "--device", "cpu"])) == want
    assert _outcome(lambda: port_test.main([*argv, "--device",
                                            "cpu"])) == want
    assert _outcome(lambda: port_serve._config(argv)) == want


TINY = ["--dataset", "synthetic", "--q_resize", "32",
        "--train_batch_size", "2", "--infer_batch_size", "4",
        "--negs_num_per_query", "2", "--queries_per_epoch", "4",
        "--cache_refresh_rate", "4", "--neg_samples_num", "8",
        "--vox_max_points", "128", "--epochs_num", "1", "--pretrained",
        "false", "--num_workers", "1"]


@pytest.mark.parametrize("flag", ["data_parallel", "gallery_parallel"])
def test_multi_device_flags_above_one_raise(flag, tmp_path):
    """Named for the refusal it once tested: nothing raises now.  On one
    rank the port does what JAX does on a one-device host: with the flag
    at 2 and the other at -1, ``train`` and ``test`` resolve no mesh and
    run single-device (and log that they do), and ``serve`` takes both
    flags and builds no mesh, as JAX's ``serve.py``."""
    import jax

    from agplace_tpu.parallel import mesh as jax_mesh
    from agplace_tpu_torch.parallel import mesh

    other = ({"data_parallel", "gallery_parallel"} - {flag}).pop()
    argv = [*TINY, f"--{flag}", "2", f"--{other}", "-1", "--save_dir",
            str(tmp_path)]
    want = jax_config.parse_arguments(argv)
    assert getattr(want.mesh, flag) == 2
    one = jax.devices()[:1]
    assert jax_mesh.resolve_data_mesh(want.mesh, (2, 4), devices=one) is None
    assert jax_mesh.resolve_gallery_mesh(want.mesh, devices=one) is None
    cfg = port_serve._config(argv)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert mesh.resolve_data_mesh(cfg.mesh, (2, 4)) is None
    assert mesh.resolve_gallery_mesh(cfg.mesh) is None
    root = logging.getLogger()
    kept = root.handlers[:], root.level
    try:  # both entry points point the root logger at save_dir
        out = cli.main([*argv, "--device", "cpu"])
        recalls = port_test.main([*argv, "--device", "cpu"])
    finally:
        for h in root.handlers:
            h.close()
        root.handlers, root.level = kept[0], kept[1]
    assert out["state"].step == 2 and np.isfinite(out["history"][0]["loss"])
    assert np.isfinite(recalls).all()
    log = open(tmp_path / "info.log").read()
    assert "resolve to single-device" in log and "data mesh" not in log


def _fcode(argv, x):
    cfg, _ = config.parse_arguments([*BASE, "--odeint_method", "dopri5",
                                     *argv])
    ode = cfg.model.mm.ode
    f = FCODE(8, "tanh", ode)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        f.kernel.copy_(torch.randn(8, 8, generator=g) * 2.0)
        y = f(x)
    return ode, y, int(f.accepted_steps)


def test_ode_tolerances_route_into_fcode():
    """``--odeint_rtol`` / ``--odeint_atol`` / ``--dopri5_max_steps`` reach
    the FCODE blocks (JAX ``models/fusion.py:77-78``): a tighter
    tolerance takes more accepted steps, and a cap of one attempt stops
    the integration short."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8)).astype(np.float32))
    loose_ode, loose, n_loose = _fcode(["--odeint_rtol", "1e-1",
                                        "--odeint_atol", "1e-1"], x)
    tight_ode, tight, n_tight = _fcode(["--odeint_rtol", "1e-7",
                                        "--odeint_atol", "1e-7"], x)
    assert (loose_ode.rtol, loose_ode.atol) == (1e-1, 1e-1)
    assert (tight_ode.rtol, tight_ode.atol) == (1e-7, 1e-7)
    assert n_tight > n_loose and not torch.equal(loose, tight)
    capped_ode, capped, n_capped = _fcode(
        ["--odeint_rtol", "1e-7", "--odeint_atol", "1e-7",
         "--dopri5_max_steps", "1"], x)
    assert capped_ode.dopri5_max_steps == 1 and n_capped <= 1
    assert not torch.equal(capped, tight)
    # and every FCODE of the MM built from the flags carries them
    cfg, _ = config.parse_arguments([*BASE, "--odeint_method", "dopri5",
                                     "--odeint_rtol", "1e-5",
                                     "--dopri5_max_steps", "9"])
    odes = [m.ode for m in MM(cfg.model.mm).modules()
            if isinstance(m, FCODE)]
    assert odes and all(o.rtol == 1e-5 and o.dopri5_max_steps == 9
                        for o in odes)
