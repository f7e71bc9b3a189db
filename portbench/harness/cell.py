"""Find everything of a cell by the names in ``BENCHMARK.json``.

* ``BENCHMARK.json`` (the checkout's root): the cell's configuration and
  traffic names, its chips, and the metrics it reports;
* ``portbench/configs/<config>.json``: the preset of the measured program
  and the keys set on it for each kind of mix (``set``);
* ``portbench/traffic/<traffic>.json``: the mix (``portbench/mixes/<mix>.py``)
  and its parameters;
* ``portbench/workloads/<cell>.json``: the limits of the comparison that
  decides ``correct``, with the readings they were set from;
* ``portbench/metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the workload's entry in BENCHMARK.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # workloads/<cell>.json["limits"]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def mix(self) -> str:
        return self.traffic["mix"]

    @property
    def params(self) -> dict:
        return self.traffic["params"]

    def mix_module(self):
        return _module(os.path.join(HERE, "mixes", self.mix + ".py"),
                       f"portbench_mix_{self.mix}")


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load(name: str) -> Cell:
    bench = benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(
        name=name, entry=entry,
        config=_json(os.path.join(HERE, "configs",
                                  entry["config"] + ".json")),
        traffic=_json(os.path.join(HERE, "traffic",
                                   entry["traffic"] + ".json")),
        limits=_json(os.path.join(HERE, "workloads",
                                  name + ".json"))["limits"],
        end_to_end=e2e, per_layer=layer)


def metric_reader(name: str):
    return _module(os.path.join(HERE, "metrics", name + ".py"),
                   "portbench_metric_" + name.replace(".", "_").replace(
                       "-", "_"))


def _replace_path(obj, path: List[str], value):
    if not path:
        return value
    head, rest = path[0], path[1:]
    return dataclasses.replace(
        obj, **{head: _replace_path(getattr(obj, head), rest, value)})


def port_config(config: dict, kind: str, extra: Optional[Dict] = None):
    """The measured program's ``Config``: the preset with the keys that
    ``config['set'][kind]`` (dotted paths) and ``extra`` give."""
    from agplace_tpu_torch import config as port

    cfg = getattr(port, config["preset"])()
    sets = dict(config.get("set", {}).get(kind, {}))
    sets.update(extra or {})
    for dotted, value in sets.items():
        if isinstance(value, list):
            value = tuple(value)
        cfg = _replace_path(cfg, dotted.split("."), value)
    return cfg


def precisions(cfg) -> Dict[str, str]:
    """The precision of each group of products, as the configuration
    states it: the image convs in the compute dtype, the voxel convs in
    bf16 (the MM's BEV convs at any compute dtype), dense layers and the
    FCODE products in fp32."""
    return {"img": cfg.model.compute_dtype, "vox": "bfloat16",
            "dense": "float32"}


LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def control_precision(cfg):
    """The control's precision of a group: the groups that compute in the
    configuration's compute dtype one step lower (fp32 with TF32 off to
    TF32, bf16 to fp8), the others as stated."""
    stated = cfg.model.compute_dtype
    return lambda p: LOWER[p] if p == stated else p


def arch_of(cfg) -> dict:
    """The numbers of the configuration the reference reads.  Raises for
    an MM the reference does not implement."""
    m = cfg.model.mm
    want = dict(imgfe="resnet18", imgfe_layers=(2, 2, 2),
                voxfe_planes=(64, 128, 256), voxfe_layers=(1, 1, 1),
                voxfe_ntd=0, voxfe_block="eca", voxfe_backend="bev",
                output_type=("image", "vox", "shallow"), output_l2=True,
                final_fusetype="add", final_l2=False, stg2nlayers=1,
                stg2_useproj=True, stg2fuse_type="basic", drop=None)
    for key, value in want.items():
        if getattr(m, key) != value:
            raise NotImplementedError(f"the reference implements mm.{key}="
                                      f"{value!r}, not {getattr(m, key)!r}")
    if (m.ode.method != "euler" or m.ode.diff_type != "fcode@relu"
            or m.ode.diff_direction != "backward"):
        raise NotImplementedError("the reference integrates one relu FCODE "
                                  "per scale by Euler, deep to shallow")
    db = cfg.model.db
    if (cfg.model.modelq != "mm" or db.modeldb != "vanilla2d"
            or db.image_fe != "resnet18" or tuple(db.image_fe_layers)
            != (2, 2, 2) or cfg.data.nmap != 1 or cfg.model.share_qdb):
        raise NotImplementedError("the reference implements the MM query "
                                  "tower and the one-map vanilla2d aerial "
                                  "tower")
    weights = {"imageorg": m.imagevoxorg_weight,
               "voxorg": m.imagevoxorg_weight,
               "shalloworg": m.shalloworg_weight,
               "stg2image": m.stg2imagevox_weight,
               "stg2vox": m.stg2imagevox_weight,
               "stg2fuse": m.stg2fuse_weight}
    steps = round(1.0 / m.ode.step_size)
    return dict(extent=tuple(m.vox_grid_extent), ode_dt=m.ode.step_size,
                ode_steps=steps, shallow_weight=m.shallow_weight,
                final_type=tuple(m.final_type), final_weights=weights,
                quant=cfg.data.quant_size, capacity=cfg.data.vox_max_points)
