"""Every name in BENCHMARK.json is found; nothing the benchmark runs
imports JAX; the reference imports nothing of the measured program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench.harness import cell as cells

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
BENCH = cells.benchmark()
FORBIDDEN = {"jax", "jaxlib", "flax", "agplace_tpu"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = cells.load(cell)
    assert os.path.exists(os.path.join(HERE, "mixes", c.mix + ".py"))
    assert hasattr(c.mix_module(), "Session")
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert c.entry["chips"] == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found(metric):
    reader = cells.metric_reader(metric)
    assert callable(reader.read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    with open(os.path.join(ROOT, config["file"])) as f:
        data = json.load(f)
    assert data["source"] and data["preset"]
    cfg = cells.port_config(data, "embed")
    cells.arch_of(cfg)  # the reference implements it


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not \
                node.level:
            yield node.module.split(".")[0]


def _sources(*parts):
    for dirpath, _, files in os.walk(os.path.join(HERE, *parts)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        found = set(_imports(path)) & (FORBIDDEN | {"agplace_tpu_torch"})
        assert not found, (path, found)


def test_no_source_imports_jax():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.model, portbench.reference.train, "
            "portbench.reference.voxels; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.strip().replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"agplace_tpu_torch"})


def test_run_refuses_without_a_card():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not p.stdout.strip()
