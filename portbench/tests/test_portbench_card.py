"""Every cell at its own size for one second on the card, correct; skips
without one (run on the card: ``python -m pytest portbench/tests -m cuda``)."""

import pytest
import torch

from portbench import run
from portbench.harness import cell as cells
from portbench.tests import tiny

NAMES = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = run.run(tiny.args(name, seed=2 ** 31 + 11, seconds=1.0))
    assert out["correct"], out["checked"]
    assert out["device"]["platform"] == "gpu"
