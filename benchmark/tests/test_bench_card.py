"""On the card (marked ``gpu``; each test skips without CUDA): a short run
of every cell at its own size is correct and its control is not.  Run
there with ``python -m pytest benchmark/tests -m gpu -q``."""

import pytest

from benchmark import harness
from benchmark.manifest import Manifest

CELLS = [w["name"] for w in Manifest().data["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = harness.run_cell(cell, 2 ** 31 + 11, 5.0, False, control=True)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["moves_per_s"]["value"] > 0.0
    assert any(not v["value"] <= v["limit"]
               for v in res["control"].values()), res["control"]
