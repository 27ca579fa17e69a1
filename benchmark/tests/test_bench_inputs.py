"""The generator's lattice start: every configuration's molecules, with
no overlap, the same from the same seed; the run.in carries the cell's
keys."""

import numpy as np
import pytest

from benchmark.inputs import geometry
from benchmark.inputs.runin import OUTPUTS, run_in
from benchmark.manifest import Manifest

MAN = Manifest()
CONFIGS = [c["name"] for c in MAN.data["configs"]]


def _least_distance(mols, L):
    """The least min-image distance between sites of two molecules."""
    x = mols.reshape(-1, 3)
    mid = np.repeat(np.arange(len(mols)), mols.shape[1])
    best = np.inf
    for i0 in range(0, len(x), 1024):
        d = x[i0:i0 + 1024, None] - x[None]
        d -= L * np.round(d / L)
        r = np.sqrt((d * d).sum(-1))
        r[mid[i0:i0 + 1024, None] == mid[None]] = np.inf
        best = min(best, r.min())
    return best


@pytest.mark.parametrize("name", CONFIGS)
def test_lattice_start_has_no_overlap(name):
    cfg = MAN.config(name)
    mols = geometry.molecules(cfg["model"], cfg["geometry"])
    S = len(cfg["model"]["sites"])
    assert mols.shape == (cfg["geometry"]["molecules"], S, 3)
    L = cfg["geometry"]["box"]
    assert np.all(np.abs(mols) < L / 2 + 2.0)
    sigma = max(s["sigma"] for s in cfg["model"]["sites"])
    # every pair of sites of two molecules sits beyond the widest sigma
    assert _least_distance(mols, L) > 1.2 * sigma


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_is_fixed_by_its_seed(name, tmp_path):
    cfg = MAN.config(name)
    a = geometry.molecules(cfg["model"], cfg["geometry"])
    b = geometry.molecules(cfg["model"], dict(cfg["geometry"]))
    assert np.array_equal(a, b)
    other = dict(cfg["geometry"], seed=2 ** 31 + 12345)
    c = geometry.molecules(cfg["model"], other)
    assert c.shape == a.shape and not np.array_equal(a, c)
    # the written charges are the model's, and each molecule is neutral
    path = tmp_path / "x.pqr"
    geometry.write_pqr(str(path), cfg["model"], a)
    rows = [ln.split() for ln in path.read_text().splitlines()
            if ln.startswith("ATOM")]
    assert len(rows) == a.shape[0] * a.shape[1]
    q = np.asarray([float(r[10]) for r in rows]).reshape(a.shape[:2])
    assert np.allclose(q.sum(axis=1), 0.0, atol=1e-12)


def test_run_in_holds_the_cell_keys():
    text = run_in(MAN.config("h2-bssp-77k"), MAN.traffic("precise"),
                  2 ** 33 + 1, "/x/input.pqr")
    keys = dict(line.split(" ", 1) for line in text.splitlines())
    assert keys["seed"] == str(2 ** 33 + 1)
    assert keys["polar_precision"] == "1e-05" and keys["polar_palmo"] == "on"
    assert keys["corrtime"] == "64" and keys["basis2"] == "0 74.8 0"
    assert keys["h2_fugacity"] == "on" and keys["pressure"] == "50.0"
    assert all(keys[k] == "/dev/null" for k in OUTPUTS)
