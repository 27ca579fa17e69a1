"""The secondary output surfaces through the port's command line on the
CPU (``--device cpu``), diffed against the files the reference binary
wrote on identical runs (tests/golden/io_surfaces/, made by
tools/io_parity.py --save-golden): the ``plain`` NVT argon lattice's
population histogram, and the ``polar`` framework + sorbates run's
dipole and field logs, frozen-lattice OpenDX file and histogram (an NVT
run on the dense float64 SCF).  ``move_factor 0`` keeps the configuration
fixed, so the files do not depend on the random stream.  Lines must be
equal, or equal in every number to the %f print quantum
(io_parity.diff_file's 2e-6)."""

import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mpmcxx_tpu_torch import cli  # noqa: E402
from tools import io_parity  # noqa: E402


@pytest.mark.parametrize("scenario", list(io_parity.SCENARIOS))
def test_io_surfaces_match_reference_through_cli(scenario, tmp_path):
    sc = io_parity.SCENARIOS[scenario]
    gold = os.path.join(io_parity.GOLDEN_DIR, scenario)
    (tmp_path / "boxA.pqr").write_text(io_parity._scenario_pqr(scenario))
    (tmp_path / "run.in").write_text(io_parity.CONFIG.format(
        steps=sc["steps"], corrtime=sc["corrtime"], seed=7,
        extra=sc["extra"]))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc, sim = cli.run(["--device", "cpu", "--quiet", "run.in"])
    finally:
        os.chdir(cwd)
    assert rc == 0 and sim.cfg.calc_hist
    assert sim.carry.pcache is None and not sim.opts.blocked_energy
    for fn in sc["files"]:
        assert io_parity.diff_file(fn, gold, str(tmp_path)), fn
