"""The seven standard-ensemble examples through the JAX package's
``runner.Simulation`` and the port's, on the CPU, at tests/test_examples.py's
QUICK_STEPS (corrtime half of them): gcmc-cavity-argon, gcmc-mof-co2,
gcmc-mof-h2, gcmc-mof-mixture, nvt-argon, npt-argon and nve-argon.

Each example runs once per package: equal accept and reject counts per
move type, energy logs within 1e-6 relative (the polarizable ones step on
f32 SCF planes summed in another order), equal restart, final and
trajectory PQR files; the dipole logs of the polarizable ones within
2e-6 absolute (6 printed decimals of values carrying that f32
difference)."""

import os
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mpmcxx_tpu.config.parser import read_config as read_config_j  # noqa: E402
from mpmcxx_tpu.runner import Simulation as Simulation_j  # noqa: E402
from mpmcxx_tpu_torch.config.parser import \
    read_config as read_config_t  # noqa: E402
from mpmcxx_tpu_torch.runner import Simulation as Simulation_t  # noqa: E402
from test_examples import EXAMPLES, QUICK_STEPS  # noqa: E402

PORTED = ["gcmc-cavity-argon", "gcmc-mof-co2", "gcmc-mof-h2",
          "gcmc-mof-mixture", "nvt-argon", "npt-argon", "nve-argon"]


def _run(name, workdir, read_config, Simulation, **kw):
    n = QUICK_STEPS[name]
    shutil.copytree(os.path.join(EXAMPLES, name), workdir)
    path = os.path.join(workdir, "run.in")
    with open(path) as f:
        text = f.read()
    text = re.sub(r"(?m)^numsteps .*$", f"numsteps {n}", text)
    text = re.sub(r"(?m)^corrtime .*$", f"corrtime {n // 2}", text)
    with open(path, "w") as f:
        f.write(text)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        sim = Simulation(read_config("run.in"), quiet=True, **kw)
        sim.run()
    finally:
        os.chdir(cwd)
    outs = {}
    for fn in sorted(os.listdir(workdir)):
        if fn.endswith((".pqr", ".dat")) and \
                not os.path.exists(os.path.join(EXAMPLES, name, fn)):
            with open(os.path.join(workdir, fn)) as f:
                outs[fn] = f.read()
    return sim, outs


def _rows(text):
    return np.array([[float(x) for x in ln.split()]
                     for ln in text.splitlines() if not ln.startswith("#")])


@pytest.mark.parametrize("name", PORTED)
def test_example_matches_jax(name, tmp_path):
    sj, oj = _run(name, str(tmp_path / "jax"), read_config_j, Simulation_j)
    st, ot = _run(name, str(tmp_path / "torch"), read_config_t,
                  Simulation_t, device="cpu")
    assert not st.opts.blocked_energy
    assert sorted(ot) == sorted(oj)
    acc_t, rej_t = st.carry.stats.accept.numpy(), st.carry.stats.reject.numpy()
    np.testing.assert_array_equal(acc_t, np.asarray(sj.carry.stats.accept))
    np.testing.assert_array_equal(rej_t, np.asarray(sj.carry.stats.reject))
    assert (acc_t + rej_t).sum() == QUICK_STEPS[name] and acc_t.sum() > 0
    energy = st.cfg.energy_output
    ej, et = _rows(oj[energy]), _rows(ot[energy])
    assert et.shape == ej.shape and et.shape[0] == 3
    np.testing.assert_allclose(et, ej, rtol=1e-6, atol=1e-6)
    pqrs = [fn for fn in ot if fn.endswith(".pqr")]
    assert len(pqrs) == 3
    for fn in pqrs:
        assert ot[fn] == oj[fn], fn
    if st.cfg.polarization:
        dip = st.cfg.dipole_output
        np.testing.assert_allclose(_rows(ot[dip]), _rows(oj[dip]), rtol=0,
                                   atol=2e-6)
    if st.sorbates is not None:
        assert [s.id for s in st.sorbates.stats] == \
            [s.id for s in sj.sorbates.stats]
        for s_t, s_j in zip(st.sorbates.stats, sj.sorbates.stats):
            assert s_t.mean == pytest.approx(s_j.mean, rel=1e-12)
