"""The nine examples through the JAX package and the port on the CPU, at
tests/test_examples.py's QUICK_STEPS (corrtime half of them): the seven
standard-ensemble ones (gcmc-cavity-argon, gcmc-mof-co2, gcmc-mof-h2,
gcmc-mof-mixture, nvt-argon, npt-argon, nve-argon) through each package's
``runner.Simulation``, and gibbs-argon and pi-argon-dimer (P = 8) through
each package's ``run_input_file``.

Each example runs once per package: equal accept and reject counts per
move type, energy logs within 1e-6 relative (the polarizable ones step on
f32 SCF planes summed in another order; per box for Gibbs), equal
restart, final and trajectory PQR files (per box for Gibbs, per bead for
PI); the dipole logs of the polarizable ones within 2e-6 absolute (6
printed decimals of values carrying that f32 difference).  The port's
CLI with ``-P 8 -xyz`` on pi-argon-dimer writes JAX's frames file."""

import os
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import mpmcxx_tpu.runner as runner_j  # noqa: E402
import mpmcxx_tpu_torch.runner as runner_t  # noqa: E402
from mpmcxx_tpu.config.parser import read_config as read_config_j  # noqa: E402
from mpmcxx_tpu.io.pqr import drain as drain_j  # noqa: E402
from mpmcxx_tpu.mc.gibbs import GibbsSimulation as Gibbs_j  # noqa: E402
from mpmcxx_tpu.mc.pi import PISimulation as PI_j  # noqa: E402
from mpmcxx_tpu_torch.config.parser import \
    read_config as read_config_t  # noqa: E402
from mpmcxx_tpu_torch.mc.gibbs import GibbsSimulation as Gibbs_t  # noqa: E402
from mpmcxx_tpu_torch.mc.pi import PISimulation as PI_t  # noqa: E402
from test_examples import EXAMPLES, QUICK_STEPS  # noqa: E402

PORTED = ["gcmc-cavity-argon", "gcmc-mof-co2", "gcmc-mof-h2",
          "gcmc-mof-mixture", "nvt-argon", "npt-argon", "nve-argon",
          "gibbs-argon", "pi-argon-dimer"]
# the examples whose simulations run_input_file picks (P = 8: its default)
DISPATCHED = {"gibbs-argon": (Gibbs_j, Gibbs_t),
              "pi-argon-dimer": (PI_j, PI_t)}


def _copy(name, workdir):
    n = QUICK_STEPS[name]
    shutil.copytree(os.path.join(EXAMPLES, name), workdir)
    path = os.path.join(workdir, "run.in")
    with open(path) as f:
        text = f.read()
    text = re.sub(r"(?m)^numsteps .*$", f"numsteps {n}", text)
    text = re.sub(r"(?m)^corrtime .*$", f"corrtime {n // 2}", text)
    with open(path, "w") as f:
        f.write(text)


def _run(name, workdir, pkg, monkeypatch):
    """Run the example in ``workdir`` through package ``pkg`` ("jax" or
    "torch"); returns (the simulation, {output file: text})."""
    _copy(name, workdir)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        if name in DISPATCHED:
            cls = DISPATCHED[name][pkg == "torch"]
            made = []
            run = cls.run

            def capture(self):
                made.append(self)
                return run(self)
            monkeypatch.setattr(cls, "run", capture)
            if pkg == "jax":
                runner_j.run_input_file("run.in", quiet=True)
                # the JAX GibbsSimulation leaves its finals on the native
                # writer's queue
                drain_j()
            else:
                runner_t.run_input_file("run.in", quiet=True, device="cpu")
            sim = made[0]
        elif pkg == "jax":
            sim = runner_j.Simulation(read_config_j("run.in"), quiet=True)
            sim.run()
        else:
            sim = runner_t.Simulation(read_config_t("run.in"), quiet=True,
                                      device="cpu")
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


def _counts(sim):
    """(accept, reject) per move type: the standard chain keeps them in
    its NodeStats, the Gibbs and PI carries beside their states."""
    stats = getattr(sim.carry, "stats", sim.carry)
    return np.asarray(stats.accept), np.asarray(stats.reject)


@pytest.mark.parametrize("name", PORTED)
def test_example_matches_jax(name, tmp_path, monkeypatch):
    sj, oj = _run(name, str(tmp_path / "jax"), "jax", monkeypatch)
    st, ot = _run(name, str(tmp_path / "torch"), "torch", monkeypatch)
    assert not getattr(st.opts, "blocked_energy", False)
    assert sorted(ot) == sorted(oj)
    (acc_t, rej_t), (acc_j, rej_j) = _counts(st), _counts(sj)
    np.testing.assert_array_equal(acc_t, acc_j)
    np.testing.assert_array_equal(rej_t, rej_j)
    assert (acc_t + rej_t).sum() == QUICK_STEPS[name] and acc_t.sum() > 0
    energies = [fn for fn in ot if fn.endswith(".dat") and "energy" in fn]
    assert len(energies) == (2 if name == "gibbs-argon" else 1)
    for energy in energies:
        ej, et = _rows(oj[energy]), _rows(ot[energy])
        assert et.shape == ej.shape and et.shape[0] == 3
        np.testing.assert_allclose(et, ej, rtol=1e-6, atol=1e-6)
    pqrs = [fn for fn in ot if fn.endswith(".pqr")]
    assert len(pqrs) == {"gibbs-argon": 2, "pi-argon-dimer": 16}.get(name, 3)
    for fn in pqrs:
        assert ot[fn] == oj[fn], fn
    if st.cfg.polarization:
        dip = st.cfg.dipole_output
        np.testing.assert_allclose(_rows(ot[dip]), _rows(oj[dip]), rtol=0,
                                   atol=2e-6)
    if getattr(st, "sorbates", None) is not None:
        assert [s.id for s in st.sorbates.stats] == \
            [s.id for s in sj.sorbates.stats]
        for s_t, s_j in zip(st.sorbates.stats, sj.sorbates.stats):
            assert s_t.mean == pytest.approx(s_j.mean, rel=1e-12)


def test_pi_cli_frames_match_jax(tmp_path):
    """``-P 8 -xyz frames.xyz`` on pi-argon-dimer through both CLIs: the
    same frames file (8 beads x 2 atoms per frame)."""
    from mpmcxx_tpu import cli as cli_j
    from mpmcxx_tpu_torch import cli as cli_t
    name = "pi-argon-dimer"
    frames = {}
    for pkg, main in (("jax", cli_j.main), ("torch", cli_t.main)):
        d = str(tmp_path / pkg)
        _copy(name, d)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            args = ["-P", "8", "-xyz", "frames.xyz", "--quiet", "run.in"]
            assert main(args if pkg == "jax" else
                        ["--device", "cpu"] + args) == 0
            with open("frames.xyz") as f:
                frames[pkg] = f.read()
        finally:
            os.chdir(cwd)
    assert frames["torch"] == frames["jax"]
    lines = frames["torch"].splitlines()
    assert lines[0] == "16" and lines[1] == "Frame: 1"
    assert len(lines) == 2 * 18
