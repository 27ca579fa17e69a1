"""The port's front end (config parser and validation, fugacities, PQR
reader/writer, startup echo) against the JAX package's on the same
inputs.  Host-side Python in both packages: equality is exact, except the
fugacities (1e-12 relative, numpy in both)."""

import dataclasses
import glob
import io
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mpmcxx_tpu.config import parser as parser_j  # noqa: E402
from mpmcxx_tpu.config import validate as validate_j  # noqa: E402
from mpmcxx_tpu.io import pqr as pqr_j  # noqa: E402
from mpmcxx_tpu.mc import fugacity as fug_j  # noqa: E402
from mpmcxx_tpu.state import build_state as build_state_j  # noqa: E402
from mpmcxx_tpu_torch import constants as const  # noqa: E402
from mpmcxx_tpu_torch.config import parser as parser_t  # noqa: E402
from mpmcxx_tpu_torch.config import validate as validate_t  # noqa: E402
from mpmcxx_tpu_torch.io import pqr as pqr_t  # noqa: E402
from mpmcxx_tpu_torch.mc import fugacity as fug_t  # noqa: E402
from mpmcxx_tpu_torch.state import build_state as build_state_t  # noqa: E402
from test_validate import ERROR_TABLE  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*", "run.in")))
MOF_CO2 = os.path.join(REPO, "examples", "gcmc-mof-co2", "mof_co2.pqr")


def _validated(validate, cfg):
    # a pi_nvt input wants a Trotter number (-P) >= 4
    n = 4 if cfg.ensemble == const.ENSEMBLE_PATH_INTEGRAL_NVT else 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return validate(cfg, n_systems=n)


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[p.split(os.sep)[-2] for p in EXAMPLES])
def test_example_config_matches_jax(path):
    cj = parser_j.read_config(path)
    ct = parser_t.read_config(path)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    cj, ct = _validated(validate_j.validate, cj), \
        _validated(validate_t.validate, ct)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert dataclasses.asdict(ct.to_flags()) == \
        dataclasses.asdict(cj.to_flags())
    assert dataclasses.asdict(ct.to_params()) == \
        dataclasses.asdict(cj.to_params())


@pytest.mark.parametrize(
    "extra,base", [(e, b) for e, b, _, _ in ERROR_TABLE],
    ids=[f"{m[:40]}@{anchor}" for _, _, m, anchor in ERROR_TABLE])
def test_validate_error_matches_jax(extra, base):
    msgs = []
    for parser, validate in ((parser_j, validate_j), (parser_t, validate_t)):
        with pytest.raises(parser.ConfigError) as e:
            _validated(validate.validate, parser.parse_config(base + extra))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


@pytest.mark.parametrize("fn,args", [
    ("h2_fugacity", (77.0, 1.0)), ("h2_fugacity", (77.0, 100.0)),
    ("h2_fugacity", (298.0, 100.0)), ("co2_fugacity", (298.0, 50.0)),
    ("co2_fugacity", (298.0, 1.0)), ("ch4_fugacity", (298.0, 50.0)),
    ("n2_fugacity", (78.0, 0.5)), ("pr_fugacity", ("ch4", 298.0, 50.0))])
def test_fugacity_matches_jax(fn, args):
    want = getattr(fug_j, fn)(*args)
    assert getattr(fug_t, fn)(*args) == pytest.approx(want, rel=1e-12)


def test_read_pqr_matches_jax(tmp_path):
    rj = pqr_j.read_pqr(MOF_CO2, scale_charge=0.5)
    rt = pqr_t.read_pqr(MOF_CO2, scale_charge=0.5)
    assert len(rt) == len(rj) == 117
    assert [dataclasses.asdict(a) for a in rt] == \
        [dataclasses.asdict(a) for a in rj]
    p = tmp_path / "box.pqr"
    p.write_text("".join(
        f"REMARK BOX BASIS[{i}] = {r[0]} {r[1]} {r[2]}\n"
        for i, r in enumerate(np.eye(3) * 24.0 + 0.5)) + "END\n")
    np.testing.assert_array_equal(pqr_t.read_pqr_box(str(p)),
                                  pqr_j.read_pqr_box(str(p)))
    assert pqr_t.read_pqr_box(MOF_CO2) is None


@pytest.mark.parametrize("wrapall", [True, False])
def test_write_state_pqr_byte_equal(tmp_path, wrapall):
    basis = np.eye(3) * 24.0
    sj, mj = build_state_j(pqr_j.read_pqr(MOF_CO2), basis,
                           extra_mol_capacity=4)
    st, mt = build_state_t(pqr_t.read_pqr(MOF_CO2), basis,
                           extra_mol_capacity=4, device="cpu")
    # move one molecule out of the cell so the COM wrap has work to do
    shift = np.zeros_like(np.asarray(sj.pos))
    shift[np.asarray(sj.mol_id) == 3] = [30.0, -13.0, 0.5]
    sj = sj.replace(pos=sj.pos + shift)
    st = st.replace(pos=st.pos + torch.from_numpy(shift))
    pj, pt = tmp_path / "jax.pqr", tmp_path / "torch.pqr"
    pqr_j.write_state_pqr(str(pj), sj, mj, wrapall=wrapall)
    pqr_j.drain()
    pqr_t.write_state_pqr(str(pt), st, mt, wrapall=wrapall)
    pqr_t.drain()
    assert pt.read_bytes() == pj.read_bytes()


# golden -> (example, the PQR written beside its run.in: the example's
# own file, or a one-line stand-in of tests/test_sim_control_echo.py, the
# fixtures' capture), the number of systems the echo reports
ECHO_CASES = {
    "gcmc_mof_co2": ("gcmc-mof-co2", "mof_co2.pqr", None, 1),
    "npt_argon": ("npt-argon", "argon.pqr", "AR_LINE", 1),
    "gcmc_mof_h2": ("gcmc-mof-h2", "mof_h2.pqr", "H2_LINE", 1),
    "gcmc_mof_mixture": ("gcmc-mof-mixture", "mof_mix.pqr", None, 1),
    "gibbs_argon": ("gibbs-argon", "boxA.pqr boxB.pqr", "AR_LINE", 2),
    "pi_argon_dimer": ("pi-argon-dimer", "dimer.pqr", None, 4),
}


@pytest.mark.parametrize("golden", list(ECHO_CASES))
def test_sim_control_echo_matches_golden(golden, tmp_path, monkeypatch):
    """The port's startup echo of each example equals the reference
    binary's (tests/golden/sim_control/<golden>.txt, the fixtures of
    tests/test_sim_control_echo.py), with the simulation each ensemble
    builds (Simulation, GibbsSimulation, PISimulation with P = 4) on the
    fixtures' inputs.  The CO2 example keeps its own PQR and the runner
    sizes its headroom so the system takes the blocked path (> 1024
    slots)."""
    import test_sim_control_echo as echo_j
    from mpmcxx_tpu_torch.io.output import display_sim_control
    from mpmcxx_tpu_torch.mc.gibbs import GibbsSimulation
    from mpmcxx_tpu_torch.mc.pi import PISimulation
    from mpmcxx_tpu_torch.runner import Simulation
    example, pqrs, line, n_systems = ECHO_CASES[golden]
    monkeypatch.chdir(tmp_path)
    src = os.path.join(REPO, "examples", example)
    with open(os.path.join(src, "run.in")) as f:
        run_in = f.read()
    if golden == "pi_argon_dimer":
        run_in = run_in.replace("numsteps 3000", "numsteps 2").replace(
            "corrtime 300", "corrtime 1")
    (tmp_path / "run.in").write_text(run_in)
    for name in pqrs.split():
        if line is None:
            with open(os.path.join(src, name)) as f:
                (tmp_path / name).write_text(f.read())
        else:
            (tmp_path / name).write_text(getattr(echo_j, line))
    cfg = parser_t.read_config("run.in")
    if golden == "gcmc_mof_co2":
        sim = Simulation(cfg, quiet=True, uvt_capacity_factor=20.0,
                         device="cpu")
        assert sim.state.n_atom_slots > 1024
    elif golden == "gibbs_argon":
        sim = GibbsSimulation(cfg, quiet=True, device="cpu")
    elif golden == "pi_argon_dimer":
        sim = PISimulation(cfg, P=4, quiet=True, device="cpu")
    else:
        sim = Simulation(cfg, quiet=True, device="cpu")
    buf = io.StringIO()
    buf.write("SIM_CONTROL: running parameters found in: run.in\n")
    buf.write("SIM_CONTROL: Finished reading config file.\n")
    display_sim_control(sim.cfg, out=buf, n_systems=n_systems)
    with open(os.path.join(HERE, "golden", "sim_control",
                           f"{golden}.txt")) as f:
        assert buf.getvalue().splitlines() == f.read().splitlines()
