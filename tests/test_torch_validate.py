"""The port's validation studies (mpmcxx_tpu_torch/validate/) against the
tools they copy and the JAX package, on the CPU.

- Builders: the PQR texts, run.in templates and state points of
  ``systems.py`` byte for byte the tools' (the tools' ``main`` run with
  their engines stubbed, to read what they would have run).
- Statistics: ``stats.py`` bitwise the tools' functions on every rows
  file in .xc_snapshots/; the VLE reduction of the saved 2 x 256 run
  reproduces the numbers its log printed.
- Short runs against the JAX package, same inputs and seed: the uVT
  studies and NPT per corrtime (E within 1e-6 relative, N and V within
  1e-9); Gibbs VLE at 2 x 32 (every sample's N and V); tempering with 2
  baths (per-bath samples, swap records); warm starts on the mini
  geometry (chain and converged energies within 1e-6 relative).
- Sources: the package and chip_smoke.py import neither jax, the JAX
  package nor tools/; the command line refuses the card without CUDA.
"""

import ast
import dataclasses
import glob
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import jax  # noqa: E402

import flagship as flagship_j  # noqa: E402  (tools/flagship.py)
import gibbs_vle as vle_j  # noqa: E402
import npt_crosscheck as npt_j  # noqa: E402
import ptemp_validate as ptemp_j  # noqa: E402
import uvt_crosscheck as uvt_j  # noqa: E402
import warmstart_study as warm_j  # noqa: E402
from mpmcxx_tpu_torch.validate import (cli, gibbs_vle, npt, ptemp,  # noqa
                                       stats, systems, uvt, warmstart)

SNAPS = os.path.join(ROOT, ".xc_snapshots")
TWO_COLUMN = sorted(p for p in glob.glob(os.path.join(SNAPS, "*.rows.txt"))
                    if not os.path.basename(p).startswith("gibbs"))
VLE_ROWS = os.path.join(SNAPS, "gibbs_vle_256x2_600000_seed4.rows.txt")


class _Stop(Exception):
    """Raised by a stub where a tool would start its engine."""


# --- builders ---------------------------------------------------------------

@pytest.mark.parametrize("n_sorb", [14, 5, 40, 160])
def test_polar_system_pqr_is_the_tools(n_sorb):
    assert systems.polar_system_pqr(n_sorb) == \
        uvt_j._polar_system_pqr(n_sorb)


def test_templates_and_constants_are_the_tools(tmp_path):
    assert systems.dense_argon_pqr() == uvt_j._dense_argon_pqr()
    assert systems.UVT_CONFIG == uvt_j.CONFIG
    assert systems.NPT_CONFIG == npt_j.CONFIG
    for name in ("EPS", "SIG", "MASS", "TSTAR", "T_K", "N_BOX",
                 "RHO_TOTAL", "LIT"):
        assert getattr(systems, name) == getattr(vle_j, name), name
    for n, L, seed in ((497, 32.3, 4), (15, 32.3, 5), (62, 20.1, 4)):
        systems.write_box(str(tmp_path / "t.pqr"), n, L, seed)
        vle_j.write_box(str(tmp_path / "j.pqr"), n, L, seed)
        assert (tmp_path / "t.pqr").read_bytes() == \
            (tmp_path / "j.pqr").read_bytes()


@pytest.mark.parametrize("study,argv", [
    ("uvt-argon", []),
    ("uvt-polar", ["--polar", "--temperature", "250", "--pressure", "30"]),
    ("uvt-cavity", ["--cavity", "--temperature", "180", "--pressure", "60"]),
], ids=["argon", "polar", "cavity"])
def test_uvt_inputs_are_the_tools(study, argv, tmp_path, monkeypatch):
    """uvt_crosscheck.main at the README's state points, its engines
    stubbed: our side's run.in (extra lines, seed, T, P) and boxA.pqr
    equal the port's study."""
    for g in ("_PQR_OVERRIDE", "_OURS_POLAR_MIXED", "_OURS_PQR_OVERRIDE",
              "_OURS_SAVE_RESTART", "_REF_PQR_OVERRIDE", "_SNAP_TAG"):
        monkeypatch.setattr(uvt_j, g, getattr(uvt_j, g))
    seen = {}
    rows = [(float(i), 1.0) for i in range(8)]

    def ours(d, steps, corrtime, seed, pressure, extra="", temperature=0.0):
        uvt_j._write_box(d, ours=True)
        seen.update(seed=seed, extra=extra, run_in=uvt_j.CONFIG.format(
            steps=steps, corrtime=corrtime, seed=seed, pressure=pressure,
            extra=extra, temperature=temperature),
            box=open(os.path.join(d, "boxA.pqr")).read(),
            polar_mixed=uvt_j._OURS_POLAR_MIXED)
        return rows
    monkeypatch.setattr(uvt_j, "run_reference", lambda *a, **k: rows)
    monkeypatch.setattr(uvt_j, "run_ours", ours)
    monkeypatch.setattr(sys, "argv", ["uvt_crosscheck.py", *argv])
    uvt_j.main()
    assert seen["seed"] == uvt.SEED
    assert seen["run_in"] == uvt.run_in(study, 30000, 250, uvt.SEED)
    assert seen["polar_mixed"] == uvt.STUDIES[study]["polar_mixed"]
    uvt.common.write_inputs(str(tmp_path), "", uvt.box_of(study))
    assert (tmp_path / "boxA.pqr").read_text() == seen["box"]


def test_npt_inputs_are_the_tools(monkeypatch):
    seen = {}

    def ours(d, steps, corrtime, seed, pressure, temperature, burn=0.25):
        seen.update(run_in=npt_j.CONFIG.format(
            steps=steps, corrtime=corrtime, seed=seed, pressure=pressure,
            temperature=temperature), seed=seed)
        return {"E": (0.0, 1.0), "V": (0.0, 1.0)}
    monkeypatch.setattr(npt_j, "run_reference", lambda *a, **k: {
        "E": (0.0, 1.0), "V": (0.0, 1.0)})
    monkeypatch.setattr(npt_j, "run_ours", ours)
    monkeypatch.setattr(sys, "argv", ["npt_crosscheck.py"])
    npt_j.main()
    assert seen["seed"] == npt.SEED
    assert seen["run_in"] == npt.run_in(30000, 250, npt.SEED)


@pytest.mark.parametrize("nbox", [128, 32])
def test_vle_inputs_are_the_tools(nbox, tmp_path, monkeypatch):
    """gibbs_vle.main up to its GibbsSimulation: run.in, boxA.pqr and
    boxB.pqr equal the port's study's at the same nbox."""
    import tempfile
    from mpmcxx_tpu.mc import gibbs as gibbs_mod
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = {}

    def stop(*a, **k):
        for f in ("run.in", "boxA.pqr", "boxB.pqr"):
            seen[f] = open(f).read()
        raise _Stop
    monkeypatch.setattr(gibbs_mod, "GibbsSimulation", stop)
    monkeypatch.setattr(sys, "argv", ["gibbs_vle.py", "--nbox", str(nbox),
                                      "--steps", "40000"])
    with pytest.raises(_Stop):
        vle_j.main()
    ours = tmp_path / "ours"
    ours.mkdir()
    with gibbs_vle.common.in_dir(str(ours)):
        gibbs_vle.simulation(nbox, 40000, gibbs_vle.CORRTIME,
                             gibbs_vle.SEED, "cpu")
    for f in ("run.in", "boxA.pqr", "boxB.pqr"):
        assert (ours / f).read_text() == seen[f], f


def test_ptemp_system_is_the_tools(monkeypatch):
    """ptemp_validate.main up to its replica runner: the same 16 atoms in
    the 18 A box, NVT options and the ladder."""
    from mpmcxx_tpu import state as state_j
    from mpmcxx_tpu.parallel import replicas as rep_j
    seen = {}
    build = state_j.build_state

    def capture(atoms, basis, **kw):
        seen["atoms"], seen["basis"] = atoms, np.asarray(basis)
        return build(atoms, basis, **kw)

    def stop(flags, params, opts, swap_every):
        seen.update(params=params, opts=opts, swap_every=swap_every)
        raise _Stop
    monkeypatch.setattr(state_j, "build_state", capture)
    monkeypatch.setattr(rep_j, "make_replica_runner", stop)
    monkeypatch.setattr(sys, "argv", ["ptemp_validate.py"])
    with pytest.raises(_Stop):
        ptemp_j.main()
    ours = systems.ptemp_atoms()
    assert [dataclasses.asdict(a) for a in ours] == \
        [dataclasses.asdict(a) for a in seen["atoms"]]
    np.testing.assert_array_equal(seen["basis"],
                                  np.eye(3) * systems.PTEMP_L)
    _, flags, params, opts = systems.ptemp_system(100.0, "cpu")
    assert seen["swap_every"] == ptemp.SWAP_EVERY
    assert params.temperature == seen["params"].temperature == 100.0
    assert (opts.ensemble, opts.move_factor) == \
        (seen["opts"].ensemble, seen["opts"].move_factor)


# --- statistics --------------------------------------------------------------

@pytest.mark.parametrize("path", TWO_COLUMN, ids=os.path.basename)
def test_stats_are_the_tools_bitwise(path):
    rows = stats.read_rows(path)
    assert len(rows) > 100
    for burn in (0.25, 0.5):
        assert stats.stats_from_rows(rows, burn_frac=burn) == \
            uvt_j.stats_from_rows(rows, burn_frac=burn)
        assert stats.npt_stats_from_rows(rows, burn_frac=burn) == \
            npt_j.stats_from_rows(rows, burn_frac=burn)
    for col in (0, 1):
        x = [r[col] for r in rows]
        assert stats.block_err(x) == ptemp_j.block_err(x)


def test_energy_dat_readers_are_the_tools():
    path = os.path.join(SNAPS, "ref_polar_110K_300k.energy.dat")
    got = stats.parse_energy_dat(path)
    assert len(got) > 100 and got == uvt_j.parse_energy_dat(path)
    assert stats.parse_energy_dat(path, column=10) == \
        npt_j.parse_energy_dat(path)


def test_vle_reduction_reproduces_the_saved_log():
    """gibbs_vle_256x2_r5.log's result line, from its saved rows: rho_l*
    0.7550 +- 0.0024 (2.72 sigma), rho_v* 0.0168 +- 0.0010 (1.22 sigma),
    to the last bit it printed."""
    want = {"rho_l": (0.7549719350121499, 0.002394999280804761,
                      2.7151376517282393),
            "rho_v": (0.016799004750482075, 0.0009939143688396544,
                      1.2220718689307843)}
    dens = stats.vle_densities(np.loadtxt(VLE_ROWS), systems.SIG,
                               gibbs_vle.WARMUP_FRAC)
    for name, (mean, berr, terr, _) in dens.items():
        err = max(berr, terr)
        lit, lit_err = systems.LIT[name]
        nsig = abs(mean - lit) / float(np.hypot(err, lit_err))
        assert (mean, err, nsig) == want[name], name
    assert f"{dens['rho_l'][0]:.4f}" == "0.7550"
    assert f"{dens['rho_v'][0]:.4f}" == "0.0168"


# --- short runs against the JAX package --------------------------------------

@pytest.mark.parametrize("study", ["uvt-argon", "uvt-polar", "uvt-cavity"])
def test_uvt_short_run_matches_jax(study, tmp_path, monkeypatch):
    """2 corrtimes of 100 steps through uvt_crosscheck.run_ours (the JAX
    Simulation) and the port's study on the same input and seed."""
    s = uvt.STUDIES[study]
    box = uvt.box_of(study)
    monkeypatch.setattr(uvt_j, "_PQR_OVERRIDE",
                        None if study == "uvt-argon" else box)
    monkeypatch.setattr(uvt_j, "_OURS_POLAR_MIXED", s["polar_mixed"])
    monkeypatch.setattr(uvt_j, "_SNAP_TAG", None)
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = uvt_j.run_ours(str(tmp_path / "jax"), 200, 100, uvt.SEED,
                          s["pressure"], s["extra"], s["temperature"])
    got, _, _ = uvt.run_rows(study, 200, 100, uvt.SEED, "cpu",
                             str(tmp_path / "torch"))
    assert len(got) == len(want) == 3
    np.testing.assert_allclose([r[0] for r in got], [r[0] for r in want],
                               rtol=1e-6)
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                               rtol=0, atol=1e-9)


def test_npt_short_run_matches_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    npt_j.run_ours(str(tmp_path / "jax"), 200, 100, npt.SEED, npt.PRESSURE,
                   npt.TEMPERATURE)
    want = npt_j.parse_energy_dat(str(tmp_path / "jax" / "g.energy.dat"))
    got, _ = npt.run_rows(200, 100, npt.SEED, "cpu", str(tmp_path / "torch"))
    assert len(got) == len(want) == 3
    np.testing.assert_allclose([r[0] for r in got], [r[0] for r in want],
                               rtol=1e-6)
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                               rtol=1e-9)


def test_gibbs_vle_short_run_matches_jax(tmp_path):
    """2 x 32 atoms, 2 corrtimes of 100 steps: the tool's chunk-and-refresh
    loop on the JAX GibbsSimulation and the port's study give the same
    (N_a, V_a, N_b, V_b) samples."""
    from mpmcxx_tpu.config.parser import read_config as read_config_j
    from mpmcxx_tpu.mc.gibbs import GibbsSimulation as Gibbs_j
    with gibbs_vle.common.in_dir(str(tmp_path)):
        sim, _ = gibbs_vle.simulation(32, 200, 100, gibbs_vle.SEED, "cpu")
        got, _ = gibbs_vle.sample(sim, 2)
        sim_j = Gibbs_j(read_config_j("run.in"), quiet=True)
    carry = sim_j._init_carry()
    want = []
    for _ in range(2):
        carry, _ = sim_j._run_chunk(carry)
        carry = sim_j._refresh(carry)
        want.append((float(np.asarray(carry.state_a.mol_alive).sum()),
                     float(carry.state_a.pbc.volume),
                     float(np.asarray(carry.state_b.mol_alive).sum()),
                     float(carry.state_b.pbc.volume)))
    np.testing.assert_array_equal(np.asarray(got)[:, [0, 2]],
                                  np.asarray(want)[:, [0, 2]])
    np.testing.assert_allclose(np.asarray(got)[:, [1, 3]],
                               np.asarray(want)[:, [1, 3]], rtol=1e-12)


def test_ptemp_short_run_matches_jax(monkeypatch, capsys):
    """ptemp_validate.main with 2 baths and 8 swap chunks, its per-bath
    samples read where it reduces them (block_err), against the port's
    run_chains on the same ladder and seeds."""
    args = dict(steps=400, swap_every=50, baths=2, tmin=140.0, tmax=240.0,
                seed=11)
    seen = []
    orig = ptemp_j.block_err
    monkeypatch.setattr(ptemp_j, "block_err",
                        lambda x, n_blocks=10: (seen.append(np.array(x)),
                                                orig(x, n_blocks))[1])
    monkeypatch.setattr(sys, "argv", ["ptemp_validate.py"] + [
        f"--{k.replace('_', '-')}={v}" for k, v in args.items()])
    ptemp_j.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    from mpmcxx_tpu_torch.parallel import replicas as rep_t
    ladder = np.asarray(rep_t.temperature_ladder(140.0, 240.0, 2))
    pt, swaps, _ = ptemp.run_chains(True, 11, 400, 50, ladder, "cpu")
    ind, _, _ = ptemp.run_chains(False, 12, 400, 50, ladder, "cpu")
    for b in range(2):
        np.testing.assert_allclose(pt[b], seen[2 * b], rtol=1e-12)
        np.testing.assert_allclose(ind[b], seen[2 * b + 1], rtol=1e-12)
    sw = np.asarray(swaps)
    np.testing.assert_allclose(sw[:, 0], seen[4], rtol=1e-12)
    assert len(sw) == line["n_attempts"] == 3
    assert float(sw[:, 1].mean()) == line["swap_measured"]


def test_warmstart_mini_matches_jax(monkeypatch, capsys):
    """warmstart_study.main --mini (cold-4 and warm-4, one 16-move chunk)
    with its chain and truth read as it runs, against the port's study:
    each chain's carried polarization within 1e-6 relative; the tool's
    truth on the f32 planes takes the divergence fallback in both
    packages (the same energy within 1e-6), and the port's float64 truth
    converges to the JAX package's float64 SCF within 1e-6."""
    from mpmcxx_tpu.mc import chain as chain_j
    from mpmcxx_tpu.ops import energy as energy_j
    for name in ("G_FRAME", "N_CO2", "N_SORB"):
        monkeypatch.setattr(flagship_j, name, getattr(flagship_j, name))
    chains, truths = [], []
    make = chain_j.make_chunk_runner
    breakdown = energy_j.energy_breakdown_blocked

    def make_runner(*a, **k):
        run = make(*a, **k)

        def recorded(carry):
            carry, outs = run(carry)
            chains.append((float(carry.obs.polarization_energy),
                           carry.state))
            return carry, outs
        return recorded

    def truth(st, flags, params):
        eb = breakdown(st, flags, params)
        if not isinstance(eb.polarization, jax.core.Tracer):
            # the tool's converged_polar (init_carry's calls are traced)
            truths.append((float(eb.polarization),
                           bool(eb.iterator_failed)))
        return eb
    monkeypatch.setattr(chain_j, "make_chunk_runner", make_runner)
    monkeypatch.setattr(energy_j, "energy_breakdown_blocked", truth)
    monkeypatch.setattr(sys, "argv", [
        "warmstart_study.py", "--mini", "--iters", "4", "--chunks", "1",
        "--chunk-steps", "16"])
    warm_j.main()
    capsys.readouterr()
    assert len(chains) == len(truths) == 2 and all(f for _, f in truths)

    # the tool left flagship_j on the mini geometry (restored at teardown)
    _, _, flags_j, params_j, _ = flagship_j.build_state_co2(
        extra_mol_capacity=8)
    f64_flags_j = flags_j.replace(polar_max_iter=0, polar_warm_start=False,
                                  polar_mixed=False)
    f64_params_j = dataclasses.replace(params_j, polar_precision=1e-12)
    system = warmstart.build(True, "cpu")
    _, _, flags, params, _ = system
    assert system[0].n_atom_slots == 232
    for (e_j, st_j), (t_j, _), (K, warm) in zip(chains, truths,
                                               ((4, False), (4, True))):
        carries = []
        pts = warmstart.run_variant(
            system, K, warm, 1, 16,
            on_chunk=lambda c, fl, p, eb: carries.append(c))
        assert pts[0]["chain"] == pytest.approx(e_j, rel=1e-6)
        assert not pts[0]["failed"] and pts[0]["iterations"] < 128
        f32 = warmstart.converged_polar(carries[0].state, flags, params,
                                        polar_mixed=True)
        assert bool(f32.iterator_failed)
        assert float(f32.polarization) == pytest.approx(t_j, rel=1e-6)
        f64_j = breakdown(st_j.replace(mu=st_j.mu * 0.0), f64_flags_j,
                          f64_params_j)
        assert not bool(f64_j.iterator_failed)
        assert pts[0]["truth"] == pytest.approx(
            float(f64_j.polarization), rel=1e-6)


# --- sources and the command line --------------------------------------------

def _imports(path):
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_no_jax_jax_package_or_tools_imports():
    paths = glob.glob(os.path.join(ROOT, "mpmcxx_tpu_torch", "validate",
                                   "*.py")) + [os.path.join(ROOT,
                                                            "chip_smoke.py")]
    tools = {os.path.splitext(os.path.basename(p))[0]
             for p in glob.glob(os.path.join(ROOT, "tools", "*.py"))}
    assert len(paths) >= 10
    for path in paths:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "mpmcxx_tpu", "tools"), \
                (path, name)
            assert top not in tools, (path, name)
        text = open(path).read()
        assert '"tools"' not in text and "'tools'" not in text, path


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present")
def test_card_without_cuda_exits_2(capsys):
    assert cli.main(["uvt-argon", "--steps", "10"]) == 2
    assert cli.main(["all", "--device", "cuda"]) == 2
    assert capsys.readouterr().out == ""


def test_cli_line_and_exit_code(tmp_path, capsys):
    """One short NPT run through the command line on the CPU: one JSON
    line with every key, the rows file, and exit code 1 on its
    disagreement (2 samples after burn-in cannot agree)."""
    rc = cli.main(["npt", "--device", "cpu", "--steps", "200",
                   "--corrtime", "50", "--rows", str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert rc == (0 if rec["verdict"] == "agree" else 1)
    for k in ("study", "steps", "wall_s", "means", "truths", "sigma",
              "verdict", "device", "card"):
        assert k in rec, k
    for q in ("E", "V"):
        assert set(rec["means"][q]) >= {"mean", "block_err", "tau_err",
                                        "err", "naive_err"}
    assert rec["card"] == "cpu" and rec["steps"] == 200
    rows = np.loadtxt(tmp_path / "npt.rows.txt")
    assert rows.shape == (5, 2)
