"""The port's bench module and flagship builders (mpmcxx_tpu_torch/bench.py,
mpmcxx_tpu_torch/flagship.py) against the JAX side (bench.py,
tools/flagship.py) on the CPU.

- The flagship geometry and constants bitwise tools/flagship.py's, for the
  three models; the builders' SystemState leaves, meta, flags, params,
  opts and topology equal to the JAX builders' (builds only, no energy at
  ~11k slots); the PQR writers byte for byte.
- bench.thole_energy on a small monatomic state cut from the flagship
  geometry within 1e-6 relative of the JAX composition bench.py times
  (mixed_field_coeffs, finish_polar, contract_mixed).
- flagship_run on the small CO2 system (tests/torch_co2_system.py; the
  builder and CHUNK / MEASURE_STEPS patched here): the schedule's moves,
  and a final carry bitwise the chunk runner's own run of them.
- The PIMC start carry against the one bench.py assembles by hand
  (bench.py:200-215), within 1e-12 relative.
- main() with the measurements patched in both benches: one stdout line,
  bench.py's line (metric, keys, rounding) without its TPU record and
  regressions, plus ``device``; the budget's skips named on stderr.
- ``python -m mpmcxx_tpu_torch.bench`` exits non-zero without CUDA; the
  bench and flagship modules import with jax, the JAX package and
  tools/ unimportable."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import torch_co2_system as co2  # noqa: E402  (puts tools/ on the path)
import flagship as flagship_j  # noqa: E402  (tools/flagship.py)
from mpmcxx_tpu.ops import polar as polar_j  # noqa: E402
from mpmcxx_tpu_torch import bench  # noqa: E402
from mpmcxx_tpu_torch import flagship as flagship_t  # noqa: E402
from mpmcxx_tpu_torch.mc import chain as chain_t  # noqa: E402
from mpmcxx_tpu_torch.ops import polar as polar_t  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GEOMETRY = {"co2": ("flagship_co2_molecules", "CO2_SITES",
                    "CO2_EXTRA_SLOTS", "N_TOTAL_CO2"),
            "h2": ("flagship_h2_molecules", "H2_SITES", "H2_EXTRA_SLOTS",
                   "N_TOTAL_H2"),
            "ar": ("flagship_atoms", None, None, "N_TOTAL")}
SHARED = ("L", "G_FRAME", "N_SORB", "TEMPERATURE", "FUGACITY",
          "INSERT_PROB", "EWALD_ALPHA", "POLAR_DAMP", "POLAR_MAX_ITER",
          "MOVE_FACTOR", "FRAME_CHARGE_E", "FRAME_EPS", "FRAME_SIG",
          "FRAME_ALPHA", "FRAME_MASS", "SORB_EPS", "SORB_SIG", "SORB_ALPHA",
          "SORB_MASS", "N_CO2", "CO2_BOND", "N_H2", "H2_BOND", "H2_NOFF")


def _same(a, b):
    """Bitwise equality of nested lists / dicts / tuples of floats and
    numpy arrays."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("model", list(GEOMETRY))
def test_flagship_geometry_and_constants_bitwise(model):
    """The model's framework and sorbate positions, its site table,
    insertion slots and live atoms, and the shared constants, bitwise
    tools/flagship.py's."""
    geom, sites, extra, n_total = GEOMETRY[model]
    _same(getattr(flagship_t, geom)(), getattr(flagship_j, geom)())
    for name in (sites, extra, n_total) + SHARED:
        if name:
            _same(getattr(flagship_t, name), getattr(flagship_j, name))
    if model == "ar":
        sorb = (flagship_j.SORB_MASS, 0.0, flagship_j.SORB_ALPHA,
                flagship_j.SORB_EPS, flagship_j.SORB_SIG)
        assert flagship_t.AR_SITES == (("Ar",) + sorb,)
        assert flagship_t.AR_EXTRA_SLOTS == \
            flagship_j.build_state.__defaults__[0]


@pytest.mark.parametrize("model,build", [
    ("co2", "build_state_co2"), ("h2", "build_state_h2"),
    ("ar", "build_state")])
def test_flagship_build_matches_jax(model, build):
    """The port's builder on the CPU gives every SystemState leaf (the
    box's included), meta, every field of flags, params and opts, and the
    topology equal to tools/flagship.py's JAX builder."""
    sj, mj, fj, pj, oj = getattr(flagship_j, build)()
    st, mt, ft, pt, ot = getattr(flagship_t, build)(device="cpu")
    assert st.pos.device.type == "cpu"
    fields = co2.jax_state_numpy(sj)
    for f in dataclasses.fields(st):
        if f.name != "pbc":
            np.testing.assert_array_equal(getattr(st, f.name).numpy(),
                                          fields[f.name], err_msg=f.name)
    for k, want in fields["pbc"].items():
        np.testing.assert_array_equal(getattr(st.pbc, k).numpy(), want,
                                      err_msg=k)
    assert mt == mj
    for got, want in ((ft, fj), (pt, pj), (ot, oj)):
        for f in dataclasses.fields(want):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for got, want in zip(flagship_t.topology(st), flagship_j.topology(sj)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert flagship_t.build(model, device="cpu")[0].n_atom_slots == \
        st.n_atom_slots


@pytest.mark.parametrize("writer", ["write_pqr", "write_pqr_co2",
                                    "write_pqr_h2"])
def test_write_pqr_byte_equal(writer, tmp_path):
    """The PQR writers' files byte for byte tools/flagship.py's."""
    getattr(flagship_j, writer)(str(tmp_path / "jax.pqr"))
    getattr(flagship_t, writer)(str(tmp_path / "port.pqr"))
    assert (tmp_path / "port.pqr").read_bytes() == \
        (tmp_path / "jax.pqr").read_bytes()


@pytest.fixture
def small_monatomic(monkeypatch):
    """The monatomic flagship's recipe cut to a 4^3 framework and 192
    sorbates (256 atom slots, no insertion slots) in both packages."""
    for mod in (flagship_j, flagship_t):
        monkeypatch.setattr(mod, "G_FRAME", 4)
        monkeypatch.setattr(mod, "N_SORB", 192)
    return (flagship_j.build_state(extra_mol_capacity=0),
            flagship_t.build_state(extra_mol_capacity=0, device="cpu"))


def test_thole_energy_matches_jax(small_monatomic):
    """The Thole solve's energy (bench.thole_energy on the port's
    planes) within 1e-6 relative of bench.py's JAX composition on the same
    state; thole_solve_ms times it and takes all three arguments or
    none."""
    (sj, _, fj, pj, _), (st, _, ft, pt, _) = small_monatomic
    assert st.n_atom_slots == 256
    coeffs, E = polar_j.mixed_field_coeffs(sj, fj, pj)
    want = float(polar_j.finish_polar(
        sj, fj, pj, E,
        lambda m: polar_j.contract_mixed(coeffs, m, l=pj.polar_damp)).energy)
    got = float(bench.thole_energy(st, ft, pt,
                                   *polar_t.mixed_field_coeffs(st, ft, pt)))
    assert want < 0.0
    assert got == pytest.approx(want, rel=1e-6)
    assert bench.thole_solve_ms(st, ft, pt) > 0.0
    with pytest.raises(ValueError, match="all three"):
        bench.thole_solve_ms(st, ft)


def test_flagship_run_matches_chunk_runner(monkeypatch):
    """flagship_run on the small CO2 system runs a warm-up chunk and
    repeats x MEASURE_STEPS moves; its final carry is bitwise the chunk
    runner's own run of the same moves from init_carry(seed=0)."""
    monkeypatch.setattr(flagship_t, "build_state_co2",
                        lambda device="cuda": co2.torch_system(device))
    monkeypatch.setattr(bench, "CHUNK", 4)
    monkeypatch.setattr(bench, "MEASURE_STEPS", 8)
    rates, carry, (flags, params, opts) = bench.flagship_run(
        "co2", repeats=2, device="cpu")
    assert rates["min"] <= rates["median"] <= rates["max"]
    assert rates["min"] > 0.0
    assert int(carry.step) == 4 + 2 * 8

    state, _, flags, params, opts = co2.torch_system("cpu")
    ref = chain_t.init_carry(state, flags, params, opts, seed=0)
    runner = chain_t.make_chunk_runner(flags, params, opts, 4,
                                       topology=flagship_t.topology(state))
    for _ in range(1 + 2 * 8 // 4):
        ref, _ = runner(ref)
    for name in ("pos", "mol_alive", "mu"):
        assert torch.equal(getattr(carry.state, name),
                           getattr(ref.state, name)), name
    for f in dataclasses.fields(ref.obs):
        assert torch.equal(getattr(carry.obs, f.name),
                           getattr(ref.obs, f.name)), f.name
    assert torch.equal(carry.stats.accept, ref.stats.accept)
    assert torch.equal(carry.stats.reject, ref.stats.reject)
    assert torch.equal(carry.key, ref.key)
    assert int(carry.stats.accept.sum() + carry.stats.reject.sum()) == 20


def test_pimc_start_carry_matches_jax_bench():
    """The port's PIMC start carry (mc/pi.init_pi_carry) equals the one
    bench.py assembles by hand for the 8-bead argon dimer, within 1e-12
    relative; the same key, bead stack and counters."""
    from mpmcxx_tpu.config.parser import read_config
    from mpmcxx_tpu.mc import pi as pi_j
    from mpmcxx_tpu.ops import delta as delta_j

    old = os.getcwd()
    os.chdir(bench.PI_EXAMPLE)
    try:
        cfg = read_config("run.in")
        cfg.energy_output = "/dev/null"
        cfg.energy_output_csv = "/dev/null"
        sim = pi_j.PISimulation(cfg, P=8, quiet=True)
    finally:
        os.chdir(old)
    # bench.py:200-215
    comps_pb, _ = pi_j.pi_potential_per_bead(sim.stack, sim.flags,
                                             sim.params)
    comps = jnp.mean(comps_pb, axis=0)
    assert sim.incremental and delta_j.uses_recip(sim.flags)
    sf = pi_j.pi_sf_compute(sim.stack, sim.flags, sim.params)

    port, carry = bench.pimc_start("cpu")
    assert port.P == 8 and int(port.cfg.corrtime) == int(cfg.corrtime)
    np.testing.assert_array_equal(carry.stack.pos.numpy(),
                                  np.asarray(sim.stack.pos))
    for got, want in ((carry.comps_per_bead, comps_pb),
                      (carry.obs_components, comps),
                      (carry.potential_current, jnp.sum(comps)),
                      (carry.sf.re, sf.re), (carry.sf.im, sf.im),
                      (carry.temperature, cfg.temperature)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=0.0)
    np.testing.assert_array_equal(carry.key.numpy().astype(np.uint32),
                                  np.asarray(sim.key))
    assert carry.starter_bead == 0 and int(carry.step) == 0
    assert not carry.accept.any() and not carry.reject.any()
    assert float(carry.bf) == 0.0


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FAKE_RATES = {"co2": {"median": 31.234567, "min": 29.876543,
                      "max": 33.333333},
              "h2": {"median": 27.111149, "min": 25.5, "max": 28.987654},
              "ar": {"median": 40.004999, "min": 38.123456,
                     "max": 41.999999}}


def _fake(mod, monkeypatch, budget):
    """Patch ``mod``'s measurements to fixed numbers; returns the order in
    which they were called."""
    calls = []

    def flagship(model="co2", repeats=3, **kw):
        calls.append(model)
        return dict(FAKE_RATES[model])

    def thole(*a, **kw):
        calls.append("thole")
        return 12.3456

    def pimc(*a, **kw):
        calls.append("pimc")
        return 1234.5678

    monkeypatch.setattr(mod, "flagship_moves_per_sec", flagship)
    monkeypatch.setattr(mod, "thole_solve_ms", thole)
    monkeypatch.setattr(mod, "pimc_sweeps_per_sec", pimc)
    monkeypatch.setattr(mod, "BUDGET_S", budget)
    return calls


@pytest.mark.parametrize("budget", [1e9, -1.0])
def test_main_prints_bench_line(budget, monkeypatch, capsys):
    """main() prints exactly one stdout line: bench.py's line for the
    same measurements (metric string, keys, rounding, the baseline's
    vs_baseline) without its static TPU record, plus ``device``; nothing
    from .bench_expected.json.  The order is CO2, H2, Thole, PIMC,
    monatomic; with the budget spent only CO2 runs, and each skip is
    named on stderr."""
    jb = _jax_bench()
    jax_calls = _fake(jb, monkeypatch, budget)
    monkeypatch.setattr(jb, "wait_for_device", lambda: True)
    monkeypatch.setattr(jb, "check_regressions", lambda result: [])
    monkeypatch.setattr(jb, "_save_last_success", lambda result: None)
    jb.main()
    want = json.loads(capsys.readouterr().out)
    del want["secondary"]["replica_dp_one_chip"]

    calls = _fake(bench, monkeypatch, budget)
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr()
    lines = out.out.splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got.pop("device") == "cpu"
    assert got == want
    assert calls == jax_calls
    with open(os.path.join(ROOT, ".bench_baseline.json")) as f:
        base = json.load(f)
    assert got["vs_baseline"] == round(
        FAKE_RATES["co2"]["median"] / base["flagship_co2_ref_moves_per_sec"],
        1)
    assert "regressions" not in got
    if budget > 0:
        assert calls == ["co2", "h2", "thole", "pimc", "ar"]
    else:
        assert calls == ["co2"]
        for name in ("h2 flagship", "thole", "pimc", "monatomic flagship"):
            assert f"{name}: skipped" in out.err


def _run(code_or_args, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT, **(env_extra or {}))
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_bench_exits_nonzero_without_cuda():
    """The default --device cuda without a CUDA device: a non-zero exit,
    the reason on stderr and no line on stdout."""
    r = _run(["-m", "mpmcxx_tpu_torch.bench"])
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr


@pytest.mark.parametrize("module", ["mpmcxx_tpu_torch.bench",
                                    "mpmcxx_tpu_torch.flagship"])
def test_imports_without_jax_or_tools(module):
    """The module imports with jax, the JAX package and tools/'s
    flagship made unimportable, and loads nothing from tools/."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        "sys.modules['flagship'] = None\n"
        f"import {module}\n"
        "tools = [m for m in sys.modules.values()\n"
        "         if '/tools/' in (getattr(m, '__file__', '') or '')]\n"
        "assert not tools, tools\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
