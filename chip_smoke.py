#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on one NVIDIA GPU, through
its hand-written kernels, and check the results.

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the
   card's ``nvidia-smi`` name and power limit.
2. Builds the kernels from ``mpmcxx_tpu_torch/csrc`` (nvcc, sm_90a) and
   prints the build time and ptxas report.
3. The CO2 flagship (tools/flagship.py, 10,112 live atoms, 11,264 slots),
   with the contraction-schedule variables unset: K1 ``contract_planes``
   against its plain PyTorch version in plane modes 3, 4 and 5 on the
   flagship's own planes, on seeded symmetric planes and on seeded planes
   with no symmetry (B1 contract_pallas's input) at A = 4,096 (relative
   error <= 1e-5); K2 ``write_plane_strips`` bitwise on copies
   of a flagship plane at window starts 0, mid-plane and A - S with
   all-valid and partly valid windows.  Then its main path:
   ``init_carry(seed=0)`` and two 64-move chunks of
   ``make_chunk_runner``, checking the initial rd / coulombic /
   polarization within 2e-6 (relative) of the reference binary's single
   point (tests/golden/flagship_co2_singlepoint.json); finite energies;
   incremental rd / coulombic within 1e-8 and polarization within 1e-5
   of a fresh ``energy_breakdown_blocked``; the committed planes within
   1e-6 of a fresh ``cache_init``; K1 >= 4 and K2 >= 1 launches per move,
   K2 with S = 3 rows, K4 none.
4. K1 and K2 as in step 3 at the shapes of step 5's run (the runner's
   19,712 atom slots, K1 in mode 3); K3 ``occupancy`` bitwise on the 24^3
   cavity grid against the atoms, on 51,200 seeded darts against that
   grid's open points, and on points with atoms at r (1 +- 1e-12).
5. The cavity-biased CO2 flagship as a user runs it, through the port's
   command line (``mpmcxx_tpu_torch.cli``) in a temporary directory: a
   ``run.in`` with cavity bias on (24^3 grid, radius 2.6 A) and the
   flagship's PQR, 128 uVT moves in two corrtimes.  Checks: exit code 0;
   the energy log's initial energies within 2e-6 of the golden; before
   each corrtime refresh, incremental energies against the refresh's full
   recompute as in step 3; 0 < cavity mean < 1 and two checkpoints; the
   energy log's rows 0, 64, 128; the restart PQR holding 512 + 3 N atoms;
   K1 >= 4, K2 >= 1 and K3 >= 2 launches per move, K4 none.
6. The H2 flagship (2,000 5-site H2, 10,752 slots): K4
   ``contract_planes_tri`` against the plain version in modes 3, 4 and 5
   on its planes and on seeded symmetric planes at the ragged A = 4,000
   (relative error <= 1e-5; two launches on one input bitwise equal),
   with K1's time and GB/s on the same planes beside K4's.  Then, with
   ``MPMCXX_TRI_KERNEL=1`` (restored afterwards), its main path as in
   step 3 against tests/golden/flagship_h2_singlepoint.json: K4 >= 4
   launches per move, K1 none (the recompute included), K2 with S = 5.
7. The monatomic flagship (9,728 sorbates, 10,752 slots): K1 in mode 3
   on its planes as in step 3, then, with ``MPMCXX_SYM_KERNEL=0`` (the
   JAX package's full-plane contract_pallas schedule), its main path as
   in step 3 (no golden exists): K1 >= 4 launches per move, K4 none, K2
   with S = 1.
8. Prints ``{"kernels": [...]}`` (per kernel: the sum over the main paths
   of steps 3, 5, 6 and 7 of its launches, each path counted from 0, and
   the count of each path; the time, plain time and bound at the shapes
   of step 4 for K1-K3 and step 6 for K4; the worst error of the checks),
   the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.  Any failure raises: non-zero exit,
   no result line.

Imports torch, numpy and the port only (never jax).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

CHUNK = 64
CAV_GRID = 24
CAV_RADIUS = 2.6
CLI_SLOTS = 19712        # 512 + 3 x (3,200 live + 3,200 dead) CO2 slots
CLI_DARTS = 51200        # volume / 10 (src/System.Cavity.cpp:131)
RUN_IN = f"""job_name flagship_cav
ensemble uvt
temperature 150.0
pressure 1.0
insert_probability 0.2
move_factor 0.5
numsteps {2 * CHUNK}
corrtime {CHUNK}
seed 0
polarization on
polar_iterative on
polar_ewald on
polar_mixed on
polar_max_iter 4
polar_damp_type exponential
polar_damp 2.1304
cavity_bias on
cavity_grid {CAV_GRID}
cavity_radius {CAV_RADIUS}
pqr_input flagship_co2.pqr
basis1 80 0 0
basis2 0 80 0
basis3 0 0 80
"""
K1_REL_TOL = 1e-5        # f32 sums of ~1e4 terms in another order
SYNTH_A = 4096
TRI_SYNTH_A = 4000       # not a multiple of K4's 64-row tile
TIMING_REPS = 10
SCHEDULE_VARS = ("MPMCXX_SYM_KERNEL", "MPMCXX_TRI_KERNEL")
# The card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): memory
# 3.35 TB/s; f32 and f64 outside the tensor cores 67 and 34 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# f32 operations per plane entry of the contraction, counted from the
# kernels' code: mode 3's coefficient recompute (27, with expf and rsqrtf
# one each) once per entry, then 18 per direction (d . mu 5, s 1, s d +
# cd mu 12); the triangle takes both directions from one entry
COEFF_OPS = {3: 27, 4: 0, 5: 0}
DIRECTION_OPS = 18
# f64 operations per point-atom test of K3: three differences, three
# squares, two adds, one compare
OCCUPANCY_OPS = 9


def _say(msg):
    print(msg, flush=True)


def _time_ms(fn, reps=TIMING_REPS):
    """Mean device ms of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``nbytes`` over the memory rate and ``ops`` over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _contract_bound(A, mode, elements, directions):
    """Bound of ``-T mu`` that reads ``elements`` entries of each of the
    ``mode`` f32 planes once (the tile triangle of symmetric planes, A^2
    of planes with no symmetry), taking ``directions`` sums from each, and
    mu [3,A] f32, and writes [A,3] f32."""
    nbytes = mode * elements * 4 + 2 * 3 * A * 4
    ops = elements * (COEFF_OPS[mode] + directions * DIRECTION_OPS)
    return _bound(nbytes, ops, F32_OPS_PER_S)


@contextlib.contextmanager
def schedule(**env):
    """Run with the contraction-schedule variables set as given (a value)
    or unset (left out), then restore them."""
    old = {k: os.environ.get(k) for k in SCHEDULE_VARS}
    try:
        for k in SCHEDULE_VARS:
            if env.get(k) is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = env[k]
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _wrappers():
    from mpmcxx_tpu_torch.ops import cuda_cavity, cuda_polar
    return {"contract_planes": cuda_polar.contract_planes,
            "contract_planes_tri": cuda_polar.contract_planes_tri,
            "write_plane_strips": cuda_polar.write_plane_strips,
            "occupancy": cuda_cavity.occupancy}


def zero_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def launches_now():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _rel(got, want):
    import torch
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


GOLDEN = {"co2": "flagship_co2_singlepoint.json",
          "h2": "flagship_h2_singlepoint.json"}


def flagship_sorbates(model):
    """(framework, [N, S, 3] sorbate positions, site table, moleculetype,
    dead insertion slots) of a flagship model, from tools/flagship.py's
    numpy geometry and constants (those of its build_state_co2,
    build_state_h2 and build_state)."""
    import flagship
    if model == "co2":
        framework, mols = flagship.flagship_co2_molecules()
        return (framework, mols, flagship.CO2_SITES, "CO2",
                flagship.CO2_EXTRA_SLOTS)
    if model == "h2":
        framework, mols = flagship.flagship_h2_molecules()
        return (framework, mols, flagship.H2_SITES, "H2",
                flagship.H2_EXTRA_SLOTS)
    if model != "ar":
        raise ValueError(f"no flagship model {model!r}")
    framework, sorbates = flagship.flagship_atoms()
    mols = np.array([[[a["x"], a["y"], a["z"]]] for a in sorbates])
    sites = (("Ar", flagship.SORB_MASS, 0.0, flagship.SORB_ALPHA,
              flagship.SORB_EPS, flagship.SORB_SIG),)
    return framework, mols, sites, "ARG", 512    # build_state's default


def build_flagship(model, device):
    """A flagship state and (flags, params, opts) built with the port:
    ``model`` "co2" (3,200 3-site CO2, 11,264 slots), "h2" (2,000 5-site
    H2, 10,752 slots) or "ar" (9,728 monatomic sorbates, 10,752 slots), as
    tools/flagship.py's build_state_co2, build_state_h2 and build_state
    make them for the JAX package."""
    import flagship
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.flags import FFlags, RunParams
    from mpmcxx_tpu_torch.mc.chain import MCOptions
    from mpmcxx_tpu_torch.state import AtomRecord, build_state

    framework, mols, sites, moltype, extra = flagship_sorbates(model)
    atoms = [AtomRecord(
        "Fw", "MOF", 1, frozen=True, x=a["x"], y=a["y"], z=a["z"],
        mass=flagship.FRAME_MASS, charge=a["q"] * const.E2REDUCED,
        epsilon=flagship.FRAME_EPS, sigma=flagship.FRAME_SIG,
        polarizability=flagship.FRAME_ALPHA) for a in framework]
    for m in range(len(mols)):
        for site, (at, mass, q, al, eps, sig) in enumerate(sites):
            p = mols[m, site]
            atoms.append(AtomRecord(
                at, moltype, 100 + m, x=p[0], y=p[1], z=p[2], mass=mass,
                charge=q * const.E2REDUCED, epsilon=eps, sigma=sig,
                polarizability=al))
    state, meta = build_state(atoms, np.eye(3) * flagship.L,
                              extra_mol_capacity=extra, device=device)
    flags = FFlags(polarization=True, polar_iterative=True, polar_ewald=True,
                   polar_mixed=True, polar_max_iter=flagship.POLAR_MAX_ITER,
                   damp_type=const.DAMPING_EXPONENTIAL)
    params = RunParams(temperature=flagship.TEMPERATURE,
                       ewald_alpha=flagship.EWALD_ALPHA,
                       polar_ewald_alpha=flagship.EWALD_ALPHA,
                       polar_damp=flagship.POLAR_DAMP, polar_gamma=1.0)
    opts = MCOptions(
        ensemble=const.ENSEMBLE_UVT, move_factor=flagship.MOVE_FACTOR,
        insert_probability=flagship.INSERT_PROB, fugacity=flagship.FUGACITY,
        incremental=True, polar_incremental=True, max_mol_atoms=len(sites),
        blocked_energy=True)
    return state, meta, flags, params, opts


def _synthetic_planes(A, mode, seed, device):
    """Seeded symmetric/antisymmetric f32 planes of one plane mode; mode 3
    displacements span the physical 1-12 A range."""
    import torch
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device)

    def antisym():
        m = rng.standard_normal((A, A), dtype=np.float32)
        return (m - m.T) / 2

    if mode == 3:
        d = np.stack([antisym() for _ in range(3)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-30
        r = rng.uniform(1.0, 12.0, (A, A)).astype(np.float32)
        d *= ((r + r.T) / 2)[..., None]
        return tuple(t(d[..., i]) for i in range(3))
    co = rng.standard_normal((A, A), dtype=np.float32) * 0.01
    co = (co + co.T) / 2
    cd = rng.standard_normal((A, A), dtype=np.float32) * 0.02
    cd = (cd + cd.T) / 2
    d = [antisym() for _ in range(3)]
    if mode == 5:
        return tuple(t(x) for x in [co, cd] + d)
    w = np.sqrt(-np.minimum(co, 0))
    return tuple(t(x) for x in [cd] + [w * x for x in d])


def _nonsym_planes(A, mode, seed, device):
    """Seeded f32 planes with no symmetry (as B1 contract_pallas takes
    them); mode 3 displacements span the physical 1-12 A range."""
    import torch
    rng = np.random.default_rng(seed)
    if mode == 3:
        d = rng.standard_normal((A, A, 3), dtype=np.float32)
        d *= (rng.uniform(1.0, 12.0, (A, A)).astype(np.float32) /
              (np.linalg.norm(d, axis=-1) + 1e-30))[..., None]
        planes = [d[..., i] for i in range(3)]
    else:
        scales = (0.01, 0.01, 1.0, 1.0, 1.0) if mode == 5 else \
            (0.01, 0.1, 0.1, 0.1)
        planes = [rng.standard_normal((A, A), dtype=np.float32) * s
                  for s in scales]
    return tuple(torch.from_numpy(np.ascontiguousarray(p)).to(device)
                 for p in planes)


def _mode_planes(planes3, flags, l, mode):
    """The pair tensor of the mode-3 planes ``planes3`` in plane mode
    ``mode`` (the representations of fold_outer_rows)."""
    from mpmcxx_tpu_torch.ops.polar import coeffs_from_d, fold_outer_rows
    if mode == 3:
        return planes3
    co, cd = coeffs_from_d(*planes3, l)
    return fold_outer_rows(co, cd, *planes3, flags.replace(
        polar_plane_mode=4) if mode == 4 else flags.replace(
        polar_wolf_full=True))


def _mu(A, device, state=None):
    """Seeded dipoles [A,3] f64; with ``state``, zero where the SCF's are
    (dead atoms and alpha = 0 sites: mu = alpha E).  The H2 model puts
    zero-alpha sites 0.008 A apart (H2E and H2N on one axis), where the
    f32 damping polynomial is all rounding noise; the chain never
    contracts a dipole across such a pair."""
    import torch
    mu = torch.from_numpy(np.random.default_rng(A).normal(
        size=(A, 3)) * 0.1).to(device)
    if state is None:
        return mu
    live = state.atom_alive() & (state.polarizability > 0)
    return torch.where(live[:, None], mu, 0.0)


def check_k1(cache, state, flags, params, device, label="flagship",
             modes=(3, 4, 5), synthetic=True):
    """K1 vs its plain version on ``cache``'s planes (of ``state``) in
    ``modes`` (and, when ``synthetic``, on seeded symmetric planes and on
    seeded planes with no symmetry, B1's input, at SYNTH_A); returns the
    record for the kernels line, timed on ``cache``'s mode-3 planes.  The
    bound of symmetric planes is that of the tile triangle (the function
    needs no more: K4 reads just that); of the others, the full planes."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar

    l = params.polar_damp
    planes3 = (cache.dx, cache.dy, cache.dz)
    A = planes3[0].shape[0]
    worst_abs = 0.0
    rec = {}
    cases = [(label, A, state, True,
              lambda m: _mode_planes(planes3, flags, l, m))]
    if synthetic:
        cases += [
            ("synthetic", SYNTH_A, None, True,
             lambda m: _synthetic_planes(SYNTH_A, m, 10 + m, device)),
            ("non-symmetric", SYNTH_A, None, False,
             lambda m: _nonsym_planes(SYNTH_A, m, 30 + m, device))]
    for name, A_, st, symmetric, planes_of_mode in cases:
        mu = _mu(A_, device, st)
        for mode in modes:
            planes = planes_of_mode(mode)
            got = cuda_polar.contract_planes(planes, mu, l)
            want = cuda_polar.contract_planes_plain(planes, mu, l)
            torch.cuda.synchronize()
            rel = _rel(got, want)
            err = float(torch.max(torch.abs(got - want)))
            ms = _time_ms(lambda: cuda_polar.contract_planes(planes, mu, l))
            plain_ms = _time_ms(
                lambda: cuda_polar.contract_planes_plain(planes, mu, l))
            bound = (_contract_bound(A_, mode, tri_elements(
                A_, cuda_polar.TRI_TILE), 2) if symmetric else
                _contract_bound(A_, mode, A_ * A_, 1))
            _say(f"K1 contract_planes {name} A={A_} mode {mode}: "
                 f"max_abs_err {err:.3e} rel_err {rel:.3e}  kernel "
                 f"{ms:.3f} ms  plain {plain_ms:.3f} ms  "
                 f"({mode * A_ * A_ * 4 / ms / 1e6:.0f} GB/s of planes)  "
                 f"bound {bound[0]:.4f} ms ({bound[1]}, "
                 f"{'triangle' if symmetric else 'full planes'})")
            if not rel <= K1_REL_TOL:
                raise AssertionError(
                    f"K1 {name} mode {mode}: rel err {rel:.3e} > "
                    f"{K1_REL_TOL}")
            worst_abs = max(worst_abs, err)
            if name == label and mode == 3:
                rec = {"ms": ms, "plain_ms": plain_ms, "bound": bound}
            del planes
    rec["max_abs_err"] = worst_abs
    return rec


def tri_elements(A, b):
    """Plane entries in the tile pairs I <= J of b x b tiles of an A x A
    plane, the ragged last tile included: (A^2 + sum of row-tile
    heights^2) / 2, which is A^2/2 + A b/2 when b divides A."""
    heights = [min(b, A - i) for i in range(0, A, b)]
    return (A * A + sum(h * h for h in heights)) // 2


def check_k4(cache, state, flags, params, device, label="H2 flagship"):
    """K4 vs its plain version (the full-plane contract_planes_plain, the
    reference of both contraction kernels) in plane modes 3, 4 and 5 on
    ``cache``'s planes and on seeded symmetric planes at the ragged
    TRI_SYNTH_A; each K4 output bitwise equal to a second launch on the
    same input.  Prints K4's and K1's times and GB/s on the same planes;
    returns the kernels-line record, timed on ``cache``'s mode-3 planes."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar

    l = params.polar_damp
    b = cuda_polar.TRI_TILE
    planes3 = (cache.dx, cache.dy, cache.dz)
    A = planes3[0].shape[0]
    worst_abs = 0.0
    rec = {}
    for name, A_, st, planes_of_mode in (
            (label, A, state, lambda m: _mode_planes(planes3, flags, l, m)),
            ("synthetic", TRI_SYNTH_A, None,
             lambda m: _synthetic_planes(TRI_SYNTH_A, m, 20 + m, device))):
        mu = _mu(A_, device, st)
        for mode in (3, 4, 5):
            planes = planes_of_mode(mode)
            got = cuda_polar.contract_planes_tri(planes, mu, l)
            again = cuda_polar.contract_planes_tri(planes, mu, l)
            want = cuda_polar.contract_planes_plain(planes, mu, l)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K4 {name} mode {mode}: two launches "
                                     "on one input differ")
            rel = _rel(got, want)
            err = float(torch.max(torch.abs(got - want)))
            ms = _time_ms(
                lambda: cuda_polar.contract_planes_tri(planes, mu, l))
            k1_rel = _rel(cuda_polar.contract_planes(planes, mu, l), want)
            k1_ms = _time_ms(
                lambda: cuda_polar.contract_planes(planes, mu, l))
            plain_ms = _time_ms(
                lambda: cuda_polar.contract_planes_plain(planes, mu, l))
            tri_gb = mode * tri_elements(A_, b) * 4 / 1e9
            _say(f"K4 contract_planes_tri {name} A={A_} mode {mode}: "
                 f"max_abs_err {err:.3e} rel_err {rel:.3e}, repeat "
                 f"bitwise equal;  K4 {ms:.4f} ms "
                 f"({tri_gb / ms * 1e3:.0f} GB/s of the triangle's "
                 f"{tri_gb:.3f} GB)  K1 {k1_ms:.4f} ms "
                 f"({mode * A_ * A_ * 4 / k1_ms / 1e6:.0f} GB/s of "
                 f"{mode * A_ * A_ * 4 / 1e9:.3f} GB, rel_err "
                 f"{k1_rel:.3e})  plain {plain_ms:.3f} ms")
            if not max(rel, k1_rel) <= K1_REL_TOL:
                raise AssertionError(
                    f"K4 {name} mode {mode}: rel err {rel:.3e} (K1 "
                    f"{k1_rel:.3e}) > {K1_REL_TOL}")
            worst_abs = max(worst_abs, err)
            if name == label and mode == 3:
                rec = {"ms": ms, "plain_ms": plain_ms, "k1_ms": k1_ms,
                       "bound": _contract_bound(A_, 3, tri_elements(A_, b),
                                                2)}
            del planes
    rec["max_abs_err"] = worst_abs
    return rec


def check_k2(cache, device):
    """K2 vs its plain version, bitwise; returns the kernels-line record."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar
    from mpmcxx_tpu_torch.ops.polar_cache import commit_strips

    A = cache.dx.shape[0]
    S = 3
    rng = np.random.default_rng(7)
    rec = {}
    for start in (0, A // 2 + 1, A - S):
        for valid in ((True, True, True), (True, False, True)):
            base = (cache.dx.clone(),)
            rows = (torch.from_numpy(rng.normal(size=(S, A)).astype(
                np.float32)).to(device),)
            st = torch.tensor(start, device=device)
            vt = torch.tensor(valid, device=device)
            blend, cols = commit_strips(base, rows, st, vt, -1.0)
            k = (base[0].clone(),)
            p = (base[0].clone(),)
            cuda_polar.write_plane_strips(k, blend, cols, st)
            cuda_polar.write_plane_strips_plain(p, blend, cols, st)
            torch.cuda.synchronize()
            if not torch.equal(k[0], p[0]):
                raise AssertionError(f"K2 start {start} valid {valid}: "
                                     "kernel differs from plain")
            _say(f"K2 write_plane_strips start={start} valid={valid}: "
                 "bitwise equal")
            del base, k, p
    # time the commit shape of the main path: three planes, S = 3
    planes = (cache.dx, cache.dy, cache.dz)
    st = torch.tensor(A // 2, device=device)
    vt = torch.ones(S, dtype=torch.bool, device=device)
    rows = tuple(pl.index_select(0, st + torch.arange(S, device=device))
                 for pl in planes)
    blend, cols = commit_strips(planes, rows, st, vt, -1.0)
    rec["ms"] = _time_ms(
        lambda: cuda_polar.write_plane_strips(planes, blend, cols, st))
    rec["plain_ms"] = _time_ms(
        lambda: cuda_polar.write_plane_strips_plain(planes, blend, cols, st))
    rec["max_abs_err"] = 0.0
    # reads the row and column strips, writes them into the planes
    rec["bound"] = _bound(4 * len(planes) * S * A * 4, 0, F32_OPS_PER_S)
    _say(f"K2 write_plane_strips 3 planes A={A} S={S}: kernel "
         f"{rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms")
    return rec


def cli_flagship_state(pqr, device):
    """The state the runner builds from the flagship's PQR: uVT headroom
    of one dead slot per live sorbate (runner.py:94-107), 19,712 slots."""
    from mpmcxx_tpu_torch.io.pqr import read_pqr
    from mpmcxx_tpu_torch.state import build_state
    atoms = read_pqr(pqr)
    n_mov = len({a.molecule_id for a in atoms if not a.frozen})
    return build_state(atoms, np.eye(3) * 80.0,
                       extra_mol_capacity=max(n_mov, 32), device=device)[0]


def check_k3(state, device):
    """K3 vs its plain version, bitwise, on the CLI run's grid and darts
    and on a seeded near-boundary case; returns the kernels-line record."""
    import torch
    from mpmcxx_tpu_torch.mc import cavity
    from mpmcxx_tpu_torch.ops import cuda_cavity
    from mpmcxx_tpu_torch.pbc import _mul3

    pos = cavity.wrapped_positions(state)
    grid = cavity.grid_points(state, CAV_GRID)
    rng = np.random.default_rng(5)
    darts = _mul3(torch.from_numpy(
        rng.uniform(size=(int(80.0 ** 3 * 0.1), 3)) - 0.5).to(device),
        state.pbc.basis)
    # atoms at r (1 +- 1e-12) of seeded points, a third of them dead
    P = 4096
    pts = torch.from_numpy(rng.uniform(-40, 40, (P, 3))).to(device)
    u = rng.normal(size=(2 * P, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    scale = CAV_RADIUS * (1.0 + 1e-12 * rng.choice([-1.0, 1.0], 2 * P))
    near = pts.repeat(2, 1) + torch.from_numpy(u * scale[:, None]).to(device)
    near_alive = torch.from_numpy(rng.uniform(size=2 * P) > 1 / 3).to(device)

    open_mask = ~cuda_cavity.occupancy_plain(grid, pos, state.aalive,
                                             CAV_RADIUS)
    rec = {"max_abs_err": 0.0}
    for label, args in (
            ("grid", (grid, pos, state.aalive)),
            ("darts", (darts, grid, open_mask)),
            ("near-boundary", (pts, near, near_alive))):
        got = cuda_cavity.occupancy(*args, CAV_RADIUS)
        want = cuda_cavity.occupancy_plain(*args, CAV_RADIUS)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"K3 {label}: {int((got != want).sum())} of {got.numel()} "
                "points differ from the plain version")
        ms = _time_ms(lambda: cuda_cavity.occupancy(*args, CAV_RADIUS))
        plain_ms = _time_ms(
            lambda: cuda_cavity.occupancy_plain(*args, CAV_RADIUS))
        _say(f"K3 occupancy {label}: {args[0].shape[0]} points x "
             f"{args[1].shape[0]} atoms, {int(got.sum())} occupied; bitwise "
             f"equal; kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        if label == "grid":
            # at least one test per occupied point, every live atom for
            # an open one; points and atoms read once, a byte per point out
            n_open = int(open_mask.sum())
            n_alive = int(state.aalive.sum())
            P, A = grid.shape[0], pos.shape[0]
            ops = OCCUPANCY_OPS * (n_open * n_alive + (P - n_open))
            rec.update(ms=ms, plain_ms=plain_ms, bound=_bound(
                P * 24 + A * 25 + P, ops, F64_OPS_PER_S))
            _say(f"  open fraction of the grid: "
                 f"{float(open_mask.double().mean()):.4f}")
        else:
            rec[f"{label}_ms"], rec[f"{label}_plain_ms"] = ms, plain_ms
    return rec


def _instrument_chain(log):
    """Wrap the port's chunk runner and refresher (as the runner looks
    them up) to time each chunk on the card and record the incremental
    energies just before each corrtime refresh beside the refresh's full
    recompute.  Returns a function that undoes the wrapping."""
    import torch
    from mpmcxx_tpu_torch.mc import chain
    orig_runner, orig_refresher = chain.make_chunk_runner, \
        chain.make_refresher
    fields = ("rd_energy", "coulombic_energy", "polarization_energy")

    def make_chunk_runner(*a, **kw):
        run_chunk = orig_runner(*a, **kw)

        def timed(carry):
            torch.cuda.synchronize()
            t0 = time.time()
            carry, outs = run_chunk(carry)
            torch.cuda.synchronize()
            log["chunks"].append((len(outs.movetype), time.time() - t0,
                                  outs))
            return carry, outs
        return timed

    def make_refresher(*a, **kw):
        refresh = orig_refresher(*a, **kw)

        def recorded(carry):
            inc = {f: float(getattr(carry.obs, f)) for f in fields}
            out = refresh(carry)
            log["refresh"].append(
                (inc, {f: float(getattr(out.obs, f)) for f in fields}))
            return out
        return recorded

    chain.make_chunk_runner = make_chunk_runner
    chain.make_refresher = make_refresher

    def undo():
        chain.make_chunk_runner = orig_runner
        chain.make_refresher = orig_refresher
    return undo


def run_cli_flagship(workdir, golden, device="cuda"):
    """Step 6: the cavity-biased flagship through the port's CLI in
    ``workdir`` (which holds flagship_co2.pqr); returns the launch counts
    of the run."""
    import torch
    from mpmcxx_tpu_torch import cli
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.io.pqr import read_pqr

    with open(os.path.join(workdir, "run.in"), "w") as f:
        f.write(RUN_IN)
    log = {"chunks": [], "refresh": []}
    undo = _instrument_chain(log)
    stdout = io.StringIO()
    cwd = os.getcwd()
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        os.chdir(workdir)
        with contextlib.redirect_stdout(stdout):
            rc, sim = cli.run(["--device", str(device), "run.in"])
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        undo()
    wall = time.time() - t0
    launches = launches_now()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for line in stdout.getvalue().splitlines():
        if line.startswith(("SIM_CONTROL: Simulation complete",
                            "OUTPUT: Grand Total", "OUTPUT: Cavity",
                            "OUTPUT: AR")):
            _say("  cli| " + line)
    _say(f"CLI run: exit code {rc}, {wall:.1f} s wall including set-up")
    if rc != 0:
        raise AssertionError(f"the CLI run exited with {rc}")

    n_moves = 2 * CHUNK
    st = sim.carry.state
    _say(f"CLI run: {st.n_atom_slots} atom slots, grid {CAV_GRID}^3 = "
         f"{CAV_GRID ** 3} points, {sim.opts.cavity_darts} darts per move")
    if st.n_atom_slots != CLI_SLOTS or sim.opts.cavity_darts != CLI_DARTS:
        raise AssertionError("the CLI run is not at the flagship's width")

    # the energy log: header, rows 0, 64 and 128
    with open(os.path.join(workdir, "flagship_cav.energy.dat")) as f:
        lines = f.read().splitlines()
    rows = [[float(x) for x in ln.split()] for ln in lines[1:]]
    if not lines[0].startswith("#step #energy") or \
            [r[0] for r in rows] != [0, CHUNK, 2 * CHUNK]:
        raise AssertionError(f"energy log rows: {[r[0] for r in rows]}")
    if not np.all(np.isfinite(rows)):
        raise AssertionError("the energy log holds non-finite values")
    for comp, col in (("rd", 3), ("coulombic", 2), ("polar", 4)):
        ours = rows[0][col]
        rel = abs(ours - golden[comp]) / abs(golden[comp])
        _say(f"CLI initial {comp} {ours:.6f} vs reference binary "
             f"{golden[comp]:.6f}: rel {rel:.2e} (tol 2e-06)")
        if not rel <= 2e-6:
            raise AssertionError(f"CLI initial {comp} off the golden: {rel}")
    # incremental vs the refresh's full recompute, at each corrtime
    for c, (inc, full) in enumerate(log["refresh"]):
        for name, tol in (("rd_energy", 1e-8), ("coulombic_energy", 1e-8),
                          ("polarization_energy", 1e-5)):
            rel = abs(inc[name] - full[name]) / abs(full[name])
            _say(f"CLI corrtime {c + 1}: incremental {name} "
                 f"{inc[name]:.9f} vs full {full[name]:.9f}: rel {rel:.2e} "
                 f"(tol {tol:g})")
            if not rel <= tol:
                raise AssertionError(f"CLI {name}: incremental vs full "
                                     f"rel {rel}")
    if len(log["refresh"]) != 2:
        raise AssertionError(f"{len(log['refresh'])} refreshes, want 2")
    cav = sim.carry.cavity.tolist()
    _say(f"cavity carry: mean open fraction {cav[0]:.6f}, dart volume "
         f"{cav[1]:.3f} A^3, snapshot {cav[2]:.6f}, checkpoints {cav[3]:g}")
    if not (0.0 < cav[0] < 1.0 and cav[3] == 2.0):
        raise AssertionError(f"cavity carry {cav}")
    outs = [o for _, _, o in log["chunks"]]
    mt = torch.cat([o.movetype for o in outs])
    acc = torch.cat([o.accepted for o in outs])
    biased = torch.cat([o.biased for o in outs])
    ins = mt == const.MOVETYPE_INSERT
    rem = mt == const.MOVETYPE_REMOVE
    n_bi = int((ins & biased & acc).sum())
    _say(f"moves: {int(ins.sum())} inserts ({int((ins & biased).sum())} "
         f"biased, {n_bi} of those accepted), {int(rem.sum())} removes "
         f"({int((rem & biased).sum())} biased, "
         f"{int((rem & biased & acc).sum())} accepted), "
         f"{int(acc.sum())} of {n_moves} moves accepted")
    if n_bi == 0:
        _say("no biased insertion was accepted in this run")
    # the restart PQR read back: the live atoms, frozen + 3 N
    N = int(sim.carry.obs.N)
    n_frozen = int(st.frozen.sum())
    n_atoms = len(read_pqr(os.path.join(workdir,
                                        "flagship_cav.restart.pqr")))
    _say(f"restart PQR: {n_atoms} atoms = {n_frozen} framework + 3 x "
         f"N = {N}")
    if n_atoms != n_frozen + 3 * N:
        raise AssertionError(f"restart PQR has {n_atoms} atoms, N = {N}")
    steps, dt, _ = log["chunks"][-1]
    _say(f"CLI second corrtime: {steps} moves in {dt:.3f} s = "
         f"{steps / dt:.2f} moves/s; peak device memory {peak_gb:.2f} GB; "
         f"launches {launches}")
    for name, per_move in (("contract_planes", 4), ("write_plane_strips", 1),
                           ("occupancy", 2)):
        if launches[name] < per_move * n_moves:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"for {n_moves} moves")
    if launches["contract_planes_tri"]:
        raise AssertionError("K4 ran on the default schedule")
    return launches


def load_golden(root, model):
    """The reference binary's single-point breakdown of a flagship
    configuration (tests/golden, gated at rel 2e-6 by
    tests/test_golden.py)."""
    with open(os.path.join(root, "tests", "golden", GOLDEN[model])) as f:
        return json.load(f)["expected"]


def _close(got, want, tol):
    """(relative difference, within tol) with a zero reference allowed."""
    diff = abs(got - want)
    return (diff / abs(want) if want else diff), diff <= tol * abs(want)


def run_flagship_chain(model, state, flags, params, opts, root, card,
                       contraction):
    """One flagship's main path under the schedule switch in force:
    ``init_carry(seed=0)`` and two CHUNK-move chunks of
    ``make_chunk_runner``, every launch count 0 just before.  Checks the
    initial rd / coulombic / polarization against the model's golden
    (where one exists, rel 2e-6); finite energies; incremental rd /
    coulombic within 1e-8 and polarization within 1e-5 of a fresh
    ``energy_breakdown_blocked``; the committed planes within 1e-6 of a
    fresh ``cache_init``; ``contraction`` (the kernel the switch picks)
    launched >= 4 times per move and the other contraction kernel never,
    the recompute included; K2 >= 1 per move, always with the model's S
    window rows.  Returns (launches of the run, second chunk's moves/s)."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown_blocked
    from mpmcxx_tpu_torch.state import topology

    S = opts.max_mol_atoms
    other = {"contract_planes": "contract_planes_tri",
             "contract_planes_tri": "contract_planes"}[contraction]
    windows = set()       # rows of each commit's strips (K2's S)
    commit = pcache.write_symmetric_rows

    def commit_window(planes, rows, *args):
        windows.add(int(rows[0].shape[0]))
        return commit(planes, rows, *args)

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    pcache.write_symmetric_rows = commit_window
    try:
        t0 = time.time()
        carry = chain.init_carry(state, flags, params, opts, seed=0)
        runner = chain.make_chunk_runner(flags, params, opts, CHUNK,
                                         topology=topology(state))
        _say(f"[{model}] init_carry: E = {float(carry.obs.energy):.6f} K, "
             f"N = {int(carry.obs.N)} ({time.time() - t0:.2f} s)")
        if model in GOLDEN:
            golden = load_golden(root, model)
            for comp, field in (("rd", "rd_energy"),
                                ("coulombic", "coulombic_energy"),
                                ("polar", "polarization_energy")):
                ours = float(getattr(carry.obs, field))
                rel = abs(ours - golden[comp]) / abs(golden[comp])
                _say(f"[{model}] initial {comp} {ours:.6f} vs reference "
                     f"binary {golden[comp]:.6f}: rel {rel:.2e} (tol 2e-06)")
                if not rel <= 2e-6:
                    raise AssertionError(
                        f"[{model}] initial {comp} off the reference: {rel}")
        moves_per_s = None
        for c in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            carry, outs = runner(carry)
            torch.cuda.synchronize()
            dt = time.time() - t0
            moves_per_s = CHUNK / dt
            _say(f"[{model}] chunk {c}: {CHUNK} moves in {dt:.3f} s = "
                 f"{moves_per_s:.2f} moves/s; E = "
                 f"{float(carry.obs.energy):.6f} K, N = {int(carry.obs.N)}")
    finally:
        pcache.write_symmetric_rows = commit
    launches = launches_now()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    acc = carry.stats.accept.cpu().numpy()
    rej = carry.stats.reject.cpu().numpy()
    for mt, name in const.MOVETYPE_NAMES.items():
        if acc[mt] + rej[mt]:
            _say(f"  {name}: {acc[mt]} accepted / {acc[mt] + rej[mt]}")
    _say(f"[{model}] second chunk: {moves_per_s:.2f} moves/s on {card}; "
         f"{state.n_atom_slots} slots, S = {S}; peak device memory "
         f"{peak_gb:.2f} GB; launches {launches}")

    # --- is the result right? --------------------------------------------
    n_moves = 2 * CHUNK
    obs = carry.obs
    for name in ("energy", "rd_energy", "coulombic_energy",
                 "polarization_energy"):
        if not np.isfinite(float(getattr(obs, name))):
            raise AssertionError(f"[{model}] {name} is not finite")
    if not torch.isfinite(carry.state.mu).all():
        raise AssertionError(f"[{model}] dipoles are not finite")
    eb = energy_breakdown_blocked(carry.state, flags, params)
    for name, full, tol in (("rd_energy", eb.rd, 1e-8),
                            ("coulombic_energy", eb.coulombic, 1e-8),
                            ("polarization_energy", eb.polarization, 1e-5)):
        inc, ref = float(getattr(obs, name)), float(full)
        rel, ok = _close(inc, ref, tol)
        _say(f"[{model}] incremental {name} {inc:.9f} vs full {ref:.9f}: "
             f"rel {rel:.2e} (tol {tol:g})")
        if not ok:
            raise AssertionError(
                f"[{model}] {name}: incremental vs full rel {rel}")
    # 128 in-place commits (K2) left the planes those of a full rebuild
    fresh = pcache.cache_init(carry.state, flags, params)
    for name in ("dx", "dy", "dz"):
        diff = float(torch.max(torch.abs(getattr(carry.pcache, name) -
                                         getattr(fresh, name))))
        _say(f"[{model}] committed plane {name} vs rebuild: max |diff| "
             f"{diff:.3e}")
        if not diff <= 1e-6:
            raise AssertionError(f"[{model}] plane {name} drifted from a "
                                 "rebuild")
    del fresh
    if launches[contraction] < 4 * n_moves:
        raise AssertionError(f"[{model}] {contraction} launched "
                             f"{launches[contraction]} times for {n_moves} "
                             "moves")
    if launches_now()[other]:
        raise AssertionError(f"[{model}] {other} ran on this schedule")
    if launches["write_plane_strips"] < n_moves or windows != {S}:
        raise AssertionError(
            f"[{model}] K2 launched {launches['write_plane_strips']} times "
            f"for {n_moves} moves with windows {sorted(windows)}, want S={S}")
    _say(f"[{model}] {contraction} {launches[contraction] / n_moves:.2f} "
         f"launches per move, {other} none; K2 windows S = {S}")
    return launches, moves_per_s


def _entry(name, source, replaces, rec, launches):
    """A kernels-line entry; ``launches`` maps each path to its count."""
    bound_ms, bound_by = rec["bound"]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n[name] for n in launches.values()),
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tools"))
    import flagship  # noqa: F401  (numpy only at import)
    from mpmcxx_tpu_torch.ops import kernels
    from mpmcxx_tpu_torch.ops import polar_cache as pcache

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    _say(f"card: {card}")
    _say(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")
    t_start = time.time()

    t0 = time.time()
    path = kernels.build()
    kernels.load()
    _say(f"kernels built in {time.time() - t0:.1f} s: {path}")
    for line in kernels.build_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "spill" in line):
            _say("  " + line.strip())

    def flush():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    launches = {}      # path -> launch counts of its run
    rates = {}         # path -> second chunk's moves/s

    # --- 1. the CO2 flagship: K1, K2 vs plain, then its main path --------
    with schedule():
        t0 = time.time()
        state, _, flags, params, opts = build_flagship("co2", device)
        _say(f"CO2 flagship: {state.n_atom_slots} atom slots, "
             f"{int(state.aalive.sum())} live atoms ({time.time() - t0:.1f} "
             "s to build)")
        cache = pcache.cache_init(state, flags, params)
        k1 = check_k1(cache, state, flags, params, device)
        k2 = check_k2(cache, device)
        del cache
        flush()
        launches["co2"], rates["co2"] = run_flagship_chain(
            "co2", state, flags, params, opts, root, card, "contract_planes")
        del state
        flush()

    # --- 2. K3, then the cavity-biased CO2 flagship through the CLI ------
    with schedule(), tempfile.TemporaryDirectory() as workdir:
        pqr = os.path.join(workdir, "flagship_co2.pqr")
        flagship.write_pqr_co2(pqr)
        # every kernel at the shapes of the CLI run (19,712 slots)
        cli_state = cli_flagship_state(pqr, device)
        cli_cache = pcache.cache_init(cli_state, flags, params)
        k1_cli = check_k1(cli_cache, cli_state, flags, params, device,
                          label="CLI flagship", modes=(3,), synthetic=False)
        k2_cli = check_k2(cli_cache, device)
        del cli_cache
        k3 = check_k3(cli_state, device)
        del cli_state
        flush()
        launches["cli"] = run_cli_flagship(workdir, load_golden(root, "co2"))
    flush()

    # --- 3. the H2 flagship: K4 vs plain, then its path through K4 -------
    t0 = time.time()
    state, _, flags, params, opts = build_flagship("h2", device)
    _say(f"H2 flagship: {state.n_atom_slots} atom slots, "
         f"{int(state.aalive.sum())} live atoms ({time.time() - t0:.1f} s "
         "to build)")
    cache = pcache.cache_init(state, flags, params)
    k4 = check_k4(cache, state, flags, params, device)
    del cache
    flush()
    with schedule(MPMCXX_TRI_KERNEL="1"):
        launches["h2"], rates["h2"] = run_flagship_chain(
            "h2", state, flags, params, opts, root, card,
            "contract_planes_tri")
    del state
    flush()

    # --- 4. the monatomic flagship through K1 on B1's schedule -----------
    t0 = time.time()
    state, _, flags, params, opts = build_flagship("ar", device)
    _say(f"monatomic flagship: {state.n_atom_slots} atom slots, "
         f"{int(state.aalive.sum())} live atoms ({time.time() - t0:.1f} s "
         "to build)")
    cache = pcache.cache_init(state, flags, params)
    k1_ar = check_k1(cache, state, flags, params, device,
                     label="monatomic flagship", modes=(3,), synthetic=False)
    del cache
    flush()
    with schedule(MPMCXX_SYM_KERNEL="0"):
        launches["ar"], rates["ar"] = run_flagship_chain(
            "ar", state, flags, params, opts, root, card, "contract_planes")
    del state
    flush()

    _say(f"second-chunk moves/s on {card}: " + ", ".join(
        f"{m} {r:.2f}" for m, r in rates.items()) +
        f"; whole check {time.time() - t_start:.1f} s after the card query")
    k1_all = dict(k1_cli, max_abs_err=max(
        k1["max_abs_err"], k1_cli["max_abs_err"], k1_ar["max_abs_err"]))
    k2_all = dict(k2_cli, max_abs_err=max(k2["max_abs_err"],
                                          k2_cli["max_abs_err"]))
    kernels_line = {"kernels": [
        _entry("contract_planes", "mpmcxx_tpu_torch/csrc/contract_planes.cu",
               "mpmcxx_tpu/ops/pallas_polar.py:209, "
               "mpmcxx_tpu/ops/pallas_polar.py:39", k1_all, launches),
        _entry("write_plane_strips",
               "mpmcxx_tpu_torch/csrc/write_plane_strips.cu",
               "mpmcxx_tpu/ops/pallas_polar.py:134", k2_all, launches),
        _entry("occupancy", "mpmcxx_tpu_torch/csrc/occupancy.cu",
               "mpmcxx_tpu/ops/pallas_cavity.py:54", k3, launches),
        _entry("contract_planes_tri",
               "mpmcxx_tpu_torch/csrc/contract_planes_tri.cu",
               "mpmcxx_tpu/ops/pallas_polar.py:369", k4, launches),
    ]}
    _say(json.dumps(kernels_line))
    _say(card)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
