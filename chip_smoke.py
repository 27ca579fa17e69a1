#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on one NVIDIA GPU, through
its hand-written kernels, and check the results.

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the
   card's ``nvidia-smi`` name and power limit.
2. Builds the kernels from ``mpmcxx_tpu_torch/csrc`` (nvcc, sm_90a) and
   prints the build time and ptxas report.
3. The CO2 flagship (tools/flagship.py, 10,112 live atoms, 11,264 slots),
   with the contraction-schedule variables unset (the default schedule,
   K5): K5 ``contract_planes_sym`` against the full-plane plain PyTorch
   version in plane modes 3, 4 and 5 on the flagship's own planes and on
   seeded symmetric planes at A = 4,096 and 4,032 (nr = 64 and 63 row
   tiles, where it is also held against its own schedule's plain
   version); relative error <= 1e-5, two launches on one input bitwise
   equal, K1's time (the call and its main kernel) and GB/s on the same
   planes beside K5's, with K1's full-plane bound.  K2
   ``write_plane_strips`` bitwise on copies of a flagship plane at window
   starts 0, mid-plane and A - S with all-valid and partly valid windows
   of S = 3 and 1 rows, the start int64 and int32; its device time
   (torch.profiler) beside the event-timed call.
   Then its main path: ``init_carry(seed=0)`` and two 64-move chunks of
   ``make_chunk_runner``, checking the initial rd / coulombic /
   polarization within 2e-6 (relative) of the reference binary's single
   point (tests/golden/flagship_co2_singlepoint.json); finite energies;
   incremental rd / coulombic within 1e-8 and polarization within 1e-5
   of a fresh ``energy_breakdown_blocked``; the committed planes within
   1e-6 of a fresh ``cache_init``; K5 >= 4 and K2 >= 1 launches per move,
   K2 with S = 3 rows, K1 and K4 none.
4. K5 (mode 3, K1 beside it) and K2 as in step 3 at the shapes of step
   5's run (the runner's 19,712 atom slots); K3 ``occupancy`` bitwise on
   the 24^3 cavity grid against the atoms, on 51,200 seeded darts against
   that grid's open points, and on points with atoms at r (1 +- 1e-12).
5. The cavity-biased CO2 flagship as a user runs it, through the port's
   command line (``mpmcxx_tpu_torch.cli``) in a temporary directory: a
   ``run.in`` with cavity bias on (24^3 grid, radius 2.6 A) and the
   flagship's PQR, 128 uVT moves in two corrtimes.  Checks: exit code 0;
   the energy log's initial energies within 2e-6 of the golden; before
   each corrtime refresh, incremental energies against the refresh's full
   recompute as in step 3; 0 < cavity mean < 1 and two checkpoints; the
   energy log's rows 0, 64, 128; the restart PQR holding 512 + 3 N atoms;
   K5 >= 4, K2 >= 1 and K3 >= 2 launches per move, K1 and K4 none.  Then
   one more 16-move chunk of the run's chain under torch.profiler: its
   device time per move, split by kernel, beside the wall time per move
   of an unprofiled 16-move chunk.
6. The H2 flagship (2,000 5-site H2, 10,752 slots): K4
   ``contract_planes_tri`` against the plain version in modes 3, 4 and 5
   on its planes and on seeded symmetric planes at the ragged A = 4,000
   (relative error <= 1e-5; two launches on one input bitwise equal),
   with K1's time and GB/s on the same planes beside K4's.  Then, with
   ``MPMCXX_TRI_KERNEL=1`` (restored afterwards), its main path as in
   step 3 against tests/golden/flagship_h2_singlepoint.json: K4 >= 4
   launches per move, K1 and K5 none (the recompute included), K2 with
   S = 5.
7. The monatomic flagship (9,728 sorbates, 10,752 slots): K1
   ``contract_planes`` against its plain version (relative error <= 1e-5,
   two launches bitwise equal, [R, 3] out) in mode 3 on its planes and on
   the middle quarter of their rows ([A/4, A], as a row-sharded caller
   passes them), and in modes 3, 4 and 5 on seeded planes with no
   symmetry (B1 contract_pallas's input) at A = 4,096, on the middle
   quarter of their rows and at A = 4,001 (A % 4 != 0, no TMA), each
   call's time and its main kernel's beside the full-plane bound (and on
   the flagship's symmetric planes the triangle's); then, with
   ``MPMCXX_SYM_KERNEL=0`` (the JAX package's full-plane contract_pallas
   schedule), its main path as in step 3 (no golden exists): K1 >= 4
   launches per move, K4 and K5 none, K2 with S = 1.
8. The seven standard-ensemble examples (``examples/``: gcmc-cavity-argon,
   gcmc-mof-co2, -h2 and -mixture, nvt-, npt- and nve-argon) through the
   port's CLI in a temporary directory, at tests/test_examples.py's
   QUICK_STEPS with corrtime half of them, each on the dense path: exit
   code 0, a finite energy log, the incremental energies against each
   refresh (rd and coulombic 1e-8; polarization 1e-5 where a polar
   cache carries it), K1 >= 4 launches per move on the polarizable ones
   (the XLA branch at 63-213 slots) and no other contraction, K3 >= 1
   per move on the cavity-biased one, no SCF kernel on the LJ-only
   ones, a volume move proposed in NPT; wall seconds and steps/s.  Then
   K1 against its plain version on the polarizable examples' committed
   planes (square, and their first quarter of rows) and on seeded planes
   with no symmetry at A = 57 (modes 3, 4 and 5, square and rows):
   relative error <= 1e-5, repeats bitwise.
9. The CO2 flagship's PQR through the CLI without the polar and cavity
   lines (19,712 slots, blocked, incremental LJ/Ewald, 2 corrtimes of
   64): initial rd and coulombic within 2e-6 of the golden, incremental
   vs each refresh within 1e-8, K1, K2, K4 and K5 never launched;
   moves/s.
10. The monatomic flagship in NPT with its polar cache (build_flagship,
   default schedule, volume moves as npt-argon's, 2 A displacements),
   checked as in step 3 at the final box, with K2 once per local move
   and at least one volume move proposed; the wall time of one volume
   move (its full recompute and cache rebuild).
11. The monatomic flagship with polar_mixed off: 8 moves, each a blocked
   full recompute whose SCF contracts in float64 row tiles; energies
   against a fresh ``energy_breakdown_blocked``, no f32-plane kernel
   launched; ms per move.
12. Prints ``{"kernels": [...]}`` (per kernel: the sum over the main paths
   of steps 3, 5-11 of its launches, each path counted from 0, and
   the count of each path; the time, plain time and bound at the shapes
   of step 4 for K2, K3 and K5, step 6 for K4 and step 7 for K1; the
   worst error of the checks), the card's name and power limit, and,
   last, ``{"ok": true, "device": {...}}``.  Any failure raises: non-zero
   exit, no result line.

Imports torch, numpy and the port only (never jax).
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
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
# the flagship CLI run without polarization (phase b): no SCF, no cavity
RUN_IN_NOPOLAR = "\n".join(
    ln for ln in RUN_IN.replace("flagship_cav", "flagship_lj").splitlines()
    if not ln.startswith(("polar", "cavity"))) + "\n"
# the examples that run through the port (tests/test_examples.py's
# QUICK_STEPS; corrtime half of it) and the polarizable ones among them
EXAMPLE_STEPS = {"gcmc-cavity-argon": 60, "gcmc-mof-co2": 40,
                 "gcmc-mof-h2": 40, "gcmc-mof-mixture": 40,
                 "nvt-argon": 200, "npt-argon": 200, "nve-argon": 200}
POLAR_EXAMPLES = ("gcmc-mof-co2", "gcmc-mof-h2", "gcmc-mof-mixture")
SMALL_A = 57             # a ragged small plane beside the examples' own
NPT_PRESSURE = 50.0      # atm; npt-argon's volume move settings below
NPT_VOLUME_PROBABILITY = 0.05
NPT_VOLUME_CHANGE = 0.12
F64_MOVES = 8            # moves of the float64 SCF phase (d)
# phases (c) and (d): 2 A steps instead of the flagship's half cutoff
# (20 A), under which about 1 in 100 displacements is accepted, so that
# local moves are accepted beside the volume moves and full recomputes
SMALL_MOVE_FACTOR = 0.05
K1_REL_TOL = 1e-5        # f32 sums of ~1e4 terms in another order
SYNTH_A = 4096
RAGGED_A = 4001          # A % 4 != 0: no TMA tensor map (16-byte rows)
SYM_SYNTH_A = (4096, 4032)   # K5's 64-row tiles: nr = 64 (even), 63 (odd)
TRI_SYNTH_A = 4000       # not a multiple of K4's 64-row tile
PROFILE_MOVES = 16
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


def _contract_bound(A, mode, elements, directions, rows=None):
    """Bound of ``-T mu`` that reads ``elements`` entries of each of the
    ``mode`` f32 planes once (the tile triangle of symmetric planes, R x A
    of planes with no symmetry), taking ``directions`` sums from each, and
    mu [3,A] f32, and writes [R,3] f32 (R = ``rows``, A by default)."""
    rows = A if rows is None else rows
    nbytes = mode * elements * 4 + 3 * (A + rows) * 4
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
            "contract_planes_sym": cuda_polar.contract_planes_sym,
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


def check_k1(cache, state, flags, params, device, label="flagship"):
    """K1 vs its plain version (relative error <= K1_REL_TOL; two launches
    on one input bitwise equal) on ``cache``'s planes (of ``state``) in
    mode 3 and on the quarter of their rows from the middle ([A/4, A], the
    self-pairs off the slice's diagonal); on seeded planes with no
    symmetry (B1's input) at SYNTH_A, at the ragged RAGGED_A (A % 4 != 0:
    the cp.async fill) and on the middle quarter of the SYNTH_A rows, in
    modes 3, 4 and 5.  Prints each call's event-timed and main-kernel
    (profiler) times beside the full-plane bound, and beside the tile
    triangle's bound on ``cache``'s whole planes (symmetric: K4 and K5
    need no more); returns the record for the kernels line, timed on
    ``cache``'s mode-3 planes."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar

    l = params.polar_damp
    planes3 = (cache.dx, cache.dy, cache.dz)
    A = planes3[0].shape[0]
    worst_abs = 0.0
    rec = {}

    def middle(planes):
        n = planes[0].shape[1]
        return tuple(p[3 * n // 8:3 * n // 8 + n // 4] for p in planes)

    cases = [(label, state, True, (3,),
              lambda m: _mode_planes(planes3, flags, l, m)),
             (f"{label} rows [A/4, A]", state, False, (3,),
              lambda m: middle(planes3)),
             ("non-symmetric", None, False, (3, 4, 5),
              lambda m: _nonsym_planes(SYNTH_A, m, 30 + m, device)),
             ("non-symmetric rows [A/4, A]", None, False, (3, 4, 5),
              lambda m: middle(_nonsym_planes(SYNTH_A, m, 30 + m, device))),
             ("non-symmetric ragged", None, False, (3, 4, 5),
              lambda m: _nonsym_planes(RAGGED_A, m, 40 + m, device))]
    for name, st, symmetric, modes, planes_of_mode in cases:
        for mode in modes:
            planes = planes_of_mode(mode)
            R, A_ = planes[0].shape
            mu = _mu(A_, device, st)
            got = cuda_polar.contract_planes(planes, mu, l)
            again = cuda_polar.contract_planes(planes, mu, l)
            want = cuda_polar.contract_planes_plain(planes, mu, l)
            torch.cuda.synchronize()
            if got.shape != (R, 3) or not torch.equal(got, again):
                raise AssertionError(
                    f"K1 {name} mode {mode}: shape {tuple(got.shape)}, or "
                    "two launches on one input differ")
            rel = _rel(got, want)
            err = float(torch.max(torch.abs(got - want)))
            ms = _time_ms(lambda: cuda_polar.contract_planes(planes, mu, l))
            main_ms, seen = _main_ms(
                lambda: cuda_polar.contract_planes(planes, mu, l))
            plain_ms = _time_ms(
                lambda: cuda_polar.contract_planes_plain(planes, mu, l))
            full = _contract_bound(A_, mode, R * A_, 1, R)
            tri = (_contract_bound(A_, mode, tri_elements(
                A_, cuda_polar.TRI_TILE), 2) if symmetric else None)
            _say(f"K1 contract_planes {name} {R}x{A_} mode {mode}: "
                 f"max_abs_err {err:.3e} rel_err {rel:.3e}, repeat bitwise "
                 f"equal;  kernel {ms:.4f} ms (main kernel {main_ms:.4f}, "
                 f"{seen} launches recorded; "
                 f"{mode * R * A_ * 4 / ms / 1e6:.0f} GB/s of planes)  "
                 f"plain {plain_ms:.3f} ms  bound {full[0]:.4f} ms "
                 f"({full[1]}, full planes: call {full[0] / ms:.1%}, main "
                 f"{full[0] / main_ms:.1%})"
                 + (f", {tri[0]:.4f} ms ({tri[1]}, the triangle of the "
                    "symmetric planes; K1's contract reaches at most half "
                    "of it)" if tri else ""))
            if not rel <= K1_REL_TOL:
                raise AssertionError(
                    f"K1 {name} mode {mode}: rel err {rel:.3e} > "
                    f"{K1_REL_TOL}")
            worst_abs = max(worst_abs, err)
            if name == label and mode == 3:
                rec = {"ms": ms, "main_ms": main_ms, "plain_ms": plain_ms,
                       "bound": tri, "bound_full_planes_ms": full[0]}
            del planes
    rec["max_abs_err"] = worst_abs
    return rec


def _main_ms(fn):
    """(device ms of one launch, launches recorded) of the main kernel of
    ``fn`` (the kernel with the most device time) over TIMING_REPS calls
    under torch.profiler: the mean over the launches it recorded."""
    split = device_split(fn)
    if not split:
        raise AssertionError("the profiler saw no kernel")
    ms, n = max(split.values())
    return ms / n, round(n * TIMING_REPS)


def tri_elements(A, b):
    """Plane entries in the tile pairs I <= J of b x b tiles of an A x A
    plane, the ragged last tile included: (A^2 + sum of row-tile
    heights^2) / 2, which is A^2/2 + A b/2 when b divides A."""
    heights = [min(b, A - i) for i in range(0, A, b)]
    return (A * A + sum(h * h for h in heights)) // 2


def check_k5(cache, state, flags, params, device, label, modes=(3, 4, 5),
             synthetic=True):
    """K5 vs the full-plane plain version in ``modes`` on ``cache``'s
    planes (of ``state``) and, when ``synthetic``, on seeded symmetric
    planes at each of SYM_SYNTH_A (nr even and odd), where it is also held
    against contract_planes_sym_plain, its own schedule in PyTorch; each
    K5 output bitwise equal to a second launch on the same input.  Prints
    K5's and K1's times and GB/s on the same planes (K5's of the bytes it
    reads, the tile triangle; K1's of the full planes, with its main
    kernel's time on ``cache``'s planes) and, on ``cache``'s mode-3
    planes, one K5 call's device time by kernel; returns the kernels-line
    record, timed on those planes."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar

    l = params.polar_damp
    b = cuda_polar.SYM_TILE
    planes3 = (cache.dx, cache.dy, cache.dz)
    A = planes3[0].shape[0]
    worst_abs = 0.0
    rec = {}
    cases = [(label, A, state,
              lambda m: _mode_planes(planes3, flags, l, m))]
    if synthetic:
        cases += [(f"synthetic nr={A_ // b}", A_, None,
                   lambda m, A_=A_: _synthetic_planes(A_, m, 50 + m, device))
                  for A_ in SYM_SYNTH_A]
    for name, A_, st, planes_of_mode in cases:
        mu = _mu(A_, device, st)
        for mode in modes:
            planes = planes_of_mode(mode)
            got = cuda_polar.contract_planes_sym(planes, mu, l)
            again = cuda_polar.contract_planes_sym(planes, mu, l)
            want = cuda_polar.contract_planes_plain(planes, mu, l)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K5 {name} mode {mode}: two launches "
                                     "on one input differ")
            rel = _rel(got, want)
            sched_rel = (_rel(got, cuda_polar.contract_planes_sym_plain(
                planes, mu, l)) if st is None else 0.0)
            err = float(torch.max(torch.abs(got - want)))
            ms = _time_ms(
                lambda: cuda_polar.contract_planes_sym(planes, mu, l))
            k1_rel = _rel(cuda_polar.contract_planes(planes, mu, l), want)
            k1_ms = _time_ms(
                lambda: cuda_polar.contract_planes(planes, mu, l))
            k1_main_ms = (_main_ms(
                lambda: cuda_polar.contract_planes(planes, mu, l))[0]
                if st is not None else None)
            plain_ms = _time_ms(
                lambda: cuda_polar.contract_planes_plain(planes, mu, l))
            tri_gb = mode * tri_elements(A_, b) * 4 / 1e9
            full_gb = mode * A_ * A_ * 4 / 1e9
            bound = _contract_bound(A_, mode, tri_elements(A_, b), 2)
            k1_bound = _contract_bound(A_, mode, A_ * A_, 1)
            _say(f"K5 contract_planes_sym {name} A={A_} mode {mode}: "
                 f"max_abs_err {err:.3e} rel_err {rel:.3e}"
                 + (f" (vs its schedule's plain {sched_rel:.3e})"
                    if st is None else "") +
                 f", repeat bitwise equal;  K5 {ms:.4f} ms "
                 f"({tri_gb / ms * 1e3:.0f} GB/s of the triangle's "
                 f"{tri_gb:.3f} GB; bound {bound[0]:.4f} ms, "
                 f"{bound[0] / ms:.1%})  K1 {k1_ms:.4f} ms"
                 + (f", main kernel {k1_main_ms:.4f}" if k1_main_ms else "")
                 + f" ({full_gb / k1_ms * 1e3:.0f} GB/s of {full_gb:.3f} "
                 f"GB; its full-plane bound {k1_bound[0]:.4f} ms, call "
                 f"{k1_bound[0] / k1_ms:.1%}"
                 + (f", main {k1_bound[0] / k1_main_ms:.1%}"
                    if k1_main_ms else "")
                 + f"; rel_err {k1_rel:.3e})  plain {plain_ms:.3f} ms")
            if not max(rel, sched_rel, k1_rel) <= K1_REL_TOL:
                raise AssertionError(
                    f"K5 {name} mode {mode}: rel err {rel:.3e} (its "
                    f"schedule's plain {sched_rel:.3e}, K1 {k1_rel:.3e}) "
                    f"> {K1_REL_TOL}")
            worst_abs = max(worst_abs, err)
            if name == label and mode == 3:
                rec = {"ms": ms, "plain_ms": plain_ms, "k1_ms": k1_ms,
                       "bound": bound}
                split = device_split(
                    lambda: cuda_polar.contract_planes_sym(planes, mu, l))
                if not split:
                    raise AssertionError("the profiler saw no K5 kernel")
                main_ms = max(ms / n for ms, n in split.values())
                _say("  K5 call's device time by kernel (mean of the "
                     "launches recorded): " + ", ".join(
                         f"{k} {ms / n:.4f} ms" for k, (ms, n) in
                         split.items()) +
                     f"; main kernel {bound[0] / main_ms:.1%} of the bound")
            del planes
    rec["max_abs_err"] = worst_abs
    return rec


def device_split(fn, reps=TIMING_REPS, tries=3):
    """Device ms and kernels per call of ``fn``, by kernel name
    (torch.profiler over ``reps`` calls after one warm-up call).  A
    session that records no device event at all (seen once in a run of
    this script) is run again, up to ``tries`` sessions; every call of
    ``fn`` runs the same work, so the sessions are alike."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                k = re.search(r"(\w+)(?:<[^>]*>)?\(", e.name)
                key = k.group(1) if k else e.name[:40]
                ms, n = out.get(key, (0.0, 0.0))
                out[key] = (ms + e.time_range.elapsed_us() / 1e3 / reps,
                            n + 1 / reps)
        if out:
            break
    return out


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
    """K2 vs its plain version, bitwise, on copies of ``cache``'s plane at
    window starts 0, mid-plane and A - S, for S = 3 (CO2) with all-valid
    and partly valid windows and S = 1 (monatomic), the start as the
    chain's int64 and once as int32.  Times the main path's commit (three
    planes, S = 3): the kernel's device time (torch.profiler) and the
    event-timed call (the wrapper's host work included).  Returns the
    kernels-line record, whose ms is the device time."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar
    from mpmcxx_tpu_torch.ops.polar_cache import commit_strips

    A = cache.dx.shape[0]
    rng = np.random.default_rng(7)
    cases = [(3, v, torch.int64) for v in ((True, True, True),
                                           (True, False, True))]
    cases += [(1, (True,), torch.int64), (1, (False,), torch.int64),
              (3, (True, True, True), torch.int32)]
    for S, valid, dtype in cases:
        for start in (0, A // 2 + 1, A - S):
            base = (cache.dx.clone(),)
            rows = (torch.from_numpy(rng.normal(size=(S, A)).astype(
                np.float32)).to(device),)
            st = torch.tensor(start, dtype=dtype, device=device)
            vt = torch.tensor(valid, device=device)
            blend, cols = commit_strips(base, rows, st, vt, -1.0)
            k = (base[0].clone(),)
            p = (base[0].clone(),)
            cuda_polar.write_plane_strips(k, blend, cols, st)
            cuda_polar.write_plane_strips_plain(p, blend, cols, st)
            torch.cuda.synchronize()
            if not torch.equal(k[0], p[0]):
                raise AssertionError(f"K2 S={S} start {start} valid {valid} "
                                     f"{dtype}: kernel differs from plain")
            _say(f"K2 write_plane_strips S={S} start={start} valid={valid} "
                 f"{str(dtype).split('.')[-1]}: bitwise equal")
            del base, k, p
    # the commit shape of the main path: three planes, S = 3
    S = 3
    planes = (cache.dx, cache.dy, cache.dz)
    st = torch.tensor(A // 2, device=device)
    vt = torch.ones(S, dtype=torch.bool, device=device)
    rows = tuple(pl.index_select(0, st + torch.arange(S, device=device))
                 for pl in planes)
    blend, cols = commit_strips(planes, rows, st, vt, -1.0)

    def call():
        cuda_polar.write_plane_strips(planes, blend, cols, st)
    split = {k: v for k, v in device_split(call).items()
             if "write_plane_strips" in k}
    if not split:
        raise AssertionError("the profiler saw no K2 kernel")
    rec = {"ms": sum(ms / n for ms, n in split.values()),
           "call_ms": _time_ms(call),
           "plain_ms": _time_ms(lambda: cuda_polar.write_plane_strips_plain(
               planes, blend, cols, st)),
           "max_abs_err": 0.0,
           # reads the row and column strips, writes them into the planes
           "bound": _bound(4 * len(planes) * S * A * 4, 0, F32_OPS_PER_S)}
    _say(f"K2 write_plane_strips 3 planes A={A} S={S}: kernel "
         f"{rec['ms']:.4f} ms of device time (profiler, the mean of "
         f"{sum(n for _, n in split.values()) * TIMING_REPS:.0f} launches "
         f"recorded of {TIMING_REPS}), call {rec['call_ms']:.4f} ms "
         f"(events), plain "
         f"{rec['plain_ms']:.4f} ms, bound {rec['bound'][0]:.5f} ms "
         f"({rec['bound'][1]}; launch-bound)")
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


def _run_cli(workdir, args):
    """``cli.run(args)`` in ``workdir`` with every launch count 0 just
    before and the chain instrumented (_instrument_chain); returns (the
    Simulation, its chain log, launch counts, wall s, stdout)."""
    import torch
    from mpmcxx_tpu_torch import cli
    log = {"chunks": [], "refresh": []}
    undo = _instrument_chain(log)
    stdout = io.StringIO()
    cwd = os.getcwd()
    zero_launches()
    t0 = time.time()
    try:
        os.chdir(workdir)
        with contextlib.redirect_stdout(stdout):
            rc, sim = cli.run(args)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        undo()
    if rc != 0:
        raise AssertionError(f"the CLI run in {workdir} exited with {rc}")
    return sim, log, launches_now(), time.time() - t0, stdout.getvalue()


def _check_refreshes(label, log, fields, n_refresh):
    """Before each corrtime refresh, the incremental energies against the
    refresh's full recompute, each field within its tolerance: relative,
    of 1 K where the full value is smaller (a term that is 0 exactly, as
    when the last charged molecule left, keeps its Delta-E sums' rounding)."""
    if len(log["refresh"]) != n_refresh:
        raise AssertionError(f"{label}: {len(log['refresh'])} refreshes, "
                             f"want {n_refresh}")
    for c, (inc, full) in enumerate(log["refresh"]):
        for name, tol in fields:
            diff = abs(inc[name] - full[name])
            rel = diff / max(abs(full[name]), 1.0)
            ok = rel <= tol
            _say(f"{label} corrtime {c + 1}: incremental {name} "
                 f"{inc[name]:.9f} vs full {full[name]:.9f}: rel {rel:.2e} "
                 f"(tol {tol:g})")
            if not ok:
                raise AssertionError(f"{label} {name}: incremental vs full "
                                     f"rel {rel}")


def run_cli_flagship(workdir, golden, device="cuda"):
    """Step 6: the cavity-biased flagship through the port's CLI in
    ``workdir`` (which holds flagship_co2.pqr); returns the launch counts
    of the run."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.io.pqr import read_pqr

    with open(os.path.join(workdir, "run.in"), "w") as f:
        f.write(RUN_IN)
    torch.cuda.reset_peak_memory_stats()
    sim, log, launches, wall, stdout = _run_cli(
        workdir, ["--device", str(device), "run.in"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for line in stdout.splitlines():
        if line.startswith(("SIM_CONTROL: Simulation complete",
                            "OUTPUT: Grand Total", "OUTPUT: Cavity",
                            "OUTPUT: AR")):
            _say("  cli| " + line)
    _say(f"CLI run: exit code 0, {wall:.1f} s wall including set-up")

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
    _check_refreshes("CLI", log, (("rd_energy", 1e-8),
                                  ("coulombic_energy", 1e-8),
                                  ("polarization_energy", 1e-5)), 2)
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
    for name, per_move in (("contract_planes_sym", 4),
                           ("write_plane_strips", 1), ("occupancy", 2)):
        if launches[name] < per_move * n_moves:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"for {n_moves} moves")
    if launches["contract_planes_tri"] or launches["contract_planes"]:
        raise AssertionError("K1 or K4 ran on the default schedule")
    profile_chunk(sim)
    return launches


# kernel-name fragments -> the kernel they belong to (profiler groups)
KERNEL_GROUPS = (("contract_sym_kernel", "K5 contract_planes_sym"),
                 ("sum_sym_slots", "K5 contract_planes_sym"),
                 ("mu_soa_kernel", "K5 contract_planes_sym"),
                 ("contract_planes_kernel", "K1 contract_planes"),
                 ("sum_row_slots", "K1 contract_planes"),
                 ("contract_tri_kernel", "K4 contract_planes_tri"),
                 ("sum_slots_kernel", "K4 contract_planes_tri"),
                 ("write_plane_strips", "K2 write_plane_strips"),
                 ("occupancy_kernel", "K3 occupancy"),
                 ("Memset", "memsets and copies"),
                 ("Memcpy", "memsets and copies"))


def profile_chunk(sim, moves=PROFILE_MOVES):
    """After the CLI run: one ``moves``-move chunk of its chain under
    torch.profiler (after a warm-up chunk), whose device time per move is
    printed split by kernel (ours by name, every other kernel as "torch
    kernels"), beside the wall time per move of one more, unprofiled
    chunk.  Kernels of one stream do not overlap, so their times add."""
    import torch
    from mpmcxx_tpu_torch.mc import chain

    run = chain.make_chunk_runner(sim.flags, sim.params, sim.opts, moves,
                                  topology=sim.topology)
    carry = [sim.carry]

    def chunk():
        carry[0], _ = run(carry[0])

    split = device_split(chunk, reps=1)
    torch.cuda.synchronize()
    t0 = time.time()
    chunk()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / moves
    sim.carry = carry[0]
    groups = {}
    for name, (ms, n) in split.items():
        group = next((g for frag, g in KERNEL_GROUPS if frag in name),
                     "torch kernels")
        g_ms, g_n = groups.get(group, (0.0, 0.0))
        groups[group] = (g_ms + ms, g_n + n)
    device_ms = sum(ms for ms, _ in groups.values()) / moves
    if device_ms == 0.0:
        raise AssertionError("the profiler saw no device time")
    _say(f"CLI profiled chunk ({moves} moves): device {device_ms:.3f} ms "
         f"per move; unprofiled wall {wall_ms:.3f} ms per move (device busy "
         f"{device_ms / wall_ms:.1%}, idle {1 - device_ms / wall_ms:.1%})")
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        _say(f"  {group}: {ms / moves:.4f} ms per move "
             f"({n / moves:.1f} device kernels per move)")


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
                       contraction, label=None):
    """One flagship's main path under the schedule switch in force:
    ``init_carry(seed=0)`` and two CHUNK-move chunks of
    ``make_chunk_runner``, every launch count 0 just before.  Checks the
    initial rd / coulombic / polarization against the model's golden
    (where one exists, rel 2e-6); finite energies; incremental rd /
    coulombic within 1e-8 and polarization within 1e-5 of a fresh
    ``energy_breakdown_blocked`` (at the final box, after NPT volume
    moves); the committed planes within 1e-6 of a fresh ``cache_init``;
    ``contraction`` (the kernel the switch picks) launched >= 4 times per
    move and the other contraction kernels never, the recompute included;
    K2 >= 1 per move that is not a volume move (a volume move rebuilds
    the planes), always with the model's S window rows; in NPT at least
    one volume move proposed.  Returns (launches of the run, second
    chunk's moves/s, the carry)."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown_blocked
    from mpmcxx_tpu_torch.state import topology

    S = opts.max_mol_atoms
    model = label or model
    others = [k for k in ("contract_planes", "contract_planes_sym",
                          "contract_planes_tri") if k != contraction]
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
        movetypes = []
        for c in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            carry, outs = runner(carry)
            torch.cuda.synchronize()
            dt = time.time() - t0
            moves_per_s = CHUNK / dt
            movetypes.append(outs.movetype)
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
    ran = [k for k in others if launches_now()[k]]
    if ran:
        raise AssertionError(f"[{model}] {ran} ran on this schedule")
    n_volume = int((torch.cat(movetypes) == const.MOVETYPE_VOLUME).sum())
    if opts.ensemble == const.ENSEMBLE_NPT:
        vol = const.MOVETYPE_VOLUME
        _say(f"[{model}] volume moves: {acc[vol] + rej[vol]} proposed, "
             f"{acc[vol]} accepted")
        if n_volume == 0:
            raise AssertionError(f"[{model}] no volume move was proposed")
    if launches["write_plane_strips"] < n_moves - n_volume or \
            windows != {S}:
        raise AssertionError(
            f"[{model}] K2 launched {launches['write_plane_strips']} times "
            f"for {n_moves - n_volume} local moves with windows "
            f"{sorted(windows)}, want S={S}")
    _say(f"[{model}] {contraction} {launches[contraction] / n_moves:.2f} "
         f"launches per move, {' and '.join(others)} none; K2 windows "
         f"S = {S}")
    return launches, moves_per_s, carry


def run_example(name, root, workdir, device="cuda"):
    """Phase (a): one example through the port's CLI on the card, at its
    EXAMPLE_STEPS with corrtime half of them.  Checks: exit code 0 and a
    finite energy log; the incremental energies against each refresh
    (rd, coulombic 1e-8; polarization 1e-5 where a polar cache carries
    it); the dense path (blocked_energy False); K1 >= 4 launches per move
    on the polarizable examples and no other contraction kernel, K3 >= 1
    per move on the cavity-biased one, no SCF kernel on the LJ-only
    ones; at least one volume move proposed in NPT.  Returns (launch
    counts, the Simulation, steps/s)."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    d = os.path.join(workdir, name)
    shutil.copytree(os.path.join(root, "examples", name), d)
    n = EXAMPLE_STEPS[name]
    path = os.path.join(d, "run.in")
    with open(path) as f:
        text = f.read()
    text = re.sub(r"(?m)^numsteps .*$", f"numsteps {n}", text)
    text = re.sub(r"(?m)^corrtime .*$", f"corrtime {n // 2}", text)
    with open(path, "w") as f:
        f.write(text)
    sim, log, launches, wall, _ = _run_cli(
        d, ["--quiet", "--device", str(device), "run.in"])
    rows = np.loadtxt(os.path.join(d, sim.cfg.energy_output), ndmin=2)
    if rows.shape[0] != 3 or not np.all(np.isfinite(rows)):
        raise AssertionError(f"{name}: energy log {rows.shape}, or not "
                             "finite")
    if sim.opts.blocked_energy:
        raise AssertionError(f"{name} took the blocked path")
    cache = sim.carry.pcache is not None
    _check_refreshes(name, log, (("rd_energy", 1e-8),
                                 ("coulombic_energy", 1e-8)) +
                     ((("polarization_energy", 1e-5),) if cache else ()), 2)
    mt = torch.cat([o.movetype for _, _, o in log["chunks"]])
    steps_s = n / sum(dt for _, dt, _ in log["chunks"])
    acc = sim.carry.stats.accept.cpu().numpy()
    rej = sim.carry.stats.reject.cpu().numpy()
    counts = ", ".join(f"{const.MOVETYPE_NAMES[m]} {acc[m]}/{acc[m] + rej[m]}"
                       for m in range(7) if acc[m] + rej[m])
    _say(f"example {name}: {sim.state.n_atom_slots} atom slots, {n} steps "
         f"in {wall:.2f} s wall with set-up, chunks {steps_s:.1f} steps/s; "
         f"accepted {counts}; launches {launches}")
    scf = ("contract_planes", "contract_planes_sym", "contract_planes_tri",
           "write_plane_strips")
    if name in POLAR_EXAMPLES:
        if not cache or launches["contract_planes"] < 4 * n or \
                launches["contract_planes_sym"] or \
                launches["contract_planes_tri"]:
            raise AssertionError(f"{name}: K1 launched "
                                 f"{launches['contract_planes']} times for "
                                 f"{n} moves, or another contraction ran")
    elif any(launches[k] for k in scf):
        raise AssertionError(f"{name}: an SCF kernel ran without "
                             "polarization")
    if sim.opts.cavity_bias and launches["occupancy"] < n:
        raise AssertionError(f"{name}: K3 launched {launches['occupancy']} "
                             f"times for {n} moves")
    if sim.cfg.ensemble == const.ENSEMBLE_NPT:
        n_vol = int((mt == const.MOVETYPE_VOLUME).sum())
        _say(f"example {name}: {n_vol} volume moves proposed, "
             f"{acc[const.MOVETYPE_VOLUME]} accepted")
        if n_vol == 0:
            raise AssertionError(f"{name}: no volume move was proposed")
    return launches, sim, steps_s


def check_k1_small(sims, device):
    """Phase (e): K1 against its plain version at the polarizable
    examples' own plane sizes, on their committed planes (square, and
    their first quarter of rows: the framework's and the first sorbates',
    where the dead slots at the end would give only zeros), and on seeded
    planes with no symmetry at the ragged A = SMALL_A (modes 3, 4 and 5;
    square and the middle quarter of rows): relative error <= K1_REL_TOL,
    two launches bitwise equal.  Returns the worst absolute error."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar

    def middle(planes):
        n = planes[0].shape[1]
        return tuple(p[3 * n // 8:3 * n // 8 + max(n // 4, 1)]
                     for p in planes)

    cases = []
    for name, sim in sims.items():
        pc, st = sim.carry.pcache, sim.carry.state
        planes = (pc.dx, pc.dy, pc.dz)
        l = sim.params.polar_damp
        rows = tuple(p[:max(p.shape[0] // 4, 1)] for p in planes)
        cases += [(name, 3, planes, st, l),
                  (f"{name} first quarter of rows", 3, rows, st, l)]
    l = next(iter(sims.values())).params.polar_damp
    for mode in (3, 4, 5):
        planes = _nonsym_planes(SMALL_A, mode, 60 + mode, device)
        cases += [(f"non-symmetric A={SMALL_A}", mode, planes, None, l),
                  (f"non-symmetric A={SMALL_A} rows", mode, middle(planes),
                   None, l)]
    worst = 0.0
    for label, mode, planes, st, l in cases:
        R, A = planes[0].shape
        mu = _mu(A, device, st)
        got = cuda_polar.contract_planes(planes, mu, l)
        again = cuda_polar.contract_planes(planes, mu, l)
        want = cuda_polar.contract_planes_plain(planes, mu, l)
        torch.cuda.synchronize()
        if got.shape != (R, 3) or not torch.equal(got, again):
            raise AssertionError(f"K1 {label} mode {mode}: shape "
                                 f"{tuple(got.shape)}, or two launches on "
                                 "one input differ")
        rel = _rel(got, want)
        err = float(torch.max(torch.abs(got - want)))
        ms = _time_ms(lambda: cuda_polar.contract_planes(planes, mu, l))
        _say(f"K1 contract_planes {label} {R}x{A} mode {mode}: max_abs_err "
             f"{err:.3e} rel_err {rel:.3e}, repeat bitwise equal; "
             f"{ms:.4f} ms")
        if not rel <= K1_REL_TOL:
            raise AssertionError(f"K1 {label} mode {mode}: rel err "
                                 f"{rel:.3e} > {K1_REL_TOL}")
        worst = max(worst, err)
    return worst


def run_cli_nopolar(workdir, golden, device="cuda"):
    """Phase (b): the CO2 flagship's PQR through the CLI with the polar
    and cavity lines of RUN_IN removed: 19,712 slots on the blocked path,
    the incremental LJ/Ewald branch, 2 corrtimes of CHUNK.  Checks: the
    energy log's initial rd and coulombic within 2e-6 of the golden; the
    incremental rd and coulombic within 1e-8 of each refresh; K1, K2, K4
    and K5 never launched.  Returns (launch counts, second corrtime's
    moves/s)."""
    with open(os.path.join(workdir, "run.in"), "w") as f:
        f.write(RUN_IN_NOPOLAR)
    sim, log, launches, wall, _ = _run_cli(
        workdir, ["--quiet", "--device", str(device), "run.in"])
    st = sim.carry.state
    if st.n_atom_slots != CLI_SLOTS or not sim.opts.blocked_energy or \
            sim.opts.polar_incremental or not sim.opts.incremental:
        raise AssertionError(f"CO2 without polarization: {st.n_atom_slots} "
                             f"slots, options {sim.opts}")
    rows = np.loadtxt(os.path.join(workdir, "flagship_lj.energy.dat"),
                      ndmin=2)
    if rows.shape[0] != 3 or not np.all(np.isfinite(rows)):
        raise AssertionError("CO2 without polarization: energy log")
    for comp, col in (("rd", 3), ("coulombic", 2)):
        rel = abs(rows[0][col] - golden[comp]) / abs(golden[comp])
        _say(f"CO2 without polarization: initial {comp} {rows[0][col]:.6f} "
             f"vs reference binary {golden[comp]:.6f}: rel {rel:.2e} "
             "(tol 2e-06)")
        if not rel <= 2e-6:
            raise AssertionError(f"initial {comp} off the golden: {rel}")
    _check_refreshes("CO2 without polarization", log,
                     (("rd_energy", 1e-8), ("coulombic_energy", 1e-8)), 2)
    ran = [k for k in ("contract_planes", "contract_planes_sym",
                       "contract_planes_tri", "write_plane_strips")
           if launches[k]]
    if ran:
        raise AssertionError(f"CO2 without polarization: {ran} launched")
    steps, dt, _ = log["chunks"][-1]
    acc = int(sim.carry.stats.accept.sum())
    _say(f"CO2 without polarization (CLI, {st.n_atom_slots} slots): "
         f"{wall:.1f} s wall with set-up; second corrtime {steps} moves in "
         f"{dt:.3f} s = {steps / dt:.2f} moves/s; {acc} of {2 * CHUNK} "
         f"accepted, N = {int(sim.carry.obs.N)}; launches {launches}")
    return launches, steps / dt


def time_volume_move(carry, flags, params, opts):
    """Wall ms of one NPT volume move (its full recompute and cache
    rebuild included) on ``carry``, synchronised around the step."""
    import torch
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.state import topology
    step = chain.make_step_fn(flags, params, opts,
                              topology=topology(carry.state))
    _, draws, _ = chain.chunk_draws(carry.key, 1)
    d = draws[0].to(carry.state.pos.device)
    torch.cuda.synchronize()
    t0 = time.time()
    carry, out = step(carry, d, None, True)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    _say(f"[ar-npt] one volume move: {ms:.1f} ms wall (accepted "
         f"{bool(out.accepted)})")
    return ms


def run_f64_scf(state, flags, params, opts):
    """Phase (d): the monatomic flagship with polar_mixed off, F64_MOVES
    uVT moves on the full-recompute branch (every proposal a blocked
    recompute whose SCF contracts in float64 row tiles, contract_blocked).
    Checks: finite energies and dipoles; the chain's energies against a
    fresh ``energy_breakdown_blocked`` (1e-8); no kernel of the f32 planes
    launched.  Returns (launch counts, ms per move)."""
    import torch
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown_blocked
    from mpmcxx_tpu_torch.state import topology
    zero_launches()
    t0 = time.time()
    carry = chain.init_carry(state, flags, params, opts, seed=0)
    runner = chain.make_chunk_runner(flags, params, opts, F64_MOVES,
                                     topology=topology(state))
    torch.cuda.synchronize()
    t_init = time.time() - t0
    t0 = time.time()
    carry, outs = runner(carry)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / F64_MOVES
    launches = launches_now()
    eb = energy_breakdown_blocked(carry.state, flags, params)
    for name, full in (("rd_energy", eb.rd), ("coulombic_energy",
                                              eb.coulombic),
                       ("polarization_energy", eb.polarization)):
        got, ref = float(getattr(carry.obs, name)), float(full)
        rel, ok = _close(got, ref, 1e-8)
        _say(f"[ar-f64] {name} {got:.9f} vs full {ref:.9f}: rel {rel:.2e} "
             "(tol 1e-08)")
        if not (ok and np.isfinite(got)):
            raise AssertionError(f"[ar-f64] {name}: chain vs full rel {rel}")
    if not torch.isfinite(carry.state.mu).all():
        raise AssertionError("[ar-f64] dipoles are not finite")
    ran = [k for k in ("contract_planes", "contract_planes_sym",
                       "contract_planes_tri", "write_plane_strips")
           if launches[k]]
    if ran:
        raise AssertionError(f"[ar-f64] {ran} launched without f32 planes")
    _say(f"[ar-f64] init_carry {t_init:.2f} s; {F64_MOVES} moves, "
         f"{int(outs.accepted.sum())} accepted: {ms:.1f} ms per move")
    return launches, ms


def ptxas_report(log):
    """Per kernel of nvcc's build log: its registers, barriers and shared
    memory ("Used ...") and its stack and spills, named by the kernel's
    function name (and plane mode, for the templated contractions)."""
    out, name = [], "?"
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']*)'", line)
        if entry:
            k = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d)E)?", entry.group(1))
            name = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
                    if k else entry.group(1))
        elif "ptxas info" in line and "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line:
            out.append(f"{name}: {line.strip()}")
    return out


def _entry(name, source, replaces, rec, launches, **extra):
    """A kernels-line entry; ``launches`` maps each path to its count;
    ``extra`` adds keys."""
    bound_ms, bound_by = rec["bound"]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n[name] for n in launches.values()),
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, **extra}


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
    from mpmcxx_tpu_torch import constants as const
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
    for line in ptxas_report(kernels.build_log):
        _say("  " + line)

    def flush():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    launches = {}      # path -> launch counts of its run
    rates = {}         # path -> second chunk's moves/s

    # --- 1. the CO2 flagship: K5, K2 vs plain, then its main path --------
    with schedule():
        t0 = time.time()
        state, _, flags, params, opts = build_flagship("co2", device)
        _say(f"CO2 flagship: {state.n_atom_slots} atom slots, "
             f"{int(state.aalive.sum())} live atoms ({time.time() - t0:.1f} "
             "s to build)")
        cache = pcache.cache_init(state, flags, params)
        k5 = check_k5(cache, state, flags, params, device, "CO2 flagship")
        k2 = check_k2(cache, device)
        del cache
        flush()
        launches["co2"], rates["co2"], _ = run_flagship_chain(
            "co2", state, flags, params, opts, root, card,
            "contract_planes_sym")
        del state
        flush()

    # --- 2. K3, then the cavity-biased CO2 flagship through the CLI ------
    with schedule(), tempfile.TemporaryDirectory() as workdir:
        pqr = os.path.join(workdir, "flagship_co2.pqr")
        flagship.write_pqr_co2(pqr)
        # every kernel at the shapes of the CLI run (19,712 slots)
        cli_state = cli_flagship_state(pqr, device)
        cli_cache = pcache.cache_init(cli_state, flags, params)
        k5_cli = check_k5(cli_cache, cli_state, flags, params, device,
                          "CLI flagship", modes=(3,), synthetic=False)
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
        launches["h2"], rates["h2"], _ = run_flagship_chain(
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
    k1 = check_k1(cache, state, flags, params, device,
                  label="monatomic flagship")
    del cache
    flush()
    with schedule(MPMCXX_SYM_KERNEL="0"):
        launches["ar"], rates["ar"], _ = run_flagship_chain(
            "ar", state, flags, params, opts, root, card, "contract_planes")
    del state
    flush()

    # --- 5. the examples through the CLI; K1 at their plane sizes --------
    step_rates = {}
    with schedule(), tempfile.TemporaryDirectory() as workdir:
        sims = {}
        for name in EXAMPLE_STEPS:
            launches[name], sim, step_rates[name] = run_example(
                name, root, workdir)
            if name in POLAR_EXAMPLES:
                sims[name] = sim
        k1["max_abs_err"] = max(k1["max_abs_err"],
                                check_k1_small(sims, device))
        del sims, sim
    flush()

    # --- 6. the CO2 flagship without polarization through the CLI --------
    with schedule(), tempfile.TemporaryDirectory() as workdir:
        flagship.write_pqr_co2(os.path.join(workdir, "flagship_co2.pqr"))
        launches["co2-lj"], rates["co2-lj"] = run_cli_nopolar(
            workdir, load_golden(root, "co2"))
    flush()

    # --- 7. the monatomic flagship in NPT, with its polar cache ----------
    state, _, flags, params, opts = build_flagship("ar", device)
    npt_params = params.replace(pressure=NPT_PRESSURE)
    npt_opts = dataclasses.replace(
        opts, ensemble=const.ENSEMBLE_NPT, move_factor=SMALL_MOVE_FACTOR,
        volume_probability=NPT_VOLUME_PROBABILITY,
        volume_change_factor=NPT_VOLUME_CHANGE)
    with schedule():
        launches["ar-npt"], rates["ar-npt"], carry = run_flagship_chain(
            "ar", state, flags, npt_params, npt_opts, root, card,
            "contract_planes_sym", label="ar-npt")
        volume_ms = time_volume_move(carry, flags, npt_params, npt_opts)
    del carry, state
    flush()

    # --- 8. the monatomic flagship's float64 SCF (polar_mixed off) -------
    state, _, flags, params, opts = build_flagship("ar", device)
    with schedule():
        launches["ar-f64"], f64_ms = run_f64_scf(
            state, flags.replace(polar_mixed=False), params,
            dataclasses.replace(opts, incremental=False,
                                polar_incremental=False,
                                move_factor=SMALL_MOVE_FACTOR))
    del state
    flush()

    _say(f"second-chunk moves/s on {card}: " + ", ".join(
        f"{m} {r:.2f}" for m, r in rates.items()) +
        f"; examples' chunk steps/s: " + ", ".join(
            f"{m} {r:.1f}" for m, r in step_rates.items()) +
        f"; NPT volume move {volume_ms:.1f} ms; f64 SCF {f64_ms:.1f} ms "
        f"per move; whole check {time.time() - t_start:.1f} s after the "
        "card query")
    k5_all = dict(k5_cli, max_abs_err=max(k5["max_abs_err"],
                                          k5_cli["max_abs_err"]))
    k2_all = dict(k2_cli, max_abs_err=max(k2["max_abs_err"],
                                          k2_cli["max_abs_err"]))
    kernels_line = {"kernels": [
        _entry("contract_planes", "mpmcxx_tpu_torch/csrc/contract_planes.cu",
               "mpmcxx_tpu/ops/pallas_polar.py:39", k1, launches,
               main_ms=k1["main_ms"],
               bound_full_planes_ms=k1["bound_full_planes_ms"]),
        _entry("contract_planes_sym",
               "mpmcxx_tpu_torch/csrc/contract_planes_sym.cu",
               "mpmcxx_tpu/ops/pallas_polar.py:209", k5_all, launches,
               k1_ms_same_planes=k5_cli["k1_ms"]),
        _entry("write_plane_strips",
               "mpmcxx_tpu_torch/csrc/write_plane_strips.cu",
               "mpmcxx_tpu/ops/pallas_polar.py:134", k2_all, launches,
               call_ms=k2_all["call_ms"]),
        _entry("occupancy", "mpmcxx_tpu_torch/csrc/occupancy.cu",
               "mpmcxx_tpu/ops/pallas_cavity.py:54", k3, launches,
               darts_ms=k3["darts_ms"]),
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
