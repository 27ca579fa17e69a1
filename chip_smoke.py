#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU, through
its hand-written kernels, and check the result.

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the
   card's ``nvidia-smi`` name and power limit.
2. Builds the kernels from ``mpmcxx_tpu_torch/csrc`` (nvcc, sm_90a) and
   prints the build time and ptxas report.
3. Holds each kernel against its plain PyTorch version on the same device
   inputs: K1 ``contract_planes`` in plane modes 3, 4 and 5 on the CO2
   flagship's own planes (A = 11,264) and on seeded synthetic planes at
   A = 4,096 (relative error <= 1e-5); K2 ``write_plane_strips`` bitwise
   on copies of a flagship plane at window starts 0, mid-plane and A - S
   with all-valid and partly valid windows.  Prints errors and times.
4. Builds the 10,112-atom CO2 uVT polarizable GCMC flagship
   (tools/flagship.py) with the port, runs ``init_carry(seed=0)`` and two
   64-move chunks of ``make_chunk_runner``, and checks: the initial
   rd / coulombic / polarization within 2e-6 (relative) of the reference
   binary's single point (tests/golden/flagship_co2_singlepoint.json);
   finite energies; incremental rd / coulombic within 1e-8 and
   polarization within 1e-5 of a fresh ``energy_breakdown_blocked``; the
   committed planes within 1e-6 of a fresh ``cache_init``; K1 launched
   >= 4 and K2 >= 1 times per move.
5. Holds every kernel against its plain version at the shapes of step
   6's run (the runner's 19,712 atom slots): K1 in mode 3 and K2 as in
   step 3 on that state's planes; K3 ``occupancy`` bitwise on the 24^3
   cavity grid against the atoms, on 51,200 seeded darts against that
   grid's open points, and on points with atoms at r (1 +- 1e-12).
   Prints both times of each.
6. Runs the flagship as a user does, through the port's command line
   (``mpmcxx_tpu_torch.cli``) in a temporary directory: a ``run.in`` with
   cavity bias on (24^3 grid, radius 2.6 A) and the flagship's PQR
   (tools/flagship.write_pqr_co2), 128 uVT moves in two corrtimes at the
   runner's 19,712 atom slots.  Checks: exit code 0; the initial
   rd / coulombic / polarization of the energy log within 2e-6 of the
   golden; finite energies; before each corrtime refresh, incremental
   rd / coulombic within 1e-8 and polarization within 1e-5 of the
   refresh's full recompute; 0 < cavity mean < 1 and two checkpoints;
   the energy log's rows 0, 64, 128; the restart PQR holding 512 + 3 N
   atoms; K1 >= 4, K2 >= 1 and K3 >= 2 launches per move.  Prints the
   second corrtime's moves/s and the peak device memory.
7. Prints ``{"kernels": [...]}`` (launches of step 6, times of step 5,
   the worst error of steps 3 and 5) and, last,
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
TIMING_REPS = 10


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


def _rel(got, want):
    import torch
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def build_flagship(device):
    """The CO2 flagship state and (flags, params, opts) built with the
    port from tools/flagship.py's numpy geometry and constants."""
    import flagship
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.flags import FFlags, RunParams
    from mpmcxx_tpu_torch.mc.chain import MCOptions
    from mpmcxx_tpu_torch.state import AtomRecord, build_state

    framework, mols = flagship.flagship_co2_molecules()
    atoms = [AtomRecord(
        "Fw", "MOF", 1, frozen=True, x=a["x"], y=a["y"], z=a["z"],
        mass=flagship.FRAME_MASS, charge=a["q"] * const.E2REDUCED,
        epsilon=flagship.FRAME_EPS, sigma=flagship.FRAME_SIG,
        polarizability=flagship.FRAME_ALPHA) for a in framework]
    for m in range(flagship.N_CO2):
        for site, (at, mass, q, al, eps, sig) in \
                enumerate(flagship.CO2_SITES):
            p = mols[m, site]
            atoms.append(AtomRecord(
                at, "CO2", 100 + m, x=p[0], y=p[1], z=p[2], mass=mass,
                charge=q * const.E2REDUCED, epsilon=eps, sigma=sig,
                polarizability=al))
    state, meta = build_state(atoms, np.eye(3) * flagship.L,
                              extra_mol_capacity=flagship.CO2_EXTRA_SLOTS,
                              device=device)
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
        incremental=True, polar_incremental=True, max_mol_atoms=3,
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


def check_k1(cache, flags, params, device, label="flagship",
             modes=(3, 4, 5), synthetic=True):
    """K1 vs its plain version on ``cache``'s planes in ``modes`` (and on
    seeded synthetic planes at SYNTH_A when ``synthetic``); returns the
    record for the kernels line, timed on ``cache``'s mode-3 planes.  The
    mode-4 and mode-5 planes are the same pair tensor in the other
    representations of fold_outer_rows."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar
    from mpmcxx_tpu_torch.ops.polar import coeffs_from_d, fold_outer_rows

    l = params.polar_damp
    planes3 = (cache.dx, cache.dy, cache.dz)
    A = planes3[0].shape[0]

    def own(mode):
        if mode == 3:
            return planes3
        co, cd = coeffs_from_d(*planes3, l)
        return fold_outer_rows(co, cd, *planes3, flags.replace(
            polar_plane_mode=4) if mode == 4 else flags.replace(
            polar_wolf_full=True))

    worst_abs = 0.0
    rec = {}
    cases = [(label, A, own)]
    if synthetic:
        cases.append(("synthetic", SYNTH_A,
                      lambda m: _synthetic_planes(SYNTH_A, m, 10 + m, device)))
    for name, A_, planes_of_mode in cases:
        mu = torch.from_numpy(np.random.default_rng(A_).normal(
            size=(A_, 3)) * 0.1).to(device)
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
            _say(f"K1 contract_planes {name} A={A_} mode {mode}: "
                 f"max_abs_err {err:.3e} rel_err {rel:.3e}  kernel "
                 f"{ms:.3f} ms  plain {plain_ms:.3f} ms  "
                 f"({mode * A_ * A_ * 4 / ms / 1e6:.0f} GB/s of planes)")
            if not rel <= K1_REL_TOL:
                raise AssertionError(
                    f"K1 {name} mode {mode}: rel err {rel:.3e} > "
                    f"{K1_REL_TOL}")
            worst_abs = max(worst_abs, err)
            if name == label and mode == 3:
                rec = {"ms": ms, "plain_ms": plain_ms}
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
            rec.update(ms=ms, plain_ms=plain_ms)
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
    from mpmcxx_tpu_torch.ops import cuda_cavity, cuda_polar

    with open(os.path.join(workdir, "run.in"), "w") as f:
        f.write(RUN_IN)
    log = {"chunks": [], "refresh": []}
    undo = _instrument_chain(log)
    stdout = io.StringIO()
    cwd = os.getcwd()
    cuda_polar.contract_planes.launches = 0
    cuda_polar.write_plane_strips.launches = 0
    cuda_cavity.occupancy.launches = 0
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
    launches = {"contract_planes": cuda_polar.contract_planes.launches,
                "write_plane_strips": cuda_polar.write_plane_strips.launches,
                "occupancy": cuda_cavity.occupancy.launches}
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
    return launches


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
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops import cuda_polar, kernels
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown_blocked
    from mpmcxx_tpu_torch.state import topology

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    _say(f"card: {card}")
    _say(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")

    t0 = time.time()
    path = kernels.build()
    kernels.load()
    _say(f"kernels built in {time.time() - t0:.1f} s: {path}")
    for line in kernels.build_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "spill" in line):
            _say("  " + line.strip())

    # --- kernels against their plain versions (launches not counted) ----
    t0 = time.time()
    state, _, flags, params, opts = build_flagship(device)
    A = state.n_atom_slots
    _say(f"flagship: {A} atom slots, {int(state.aalive.sum())} live atoms "
         f"({time.time() - t0:.1f} s to build)")
    cache = pcache.cache_init(state, flags, params)
    k1 = check_k1(cache, flags, params, device)
    k2 = check_k2(cache, device)
    del cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # --- the main path -----------------------------------------------------
    cuda_polar.contract_planes.launches = 0
    cuda_polar.write_plane_strips.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    carry = chain.init_carry(state, flags, params, opts, seed=0)
    runner = chain.make_chunk_runner(flags, params, opts, CHUNK,
                                     topology=topology(state))
    e0 = float(carry.obs.energy)
    _say(f"init_carry: E = {e0:.6f} K, N = {int(carry.obs.N)} "
         f"({time.time() - t0:.2f} s)")
    # the reference binary's single-point breakdown of this configuration
    # (tests/golden, gated at rel 2e-6 by tests/test_golden.py)
    with open(os.path.join(root, "tests", "golden",
                           "flagship_co2_singlepoint.json")) as f:
        golden = json.load(f)["expected"]
    for comp, field in (("rd", "rd_energy"), ("coulombic", "coulombic_energy"),
                        ("polar", "polarization_energy")):
        ours = float(getattr(carry.obs, field))
        rel = abs(ours - golden[comp]) / abs(golden[comp])
        _say(f"initial {comp} {ours:.6f} vs reference binary "
             f"{golden[comp]:.6f}: rel {rel:.2e} (tol 2e-06)")
        if not rel <= 2e-6:
            raise AssertionError(f"initial {comp} off the reference: {rel}")
    moves_per_s = None
    for c in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        carry, outs = runner(carry)
        torch.cuda.synchronize()
        dt = time.time() - t0
        moves_per_s = CHUNK / dt
        _say(f"chunk {c}: {CHUNK} moves in {dt:.3f} s = {moves_per_s:.2f} "
             f"moves/s; E = {float(carry.obs.energy):.6f} K, "
             f"N = {int(carry.obs.N)}")
    launches = {"contract_planes": cuda_polar.contract_planes.launches,
                "write_plane_strips": cuda_polar.write_plane_strips.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    acc = carry.stats.accept.cpu().numpy()
    rej = carry.stats.reject.cpu().numpy()
    from mpmcxx_tpu_torch import constants as const
    for mt, name in const.MOVETYPE_NAMES.items():
        if acc[mt] + rej[mt]:
            _say(f"  {name}: {acc[mt]} accepted / {acc[mt] + rej[mt]}")
    _say(f"second chunk: {moves_per_s:.2f} moves/s on {card}; peak device "
         f"memory {peak_gb:.2f} GB; launches {launches}")

    # --- is the result right? --------------------------------------------
    n_moves = 2 * CHUNK
    obs = carry.obs
    for name in ("energy", "rd_energy", "coulombic_energy",
                 "polarization_energy"):
        if not np.isfinite(float(getattr(obs, name))):
            raise AssertionError(f"{name} is not finite")
    if not torch.isfinite(carry.state.mu).all():
        raise AssertionError("dipoles are not finite")
    eb = energy_breakdown_blocked(carry.state, flags, params)
    for name, full, tol in (("rd_energy", eb.rd, 1e-8),
                            ("coulombic_energy", eb.coulombic, 1e-8),
                            ("polarization_energy", eb.polarization, 1e-5)):
        inc, ref = float(getattr(obs, name)), float(full)
        rel = abs(inc - ref) / abs(ref)
        _say(f"incremental {name} {inc:.9f} vs full {ref:.9f}: rel "
             f"{rel:.2e} (tol {tol:g})")
        if not rel <= tol:
            raise AssertionError(f"{name}: incremental vs full rel {rel}")
    # 128 in-place commits (K2) left the planes those of a full rebuild
    fresh = pcache.cache_init(carry.state, flags, params)
    for name in ("dx", "dy", "dz"):
        diff = float(torch.max(torch.abs(getattr(carry.pcache, name) -
                                         getattr(fresh, name))))
        _say(f"committed plane {name} vs rebuild: max |diff| {diff:.3e}")
        if not diff <= 1e-6:
            raise AssertionError(f"plane {name} drifted from a rebuild")
    del fresh
    if launches["contract_planes"] < 4 * n_moves:
        raise AssertionError(f"K1 launched {launches['contract_planes']} "
                             f"times for {n_moves} moves")
    if launches["write_plane_strips"] < n_moves:
        raise AssertionError(f"K2 launched "
                             f"{launches['write_plane_strips']} times for "
                             f"{n_moves} moves")
    del carry, runner, state, eb
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # --- K3, then the cavity-biased flagship through the CLI --------------
    with tempfile.TemporaryDirectory() as workdir:
        pqr = os.path.join(workdir, "flagship_co2.pqr")
        flagship.write_pqr_co2(pqr)
        # every kernel at the shapes of the CLI run (19,712 slots)
        cli_state = cli_flagship_state(pqr, device)
        cli_cache = pcache.cache_init(cli_state, flags, params)
        k1_cli = check_k1(cli_cache, flags, params, device,
                          label="CLI flagship", modes=(3,), synthetic=False)
        k2_cli = check_k2(cli_cache, device)
        del cli_cache
        k3 = check_k3(cli_state, device)
        del cli_state
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        launches = run_cli_flagship(workdir, golden)

    kernels_line = {"kernels": [
        {"name": "contract_planes", "route": "cuda",
         "source": "mpmcxx_tpu_torch/csrc/contract_planes.cu",
         "replaces": "mpmcxx_tpu/ops/pallas_polar.py:209",
         "launches": launches["contract_planes"],
         "max_abs_err": max(k1["max_abs_err"], k1_cli["max_abs_err"]),
         "ms": k1_cli["ms"], "plain_ms": k1_cli["plain_ms"]},
        {"name": "write_plane_strips", "route": "cuda",
         "source": "mpmcxx_tpu_torch/csrc/write_plane_strips.cu",
         "replaces": "mpmcxx_tpu/ops/pallas_polar.py:134",
         "launches": launches["write_plane_strips"],
         "max_abs_err": max(k2["max_abs_err"], k2_cli["max_abs_err"]),
         "ms": k2_cli["ms"], "plain_ms": k2_cli["plain_ms"]},
        {"name": "occupancy", "route": "cuda",
         "source": "mpmcxx_tpu_torch/csrc/occupancy.cu",
         "replaces": "mpmcxx_tpu/ops/pallas_cavity.py:54",
         "launches": launches["occupancy"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"]},
    ]}
    _say(json.dumps(kernels_line))
    _say(card)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
