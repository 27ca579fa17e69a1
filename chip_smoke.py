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
5. Prints ``{"kernels": [...]}`` and, last,
   ``{"ok": true, "device": {...}}``.  Any failure raises: non-zero exit,
   no result line.

Imports torch, numpy and the port only (never jax).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

CHUNK = 64
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


def check_k1(cache, flags, params, device):
    """K1 vs its plain version; returns the record for the kernels line.
    The flagship's mode-4 and mode-5 planes are the same pair tensor in
    the other representations of fold_outer_rows."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar
    from mpmcxx_tpu_torch.ops.polar import coeffs_from_d, fold_outer_rows

    l = params.polar_damp
    planes3 = (cache.dx, cache.dy, cache.dz)
    A = planes3[0].shape[0]
    co, cd = coeffs_from_d(*planes3, l)
    own = {3: planes3,
           4: fold_outer_rows(co, cd, *planes3,
                              flags.replace(polar_plane_mode=4)),
           5: fold_outer_rows(co, cd, *planes3,
                              flags.replace(polar_wolf_full=True))}
    del co, cd
    worst_abs = 0.0
    rec = {}
    for label, A_, planes_of_mode in (
            ("flagship", A, lambda m: own[m]),
            ("synthetic", SYNTH_A,
             lambda m: _synthetic_planes(SYNTH_A, m, 10 + m, device))):
        mu = torch.from_numpy(np.random.default_rng(A_).normal(
            size=(A_, 3)) * 0.1).to(device)
        for mode in (3, 4, 5):
            planes = planes_of_mode(mode)
            got = cuda_polar.contract_planes(planes, mu, l)
            want = cuda_polar.contract_planes_plain(planes, mu, l)
            torch.cuda.synchronize()
            rel = _rel(got, want)
            err = float(torch.max(torch.abs(got - want)))
            ms = _time_ms(lambda: cuda_polar.contract_planes(planes, mu, l))
            plain_ms = _time_ms(
                lambda: cuda_polar.contract_planes_plain(planes, mu, l))
            _say(f"K1 contract_planes {label} A={A_} mode {mode}: "
                 f"max_abs_err {err:.3e} rel_err {rel:.3e}  kernel "
                 f"{ms:.3f} ms  plain {plain_ms:.3f} ms  "
                 f"({mode * A_ * A_ * 4 / ms / 1e6:.0f} GB/s of planes)")
            if not rel <= K1_REL_TOL:
                raise AssertionError(
                    f"K1 {label} mode {mode}: rel err {rel:.3e} > "
                    f"{K1_REL_TOL}")
            worst_abs = max(worst_abs, err)
            if label == "flagship" and mode == 3:
                rec = {"ms": ms, "plain_ms": plain_ms}
            del planes
    own.clear()
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

    kernels_line = {"kernels": [
        {"name": "contract_planes", "route": "cuda",
         "source": "mpmcxx_tpu_torch/csrc/contract_planes.cu",
         "replaces": "mpmcxx_tpu/ops/pallas_polar.py:209",
         "launches": launches["contract_planes"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "write_plane_strips", "route": "cuda",
         "source": "mpmcxx_tpu_torch/csrc/write_plane_strips.cu",
         "replaces": "mpmcxx_tpu/ops/pallas_polar.py:134",
         "launches": launches["write_plane_strips"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]},
    ]}
    _say(json.dumps(kernels_line))
    _say(card)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
