"""SCF warm starts on the CO2 flagship, held to a converged SCF.

Twin: tools/warmstart_study.py, on the port's
``flagship.build_state_co2(extra_mol_capacity=384)`` (11,264 slots).
The flagship solves the Thole SCF with a fixed K = 4 Jacobi iterations
per move from the reference's cold start alpha * E; ``polar_warm_start``
starts from the last accepted dipoles instead.  For cold-4, warm-2,
warm-3 and warm-4, a GCMC chain of ``chunks`` x ``chunk_steps`` moves
from ``init_carry(seed=0)`` is stopped after each chunk, and its carried
polarization energy is compared with a from-scratch converged SCF of the
same configuration (``polar_max_iter`` 0, precision 1e-12, cold mu).

One departure from the tool: the tool solves its truth on the float32
planes (``polar_mixed``), where a precision of 1e-12 D is out of reach;
there the JAX package and the port both run the 128 sweeps and take the
divergence fallback mu = alpha * E (on the mini geometry's first state
-166.08 K where the converged SCF gives -144.60 K).  The truth here is
the float64 row-tile SCF (``polar_mixed`` off), which converges, and each
checkpoint records its iterations and whether it failed.

The tool's decision rule: warm-K is an acceptable default iff its
largest error on the total-energy scale is at most cold-4's (or 1e-6).
The JAX study (mini geometry, 8 x 64 moves, against the fallback;
docs/PERF.md, "SCF warm starts") found every warm variant WORSE, so
``polar_warm_start`` stayed off.  The record gives the port's decision
beside that one; it does not gate on it, since the JAX study's truth was
the fallback.  The verdict is "agree" when every checkpoint's truth
converged and every error is finite: the measurement holds.

``mini``: the tool's shrunk geometry (G_FRAME 4, N_CO2 48, N_SORB 150,
8 insertion slots), set on ``flagship`` only while the state is built.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np

from . import common

CHUNKS = 8
CHUNK_STEPS = 64
ITERS = (2, 3, 4)
TRUTH_PRECISION = 1e-12
# rows per tile of the float64 truth: each of its ~100 sweeps rebuilds the
# pair geometry tile by tile, so a tall tile launches fewer kernels
TRUTH_BLOCK = 2048
# the JAX study's result (mini geometry): variant -> (median polar error,
# largest error on the total-energy scale) and the rule's decision
JAX_MINI = {"cold-4": (5.3e-2, 1.8e-2), "warm-2": (6.9e-2, 2.6e-2),
            "warm-3": (5.7e-2, 1.9e-2), "warm-4": (6.9e-2, 2.5e-2)}
JAX_DECISION = {"warm-2": "WORSE", "warm-3": "WORSE", "warm-4": "WORSE"}


@contextlib.contextmanager
def mini_geometry():
    """The tool's --mini geometry on the port's flagship module, restored
    when the block ends."""
    from .. import flagship
    saved = flagship.G_FRAME, flagship.N_CO2, flagship.N_SORB
    flagship.G_FRAME, flagship.N_CO2, flagship.N_SORB = 4, 48, 150
    try:
        yield
    finally:
        flagship.G_FRAME, flagship.N_CO2, flagship.N_SORB = saved


def build(mini: bool, device):
    """(state, meta, flags, params, opts) of the CO2 flagship, full width
    (384 insertion slots) or the mini geometry (8)."""
    from .. import flagship
    if mini:
        with mini_geometry():
            return flagship.build_state_co2(extra_mol_capacity=8,
                                            device=device)
    return flagship.build_state_co2(extra_mol_capacity=384, device=device)


def truth_block(state) -> int:
    """Rows per tile of a blocked recompute of ``state``: TRUTH_BLOCK, or
    every slot when there are fewer."""
    return min(TRUTH_BLOCK, state.n_atom_slots)


def converged_polar(state, flags, params, polar_mixed: bool = False):
    """The from-scratch SCF of ``state`` (the tool's ``converged_polar``):
    mu zeroed, ``polar_max_iter`` 0 and precision 1e-12, in float64 row
    tiles, or on the f32 planes as the tool solves it (``polar_mixed``).
    Returns the blocked energy breakdown."""
    from ..ops.energy import energy_breakdown_blocked
    st = state.replace(mu=state.mu * 0.0)
    return energy_breakdown_blocked(
        st, flags.replace(polar_max_iter=0, polar_warm_start=False,
                          polar_mixed=polar_mixed),
        params.replace(polar_precision=TRUTH_PRECISION),
        block=truth_block(state))


def variants(flags):
    """(name, K, warm) of the tool's variants: cold only at the flagship's
    K, warm at each of ITERS."""
    out = []
    for warm in (False, True):
        for K in ITERS:
            if not warm and K != flags.polar_max_iter:
                continue
            out.append((f"{'warm' if warm else 'cold'}-{K}", K, warm))
    return out


def run_variant(system, K: int, warm: bool, chunks: int, chunk_steps: int,
                seed: int = 0, on_chunk=None):
    """One variant's chain from ``init_carry(seed)``: per chunk the
    carried polarization energy, the converged truth's polarization and
    total energies, its iterations and whether it failed.  ``on_chunk``,
    when given, is called with (carry, the variant's flags, params, the
    truth's breakdown)."""
    from ..mc import chain
    from ..state import topology
    state, _meta, flags, params, opts = system
    fl = flags.replace(polar_max_iter=K, polar_warm_start=warm)
    # each variant starts from its own copy of the built state
    carry = chain.init_carry(copy.deepcopy(state), fl, params, opts,
                             seed=seed)
    runner = chain.make_chunk_runner(fl, params, opts, chunk_steps,
                                     topology=topology(state))
    out = []
    for _ in range(chunks):
        carry, _ = runner(carry)
        eb = converged_polar(carry.state, flags, params)
        out.append(dict(chain=float(carry.obs.polarization_energy),
                        truth=float(eb.polarization), total=float(eb.total),
                        iterations=float(eb.polarization_iterations),
                        failed=bool(eb.iterator_failed)))
        if on_chunk is not None:
            on_chunk(carry, fl, params, eb)
    return out


def errors(points) -> dict:
    """The tool's summary of a variant's checkpoints."""
    errs = [abs(p["chain"] - p["truth"]) / max(abs(p["truth"]), 1e-12)
            for p in points]
    terrs = [abs(p["chain"] - p["truth"]) / max(abs(p["total"]), 1.0)
             for p in points]
    return {"rel_err_polar_max": max(errs),
            "rel_err_polar_median": float(np.median(errs)),
            "rel_err_total_max": max(terrs)}


def decide(results: dict) -> dict:
    """The tool's decision rule: warm-K "OK" iff its total-scale error is
    at most max(cold-4's, 1e-6), else "WORSE"."""
    cold4 = results["cold-4"]["rel_err_total_max"]
    return {name: ("OK" if r["rel_err_total_max"] <= max(cold4, 1e-6)
                   else "WORSE")
            for name, r in results.items() if name.startswith("warm")}


def run(chunks: int = CHUNKS, chunk_steps: int = CHUNK_STEPS, seed: int = 0,
        device="cuda", mini: bool = False) -> dict:
    """Run the warm-start study on ``device``: the JSON record."""
    study = "warmstart"
    system = build(mini, device)
    common.log(study, f"CO2 flagship{' (mini)' if mini else ''}: "
               f"{system[0].n_atom_slots} atom slots; {chunks} x "
               f"{chunk_steps} moves per variant")
    results, failed = {}, 0
    for name, K, warm in variants(system[2]):
        clock = common.Clock(device)
        points = run_variant(system, K, warm, chunks, chunk_steps, seed)
        results[name] = dict(errors(points), wall_s=clock.seconds(),
                             checkpoints=points)
        failed += sum(p["failed"] for p in points)
        r = results[name]
        common.log(study, f"{name}: polar rel err median "
                   f"{r['rel_err_polar_median']:.2e} max "
                   f"{r['rel_err_polar_max']:.2e}; vs total max "
                   f"{r['rel_err_total_max']:.2e}")
    decision = decide(results)
    for name, d in decision.items():
        common.log(study, f"{name}: {d} (total-scale err "
                   f"{results[name]['rel_err_total_max']:.2e} vs cold-4 "
                   f"{results['cold-4']['rel_err_total_max']:.2e}); the JAX "
                   f"study: {JAX_DECISION.get(name)}")
    finite = all(np.isfinite(r[k]) for r in results.values()
                 for k in ("rel_err_polar_max", "rel_err_total_max"))
    return dict(
        study=study, steps=chunks * chunk_steps, chunks=chunks,
        chunk_steps=chunk_steps, seed=seed, mini=mini,
        slots=system[0].n_atom_slots,
        wall_s=sum(r["wall_s"] for r in results.values()),
        variants=results, decision=decision,
        truths={"jax_mini": {k: list(v) for k, v in JAX_MINI.items()},
                "jax_decision": JAX_DECISION},
        decision_matches_jax=all(JAX_DECISION.get(k) == v
                                 for k, v in decision.items()),
        truth_failed=failed,
        verdict="agree" if finite and not failed else "disagree")
