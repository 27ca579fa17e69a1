"""Thole dipole polarization.

JAX twin: mpmcxx_tpu/ops/polar.py, all of it.  The Thole dipole tensor
under off, linear or exponential damping with the optional
polar_wolf_full correction (thole_tile, thole_amatrix; polar.py:46-116);
the static field under the no-PBC, Wolf or Ewald treatment (thole_field,
thole_field_blocked, field_scalars; :140-249, :582-609; the twin's
per-treatment thole_field_nopbc and thole_field_wolf are field_scalars'
branches here); the SCF solvers
(:252-471): the reference's Jacobi sweep with SOR/ESOR relaxation,
fixed-count or precision-terminated with the 128-iteration divergence
fallback, ZODID, the warm start, the sequential Gauss-Seidel and ranked
Gauss-Seidel sweeps of the dense A matrix (gs_rank_order, _gs_sweep) and
the exact solve (thole_exact, an LU solve of the [3A,3A] matrix); the
full-Ewald SCF (:474-579); the matrix-free float64 contraction in row
tiles (contract_blocked); the float32 pair-coefficient planes of the
mixed-precision SCF (mixed_coeff_scalars, plane_mode, coeffs_from_d,
fold_outer_rows, mixed_field_coeffs) and the contraction ``-T mu`` over
them (contract_mixed, which runs a hand-written CUDA kernel of
ops/cuda_polar.py on a CUDA tensor, chosen by the JAX package's
MPMCXX_SYM_KERNEL / MPMCXX_TRI_KERNEL switch: K4, K5 or K1 where it runs
B3, B2, or B1 and its XLA branch); the matrix-free solve with Palmo's
correction and the conjugate-gradient exact branch (finish_polar,
polar_blocked, cg_solve); the dispatcher ``polar``; and the
polarizability-tensor report.  Energy = -1/2 sum mu . E_static (+ the
Palmo correction) in Kelvin.

The twin ends its loops on the device (``lax.while_loop``).  Here a loop
runs in groups of LOOP_GROUP iterations (_grouped_while): an iteration
whose loop has ended leaves the carry as it is, and the host reads
whether the loop goes on once per group, so the result is bitwise the
same whatever the group size.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as const
from ..flags import FFlags, RunParams
from ..parallel import meshing
from ..state import SystemState
from . import cuda_polar
from .ewald import kvectors
from .pairwise import (PairTensors, _arange, assemble_tiles, build_pairs,
                       build_pairs_rect, phase_dot, tile_starts)

# iterations of a device-side loop between two host reads of whether it
# has ended (the precision-terminated SCF, the full-Ewald SCF and CG):
# one sync per group, and up to LOOP_GROUP - 1 iterations computed and
# discarded past the end.  1, because the chain's step is host-bound: a
# host read costs less than the iterations a larger group discards
# (chip_smoke.py step 18 runs the same moves at groups 1 and 8)
LOOP_GROUP = 1
# the exact solve over planes or row tiles: CG to gamma <= tol^2 b.b or
# CG_MAXITER steps, the twin's cg(..., tol=1e-12, maxiter=400)
# (polar.py:939-940)
CG_TOL = 1e-12
CG_MAXITER = 400


class PolarResult(NamedTuple):
    energy: torch.Tensor          # polarization energy (K)
    mu: torch.Tensor              # [A,3] converged dipoles
    iterations: torch.Tensor      # iteration count (f64)
    iterator_failed: torch.Tensor # bool
    dipole_rrms: torch.Tensor     # mean dipole rrms


def _thole_damps(state: SystemState, pt: PairTensors, flags: FFlags,
                 params: RunParams):
    """(damp1, damp2, wdamp1, wdamp2) of the Thole damping for the pairs
    in pt (src/System.Energy.cpp:2712-2742; polar.py:612-636).  Linear
    damping reads the row atoms' polarizability through ``pt.row``, so an
    [S,A] window or [B,A] tile pairs the right atoms."""
    l = params.polar_damp
    rcut = state.pbc.cutoff
    r = pt.rimg
    if flags.damp_type == const.DAMPING_OFF:
        damp1 = torch.where(pt.es_excluded, 0.0, 1.0).to(r.dtype)
        return damp1, damp1, damp1, damp1
    if flags.damp_type == const.DAMPING_LINEAR:
        ai = pt.row(state.polarizability)[:, None] * \
            state.polarizability[None, :]
        sd = l * ai ** (1.0 / 6.0)
        v = r / torch.where(sd == 0.0, 1.0, sd)
        damp1 = torch.where(r < sd, (4.0 - 3.0 * v) * v ** 3, 1.0)
        damp2 = torch.where(r < sd, v ** 4, 1.0)
        return damp1, damp2, torch.ones_like(damp1), torch.ones_like(damp2)
    explr = torch.exp(-l * r)
    damp1 = 1.0 - explr * (0.5 * l * l * r * r + l * r + 1.0)
    damp2 = damp1 - explr * (l ** 3 * r ** 3 / 6.0)
    explrcut = torch.exp(-l * rcut)
    wdamp1 = 1.0 - explrcut * (0.5 * l * l * rcut * rcut + l * rcut + 1.0)
    wdamp2 = wdamp1 - explrcut * (l ** 3 * rcut ** 3 / 6.0)
    return damp1, damp2, wdamp1, wdamp2


def _not_self(state: SystemState, pt: PairTensors):
    A = state.n_atom_slots
    if pt.rows is None:
        return ~torch.eye(A, dtype=torch.bool, device=state.pos.device)
    safe = pt.rows.clamp(0, A - 1)
    return (_arange(A, safe)[None, :] != safe[:, None]) & \
        (pt.rows >= 0)[:, None]


def thole_tile(state: SystemState, pt: PairTensors, flags: FFlags,
               params: RunParams):
    """Off-diagonal Thole dipole-tensor blocks for the pairs in ``pt``
    ([R,A,3,3]; src/System.Energy.cpp:2694-2767; polar.py:46-98)."""
    rcut = state.pbc.cutoff
    r = pt.rimg
    ir = 1.0 / torch.where(r == 0.0, 1.0, r)
    ir3 = torch.where(r == 0.0, const.MAXVALUE, ir ** 3)
    ir5 = torch.where(r == 0.0, const.MAXVALUE, ir ** 5)
    damp1, damp2, wdamp1, wdamp2 = _thole_damps(state, pt, flags, params)
    d = pt.dimg
    outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    block = (-3.0 * outer * (damp2 * ir5)[..., None, None] +
             eye * (damp1 * ir3)[..., None, None])
    if flags.polar_wolf_full:
        block = block + (3.0 * outer *
                         (wdamp2 * ir * ir / rcut ** 3)[..., None, None] -
                         eye * (wdamp1 / rcut ** 3)[..., None, None])
    offdiag = _not_self(state, pt) & pt.alive
    return torch.where(offdiag[..., None, None], block, 0.0)


def thole_amatrix(state: SystemState, pt: PairTensors, flags: FFlags,
                  params: RunParams):
    """[A,A,3,3] dipole field tensor of the dense pairs ``pt``
    (src/System.Energy.cpp:2661-2770): diagonal blocks 1/alpha * I
    (MAXVALUE where alpha == 0), zero off-diagonal blocks for dead atoms."""
    A = state.n_atom_slots
    block = thole_tile(state, pt, flags, params)
    alpha = state.polarizability
    inv_alpha = torch.where(alpha != 0.0,
                            1.0 / torch.where(alpha == 0.0, 1.0, alpha),
                            const.MAXVALUE)
    idx = _arange(A, alpha)
    block[idx, idx] = torch.eye(3, dtype=alpha.dtype,
                                device=alpha.device) * inv_alpha[:, None, None]
    return block


def contract_matrix(Amat):
    """The off-diagonal blocks of ``Amat`` as one float64 [3A, 3A] matrix
    M, so that ef_induced = -sum_{j != i} A_ij mu_j (the twin's _contract,
    polar.py:256-261) is ``-(M @ mu.reshape(-1)).reshape(A, 3)``."""
    A = Amat.shape[0]
    diag = torch.eye(A, dtype=torch.bool, device=Amat.device)
    off = torch.where(diag[:, :, None, None], 0.0, Amat)
    return off.permute(0, 2, 1, 3).reshape(3 * A, 3 * A)


def damp_factor(t, i: int):
    """(src/System.Energy.cpp:3108-3116; polar.py:119-124)"""
    temp = 1.0 + t + 0.5 * t * t
    if i == 3:
        temp = temp + t ** 3 / 6.0
    return temp * torch.exp(-t)


# ---------------------------------------------------------------------------
# static fields
# ---------------------------------------------------------------------------

def _nopbc_field_scalars(state: SystemState, pt: PairTensors):
    """Masked per-pair scalar f with E_i = sum_j f_ij q_j d_ij
    (src/System.Energy.cpp:3300-3333; polar.py:140-149): inside the
    cutoff by ``rimg - SMALL_dR < cutoff``; symmetric in (i, j)."""
    mask = (~pt.frozen & ~pt.same_mol & pt.alive &
            (pt.rimg - const.SMALL_dR < state.pbc.cutoff) &
            (pt.rimg != 0.0) & _not_self(state, pt))
    r3 = torch.where(pt.rimg == 0.0, 1.0, pt.rimg) ** 3
    return torch.where(mask, 1.0 / r3, 0.0)


def _wolf_field_scalars(state: SystemState, pt: PairTensors, flags: FFlags,
                        params: RunParams):
    """(src/System.Energy.cpp:3337-3396; polar.py:159-177); symmetric in
    (i, j)."""
    R = state.pbc.cutoff
    rR = 1.0 / R
    a = params.polar_wolf_alpha
    mask = (~pt.frozen & ~pt.same_mol & pt.alive &
            (pt.rimg - const.SMALL_dR < R) & (pt.rimg != 0.0) &
            _not_self(state, pt))
    r = torch.where(pt.rimg == 0.0, 1.0, pt.rimg)
    rr = 1.0 / r
    if a == 0.0:
        f = (rr * rr - rR * rR) * rr
    else:
        cutoffterm = (torch.special.erfc(a * R) * rR * rR +
                      2.0 * a * const.OneOverSqrtPi *
                      torch.exp(-a * a * R * R) * rR)
        bigmess = (torch.special.erfc(a * r) * rr * rr +
                   2.0 * a * const.OneOverSqrtPi *
                   torch.exp(-a * a * r * r) * rr)
        f = (bigmess - cutoffterm) * rr
    return torch.where(mask, f, 0.0)


def recip_term(state: SystemState, flags: FFlags, params: RunParams):
    """k-space static field (src/System.Energy.cpp:2834-2896)."""
    ea = params.polar_ewald_alpha
    k, k2 = kvectors(state, flags.ewald_kmax)       # [K,3],[K]
    q = torch.where(state.atom_alive(), state.charge, 0.0)
    phase = phase_dot(state.pos, k)                 # [A,K]
    cosp, sinp = torch.cos(phase), torch.sin(phase)
    f1 = q @ cosp                                   # [K] sum q cos
    f2 = q @ sinp
    kweight = k / k2[:, None] * torch.exp(-k2 / (4.0 * ea * ea))[:, None]
    # E_i[p] += kw[k,p]*(sin(k.r_i)*f1 - cos(k.r_i)*f2)
    coeff = sinp * f1[None, :] - cosp * f2[None, :]  # [A,K]
    return coeff @ kweight * 8.0 * const.pi / state.pbc.volume


def _real_field_scalars(state: SystemState, pt: PairTensors,
                        params: RunParams):
    """(src/System.Energy.cpp:2900-2940); symmetric in (i, j)."""
    a = params.polar_ewald_alpha
    base = pt.alive & ~pt.frozen & _not_self(state, pt) & \
        (pt.rimg != 0.0) & ~(pt.rimg > state.pbc.cutoff)
    r = torch.where(pt.rimg == 0.0, 1.0, pt.rimg)
    r2 = r * r
    g = 2.0 * a * const.OneOverSqrtPi * torch.exp(-a * a * r2) * r
    f_ex = (g - torch.special.erf(a * r)) / (r * r2)
    f_in = (g + torch.special.erfc(a * r)) / (r2 * r)
    f = torch.where(pt.es_excluded, f_ex, f_in)
    return torch.where(base, f, 0.0)


def _field_from_scalars(state: SystemState, pt: PairTensors, f):
    q_j = state.charge[None, :, None]
    return torch.sum(f[..., None] * q_j * pt.dimg, dim=1)


def real_term(state: SystemState, pt: PairTensors, params: RunParams):
    """Real-space static field for the Ewald treatments
    (src/System.Energy.cpp:2900-2940)."""
    return _field_from_scalars(state, pt,
                               _real_field_scalars(state, pt, params))


def field_scalars(state: SystemState, pt: PairTensors, flags: FFlags,
                  params: RunParams):
    """Per-pair static-field scalar of the active treatment
    (polar.py:228-237): the field at row i is sum_j f_ij q_j d_ij, and
    (f symmetric, d antisymmetric) the field at j sourced by row atoms is
    -sum_i f_ij q_i d_ij."""
    if flags.polar_ewald:
        return _real_field_scalars(state, pt, params)
    if flags.polar_wolf or flags.polar_wolf_full:
        return _wolf_field_scalars(state, pt, flags, params)
    return _nopbc_field_scalars(state, pt)


def _pair_field(state: SystemState, pt: PairTensors, flags: FFlags,
                params: RunParams):
    """The pairwise part of the static field at the rows of ``pt``."""
    return _field_from_scalars(state, pt,
                               field_scalars(state, pt, flags, params))


def thole_field(state: SystemState, pt: PairTensors, flags: FFlags,
                params: RunParams):
    """Static field of the dense pairs ``pt`` (src/System.Energy.cpp:
    3271-3297; polar.py:240-249): Ewald (k-space + real space), Wolf or
    no-PBC."""
    E = _pair_field(state, pt, flags, params)
    if flags.polar_ewald:
        E = recip_term(state, flags, params) + E
    return torch.where(state.atom_alive()[:, None], E, 0.0)


def row_tiles(A: int, block: int, device):
    """The [block] row windows of tile_starts(A, block) on ``device``,
    -1-padded when one tile covers every row (A <= block)."""
    for s in tile_starts(A, block):
        rows = s + torch.arange(block, device=device)
        yield torch.where(rows < A, rows, -1) if A <= block else rows


def thole_field_blocked(state: SystemState, flags: FFlags,
                        params: RunParams, block: int = 128):
    """Static field without [A,A] tensors, in [block, A] row tiles
    (polar.py:582-609); k-space only under polar_ewald."""
    A = state.n_atom_slots
    tiles = [_pair_field(state, build_pairs_rect(state, flags, rows), flags,
                         params)
             for rows in row_tiles(A, block, state.pos.device)]
    E = assemble_tiles(torch.stack(tiles), A, block)
    if flags.polar_ewald:
        E = E + recip_term(state, flags, params)
    return torch.where(state.atom_alive()[:, None], E, 0.0)


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def _grouped_while(cond, body, carry, max_steps: int):
    """``lax.while_loop(cond, body, carry)`` for a loop of at most
    ``max_steps`` iterations, with the host reading ``cond`` once per
    LOOP_GROUP iterations.  ``body(carry, step)`` gets the 1-based
    iteration number; every iteration whose ``cond`` is false keeps the
    carry as it is, so the result is bitwise the while_loop's.  The
    iterations that run are a prefix, so ``step`` is the loop's own
    count wherever the iteration counts."""
    step = 0
    while True:
        for _ in range(min(LOOP_GROUP, max_steps - step)):
            step += 1
            go = cond(carry)
            carry = tuple(torch.where(go, n, c)
                          for n, c in zip(body(carry, step), carry))
        if step >= max_steps or not bool(cond(carry)):
            return carry


def _apply_relax(flags: FFlags, params: RunParams, new_mu, old_mu, it: int):
    if flags.polar_sor:
        return params.polar_gamma * new_mu + \
            (1.0 - params.polar_gamma) * old_mu
    if flags.polar_esor:
        w = 1.0 - math.exp(-params.polar_gamma * it)
        return w * new_mu + (1.0 - w) * old_mu
    return new_mu


def gs_rank_order(state: SystemState, pt: PairTensors):
    """The ranked-GS iteration order (polar.py:273-287): descending
    rank_metric, the count of polarizable neighbours within 1.5x the
    smallest polarizable separation (src/System.cpp:1001-1029), sorted
    stably as update_ranking's bubble sort (src/System.Energy.cpp:
    3631-3653)."""
    A = state.n_atom_slots
    pol = (state.polarizability != 0.0) & state.atom_alive()
    ok = pol[:, None] & pol[None, :] & \
        ~torch.eye(A, dtype=torch.bool, device=pol.device) & pt.alive
    r = torch.where(ok, pt.rimg, const.MAXVALUE)
    rmin = torch.min(r)
    metric = torch.sum(ok & (pt.rimg <= 1.5 * rmin), dim=1).to(
        torch.float64)
    return torch.argsort(-metric, stable=True)


def _gs_sweep(M, E_static, alpha, ok, mu, order):
    """One sequential Gauss-Seidel sweep over the atoms in ``order`` (a
    host list): each atom's new dipole is visible to the atoms after it
    in the same sweep (contract_dipoles with polar_gs/gs_ranked,
    src/System.Energy.cpp:3564-3598; polar.py:290-313).  ``M`` is the
    off-diagonal [3A,3A] contract_matrix, read three rows per atom; ``ok``
    marks the live polarizable atoms.  Four launches per atom."""
    mu = mu.clone()
    flat = mu.view(-1)
    for i in order:
        ef = torch.addmv(E_static[i], M[3 * i:3 * i + 3], flat, alpha=-1.0)
        mu[i] = torch.where(ok[i], alpha[i] * ef, 0.0)
    return mu


def thole_iterative(state: SystemState, E_static, flags: FFlags,
                    params: RunParams, contract_fn, gs_matrix=None,
                    rank_order=None):
    """Fixed-point dipole solver (src/System.Energy.cpp:3450-3543;
    polar.py:316-453): the reference's Jacobi update contracting the
    previous sweep's dipoles with SOR/ESOR relaxation, a fixed
    polar_max_iter or precision termination (every component's squared
    change at most polar_precision^2 in e^2 A^2), and the divergence
    fallback after MAX_ITERATION_COUNT sweeps (mu = alpha * E_static,
    iterator_failed).  ZODID returns the start mu0 = alpha * E_static;
    polar_warm_start starts from the dipoles carried on the state.

    With polar_gs or polar_gs_ranked and ``gs_matrix`` (the dense path's
    contract_matrix) the sweep is the reference's sequential Gauss-Seidel
    (_gs_sweep): sweep 1 in natural order, later sweeps in ``rank_order``
    when given.  Without it (the blocked, mixed and cache paths) GS
    keeps the Jacobi order, as in the twin."""
    alpha = state.polarizability[:, None]
    alive = state.atom_alive()[:, None]
    mu0 = alpha * E_static
    if not (flags.polar_sor or flags.polar_esor):
        mu0 = mu0 * params.polar_gamma
    if flags.polar_warm_start and not flags.polar_zodid:
        carried = torch.any(state.mu != 0.0)
        mu0 = torch.where(carried, state.mu, mu0)
    mu0 = torch.where(alive, mu0, 0.0)
    dev = mu0.device
    no = torch.zeros((), dtype=torch.bool, device=dev)
    if flags.polar_zodid:
        return (mu0, torch.zeros((), dtype=torch.float64, device=dev), no,
                _dipole_rrms_mean(state, mu0, mu0 * 0))

    if (flags.polar_gs or flags.polar_gs_ranked) and gs_matrix is not None:
        ok = state.atom_alive() & (state.polarizability != 0.0)
        natural = list(range(mu0.shape[0]))
        ranked = natural if rank_order is None else rank_order.tolist()

        def iterate(mu, step):
            return _gs_sweep(gs_matrix, E_static, state.polarizability, ok,
                             mu, natural if step <= 1 else ranked)
    else:
        def iterate(mu, step):
            return torch.where(alive, alpha * (E_static + contract_fn(mu)),
                               0.0)

    if params.polar_precision == 0.0:
        mu, old_mu = mu0, torch.zeros_like(mu0)
        for it in range(1, flags.polar_max_iter + 1):
            mu, old_mu = _apply_relax(flags, params, iterate(mu, it), mu,
                                      it), mu
        iters = torch.full((), float(flags.polar_max_iter),
                           dtype=torch.float64, device=dev)
        return mu, iters, no, _dipole_rrms_mean(state, mu, old_mu)

    max_iter = int(const.MAX_ITERATION_COUNT)
    allowed_sqerr = (params.polar_precision ** 2 *
                     const.DEBYE2SKA * const.DEBYE2SKA)

    def cond(c):
        return ~c[3] & (c[2] < max_iter)

    def body(c, step):
        mu, _, it, _ = c
        new_mu = iterate(mu, step)
        done = torch.all((new_mu - mu) ** 2 <= allowed_sqerr)
        return (_apply_relax(flags, params, new_mu, mu, step), mu, it + 1,
                done)

    mu, old_mu, it, done = _grouped_while(
        cond, body, (mu0, torch.zeros_like(mu0),
                     torch.zeros((), dtype=torch.int64, device=dev), no),
        max_iter)
    failed = ~done
    mu = torch.where(failed, torch.where(alive, alpha * E_static, 0.0), mu)
    return (mu, it.to(torch.float64), failed,
            _dipole_rrms_mean(state, mu, old_mu))


def _dipole_rrms_mean(state: SystemState, new_mu, old_mu):
    """(src/System.Energy.cpp:3147-3177 + 2639-2657)"""
    num = torch.sum((new_mu - old_mu) ** 2, dim=-1)
    den = torch.sum(new_mu * new_mu, dim=-1)
    rrms = torch.sqrt(num / torch.where(den == 0.0, 1.0, den))
    rrms = torch.where(torch.isfinite(rrms) & (den != 0.0), rrms, 0.0)
    return torch.sum(rrms) / state.n_atom_slots


def thole_exact(state: SystemState, Amat, E_static):
    """Exact dipoles by an LU solve of the float64 [3A,3A] A matrix
    (src/System.Energy.cpp:3660-3710; polar.py:465-471, whose CPU branch
    is LAPACK's)."""
    A = state.n_atom_slots
    M = Amat.permute(0, 2, 1, 3).reshape(3 * A, 3 * A)
    mu = torch.linalg.solve(M, E_static.reshape(-1)).reshape(A, 3)
    return torch.where(state.atom_alive()[:, None], mu, 0.0)


def cg_solve(matvec, b):
    """``jax.scipy.sparse.linalg.cg(matvec, b, tol=CG_TOL,
    maxiter=CG_MAXITER)`` step for step (jax/_src/scipy/sparse/linalg.py
    ``_cg_solve``): from x0 = 0 with the initial ``matvec(x0)`` call,
    gamma = r.r, until gamma <= tol^2 b.b or CG_MAXITER steps.  Returns
    (x, the step count as a 0-d int64 tensor)."""
    def vdot(x, y):
        return torch.sum(x * y)

    maxiter = CG_MAXITER
    atol2 = (CG_TOL * CG_TOL) * vdot(b, b)
    x0 = torch.zeros_like(b)
    r0 = b - matvec(x0)
    k0 = torch.zeros((), dtype=torch.int64, device=b.device)

    def cond(c):
        return (c[2] > atol2) & (c[4] < maxiter)

    def body(c, step):
        x, r, gamma, p, k = c
        Ap = matvec(p)
        alpha = gamma / vdot(p, Ap)
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        gamma_ = vdot(r_, r_)
        beta = gamma_ / gamma
        return x_, r_, gamma_, r_ + beta * p, k + 1

    x, _, _, _, k = _grouped_while(cond, body,
                                   (x0, r0, vdot(r0, r0), r0, k0), maxiter)
    return x, k


# --- full-Ewald SCF (Nymand & Linse) ---------------------------------------

def induced_real_term(state: SystemState, pt: PairTensors, flags: FFlags,
                      params: RunParams, mu):
    """(src/System.Energy.cpp:3046-3104; polar.py:476-501)"""
    a = params.polar_ewald_alpha
    l = params.polar_damp
    A = state.n_atom_slots
    pol = state.polarizability
    mask = (pt.alive & ~torch.eye(A, dtype=torch.bool, device=pol.device) &
            (pol[:, None] != 0.0) & (pol[None, :] != 0.0) &
            ~(pt.rimg > state.pbc.cutoff))
    r = torch.where(pt.rimg == 0.0, 1.0, pt.rimg)
    ir3 = 1.0 / r ** 3
    ir5 = 1.0 / r ** 5
    erfcar = torch.special.erfc(a * r)
    expa2r2 = torch.exp(-a * a * r * r)
    s2 = (erfcar + 2.0 * a * r * const.OneOverSqrtPi * expa2r2 +
          4.0 * (a ** 3) * (r ** 3) / 3.0 * const.OneOverSqrtPi * expa2r2 -
          damp_factor(l * r, 3))
    s1 = (erfcar + 2.0 * a * r * const.OneOverSqrtPi * expa2r2 -
          damp_factor(l * r, 2))
    d = pt.dimg
    outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    T = 3.0 * outer * (s2 * ir5)[..., None, None] - \
        eye * (s1 * ir3)[..., None, None]
    T = torch.where(mask[..., None, None], T, 0.0)
    return torch.einsum("ijpq,jq->ip", T, mu)


def induced_recip_term(state: SystemState, flags: FFlags, params: RunParams,
                       mu):
    """(src/System.Energy.cpp:2975-3042; polar.py:504-517) with the
    per-component k weight (the reference collapses it to a scalar, a
    loop bug the twin's golden records as its known_delta)."""
    a = params.polar_ewald_alpha
    k, k2 = kvectors(state, flags.ewald_kmax)
    mu_m = torch.where(state.atom_alive()[:, None], mu, 0.0)
    phase = phase_dot(state.pos, k)              # [A,K]
    kmu = phase_dot(mu_m, k)                     # [A,K]
    Pcos = torch.sum(kmu * torch.cos(phase), dim=0)  # [K]
    Psin = torch.sum(kmu * torch.sin(phase), dim=0)
    w = 8.0 * const.pi / state.pbc.volume * \
        torch.exp(-k2 / (4 * a * a)) / k2
    coeff = -(torch.sin(phase) * Psin[None] +
              torch.cos(phase) * Pcos[None])     # [A,K]
    return (coeff * w[None]) @ k                 # [A,3]


def induced_corr_term(state: SystemState, params: RunParams, mu):
    """(src/System.Energy.cpp:3120-3143; polar.py:520-527)"""
    a = params.polar_ewald_alpha
    mu_m = torch.where(state.atom_alive()[:, None], mu, 0.0)
    total = torch.sum(mu_m, dim=0)
    return (-4.0 * const.pi / (3.0 * state.pbc.volume) * total[None, :] +
            4.0 * a ** 3 / (3.0 * const.SqrtPi) * mu_m)


def _palmo_change(state: SystemState, E_static, mu, ef_ind):
    """Palmo's correction field: one more contraction's induced field
    less the field the final dipoles imply (src/System.Energy.cpp:
    3602-3627), at the live polarizable atoms."""
    alpha = state.polarizability[:, None]
    implied = mu / torch.where(alpha == 0.0, 1.0, alpha) - E_static
    return torch.where(state.atom_alive()[:, None] & (alpha != 0.0),
                       ef_ind - implied, 0.0)


def ewald_full(state: SystemState, pt: PairTensors, flags: FFlags,
               params: RunParams):
    """Full-Ewald SCF (src/System.Energy.cpp:2785-2830; polar.py:530-579).
    Returns (E_static, mu, iterations, failed, rrms, Palmo change)."""
    alive = state.atom_alive()[:, None]
    E_static = recip_term(state, flags, params) + real_term(state, pt,
                                                            params)
    E_static = torch.where(alive, E_static, 0.0)
    alpha = state.polarizability[:, None]
    mu0 = torch.where(alive, alpha * E_static, 0.0)
    dev = mu0.device
    max_iter = (flags.polar_max_iter if params.polar_precision == 0.0
                else int(const.MAX_ITERATION_COUNT))
    allowed_sqerr = (params.polar_precision ** 2 *
                     const.DEBYE2SKA * const.DEBYE2SKA)

    def induced(mu):
        return (induced_real_term(state, pt, flags, params, mu) +
                induced_recip_term(state, flags, params, mu) +
                induced_corr_term(state, params, mu))

    def cond(c):
        return ~c[3] & (c[2] < max_iter)

    def body(c, step):
        mu, _, it, _ = c
        new_mu = torch.where(alive, alpha * (E_static + induced(mu)), 0.0)
        if params.polar_precision == 0.0:
            done = it + 1 >= max_iter
        else:
            done = torch.all((new_mu - mu) ** 2 <= allowed_sqerr)
        return (_apply_relax(flags, params, new_mu, mu, step), mu, it + 1,
                done)

    no = torch.zeros((), dtype=torch.bool, device=dev)
    mu, old_mu, it, done = _grouped_while(
        cond, body, (mu0, torch.zeros_like(mu0),
                     torch.zeros((), dtype=torch.int64, device=dev), no),
        max_iter)
    failed = ~done if params.polar_precision > 0.0 else no
    change = (_palmo_change(state, E_static, mu, induced(mu))
              if flags.polar_palmo else torch.zeros_like(mu))
    return (E_static, mu, it.to(torch.float64), failed,
            _dipole_rrms_mean(state, mu, old_mu), change)


# ---------------------------------------------------------------------------
# matrix-free and mixed-precision contractions
# ---------------------------------------------------------------------------

def _wolf_full_coeffs(c_outer, c_diag, wdamp1, wdamp2, ir, rcut):
    """The polar_wolf_full correction of (c_outer, c_diag)
    (polar.py:670-672, 699-701)."""
    return (c_outer + 3.0 * wdamp2 * ir * ir / rcut ** 3,
            c_diag - wdamp1 / rcut ** 3)


def contract_blocked(state: SystemState, flags: FFlags, params: RunParams,
                     mu, block: int = 128):
    """Matrix-free float64 ef_induced = -sum_j T_ij mu_j in [block, A] row
    tiles, from T_ij mu_j = -3 d (d.mu) damp2/r^5 + damp1 mu/r^3 [+ the
    wolf-full terms] (polar.py:639-680)."""
    A = state.n_atom_slots
    rcut = state.pbc.cutoff
    tiles = []
    for rows in row_tiles(A, block, state.pos.device):
        pt = build_pairs_rect(state, flags, rows)
        r = pt.rimg
        ir = 1.0 / torch.where(r == 0.0, 1.0, r)
        ir3 = torch.where(r == 0.0, const.MAXVALUE, ir ** 3)
        ir5 = torch.where(r == 0.0, const.MAXVALUE, ir ** 5)
        damp1, damp2, wdamp1, wdamp2 = _thole_damps(state, pt, flags,
                                                    params)
        mask = _not_self(state, pt) & pt.alive
        dot = torch.sum(pt.dimg * mu[None], dim=-1)              # [B,A]
        c_outer = -3.0 * damp2 * ir5
        c_diag = damp1 * ir3
        if flags.polar_wolf_full:
            c_outer, c_diag = _wolf_full_coeffs(c_outer, c_diag, wdamp1,
                                                wdamp2, ir, rcut)
        c_outer = torch.where(mask, c_outer, 0.0)
        c_diag = torch.where(mask, c_diag, 0.0)
        tiles.append(-(torch.sum((c_outer * dot)[..., None] * pt.dimg,
                                 dim=1) + c_diag @ mu))
    return assemble_tiles(torch.stack(tiles), A, block)


def mixed_coeff_scalars(state: SystemState, pt: PairTensors, flags: FFlags,
                        params: RunParams):
    """(c_outer, c_diag) float32 dipole-contraction coefficients for the
    pairs in ``pt``: T_ij mu_j = c_outer d (d.mu) + c_diag mu
    (polar.py:683-704)."""
    r = pt.rimg
    ir = 1.0 / torch.where(r == 0.0, 1.0, r)
    damp1, damp2, wdamp1, wdamp2 = _thole_damps(state, pt, flags, params)
    mask = _not_self(state, pt) & pt.alive
    c_outer = -3.0 * damp2 * ir ** 5
    c_diag = damp1 * ir ** 3
    if flags.polar_wolf_full:
        c_outer, c_diag = _wolf_full_coeffs(c_outer, c_diag, wdamp1, wdamp2,
                                            ir, state.pbc.cutoff)
    return (torch.where(mask, c_outer, 0.0).to(torch.float32),
            torch.where(mask, c_diag, 0.0).to(torch.float32))


def plane_mode(flags: FFlags) -> int:
    """How many f32 planes the mixed-precision SCF streams per
    contraction: 3 (masked displacements; coefficients recomputed
    in-kernel) under exponential damping, 4 ``(cd, s = sqrt(-co) d)`` when
    forced by polar_plane_mode=4 or for linear/off damping, 5
    ``(co, cd, d)`` under polar_wolf_full (polar.py:707-732)."""
    if flags.polar_wolf_full:
        return 5
    if flags.polar_plane_mode == 4:
        return 4
    if flags.damp_type == const.DAMPING_EXPONENTIAL:
        return 3
    return 4


def coeffs_from_d(dx, dy, dz, l):
    """(c_outer, c_diag) recomputed in f32 from masked displacement planes
    under exponential Thole damping (polar.py:735-761): both are functions
    of r alone; masked pairs are d == 0 and yield co = cd = 0.  ``l`` is a
    Python float: a tensor-scalar op on float32 planes computes in float32
    with the scalar rounded to float32, as ``jnp.float32(l)`` does in the
    twin."""
    r2 = dx * dx + dy * dy + dz * dz
    live = r2 > 0.0
    r2s = torch.where(live, r2, 1.0)
    ir = torch.rsqrt(r2s)
    r = r2s * ir                      # sqrt(r2)
    ir2 = ir * ir
    ir3 = ir * ir2
    ir5 = ir3 * ir2
    x = l * r
    ex = torch.exp(-x)
    x2 = x * x
    damp1 = 1.0 - ex * (0.5 * x2 + x + 1.0)
    damp2 = damp1 - ex * (x * x2 * (1.0 / 6.0))
    co = torch.where(live, -3.0 * damp2 * ir5, 0.0)
    cd = torch.where(live, damp1 * ir3, 0.0)
    return co, cd


def expand_planes(planes, l):
    """(co, cd, dx, dy, dz) of a 3-, 4- or 5-tuple in the fold_outer_rows
    representation (polar_cache.py:438-449): mode 3 recomputes the
    coefficients (coeffs_from_d), mode 4 has co None (folded into s)."""
    if len(planes) == 3:
        return coeffs_from_d(*planes, l) + tuple(planes)
    co = planes[0] if len(planes) == 5 else None
    return (co,) + tuple(planes[-4:])


def plane_sums(terms, m, dim: int):
    """Sum over axis ``dim`` of T_ij m in f32, from the expand_planes
    ``terms``: m [n,3] is the mu of the columns (dim 1, row sums: the
    field at the rows) or of the rows (dim 0, column sums: the field the
    rows source at the columns; T is symmetric).  The contraction of
    contract_mixed's plain versions and of the polar cache's row
    corrections (polar.py:884-897, polar_cache.py:460-483)."""
    co, cd, dx, dy, dz = terms
    shape = (1, -1) if dim == 1 else (-1, 1)
    mx, my, mz = (m[:, k].reshape(shape) for k in range(3))
    dot = dx * mx + dy * my + dz * mz
    s = -dot if co is None else co * dot
    return torch.stack([torch.sum(s * dx + cd * mx, dim=dim),
                        torch.sum(s * dy + cd * my, dim=dim),
                        torch.sum(s * dz + cd * mz, dim=dim)], dim=1)


def fold_outer_rows(co, cd, d32x, d32y, d32z, flags: FFlags):
    """The SCF's plane representation (see plane_mode) as a 3-, 4- or
    5-tuple of f32 planes (polar.py:764-794).  Mode 3 masks the
    displacements to zero where the coefficients are masked (``co != 0``
    is an exact proxy); mode 4 folds ``s = sqrt(-co) d``."""
    mode = plane_mode(flags)
    if mode == 5:
        return co, cd, d32x, d32y, d32z
    if mode == 3:
        live = co != 0.0
        return (torch.where(live, d32x, 0.0), torch.where(live, d32y, 0.0),
                torch.where(live, d32z, 0.0))
    w = torch.sqrt(torch.clamp(-co, min=0.0))
    return cd, w * d32x, w * d32y, w * d32z


def mixed_field_coeffs(state: SystemState, flags: FFlags, params: RunParams,
                       block: int = 128):
    """Float32 pair-coefficient planes (fold_outer_rows form) and the f64
    static field, built in [block, A] row tiles (polar.py:797-844)."""
    A = state.n_atom_slots
    planes, fields = [], []
    for rows in row_tiles(A, block, state.pos.device):
        pt = build_pairs_rect(state, flags, rows)
        c_outer, c_diag = mixed_coeff_scalars(state, pt, flags, params)
        d32 = pt.dimg.to(torch.float32)
        planes.append(fold_outer_rows(c_outer, c_diag, d32[..., 0],
                                      d32[..., 1], d32[..., 2], flags))
        fields.append(_pair_field(state, pt, flags, params))
    planes = tuple(assemble_tiles(torch.stack(p), A, block)
                   for p in zip(*planes))
    E = assemble_tiles(torch.stack(fields), A, block)
    if flags.polar_ewald:
        E = E + recip_term(state, flags, params)
    return planes, torch.where(state.atom_alive()[:, None], E, 0.0)


def supported(A: int) -> bool:
    """pallas_polar.supported (pallas_polar.py:116-117): the square sizes
    the JAX package's contraction kernels take."""
    return A >= 256 and A % 128 == 0


def use_tri(shape) -> bool:
    """Whether the JAX package's contract_mixed, off the CPU, runs
    contract_pallas_tri on planes of ``shape`` (polar.py:865-883), with the
    environment read now: square supported planes, MPMCXX_SYM_KERNEL not
    "0" and MPMCXX_TRI_KERNEL "1".  (Its _pick_b_sym test holds for every
    supported A.)"""
    rows, cols = shape
    return (rows == cols and supported(rows)
            and os.environ.get("MPMCXX_SYM_KERNEL", "1") != "0"
            and os.environ.get("MPMCXX_TRI_KERNEL", "0") == "1")


def use_sym(shape) -> bool:
    """Whether the JAX package's contract_mixed, off the CPU, runs
    contract_pallas_sym on planes of ``shape`` (polar.py:865-883), with the
    environment read now: square supported planes, MPMCXX_SYM_KERNEL not
    "0" and MPMCXX_TRI_KERNEL not "1" (the default)."""
    rows, cols = shape
    return (rows == cols and supported(rows)
            and os.environ.get("MPMCXX_SYM_KERNEL", "1") != "0"
            and os.environ.get("MPMCXX_TRI_KERNEL", "0") != "1")


def contract_mixed(coeffs, mu, l=None):
    """ef_induced = -T mu from the 3-, 4- or 5-plane f32 tuple of
    fold_outer_rows; the 3-plane mode needs the damping width ``l``
    (params.polar_damp).  Where the JAX package would run
    contract_pallas_tri (use_tri) this runs kernel K4
    (ops/cuda_polar.contract_planes_tri), where it would run
    contract_pallas_sym (use_sym) kernel K5 (contract_planes_sym),
    otherwise (contract_pallas, the XLA branch: other square sizes and
    [R, A] row slices, returning [R, 3]) kernel K1 (contract_planes);
    each takes a plain PyTorch version on CPU tensors.  Row-sharded
    planes (meshing.RowShards) contract shard by shard
    (``contract_rows``)."""
    if len(coeffs) == 3 and l is None:
        raise ValueError("3-plane mixed coefficients need l=polar_damp")
    l = 0.0 if l is None else l
    if isinstance(coeffs[0], meshing.RowShards):
        return contract_rows(coeffs, mu, l)
    if use_tri(coeffs[0].shape):
        return cuda_polar.contract_planes_tri(coeffs, mu, l)
    if use_sym(coeffs[0].shape):
        return cuda_polar.contract_planes_sym(coeffs, mu, l)
    return cuda_polar.contract_planes(coeffs, mu, l)


def contract_rows(coeffs, mu, l: float):
    """``-T mu`` [A,3] over row-sharded planes (a tuple of
    meshing.RowShards): one contract_mixed per shard on its [R_d, A]
    slices, under that shard's device and with mu on it, the [R_d, 3]
    results stacked in shard order on the leader.  Row slices are not
    square, so they take K1 (the JAX package's rule, polar.py:867-870:
    row slices never reach the triangle kernels)."""
    mesh = coeffs[0].mesh
    outs = []
    for d, dev in enumerate(mesh.devices):
        with meshing.device_guard(dev):
            outs.append(contract_mixed(tuple(p.parts[d] for p in coeffs),
                                       mu.to(dev), l))
    return meshing.gather_rows(outs, mesh)


def polar_blocked(state: SystemState, flags: FFlags, params: RunParams,
                  block: int = 128) -> PolarResult:
    """Large-system polarization with a matrix-free solve
    (polar.py:900-915): over f32 coefficient planes under polar_mixed,
    else in f64 row tiles that rebuild the pair geometry every
    contraction.  polar_ewald_full never comes here: flags.dense_only
    routes it to the dense ``polar``."""
    if flags.polar_mixed:
        coeffs, E_static = mixed_field_coeffs(state, flags, params, block)
        return finish_polar(state, flags, params, E_static,
                            lambda m: contract_mixed(coeffs, m,
                                                     l=params.polar_damp))
    E_static = thole_field_blocked(state, flags, params, block)
    return finish_polar(state, flags, params, E_static,
                        lambda m: contract_blocked(state, flags, params, m,
                                                   block))


def finish_polar(state: SystemState, flags: FFlags, params: RunParams,
                 E_static, contract_fn) -> PolarResult:
    """Solve for the dipoles given a static field and a matrix-free
    contraction, and assemble the polarization energy with Palmo's
    correction (polar.py:918-955): thole_iterative, or under
    polar_iterative off the exact solve as CG (cg_solve) on
    A mu = E_static, A = diag(1/alpha) - the contraction."""
    if flags.polar_iterative:
        mu, iters, failed, rrms = thole_iterative(state, E_static, flags,
                                                  params, contract_fn)
    else:
        alpha = state.polarizability[:, None]
        inv_alpha = torch.where(alpha != 0.0,
                                1.0 / torch.where(alpha == 0.0, 1.0, alpha),
                                const.MAXVALUE)
        alive = state.atom_alive()[:, None]
        b = torch.where(alive, E_static, 0.0)
        mu, _ = cg_solve(lambda m: m * inv_alpha - contract_fn(m), b)
        mu = torch.where(alive, mu, 0.0)
        iters = torch.zeros((), dtype=torch.float64, device=mu.device)
        failed = torch.zeros((), dtype=torch.bool, device=mu.device)
        rrms = iters
    pot = torch.sum(mu * E_static)
    if flags.polar_palmo:
        pot = pot + torch.sum(mu * _palmo_change(state, E_static, mu,
                                                 contract_fn(mu)))
    return PolarResult(-0.5 * pot, mu, iters, failed, rrms)


def polar(state: SystemState, pt: PairTensors, flags: FFlags,
          params: RunParams) -> PolarResult:
    """Induction energy of the dense pairs ``pt`` (src/System.Energy.cpp:
    2534-2635; polar.py:958-997): the full-Ewald SCF, the iterative
    solve on the float64 A matrix (Jacobi or sequential Gauss-Seidel, with
    Palmo's correction), or the exact solve."""
    if flags.polar_ewald_full:
        E_static, mu, iters, failed, rrms, change = ewald_full(
            state, pt, flags, params)
        pot = torch.sum(mu * E_static)
        if flags.polar_palmo:
            pot = pot + torch.sum(mu * change)
        return PolarResult(-0.5 * pot, mu, iters, failed, rrms)

    Amat = thole_amatrix(state, pt, flags, params)
    E_static = thole_field(state, pt, flags, params)
    if not flags.polar_iterative:
        mu = thole_exact(state, Amat, E_static)
        z = torch.zeros((), dtype=torch.float64, device=mu.device)
        return PolarResult(-0.5 * torch.sum(mu * E_static), mu, z,
                           torch.zeros_like(z, dtype=torch.bool), z)
    M = contract_matrix(Amat)

    def contract_fn(m):
        return -(M @ m.reshape(-1)).reshape(m.shape)

    ro = gs_rank_order(state, pt) if flags.polar_gs_ranked else None
    mu, iters, failed, rrms = thole_iterative(
        state, E_static, flags, params, contract_fn, gs_matrix=M,
        rank_order=ro)
    pot = torch.sum(mu * E_static)
    if flags.polar_palmo:
        pot = pot + torch.sum(mu * _palmo_change(state, E_static, mu,
                                                 contract_fn(mu)))
    return PolarResult(-0.5 * pot, mu, iters, failed, rrms)


def polarizability_tensor_report(state: SystemState, flags: FFlags,
                                 params: RunParams):
    """Molecular polarizability tensor from the inverted Thole matrix
    (thole_polarizability_tensor, src/System.Energy.cpp:3714-3760;
    polar.py:1000-1028): B = A^-1 over the live atoms in host float64,
    C[p][q] = sum over atom blocks of B[3i+p][3j+q], isotropic = tr(C)/3.
    Returns ``(A_dense, B, C, isotropic)`` as numpy arrays."""
    pt = build_pairs(state, flags)
    Amat = thole_amatrix(state, pt, flags, params).cpu().numpy()
    idx = np.nonzero(state.atom_alive().cpu().numpy())[0]
    n = len(idx)
    A_dense = np.transpose(Amat[np.ix_(idx, idx)],
                           (0, 2, 1, 3)).reshape(3 * n, 3 * n)
    B = np.linalg.inv(A_dense)
    C = B.reshape(n, 3, n, 3).sum(axis=(0, 2))
    return A_dense, B, C, np.trace(C) / 3.0


def print_polarizability_tensor(state: SystemState, flags: FFlags,
                                params: RunParams, out) -> None:
    """Print the A matrix, B matrix and molecular polarizability tensor in
    the reference's format (print_matrix src/System.Energy.cpp:2497-2507;
    tensor block :3745-3760; polar.py:1031-1055)."""
    A_dense, B, C, isotropic = polarizability_tensor_report(
        state, flags, params)

    def print_matrix(m):
        out.write("\n")
        for row in m:
            out.write("".join(f"{v:.3f} " for v in row) + "\n")
        out.write("\n")

    out.write("POLAR: A matrix:\n")
    print_matrix(A_dense)
    out.write("POLAR: B matrix:\n")
    print_matrix(B)
    out.write("POLARIZATION: polarizability tensor (A^3):\n")
    out.write("##########################\n")
    for p in range(3):
        out.write("".join(f"{C[p][q]:.4f} " for q in range(3)) + "\n")
    out.write("##########################\n")
    out.write(f"isotropic = {isotropic:.4f}\n")
    out.write(f"XX/ZZ = {C[0][0] / C[2][2]:.4f}\n")
