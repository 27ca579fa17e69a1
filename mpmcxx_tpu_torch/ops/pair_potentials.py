"""Repulsion/dispersion pair potentials.

JAX twin: mpmcxx_tpu/ops/pair_potentials.py.  Ported: Lennard-Jones with
its long-range corrections, crystal lattice sums and Feynman-Hibbs
corrections (src/System.Energy.cpp:897-1208), the buffered 14-7 MMFF
(:1212-1291), Silvera-Goldman H2 (:1773-1928), DREIDING (:2098-2265), the
dispersion expansion with Tang-Toennies damping (:1939-2078) and the
exponential repulsion (:2275-2485), each with its cavity_autoreject
branch, SPECTRE's repulsion-only LJ, and the 1-D anharmonic oscillator
with its Feynman-Hibbs terms (:757-885).

Every function takes the pair tensors of any layout (dense [A,A], an
[S,A] move window, a [B,A] row tile): per-row arrays go through
``pt.row``.  ``pair_only`` leaves out the whole-system self sums, which
a row-tiled caller adds once.  Energies in Kelvin.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as const
from ..flags import FFlags, RunParams
from ..state import SystemState
from .pairwise import PairTensors


def _safe_div(a, b):
    return a / torch.where(b == 0.0, 1.0, b)


def _reduced_mass_kg(state: SystemState, pt=None):
    """Pair reduced mass in kg from molecule masses ([R,A] layout)."""
    mm = state.mol_mass[state.mol_id]
    mi = (pt.row(mm) if pt is not None else mm)[:, None]
    mj = mm[None, :]
    return const.AMU2KG * _safe_div(mi * mj, mi + mj)


def _image_grid(n: int, include_origin: bool) -> np.ndarray:
    """Integer cell-image coefficients in [-n, n]^3."""
    rng = np.arange(-n, n + 1)
    g = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), -1).reshape(-1, 3)
    if not include_origin:
        g = g[np.any(g != 0, axis=1)]
    return g.astype(np.float64)


def _crystal_shifts(state: SystemState, n: int, include_origin: bool):
    """([C,3] lattice shifts, [C] bool origin) of the images in [-n, n]^3."""
    g = torch.as_tensor(_image_grid(n, include_origin),
                        device=state.pos.device)
    return g @ state.pbc.basis, torch.all(g == 0, dim=-1)


def _row_disp(state: SystemState, pt: PairTensors):
    """[R,A,3] real (unwrapped) displacement r_i - r_j of pt's pairs."""
    return pt.row(state.pos)[:, None, :] - state.pos[None, :, :]


def _rd_cutoff(state: SystemState, flags: FFlags):
    if flags.rd_crystal:
        return 2.0 * state.pbc.cutoff * (flags.rd_crystal_order - 0.5)
    return state.pbc.cutoff


def lj_fh_corr(flags: FFlags, params: RunParams, state: SystemState,
               rimg, term12, term6, epsilon, sigrep, pt=None):
    """Feynman-Hibbs 2nd/4th order LJ correction
    (src/System.Energy.cpp:1100-1148)."""
    ir = _safe_div(1.0, rimg)
    ir2, ir3, ir4 = ir * ir, ir ** 3, ir ** 4
    rm = _reduced_mass_kg(state, pt)
    T = params.temperature
    if flags.cdvdw_sig_repulsion:
        dE = -6.0 * sigrep * (2.0 * term12 - term6) * ir
        d2E = 6.0 * sigrep * (26.0 * term12 - 7.0 * term6) * ir2
    else:
        dE = -24.0 * epsilon * (2.0 * term12 - term6) * ir
        d2E = 24.0 * epsilon * (26.0 * term12 - 7.0 * term6) * ir2
    corr = (const.M2A2 * (const.hBar2 / (24.0 * const.kB * T * rm)) *
            (d2E + 2.0 * dE * ir))
    if flags.feynman_hibbs_order >= 4:
        if flags.cdvdw_sig_repulsion:
            d3E = -336.0 * sigrep * (6.0 * term12 - term6) * ir3
            d4E = 3024.0 * sigrep * (10.0 * term12 - term6) * ir4
        else:
            d3E = -1344.0 * epsilon * (6.0 * term12 - term6) * ir3
            d4E = 12096.0 * epsilon * (10.0 * term12 - term6) * ir4
        corr = corr + (const.M2A4 *
                       (const.hBar4 / (1152.0 * const.kB2 * T * T * rm * rm)) *
                       (15.0 * dE * ir3 + 4.0 * d3E * ir + d4E))
    return corr


def lj(state: SystemState, pt: PairTensors, flags: FFlags,
       params: RunParams, pair_only: bool = False):
    """Lennard-Jones energy (src/System.Energy.cpp:897-1032)."""
    cutoff = _rd_cutoff(state, flags)
    contrib = (pt.pair_once & pt.alive & (pt.rimg - const.SMALL_dR < cutoff) &
               (~pt.rd_excluded | bool(flags.rd_crystal)) & ~pt.frozen)
    abs_sig = torch.abs(pt.sigma)
    if flags.rd_crystal:
        shift, origin = _crystal_shifts(state, flags.rd_crystal_order - 1,
                                        include_origin=True)
        rvec = _row_disp(state, pt)[None] + shift[:, None, None, :]
        rr = torch.sqrt(torch.sum(rvec * rvec, dim=-1))       # [C,R,A]
        use = (rr <= cutoff) & ~(origin[:, None, None] &
                                 pt.rd_excluded[None]) & (rr > 0)
        sor = torch.where(use, _safe_div(abs_sig[None], rr), 0.0)
        sor6 = torch.sum(sor ** 6, dim=0)
        sor12 = torch.sum(sor ** 12, dim=0)
    else:
        sor = _safe_div(abs_sig, pt.rimg)
        sor6 = sor ** 6
        sor12 = sor6 * sor6

    if flags.spectre:
        # repulsion only, with no 4 epsilon (pair_potentials.py:111-114)
        term6, term12 = torch.zeros_like(sor6), sor12
        pot = term12
    else:
        term6 = torch.zeros_like(sor6) if flags.polarvdw else sor6
        term12 = torch.where(pt.attractive_only, 0.0, sor12)
        if flags.cdvdw_sig_repulsion:
            pot = pt.sigrep * term12
        else:
            pot = 4.0 * pt.epsilon * (term12 - term6)
    if flags.feynman_hibbs:
        pot = pot + lj_fh_corr(flags, params, state, pt.rimg, term12, term6,
                               pt.epsilon, pt.sigrep, pt)
    if flags.cavity_autoreject:
        pot = torch.where(pt.rimg < params.cavity_autoreject_scale * abs_sig,
                          const.MAXVALUE, pot)
    energy = torch.sum(torch.where(contrib, pot, 0.0))
    if flags.rd_lrc:
        energy = energy + lj_lrc(state, pt, flags, cutoff, pair_only=pair_only)
    if flags.rd_crystal and not pair_only:
        energy = energy + lj_rd_crystal_self(state, flags, cutoff)
    return energy


def lj_lrc(state: SystemState, pt: PairTensors, flags: FFlags, cutoff,
           pair_only: bool = False):
    """Pair + self long-range corrections (src/System.Energy.cpp:1036-1096)."""
    vol = state.pbc.volume
    # every alive, non-frozen pair with nonzero mixed eps & sigma;
    # rd-excluded (same molecule) pairs DO contribute (reference comment)
    sp = state.spectre
    ss_pair = pt.row(sp)[:, None] & sp[None, :]
    ok = (pt.pair_once & pt.alive & ~pt.frozen & ~ss_pair &
          (pt.epsilon != 0.0) & (pt.sigma != 0.0))
    sig_cut = torch.abs(pt.sigma) / cutoff
    sig3 = torch.abs(pt.sigma) ** 3
    sig_cut3 = sig_cut ** 3
    sig_cut9 = sig_cut3 ** 3
    if flags.cdvdw_sig_repulsion:
        pair_lrc = (4.0 / 9.0) * const.pi * pt.sigrep * sig3 * sig_cut9 / vol
    elif flags.polarvdw:
        pair_lrc = (16.0 / 9.0) * const.pi * pt.epsilon * sig3 * sig_cut9 / vol
    else:
        pair_lrc = ((16.0 / 3.0) * const.pi * pt.epsilon * sig3 *
                    ((1.0 / 3.0) * sig_cut9 - sig_cut3) / vol)
    total = torch.sum(torch.where(ok, pair_lrc, 0.0))
    if pair_only:
        return total

    aok = (state.atom_alive() & (state.sigma != 0.0) &
           (state.epsilon != 0.0) & ~state.frozen & ~state.spectre)
    s_cut = torch.abs(state.sigma) / cutoff
    s3 = torch.abs(state.sigma) ** 3
    s_cut3 = s_cut ** 3
    s_cut9 = s_cut3 ** 3
    if flags.cdvdw_sig_repulsion:
        self_lrc = ((1.0 / 3.0) * const.pi * const.hBar / const.kB *
                    const.au2invseconds * state.omega *
                    state.polarizability ** 2 * _safe_div(s_cut9, s3) / vol)
    elif flags.polarvdw:
        self_lrc = (16.0 / 9.0) * const.pi * state.epsilon * s3 * s_cut9 / vol
    else:
        self_lrc = ((16.0 / 3.0) * const.pi * state.epsilon * s3 *
                    ((1.0 / 3.0) * s_cut9 - s_cut3) / vol)
    return total + torch.sum(torch.where(aok, self_lrc, 0.0))


def lj_rd_crystal_self(state: SystemState, flags: FFlags, cutoff):
    """Self-interaction with periodic images
    (src/System.Energy.cpp:1152-1208)."""
    shift, _ = _crystal_shifts(state, flags.rd_crystal_order - 1,
                               include_origin=False)
    rr = torch.sqrt(torch.sum(shift * shift, dim=-1))     # [C]
    abs_sig = torch.abs(state.sigma)                      # [A]
    sor = torch.where((rr <= cutoff)[:, None],
                      _safe_div(abs_sig[None, :], rr[:, None]), 0.0)
    sor6 = 0.5 * torch.sum(sor ** 6, dim=0)
    sor12 = 0.5 * torch.sum(sor ** 12, dim=0)
    term6 = torch.zeros_like(sor6) if flags.polarvdw else sor6
    term12 = torch.where(state.sigma < 0.0, 0.0, sor12)
    if flags.spectre:
        pot = sor12
    elif flags.cdvdw_sig_repulsion:
        pot = (0.75 * const.hBar / const.kB * const.au2invseconds *
               state.omega * state.polarizability ** 2 *
               _safe_div(term12, state.sigma ** 6))
    elif flags.polarvdw:
        pot = 4.0 * state.epsilon * term12
    else:
        pot = 4.0 * state.epsilon * (term12 - term6)
    ok = state.atom_alive() & ~((state.sigma == 0.0) & (state.epsilon == 0.0))
    return torch.sum(torch.where(ok, pot, 0.0))


def lj_buffered_14_7(state: SystemState, pt: PairTensors, flags: FFlags,
                     params: RunParams):
    """Buffered 14-7 MMFF potential (src/System.Energy.cpp:1212-1248)."""
    ok = (pt.pair_once & pt.alive & ~(pt.rimg > state.pbc.cutoff) &
          ~pt.rd_excluded & ~pt.frozen)
    r_sig = _safe_div(pt.rimg, pt.sigma)
    first = (1.07 / (r_sig + 0.07)) ** 7
    second = 1.12 / (r_sig ** 7 + 0.12) - 2.0
    pot = pt.epsilon * first * second
    if flags.cavity_autoreject:
        pot = torch.where(pt.rimg < params.cavity_autoreject_scale * pt.sigma,
                          const.MAXVALUE, pot)
    return torch.sum(torch.where(ok, pot, 0.0))


# Silvera-Goldman constants (src/System.Energy.cpp:1763-1770)
SG_ALPHA, SG_BETA, SG_GAMMA = 1.713, 1.5671, 0.00993
SG_C6, SG_C8, SG_C10, SG_C9, SG_RM = 12.14, 215.2, 4813.9, 143.1, 8.321


def sg(state: SystemState, pt: PairTensors, flags: FFlags, params: RunParams):
    """Silvera-Goldman H2 potential (src/System.Energy.cpp:1773-1867): the
    reference applies it to every pair within the cutoff, with no
    exclusion or frozen check."""
    ok = pt.pair_once & pt.alive & (pt.rimg < state.pbc.cutoff)
    r = pt.rimg / const.AU2ANGSTROM
    r = torch.where(r == 0.0, 1.0, r)
    repulsive = torch.exp(SG_ALPHA - SG_BETA * r - SG_GAMMA * r * r)
    multipole = (SG_C6 / r ** 6 + SG_C8 / r ** 8 + SG_C10 / r ** 10 -
                 SG_C9 / r ** 9)
    r_rm = SG_RM / r
    expterm = torch.where(r < SG_RM, torch.exp(-((r_rm - 1.0) ** 2)), 1.0)
    pot = repulsive - multipole * expterm

    if flags.feynman_hibbs:
        first = (-SG_BETA - 2.0 * SG_GAMMA * r) * repulsive
        first = first + (6.0 * SG_C6 / r ** 7 + 8.0 * SG_C8 / r ** 9 -
                         9.0 * SG_C9 / r ** 10 +
                         10.0 * SG_C10 / r ** 11) * expterm
        frd = (r_rm * r_rm - r_rm) / r
        first = first + -2.0 * multipole * expterm * frd
        second = ((SG_BETA + 2.0 * SG_GAMMA * r) ** 2 -
                  2.0 * SG_GAMMA) * repulsive
        second = second + (-expterm) * (
            42.0 * SG_C6 / r ** 8 + 72.0 * SG_C8 / r ** 10 -
            90.0 * SG_C9 / r ** 11 + 110.0 * SG_C10 / r ** 10)
        second = second + expterm * frd * (
            12.0 * SG_C6 / r ** 7 + 16.0 * SG_C8 / r ** 9 -
            18.0 * SG_C9 / r ** 10 + 20.0 * SG_C10 / r ** 11)
        second = second + expterm * frd ** 2 * 4.0 * multipole
        srd = (3.0 * r_rm * r_rm - 2.0 * r_rm) / (r * r)
        second = second + expterm * srd * 2.0 * multipole
        mmass = const.AMU2KG * _lower_mass(state, pt)
        fh2 = (const.M2A2 * (const.hBar ** 2 /
               (24.0 * const.kB * params.temperature * mmass)) *
               (second + 2.0 * first / r))
        pot = pot + fh2
    return torch.sum(torch.where(ok, pot * const.HARTREE2KELVIN, 0.0))


def _lower_mass(state: SystemState, pt: PairTensors):
    """[R,A] mass of the pair's molecule of lower atom index: the
    reference's outer-loop molecule, whose mass alone enters the SG
    Feynman-Hibbs term.  On the dense and row-tiled triangles that is the
    row; on an [S,A] move window the column where it comes first (the
    twin reads the row there too, pair_potentials.py:264, so its Delta-E
    differs from its full recompute wherever the masses differ)."""
    mm = state.mol_mass[state.mol_id]
    mi = pt.row(mm)[:, None]
    if pt.rows is None:
        return mi
    col = torch.arange(mm.shape[0], device=mm.device)
    first = col[None, :] < pt.rows.clamp(0, mm.shape[0] - 1)[:, None]
    return torch.where(first, mm[None, :], mi)


DREIDING_GAMMA = 12.0


def dreiding(state: SystemState, pt: PairTensors, flags: FFlags,
             params: RunParams):
    """DREIDING exp-6 potential (src/System.Energy.cpp:2098-2215)."""
    g = DREIDING_GAMMA
    ok = (pt.pair_once & pt.alive & ~(pt.rimg > state.pbc.cutoff) &
          ~pt.rd_excluded & ~pt.frozen)
    r_sig = _safe_div(pt.rimg, pt.sigma)
    term6 = r_sig ** (-6.0) * (g / (g - 6.0))
    termexp = torch.where(
        pt.attractive_only, 0.0,
        torch.where(pt.rimg < 0.4 * pt.sigma, const.MAXVALUE,
                    torch.exp(g * (1.0 - r_sig)) * (6.0 / (g - 6.0))))
    pot = pt.epsilon * (termexp - term6)
    if flags.cavity_autoreject:
        pot = torch.where(pt.rimg < params.cavity_autoreject_scale * pt.sigma,
                          const.MAXVALUE, pot)
    return torch.sum(torch.where(ok, pot, 0.0))


def tt_damping(n: int, br):
    """Tang-Toennies damping f_n(br) (src/System.Energy.cpp:2037-2052)."""
    s = torch.ones_like(br)
    term = torch.ones_like(br)
    for i in range(1, n + 1):
        term = term * br / i
        s = s + term
    result = 1.0 - torch.exp(-br) * s
    return torch.where(result > 1e-9, result, 0.0)


def disp_expansion(state: SystemState, pt: PairTensors, flags: FFlags,
                   params: RunParams, pair_only: bool = False):
    """C6/C8/C10 dispersion + Born-Mayer repulsion
    (src/System.Energy.cpp:1939-2018).  The mbvdw coupling term is added by
    the energy dispatcher."""
    ok = pt.pair_once & pt.alive & ~pt.rd_excluded & ~pt.frozen
    r = torch.where(pt.rimg == 0.0, 1.0, pt.rimg)
    r2 = r * r
    r6 = r2 ** 3
    r8 = r6 * r2
    r10 = r8 * r2
    c6 = torch.zeros_like(pt.c6) if flags.disp_expansion_mbvdw else pt.c6
    repulsion = torch.where(
        (pt.epsilon != 0.0) & (pt.sigma != 0.0),
        315.7750382111558307123944638 * torch.exp(-pt.epsilon *
                                                  (r - pt.sigma)),
        0.0)
    if flags.damp_dispersion:
        br = pt.epsilon * r
        pot = (-tt_damping(6, br) * c6 / r6
               - tt_damping(8, br) * pt.c8 / r8
               - tt_damping(10, br) * pt.c10 / r10 + repulsion)
    else:
        pot = -c6 / r6 - pt.c8 / r8 - pt.c10 / r10 + repulsion
    if flags.cavity_autoreject:
        pot = torch.where(pt.rimg < params.cavity_autoreject_scale * pt.sigma,
                          const.MAXVALUE, pot)
        pot = torch.where((params.cavity_autoreject_repulsion != 0.0) &
                          (repulsion > params.cavity_autoreject_repulsion),
                          const.MAXVALUE, pot)
    energy = torch.sum(torch.where(ok, pot, 0.0))

    if flags.rd_lrc:
        cutoff = state.pbc.cutoff
        vol = state.pbc.volume
        lrc_ok = pt.pair_once & pt.alive & ~pt.frozen
        pair_lrc = -4.0 * const.pi * (
            pt.c6 / (3.0 * cutoff ** 3) + pt.c8 / (5.0 * cutoff ** 5) +
            pt.c10 / (7.0 * cutoff ** 7)) / vol
        energy = energy + torch.sum(torch.where(lrc_ok, pair_lrc, 0.0))
        if pair_only:
            return energy
        # self LRC (src/System.Energy.cpp:2056-2078): the reference reads
        # the *unmixed* atomic coefficients in a.u.
        if flags.extrapolate_disp_coeffs:
            c10s = torch.where((state.c6 != 0.0) & (state.c8 != 0.0),
                               49.0 / 40.0 * state.c8 ** 2 /
                               torch.where(state.c6 == 0, 1.0, state.c6), 0.0)
        else:
            c10s = state.c10
        self_lrc = -4.0 * const.pi * (
            state.c6 / (3.0 * cutoff ** 3) + state.c8 / (5.0 * cutoff ** 5) +
            c10s / (7.0 * cutoff ** 7)) / vol
        energy = energy + torch.sum(torch.where(
            state.atom_alive() & ~state.frozen, self_lrc, 0.0))
    return energy


def exp_fh_corr(flags, params, state, rimg, epsilon, pot, pt=None):
    """FH correction for exp repulsion (src/System.Energy.cpp:2400-2437)."""
    ir = _safe_div(1.0, rimg)
    ir3 = ir ** 3
    rm = _reduced_mass_kg(state, pt)
    eps = torch.where(epsilon == 0, 1.0, epsilon)
    dE = -pot / (2.0 * eps)
    d2E = dE / (2.0 * eps)
    corr = (const.M2A2 * (const.hBar2 /
            (24.0 * const.kB * params.temperature * rm)) *
            (d2E + 2.0 * dE * ir))
    if flags.feynman_hibbs_order >= 4:
        d3E = -d2E / (2.0 * eps)
        d4E = d3E / (2.0 * eps)
        corr = corr + (const.M2A4 * (const.hBar4 / (
            1152.0 * const.kB2 * params.temperature ** 2 * rm * rm)) *
            (15.0 * dE * ir3 + 4.0 * d3E * ir + d4E))
    return corr


def exp_repulsion(state: SystemState, pt: PairTensors, flags: FFlags,
                  params: RunParams, pair_only: bool = False):
    """Buckingham exponential repulsion (src/System.Energy.cpp:2275-2368)."""
    cutoff = _rd_cutoff(state, flags)
    ok = (pt.pair_once & pt.alive & (pt.rimg - const.SMALL_dR < cutoff) &
          (~pt.rd_excluded | bool(flags.rd_crystal)) & ~pt.frozen)
    eps = torch.where(pt.epsilon == 0.0, 1.0, pt.epsilon)
    if flags.rd_crystal:
        # lattice sum, images in [-order, order] (wider than LJ's)
        shift, origin = _crystal_shifts(state, flags.rd_crystal_order,
                                        include_origin=True)
        rvec = _row_disp(state, pt)[None] + shift[:, None, None, :]
        rr = torch.sqrt(torch.sum(rvec * rvec, dim=-1))
        use = (rr + const.SMALL_dR <= cutoff) & ~(origin[:, None, None] &
                                                  pt.rd_excluded[None])
        term = torch.sum(torch.where(use, torch.exp(-rr / (2.0 * eps[None])),
                                     0.0), dim=0)
    else:
        term = torch.exp(-pt.rimg / (2.0 * eps))
    pot = pt.sigma * term
    if flags.feynman_hibbs:
        pot = pot + exp_fh_corr(flags, params, state, pt.rimg, pt.epsilon,
                                pot, pt)
    energy = torch.sum(torch.where(ok, pot, 0.0))

    if flags.rd_crystal and not pair_only:
        # self term (src/System.Energy.cpp:2441-2469)
        shift, _ = _crystal_shifts(state, flags.rd_crystal_order,
                                   include_origin=False)
        rr = torch.sqrt(torch.sum(shift * shift, dim=-1))
        aeps = torch.where(state.epsilon == 0.0, 1.0, state.epsilon)
        t = 0.5 * torch.sum(torch.where(
            (rr <= cutoff)[:, None],
            torch.exp(-rr[:, None] / (2.0 * aeps[None, :])), 0.0), dim=0)
        aok = (state.atom_alive() & (state.sigma != 0.0) &
               (state.epsilon != 0.0))
        energy = energy + torch.sum(torch.where(aok, state.sigma * t, 0.0))

    if flags.rd_lrc:
        vol = state.pbc.volume
        rover2e = cutoff / (2.0 * eps)
        # the mask on pt's rows (the twin's is [A,A], which raises on a
        # row tile or a move window)
        sp = state.spectre
        ss_pair = pt.row(sp)[:, None] & sp[None, :]
        lrc_ok = (pt.pair_once & pt.alive & ~pt.frozen & ~ss_pair &
                  (pt.epsilon != 0.0) & (pt.sigma != 0.0))
        pair_lrc = ((8.0 * const.pi) * torch.exp(1.0 - rover2e) *
                    (cutoff ** 2 + 4.0 * pt.epsilon * cutoff +
                     8.0 * pt.epsilon ** 2) * pt.sigma / vol)
        energy = energy + torch.sum(torch.where(lrc_ok, pair_lrc, 0.0))
        if pair_only:
            return energy
        aeps = torch.where(state.epsilon == 0.0, 1.0, state.epsilon)
        arover = cutoff / (2.0 * aeps)
        self_lrc = ((8.0 * const.pi) * torch.exp(1.0 - arover) *
                    (cutoff ** 2 + 4.0 * state.epsilon * cutoff +
                     8.0 * state.epsilon ** 2) * state.sigma / vol)
        aok = (state.atom_alive() & (state.sigma != 0.0) &
               (state.epsilon != 0.0) & ~state.frozen & ~state.spectre)
        energy = energy + torch.sum(torch.where(aok, self_lrc, 0.0))
    return energy


def anharmonic(state: SystemState, flags: FFlags, params: RunParams):
    """1-D anharmonic oscillator well (src/System.Energy.cpp:757-885;
    pair_potentials.py:450-470).  The Feynman-Hibbs terms read the
    chain's temperature and are added only with feynman_kleinert off:
    with it on, the energy is the classical well, as in the twin, which
    has no Feynman-Kleinert iteration (a fault shared with it)."""
    k = flags.rd_anharmonic_k
    g = flags.rd_anharmonic_g
    x = state.pos[:, 0]
    pot = 0.5 * k * x ** 2 + 0.25 * g * x ** 4
    if flags.feynman_hibbs and not flags.feynman_kleinert:
        mass = const.AMU2KG * state.mass
        T = params.temperature
        first = k * x + g * x ** 3
        second = k + 3.0 * g * x ** 2
        xs = torch.where(x == 0.0, 1.0, x)
        pot = pot + (const.M2A2 * const.hBar ** 2 /
                     (24.0 * const.kB * T * mass) *
                     (second + 2.0 * first / xs))
        if flags.feynman_hibbs_order == 4:
            other = 15.0 * k / xs ** 2 + 45.0 * g
            pot = pot + (const.M2A4 * const.hBar ** 4 /
                         (1152.0 * (const.kB * T * mass) ** 2) * other)
    return torch.sum(torch.where(state.atom_alive(), pot, 0.0))


def rd_energy(state: SystemState, pt: PairTensors, flags: FFlags,
              params: RunParams, pair_only: bool = False):
    """Repulsion-dispersion energy of the pairs in ``pt`` in the dense
    dispatch order of energy.py:80-101 (the many-body coupling of
    disp_expansion_mbvdw is added by the dense caller): the anharmonic
    well first, and GWP with no other form has none."""
    if flags.rd_anharmonic:
        return anharmonic(state, flags, params)
    if flags.use_sg:
        return sg(state, pt, flags, params)
    if flags.use_dreiding:
        return dreiding(state, pt, flags, params)
    if flags.using_lj_buffered_14_7:
        return lj_buffered_14_7(state, pt, flags, params)
    if flags.using_disp_expansion:
        return disp_expansion(state, pt, flags, params, pair_only=pair_only)
    if flags.cdvdw_exp_repulsion:
        return exp_repulsion(state, pt, flags, params, pair_only=pair_only)
    if flags.gwp:
        return torch.zeros((), dtype=torch.float64, device=state.pos.device)
    return lj(state, pt, flags, params, pair_only=pair_only)
