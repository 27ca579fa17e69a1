"""Coupled-dipole ("polarvdw") many-body van der Waals energy.

JAX twin: mpmcxx_tpu/ops/polarvdw.py.  The vdW energy comes from the
eigenvalues of the mass-weighted Thole matrix C = K^-1/2 A K^-1/2
(src/System.Energy.cpp:175-753; the reference's LAPACK dsyev_ calls are
commented out, :566,571, so the twin restores the physics):

E = (sum_i sqrt(lambda_i) [C]  -  sum_i sqrt(lambda_i) [C_iso]) * au->K

where C_iso zeroes every inter-molecular block, so its spectrum is the
union of the isolated molecules' spectra.  The eigenvalues are
``torch.linalg.eigvalsh`` in float64 (cuSOLVER on the card); rows with
sqrt(alpha)*omega == 0 give exact zeros, which round-off can make
slightly negative, so negative eigenvalues are clamped to 0 as in the
twin.  The system is dense (runner.capacity_opts keeps it off the
incremental and blocked paths).
"""

from __future__ import annotations

import torch

from .. import constants as const
from ..flags import FFlags, RunParams
from ..state import SystemState
from .pair_potentials import _reduced_mass_kg, _safe_div
from .pairwise import PairTensors


def _sqrtkinv(state: SystemState):
    """sqrt(alpha_i)*omega_i per atom; zero kills the row/col
    (src/System.Energy.cpp:231-251)."""
    k = torch.sqrt(torch.abs(state.polarizability)) * state.omega
    return torch.where(state.atom_alive(), k, 0.0)


def _cmatrix(state: SystemState, Amat, intra_only: bool):
    """[3A,3A] C matrix; zero rows/cols where sqrtKinv == 0 (their
    eigenvalues become 0 and add nothing to sum sqrt(lambda))."""
    A = state.n_atom_slots
    k = _sqrtkinv(state)
    blocks = Amat * (k[:, None] * k[None, :])[:, :, None, None]
    if intra_only:
        same = state.mol_id[:, None] == state.mol_id[None, :]
        blocks = blocks * same[:, :, None, None]
    return blocks.permute(0, 2, 1, 3).reshape(3 * A, 3 * A)


def _eigen_energy(C):
    lam = torch.linalg.eigvalsh(C)
    lam = torch.where(lam < 0.0, 0.0, lam)
    return torch.sum(torch.sqrt(lam))


def _pair_params(state: SystemState, pt: PairTensors):
    """(alpha_i, alpha_j, omega_i, omega_j) on pt's [R,A] layout."""
    a, w = state.polarizability, state.omega
    return pt.row(a)[:, None], a[None, :], pt.row(w)[:, None], w[None, :]


def e2body(state: SystemState, pt: PairTensors, params: RunParams, r):
    """Two-body coupled-dipole energy at separation ``r`` [R,A]: the
    reference's 6x6 eigenproblem (src/System.Energy.cpp:498-536) is three
    2x2 blocks (one per axis), solved in closed form."""
    l = params.polar_damp
    lr = l * r
    elr = torch.exp(-lr)
    r3 = torch.where(r == 0.0, 1.0, r) ** 3
    Txx = (-2.0 + (0.5 * lr ** 3 + lr ** 2 + 2 * lr + 2) * elr) / r3
    Tyy = (1.0 - (0.5 * lr ** 2 + lr + 1) * elr) / r3
    ai, aj, wi, wj = _pair_params(state, pt)
    coupling = wi * wj * torch.sqrt(torch.abs(ai * aj))

    def axis_sum(T):
        c = coupling * T
        p, q = wi ** 2, wj ** 2
        disc = torch.sqrt(torch.clamp((p - q) ** 2 + 4.0 * c * c, min=0.0))
        lam1 = torch.clamp(0.5 * (p + q + disc), min=0.0)
        lam2 = torch.clamp(0.5 * (p + q - disc), min=0.0)
        return torch.sqrt(lam1) + torch.sqrt(lam2)

    total = axis_sum(Txx) + 2.0 * axis_sum(Tyy)
    total = total - 3.0 * wi - 3.0 * wj
    return total * const.au2invseconds * const.half_hBar


def _fh_mask(state: SystemState, pt: PairTensors):
    ai, aj, wi, wj = _pair_params(state, pt)
    return (pt.pair_once & pt.alive & ~pt.frozen & ~pt.same_mol &
            ~(pt.rimg > state.pbc.cutoff) &
            (ai != 0.0) & (aj != 0.0) & (wi != 0.0) & (wj != 0.0))


def fh_vdw_corr(state: SystemState, pt: PairTensors, flags: FFlags,
                params: RunParams):
    """FH correction by 5-point finite differencing of e2body
    (src/System.Energy.cpp:630-689)."""
    H = 0.01
    mask = _fh_mask(state, pt)
    r = pt.rimg
    E = [e2body(state, pt, params, r + dh)
         for dh in (-2 * H, -H, 0.0, H, 2 * H)]
    dv = (E[3] - E[1]) / (2.0 * H)
    d2v = (E[3] - 2.0 * E[2] + E[1]) / (H * H)
    d3v = (E[4] - 2 * E[3] + 2 * E[1] - E[0]) / (2 * H ** 3)
    d4v = (E[4] - 4 * E[3] + 6 * E[2] - 4 * E[1] + E[0]) / H ** 4
    rm = _reduced_mass_kg(state, pt)
    T = params.temperature
    rs = torch.where(r == 0.0, 1.0, r)
    corr = (const.METER2ANGSTROM ** 2 *
            (const.hBar * const.hBar / (24.0 * const.kB * T * rm)) *
            (d2v + 2.0 * dv / rs))
    if flags.feynman_hibbs_order >= 4:
        corr = corr + (const.METER2ANGSTROM ** 4 *
                       (const.hBar ** 4 / (1152.0 * (const.kB * T * rm) ** 2))
                       * (15.0 * dv / rs ** 3 + 4.0 * d3v / rs + d4v))
    return torch.sum(torch.where(mask, corr, 0.0))


def _c6_coeff(state: SystemState, pt: PairTensors):
    """The pair's London C6 from alpha and omega (K*Angstrom^6)."""
    ai, aj, wi, wj = _pair_params(state, pt)
    return (1.5 * const.c_hBar * _safe_div(wi * wj, wi + wj) *
            const.au2invseconds * ai * aj)


def fh_vdw_corr_2be(state: SystemState, pt: PairTensors, flags: FFlags,
                    params: RunParams):
    """FH via analytic C6 derivatives (src/System.Energy.cpp:693-753)."""
    mask = _fh_mask(state, pt)
    cC = _c6_coeff(state, pt)
    rm = _reduced_mass_kg(state, pt)
    r = torch.where(pt.rimg == 0.0, 1.0, pt.rimg)
    T = params.temperature
    dv = 6.0 * cC * r ** (-7.0)
    d2v = dv * (-7.0) / r
    corr = (const.METER2ANGSTROM ** 2 *
            (const.hBar * const.hBar / (24.0 * const.kB * T * rm)) *
            (d2v + 2.0 * dv / r))
    if flags.feynman_hibbs_order >= 4:
        d3v = d2v * (-8.0) / r
        d4v = d3v * (-9.0) / r
        corr = corr + (const.METER2ANGSTROM ** 4 *
                       (const.hBar ** 4 / (1152.0 * (const.kB * T * rm) ** 2))
                       * (15.0 * dv / r ** 3 + 4.0 * d3v / r + d4v))
    return torch.sum(torch.where(mask, corr, 0.0))


def lr_vdw_corr(state: SystemState, pt: PairTensors, params: RunParams):
    """Long-range correction (src/System.Energy.cpp:586-626); same-molecule
    pairs DO contribute (reference comment at :608)."""
    ai, aj, wi, wj = _pair_params(state, pt)
    mask = (pt.pair_once & pt.alive & ~pt.frozen &
            (ai != 0.0) & (aj != 0.0) & (wi != 0.0) & (wj != 0.0))
    corr = -4.0 / 3.0 * const.pi * _c6_coeff(state, pt) * \
        state.pbc.cutoff ** (-3.0) / state.pbc.volume
    return torch.sum(torch.where(mask, corr, 0.0))


def vdw(state: SystemState, Amat, pt: PairTensors, flags: FFlags,
        params: RunParams):
    """Total coupled-dipole vdW energy (src/System.Energy.cpp:175-227)
    from the dense [A,A,3,3] Thole matrix ``Amat``."""
    e_total = _eigen_energy(_cmatrix(state, Amat, intra_only=False))
    e_iso = _eigen_energy(_cmatrix(state, Amat, intra_only=True))
    energy = (e_total * const.au2invseconds * const.half_hBar -
              e_iso * const.au2invseconds * const.half_hBar)
    if flags.feynman_hibbs:
        energy = energy + (fh_vdw_corr_2be(state, pt, flags, params)
                           if flags.vdw_fh_2be
                           else fh_vdw_corr(state, pt, flags, params))
    if flags.rd_lrc:
        energy = energy + lr_vdw_corr(state, pt, params)
    return energy
