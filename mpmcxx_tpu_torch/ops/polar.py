"""Thole dipole polarization: the mixed-precision exponential-damping path.

JAX twin: mpmcxx_tpu/ops/polar.py.  Ported: the Ewald static field
(real_term, recip_term; src/System.Energy.cpp:2834-2940), the float32
pair-coefficient planes of the mixed-precision SCF (mixed_coeff_scalars,
plane_mode, coeffs_from_d, fold_outer_rows, mixed_field_coeffs), the
contraction ``-T mu`` over those planes (contract_mixed, which runs a
hand-written CUDA kernel of ops/cuda_polar.py on a CUDA tensor, chosen by
the JAX package's MPMCXX_SYM_KERNEL / MPMCXX_TRI_KERNEL switch), and the
fixed-iteration Jacobi solve (thole_iterative, finish_polar,
polar_blocked).  Energy = -1/2 sum mu . E_static in Kelvin.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

from .. import constants as const
from ..flags import FFlags, RunParams
from ..state import SystemState
from . import cuda_polar
from .ewald import kvectors
from .pairwise import (PairTensors, _arange, assemble_tiles,
                       build_pairs_rect, phase_dot, tile_starts)


class PolarResult(NamedTuple):
    energy: torch.Tensor          # polarization energy (K)
    mu: torch.Tensor              # [A,3] converged dipoles
    iterations: torch.Tensor      # iteration count (f64)
    iterator_failed: torch.Tensor # bool
    dipole_rrms: torch.Tensor     # mean dipole rrms


def _thole_damps(state: SystemState, pt: PairTensors, flags: FFlags,
                 params: RunParams):
    """(damp1, damp2) of exponential Thole damping for the pairs in pt
    (src/System.Energy.cpp:2712-2726)."""
    l = params.polar_damp
    r = pt.rimg
    explr = torch.exp(-l * r)
    damp1 = 1.0 - explr * (0.5 * l * l * r * r + l * r + 1.0)
    damp2 = damp1 - explr * (l ** 3 * r ** 3 / 6.0)
    return damp1, damp2


def _not_self(state: SystemState, pt: PairTensors):
    A = state.n_atom_slots
    safe = pt.rows.clamp(0, A - 1)
    return (_arange(A, safe)[None, :] != safe[:, None]) & \
        (pt.rows >= 0)[:, None]


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


def real_term(state: SystemState, pt: PairTensors, params: RunParams):
    """Real-space static field for the Ewald treatment
    (src/System.Energy.cpp:2900-2940)."""
    f = _real_field_scalars(state, pt, params)
    q_j = state.charge[None, :, None]
    return torch.sum(f[..., None] * q_j * pt.dimg, dim=1)


def field_scalars(state: SystemState, pt: PairTensors, flags: FFlags,
                  params: RunParams):
    """Per-pair static-field scalar: the field at row i is
    sum_j f_ij q_j d_ij (Ewald real space, the only treatment ported)."""
    return _real_field_scalars(state, pt, params)


def _apply_relax(flags: FFlags, params: RunParams, new_mu, old_mu, it):
    if flags.polar_sor:
        return params.polar_gamma * new_mu + \
            (1.0 - params.polar_gamma) * old_mu
    if flags.polar_esor:
        w = 1.0 - math.exp(-params.polar_gamma * it)
        return w * new_mu + (1.0 - w) * old_mu
    return new_mu


def thole_iterative(state: SystemState, E_static, flags: FFlags,
                    params: RunParams, contract_fn):
    """Fixed-iteration Jacobi dipole solve (src/System.Energy.cpp:
    3450-3543 with a fixed polar_max_iter; polar.py:412-426): the
    reference's non-Gauss-Seidel update contracting the previous sweep's
    dipoles, cold-started from alpha * E_static."""
    alpha = state.polarizability[:, None]
    alive = state.atom_alive()[:, None]
    mu0 = alpha * E_static
    if not (flags.polar_sor or flags.polar_esor):
        mu0 = mu0 * params.polar_gamma
    mu = torch.where(alive, mu0, 0.0)
    old_mu = torch.zeros_like(mu)
    for it in range(1, flags.polar_max_iter + 1):
        new_mu = alpha * (E_static + contract_fn(mu))
        new_mu = torch.where(alive, new_mu, 0.0)
        mu, old_mu = _apply_relax(flags, params, new_mu, mu, it), mu
    iters = torch.full((), float(flags.polar_max_iter), dtype=torch.float64,
                       device=mu.device)
    failed = torch.zeros((), dtype=torch.bool, device=mu.device)
    return mu, iters, failed, _dipole_rrms_mean(state, mu, old_mu)


def _dipole_rrms_mean(state: SystemState, new_mu, old_mu):
    """(src/System.Energy.cpp:3147-3177 + 2639-2657)"""
    num = torch.sum((new_mu - old_mu) ** 2, dim=-1)
    den = torch.sum(new_mu * new_mu, dim=-1)
    rrms = torch.sqrt(num / torch.where(den == 0.0, 1.0, den))
    rrms = torch.where(torch.isfinite(rrms) & (den != 0.0), rrms, 0.0)
    return torch.sum(rrms) / state.n_atom_slots


def mixed_coeff_scalars(state: SystemState, pt: PairTensors, flags: FFlags,
                        params: RunParams):
    """(c_outer, c_diag) float32 dipole-contraction coefficients for the
    pairs in ``pt``: T_ij mu_j = c_outer d (d.mu) + c_diag mu."""
    r = pt.rimg
    ir = 1.0 / torch.where(r == 0.0, 1.0, r)
    damp1, damp2 = _thole_damps(state, pt, flags, params)
    mask = _not_self(state, pt) & pt.alive
    c_outer = -3.0 * damp2 * ir ** 5
    c_diag = damp1 * ir ** 3
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
    for s in tile_starts(A, block):
        if A <= block:
            rows_f = torch.arange(block, device=state.pos.device)
            rows = torch.where(rows_f < A, rows_f, -1)
        else:
            rows = s + torch.arange(block, device=state.pos.device)
        pt = build_pairs_rect(state, flags, rows)
        c_outer, c_diag = mixed_coeff_scalars(state, pt, flags, params)
        d32 = pt.dimg.to(torch.float32)
        planes.append(fold_outer_rows(c_outer, c_diag, d32[..., 0],
                                      d32[..., 1], d32[..., 2], flags))
        fields.append(real_term(state, pt, params))
    planes = tuple(assemble_tiles(torch.stack(p), A, block)
                   for p in zip(*planes))
    E = assemble_tiles(torch.stack(fields), A, block)
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


def contract_mixed(coeffs, mu, l=None):
    """ef_induced = -T mu from the 3-, 4- or 5-plane f32 tuple of
    fold_outer_rows; the 3-plane mode needs the damping width ``l``
    (params.polar_damp).  Where the JAX package would run
    contract_pallas_tri (use_tri) this runs kernel K4
    (ops/cuda_polar.contract_planes_tri), otherwise kernel K1
    (contract_planes); each takes its plain PyTorch version on CPU
    tensors."""
    if len(coeffs) == 3 and l is None:
        raise ValueError("3-plane mixed coefficients need l=polar_damp")
    l = 0.0 if l is None else l
    if use_tri(coeffs[0].shape):
        return cuda_polar.contract_planes_tri(coeffs, mu, l)
    return cuda_polar.contract_planes(coeffs, mu, l)


def polar_blocked(state: SystemState, flags: FFlags, params: RunParams,
                  block: int = 128) -> PolarResult:
    """Large-system polarization: f32 coefficient planes + matrix-free
    fixed-iteration solve (polar_mixed path of polar.py:900-915)."""
    coeffs, E_static = mixed_field_coeffs(state, flags, params, block)
    return finish_polar(state, flags, params, E_static,
                        lambda m: contract_mixed(coeffs, m,
                                                 l=params.polar_damp))


def finish_polar(state: SystemState, flags: FFlags, params: RunParams,
                 E_static, contract_fn) -> PolarResult:
    """Solve for the dipoles given a static field and a matrix-free
    contraction, and assemble the polarization energy."""
    mu, iters, failed, rrms = thole_iterative(state, E_static, flags,
                                              params, contract_fn)
    return PolarResult(-0.5 * torch.sum(mu * E_static), mu, iters, failed,
                       rrms)
