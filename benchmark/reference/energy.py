"""Plain reference of the energy a polarizable GCMC state carries.

MPMC++'s potential of one configuration (System::energy(),
src/System.Energy.cpp), written out in plain PyTorch from the physics a
configuration states: Lennard-Jones with Lorentz-Berthelot mixing, its
long-range corrections and Feynman-Hibbs corrections of order 2 or 4;
Ewald electrostatics (real space with the intra-molecular screening
correction and its Feynman-Hibbs term, the hemisphere k-space sum, the
self term; frozen atoms take no part); Thole polarization under
exponential damping with the Ewald static field (polar_ewald), solved by
the configured Jacobi iteration (a fixed polar_max_iter, or termination
at polar_precision with the 128-sweep fallback to alpha E) from alpha E,
with Palmo's correction where configured.  Energy = -1/2 sum mu . E.

It imports nothing of the program and takes nothing the program made:
the atoms' parameters come from the benchmark's own inputs, and only the
positions and which molecules are alive come from the state under test.

``dtype`` is the precision of every pair sum (float64 for the reference;
the control computes in float32), ``plane_dtype`` that of the stored
dipole-tensor planes of the SCF (the configuration's polar_mixed states
float32 planes; the control holds them in bfloat16).  Work is done in
``block``-row tiles so that a 10k-atom system fits beside nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C


def _kvecs(kmax: int) -> np.ndarray:
    """The integer hemisphere k-lattice (src/System.Energy.cpp:1577-1583)."""
    out = []
    for l0 in range(0, kmax + 1):
        for l1 in range(0 if l0 == 0 else -kmax, kmax + 1):
            for l2 in range(1 if (l0 == 0 and l1 == 0) else -kmax,
                            kmax + 1):
                if l0 * l0 + l1 * l1 + l2 * l2 <= kmax * kmax:
                    out.append((l0, l1, l2))
    return np.asarray(out, dtype=np.float64)


class _Pairs:
    """Pair quantities of rows ``i0:i1`` against every atom."""

    def __init__(self, a, i0, i1, L):
        pos = a["pos"]
        self.rows = slice(i0, i1)
        self.i = torch.arange(i0, i1, device=pos.device)[:, None]
        self.j = torch.arange(pos.shape[0], device=pos.device)[None, :]
        d = pos[i0:i1, None, :] - pos[None, :, :]
        self.d = d
        self.dimg = d - L * torch.round(d / L)
        self.rimg = torch.sqrt(torch.sum(self.dimg * self.dimg, dim=-1))
        self.r = torch.sqrt(torch.sum(d * d, dim=-1))
        self.upper = self.j > self.i
        self.not_self = self.j != self.i
        self.same_mol = a["mol"][i0:i1, None] == a["mol"][None, :]
        self.frozen = a["frozen"][i0:i1, None] & a["frozen"][None, :]
        q = a["q"]
        self.qi, self.qj = q[i0:i1, None], q[None, :]
        self.es_excluded = self.same_mol | (self.qi == 0) | (self.qj == 0)
        mi, mj = a["mol_mass"][i0:i1, None], a["mol_mass"][None, :]
        s = mi + mj
        self.rm = mi * mj / torch.where(s == 0, 1.0, s)    # amu


def _fh_factors(phys):
    """The Feynman-Hibbs prefactors of order 2 and 4 over a reduced mass
    in amu (hBar^2 / (24 kB T m) and hBar^4 / (1152 kB^2 T^2 m^2) in
    A^2 and A^4), folded in float64 on the host: float32 holds neither
    hBar^4 nor kB^2."""
    T = phys["temperature"]
    f2 = C.M2A2 * C.hBar2 / (24.0 * C.kB * T * C.AMU2KG)
    f4 = C.M2A4 * C.hBar4 / (1152.0 * C.kB2 * T * T * C.AMU2KG ** 2)
    return f2, f4


def _nz(x):
    return torch.where(x == 0, torch.ones_like(x), x)


def _lj(a, p, phys, rc, V):
    """Lennard-Jones pair energy, Feynman-Hibbs and the pair part of the
    long-range correction (src/System.Energy.cpp:897-1148)."""
    si, sj = a["sigma"][p.rows, None], a["sigma"][None, :]
    ei, ej = a["epsilon"][p.rows, None], a["epsilon"][None, :]
    sig = torch.where((si == 0) | (sj == 0), 0.0, 0.5 * (si + sj))
    eps = torch.sqrt(ei * ej)
    excl = p.same_mol | (ei == 0) | (si == 0) | (ej == 0) | (sj == 0)
    use = p.upper & (p.rimg - C.SMALL_dR < rc) & ~excl & ~p.frozen
    ir = 1.0 / _nz(p.rimg)
    t6 = (sig * ir) ** 6
    t12 = t6 * t6
    pot = 4.0 * eps * (t12 - t6)
    if phys["feynman_hibbs"]:
        f2, f4 = _fh_factors(phys)
        dE = -24.0 * eps * (2.0 * t12 - t6) * ir
        d2E = 24.0 * eps * (26.0 * t12 - 7.0 * t6) * ir * ir
        pot = pot + f2 / p.rm * (d2E + 2.0 * dE * ir)
        if phys["feynman_hibbs_order"] >= 4:
            d3E = -1344.0 * eps * (6.0 * t12 - t6) * ir ** 3
            d4E = 12096.0 * eps * (10.0 * t12 - t6) * ir ** 4
            pot = pot + f4 / (p.rm * p.rm) * (
                15.0 * dE * ir ** 3 + 4.0 * d3E * ir + d4E)
    e = torch.where(use, pot, 0.0)
    ok = p.upper & ~p.frozen & (eps != 0) & (sig != 0)
    sc = sig / rc
    lrc = (16.0 / 3.0) * C.pi * eps * sig ** 3 * (
        (1.0 / 3.0) * sc ** 9 - sc ** 3) / V
    lrc = torch.where(ok, lrc, 0.0)
    return (torch.sum(e), torch.sum(lrc),
            torch.sum(torch.abs(e)) + torch.sum(torch.abs(lrc)))


def _lrc_self(a, rc, V):
    s, e = a["sigma"], a["epsilon"]
    ok = (s != 0) & (e != 0) & ~a["frozen"]
    sc = s / rc
    v = (16.0 / 3.0) * C.pi * e * s ** 3 * ((1.0 / 3.0) * sc ** 9 -
                                            sc ** 3) / V
    return torch.sum(torch.where(ok, v, 0.0))


def _coulomb_fh(p, r, alpha, phys):
    """The Feynman-Hibbs term of the real-space sum
    (src/System.Energy.cpp:1521-1557), as MPMC++ adds it: a function of
    the distance and the pair's reduced mass alone."""
    sqpi = float(np.sqrt(C.pi))
    gauss = torch.exp(-alpha * alpha * r * r)
    erfc = torch.special.erfc(alpha * r)
    ir = 1.0 / r
    ir2, ir3, ir4 = ir * ir, ir ** 3, ir ** 4
    a3 = alpha ** 3
    du = -2.0 * alpha * gauss / (r * sqpi) - erfc * ir2
    d2u = (4.0 / sqpi) * gauss * (a3 + ir2) + 2.0 * erfc * ir3
    f2, f4 = _fh_factors(phys)
    fh = f2 / p.rm * (d2u + 2.0 * du / r)
    if phys["feynman_hibbs_order"] >= 4:
        d3u = (gauss / sqpi) * (-8.0 * a3 * alpha ** 2 * r - 8.0 * a3 / r -
                                12.0 * alpha * ir3) - 6.0 * erfc * ir4
        d4u = (gauss / sqpi) * (8.0 * a3 * alpha ** 2 +
                                16.0 * a3 * alpha ** 4 * r * r +
                                32.0 * a3 * ir2 + 48.0 * ir4) + \
            24.0 * erfc * ir4 * ir
        fh = fh + f4 / (p.rm * p.rm) * (
            15.0 * du * ir3 + 4.0 * d3u / r + d4u)
    return fh


def _ewald_real(a, p, phys, rc, alpha):
    """Real-space erfc sum less the screening of excluded pairs
    (src/System.Energy.cpp:1466-1517); frozen pairs take no part."""
    base = p.upper & ~p.frozen
    r = _nz(p.rimg)
    pot = p.qi * p.qj * torch.special.erfc(alpha * r) / r
    if phys["feynman_hibbs"]:
        pot = pot + _coulomb_fh(p, r, alpha, phys)
    cut = ~(p.rimg > rc) & ~p.es_excluded
    rr = _nz(p.r)
    intra = p.qi * p.qj * torch.special.erf(alpha * rr) / rr
    return (torch.sum(torch.where(base & cut, pot, 0.0)) -
            torch.sum(torch.where(base & p.es_excluded, intra, 0.0)))


def _static_field_real(a, p, rc, alpha):
    """The Ewald real-space static field at rows i (src/System.Energy.cpp:
    2900-2940): sum_j f_ij q_j d_ij."""
    base = ~p.frozen & p.not_self & (p.rimg != 0) & ~(p.rimg > rc)
    r = _nz(p.rimg)
    r3 = r * r * r
    g = 2.0 * alpha * C.OneOverSqrtPi * torch.exp(-alpha * alpha * r * r) * r
    f = torch.where(p.es_excluded, (g - torch.special.erf(alpha * r)) / r3,
                    (g + torch.special.erfc(alpha * r)) / r3)
    f = torch.where(base, f, 0.0)
    return torch.sum((f * p.qj)[..., None] * p.dimg, dim=1)


def _thole_planes(p, damp, plane_dtype):
    """Rows of the exponential-damped dipole tensor T_ij = co d d^T +
    cd I over every live pair i != j at the minimum image, no cutoff
    (src/System.Energy.cpp:2694-2767): (co, cd, dx, dy, dz)."""
    r = p.rimg
    live = p.not_self & (r > 0)
    ir = 1.0 / _nz(r)
    x = damp * r
    ex = torch.exp(-x)
    d1 = 1.0 - ex * (0.5 * x * x + x + 1.0)
    d2 = d1 - ex * (x ** 3 / 6.0)
    co = torch.where(live, -3.0 * d2 * ir ** 5, 0.0)
    cd = torch.where(live, d1 * ir ** 3, 0.0)
    dd = torch.where(live[..., None], p.dimg, 0.0)
    return tuple(t.to(plane_dtype) for t in
                 (co, cd, dd[..., 0], dd[..., 1], dd[..., 2]))


def _induced(planes, mu, block):
    """E_ind = -sum_j T_ij mu_j, in ``block``-row tiles of the stored
    planes, computed in mu's precision."""
    co, cd, dx, dy, dz = planes
    n = mu.shape[0]
    out = []
    for i0 in range(0, n, block):
        t = [x[i0:i0 + block].to(mu.dtype) for x in (co, cd, dx, dy, dz)]
        dot = t[2] * mu[None, :, 0] + t[3] * mu[None, :, 1] + \
            t[4] * mu[None, :, 2]
        s = t[0] * dot
        out.append(-torch.stack([
            torch.sum(s * t[k + 2] + t[1] * mu[None, :, k], dim=1)
            for k in range(3)], dim=1))
    return torch.cat(out)


def _scf(E, alpha, planes, phys, block):
    """The configured Jacobi SCF from mu0 = gamma alpha E
    (src/System.Energy.cpp:3450-3543): (mu, iterations, failed)."""
    al = alpha[:, None]
    mu = al * E * phys["polar_gamma"]
    prec = phys["polar_precision"]
    if prec == 0.0:
        for _ in range(phys["polar_max_iter"]):
            mu = al * (E + _induced(planes, mu, block))
        return mu, phys["polar_max_iter"], False
    allowed = (prec * C.DEBYE2SKA) ** 2
    for it in range(1, C.MAX_ITERATION_COUNT + 1):
        new = al * (E + _induced(planes, mu, block))
        done = bool(torch.all((new - mu) ** 2 <= allowed))
        mu = new
        if done:
            return mu, it, False
    return al * E, C.MAX_ITERATION_COUNT, True


def energy_terms(a: dict, phys: dict, box: float, dtype=torch.float64,
                 plane_dtype=None, block: int = 1024) -> dict:
    """The energy terms of the live atoms ``a`` (tensors on one device:
    pos [n,3], q [n] in sqrt(K A), sigma, epsilon, alpha [n], frozen [n]
    bool, mol [n] int64, mol_mass [n] amu) in a cubic box of side
    ``box``.  Returns floats: rd, coulombic (real + recip + self),
    recip, polarization, the scales of rd and coulombic (the sums of
    their parts' magnitudes), and the SCF's iterations and whether it
    fell back."""
    plane_dtype = plane_dtype or dtype
    a = {k: (v.to(dtype) if v.is_floating_point() else v)
         for k, v in a.items()}
    dev = a["pos"].device
    n = a["pos"].shape[0]
    L = float(box)
    V = L ** 3
    rc = 0.5 * L
    alpha = 3.5 / rc if phys.get("ewald_alpha") is None else \
        phys["ewald_alpha"]
    palpha = 3.5 / rc if phys.get("polar_ewald_alpha") is None else \
        phys["polar_ewald_alpha"]
    z = torch.zeros((), dtype=dtype, device=dev)
    rd, lrc, rd_abs, real = z, z, z, z
    E_real = []
    planes = []
    polar = phys["polarization"]
    for i0 in range(0, n, block):
        p = _Pairs(a, i0, min(i0 + block, n), L)
        e, l, mag = _lj(a, p, phys, rc, V)
        rd, lrc, rd_abs = rd + e, lrc + l, rd_abs + mag
        real = real + _ewald_real(a, p, phys, rc, alpha)
        if polar:
            E_real.append(_static_field_real(a, p, rc, palpha))
            planes.append(_thole_planes(p, phys["polar_damp"], plane_dtype))
        del p
    lrc_self = _lrc_self(a, rc, V)
    rd = rd + lrc + lrc_self

    # k-space: hemisphere vectors, k = 2 pi l / L
    k = torch.as_tensor(_kvecs(phys["ewald_kmax"]), dtype=dtype,
                        device=dev) * (2.0 * C.pi / L)
    k2 = torch.sum(k * k, dim=-1)
    phase = a["pos"] @ k.T                         # [n,K]
    cos, sin = torch.cos(phase), torch.sin(phase)
    qm = torch.where(a["frozen"], 0.0, a["q"])
    s_re, s_im = qm @ cos, qm @ sin
    recip = torch.sum(torch.exp(-k2 / (4.0 * alpha * alpha)) / k2 *
                      (s_re ** 2 + s_im ** 2)) * 4.0 * C.pi / V
    self_e = -torch.sum(alpha * qm ** 2) / float(np.sqrt(C.pi))
    coul = real + recip + self_e

    # the scales the gaps are measured against: the sums of the terms'
    # magnitudes, which a total that cancels to near 0 is not
    out = {"rd": rd, "coulombic": coul, "recip": recip,
           "rd_scale": rd_abs + torch.abs(lrc_self),
           "coulombic_scale": (torch.abs(real) + torch.abs(recip) +
                               torch.abs(self_e)),
           "polarization": z, "iterations": 0, "failed": False}
    if polar:
        f1, f2 = a["q"] @ cos, a["q"] @ sin
        kw = k / k2[:, None] * torch.exp(-k2 / (4.0 * palpha * palpha))[
            :, None]
        E = torch.cat(E_real) + (sin * f1[None] - cos * f2[None]) @ kw * (
            8.0 * C.pi / V)
        planes = tuple(torch.cat(t) for t in zip(*planes))
        mu, iters, failed = _scf(E, a["alpha"], planes, phys, block)
        pot = torch.sum(mu * E)
        if phys["polar_palmo"]:
            al = a["alpha"][:, None]
            implied = mu / torch.where(al == 0, 1.0, al) - E
            change = torch.where(al != 0, _induced(planes, mu, block) -
                                 implied, 0.0)
            pot = pot + torch.sum(mu * change)
        out.update(polarization=-0.5 * pot, iterations=iters,
                   failed=failed)
    return {k: (float(v) if torch.is_tensor(v) else v)
            for k, v in out.items()}
