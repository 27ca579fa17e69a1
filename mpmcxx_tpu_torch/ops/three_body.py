"""Axilrod-Teller triple-dipole 3-body dispersion.

JAX twin: mpmcxx_tpu/ops/three_body.py (src/System.Energy.cpp:1653-1751):
the reference's loop over molecule/atom triples becomes batched
contractions of the minimum-image displacement tensor.  Counting matches
the reference: all ordered triples of distinct atoms spanning >= 2
distinct molecules, divided by 6.

The twin builds every [A,A,A] float64 term at once (about twelve of
them, 1.07 GB each at 512 atoms).  Here the sum runs over chunks of the
first atom i, each chunk a [c,A,A] slab of about ``_CHUNK_ELEMS``
elements, so memory stays bounded; the result differs from the twin's
only in reduction order (<= 1e-12 relative).
"""

from __future__ import annotations

import torch

from ..flags import FFlags
from ..state import SystemState
from .pairwise import PairTensors, _arange

BOHR3 = 6.7483345                # polarizability A^3 -> a.u. factor
C9_UNIT = 0.0032539449 / (3.166811429e-6)  # H*Bohr^9 -> K*A^9
_CHUNK_ELEMS = 1 << 24           # [c,A,A] elements per chunk (128 MB f64)


def axilrod_teller(state: SystemState, pt: PairTensors, flags: FFlags):
    """Triple-dipole energy (K) of the dense pairs ``pt``."""
    a = state.polarizability * BOHR3
    if flags.midzuno_kihara_approx:
        c9_atom = 0.75 * a * state.c6
    else:
        c9_atom = state.c9
    a3 = a ** 3
    # per-atom c9/alpha^3 ratio for the harmonic-mean mixing rule
    ratio = torch.where(a3 == 0.0, 0.0,
                        c9_atom / torch.where(a3 == 0.0, 1.0, a3))
    inv_ratio = torch.where(ratio == 0.0, 0.0,
                            1.0 / torch.where(ratio == 0.0, 1.0, ratio))
    d = pt.dimg                   # d[i,j] = min-image (r_i - r_j)
    r = torch.where(pt.rimg == 0.0, 1.0, pt.rimg)
    A = state.n_atom_slots
    idx = _arange(A, a)
    mol = state.mol_id
    alive = state.atom_alive()
    c = max(1, _CHUNK_ELEMS // max(A * A, 1))
    total = torch.zeros((), dtype=torch.float64, device=a.device)
    for i0 in range(0, A, c):
        i = slice(i0, min(i0 + c, A))
        # mixed c9 of triple (i,j,k): (a3_i a3_j a3_k)^(1/3) * 3/(sum 1/ratio)
        geo = torch.abs(a3[i, None, None] * a3[None, :, None] *
                        a3[None, None, :]) ** (1.0 / 3.0)
        inv_sum = (inv_ratio[i, None, None] + inv_ratio[None, :, None] +
                   inv_ratio[None, None, :])
        c9 = torch.where(inv_sum == 0.0, 0.0,
                         geo * 3.0 / torch.where(inv_sum == 0.0, 1.0,
                                                 inv_sum))
        any_zero = ((a[i, None, None] == 0.0) | (a[None, :, None] == 0.0) |
                    (a[None, None, :] == 0.0))
        c9 = torch.where(any_zero, 0.0, c9) * C9_UNIT

        di = d[i]
        # dot products between the three triangle edges
        dot_ij_ik = torch.einsum("ija,ika->ijk", di, di)
        dot_ij_jk = torch.einsum("ija,jka->ijk", di, d)
        dot_ik_jk = torch.einsum("ika,jka->ijk", di, d)
        rij = r[i, :, None]
        rik = r[i, None, :]
        rjk = r[None, :, :]
        # cos(i)*cos(j)*cos(k) as the reference's a.b products:
        # (-ij.-ik)(ij.-jk)(ik.jk) / (rij^2 rik^2 rjk^2)
        cos_part = 3.0 * (dot_ij_ik * (-dot_ij_jk) * dot_ik_jk /
                          (rij ** 2 * rik ** 2 * rjk ** 2))
        pot = c9 * (1.0 + cos_part) / (rij * rik * rjk) ** 3

        ii = idx[i, None, None]
        distinct = ((ii != idx[None, :, None]) & (ii != idx[None, None, :]) &
                    (idx[None, :, None] != idx[None, None, :]))
        same_all = ((mol[i, None, None] == mol[None, :, None]) &
                    (mol[i, None, None] == mol[None, None, :]))
        alive3 = (alive[i, None, None] & alive[None, :, None] &
                  alive[None, None, :])
        mask = distinct & ~same_all & alive3
        total = total + torch.sum(torch.where(mask, pot, 0.0))
    return total / 6.0
