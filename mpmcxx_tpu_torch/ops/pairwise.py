"""Pair geometry, exclusion masks and LJ mixing on row windows.

JAX twin: mpmcxx_tpu/ops/pairwise.py.  Pair quantities are [R,A] tensors
of R contiguous row atoms against all A atoms: the [S,A] slice of one
molecule for incremental Delta-E (ops/delta.py), [B,A] row blocks of
the dense triangle for full energies of large systems, and the dense
[A,A] of all pairs for those of small ones.  ``pair_once`` marks each
physical pair exactly once in every layout.  ``mix_lj`` carries every
mixing rule of the twin (Lorentz-Berthelot, Waldman-Hagler, Halgren, C6,
the 9th-power and sigma repulsions, Buckingham and the dispersion
expansion's coefficients); the exclusion masks follow GWP's and
SPECTRE's rules.

Row windows start at a device index, so every row read is an
``index_select`` and every write an ``index_copy`` with a device index
tensor: nothing here waits on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import constants as const
from ..flags import FFlags
from ..pbc import _mul3, minimum_image_disp
from ..state import SystemState


@dataclasses.dataclass
class PairTensors:
    """Pair quantities; leading dim is the R row atoms."""

    dimg: torch.Tensor         # [R,A,3] minimum-image displacement r_i - r_j
    rimg: torch.Tensor         # [R,A] minimum-image distance
    r: torch.Tensor            # [R,A] real (unwrapped) distance
    pair_once: torch.Tensor    # [R,A] bool: count this pair here (and alive)
    alive: torch.Tensor        # [R,A] bool both atoms' molecules alive
    same_mol: torch.Tensor     # [R,A] bool
    frozen: torch.Tensor       # [R,A] bool frozen_i && frozen_j
    rd_excluded: torch.Tensor  # [R,A] bool
    es_excluded: torch.Tensor  # [R,A] bool
    sigma: torch.Tensor        # [R,A] mixed
    epsilon: torch.Tensor      # [R,A] mixed
    attractive_only: torch.Tensor  # [R,A] bool
    sigrep: torch.Tensor       # [R,A] (cdvdw_sig_repulsion)
    c6: torch.Tensor           # [R,A] mixed dispersion coeffs (K*Angstrom^n)
    c8: torch.Tensor
    c10: torch.Tensor
    rows: Optional[torch.Tensor] = None       # [R] atom indices (-1 pads),
                                              # None for the dense [A,A]
    row_start: Optional[torch.Tensor] = None  # window start (contiguous rows)

    def row(self, arr):
        """Slice a per-atom array onto the row axis."""
        if self.rows is None:
            return arr
        if self.row_start is not None:
            return slice_rows(arr, self.row_start, self.rows.shape[0])
        return arr[self.rows.clamp(0, arr.shape[0] - 1)]


def _arange(n: int, like: torch.Tensor):
    return torch.arange(n, dtype=torch.int64, device=like.device)


def window_start(rows, A: int):
    """Start of the contiguous row window: rows[k] == start + k for every
    valid (>= 0) entry; clipped so the window stays in bounds."""
    S = rows.shape[0]
    off = _arange(S, rows)
    start = torch.max(torch.where(rows >= 0, rows - off, -1))
    return start.clamp(0, max(A - S, 0))


def normalize_window(rows, A: int):
    """Re-index a contiguous-run row set into its clipped S-window:
    ``(start, rows_w, valid_w)`` with rows_w[k] == start + k and valid_w
    marking which window rows are real rows (pairwise.py:85-101)."""
    S = rows.shape[0]
    start = window_start(rows, A)
    if S == 1:
        return start, rows, rows >= 0
    arange = _arange(S, rows)
    first_valid = torch.min(torch.where(rows >= 0, rows, A))
    nvalid = torch.sum(rows >= 0)
    offset = first_valid - start
    valid_w = (arange >= offset) & (arange < offset + nvalid)
    return start, torch.where(valid_w, start + arange, -1), valid_w


def phase_dot(pos, k):
    """``pos[..., 3] @ k[K, 3].T``."""
    return _mul3(pos, k.T)


def sum_small_rows(w, m):
    """``w[S] @ m[S, ...]`` summed row by row in the JAX twin's order."""
    out = w[0] * m[0]
    for s in range(1, m.shape[0]):
        out = out + w[s] * m[s]
    return out


def contract_small_rows(f, q, d):
    """``einsum('sj,s,sjp->jp', f, q, d)`` for small static S."""
    out = (f[0] * q[0])[:, None] * d[0]
    for s in range(1, f.shape[0]):
        out = out + (f[s] * q[s])[:, None] * d[s]
    return out


def rows_field(f, qj, d):
    """``einsum('sj,j,sjp->sp', f, qj, d)``."""
    t = f * qj[None, :]
    return torch.sum(t[..., None] * d, dim=1)


def tile_starts(A: int, block: int):
    """Static tile starts covering [0,A) with in-bounds windows; the last
    tile shifts down to end exactly at A (its overlap rows recompute
    identical data)."""
    nb = -(-A // block)
    return [min(b * block, max(A - block, 0)) for b in range(nb)]


def assemble_tiles(tiles, A: int, block: int):
    """[nb, block, ...] tile stack -> [A, ...] honoring tile_starts."""
    nb = tiles.shape[0]
    flat = (nb * block,) + tuple(tiles.shape[2:])
    if nb * block == A:
        return tiles.reshape(flat)
    if A <= block:
        return tiles.reshape(flat)[:A]
    head = tiles[:-1].reshape(((nb - 1) * block,) + tuple(tiles.shape[2:]))
    tail = tiles[-1][block - (A - (nb - 1) * block):]
    return torch.cat([head, tail], dim=0)


def slice_rows(arr, start, S: int):
    """Contiguous S-row slice along axis 0 from a device start index."""
    return arr.index_select(0, start + _arange(S, arr))


def update_rows(arr, start, block, valid=None):
    """``arr`` with a contiguous row block written at ``start`` (a new
    tensor, as in the JAX twin); ``valid`` masks rows that keep their
    current contents."""
    S = block.shape[0]
    if S > arr.shape[0]:
        raise ValueError(f"{S}-row window on a {arr.shape[0]}-row array")
    idx = start + _arange(S, arr)
    if valid is not None:
        vm = valid.reshape((S,) + (1,) * (arr.dim() - 1))
        block = torch.where(vm, block, arr.index_select(0, idx))
    return arr.index_copy(0, idx, block.to(arr.dtype))


def mix_lj(flags: FFlags, eps_i, eps_j, sig_i, sig_j, w_i, w_j, a_i, a_j,
           c6_i, c6_j, c8_i, c8_j, c10_i, c10_j):
    """LJ/Buckingham mixing rules (src/System.cpp:1070-1177;
    pairwise.py:191-291).  Inputs broadcast; returns (sigma, epsilon,
    attractive_only, sigrep, c6, c8, c10)."""
    zero = torch.zeros(torch.broadcast_shapes(eps_i.shape, eps_j.shape),
                       dtype=eps_i.dtype, device=eps_i.device)
    sigrep, c6m, c8m, c10m = zero, zero, zero, zero
    attractive_only = (sig_i < 0.0) | (sig_j < 0.0)

    def nz(x):
        return torch.where(x == 0.0, 1.0, x)

    if flags.use_sg:
        return zero, zero, attractive_only, sigrep, c6m, c8m, c10m

    if flags.waldmanhagler and not flags.cdvdw_sig_repulsion:
        si3, sj3 = sig_i ** 3, sig_j ** 3
        si6, sj6 = si3 * si3, sj3 * sj3
        sig_zero = (sig_i == 0.0) | (sig_j == 0.0)
        sigma = torch.where(sig_zero & ~attractive_only, 0.0,
                            (0.5 * (si6 + sj6)) ** (1.0 / 6.0))
        eps_wh = torch.sqrt(eps_i * eps_j) * 2.0 * si3 * sj3 / nz(si6 + sj6)
        epsilon = torch.where(sig_zero, torch.sqrt(eps_i * eps_j), eps_wh)
        # reference quirk: the attractive-only branch never assigns
        # epsilon (src/System.cpp:1081-1083), so such pairs keep 0
        epsilon = torch.where(attractive_only & ~sig_zero, 0.0, epsilon)
    elif flags.halgren_mixing:
        s2 = sig_i * sig_i + sig_j * sig_j
        sigma = torch.where((sig_i > 0) & (sig_j > 0),
                            (sig_i ** 3 + sig_j ** 3) / nz(s2), 0.0)
        se = torch.sqrt(eps_i) + torch.sqrt(eps_j)
        epsilon = torch.where((eps_i > 0) & (eps_j > 0),
                              4 * eps_i * eps_j / torch.where(
                                  se == 0, 1.0, se ** 2), 0.0)
    elif flags.cdvdw_9th_repulsion:
        si6, sj6 = sig_i ** 6, sig_j ** 6
        repul1 = 4.0 * si6 * si6 * eps_i
        repul2 = 4.0 * sj6 * sj6 * eps_j
        repulmix = (0.5 * (repul1 ** (1. / 9.) + repul2 ** (1. / 9.))) ** 9
        sigma = torch.ones_like(zero)
        epsilon = repulmix / 4.0
    elif flags.cdvdw_sig_repulsion:
        sigma = (0.5 * (sig_i ** 6 + sig_j ** 6)) ** (1. / 6.)
        sigrep = (1.5 * const.hBar / const.kB * const.au2invseconds *
                  w_i * w_j * a_i * a_j / nz(w_i + w_j) / nz(sigma ** 6))
        epsilon = torch.sqrt(eps_i * eps_j)
    elif flags.cdvdw_exp_repulsion:
        # Buckingham: sigma == C, epsilon == rho; U = C exp(-R/(2 rho))
        esum = eps_i + eps_j
        sigma = (torch.abs(sig_i) ** eps_i * torch.abs(sig_j) ** eps_j) ** (
            1.0 / nz(esum))
        epsilon = 0.5 * esum
    elif flags.using_disp_expansion:
        # sigma == r, epsilon == alpha; U = C exp(-alpha(R-r)), C ~= 316 K
        sigma = 0.5 * (sig_i + sig_j)
        esum = eps_i + eps_j
        epsilon = 2.0 * eps_i * eps_j / nz(esum)
        if flags.schmidt_ff:
            epsilon = esum * eps_i * eps_j / nz(eps_i * eps_i + eps_j * eps_j)
        # a.u. -> K*Angstrom^n conversions (src/System.cpp:1149-1157)
        c6m = torch.sqrt(c6_i * c6_j) * 0.021958709 / (3.166811429e-6)
        c8m = torch.sqrt(c8_i * c8_j) * 0.0061490647 / (3.166811429e-6)
        if flags.extrapolate_disp_coeffs:
            # reference quirk: 0 where either coefficient is 0
            c10m = torch.where((c6m != 0.0) & (c8m != 0.0),
                               49.0 / 40.0 * c8m * c8m / nz(c6m), 0.0)
        else:
            c10m = torch.sqrt(c10_i * c10_j) * 0.0017219135 / (3.166811429e-6)
    elif flags.c6_mixing:
        sigma = 0.5 * (sig_i + sig_j)
        epsilon = torch.where(
            sigma != 0.0,
            64.0 * torch.sqrt(eps_i * eps_j) * (sig_i ** 3) * (sig_j ** 3) /
            nz((sig_i + sig_j) ** 6), 0.0)
    else:  # Lorentz-Berthelot (src/System.cpp:1166-1177)
        sig_zero = (sig_i == 0.0) | (sig_j == 0.0)
        sigma = torch.where(attractive_only,
                            0.5 * (torch.abs(sig_i) + torch.abs(sig_j)),
                            torch.where(sig_zero, 0.0, 0.5 * (sig_i + sig_j)))
        # same quirk as WH: epsilon unassigned (-> 0) for attractive-only
        # pairs (src/System.cpp:1167-1169)
        epsilon = torch.where(attractive_only, 0.0, torch.sqrt(eps_i * eps_j))
    return sigma, epsilon, attractive_only, sigrep, c6m, c8m, c10m


def _build(state: SystemState, flags: FFlags, rows,
           block_global: bool = False) -> PairTensors:
    A = state.n_atom_slots
    if rows is None:
        g = lambda arr: arr
        row_valid = torch.ones(A, dtype=torch.bool, device=state.pos.device)
        row_start = None
    elif rows.shape[0] > A:
        # window wider than the array: clip-gather semantics
        safe_g = rows.clamp(0, A - 1)
        g = lambda arr: arr[safe_g]
        row_valid = rows >= 0
        row_start = None
    else:
        S = rows.shape[0]
        row_start, rows, row_valid = normalize_window(rows, A)
        g = lambda arr: slice_rows(arr, row_start, S)
    pos_r = g(state.pos)

    d = pos_r[:, None, :] - state.pos[None, :, :]
    dimg, rimg = minimum_image_disp(d, state.pbc.basis, state.pbc.reciprocal)
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    # NaN-guard mirror of src/System.cpp:1265-1270: bad image -> use real
    bad = ~torch.isfinite(rimg)
    rimg = torch.where(bad, r, rimg)
    dimg = torch.where(bad[..., None], d, dimg)

    atom_alive = state.atom_alive()
    alive = (g(atom_alive) & row_valid)[:, None] & atom_alive[None, :]
    same_mol = g(state.mol_id)[:, None] == state.mol_id[None, :]
    frozen = g(state.frozen)[:, None] & state.frozen[None, :]

    eps_i, eps_j = g(state.epsilon)[:, None], state.epsilon[None, :]
    sig_i, sig_j = g(state.sigma)[:, None], state.sigma[None, :]
    c6_i, c6_j = g(state.c6)[:, None], state.c6[None, :]
    c8_i, c8_j = g(state.c8)[:, None], state.c8[None, :]
    c10_i, c10_j = g(state.c10)[:, None], state.c10[None, :]

    # exclusions (src/System.cpp:1042-1064); under GWP a molecule's own
    # pairs are not excluded for being its own
    lj_null = (eps_i == 0.0) | (sig_i == 0.0) | (eps_j == 0.0) | (sig_j == 0.0)
    cn_null = ((c6_i == 0.0) & (c8_i == 0.0) & (c10_i == 0.0) &
               (c6_j == 0.0) & (c8_j == 0.0) & (c10_j == 0.0))
    own = torch.zeros_like(same_mol) if flags.gwp else same_mol
    rd_excluded = own | (lj_null & cn_null)
    q_i, q_j = g(state.charge)[:, None], state.charge[None, :]
    es_excluded = own | (q_i == 0.0) | (q_j == 0.0)
    if flags.spectre:
        # SPECTRE overrides (src/System.cpp:1181-1194; pairwise.py:
        # 351-357): two SPECTRE sites interact by repulsion only, a
        # SPECTRE site and another atom by charge only
        sp_i, sp_j = g(state.spectre)[:, None], state.spectre[None, :]
        both, one = sp_i & sp_j, sp_i ^ sp_j
        rd_excluded = torch.where(both, False, rd_excluded | one)
        es_excluded = torch.where(both, True, es_excluded & ~one)

    sigma, epsilon, attractive_only, sigrep, c6m, c8m, c10m = mix_lj(
        flags, eps_i, eps_j, sig_i, sig_j,
        g(state.omega)[:, None], state.omega[None, :],
        g(state.polarizability)[:, None], state.polarizability[None, :],
        c6_i, c6_j, c8_i, c8_j, c10_i, c10_j)

    col = _arange(A, state.pos)[None, :]
    upper = col > (col.T if rows is None else rows.clamp(0, A - 1)[:, None])
    if rows is None:
        pair_once = upper & alive
    elif block_global:
        # tile of the dense triangle: global col > row rule, so summing
        # over a block partition of all atoms counts each pair once
        pair_once = row_valid[:, None] & alive & upper
    else:
        # count each pair touching the row molecule exactly once: rows vs
        # other molecules always; intra-molecular only for col > row
        pair_once = row_valid[:, None] & alive & (~same_mol | upper)

    return PairTensors(
        dimg=dimg, rimg=rimg, r=r,
        pair_once=pair_once, alive=alive, same_mol=same_mol, frozen=frozen,
        rd_excluded=rd_excluded, es_excluded=es_excluded,
        sigma=sigma, epsilon=epsilon, attractive_only=attractive_only,
        sigrep=sigrep, c6=c6m, c8=c8m, c10=c10m,
        rows=rows, row_start=row_start)


def build_pairs(state: SystemState, flags: FFlags) -> PairTensors:
    """Dense [A,A] pair tensors for the full-energy path of small systems
    (pairwise.py:385-387)."""
    return _build(state, flags, None)


def build_pairs_rect(state: SystemState, flags: FFlags,
                     rows) -> PairTensors:
    """[S,A] pair tensors for the atoms in ``rows`` (padded with -1)
    against all atoms — the Delta-E slice."""
    return _build(state, flags, rows)


def build_pairs_block(state: SystemState, flags: FFlags,
                      rows) -> PairTensors:
    """[B,A] tile of the dense upper triangle: summing any block partition
    of the atom axis visits every pair exactly once."""
    return _build(state, flags, rows, block_global=True)
