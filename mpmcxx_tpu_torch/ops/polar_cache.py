"""Incrementally maintained polarization state for the MC chain.

JAX twin: mpmcxx_tpu/ops/polar_cache.py, every plane mode and static
field.  The mu-independent work of the reference's per-step
repolarization (src/System.Energy.cpp:93-116) lives in a cache that a
local move updates in O(S*A) (S = atoms of the moved molecule):

- the f32 contraction planes of ops.polar.fold_outer_rows
  (``planes_of``): three masked displacement planes ``dx``/``dy``/``dz``
  under exponential damping (mode 3; the damped coefficients are
  recomputed inside the contraction kernel), ``cd`` and the folded
  ``s = sqrt(-co) d`` in ``dx``/``dy``/``dz`` under linear or no damping
  (mode 4), and ``co``, ``cd`` and the masked displacements under
  polar_wolf_full (mode 5).  Rows are exact; columns follow by symmetry
  (``co``, ``cd``) or antisymmetry (the displacement planes), so the
  planes stay bitwise those of a full rebuild.
- ``e_pair``: the pairwise static field (Ewald real space, Wolf or
  no-PBC), f64.
- ``cosp``/``sinp``/``f1``/``f2``: per-atom k-space phases (f32) and
  charge structure factors (f64) for the reciprocal static field
  (src/System.Energy.cpp:2834-2896) in O(A*K) f32 work; empty (K = 0)
  without polar_ewald.

A proposal (``polar_proposal``) reads the cache only; the commit
(``cache_commit``) writes the planes and phases IN PLACE, where the JAX
twin returned new arrays: one launch of kernel K2 commits all 3, 4 or 5
planes.

On a mesh (``cache_init(..., mesh=)``, parallel/meshing.py) the planes
are meshing.RowShards: each shard builds, contracts and commits its own
[A/n, A] rows on its device (n K1 launches per contraction, n K2
launches per commit); the window rows a proposal reads come from the one
or two shards that hold them.  The [A, 3] and [A, K] leaves stay on the
leader.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import torch

from .. import constants as const
from ..flags import FFlags, RunParams, dense_only
from ..parallel import meshing
from ..parallel.meshing import RowShards
from ..state import SystemState
from . import cuda_polar
from . import polar as polar_mod
from .ewald import kvectors
from .pairwise import (_arange, assemble_tiles, build_pairs_rect,
                       contract_small_rows, normalize_window, phase_dot,
                       rows_field, slice_rows, sum_small_rows, tile_starts,
                       update_rows)


@dataclasses.dataclass
class PolarCache:
    co: torch.Tensor      # [A,A] f32 c_outer (mode 5), else a [0,0]
    #                       placeholder (folded or recomputed)
    cd: torch.Tensor      # [A,A] f32 c_diag (modes 4, 5), else [0,0]
    dx: torch.Tensor      # [A,A] f32 masked minimum-image displacement
    dy: torch.Tensor      #  planes (modes 3 and 5) or s = sqrt(-co) d
    dz: torch.Tensor      #  (mode 4); antisymmetric
    e_pair: torch.Tensor  # [A,3] f64 pairwise static field
    cosp: torch.Tensor    # [A,K] f32 cos(k.r_i)  (K = 0 without polar_ewald)
    sinp: torch.Tensor    # [A,K] f32 sin(k.r_i)
    f1: torch.Tensor      # [K] f64 sum_j q_j cos(k.r_j)
    f2: torch.Tensor      # [K] f64 sum_j q_j sin(k.r_j)


def empty_cache(device="cuda") -> PolarCache:
    """A cache with every field empty (polar_cache.py:70-73) on ``device``
    (the card unless the caller asks for another): [0, 0] planes and
    phases, a [0, 3] static field, [0] structure factors."""
    z2 = torch.zeros((0, 0), dtype=torch.float32, device=device)
    f = torch.zeros(0, dtype=torch.float64, device=device)
    return PolarCache(z2, z2.clone(), z2.clone(), z2.clone(), z2.clone(),
                      torch.zeros((0, 3), dtype=torch.float64, device=device),
                      z2.clone(), z2.clone(), f, f.clone())


def planes_of(cache: PolarCache):
    """The cache's contraction planes in contract_mixed form
    (polar_cache.py:76-85): (dx, dy, dz), (cd, sx, sy, sz) or
    (co, cd, dx, dy, dz)."""
    return tuple(p for p in (cache.co, cache.cd, cache.dx, cache.dy,
                             cache.dz) if p.numel())


def plane_signs(n_planes: int):
    """Each plane's symmetry under (i, j) -> (j, i), in planes_of order:
    +1 for co and cd, -1 for the displacement planes."""
    return (1.0,) * (n_planes - 3) + (-1.0,) * 3


# Slot bound of the CPU path: the JAX twin's cap (polar_cache.py:92-104).
CPU_MAX_SLOTS = 16384
# Device-memory budget of the caches on a GPU: a corrtime refresh holds the
# carry's old planes, cache_init's tile stack and the assembled new planes
# at once (3 copies of 4 A^2 bytes per plane), beside the resident planes
# of the other replicas' caches (they refresh one after the other), and
# that peak stays within this share of the card's memory, leaving the
# rest to the blocked energy, the proposal's [S,A] rows and the allocator.
PLANE_COPIES_AT_PEAK = 3
DEVICE_MEMORY_SHARE = 0.6


def max_slots(device=None, n_planes: int = 3, n_caches: int = 1,
              mesh=None) -> int:
    """Largest atom-slot count at which ``n_caches`` resident caches of
    ``n_planes`` f32 [A,A] planes each (plane_mode: 3, 4 or 5), one of
    them refreshing, fit ``device``: (n_caches + PLANE_COPIES_AT_PEAK - 1)
    n_planes 4 A^2 bytes within DEVICE_MEMORY_SHARE of its memory.  On a
    ``mesh`` the planes are row-sharded and each card holds the rows of
    its shards: the budget is that of the card holding the most (4 shards
    on one card: the one-card cap).  The CPU's cap is the twin's for
    every ``n_caches``."""
    if mesh is not None:
        dev, k = collections.Counter(mesh.devices).most_common(1)[0]
        if dev.type != "cuda":
            return CPU_MAX_SLOTS
        return int(max_slots(dev, n_planes, n_caches) *
                   (mesh.size / k) ** 0.5)
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return CPU_MAX_SLOTS
    total = torch.cuda.get_device_properties(dev).total_memory
    copies = n_caches + PLANE_COPIES_AT_PEAK - 1
    plane_bytes = n_planes * 4 * copies                     # per A^2
    return int((DEVICE_MEMORY_SHARE * total / plane_bytes) ** 0.5)


def supports(flags: FFlags, n_atom_slots: int = 0, device=None,
             n_caches: int = 1, mesh=None) -> bool:
    """True when polarization can ride the incremental cache with
    ``n_atom_slots`` slots on ``device`` (or row-sharded over ``mesh``)
    beside ``n_caches`` - 1 other replicas' caches (the mode's f32 [A,A]
    planes; see max_slots).  flags.dense_only holds polar_ewald_full,
    whose SCF couples the dipoles through k-space and has no row-local
    update."""
    # under use_sg or rd_only the full energy has no polarization
    # (energy.py:62), which the twin's cache would still carry
    ok = (flags.polarization and flags.polar_mixed and
          not (flags.use_sg or flags.rd_only) and
          not dense_only(flags))
    mode = polar_mod.plane_mode(flags)
    cap = max_slots(device, mode, n_caches) if mesh is None else \
        max_slots(device, mode, n_caches, mesh=mesh)
    if n_atom_slots and n_atom_slots > cap:
        return False
    return ok


def _empty_kspace(A: int, device):
    """The K = 0 phases and structure factors of a cache without
    polar_ewald (polar_cache.py:151-155)."""
    z = torch.zeros((A, 0), dtype=torch.float32, device=device)
    f = torch.zeros(0, dtype=torch.float64, device=device)
    return z, z.clone(), f, f.clone()


def plane_rows(state: SystemState, flags: FFlags, params: RunParams,
               row0: int, R: int, block: int = 128):
    """Rows row0 .. row0+R-1 of the cache's planes (in fold_outer_rows
    form, each [R, A] f32) and of the pairwise static field ([R, 3] f64),
    built in [min(block, R), A] row tiles on the state's device (the tiles
    of tile_starts(R, block), shifted by row0).  No tile is padded: a
    padded window that ends past A would be shifted into bounds by the
    row normalisation (pairwise.window_start)."""
    dev = state.pos.device
    block = min(block, R)
    planes, fields = [], []
    for s0 in tile_starts(R, block):
        rows = row0 + s0 + torch.arange(block, device=dev)
        pt = build_pairs_rect(state, flags, rows)
        co, cd = polar_mod.mixed_coeff_scalars(state, pt, flags, params)
        f = polar_mod.field_scalars(state, pt, flags, params)
        fields.append(rows_field(f, state.charge, pt.dimg))
        d32 = pt.dimg.to(torch.float32)
        planes.append(polar_mod.fold_outer_rows(
            co, cd, d32[..., 0], d32[..., 1], d32[..., 2], flags))
    planes = [assemble_tiles(torch.stack(p), R, block).contiguous()
              for p in zip(*planes)]
    return planes, assemble_tiles(torch.stack(fields), R, block)


def sharded_rows(state: SystemState, flags: FFlags, params: RunParams,
                 mesh, ranges, block: int = 128):
    """``plane_rows`` of each shard's row range ``ranges[d] = (row0, R)``,
    built on its device from a copy of the state there: the planes as
    meshing.RowShards and the static field's rows stacked on the
    leader."""
    parts, fields = [], []
    for (r0, R), dev in zip(ranges, mesh.devices):
        with meshing.device_guard(dev):
            planes, e = plane_rows(meshing.to_device(state, dev), flags,
                                   params, r0, R, block)
        parts.append(planes)
        fields.append(e)
    planes = [RowShards(tuple(p), tuple(r0 for r0, _ in ranges), mesh)
              for p in zip(*parts)]
    return planes, meshing.gather_rows(fields, mesh)


def cache_init(state: SystemState, flags: FFlags, params: RunParams,
               block: int = 128, mesh=None) -> PolarCache:
    """Full O(A^2) build (chain start and every refresh;
    polar_cache.py:108-156).  With ``mesh`` each shard builds its even
    row range on its device (the planes are meshing.RowShards; the whole
    planes are never built)."""
    A = state.n_atom_slots
    if mesh is None:
        planes, e = plane_rows(state, flags, params, 0, A, block)
    else:
        planes, e = sharded_rows(state, flags, params, mesh,
                                 meshing.even_rows(A, mesh.size), block)
    z0 = torch.zeros((0, 0), dtype=torch.float32, device=state.pos.device)
    planes = [z0, z0.clone()][:5 - len(planes)] + planes

    if flags.polar_ewald:
        k, _ = kvectors(state, flags.ewald_kmax)
        phase = phase_dot(state.pos, k)               # [A,K]
        cos64, sin64 = torch.cos(phase), torch.sin(phase)
        q = torch.where(state.atom_alive(), state.charge, 0.0)
        kspace = (cos64.to(torch.float32), sin64.to(torch.float32),
                  q @ cos64, q @ sin64)
    else:
        kspace = _empty_kspace(A, state.pos.device)
    return PolarCache(*planes, e, *kspace)


def _kweight(state: SystemState, flags: FFlags, params: RunParams):
    ea = params.polar_ewald_alpha
    k, k2 = kvectors(state, flags.ewald_kmax)
    return k, k / k2[:, None] * torch.exp(-k2 / (4.0 * ea * ea))[:, None]


def recip_field(state: SystemState, flags: FFlags, params: RunParams,
                cache: PolarCache):
    """k-space static field from the cached phases — the f32 cut of
    ops.polar.recip_term.  The matmul is full f32 (TF32 is off package
    wide), as the twin's Precision.HIGHEST."""
    _, kw = _kweight(state, flags, params)
    coeff = (cache.sinp * cache.f1.to(torch.float32)[None, :] -
             cache.cosp * cache.f2.to(torch.float32)[None, :])
    E = (coeff @ kw.to(torch.float32)).to(torch.float64)
    return E * 8.0 * const.pi / state.pbc.volume


def static_field(state: SystemState, flags: FFlags, params: RunParams,
                 cache: PolarCache):
    """The cached static field, k-space only under polar_ewald
    (polar_cache.py:173-178)."""
    E = cache.e_pair
    if flags.polar_ewald:
        E = E + recip_field(state, flags, params, cache)
    return torch.where(state.atom_alive()[:, None], E, 0.0)


def window_rows(plane, start, S: int):
    """Rows start..start+S-1 of a plane, whole or row-sharded (from the
    one or two shards that hold them), as [S, A] on the leader."""
    if isinstance(plane, RowShards):
        return plane.window_rows(start, S)
    return slice_rows(plane, start, S)


def write_symmetric_rows(planes, rows_planes, start, valid, sign):
    """Commit an S-row update window into symmetric (sign=+1) or
    antisymmetric (sign=-1) [A,A] planes, in place: the row strip directly
    and the matching column strip via ``plane[:, start+s] == sign *
    plane[start+s, :]`` (polar_cache.py:181-224).  ``sign`` is one float
    for every plane or one per plane.  Rows whose ``valid`` entry is False
    re-write their current content.  Kernel K2 (or, for CPU tensors, its
    plain version) scatters the strips of ``commit_strips`` on every plane
    in one launch; on row-sharded planes one launch per shard writes the
    strips' share of its rows, on its device."""
    blend, cols = commit_strips(planes, rows_planes, start, valid, sign)
    if not isinstance(planes[0], RowShards):
        cuda_polar.write_plane_strips(tuple(planes), blend, cols, start)
        return
    for d, dev in enumerate(planes[0].mesh.devices):
        with meshing.device_guard(dev):
            cuda_polar.write_plane_strips(
                tuple(p.parts[d] for p in planes), blend.to(dev),
                cols.to(dev), start.to(dev), row0=planes[0].row0s[d])


def commit_strips(planes, rows_planes, start, valid, sign):
    """The ([P,S,A] row strip, [P,S,A] column strip) values of
    write_symmetric_rows, computed exactly as the twin does
    (polar_cache.py:196-213); ``sign`` is one float or one per plane."""
    S = rows_planes[0].shape[0]
    signs = (sign,) * len(planes) if isinstance(sign, float) else sign
    idx = start + _arange(S, start)
    cur = torch.stack([window_rows(p, start, S) for p in planes])  # [P,S,A]
    vm = valid[None, :, None]
    blend = torch.where(vm, torch.stack(rows_planes), cur)
    # column start+s: sign*blend[s] where the column is valid, else its
    # current content == sign*cur[s] away from the window, with the window
    # rows patched to the row-write values
    colv = torch.where(vm, blend, cur)
    colv = torch.stack([sg * c for sg, c in zip(signs, colv)])
    win_cur = blend.index_select(2, idx).transpose(1, 2)   # [P,s,t]
    win_val = colv.index_select(2, idx)                    # [P,s,t]
    patch = torch.where(vm, win_val, win_cur)
    return blend.contiguous(), colv.index_copy(2, idx, patch).contiguous()


class CommitData(NamedTuple):
    """What ``cache_commit`` needs for an accepted move, captured from
    ``polar_proposal``'s own intermediates (no geometry re-run)."""
    start: torch.Tensor    # window start (0-d int64)
    valid: torch.Tensor    # [S] bool
    e_pair: torch.Tensor   # [A,3] f64 pairwise static field (no recip)
    rows: tuple            # [S,A] f32 row blocks in planes_of order;
                           # invalid rows zeroed
    f1: torch.Tensor       # [K] f64 updated structure factors
    f2: torch.Tensor
    cosp: torch.Tensor     # [S,K] f64 new-row phases
    sinp: torch.Tensor


def polar_proposal(cache: PolarCache, old_state: SystemState,
                   new_state: SystemState, rows, flags: FFlags,
                   params: RunParams, with_commit: bool = False):
    """Polarization energy of a PROPOSED move without materialising an
    updated cache (polar_cache.py:352-506): each SCF iteration (or CG
    step, or Palmo contraction) contracts the unmodified planes (kernel
    K5, K4 or K1, ops.polar.contract_mixed) and applies O(S*A) row/column
    corrections.  With ``with_commit`` returns
    ``(PolarResult, CommitData)``."""
    A = old_state.n_atom_slots
    S = rows.shape[0]
    start, rows, valid = normalize_window(rows, A)

    def rows_of(arr):
        return slice_rows(arr, start, S)

    in_R = update_rows(torch.zeros(A, dtype=torch.bool, device=rows.device),
                       start, valid)
    pt_old = build_pairs_rect(old_state, flags, rows)
    pt_new = build_pairs_rect(new_state, flags, rows)

    # --- proposal's static field ------------------------------------------
    f_old = polar_mod.field_scalars(old_state, pt_old, flags, params)
    f_new = polar_mod.field_scalars(new_state, pt_new, flags, params)
    q_ro = torch.where(valid, rows_of(old_state.charge), 0.0)
    q_rn = torch.where(valid, rows_of(new_state.charge), 0.0)
    C_old = -contract_small_rows(f_old, q_ro, pt_old.dimg)
    C_new = -contract_small_rows(f_new, q_rn, pt_new.dimg)
    e = cache.e_pair + (C_new - C_old)
    E_rows = rows_field(f_new, new_state.charge, pt_new.dimg)
    e = update_rows(e, start, E_rows, valid)
    e_pair_new = e

    if flags.polar_ewald:
        k, kw = _kweight(new_state, flags, params)
        ph_old = phase_dot(rows_of(old_state.pos), k)
        ph_new = phase_dot(rows_of(new_state.pos), k)
        cos_o, sin_o = torch.cos(ph_old), torch.sin(ph_old)
        cos_n, sin_n = torch.cos(ph_new), torch.sin(ph_new)
        qo = torch.where(valid & rows_of(old_state.atom_alive()),
                         rows_of(old_state.charge), 0.0)
        qn = torch.where(valid & rows_of(new_state.atom_alive()),
                         rows_of(new_state.charge), 0.0)
        f1 = cache.f1 - sum_small_rows(qo, cos_o) + sum_small_rows(qn, cos_n)
        f2 = cache.f2 - sum_small_rows(qo, sin_o) + sum_small_rows(qn, sin_n)
        coeff = (cache.sinp * f1.to(torch.float32)[None, :] -
                 cache.cosp * f2.to(torch.float32)[None, :])
        E_recip = (coeff @ kw.to(torch.float32)).to(torch.float64)
        # the moved rows' phases changed: fix their recip field directly
        row_coeff = sin_n * f1[None, :] - cos_n * f2[None, :]
        E_recip = update_rows(
            E_recip, start, torch.sum(row_coeff[..., None] * kw[None], dim=1),
            valid)
        e = e + E_recip * 8.0 * const.pi / new_state.pbc.volume
    else:
        f1, f2 = cache.f1, cache.f2
        cos_n = torch.zeros((S, 0), dtype=torch.float64, device=e.device)
        sin_n = cos_n
    E_static = torch.where(new_state.atom_alive()[:, None], e, 0.0)

    # --- row blocks, new (from geometry) and old (gathered from cache) ---
    co_n, cd_n = polar_mod.mixed_coeff_scalars(new_state, pt_new, flags,
                                               params)
    d_n = pt_new.dimg.to(torch.float32)
    vm = valid[:, None]
    rows_new = tuple(torch.where(vm, p, 0.0) for p in
                     polar_mod.fold_outer_rows(co_n, cd_n, d_n[..., 0],
                                               d_n[..., 1], d_n[..., 2],
                                               flags))
    rows_old = tuple(torch.where(vm, window_rows(p, start, S), 0.0)
                     for p in planes_of(cache))
    l = params.polar_damp
    # (co, cd, dx, dy, dz) of both row blocks (co None in mode 4: the
    # outer coefficient is folded into s); mu-independent, so expanded
    # once for all contractions
    new_b = polar_mod.expand_planes(rows_new, l)
    old_b = polar_mod.expand_planes(rows_old, l)

    def contract_fn(m):
        base = polar_mod.contract_mixed(planes_of(cache), m, l=l)
        m32 = m.to(torch.float32)
        mu_r = torch.where(vm, rows_of(m32), 0.0)              # [S,3]
        # the field -T mu the row atoms source at every atom (column sums;
        # the row blocks serve directly, T symmetric), new less old
        col_corr = (-polar_mod.plane_sums(new_b, mu_r, 0).to(torch.float64) -
                    -polar_mod.plane_sums(old_b, mu_r, 0).to(torch.float64))
        # pairs with i in R belong to the wholesale row replacement below
        ef = base + torch.where(in_R[:, None], 0.0, col_corr)
        # the field -T mu at the row atoms from everyone (row sums)
        row_ef = -polar_mod.plane_sums(new_b, m32, 1).to(torch.float64)
        return update_rows(ef, start, row_ef, valid)

    res = polar_mod.finish_polar(new_state, flags, params, E_static,
                                 contract_fn)
    if not with_commit:
        return res
    return res, CommitData(start=start, valid=valid, e_pair=e_pair_new,
                           rows=rows_new, f1=f1, f2=f2, cosp=cos_n,
                           sinp=sin_n)


def cache_commit(cache: PolarCache, accept, cdata: CommitData,
                 flags: FFlags) -> PolarCache:
    """Commit a proposal's CommitData into the cache IN PLACE (the twin
    returned a new cache; polar_cache.py:509-549).  On reject every write
    re-writes current content, so the commit runs unconditionally after
    the Metropolis decision and the step never branches on the host.  One
    K2 launch writes every plane, co and cd symmetric (+1), the
    displacement planes antisymmetric (-1)."""
    S = cdata.valid.shape[0]
    start = cdata.start
    ok = accept & cdata.valid                      # [S]
    cache.e_pair = torch.where(accept, cdata.e_pair, cache.e_pair)
    planes = planes_of(cache)
    write_symmetric_rows(planes, cdata.rows, start, ok,
                         plane_signs(len(planes)))
    if flags.polar_ewald:
        cache.f1 = torch.where(accept, cdata.f1, cache.f1)
        cache.f2 = torch.where(accept, cdata.f2, cache.f2)
        idx = start + _arange(S, start)
        for plane, vals in ((cache.cosp, cdata.cosp),
                            (cache.sinp, cdata.sinp)):
            blend = torch.where(ok[:, None], vals.to(torch.float32),
                                plane.index_select(0, idx))
            plane.index_copy_(0, idx, blend)
    return cache


def polar_from_cache(state: SystemState, cache: PolarCache, flags: FFlags,
                     params: RunParams) -> polar_mod.PolarResult:
    """Polarization energy with all mu-independent work cached: the same
    SCF as ops.polar.polar_blocked, minus the O(A^2) setup
    (polar_cache.py:552-563)."""
    E_static = static_field(state, flags, params, cache)
    planes = planes_of(cache)
    return polar_mod.finish_polar(
        state, flags, params, E_static,
        lambda m: polar_mod.contract_mixed(planes, m, l=params.polar_damp))
