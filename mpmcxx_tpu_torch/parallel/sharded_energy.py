"""Mesh-sharded full energy: the O(A^2) pair work split over devices.

JAX twin: mpmcxx_tpu/parallel/sharded_energy.py.  Each shard owns a
contiguous slice of pair-tensor ROWS, padded so that every shard gets
the same number of ``block``-row tiles (``_row_slices``, the twin's row
sets), loops over its tiles of rd and Ewald real space (or Wolf) and the
cavity penalty on its device, and the partial sums are added on the
leader in shard order (meshing.psum).

Polarization shards the same way: each shard builds the f32 coefficient
planes of its own rows ([R_d, A], ops.polar_cache.plane_rows) on its
device, and every SCF iteration contracts them shard by shard (one K1
launch per shard, ops.polar.contract_rows) with the [R_d, 3] field rows
gathered on the leader.  No shard holds the whole planes.  The long-range
correction, k-space, the self term and the many-body terms (polarvdw,
Axilrod-Teller: an eigendecomposition and an O(N^3) triple sum, dense and
replicated in the twin) are computed once on the leader.
"""

from __future__ import annotations

import torch

from ..flags import FFlags, RunParams
from ..ops import ewald, pair_potentials, polar_cache
from ..ops import polar as polar_mod
from ..ops.energy import EnergyBreakdown, _close_pairs, _penalty
from ..ops.pairwise import build_pairs, build_pairs_block
from ..state import SystemState
from . import meshing


def _row_slices(A: int, n_dev: int, block: int) -> list:
    """Each shard's global row ids, padded so that every shard gets equal
    contiguous work (sharded_energy.py:52-57); -1 marks padding."""
    per_dev = -(-A // n_dev)
    per_dev = -(-per_dev // block) * block
    ids = torch.arange(n_dev * per_dev)
    return list(torch.where(ids < A, ids, -1).reshape(n_dev, per_dev))


def sharded_breakdown(state: SystemState, flags: FFlags, params: RunParams,
                      mesh: meshing.Mesh, axis: str | None = None,
                      block: int = 256) -> EnergyBreakdown:
    """energy_breakdown_blocked with the row loop sharded over ``mesh``
    (sharded_energy.py:60-247); ``state`` lives on the leader, the result
    too.  ``axis``, when given, must be the mesh's axis."""
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"sharded_breakdown: the mesh's axis is "
                         f"{mesh.axis!r}, not {axis!r}")
    if flags.rd_crystal or flags.gwp or flags.spectre or flags.rd_anharmonic:
        raise ValueError(
            "sharded energy: rd_crystal / gwp / spectre / rd_anharmonic "
            "run single-chip only (dense energy_breakdown)")
    if flags.polarization and not flags.polar_mixed:
        raise ValueError("sharded polarization runs on the mixed-precision "
                         "planes; set polar_mixed")
    if (flags.polarvdw or flags.using_axilrod_teller) and \
            state.n_atom_slots > 4096:
        raise ValueError(
            "sharded polarvdw/Axilrod-Teller replicate dense [A,A(,3,3)] "
            "tensors per device; capped at 4096 atom slots "
            f"(got {state.n_atom_slots})")
    if (flags.polarization and flags.polar_ewald_full) or \
            (flags.using_disp_expansion and flags.disp_expansion_mbvdw):
        # flags.dense_only terms with no row form (the twin would drop
        # them silently, as its blocked path does: ROADMAP section C)
        raise ValueError("sharded energy: polar_ewald_full and "
                         "disp_expansion_mbvdw run dense only")
    A = state.n_atom_slots
    lead = mesh.leader
    z = torch.zeros((), dtype=torch.float64, device=lead)
    use_es = not (flags.use_sg or flags.rd_only)
    slices = _row_slices(A, mesh.size, block)

    rds, ess, closes, ranges = [], [], [], []
    for rows_all, dev in zip(slices, mesh.devices):
        n_valid = int((rows_all >= 0).sum())
        ranges.append((int(rows_all[0]) if n_valid else A, n_valid))
        with meshing.device_guard(dev):
            st = meshing.to_device(state, dev)
            zd = torch.zeros((), dtype=torch.float64, device=dev)
            rd, es = zd, zd
            close = torch.zeros((), dtype=torch.bool, device=dev)
            for b in range(-(-n_valid // block)):
                # a tile of padding only adds zeros: skipped
                rows = rows_all[b * block:(b + 1) * block].to(dev)
                pt = build_pairs_block(st, flags, rows)
                rd = rd + pair_potentials.rd_energy(st, pt, flags, params,
                                                    pair_only=True)
                if use_es:
                    es = es + (ewald.coulombic_wolf if flags.wolf
                               else ewald.coulombic_real)(st, pt, flags,
                                                          params)
                if flags.cavity_autoreject_absolute:
                    close = close | _close_pairs(pt, params)
        rds.append(rd)
        ess.append(es)
        closes.append(close)
    rd = meshing.psum(rds, mesh)
    es = meshing.psum(ess, mesh)
    close = meshing.psum([c.to(torch.int64) for c in closes], mesh) > 0

    pol = torch.zeros((), dtype=torch.float64, device=lead)
    mu = state.mu * 0.0
    iters, rrms = pol, pol
    failed = torch.zeros((), dtype=torch.bool, device=lead)
    if flags.polarization and use_es:
        # the row-sharded mixed SCF: each shard's planes of its own rows
        keep = [(d, r) for d, r in enumerate(ranges) if r[1]]
        sub = meshing.Mesh(tuple(mesh.devices[d] for d, _ in keep),
                           mesh.axis)
        planes, E = polar_cache.sharded_rows(state, flags, params, sub,
                                             [r for _, r in keep])
        if flags.polar_ewald:
            E = E + polar_mod.recip_term(state, flags, params)
        E = torch.where(state.atom_alive()[:, None], E, 0.0)
        pol, mu, iters, failed, rrms = polar_mod.finish_polar(
            state, flags, params, E,
            lambda m: polar_mod.contract_mixed(planes, m,
                                               l=params.polar_damp))

    # whole-system once-only terms, on the leader
    if flags.rd_lrc and not (flags.use_sg or flags.use_dreiding or
                             flags.using_lj_buffered_14_7):
        empty = build_pairs_block(
            state, flags, -torch.ones(1, dtype=torch.int64, device=lead))
        rd = rd + pair_potentials.rd_energy(state, empty, flags, params)
    coul = z
    if use_es:
        coul = es
        if not flags.wolf:
            coul = coul + ewald.coulombic_reciprocal(state, flags, params) \
                + ewald.coulombic_self(state, params)

    vdw_e, tb = z, z
    if flags.polarvdw or flags.using_axilrod_teller:
        from ..ops import polarvdw, three_body
        pt_dense = build_pairs(state, flags)
        if flags.polarvdw:
            amat = polar_mod.thole_amatrix(state, pt_dense, flags, params)
            vdw_e = polarvdw.vdw(state, amat, pt_dense, flags, params)
        if flags.using_axilrod_teller:
            tb = three_body.axilrod_teller(state, pt_dense, flags)

    pen = _penalty(close) if flags.cavity_autoreject_absolute else z
    return EnergyBreakdown(
        total=rd + coul + pol + vdw_e + tb, rd=rd, coulombic=coul,
        polarization=pol, vdw=vdw_e, three_body=tb, kinetic=z, mu=mu,
        polarization_iterations=iters, iterator_failed=failed,
        dipole_rrms=rrms, cavity_penalty=pen)
