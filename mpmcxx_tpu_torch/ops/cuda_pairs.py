"""Hand-written CUDA kernel of the blocked full recompute's pair sums and
its launch count.

JAX twin: the row-tile loop of mpmcxx_tpu/ops/energy.py
energy_breakdown_blocked (XLA; no Pallas kernel).

K6 ``pair_sums`` (csrc/pair_energy.cu) computes in one launch what the
row-tile loop ``ops/energy.pair_sums_plain`` computes: over the upper
pair triangle of live atoms, the repulsion-dispersion pair sum
(Lorentz-Berthelot LJ with Feynman-Hibbs order 2 or 4, cavity_autoreject
and the long-range correction's pair part), the Ewald real-space sum
(with its Feynman-Hibbs term and the intra-molecular screening
correction) and whether an inter-molecular pair lies closer than the
absolute cavity scale, all in float64.  ``takes`` says where
energy_breakdown_blocked calls it; every other form (the other mixing
rules and potentials, Wolf) and every CPU run take the plain loop.

The wrapper launches the kernel or raises: on a state or form ``takes``
refuses, when the build fails, and when the launch reports an error.
``pair_sums.launches`` counts its kernel launches (the partials' sum
kernel that follows each is not counted).
"""

from __future__ import annotations

import ctypes

import torch

from .. import constants as const
from ..flags import FFlags, RunParams
from ..state import SystemState
from . import ewald, kernels

# per-atom bits of the kernel's byte (csrc/pair_energy.cu kAlive, ...)
ALIVE, FROZEN, SPECTRE, CN_ZERO = 1, 2, 4, 8


def takes(state: SystemState, flags: FFlags) -> bool:
    """Whether K6 computes this state's pair sums: a float64 state on
    CUDA, under Lorentz-Berthelot LJ (with or without Feynman-Hibbs 2/4,
    LRC and either cavity check) and Ewald real space, or no
    electrostatics (``rd_only``)."""
    other_rd = (flags.rd_anharmonic or flags.use_sg or flags.use_dreiding or
                flags.using_lj_buffered_14_7 or flags.using_disp_expansion or
                flags.cdvdw_exp_repulsion or flags.gwp or flags.spectre or
                flags.rd_crystal or flags.polarvdw)
    other_mixing = (flags.waldmanhagler or flags.halgren_mixing or
                    flags.cdvdw_9th_repulsion or flags.cdvdw_sig_repulsion or
                    flags.c6_mixing)
    return (state.pos.device.type == "cuda" and
            state.pos.dtype == torch.float64 and
            not (other_rd or other_mixing or
                 (flags.wolf and not flags.rd_only)))


def atom_bits(state: SystemState):
    """[A] uint8: ALIVE, FROZEN, SPECTRE, and CN_ZERO where the atom's
    dispersion coefficients c6, c8 and c10 are all zero."""
    u8 = torch.uint8
    cn_zero = (state.c6 == 0.0) & (state.c8 == 0.0) & (state.c10 == 0.0)
    return (state.aalive.to(u8) * ALIVE | state.frozen.to(u8) * FROZEN |
            state.spectre.to(u8) * SPECTRE | cn_zero.to(u8) * CN_ZERO)


def _scalar(x, dev):
    """[1] float64 on ``dev``: a tensor reshaped, a number filled in (no
    host-to-device copy)."""
    if torch.is_tensor(x):
        return x.reshape(1).to(dtype=torch.float64, device=dev)
    return torch.full((1,), float(x), dtype=torch.float64, device=dev)


def _consts(params: RunParams):
    """The kernel's host scalars, in csrc/pair_energy.cu Consts' order."""
    vals = (params.ewald_alpha, params.cavity_autoreject_scale,
            ewald._SQRT_PI, const.pi, const.M2A2, const.hBar2, const.kB,
            const.M2A4, const.hBar4, const.kB2, const.AMU2KG,
            const.MAXVALUE, const.SMALL_dR)
    return (ctypes.c_double * len(vals))(*[float(v) for v in vals])


def pair_sums(state: SystemState, flags: FFlags, params: RunParams):
    """(rd, es, close) as ``ops/energy.pair_sums_plain`` gives them: 0-d
    float64, float64 and bool tensors."""
    if not takes(state, flags):
        raise ValueError(
            f"pair_sums: K6 computes Lorentz-Berthelot LJ with Ewald or no "
            f"electrostatics on a float64 CUDA state, got a "
            f"{state.pos.dtype} state on {state.pos.device}; run "
            f"ops/energy.pair_sums_plain")
    dev = state.pos.device
    A = state.n_atom_slots
    f64 = torch.float64
    pos, charge, sigma, epsilon = (
        t.to(f64).contiguous() for t in (state.pos, state.charge,
                                         state.sigma, state.epsilon))
    mmass = state.mol_mass[state.mol_id].to(f64).contiguous()
    mol_id = state.mol_id.to(torch.int64).contiguous()
    bits = atom_bits(state).contiguous()
    pbc = state.pbc
    box = torch.cat([pbc.basis.reshape(9).to(f64),
                     pbc.reciprocal.reshape(9).to(f64),
                     _scalar(pbc.cutoff, dev), _scalar(pbc.volume, dev),
                     _scalar(params.temperature, dev)])
    lib = kernels.load()
    nt = -(-A // lib.mpmcxx_pair_energy_tile())
    partial = torch.empty(nt * (nt + 1) // 2 * 3, dtype=f64, device=dev)
    out = torch.empty(3, dtype=f64, device=dev)
    fh = (4 if flags.feynman_hibbs_order >= 4 else 2) \
        if flags.feynman_hibbs else 0
    rc = lib.mpmcxx_pair_energy(
        pos.data_ptr(), charge.data_ptr(), sigma.data_ptr(),
        epsilon.data_ptr(), mmass.data_ptr(), mol_id.data_ptr(),
        bits.data_ptr(), box.data_ptr(), _consts(params), fh,
        int(not (flags.use_sg or flags.rd_only)), int(flags.rd_lrc),
        int(flags.cavity_autoreject), int(flags.cavity_autoreject_absolute),
        A, partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pair_sums launch failed: CUDA error {rc}")
    pair_sums.launches += 1
    return out[0], out[1], out[2] > 0.0


pair_sums.launches = 0
