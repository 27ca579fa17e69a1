"""A small mixture for the blocked full recompute's pair sums (K6 and its
plain row-tile loop): 3-site CO2-like molecules and 2-site charged
molecules whose one site has no LJ (sigma = epsilon = 0, a nonzero c6)
and whose other is attractive-only (sigma < 0), half of them with a
third site that is neutral and massless but has LJ (as BSSP H2's H2N
sites: Ewald skips its pairs, the Feynman-Hibbs mass leaves it out), in
a triclinic box, with atoms wrapped one by one (molecules split across
the box), two frozen molecules, dead slots in the middle and at the end,
and one inter-molecular pair 0.4 A apart (the two LJ-less sites).  The
slot count is not a multiple of the kernel's 128-slot tile.  This module
imports no jax, so the card's tests can use it."""

import numpy as np

from mpmcxx_tpu_torch.flags import FFlags, RunParams
from mpmcxx_tpu_torch.state import AtomRecord, build_state

BASIS = np.array([[44.0, 0.0, 0.0], [6.0, 42.0, 0.0], [4.0, 5.0, 43.0]])
N_MOL = 350             # live and dead-in-the-middle molecules
EXTRA = 30              # dead headroom at the end
KILLED = (5, 17, 40)    # molecules dead in the middle
FROZEN = (0, 1)
CLOSE = 0.4             # the close pair's distance (A)
SCALE = 0.6             # cavity_autoreject_scale: absolute 0.6 A


def _unit(rng):
    v = rng.normal(size=3)
    return v / np.linalg.norm(v)


def _co2(c, u):
    return [("C", c, 9.9, 2.80, 27.0, 12.011, 0.0),
            ("O", c + 1.16 * u, -4.95, 3.05, 79.0, 15.999, 0.0),
            ("O", c - 1.16 * u, -4.95, 3.05, 79.0, 15.999, 0.0)]


def _qn(q_pos, u):
    return [("Q", q_pos, 6.0, 0.0, 0.0, 1.008, 1.0),
            ("N", q_pos + 1.1 * u, -6.0, -2.5, 35.0, 14.007, 0.0)]


def _qnx(q_pos, u):
    """_qn with a neutral, massless LJ site 0.7 A behind Q."""
    return _qn(q_pos, u) + [("X", q_pos - 0.7 * u, 0.0, 2.3, 4.0, 0.0, 0.0)]


def molecules(seed=0):
    """[(moleculetype, [(atomtype, pos, q, sigma, eps, mass, c6)])]."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    picks = rng.choice(len(grid), N_MOL - 1, replace=False)
    mols = []
    for m, g in enumerate(grid[picks]):
        c = ((g + 0.5) / 8.0) @ BASIS + rng.uniform(-0.3, 0.3, 3)
        if m == 2:
            # the close pair: two molecules whose LJ-less sites lie CLOSE
            # apart, their attractive-only sites pointing away
            u = _unit(rng)
            v = np.cross(u, _unit(rng))
            v /= np.linalg.norm(v)
            mols.append(("QN", _qn(c, u)))
            mols.append(("QN", _qn(c + CLOSE * v, -u)))
        elif m % 8 == 7:
            mols.append(("QNX", _qnx(c, _unit(rng))))
        elif m % 4 == 3:
            mols.append(("QN", _qn(c, _unit(rng))))
        else:
            mols.append(("CO2", _co2(c, _unit(rng))))
    return mols


def _wrap(p):
    frac = p @ np.linalg.inv(BASIS)
    return (frac - np.floor(frac)) @ BASIS


def records(seed=0):
    out = []
    for m, (mt, sites) in enumerate(molecules(seed)):
        for at, p, q, sig, eps, mass, c6 in sites:
            x, y, z = _wrap(p)
            out.append(AtomRecord(atomtype=at, moleculetype=mt,
                                  molecule_id=m + 1, frozen=m in FROZEN,
                                  x=x, y=y, z=z, mass=mass, charge=q,
                                  epsilon=eps, sigma=sig, c6=c6))
    return out


def build(device, seed=0):
    """(state, meta) on ``device``: the mixture with KILLED dead and EXTRA
    dead molecules of headroom at the end."""
    state, meta = build_state(records(seed), BASIS,
                              extra_mol_capacity=EXTRA,
                              template_moleculetype="CO2", device=device)
    alive = state.mol_alive.clone()
    alive[list(KILLED)] = False
    return state.replace(mol_alive=alive, aalive=alive[state.mol_id]), meta


def params(**kw):
    base = dict(temperature=77.0, ewald_alpha=0.16,
                cavity_autoreject_scale=SCALE)
    base.update(kw)
    return RunParams(**base)


# the forms K6 computes: LJ, + FH2, + FH4; each with Ewald or rd_only,
# with LRC or not, with both cavity checks or none
FORMS = {"lj": {}, "fh2": dict(feynman_hibbs=True, feynman_hibbs_order=2),
         "fh4": dict(feynman_hibbs=True, feynman_hibbs_order=4)}


def flags(form="lj", ewald=True, lrc=True, cavity=False, **kw):
    return FFlags(rd_only=not ewald, rd_lrc=lrc, cavity_autoreject=cavity,
                  cavity_autoreject_absolute=cavity, **FORMS[form], **kw)
