"""The comparison that decides ``correct`` fails where it has to: the
control (the reference in the precision below the configuration's, put in
the program's place) and the timed path broken underneath, each at a
small cut of the cell, with the harness's look for a card skipped
(device "cpu").  The exchange between chips is no fault these one-chip
cells can have."""

import pytest
import torch

from benchmark.tests.small import run_rotor, run_small

pytest.importorskip("mpmcxx_tpu_torch")

CELLS = ("h2-bulk-77k.fixed4", "co2-bulk.plain", "h2-bulk-77k.precise",
         "pi-h2-nvt.b16")


def _fails(checks):
    return [k for k, v in checks.items()
            if v["value"] is not None and not v["value"] <= v["limit"]]


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(cell):
    res = run_small(cell, control=True)
    assert res["correct"], res["checks"]
    assert res["window"]["moves"] > 0 and res["window"]["accepted"] > 0
    assert _fails(res["control"]), res["control"]


def _long_corrtime(monkeypatch):
    """No refresh inside the window: the carried energies are the chain's
    own sums when the window closes."""
    import benchmark.tests.small as small
    real = small.small

    def small_long(name, size=small.DENSE, man=None):
        cfg, tr = real(name, size, man)
        tr["corrtime"] = 64
        return cfg, tr

    monkeypatch.setattr(small, "small", small_long)


def test_step_that_leaves_the_state_unchanged(monkeypatch):
    from mpmcxx_tpu_torch.mc import chain
    real = chain.make_step_fn

    def make(*a, **k):
        step = real(*a, **k)

        def stuck(carry, *b, **kw):
            _, out = step(carry, *b, **kw)
            return carry, out

        stuck.any_adiabatic = step.any_adiabatic
        return stuck

    monkeypatch.setattr(chain, "make_step_fn", make)
    res = run_small("h2-bulk-77k.fixed4")
    assert not res["correct"]
    assert _fails(res["checks"]) == ["unmoved"]


def test_delta_energy_over_half_the_atoms(monkeypatch):
    """The pair sum of every move's Delta-E over half of the atoms,
    doubled (the mean over the rest)."""
    _long_corrtime(monkeypatch)
    from mpmcxx_tpu_torch.ops import delta
    real = delta.delta_energy

    def half(old, new, rows, sf, flags, params, recip_old=None):
        res = real(old, new, rows, sf, flags, params, recip_old=recip_old)
        keep = torch.arange(old.n_atom_slots, device=rows.device) % 2 == 0
        keep[rows.clamp(min=0)] = True
        h = real(old.replace(aalive=old.aalive & keep),
                 new.replace(aalive=new.aalive & keep), rows, sf, flags,
                 params)
        return res._replace(d_rd=2.0 * h.d_rd)

    monkeypatch.setattr(delta, "delta_energy", half)
    res = run_small("co2-bulk.plain")
    assert not res["correct"]
    assert "rd_gap" in _fails(res["checks"])


def test_polarization_altered_where_it_is_produced(monkeypatch):
    _long_corrtime(monkeypatch)
    from mpmcxx_tpu_torch.ops import polar_cache
    real = polar_cache.polar_proposal

    def altered(*a, **k):
        res, commit = real(*a, **k)
        return res._replace(energy=res.energy * (1.0 + 1e-3)), commit

    monkeypatch.setattr(polar_cache, "polar_proposal", altered)
    res = run_small("h2-bulk-77k.fixed4")
    assert not res["correct"]
    assert "polar_gap" in _fails(res["checks"])


def test_pi_step_that_leaves_the_stack_unchanged(monkeypatch):
    """A PI step that carries its new energies but leaves every bead where
    it was."""
    import dataclasses

    from mpmcxx_tpu_torch.mc import pi
    real = pi.make_pi_step

    def make(*a, **k):
        step = real(*a, **k)

        def stuck(carry, *b, **kw):
            new, out = step(carry, *b, **kw)
            return dataclasses.replace(new, stack=carry.stack), out

        return stuck

    monkeypatch.setattr(pi, "make_pi_step", make)
    res = run_small("pi-h2-nvt.b16")
    assert not res["correct"]
    assert res["window"]["accepted"] > 0
    assert "unmoved" in _fails(res["checks"])


def test_pi_delta_potential_over_half_the_beads(monkeypatch):
    """Every move's Delta-E on the even beads only, each odd bead given
    their mean."""
    from mpmcxx_tpu_torch.mc import pi
    real = pi.pi_delta_potential

    def half(old, new, rows, sf, comps_old, flags, params, beads=None):
        comps, sf_new, _ = real(old, new, rows, sf, comps_old, flags,
                                params, beads=beads)
        odd = torch.arange(comps.shape[0], device=comps.device) % 2 == 1
        mean = torch.mean((comps - comps_old)[~odd], dim=0)
        comps = torch.where(odd[:, None], comps_old + mean, comps)
        return comps, sf_new, torch.sum(torch.mean(comps, dim=0))

    monkeypatch.setattr(pi, "pi_delta_potential", half)
    res = run_small("pi-h2-nvt.b16")
    assert not res["correct"]
    assert "rd_gap" in _fails(res["checks"])


def test_pi_delta_energy_altered_where_it_is_produced(monkeypatch):
    """Each bead's LJ Delta-E off by a thousandth, in ``delta_energy``."""
    from mpmcxx_tpu_torch.ops import delta
    real = delta.delta_energy

    def altered(*a, **k):
        res = real(*a, **k)
        return res._replace(d_rd=res.d_rd * (1.0 + 1e-3))

    monkeypatch.setattr(delta, "delta_energy", altered)
    res = run_small("pi-h2-nvt.b16")
    assert not res["correct"]
    assert "rd_gap" in _fails(res["checks"])


def test_pi_displacement_of_half_the_beads(monkeypatch):
    """A whole-chain displacement that moves the even beads only, with its
    Delta-E taken of the positions it leaves: the energies stay true to
    the stack."""
    from mpmcxx_tpu_torch.mc import pi
    real = pi.pi_displace

    def half(stack, *a, **k):
        new = real(stack, *a, **k)
        even = (torch.arange(stack.pos.shape[0],
                             device=stack.pos.device) % 2 == 0)
        return new.replace(pos=torch.where(even[:, None, None], new.pos,
                                           stack.pos))

    monkeypatch.setattr(pi, "pi_displace", half)
    res = run_small("pi-h2-nvt.b16")
    assert not res["correct"]
    assert res["window"]["accepted"] > 0
    assert _fails(res["checks"]) == ["unmoved"]


def test_pi_trial_potential_as_a_bead_sum(monkeypatch):
    """The trial potential the acceptance reads summed over the beads in
    place of their mean; the per-bead energies stay true."""
    from mpmcxx_tpu_torch.mc import pi
    real = pi.pi_delta_potential

    def summed(*a, **k):
        comps, sf_new, _ = real(*a, **k)
        return comps, sf_new, torch.sum(comps)

    monkeypatch.setattr(pi, "pi_delta_potential", summed)
    res = run_small("pi-h2-nvt.b16")
    assert not res["correct"]
    assert _fails(res["checks"]) == ["rd_gap"]


@pytest.mark.parametrize("stale", [False, True])
def test_pi_structure_factors_stale_after_orientation_staging(monkeypatch,
                                                              stale):
    """On the charged rotor cut, every bead perturbation (the orientation
    staging, then the Coker staging) accepted, and with ``stale`` bead 0's
    carried structure factors left at their values before it.  Accepting
    is planted: from the start's beads of one orientation, MPMC++'s
    orientation term (no reduced mass) takes every staging's Boltzmann
    factor to 0.  Accepted alone the energies stay true to the stack."""
    import dataclasses

    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.mc import pi
    real = pi.make_pi_step

    def make(*a, **k):
        step = real(*a, **k)

        def staged(carry, d, movetype, *b):
            if movetype != const.MOVETYPE_PERTURB_BEADS:
                return step(carry, d, movetype, *b)
            d = d.clone()
            d[pi._U_ACC] = -1.0
            new, out = step(carry, d, movetype, *b)
            if stale:
                re, im = new.sf.re.clone(), new.sf.im.clone()
                re[0], im[0] = carry.sf.re[0], carry.sf.im[0]
                new = dataclasses.replace(new, sf=type(new.sf)(re, im))
            return new, out

        return staged

    monkeypatch.setattr(pi, "make_pi_step", make)
    res = run_rotor(polarization=False, corrtime=64)
    assert res["window"]["accepted"] > 0
    if stale:
        assert not res["correct"]
        assert "recip_gap" in _fails(res["checks"])
    else:
        assert res["correct"], res["checks"]
