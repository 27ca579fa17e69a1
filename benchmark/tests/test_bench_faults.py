"""The comparison that decides ``correct`` fails where it has to: the
control (the reference in the precision below the configuration's, put in
the program's place) and the timed path broken underneath, each at a
small cut of the cell, with the harness's look for a card skipped
(device "cpu").  The exchange between chips is no fault these one-chip
cells can have."""

import pytest
import torch

from benchmark.tests.small import run_small

pytest.importorskip("mpmcxx_tpu_torch")

CELLS = ("h2-bulk-77k.fixed4", "co2-bulk.plain", "h2-bulk-77k.precise")


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
