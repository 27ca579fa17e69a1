"""The port's twins of the JAX package's remaining public functions against
them on the same numpy inputs (CPU):

- ``ops/energy.total_energy`` on the small CO2 system: 1e-9 relative;
- ``ops/polar_cache.polar_from_cache`` on that system's cache: 1e-6
  relative (the f32 planes), and against the port's own blocked energy;
  ``empty_cache``: every field's shape;
- ``mc/pi.pi_potential`` on the pi-argon-dimer example's 8-bead stack:
  1e-12 relative, and the failure flag;
- ``pbc.wrap_positions``, ``cart_to_frac``, ``frac_to_cart`` and
  ``quaternion.rotation_matrix``: bitwise, or 1e-15 where the twins'
  multiply-adds may fuse differently;
- ``io/pqr.state_bool`` on a state's bool fields: every element."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import torch_co2_system as co2  # noqa: E402
from mpmcxx_tpu import pbc as pbc_j  # noqa: E402
from mpmcxx_tpu import quaternion as quat_j  # noqa: E402
from mpmcxx_tpu.io import pqr as pqr_j  # noqa: E402
from mpmcxx_tpu.ops import energy as energy_j  # noqa: E402
from mpmcxx_tpu.ops import polar_cache as pc_j  # noqa: E402
from mpmcxx_tpu_torch import pbc as pbc_t  # noqa: E402
from mpmcxx_tpu_torch import quaternion as quat_t  # noqa: E402
from mpmcxx_tpu_torch.io import pqr as pqr_t  # noqa: E402
from mpmcxx_tpu_torch.ops import energy as energy_t  # noqa: E402
from mpmcxx_tpu_torch.ops import polar_cache as pc_t  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def systems():
    return co2.jax_system(), co2.torch_system()


def test_total_energy_matches_jax(systems):
    (sj, _, fj, pj, _), (st, _, ft, pt, _) = systems
    want = float(energy_j.total_energy(sj, fj, pj))
    got = energy_t.total_energy(st, ft, pt)
    assert got.shape == () and got.dtype == torch.float64
    assert float(got) == pytest.approx(want, rel=1e-9)
    eb = energy_t.energy_breakdown(st, ft, pt)
    assert float(got) == float(eb.total + eb.cavity_penalty)


def test_polar_from_cache_matches_jax(systems):
    (sj, _, fj, pj, _), (st, _, ft, pt, _) = systems
    want = pc_j.polar_from_cache(sj, pc_j.cache_init(sj, fj, pj), fj, pj)
    got = pc_t.polar_from_cache(st, pc_t.cache_init(st, ft, pt), ft, pt)
    assert float(got.energy) == pytest.approx(float(want.energy), rel=1e-6)
    # f32 planes: each dipole within 1e-6 of the largest
    mu = np.asarray(want.mu)
    np.testing.assert_allclose(got.mu.numpy(), mu, rtol=0.0,
                               atol=1e-6 * np.abs(mu).max())
    assert int(got.iterations) == int(want.iterations) == \
        ft.polar_max_iter
    blocked = energy_t.energy_breakdown_blocked(st, ft, pt)
    assert float(got.energy) == pytest.approx(float(blocked.polarization),
                                              rel=1e-6)


def test_empty_cache_shapes():
    want = pc_j.empty_cache()
    got = pc_t.empty_cache(device="cpu")
    for f in pc_j.PolarCache._fields:
        assert tuple(getattr(got, f).shape) == getattr(want, f).shape, f
    assert pc_t.planes_of(got) == ()


def test_pi_potential_matches_jax():
    """The 8-bead argon dimer's stack as each package's PISimulation reads
    it: the bead-mean components, their total and the failure flag."""
    from mpmcxx_tpu.config.parser import read_config as read_j
    from mpmcxx_tpu.mc import pi as pi_j
    from mpmcxx_tpu_torch.config.parser import read_config as read_t
    from mpmcxx_tpu_torch.mc import pi as pi_t

    old = os.getcwd()
    os.chdir(os.path.join(ROOT, "examples", "pi-argon-dimer"))
    try:
        sim_j = pi_j.PISimulation(read_j("run.in"), P=8, quiet=True)
        sim_t = pi_t.PISimulation(read_t("run.in"), P=8, quiet=True,
                                  device="cpu")
    finally:
        os.chdir(old)
    mean_j, total_j, failed_j = pi_j.pi_potential(sim_j.stack, sim_j.flags,
                                                  sim_j.params)
    mean_t, total_t, failed_t = pi_t.pi_potential(sim_t.stack, sim_t.flags,
                                                  sim_t.params)
    assert mean_t.shape == (4,) and total_t.shape == ()
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j),
                               rtol=1e-12, atol=0.0)
    assert float(total_t) == pytest.approx(float(total_j), rel=1e-12)
    assert float(total_t) < 0.0
    assert bool(failed_t) is bool(failed_j) is False


def _box():
    """A triclinic basis, its reciprocal, and positions and fractional
    coordinates that span several images."""
    rng = np.random.default_rng(5)
    basis = np.array([[21.0, 0.0, 0.0], [3.5, 19.0, 0.0],
                      [-2.25, 4.0, 23.5]])
    recip = np.linalg.inv(basis)
    pos = rng.uniform(-60.0, 60.0, (257, 3))
    frac = rng.uniform(-2.5, 2.5, (257, 3))
    return basis, recip, pos, frac


def _close_or_equal(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15,
                               atol=1e-15)


def test_pbc_twins_match_jax():
    basis, recip, pos, frac = _box()
    tb, tr = torch.from_numpy(basis), torch.from_numpy(recip)
    _close_or_equal(pbc_t.wrap_positions(torch.from_numpy(pos), tb, tr),
                    pbc_j.wrap_positions(jnp.asarray(pos),
                                         jnp.asarray(basis),
                                         jnp.asarray(recip)))
    _close_or_equal(pbc_t.cart_to_frac(torch.from_numpy(pos), tr),
                    pbc_j.cart_to_frac(jnp.asarray(pos), jnp.asarray(recip)))
    _close_or_equal(pbc_t.frac_to_cart(torch.from_numpy(frac), tb),
                    pbc_j.frac_to_cart(jnp.asarray(frac), jnp.asarray(basis)))
    wrapped = pbc_t.cart_to_frac(
        pbc_t.wrap_positions(torch.from_numpy(pos), tb, tr), tr)
    assert float(wrapped.abs().max()) <= 0.5 + 1e-12


def test_rotation_matrix_matches_jax():
    """Batched quaternions of any norm, the zero quaternion among them; the
    matrix of a unit quaternion rotates as quaternion.rotate does."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(64, 4)) * rng.uniform(0.1, 3.0, (64, 1))
    q[0] = 0.0
    got = quat_t.rotation_matrix(torch.from_numpy(q))
    assert got.shape == (64, 3, 3)
    _close_or_equal(got, quat_j.rotation_matrix(jnp.asarray(q)))
    np.testing.assert_array_equal(got[0].numpy(), np.eye(3))
    unit = torch.from_numpy(q[1:] / np.linalg.norm(q[1:], axis=1,
                                                   keepdims=True))
    v = torch.from_numpy(rng.normal(size=(63, 3)))
    np.testing.assert_allclose(
        (quat_t.rotation_matrix(unit) @ v[:, :, None])[..., 0].numpy(),
        quat_t.rotate(unit, v).numpy(), rtol=1e-12, atol=1e-12)


def test_state_bool_matches_jax(systems):
    (sj, *_), (st, *_) = systems
    for name in ("frozen", "mol_alive", "aalive"):
        got, want = getattr(st, name), getattr(sj, name)
        vals = [pqr_t.state_bool(got, i) for i in range(len(got))]
        assert vals == [pqr_j.state_bool(want, i) for i in range(len(want))]
        assert all(type(v) is bool for v in vals)
        assert any(vals) and not all(vals)
