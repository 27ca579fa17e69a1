"""The port's cavity bias against the JAX package's on the CPU: the plain
version of kernel K3 against ``pallas_cavity.occupancy`` (its f64 CPU
path), and ``mc/cavity`` on the small CO2 system under the same keys.
Every comparison is exact: f64 in both, the same operation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_co2_system as co2  # noqa: E402
from mpmcxx_tpu.mc import cavity as cavity_j  # noqa: E402
from mpmcxx_tpu.ops.pallas_cavity import occupancy as occupancy_j  # noqa: E402
from mpmcxx_tpu_torch import random as rnd  # noqa: E402
from mpmcxx_tpu_torch.mc import cavity as cavity_t  # noqa: E402
from mpmcxx_tpu_torch.ops import cuda_cavity  # noqa: E402
from mpmcxx_tpu_torch.state import state_from_jax  # noqa: E402

G, R = 5, 2.6
N_DARTS = int(co2.L ** 3 * 0.1)


def _occupancy_both(points, pos, alive, r):
    want = np.asarray(occupancy_j(jnp.asarray(points), jnp.asarray(pos),
                                  jnp.asarray(alive), r))
    got = cuda_cavity.occupancy(torch.from_numpy(points),
                                torch.from_numpy(pos),
                                torch.from_numpy(alive), r)
    return got.numpy(), want


def test_occupancy_plain_matches_jax():
    # the case of tests/test_pallas.py::test_occupancy_matches_dense
    rng = np.random.default_rng(0)
    P, A = 300, 70
    points = rng.uniform(-10, 10, (P, 3))
    pos = rng.uniform(-10, 10, (A, 3))
    alive = rng.uniform(size=A) < 0.8
    got, want = _occupancy_both(points, pos, alive, 2.4)
    assert got.dtype == np.bool_ and 0 < want.sum() < P
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def states():
    sj = co2.jax_system()[0]
    return sj, state_from_jax(co2.jax_state_numpy(sj))


def test_occupancy_plain_matches_jax_on_grid(states):
    """A grid-shaped case: the cavity grid against the wrapped atoms, and
    plain-version chunks smaller than the grid."""
    sj, st = states
    pts = cavity_t.grid_points(st, 7)
    np.testing.assert_array_equal(pts.numpy(),
                                  np.asarray(cavity_j.grid_points(sj, 7)))
    pos = cavity_t.wrapped_positions(st)
    got, want = _occupancy_both(pts.numpy(), pos.numpy(), st.aalive.numpy(),
                                R)
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got, want)
    small = cuda_cavity._PLAIN_PAIRS
    try:
        cuda_cavity._PLAIN_PAIRS = 7 * pos.shape[0]
        np.testing.assert_array_equal(
            cuda_cavity.occupancy(pts, pos, st.aalive, R).numpy(), want)
    finally:
        cuda_cavity._PLAIN_PAIRS = small


def test_mol_com_matches_jax(states):
    sj, st = states
    np.testing.assert_allclose(st.mol_com().numpy(), np.asarray(sj.mol_com()),
                               rtol=1e-15, atol=1e-13)


@pytest.mark.parametrize("seed", [0, 3])
def test_update_grid_matches_jax(states, seed):
    sj, st = states
    kj = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
    kt = rnd.split(rnd.PRNGKey(seed), 3)[0]
    ij = cavity_j.update_grid(sj, G, R, kj, n_darts=N_DARTS)
    it = cavity_t.update_grid(st, G, R, rnd.uniform(kt, (N_DARTS, 3)))
    np.testing.assert_array_equal(it.open_mask.numpy(),
                                  np.asarray(ij.open_mask))
    assert 0 < int(it.open_mask.sum()) < G ** 3
    assert float(it.probability) == float(ij.probability)
    assert float(it.volume) == float(ij.volume)
    np.testing.assert_array_equal(it.points.numpy(), np.asarray(ij.points))


@pytest.mark.parametrize("seed", range(4))
def test_biased_insert_position_matches_jax(states, seed):
    sj, st = states
    kj = jax.random.split(jax.random.PRNGKey(seed), 3)
    kt = rnd.split(rnd.PRNGKey(seed), 3)
    ij = cavity_j.update_grid(sj, G, R, kj[0], n_darts=N_DARTS)
    it = cavity_t.update_grid(st, G, R, rnd.uniform(kt[0], (N_DARTS, 3)))
    com_j, ok_j = cavity_j.biased_insert_position(ij, kj[1])
    com_t, ok_t = cavity_t.biased_insert_position(it, rnd.uniform(kt[1]))
    np.testing.assert_array_equal(com_t.numpy(), np.asarray(com_j))
    assert bool(ok_t) == bool(ok_j)
    # no open point: the pick reports unbiased
    closed = it._replace(open_mask=torch.zeros_like(it.open_mask))
    assert not bool(cavity_t.biased_insert_position(
        closed, rnd.uniform(kt[1]))[1])


@pytest.mark.parametrize("avg", [0.0, 0.01, 0.03, 0.2])
def test_remove_biased_flag_matches_jax(avg):
    for seed in range(8):
        kj = jax.random.PRNGKey(seed)
        kt = rnd.PRNGKey(seed)
        want = cavity_j.remove_biased_flag(kj, jnp.asarray(avg), G)
        got = cavity_t.remove_biased_flag(rnd.uniform(kt),
                                          torch.tensor(avg), G)
        assert bool(got) == bool(want)
