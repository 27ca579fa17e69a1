"""The port's threefry keys and draws against jax.random, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mpmcxx_tpu_torch import random as rnd  # noqa: E402

SEEDS = (0, 1, 42, 2 ** 33 + 5)


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_bit_equal(seed):
    kj, kt = jax.random.PRNGKey(seed), rnd.PRNGKey(seed)
    np.testing.assert_array_equal(_np(kj), kt.numpy())
    for n in (1, 3, 4, 6):
        np.testing.assert_array_equal(_np(jax.random.split(kj, n)),
                                      rnd.split(kt, n).numpy())
    for data in (0, 1, 2, 12345):
        np.testing.assert_array_equal(_np(jax.random.fold_in(kj, data)),
                                      rnd.fold_in(kt, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (6,), (3,)])
def test_uniform_bit_equal(seed, shape):
    kj = jax.random.split(jax.random.PRNGKey(seed), 6)[3]
    kt = rnd.split(rnd.PRNGKey(seed), 6)[3]
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(kj, shape)),
                                  rnd.uniform(kt, shape).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(kj, shape, jnp.float32)),
        rnd.uniform(kt, shape, torch.float32).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches(seed):
    # the two erfinv implementations differ in the last bits
    kj = jax.random.split(jax.random.PRNGKey(seed), 6)[1]
    kt = rnd.split(rnd.PRNGKey(seed), 6)[1]
    np.testing.assert_allclose(rnd.normal(kt, (3,)).numpy(),
                               np.asarray(jax.random.normal(kj, (3,))),
                               rtol=1e-14, atol=0)


def test_batched_keys_match_one_by_one():
    # chunk_draws derives a chunk's draws from a [n, 2] stack of keys
    kj = jax.random.split(jax.random.PRNGKey(7), 5)
    kt = rnd.split(rnd.PRNGKey(7), 5)
    got = rnd.uniform(rnd.split(kt, 3)[:, 2], (6,)).numpy()
    for i in range(5):
        want = jax.random.uniform(jax.random.split(kj[i], 3)[2], (6,))
        np.testing.assert_array_equal(got[i], np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 0.5), (-3.0, 7.25),
                                   ("normal", 1.0)])
def test_uniform_bounds_as_scalars_unchanged(dtype, lo, hi):
    """uniform() keeps its bounds as Python scalars (no device copy); its
    draws equal, bit for bit, those of the bounds as 0-d tensors of the
    draw's dtype (this module's earlier form).  (jax agrees bit for bit at
    the bounds the chain uses, test_uniform_bit_equal; at others XLA may
    fuse the scale and shift into one rounding.)"""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    if lo == "normal":
        lo = float(np.nextafter(np_dt(-1.0), np_dt(0.0)))
    kt = rnd.split(rnd.PRNGKey(11), 4)
    got = rnd.uniform(kt, (257,), dtype, lo, hi)
    base = rnd.uniform(kt, (257,), dtype)          # floats in [0, 1)
    lo_t, hi_t = torch.tensor(lo, dtype=dtype), torch.tensor(hi, dtype=dtype)
    want = torch.maximum(lo_t, base * (hi_t - lo_t) + lo_t)
    assert torch.equal(got, want)
