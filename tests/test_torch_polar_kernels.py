"""Kernels K1 (contract_planes), K2 (write_plane_strips) and K4
(contract_planes_tri) of the port, and contract_mixed's choice between K1
and K4.

On the CPU the wrappers run their plain PyTorch versions, which are held
here against the JAX package's Pallas kernels in interpret mode and its
XLA paths (tests/test_torch_cuda_kernels.py holds the CUDA kernels
against the plain versions on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mpmcxx_tpu.ops import pallas_polar, polar  # noqa: E402
from mpmcxx_tpu.ops import polar_cache as pc_j  # noqa: E402
from mpmcxx_tpu_torch.ops import cuda_polar  # noqa: E402
from mpmcxx_tpu_torch.ops import polar as polar_t  # noqa: E402
from mpmcxx_tpu_torch.ops import polar_cache as pc_t  # noqa: E402

L_DAMP = 2.1304
# (rtol, atol) per plane mode: test_pallas.py:180-193 for modes 5 and 4,
# :225-227 for mode 3 (f32 sums of A terms in another order)
TOL = {5: (1e-5, 1e-6), 4: (1e-4, 1e-5), 3: (2e-5, 1e-5)}


def _planes(A, mode, seed):
    rng = np.random.default_rng(seed)

    def antisym(scale):
        m = rng.normal(size=(A, A)) * scale
        return ((m - m.T) / 2).astype(np.float32)

    if mode == 3:
        # antisymmetric displacements over the physical pair-distance
        # range (1-12 A): below ~0.5 A the f32 damping polynomials cancel
        # to noise and any two f32 implementations disagree there
        m = rng.normal(size=(A, A, 3))
        u = m - m.transpose(1, 0, 2)
        u /= np.linalg.norm(u, axis=-1, keepdims=True) + 1e-300
        r = rng.uniform(1.0, 12.0, size=(A, A))
        d = u * ((r + r.T) / 2)[..., None]
        mask = rng.uniform(size=(A, A)) < 0.9
        mask = mask & mask.T
        np.fill_diagonal(mask, False)
        return [np.where(mask, d[..., i], 0).astype(np.float32)
                for i in range(3)]
    co = rng.normal(size=(A, A)) * 0.01
    co = ((co + co.T) / 2).astype(np.float32)
    cd = rng.normal(size=(A, A)) * 0.02
    cd = ((cd + cd.T) / 2).astype(np.float32)
    d = [antisym(1.0) for _ in range(3)]
    if mode == 5:
        return [co, cd] + d
    w = np.sqrt(-np.minimum(co, 0)).astype(np.float32)
    return [cd] + [w * x for x in d]


@pytest.mark.parametrize("A", [256, 640])      # nr even (2), odd (5)
@pytest.mark.parametrize("mode", [3, 4, 5])
def test_contract_plain_matches_jax(A, mode):
    planes = _planes(A, mode, seed=A + mode)
    mu = np.random.default_rng(A * mode).normal(size=(A, 3)) * 0.1
    got = cuda_polar.contract_planes(
        tuple(torch.from_numpy(p) for p in planes), torch.from_numpy(mu),
        L_DAMP)
    assert got.dtype == torch.float64 and got.shape == (A, 3)
    pj = tuple(jnp.asarray(p) for p in planes)
    sym = pallas_polar.contract_pallas_sym(pj, jnp.asarray(mu), l=L_DAMP,
                                           interpret=True)
    xla = polar.contract_mixed(pj, jnp.asarray(mu), l=L_DAMP)
    rtol, atol = TOL[mode]
    for want in (sym, xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=rtol, atol=atol)


def _nonsym_planes(A, mode, seed):
    """Planes with no symmetry at all (test_pallas.py:127-149): the
    full-plane pass assumes none.  Mode 3 keeps pair distances in the
    physical 1-12 A range (see _planes)."""
    rng = np.random.default_rng(seed)
    if mode == 3:
        u = rng.normal(size=(A, A, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        d = u * rng.uniform(1.0, 12.0, size=(A, A))[..., None]
        return [d[..., i].astype(np.float32) for i in range(3)]
    # mode 4's s = sqrt(-co) d is ~0.1 d (test_pallas.py:57-60)
    scales = (0.01, 0.01, 1.0, 1.0, 1.0) if mode == 5 else \
        (0.01, 0.1, 0.1, 0.1)
    return [(rng.normal(size=(A, A)) * s).astype(np.float32)
            for s in scales]


@pytest.mark.parametrize("bc_max", [None, 128])   # one or 3 column tiles
@pytest.mark.parametrize("mode", [3, 4, 5])
def test_full_plane_plain_matches_contract_pallas(monkeypatch, bc_max, mode):
    """K1's plain version is B1 ``contract_pallas`` on non-symmetric
    planes, with the column tile capped as in
    test_pallas.py::test_column_tiling_accumulation."""
    A = 384
    if bc_max is not None:
        monkeypatch.setattr(pallas_polar, "BC_MAX", bc_max)
    pallas_polar.contract_pallas.clear_cache()     # BC_MAX is read at trace
    planes = _nonsym_planes(A, mode, seed=mode)
    mu = np.random.default_rng(mode + 10).normal(size=(A, 3))
    try:
        want = pallas_polar.contract_pallas(
            tuple(jnp.asarray(p) for p in planes), jnp.asarray(mu),
            l=L_DAMP, interpret=True)
    finally:
        pallas_polar.contract_pallas.clear_cache()
    got = cuda_polar.contract_planes(
        tuple(torch.from_numpy(p) for p in planes), torch.from_numpy(mu),
        L_DAMP)
    # f32 sums of A terms in another order (test_pallas.py:148-149; the
    # folded mode 4 as at :65-66)
    rtol, atol = (1e-4, 1e-5) if mode == 4 else (2e-5, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("A", [256, 640])      # nr even (2), odd (5) at b=128
@pytest.mark.parametrize("mode", [3, 4, 5])
def test_tri_plain_matches_contract_pallas_tri(A, mode):
    """K4's plain version (the kernel's 64 x 64 tile triangle) against B3
    ``contract_pallas_tri`` (its 128 x 128 triangle) in interpret mode:
    the tolerance of test_pallas.py::test_tri_contract_matches_sym."""
    planes = _planes(A, mode, seed=2 * A + mode)
    mu = np.random.default_rng(A + 7 * mode).normal(size=(A, 3)) * 0.1
    got = cuda_polar.contract_planes_tri(
        tuple(torch.from_numpy(p) for p in planes), torch.from_numpy(mu),
        L_DAMP)
    assert got.dtype == torch.float64 and got.shape == (A, 3)
    want = pallas_polar.contract_pallas_tri(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(mu), l=L_DAMP,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)


@pytest.mark.parametrize("A", [1000, 321])   # ragged last tile: 40, 1 rows
@pytest.mark.parametrize("mode", [3, 4, 5])
def test_tri_plain_ragged_matches_full_plane(mode, A):
    """With a ragged last tile (1,000 = 15 x 64 + 40, 321 = 5 x 64 + 1)
    the triangle with its transposed column sums and each diagonal tile
    once gives the full-plane contraction."""
    planes = tuple(torch.from_numpy(p) for p in _planes(A, mode, seed=mode))
    mu = torch.from_numpy(
        np.random.default_rng(mode).normal(size=(A, 3)) * 0.1)
    got = cuda_polar.contract_planes_tri_plain(planes, mu, L_DAMP)
    want = cuda_polar.contract_planes_plain(planes, mu, L_DAMP)
    rtol, atol = TOL[mode]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=atol)


SCHEDULE_ENVS = [{}, {"MPMCXX_TRI_KERNEL": "1"}, {"MPMCXX_SYM_KERNEL": "0"},
                 {"MPMCXX_SYM_KERNEL": "0", "MPMCXX_TRI_KERNEL": "1"},
                 {"MPMCXX_SYM_KERNEL": "1", "MPMCXX_TRI_KERNEL": "0"}]
# the port's kernel for each TPU kernel of polar.py:865-883
PORT_KERNEL = {"contract_pallas_tri": "contract_planes_tri",
               "contract_pallas_sym": "contract_planes",
               "contract_pallas": "contract_planes",
               "xla": "contract_planes"}


@pytest.mark.parametrize("shape", [(256, 256), (384, 384), (640, 640),
                                   (128, 128), (1000, 1000), (256, 512)])
@pytest.mark.parametrize("env", SCHEDULE_ENVS)
def test_schedule_switch_matches_jax(monkeypatch, env, shape):
    """contract_mixed picks K4 exactly where the JAX package, off the CPU,
    runs contract_pallas_tri, and K1 for every other branch of
    polar.py:865-883 (B2, B1, XLA).  The JAX side runs with its backend
    reported as a TPU and its kernels replaced by recorders."""
    import jax
    for k in ("MPMCXX_SYM_KERNEL", "MPMCXX_TRI_KERNEL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    called = []

    def recorder(name):
        def run(coeffs, mu, l=0.0):
            called.append(name)
            return jnp.zeros((coeffs[0].shape[0], 3))
        return run

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for name in ("contract_pallas", "contract_pallas_sym",
                 "contract_pallas_tri"):
        monkeypatch.setattr(pallas_polar, name, recorder(name))
    planes = [np.zeros(shape, np.float32)] * 3
    polar.contract_mixed(tuple(jnp.asarray(p) for p in planes),
                         jnp.zeros((shape[1], 3)), l=L_DAMP)
    jax_kernel = called[0] if called else "xla"

    ran = []
    for name in ("contract_planes", "contract_planes_tri"):
        monkeypatch.setattr(cuda_polar, name,
                            lambda *a, _n=name, **k: ran.append(_n))
    polar_t.contract_mixed(tuple(torch.from_numpy(p) for p in planes),
                           torch.zeros(shape[1], 3), l=L_DAMP)
    assert ran == [PORT_KERNEL[jax_kernel]]
    assert polar_t.use_tri(shape) == (jax_kernel == "contract_pallas_tri")


WINDOW_A, WINDOW_S = 512, 3
STARTS = (0, 17, 126, 127, 128, 255, 383, WINDOW_A - WINDOW_S)


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("valid", [(True, True, True),
                                   (False, True, True),
                                   (True, True, False)])
def test_write_symmetric_rows_bit_equal(start, valid):
    """The port's commit scatter equals the JAX twin's
    write_symmetric_rows (row update + S column updates) and, given the
    same strips, the Pallas write_columns_pallas, bit for bit."""
    A, S = WINDOW_A, WINDOW_S
    rng = np.random.default_rng(start)
    plane = rng.normal(size=(A, A)).astype(np.float32)
    rows = rng.normal(size=(S, A)).astype(np.float32)
    vj = jnp.asarray(valid)

    want = pc_j.write_symmetric_rows(jnp.asarray(plane), jnp.asarray(rows),
                                     jnp.asarray(start, jnp.int32), vj, -1.0)
    pt = torch.from_numpy(plane.copy())
    pc_t.write_symmetric_rows((pt,), (torch.from_numpy(rows),),
                              torch.tensor(start), torch.tensor(valid), -1.0)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(want))

    # the same strips through the Pallas column kernel
    cur = plane[start:start + S]
    blend = np.where(np.asarray(valid)[:, None], rows, cur)
    with_rows = plane.copy()
    with_rows[start:start + S] = blend
    cols = pt.numpy()[:, start:start + S]
    pallas = pallas_polar.write_columns_pallas(
        jnp.asarray(with_rows), jnp.asarray(cols),
        jnp.asarray(start, jnp.int32), interpret=True)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pallas))


def test_cpu_wrappers_do_not_count_launches():
    before = (cuda_polar.contract_planes.launches,
              cuda_polar.contract_planes_tri.launches,
              cuda_polar.write_plane_strips.launches)
    planes = tuple(torch.from_numpy(p) for p in _planes(256, 3, 0))
    cuda_polar.contract_planes(planes, torch.zeros(256, 3), L_DAMP)
    cuda_polar.contract_planes_tri(planes, torch.zeros(256, 3), L_DAMP)
    cuda_polar.write_plane_strips(
        planes, torch.zeros(3, 3, 256), torch.zeros(3, 3, 256),
        torch.tensor(5))
    assert (cuda_polar.contract_planes.launches,
            cuda_polar.contract_planes_tri.launches,
            cuda_polar.write_plane_strips.launches) == before


@pytest.mark.parametrize("slots", [0, 16384, 16385, 19712])
def test_cache_slot_bound(monkeypatch, slots):
    """On the CPU ``supports`` takes the JAX package's branch (16,384
    slots); on a card the bound is its memory: three plane copies of
    12 A^2 bytes within DEVICE_MEMORY_SHARE of total_memory, so an
    80 GiB card takes the CO2 flagship's 19,712 runner slots."""
    from mpmcxx_tpu import flags as fl_j
    from mpmcxx_tpu_torch import flags as fl_t
    kw = dict(polarization=True, polar_iterative=True, polar_ewald=True,
              polar_mixed=True)
    assert pc_t.supports(fl_t.FFlags(**kw), slots) == \
        pc_j.supports(fl_j.FFlags(**kw), slots)

    class Props:
        total_memory = 80 * 2 ** 30
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    cap = pc_t.max_slots("cuda")
    assert 36 * cap ** 2 <= pc_t.DEVICE_MEMORY_SHARE * Props.total_memory \
        < 36 * (cap + 1) ** 2
    assert pc_t.supports(fl_t.FFlags(**kw), slots, "cuda")
