"""The port's CUDA kernels against their plain PyTorch versions on the
card.  CUDA kernels have no CPU mode: every test here is marked ``gpu``
and skips without a CUDA device.  Run on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu

(this file imports no jax, so it runs where only torch is installed)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmcxx_tpu_torch.ops import cuda_cavity  # noqa: E402
from mpmcxx_tpu_torch.ops import cuda_polar  # noqa: E402
from mpmcxx_tpu_torch.ops import polar_cache  # noqa: E402

L_DAMP = 2.1304


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _planes(A, mode, seed, device):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(A, A, 3))
    d = m - m.transpose(1, 0, 2)
    if mode == 3:
        # masked displacements over the physical 1-12 A range
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-300
        r = rng.uniform(1.0, 12.0, size=(A, A))
        d *= ((r + r.T) / 2)[..., None]
        planes = [d[..., i] for i in range(3)]
    else:
        co = rng.normal(size=(A, A)) * 0.01
        co = (co + co.T) / 2
        cd = rng.normal(size=(A, A)) * 0.02
        cd = (cd + cd.T) / 2
        w = np.sqrt(-np.minimum(co, 0))
        planes = ([co, cd] + [d[..., i] for i in range(3)] if mode == 5
                  else [cd] + [w * d[..., i] for i in range(3)])
    return tuple(torch.from_numpy(p.astype(np.float32)).to(device)
                 for p in planes)


@pytest.mark.gpu
@pytest.mark.parametrize("A", [1024, 1000])
@pytest.mark.parametrize("mode", [3, 4, 5])
def test_contract_kernel_matches_plain(cuda, A, mode):
    planes = _planes(A, mode, mode, cuda)
    mu = torch.from_numpy(
        np.random.default_rng(mode).normal(size=(A, 3)) * 0.1).to(cuda)
    before = cuda_polar.contract_planes.launches
    got = cuda_polar.contract_planes(planes, mu, L_DAMP)
    want = cuda_polar.contract_planes_plain(planes, mu, L_DAMP)
    torch.cuda.synchronize()
    assert cuda_polar.contract_planes.launches == before + 1
    # f32 sums of A terms in another order
    assert float(torch.linalg.norm(got - want) /
                 torch.linalg.norm(want)) <= 1e-5


def _nonsym_planes(A, mode, seed, device):
    """Planes with no symmetry at all (test_pallas.py:127-149), as B1
    contract_pallas takes them; mode 3 keeps pair distances in 1-12 A."""
    rng = np.random.default_rng(seed)
    if mode == 3:
        u = rng.normal(size=(A, A, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        d = u * rng.uniform(1.0, 12.0, size=(A, A))[..., None]
        planes = [d[..., i] for i in range(3)]
    else:
        scales = (0.01, 0.01, 1.0, 1.0, 1.0) if mode == 5 else \
            (0.01, 0.1, 0.1, 0.1)
        planes = [rng.normal(size=(A, A)) * s for s in scales]
    return tuple(torch.from_numpy(p.astype(np.float32)).to(device)
                 for p in planes)


@pytest.mark.gpu
@pytest.mark.parametrize("A", [1024, 1000])
@pytest.mark.parametrize("mode", [3, 4, 5])
def test_contract_kernel_nonsym_matches_plain(cuda, A, mode):
    """K1 as B1's counterpart: the full-plane pass on planes with no
    symmetry."""
    planes = _nonsym_planes(A, mode, 20 + mode, cuda)
    mu = torch.from_numpy(
        np.random.default_rng(A - mode).normal(size=(A, 3)) * 0.1).to(cuda)
    before = cuda_polar.contract_planes.launches
    got = cuda_polar.contract_planes(planes, mu, L_DAMP)
    want = cuda_polar.contract_planes_plain(planes, mu, L_DAMP)
    torch.cuda.synchronize()
    assert cuda_polar.contract_planes.launches == before + 1
    # f32 sums of A terms in another order
    assert float(torch.linalg.norm(got - want) /
                 torch.linalg.norm(want)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("A", [1024, 1000])     # 1,000: ragged last tile
@pytest.mark.parametrize("mode", [3, 4, 5])
def test_tri_kernel_matches_plain(cuda, A, mode):
    """K4 against the full-plane plain version and its own triangle plain
    version; two launches on the same input are bitwise equal."""
    planes = _planes(A, mode, 10 + mode, cuda)
    mu = torch.from_numpy(
        np.random.default_rng(A + mode).normal(size=(A, 3)) * 0.1).to(cuda)
    before = cuda_polar.contract_planes_tri.launches
    got = cuda_polar.contract_planes_tri(planes, mu, L_DAMP)
    again = cuda_polar.contract_planes_tri(planes, mu, L_DAMP)
    torch.cuda.synchronize()
    assert cuda_polar.contract_planes_tri.launches == before + 2
    assert got.dtype == torch.float64 and got.shape == (A, 3)
    assert torch.equal(got, again)
    # f32 sums of A terms in another order
    for want in (cuda_polar.contract_planes_plain(planes, mu, L_DAMP),
                 cuda_polar.contract_planes_tri_plain(planes, mu, L_DAMP)):
        assert float(torch.linalg.norm(got - want) /
                     torch.linalg.norm(want)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("start", [0, 517, 1021])
@pytest.mark.parametrize("valid", [(True, True, True), (False, True, True)])
def test_commit_kernel_bit_equal_to_plain(cuda, start, valid):
    A = 1024
    rng = np.random.default_rng(start)
    base = tuple(torch.from_numpy(rng.normal(size=(A, A)).astype(
        np.float32)).to(cuda) for _ in range(3))
    rows = tuple(torch.from_numpy(rng.normal(size=(3, A)).astype(
        np.float32)).to(cuda) for _ in range(3))
    st = torch.tensor(start, device=cuda)
    blend, cols = polar_cache.commit_strips(
        base, rows, st, torch.tensor(valid, device=cuda), -1.0)
    k = tuple(p.clone() for p in base)
    p = tuple(x.clone() for x in base)
    cuda_polar.write_plane_strips(k, blend, cols, st)
    cuda_polar.write_plane_strips_plain(p, blend, cols, st)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs(cuda):
    A = 256
    planes = _planes(A, 3, 0, cuda)
    mu = torch.zeros(A, 3, device=cuda)
    with pytest.raises(ValueError):
        cuda_polar.contract_planes(tuple(p.double() for p in planes), mu)
    with pytest.raises(ValueError):
        cuda_polar.contract_planes(tuple(p.t() for p in planes), mu)
    for bad in (tuple(p.double() for p in planes),
                tuple(p.t() for p in planes),
                planes[:2] + (planes[2].cpu(),),
                tuple(p[:, :A - 1].contiguous() for p in planes),
                planes[:2]):
        with pytest.raises(ValueError):
            cuda_polar.contract_planes_tri(bad, mu)
    with pytest.raises(ValueError):
        cuda_polar.contract_planes_tri(planes, mu[:-1])
    with pytest.raises(ValueError):
        cuda_polar.write_plane_strips(planes, torch.zeros(2, 3, A,
                                                          device=cuda),
                                      torch.zeros(2, 3, A, device=cuda),
                                      torch.tensor(0, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("P,A", [(300, 70), (4097, 1000), (1, 0)])
def test_occupancy_kernel_bit_equal_to_plain(cuda, P, A):
    """K3 against its plain version, bitwise, with atoms placed at
    r (1 +- 1e-12) of the points and a third of them dead."""
    r = 2.6
    rng = np.random.default_rng(P + A)
    pts = rng.uniform(-10, 10, (P, 3))
    u = rng.normal(size=(A, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    near = pts[rng.integers(0, P, A)] + u * (
        r * (1 + 1e-12 * rng.choice([-1.0, 1.0], A)))[:, None]
    alive = rng.uniform(size=A) > 1 / 3
    args = [torch.from_numpy(x).to(cuda) for x in (pts, near, alive)]
    before = cuda_cavity.occupancy.launches
    got = cuda_cavity.occupancy(*args, r)
    want = cuda_cavity.occupancy_plain(*args, r)
    torch.cuda.synchronize()
    assert cuda_cavity.occupancy.launches == before + 1
    assert got.dtype == torch.bool and torch.equal(got, want)
