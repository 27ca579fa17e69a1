"""The port's CUDA kernels against their plain PyTorch versions on the
card.  CUDA kernels have no CPU mode: every test here is marked ``gpu``
and skips without a CUDA device.  Run on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu

(this file imports no jax, so it runs where only torch is installed)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_pair_system as pair_system  # noqa: E402
from mpmcxx_tpu_torch import tracing  # noqa: E402
from mpmcxx_tpu_torch.flags import FFlags  # noqa: E402
from mpmcxx_tpu_torch.ops import cuda_cavity  # noqa: E402
from mpmcxx_tpu_torch.ops import cuda_pairs  # noqa: E402
from mpmcxx_tpu_torch.ops import cuda_polar  # noqa: E402
from mpmcxx_tpu_torch.ops import ewald, pair_potentials  # noqa: E402
from mpmcxx_tpu_torch.ops import polar_cache  # noqa: E402
from mpmcxx_tpu_torch.ops.energy import \
    energy_breakdown_blocked, pair_sums_plain  # noqa: E402
from mpmcxx_tpu_torch.ops.pairwise import build_pairs_block  # noqa: E402

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


def _nonsym_planes(A, mode, seed, device, rows=None):
    """[rows, A] planes (rows = A by default) with no symmetry at all
    (test_pallas.py:127-149), as B1 contract_pallas and the XLA branch
    take them; mode 3 keeps pair distances in 1-12 A."""
    rng = np.random.default_rng(seed)
    shape = (A if rows is None else rows, A)
    if mode == 3:
        u = rng.normal(size=shape + (3,))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        d = u * rng.uniform(1.0, 12.0, size=shape)[..., None]
        planes = [d[..., i] for i in range(3)]
    else:
        scales = (0.01, 0.01, 1.0, 1.0, 1.0) if mode == 5 else \
            (0.01, 0.1, 0.1, 0.1)
        planes = [rng.normal(size=shape) * s for s in scales]
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


# square (TMA fill), ragged units, row slices, A % 4 != 0 (cp.async fill)
RECT_SHAPES = [(1024, 1024), (1000, 1000), (256, 1024), (37, 1001),
               (1001, 1001), (1, 640)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", RECT_SHAPES)
@pytest.mark.parametrize("mode", [3, 4, 5])
def test_contract_kernel_rect_matches_plain(cuda, shape, mode):
    """K1 on [R, A] planes, square or a slice of rows, as the XLA branch
    takes them: [R, 3] f64 within rel 1e-5 of the plain version, and two
    launches on one input bitwise equal."""
    R, A = shape
    planes = _nonsym_planes(A, mode, R + mode, cuda, rows=R)
    mu = torch.from_numpy(
        np.random.default_rng(R + A).normal(size=(A, 3)) * 0.1).to(cuda)
    before = cuda_polar.contract_planes.launches
    got = cuda_polar.contract_planes(planes, mu, L_DAMP)
    again = cuda_polar.contract_planes(planes, mu, L_DAMP)
    want = cuda_polar.contract_planes_plain(planes, mu, L_DAMP)
    torch.cuda.synchronize()
    assert cuda_polar.contract_planes.launches == before + 2
    assert got.dtype == torch.float64 and got.shape == (R, 3)
    assert torch.equal(got, again)
    # f32 sums of A terms in another order
    assert float(torch.linalg.norm(got - want) /
                 torch.linalg.norm(want)) <= 1e-5


# the dense examples' plane sizes (gcmc-mof-h2 63, -mixture 148, -co2
# 213 atom slots) and a ragged 57, square and a quarter of their rows: a
# few 32 x 64 units, mostly ragged, most with A % 4 != 0
SMALL_SHAPES = [(63, 63), (148, 148), (213, 213), (57, 57), (15, 63),
                (37, 148), (53, 213), (14, 57)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SMALL_SHAPES)
@pytest.mark.parametrize("mode", [3, 4, 5])
def test_contract_kernel_small_ragged_matches_plain(cuda, shape, mode):
    """K1 at the small, ragged sizes of the dense examples' XLA branch:
    [R, 3] within rel 1e-5 of the plain version, repeats bitwise."""
    R, A = shape
    planes = _nonsym_planes(A, mode, R * A + mode, cuda, rows=R)
    mu = torch.from_numpy(
        np.random.default_rng(A + mode).normal(size=(A, 3)) * 0.1).to(cuda)
    before = cuda_polar.contract_planes.launches
    got = cuda_polar.contract_planes(planes, mu, L_DAMP)
    again = cuda_polar.contract_planes(planes, mu, L_DAMP)
    want = cuda_polar.contract_planes_plain(planes, mu, L_DAMP)
    torch.cuda.synchronize()
    assert cuda_polar.contract_planes.launches == before + 2
    assert got.dtype == torch.float64 and got.shape == (R, 3)
    assert torch.equal(got, again)
    # f32 sums of A terms in another order
    assert float(torch.linalg.norm(got - want) /
                 torch.linalg.norm(want)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [3, 4, 5])
def test_contract_kernel_middle_rows_of_symmetric_planes(cuda, mode):
    """K1 on a quarter of the rows from the middle of symmetric planes
    (the self-pairs off the slice's diagonal), against the plain version
    and against the same rows of the whole planes' contraction."""
    A = 1024
    planes = _planes(A, mode, 60 + mode, cuda)
    mu = torch.from_numpy(
        np.random.default_rng(mode).normal(size=(A, 3)) * 0.1).to(cuda)
    r0, r1 = 3 * A // 8, 5 * A // 8
    rows = tuple(p[r0:r1] for p in planes)
    got = cuda_polar.contract_planes(rows, mu, L_DAMP)
    whole = cuda_polar.contract_planes(planes, mu, L_DAMP)[r0:r1]
    want = cuda_polar.contract_planes_plain(rows, mu, L_DAMP)
    torch.cuda.synchronize()
    for ref in (want, whole):
        assert float(torch.linalg.norm(got - ref) /
                     torch.linalg.norm(ref)) <= 1e-5


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
@pytest.mark.parametrize("A", [1024, 1280, 4096, 960])   # 960: nr = 15, odd
@pytest.mark.parametrize("mode", [3, 4, 5])
def test_sym_kernel_matches_plain(cuda, A, mode):
    """K5 against the full-plane plain version and its own schedule's
    plain version; two launches on the same input are bitwise equal."""
    planes = _planes(A, mode, 40 + mode, cuda)
    mu = torch.from_numpy(
        np.random.default_rng(A + 3 * mode).normal(size=(A, 3)) * 0.1).to(
        cuda)
    before = cuda_polar.contract_planes_sym.launches
    got = cuda_polar.contract_planes_sym(planes, mu, L_DAMP)
    again = cuda_polar.contract_planes_sym(planes, mu, L_DAMP)
    torch.cuda.synchronize()
    assert cuda_polar.contract_planes_sym.launches == before + 2
    assert got.dtype == torch.float64 and got.shape == (A, 3)
    assert torch.equal(got, again)
    # f32 sums of A terms in another order
    for want in (cuda_polar.contract_planes_plain(planes, mu, L_DAMP),
                 cuda_polar.contract_planes_sym_plain(planes, mu, L_DAMP)):
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
@pytest.mark.parametrize("P", [1, 3, 5])
@pytest.mark.parametrize("S", [1, 3, 5])
@pytest.mark.parametrize("A", [1024, 1001])     # 16-byte rows or not
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_commit_kernel_strips_bit_equal_to_plain(cuda, P, S, A, dtype):
    """K2 on P planes with an S-row window at starts 0, mid-plane and
    A - S, the start as the chain's int64 or as int32: bitwise its plain
    version, one launch each."""
    rng = np.random.default_rng(P * S + A)
    for start in (0, A // 2 + 1, A - S):
        base = tuple(torch.from_numpy(rng.normal(size=(A, A)).astype(
            np.float32)).to(cuda) for _ in range(P))
        rows = tuple(torch.from_numpy(rng.normal(size=(S, A)).astype(
            np.float32)).to(cuda) for _ in range(P))
        st = torch.tensor(start, dtype=dtype, device=cuda)
        valid = torch.from_numpy(np.arange(S) % 2 == 0).to(cuda)
        blend, cols = polar_cache.commit_strips(base, rows, st, valid, -1.0)
        k = tuple(p.clone() for p in base)
        p = tuple(x.clone() for x in base)
        before = cuda_polar.write_plane_strips.launches
        cuda_polar.write_plane_strips(k, blend, cols, st)
        cuda_polar.write_plane_strips_plain(p, blend, cols, st)
        torch.cuda.synchronize()
        assert cuda_polar.write_plane_strips.launches == before + 1
        for a, b in zip(k, p):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("S", [1, 3, 5])
@pytest.mark.parametrize("A", [1024, 1000])     # 16-byte rows or not
def test_commit_kernel_row_slices_bit_equal_to_plain(cuda, n, S, A):
    """K2's row-slice mode: each shard's launch on its [A/n, A] slices
    (row0 = its first row) bitwise the plain version on the same slices and
    the full-plane plain version's rows, at window starts 0, inside one
    shard, straddling a shard boundary and A - S, partly valid windows;
    one launch per shard."""
    R = A // n
    rng = np.random.default_rng(n * S + A)
    for start in sorted({0, R + 1, max(R - S // 2 - 1, 0), A - S}):
        full = tuple(torch.from_numpy(rng.normal(size=(A, A)).astype(
            np.float32)).to(cuda) for _ in range(3))
        rows = tuple(torch.from_numpy(rng.normal(size=(S, A)).astype(
            np.float32)).to(cuda) for _ in range(3))
        st = torch.tensor(start, device=cuda)
        valid = torch.from_numpy(np.arange(S) % 2 == 0).to(cuda)
        blend, cols = polar_cache.commit_strips(full, rows, st, valid,
                                                (1.0, -1.0, -1.0))
        want = tuple(p.clone() for p in full)
        cuda_polar.write_plane_strips_plain(want, blend, cols, st)
        before = cuda_polar.write_plane_strips.launches
        for d in range(n):
            k = tuple(p[d * R:(d + 1) * R].clone() for p in full)
            q = tuple(p[d * R:(d + 1) * R].clone() for p in full)
            cuda_polar.write_plane_strips(k, blend, cols, st, row0=d * R)
            cuda_polar.write_plane_strips_plain(q, blend, cols, st,
                                                row0=d * R)
            torch.cuda.synchronize()
            for a, b, w in zip(k, q, want):
                assert torch.equal(a, b)
                assert torch.equal(a, w[d * R:(d + 1) * R])
        assert cuda_polar.write_plane_strips.launches == before + n


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs(cuda):
    A = 256
    planes = _planes(A, 3, 0, cuda)
    mu = torch.zeros(A, 3, device=cuda)
    with pytest.raises(ValueError):
        cuda_polar.contract_planes(tuple(p.double() for p in planes), mu)
    with pytest.raises(ValueError):
        cuda_polar.contract_planes(tuple(p.t() for p in planes), mu)
    rows = tuple(p[:64] for p in planes)                    # [64, A]: taken
    for bad_planes, bad_mu in (
            (rows, mu[:64]),                                # mu of the rows
            (planes[:2] + (planes[2].cpu(),), mu),          # mixed devices
            (planes, mu.cpu()),
            (rows[:2] + (planes[2],), mu),                  # shapes differ
            (tuple(p[:0] for p in planes), mu),             # no rows
            (tuple(p[:, ::2] for p in planes), mu[::2]),    # not contiguous
            (tuple(p.half() for p in planes), mu),
            (planes[:2], mu),
            (planes + planes[:3], mu)):                     # 6 planes
        with pytest.raises(ValueError):
            cuda_polar.contract_planes(bad_planes, bad_mu)
    for bad in (tuple(p.double() for p in planes),
                tuple(p.t() for p in planes),
                planes[:2] + (planes[2].cpu(),),
                tuple(p[:, :A - 1].contiguous() for p in planes),
                planes[:2]):
        with pytest.raises(ValueError):
            cuda_polar.contract_planes_tri(bad, mu)
    with pytest.raises(ValueError):
        cuda_polar.contract_planes_tri(planes, mu[:-1])
    for bad in (tuple(p.double() for p in planes),
                tuple(p.t() for p in planes),
                planes[:2] + (planes[2].cpu(),),
                tuple(p[:, :A - 1].contiguous() for p in planes),
                planes[:2]):
        with pytest.raises(ValueError):
            cuda_polar.contract_planes_sym(bad, mu)
    with pytest.raises(ValueError):
        cuda_polar.contract_planes_sym(planes, mu[:-1])
    ragged = _planes(1000, 3, 0, cuda)       # not a multiple of 64 rows
    with pytest.raises(ValueError):
        cuda_polar.contract_planes_sym(ragged, torch.zeros(1000, 3,
                                                           device=cuda))
    with pytest.raises(ValueError):
        cuda_polar.write_plane_strips(planes, torch.zeros(2, 3, A,
                                                          device=cuda),
                                      torch.zeros(2, 3, A, device=cuda),
                                      torch.tensor(0, device=cuda))
    strip = torch.zeros(3, 3, A, device=cuda)
    for bad_start in (torch.tensor(0.0, device=cuda),
                      torch.tensor(0, dtype=torch.int16, device=cuda),
                      torch.tensor([0], device=cuda),
                      torch.tensor(0)):
        with pytest.raises(ValueError):
            cuda_polar.write_plane_strips(planes, strip, strip, bad_start)
    with pytest.raises(ValueError):
        cuda_polar.write_plane_strips(planes, strip.double(), strip,
                                      torch.tensor(0, device=cuda))
    with pytest.raises(ValueError):
        cuda_polar.write_plane_strips(planes, strip, strip.transpose(1, 2),
                                      torch.tensor(0, device=cuda))
    rows = tuple(p[:64].contiguous() for p in planes)
    for row0 in (-1, A - 63):                  # not a slice of A rows
        with pytest.raises(ValueError):
            cuda_polar.write_plane_strips(rows, strip, strip,
                                          torch.tensor(0, device=cuda),
                                          row0=row0)


@pytest.mark.gpu
@pytest.mark.parametrize("P,A", [(300, 70), (4097, 1000), (1, 0),
                                 (13824, 19712)])
def test_occupancy_kernel_bit_equal_to_plain(cuda, P, A):
    """K3 against its plain version, bitwise, with atoms placed at
    r (1 +- 1e-12) of the points and a third of them dead, interleaved
    with the live ones; at the CLI run's grid shape (13,824 points, 19,712
    slots: 54 point tiles x 20 atom chunks) the slots of the second
    1,024-slot chunk are all dead."""
    r = 2.6
    rng = np.random.default_rng(P + A)
    box = 10 if P < 10000 else 40
    pts = rng.uniform(-box, box, (P, 3))
    u = rng.normal(size=(A, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    near = pts[rng.integers(0, P, A)] + u * (
        r * (1 + 1e-12 * rng.choice([-1.0, 1.0], A)))[:, None]
    alive = rng.uniform(size=A) > 1 / 3
    alive[1024:2048] = False
    args = [torch.from_numpy(x).to(cuda) for x in (pts, near, alive)]
    before = cuda_cavity.occupancy.launches
    got = cuda_cavity.occupancy(*args, r)
    want = cuda_cavity.occupancy_plain(*args, r)
    torch.cuda.synchronize()
    assert cuda_cavity.occupancy.launches == before + 1
    assert got.dtype == torch.bool and torch.equal(got, want)


def _abs_tile_sums(state, flags, params, block=16):
    """The plain version's rd and es pair sums taken over [block, A] row
    tiles, each tile's sum made absolute: no more than the sums of the
    absolute pair terms, so a tolerance on these is no looser."""
    A = state.n_atom_slots
    rd, es = 0.0, 0.0
    for b in range(-(-A // block)):
        rows = b * block + torch.arange(block, device=state.pos.device)
        pt = build_pairs_block(state, flags, torch.where(rows < A, rows, -1))
        rd += abs(float(pair_potentials.rd_energy(state, pt, flags, params,
                                                  pair_only=True)))
        if not flags.rd_only:
            es += abs(float(ewald.coulombic_real(state, pt, flags, params)))
    return rd, es


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(pair_system.FORMS))
@pytest.mark.parametrize("ewald_on", [True, False])
@pytest.mark.parametrize("lrc", [True, False])
@pytest.mark.parametrize("cavity", [False, True])
def test_pair_kernel_matches_plain(cuda, form, ewald_on, lrc, cavity):
    """K6 against the row-tile loop on tests/torch_pair_system.py's
    mixture (1,094 slots: 9 tiles, the last ragged; dead slots in the
    middle and at the end, frozen and same-molecule pairs, neutral
    massless LJ sites, a triclinic box, molecules split across it, a pair
    0.4 A apart): rd and es within
    1e-10 of the absolute tile sums, close exact, two calls bitwise."""
    state, _ = pair_system.build(cuda)
    flags = pair_system.flags(form, ewald_on, lrc, cavity)
    params = pair_system.params()
    before = cuda_pairs.pair_sums.launches
    got = cuda_pairs.pair_sums(state, flags, params)
    again = cuda_pairs.pair_sums(state, flags, params)
    want = pair_sums_plain(state, flags, params)
    torch.cuda.synchronize()
    assert cuda_pairs.pair_sums.launches == before + 2
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert got[0].dtype == got[1].dtype == torch.float64
    assert got[2].dtype == torch.bool
    scale_rd, scale_es = _abs_tile_sums(state, flags, params)
    assert scale_rd > 0.0 and (scale_es > 0.0) == ewald_on
    assert abs(float(got[0] - want[0])) <= 1e-10 * scale_rd
    assert abs(float(got[1] - want[1])) <= 1e-10 * scale_es
    assert bool(got[2]) == bool(want[2]) == cavity


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(pair_system.FORMS))
def test_pair_kernel_cavity_maxvalue(cuda, form):
    """Two live, unfrozen O sites of two molecules 1 A apart (inside
    cavity_autoreject_scale * sigma = 1.83 A): MAXVALUE in both sums."""
    state, meta = pair_system.build(cuda)
    alive = state.aalive.cpu().numpy()
    mol = state.mol_id.cpu().numpy()
    o = [a for a, t in enumerate(meta["atomtypes"]) if t == "O" and
         alive[a] and mol[a] not in pair_system.FROZEN]
    i, j = o[0], next(a for a in o if mol[a] != mol[o[0]])
    pos = state.pos.clone()
    pos[i] = pos[j] + torch.tensor([1.0, 0.0, 0.0], device=cuda)
    state = state.replace(pos=pos)
    flags = pair_system.flags(form, cavity=True)
    params = pair_system.params()
    got = cuda_pairs.pair_sums(state, flags, params)
    want = pair_sums_plain(state, flags, params)
    assert float(want[0]) >= 1e30
    assert abs(float(got[0] - want[0])) <= 1e-12 * float(want[0])
    assert bool(got[2]) and bool(want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(pair_system.FORMS))
def test_blocked_energy_takes_k6_on_the_card(cuda, form):
    """energy_breakdown_blocked on the card counts ``pair_kernel`` and
    agrees with the same energy on the CPU (the plain loop)."""
    flags = pair_system.flags(form, cavity=True)
    params = pair_system.params()
    state, _ = pair_system.build(cuda)
    host, _ = pair_system.build("cpu")
    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("refresh.energy"):
            got = energy_breakdown_blocked(state, flags, params)
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    assert snap["counters"]["pair_kernel"] == {"refresh.energy": 1}
    assert "pair_plain" not in snap["counters"]
    want = energy_breakdown_blocked(host, flags, params)
    scale_rd, scale_es = _abs_tile_sums(host, flags, params)
    assert abs(float(got.rd) - float(want.rd)) <= 1e-10 * scale_rd
    assert abs(float(got.coulombic) - float(want.coulombic)) <= \
        1e-10 * scale_es
    assert float(got.cavity_penalty) == float(want.cavity_penalty) > 0.0


@pytest.mark.gpu
def test_pair_kernel_rejects_what_it_does_not_compute(cuda):
    state, _ = pair_system.build(cuda)
    params = pair_system.params()
    for bad in (FFlags(wolf=True), FFlags(cdvdw_exp_repulsion=True),
                FFlags(waldmanhagler=True), FFlags(use_sg=True)):
        assert not cuda_pairs.takes(state, bad)
        with pytest.raises(ValueError):
            cuda_pairs.pair_sums(state, bad, params)
    flags = pair_system.flags()
    assert cuda_pairs.takes(state, flags)
    with pytest.raises(ValueError):
        cuda_pairs.pair_sums(state.replace(pos=state.pos.float()), flags,
                             params)
