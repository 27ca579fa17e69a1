"""Which path computes the blocked full recompute's pair sums: K6
(ops/cuda_pairs.pair_sums, CUDA only) or the plain row-tile loop
(ops/energy.pair_sums_plain), and the counters that say so.  On the CPU
every blocked energy runs the plain loop; the kernel itself is held to
it on the card (tests/test_torch_cuda_kernels.py).  This file imports
no jax."""

import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_pair_system as pair_system  # noqa: E402
from mpmcxx_tpu_torch import tracing  # noqa: E402
from mpmcxx_tpu_torch.flags import FFlags  # noqa: E402
from mpmcxx_tpu_torch.ops import cuda_pairs  # noqa: E402
from mpmcxx_tpu_torch.ops.energy import \
    energy_breakdown_blocked, pair_sums_plain  # noqa: E402

# (flags, whether K6 computes them)
FORMS = {
    "lj": (pair_system.flags(), True),
    "lj_no_lrc": (pair_system.flags(lrc=False), True),
    "lj_rd_only": (pair_system.flags(ewald=False), True),
    "lj_cavity": (pair_system.flags(cavity=True), True),
    "fh2": (pair_system.flags("fh2"), True),
    "fh4": (pair_system.flags("fh4", cavity=True), True),
    "fh4_rd_only": (pair_system.flags("fh4", ewald=False), True),
    "wolf": (pair_system.flags(wolf=True), False),
    "wolf_rd_only": (pair_system.flags(ewald=False, wolf=True), True),
    "buckingham": (pair_system.flags(cdvdw_exp_repulsion=True), False),
    "waldman_hagler": (pair_system.flags(waldmanhagler=True), False),
    "halgren": (pair_system.flags(halgren_mixing=True), False),
    "c6_mixing": (pair_system.flags(c6_mixing=True), False),
    "sig_repulsion": (pair_system.flags(cdvdw_sig_repulsion=True), False),
    "9th_repulsion": (pair_system.flags(cdvdw_9th_repulsion=True), False),
    "silvera_goldman": (FFlags(use_sg=True), False),
    "dreiding": (FFlags(use_dreiding=True), False),
    "buffered_14_7": (FFlags(using_lj_buffered_14_7=True), False),
    "disp_expansion": (FFlags(using_disp_expansion=True), False),
}
# the forms whose blocked energy runs on the mixture (SG, DREIDING, the
# buffered 14-7 and the dispersion expansion read other parameters)
RUN = ("lj", "lj_cavity", "fh4", "fh4_rd_only", "wolf", "wolf_rd_only",
       "buckingham", "waldman_hagler")




def _stand_in(dtype=torch.float64):
    """What ``takes`` reads of a state, as a CUDA state would show it."""
    return types.SimpleNamespace(pos=types.SimpleNamespace(
        device=torch.device("cuda"), dtype=dtype))


CARD = _stand_in()


@pytest.fixture(scope="module")
def state():
    return pair_system.build("cpu")[0]


@pytest.mark.parametrize("name", sorted(FORMS))
def test_takes(state, name):
    """K6 takes a float64 CUDA state under the forms it computes, and no
    float32 state and no CPU state under any form."""
    flags, want = FORMS[name]
    assert cuda_pairs.takes(CARD, flags) is want
    assert not cuda_pairs.takes(_stand_in(torch.float32), flags)
    assert not cuda_pairs.takes(state, flags)


def _counted(state, flags):
    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("refresh.energy"):
            eb = energy_breakdown_blocked(state, flags, pair_system.params())
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
    return eb, {k: v for k, v in counters.items() if v}


@pytest.mark.parametrize("name", RUN)
def test_blocked_energy_counts_pair_plain_on_cpu(state, name):
    """On CPU tensors every form takes the plain loop, counted once."""
    flags, _ = FORMS[name]
    assert not cuda_pairs.takes(state, flags)
    before = cuda_pairs.pair_sums.launches
    _, counters = _counted(state, flags)
    assert counters == {"pair_plain": {"refresh.energy": 1}}
    assert cuda_pairs.pair_sums.launches == before


@pytest.mark.parametrize("name", RUN)
def test_blocked_energy_counts_pair_kernel_where_it_applies(state, name,
                                                           monkeypatch):
    """With the CUDA device check stood in for, energy_breakdown_blocked
    calls the kernel's wrapper (here its plain version) and counts
    ``pair_kernel`` exactly where K6 computes the form, ``pair_plain``
    elsewhere, with the same breakdown either way."""
    flags, applies = FORMS[name]
    want, _ = _counted(state, flags)
    calls = []

    def wrapper(*args):
        calls.append(args)
        return pair_sums_plain(*args)

    wrapper.launches = 0
    takes = cuda_pairs.takes
    monkeypatch.setattr(cuda_pairs, "takes", lambda st, fl: takes(CARD, fl))
    monkeypatch.setattr(cuda_pairs, "pair_sums", wrapper)
    got, counters = _counted(state, flags)
    key = "pair_kernel" if applies else "pair_plain"
    assert counters == {key: {"refresh.energy": 1}}
    assert len(calls) == int(applies)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_pair_sums_refuses_cpu_tensors(state):
    """The wrapper takes what ``takes`` takes and nothing else: on CPU
    tensors it raises, launching nothing."""
    flags, params = pair_system.flags("fh4", cavity=True), \
        pair_system.params()
    before = cuda_pairs.pair_sums.launches
    with pytest.raises(ValueError, match="pair_sums_plain"):
        cuda_pairs.pair_sums(state, flags, params)
    assert cuda_pairs.pair_sums.launches == before


@pytest.mark.parametrize("block", [64, 100, 2048])
def test_pair_sums_plain_does_not_depend_on_the_tile(state, block):
    """Any row-tile partition visits every pair once: the sums agree with
    the 256-row tiles' to rounding, and the close check exactly."""
    flags, params = pair_system.flags("fh2", cavity=True), \
        pair_system.params()
    want = pair_sums_plain(state, flags, params)
    got = pair_sums_plain(state, flags, params, block)
    for a, b in zip(got[:2], want[:2]):
        assert abs(float(a - b)) <= 1e-12 * abs(float(b))
    assert bool(got[2]) and bool(want[2])


def test_the_mixture_has_what_the_kernel_test_needs(state):
    """The close pair is the only pair inside the absolute scale, so
    killing one of its molecules clears the check; the slot count is
    ragged against the kernel's 128-slot tile; there are dead slots in
    the middle and at the end, frozen molecules, and live neutral sites
    with LJ."""
    flags, params = pair_system.flags(cavity=True), pair_system.params()
    assert bool(pair_sums_plain(state, flags, params)[2])
    alive = state.mol_alive.clone()
    alive[3] = False
    cleared = state.replace(mol_alive=alive, aalive=alive[state.mol_id])
    assert not bool(pair_sums_plain(cleared, flags, params)[2])
    A = state.n_atom_slots
    assert A % 128 != 0 and A > 256
    dead = ~state.aalive
    assert bool(dead[:A // 2].any()) and bool(dead[-1])
    assert int(state.mol_frozen.sum()) == len(pair_system.FROZEN)
    neutral = state.aalive & (state.charge == 0.0) & (state.epsilon > 0.0)
    assert int(neutral.sum()) > 0
    assert bool((state.mass[neutral] == 0.0).all())
