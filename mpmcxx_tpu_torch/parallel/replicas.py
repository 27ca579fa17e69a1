"""Replica chains and parallel tempering on one device.

JAX twin: mpmcxx_tpu/parallel/replicas.py.  The reference's only
data-parallelism is MPI replica chains: every rank runs an independent
Markov chain and rank 0 gathers the statistics every corrtime
(src/System.MonteCarlo.cpp:213-248, 1902-2028).  The twin vmaps R chains
over a leading ``[R]`` axis; here the R replicas are a list of carries
whose chunks run one after the other on the device, each through the
single chain's runner (``mc.chain.make_chunk_runner``) with its own
molecule topology.  Each replica owns its tensors: the chain writes its
polarization planes in place, so no two replicas may share storage.
Replica ``i`` draws from ``fold_in(PRNGKey(seed), i)``, as in the twin,
so each replica's trajectory is that of one independent chain.

Parallel tempering — designed but disabled in the reference
(src/System.MonteCarlo.cpp:1767-1897 commented out) — permutes the
replicas' temperatures over a geometric ladder; the swap is a host
computation on R numbers.  On a mesh (``mesh=``, parallel/meshing.py)
replica i lives on device i % n, where the twin shards the [R] axis over
the mesh; the replicas still take turns, so launches on different cards
overlap.
"""

from __future__ import annotations

import collections
import copy
import dataclasses

import numpy as np
import torch

from .. import random as rnd
from ..flags import FFlags, RunParams
from ..mc import chain as chain_mod
from ..state import topology
from . import meshing


def make_mesh(n_devices: int | None = None, axis: str = "replica",
              devices=None) -> meshing.Mesh:
    """meshing.make_mesh with the replica axis (replicas.py:30-35)."""
    return meshing.make_mesh(n_devices, axis, devices)


def replica_device(mesh: meshing.Mesh, r: int) -> torch.device:
    """The device of replica ``r`` on ``mesh``: mesh.devices[r % n]."""
    return mesh.devices[r % mesh.size]


def caches_per_device(mesh, n_replicas: int) -> int:
    """The most replicas (so polar caches) that one card of ``mesh``
    holds; all of them without a mesh."""
    if mesh is None:
        return n_replicas
    return max(collections.Counter(replica_device(mesh, r)
                                   for r in range(n_replicas)).values())


def replicate_carry(carry: chain_mod.MCCarry, n_replicas: int,
                    base_seed: int = 0) -> list:
    """R deep copies of a single-chain carry, each owning its tensors
    (the twin's broadcast view would let one replica's in-place plane
    writes reach another's), with independent random streams
    (replicas.py:38-49): replica ``i``'s key is
    ``fold_in(PRNGKey(base_seed), i)``."""
    base = rnd.PRNGKey(base_seed)
    return [dataclasses.replace(copy.deepcopy(carry),
                                key=rnd.fold_in(base, i))
            for i in range(n_replicas)]


def make_replica_runner(flags: FFlags, params: RunParams,
                        opts: chain_mod.MCOptions, chunk_steps: int,
                        mesh=None, axis: str | None = None):
    """``run(carries) -> (carries, [StepOut])``: one ``chunk_steps``-move
    chunk of each replica, one replica after the other
    (replicas.py:52-67).  Each replica runs with its own molecule
    topology (``state.topology``), taken from its carry at the first call:
    a replica's slot layout is fixed between regrowths.  On a ``mesh``
    replica r runs on ``replica_device(mesh, r)`` (its carry moved there
    first if it lives elsewhere); ``axis``, when given, must be the
    mesh's."""
    if mesh is not None and axis is not None and axis != mesh.axis:
        raise ValueError(f"make_replica_runner: the mesh's axis is "
                         f"{mesh.axis!r}, not {axis!r}")
    runners = {}

    def run(carries):
        new, outs = [], []
        for r, carry in enumerate(carries):
            if r not in runners:
                runners[r] = chain_mod.make_chunk_runner(
                    flags, params, opts, chunk_steps,
                    topology=topology(carry.state))
            if mesh is None:
                carry, out = runners[r](carry)
            else:
                dev = replica_device(mesh, r)
                with meshing.device_guard(dev):
                    if carry.state.pos.device != dev:
                        carry = meshing.to_device(carry, dev)
                    carry, out = runners[r](carry)
            new.append(carry)
            outs.append(out)
        return new, outs

    return run


# ---------------------------------------------------------------------------
# parallel tempering
# ---------------------------------------------------------------------------

def temperature_ladder(t_min: float, t_max: float, n: int) -> np.ndarray:
    """Geometric temperature ladder, float64 (replicas.py:75-82)."""
    if n == 1:
        return np.asarray([t_min], dtype=np.float64)
    ratio = (t_max / t_min) ** (1.0 / (n - 1))
    return t_min * ratio ** np.arange(n, dtype=np.float64)


def tempering_swap(temperatures, energies, key: torch.Tensor, parity: int):
    """One alternating-parity neighbor-swap sweep over the ladder
    (replicas.py:85-112), on the host.

    Swap (i, i+1) accepted with exp((1/T_i - 1/T_j)(E_i - E_j)); swaps
    exchange the replica *temperatures* (chains keep their
    configurations), matching the reference's temper_system design
    (src/System.MonteCarlo.cpp:1790-1880).  The uniforms are the twin's
    ``jax.random.uniform(key, (R,))`` bit for bit.

    Returns (new_temperatures, swapped_mask) as numpy arrays."""
    temperatures = np.asarray(temperatures, dtype=np.float64)
    energies = np.asarray(energies, dtype=np.float64)
    R = temperatures.shape[0]
    idx = np.arange(R)
    is_left = (idx % 2 == parity) & (idx + 1 < R)
    right = np.clip(idx + 1, 0, R - 1)

    beta_i = 1.0 / temperatures
    beta_j = 1.0 / temperatures[right]
    with np.errstate(over="ignore", invalid="ignore"):
        factor = np.exp((beta_i - beta_j) * (energies - energies[right]))
    u = rnd.uniform(key.cpu(), (R,), torch.float64).numpy()
    do_swap = is_left & (u < factor)

    # the permutation: i <-> i+1 where do_swap[i]
    perm = np.where(do_swap, idx + 1, idx)
    swap_from_left = np.roll(do_swap, 1) & (idx > 0)
    perm = np.where(swap_from_left, idx - 1, perm)
    return temperatures[perm], do_swap
