"""A mesh of devices driven from one process, and the sharded state that
lives on it.

JAX twin: mpmcxx_tpu/parallel/meshing.py.  The twin places a carry on a
``jax.sharding.Mesh`` and lets XLA's SPMD partitioner derive the parallel
program from the input shardings; one process (a single controller) owns
every device.  Here too one process owns an ordered list of devices
(``Mesh``), but the sharded state is an explicit container and every
per-shard call is made by the caller, shard after shard:

* ``RowShards`` — an [A, A] plane as ``[R_d, A]`` row blocks, block d on
  ``mesh.devices[d]`` (the twin's ``NamedSharding(P(ax, None))``).  The
  chain's polar-cache planes split evenly (``shard_chain_carry``,
  ``Simulation(mesh=...)``, A % n == 0); the sharded energy's planes
  follow its padded row slices (parallel/sharded_energy.py).
* ``BeadShards`` — a PI bead stack as n sub-stacks of P/n beads, block d
  on ``mesh.devices[d]`` (``shard_pi_carry``, ``PISimulation(mesh=...)``,
  P % n == 0).

Only the O(A^2) planes and the bead stack shard.  The polar cache's [A, 3]
and [A, K] leaves (``e_pair``, ``cosp``, ``sinp``; the twin row-shards
them too), the PI carry's per-bead energies and structure factors, and
all control state stay on the leader, ``mesh.devices[0]``: they are O(A)
and no result depends on where they live.

The collectives are plain tensor ops on the leader: ``psum`` adds the
shards' partials in shard order (a deterministic sum), and the twin's
"place rows at their window start, then psum" is one concatenation of
the shards' row blocks in shard order (``gather_rows``).

A mesh may list one device several times: ``make_mesh(devices=["cpu"] *
8)`` is the counterpart of the twin's 8 virtual CPU devices
(tests/conftest.py), and ``["cuda:0"] * 4`` runs every row slice, sum and
sliced kernel launch of the mesh paths on one card.  Each per-shard call
runs under ``device_guard(shard_device)``, which makes that card current
for the kernels' ctypes launches.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices with one axis name; shard d is
    ``devices[d]`` and ``devices[0]`` is the leader."""
    devices: tuple
    axis: str = "shard"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def leader(self) -> torch.device:
        return self.devices[0]

    @property
    def shape(self) -> dict:
        """``{axis: n}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis: self.size}


def make_mesh(n_devices: int | None = None, axis: str = "shard",
              devices=None) -> Mesh:
    """A mesh of the first ``n_devices`` CUDA cards (all of them when
    None), as the twin takes ``jax.devices()[:n]``; or of ``devices``, a
    list that may repeat a device.  Raises RuntimeError for a CUDA device
    when CUDA is absent or the card does not exist."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "pass devices=['cpu'] * n")
        devices = [f"cuda:{i}" for i in range(count)]
        if n_devices is not None:
            devices = devices[:n_devices]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    devs = []
    for d in map(torch.device, devices):
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"make_mesh: {d} is not available: CUDA "
                                   "is absent")
            if d.index is None:                 # the tensors' own spelling
                d = torch.device("cuda", torch.cuda.current_device())
            if d.index >= torch.cuda.device_count():
                raise RuntimeError(f"make_mesh: no card {d}")
        elif d.type != "cpu":
            raise ValueError(f"make_mesh: unsupported device {d}")
        devs.append(d)
    if not devs:
        raise ValueError("make_mesh: no devices")
    return Mesh(tuple(devs), axis)


def device_guard(dev: torch.device):
    """The context that makes ``dev`` the current card (nothing on the
    CPU): the kernels' ctypes entry points launch on the calling thread's
    current device."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def psum(parts, mesh: Mesh):
    """The sum of the shards' partials on the leader, added in shard
    order."""
    out = parts[0].to(mesh.leader)
    for p in parts[1:]:
        out = out + p.to(mesh.leader)
    return out


def gather_rows(blocks, mesh: Mesh):
    """The shards' row blocks stacked in shard order on the leader."""
    return torch.cat([b.to(mesh.leader) for b in blocks], dim=0)


def even_rows(A: int, n: int) -> list:
    """``[(row0, R)]`` of the contiguous even split of A rows over n
    shards: shard d owns rows [d A/n, (d+1) A/n).  Raises the twin's
    ValueError when n does not divide A (meshing.py:69-78)."""
    if A % n:
        raise ValueError(
            f"atom capacity {A} not divisible by the {n}-device mesh")
    R = A // n
    return [(d * R, R) for d in range(n)]


def _arange(n: int, like: torch.Tensor):
    return torch.arange(n, dtype=like.dtype, device=like.device)


@dataclasses.dataclass
class RowShards:
    """An [A, A] plane split into row blocks: ``parts[d]`` is an [R_d, A]
    tensor on ``mesh.devices[d]`` holding global rows ``row0s[d] ..
    row0s[d] + R_d - 1``; the blocks cover [0, A) in shard order."""
    parts: tuple
    row0s: tuple
    mesh: Mesh

    @classmethod
    def split(cls, plane: torch.Tensor, mesh: Mesh, ranges=None):
        """Copies of ``plane``'s row blocks on their devices (the even
        split unless ``ranges`` gives ``[(row0, R)]``)."""
        ranges = ranges or even_rows(plane.shape[0], mesh.size)
        parts = tuple(plane[r0:r0 + R].to(dev, copy=True).contiguous()
                      for (r0, R), dev in zip(ranges, mesh.devices))
        return cls(parts, tuple(r0 for r0, _ in ranges), mesh)

    @property
    def shape(self) -> tuple:
        return (sum(p.shape[0] for p in self.parts), self.parts[0].shape[1])

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    def full(self) -> torch.Tensor:
        """The whole plane on the leader (checks only: the mesh paths
        never build it)."""
        return gather_rows(self.parts, self.mesh)

    def window_rows(self, start: torch.Tensor, S: int) -> torch.Tensor:
        """Rows ``start .. start+S-1`` (a 0-d device index; the window lies
        inside [0, A)) as an [S, A] tensor on the leader, taken from the one
        or two shards that hold them.  Each shard gives its clamped rows
        and a select keeps those it owns: no host read of ``start``."""
        lead = self.mesh.leader
        idx = start.to(lead) + _arange(S, start.to(lead))
        out = None
        for part, r0 in zip(self.parts, self.row0s):
            R = part.shape[0]
            local = idx.to(part.device) - r0
            rows = part.index_select(0, local.clamp(0, R - 1)).to(lead)
            if out is None:
                out = rows
            else:
                own = ((local >= 0) & (local < R)).to(lead)
                out = torch.where(own[:, None], rows, out)
        return out


def parts_of(x) -> list:
    """The tensors that hold ``x``: its row blocks, or ``[x]``."""
    return list(x.parts) if isinstance(x, RowShards) else [x]


def plane_row_balance(state, n_shards: int) -> np.ndarray:
    """Per-device live-atom counts for the contiguous row sharding of
    the [A, A] planes: device d owns rows [d*A/n, (d+1)*A/n).  The
    per-device SCF work is proportional to its live rows (dead
    capacity rows are masked zeros), so max/mean of this vector is the
    work-imbalance factor (meshing.py:93-102)."""
    alive = state.atom_alive().cpu().numpy()
    blocks = alive.reshape(n_shards, -1)
    return blocks.sum(axis=1)


def bead_balance(P_beads: int, n_shards: int) -> np.ndarray:
    """Beads per device for the PI bead sharding (exact by
    construction when P % n == 0; meshing.py:105-109)."""
    base = np.full(n_shards, P_beads // n_shards)
    base[: P_beads % n_shards] += 1
    return base


# ---------------------------------------------------------------------------
# the chain's carry: row-sharded polar-cache planes
# ---------------------------------------------------------------------------

PLANE_FIELDS = ("co", "cd", "dx", "dy", "dz")


def mesh_of(cache):
    """The mesh of a polar cache's row-sharded planes, or None."""
    if cache is None:
        return None
    for f in PLANE_FIELDS:
        p = getattr(cache, f)
        if isinstance(p, RowShards):
            return p.mesh
    return None


def shard_chain_carry(carry, mesh: Mesh):
    """The carry with its polar cache's [A, A] planes row-sharded evenly
    over ``mesh`` (copies: the chain writes the planes in place, so the
    carry passed in keeps its own), the cache's other leaves copied on
    the leader; a carry already on ``mesh`` is returned as it is, one
    without a cache unchanged (meshing.py:66-90).  Raises the twin's
    ValueError when n does not divide A."""
    A = carry.state.n_atom_slots
    even_rows(A, mesh.size)
    cache = carry.pcache
    if cache is None or mesh_of(cache) == mesh:
        return carry
    kw = {}
    for f in dataclasses.fields(cache):
        t = getattr(cache, f.name)
        if f.name in PLANE_FIELDS and t.numel():
            if isinstance(t, RowShards):
                t = t.full()
            kw[f.name] = RowShards.split(t, mesh)
        elif isinstance(t, RowShards):
            kw[f.name] = t
        else:
            kw[f.name] = t.to(mesh.leader, copy=True)
    return dataclasses.replace(carry, pcache=dataclasses.replace(cache,
                                                                 **kw))


def to_device(x, dev: torch.device):
    """``x`` (a tensor, a dataclass, a named tuple, a tuple or list of
    them) with every tensor on ``dev``, but a dataclass field named
    ``key``: the chain's random key lives on the host."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, RowShards):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: getattr(x, f.name) if f.name == "key" else
            to_device(getattr(x, f.name), dev)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, dev) for v in x)
    return x


# ---------------------------------------------------------------------------
# the PI carry: a bead-sharded stack
# ---------------------------------------------------------------------------

def check_beads(P_beads: int, mesh: Mesh) -> int:
    """Beads per shard; raises the twin's ValueError when n does not
    divide P (meshing.py:44-51)."""
    n = mesh.size
    if P_beads % n:
        raise ValueError(
            f"Trotter number {P_beads} not divisible by the "
            f"{n}-device mesh")
    return P_beads // n


@dataclasses.dataclass
class BeadShards:
    """A [P, ...] bead stack (a SystemState) as n sub-stacks: ``parts[d]``
    holds beads d P/n .. (d+1) P/n - 1 on ``mesh.devices[d]``."""
    parts: tuple
    mesh: Mesh

    @classmethod
    def split(cls, stack, mesh: Mesh):
        k = check_beads(stack.pos.shape[0], mesh)
        return cls(tuple(_bead_slice(stack, d * k, (d + 1) * k, dev)
                         for d, dev in enumerate(mesh.devices)), mesh)

    def whole(self):
        """The whole stack on the leader (the moves' and the outputs'
        view: a PI move is batched over the bead axis)."""
        return _cat_stacks(self.parts, self.mesh.leader)

    def with_fields(self, **fields):
        """These shards with the named [P, ...] leader tensors' bead
        blocks written to their devices."""
        k = self.parts[0].pos.shape[0]
        return dataclasses.replace(self, parts=tuple(
            part.replace(**{f: v[d * k:(d + 1) * k].to(part.pos.device)
                            for f, v in fields.items()})
            for d, part in enumerate(self.parts)))


def _map_state(state, fn):
    from ..pbc import PBC
    kw = {f.name: fn(getattr(state, f.name))
          for f in dataclasses.fields(state) if f.name != "pbc"}
    kw["pbc"] = PBC(**{f.name: fn(getattr(state.pbc, f.name))
                       for f in dataclasses.fields(PBC)})
    return type(state)(**kw)


def _bead_slice(stack, b0: int, b1: int, dev):
    return _map_state(stack, lambda t: t[b0:b1].to(dev, copy=True))


def _cat_stacks(parts, dev):
    from ..pbc import PBC
    first = parts[0]
    kw = {f.name: torch.cat([getattr(p, f.name).to(dev) for p in parts])
          for f in dataclasses.fields(first) if f.name != "pbc"}
    kw["pbc"] = PBC(**{f.name: torch.cat([getattr(p.pbc, f.name).to(dev)
                                          for p in parts])
                       for f in dataclasses.fields(PBC)})
    return type(first)(**kw)


def shard_pi_carry(carry, mesh: Mesh, P_beads: int):
    """The PI carry with its bead stack split over ``mesh``, one block of
    P/n beads per device (meshing.py:40-63); its per-bead energies and
    structure factors and the control state stay on the leader.  Raises
    the twin's ValueError when n does not divide P."""
    check_beads(P_beads, mesh)
    if isinstance(carry.stack, BeadShards):
        return carry
    return dataclasses.replace(carry,
                               stack=BeadShards.split(carry.stack, mesh))
