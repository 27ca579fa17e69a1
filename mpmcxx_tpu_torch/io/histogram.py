"""3-D population histogram + OpenDX writer.

JAX twin: mpmcxx_tpu/io/histogram.py (a copy; numpy on the host:
``write_frozen_dx`` copies the state's tensors there).
Fractional-coordinate binning of sorbate molecule COMs with a
per-corrtime grid accumulated into a root grid and emitted in OpenDX
format (src/System.Histogram.cpp:8-408).  The reference's triple-pointer
int grid and per-molecule loops become one vectorised numpy
histogramdd-style binning.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import constants as const


@dataclasses.dataclass
class PopulationHistogram:
    basis: np.ndarray          # [3,3]
    resolution: float
    dims: tuple = None
    grid: np.ndarray = None    # per-corrtime grid
    avg_grid: np.ndarray = None
    norm_total: int = 0

    def __post_init__(self):
        mags = np.linalg.norm(self.basis, axis=1)
        dims = np.rint(mags / self.resolution).astype(int)
        dims = np.maximum(dims, 1)
        self.dims = tuple(dims)
        self.grid = np.zeros(self.dims, dtype=np.int64)
        self.avg_grid = np.zeros(self.dims, dtype=np.int64)

    @property
    def n_bins(self) -> int:
        return int(np.prod(self.dims))

    def zero(self):
        self.grid[:] = 0

    def accumulate(self, coms: np.ndarray, frozen_mask: np.ndarray):
        """Bin non-frozen molecule COMs (population_histogram,
        src/System.Histogram.cpp:190-211 + compute_bin :131-158)."""
        recip = np.linalg.inv(self.basis)
        pts = coms[~frozen_mask]
        frac = pts @ recip
        frac = frac - np.rint(frac)          # wrap1coord
        frac = frac + 0.5
        bins = np.floor(frac * np.asarray(self.dims)).astype(int)
        bins = np.clip(bins, 0, np.asarray(self.dims) - 1)
        np.add.at(self.grid, tuple(bins.T), 1)

    def update_root(self):
        """(update_root_histogram, src/System.Histogram.cpp:91-107)"""
        self.avg_grid += self.grid
        self.norm_total += int(self.grid.sum())

    def write_dx(self, f):
        """(write_histogram, src/System.Histogram.cpp:213-259)"""
        xd, yd, zd = self.dims
        # origin at frac (-0.5,-0.5,-0.5) offset by half a bin
        half = 0.5 / np.asarray(self.dims)
        origin = (np.asarray([-0.5, -0.5, -0.5]) + half) @ self.basis
        delta = self.basis / np.asarray(self.dims)[:, None]

        f.seek(0)
        f.write("# OpenDX format population histogram\n")
        f.write(f"object 1 class gridpositions counts {xd} {yd} {zd}\n")
        f.write(f"origin\t{origin[0]:f}\t{origin[1]:f}\t{origin[2]:f}\n")
        for i in range(3):
            f.write(f"delta \t{delta[i][0]:f}\t{delta[i][1]:f}"
                    f"\t{delta[i][2]:f}\n")
        f.write("\n")
        f.write(f"object 2 class gridconnections counts {xd} {yd} {zd}\n\n")
        f.write(f"object 3 class array type float rank 0 items "
                f"{self.n_bins} data follows\n")
        norm = max(self.norm_total, 1)
        count = 0
        for i in range(xd):
            for j in range(yd):
                row = self.avg_grid[i, j]
                f.write("".join(f"{v / norm:f} " for v in row) + "\n")
                count += int(row.sum())
            f.write("\n")
        f.write(f"# count={count}\n")
        f.write('attribute "dep" string "positions"\n')
        f.write('object "regular positions regular connections" '
                'class field\n')
        f.write('component "positions" value 1\n')
        f.write('component "connections" value 2\n')
        f.write('component "data" value 3\n')
        f.write("\nend\n")
        f.flush()


def write_frozen_dx(f, state, meta, max_bondlength: float = 0.0):
    """Frozen-lattice OpenDX molecule file with mass-heuristic bonds
    (write_frozen src/System.Output.cpp:85-116, bondlength_check
    src/System.cpp:1487-1532)."""
    def host(t):
        return t.detach().cpu().numpy()

    pos = host(state.pos)
    frozen = host(state.frozen) & host(state.atom_alive())
    idx = np.nonzero(frozen)[0]
    n = len(idx)
    mass = host(state.mass)
    mol_id = host(state.mol_id)

    # bonds pair atoms WITHIN one frozen molecule only (calculate_bonds
    # walks atom2 from atom->next inside the same Molecule,
    # src/System.cpp:1487-1510); indices are global frozen-atom indices
    bonds = []
    slope, yint = 0.0234, 0.603
    for a in range(n):
        for b in range(a + 1, n):
            i, j = idx[a], idx[b]
            if mol_id[i] != mol_id[j]:
                continue
            gm = np.sqrt(mass[i] * mass[j])
            d = np.linalg.norm(pos[i] - pos[j])
            if d < (gm * slope + yint) * max_bondlength:
                bonds.append((a, b))

    f.write("# OpenDX format coordinate file for frozen atoms\n")
    f.write(f"object 1 class array type float rank 1 shape 3 items {n} "
            "data follows\n")
    for i in idx:
        f.write(f"{pos[i][0]:f} {pos[i][1]:f} {pos[i][2]:f}\n")
    f.write(f"object 2 class array type int rank 1 shape 2 items "
            f"{len(bonds)} data follows\n")
    for a, b in bonds:
        f.write(f"{a} {b}\n")
    f.write('attribute "element type" string "lines"\n')
    f.write('attribute "ref" string "positions"\n')
    f.write(f"object 3 class array type float rank 0 items {n} "
            "data follows\n")
    for i in idx:
        f.write(f"{mass[i]:f}\n")
    f.write('attribute "dep" string "positions"\n')
    # object 4: per-atom display colors from the mass heuristic
    # (print_frozen_colors, src/System.Output.cpp:209-244)
    f.write(f"object 4 class array type float rank 1 shape 3 items {n} "
            "data follows\n")
    for i in idx:
        m = mass[i]
        if m < 1.1:
            f.write("0.2 0.2 0.2\n")
        elif m < 12.2:
            f.write("0.1 0.5 0.1\n")
        elif m < 14.1:
            f.write("0.2 0.2 1.0\n")
        elif m < 16.1:
            f.write("1.0 0.0 0.0\n")
        else:
            f.write("0.1 0.1 0.1\n")
    f.write('object "irregular positions irregular connections" '
            'class field\n')
    f.write('component "positions" value 1\n')
    f.write('component "connections" value 2\n')
    f.write('component "data" value 3\n')
    f.write('component "colors" value 4\n')
    f.write("end\n")
    f.flush()
