"""The benchmark's inputs: a bulk fluid of rigid molecules, started on a
lattice.

A configuration's ``model`` is the published molecule: its sites, each
with its offset along the molecule's axis and its PQR parameters.  Its
``geometry`` places ``molecules`` of them in a cubic box of side
``box``: the centres on a g^3 simple cubic lattice (g the smallest with
g^3 >= molecules, strided down to ``molecules`` points), jittered by
+-``jitter`` A, each axis uniform on the sphere, all drawn from the
geometry's ``seed``.  The lattice pitch keeps every pair of molecules
apart, so the start holds no overlap (tests/test_bench_inputs.py holds
each configuration to a least site-site distance).

Nothing here imports the program or the reference: both read what this
module makes, the program through the PQR file, the reference through
``site`` and the model.
"""

from __future__ import annotations

import numpy as np


def lattice(geo: dict) -> np.ndarray:
    """[molecules, 3] lattice centres in (-box/2, box/2)."""
    L, n = geo["box"], geo["molecules"]
    g = 1
    while g ** 3 < n:
        g += 1
    s = L / g
    pts = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                   axis=-1).reshape(-1, 3) * s + s / 2 - L / 2
    idx = np.linspace(0, len(pts) - 1, n).round().astype(int)
    return pts[idx]


def molecules(model: dict, geo: dict) -> np.ndarray:
    """[molecules, S, 3] site positions, rounded to the PQR writer's
    %8.3f."""
    rng = np.random.default_rng(geo["seed"])
    n = geo["molecules"]
    jit = geo["jitter"]
    coms = lattice(geo) + rng.uniform(-jit, jit, (n, 3))
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    offs = np.asarray([s["offset"] for s in model["sites"]],
                      dtype=np.float64)
    mols = coms[:, None, :] + offs[None, :, None] * u[:, None, :]
    return np.round(mols, 3)


def write_pqr(path: str, model: dict, mols) -> None:
    """The molecules as a 20-token PQR, charges in e."""
    moltype = model["moleculetype"]
    with open(path, "w") as f:
        i = 0
        for m in range(len(mols)):
            for site, s in enumerate(model["sites"]):
                p = mols[m, site]
                i += 1
                f.write(f"ATOM  {i:5d} {s['name']:<4s} {moltype:<3s} M "
                        f"{m + 1:4d}   "
                        f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f} "
                        f"{s['mass']:.5f} {s['charge']:8.5f} "
                        f"{s['alpha']:.5f} {s['epsilon']:.5f} "
                        f"{s['sigma']:.5f} 0.00000 0.00000\n")
        f.write("END\n")
