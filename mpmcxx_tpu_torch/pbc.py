"""Triclinic periodic boundary conditions.

JAX twin: mpmcxx_tpu/pbc.py.  The box is a 3x3 basis matrix (rows =
lattice vectors); fractional coordinates are ``frac = cart @ reciprocal``
(src/PeriodicBoundary.cpp:83-101) and the interaction cutoff is half the
shortest lattice vector found by brute coefficient search
(src/PeriodicBoundary.cpp:40-66).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAX_VECT_COEF = 15


def basis_volume(basis):
    """det of the 3x3 basis via the scalar triple product
    (src/PeriodicBoundary.cpp:71-78)."""
    return torch.dot(basis[0], torch.linalg.cross(basis[1], basis[2]))


def reciprocal_basis(basis):
    """inv(basis) as the reference's cofactor matrix
    (src/PeriodicBoundary.cpp:83-101)."""
    b = basis
    cof = torch.stack([
        torch.linalg.cross(b[1], b[2]),
        torch.linalg.cross(b[2], b[0]),
        torch.linalg.cross(b[0], b[1]),
    ], dim=1)  # columns are cofactor vectors -> inv = cof / det
    return cof / basis_volume(b)


def shortest_half_vector(basis):
    """Cutoff = half the shortest nonzero lattice vector (brute search)."""
    rng = np.arange(-MAX_VECT_COEF, MAX_VECT_COEF + 1)
    coefs = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    coefs = coefs[np.any(coefs != 0, axis=1)]
    coefs = torch.as_tensor(coefs, dtype=basis.dtype, device=basis.device)
    vecs = coefs @ basis
    return 0.5 * torch.min(torch.sqrt(torch.sum(vecs * vecs, dim=-1)))


@dataclasses.dataclass
class PBC:
    """Periodic boundary state: basis, reciprocal, volume, cutoff (0-d)."""

    basis: torch.Tensor       # [3,3] rows are lattice vectors a,b,c
    reciprocal: torch.Tensor  # [3,3] such that frac = cart @ reciprocal
    volume: torch.Tensor      # scalar
    cutoff: torch.Tensor      # scalar

    @classmethod
    def from_basis(cls, basis: torch.Tensor) -> "PBC":
        return cls(basis=basis, reciprocal=reciprocal_basis(basis),
                   volume=basis_volume(basis),
                   cutoff=shortest_half_vector(basis))

    def scale(self, factor) -> "PBC":
        """The box scaled isotropically by ``factor`` (NPT volume move,
        pbc.py:94-105): the cutoff scales with the basis."""
        return PBC(basis=self.basis * factor,
                   reciprocal=self.reciprocal / factor,
                   volume=self.volume * factor ** 3,
                   cutoff=self.cutoff * factor)


def _mul3(d, M):
    """``d[..., p] @ M[p, q]`` written as three multiply-adds in the JAX
    twin's order, so both packages round alike."""
    return d[..., 0:1] * M[0] + d[..., 1:2] * M[1] + d[..., 2:3] * M[2]


def minimum_image_disp(d, basis, reciprocal):
    """Minimum-image displacement ``d[..., 3]`` and its norm
    (src/System.cpp:1202-1279)."""
    img = torch.round(_mul3(d, reciprocal))
    di = d - _mul3(img, basis)
    return di, torch.sqrt(torch.sum(di * di, dim=-1))


def wrap_positions(pos, basis, reciprocal):
    """Positions ``pos[..., 3]`` wrapped into the central cell, centred on
    the origin: each minimum-imaged against the origin (pbc.py:131-137)."""
    return minimum_image_disp(pos, basis, reciprocal)[0]


def cart_to_frac(cart, reciprocal):
    return _mul3(cart, reciprocal)


def frac_to_cart(frac, basis):
    return _mul3(frac, basis)
