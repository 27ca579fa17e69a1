"""Hand-written CUDA kernels of the polarization path, with their plain
PyTorch versions and launch counts.

JAX twin: mpmcxx_tpu/ops/pallas_polar.py.

- K1 ``contract_planes`` (csrc/contract_planes.cu) replaces
  ``contract_pallas_sym`` and ``contract_pallas``: ``-T mu`` over the full
  f32 SCF planes, no symmetry assumed.  Bound by device-memory bytes
  (1.52 GB per call in mode 3 at A = 11,264).
- K4 ``contract_planes_tri`` (csrc/contract_planes_tri.cu) replaces
  ``contract_pallas_tri``: the same ``-T mu`` for symmetric T, reading each
  unordered 64 x 64 tile pair once (about half of K1's bytes).
- K2 ``write_plane_strips`` (csrc/write_plane_strips.cu) replaces
  ``write_columns_pallas`` and the row update of
  ``polar_cache.write_symmetric_rows``: the commit's row and column strips
  on every plane in one launch.  Bound by launch latency.

Each wrapper runs its plain version only for CPU tensors.  For CUDA
tensors it launches the kernel or raises: on a wrong dtype, shape or
contiguity, when the build fails, and when the launch reports an error.
Each wrapper's ``launches`` attribute counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels


def _void_ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() for t in tensors])


def _check_cuda_f32(name, t, shape):
    if t.device.type != "cuda" or t.dtype != torch.float32 or \
            not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want a contiguous float32 CUDA tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


# --------------------------------------------------------------------------
# K1: SCF contraction
# --------------------------------------------------------------------------

def _unfold(planes, l: float):
    """(co or None, cd, dx, dy, dz) of a 3-, 4- or 5-plane tuple; mode 3
    recomputes (co, cd) from the masked displacements, mode 4 has no co
    (s = -(s . mu))."""
    from .polar import coeffs_from_d
    if len(planes) == 3:
        dx, dy, dz = planes
        co, cd = coeffs_from_d(dx, dy, dz, l)
        return co, cd, dx, dy, dz
    co = planes[0] if len(planes) == 5 else None
    return (co,) + tuple(planes[-4:])


def _t_mu(terms, m, dim: int):
    """Sum over axis ``dim`` of T_ij m, f32: m [n,3] is the mu of the
    columns (dim 1, row sums) or of the rows (dim 0, column sums)."""
    co, cd, dx, dy, dz = terms
    shape = (1, -1) if dim == 1 else (-1, 1)
    mx, my, mz = (m[:, k].reshape(shape) for k in range(3))
    dot = dx * mx + dy * my + dz * mz
    s = -dot if co is None else co * dot
    return torch.stack([torch.sum(s * dx + cd * mx, dim=dim),
                        torch.sum(s * dy + cd * my, dim=dim),
                        torch.sum(s * dz + cd * mz, dim=dim)], dim=1)


def contract_planes_plain(planes, mu, l: float = 0.0):
    """Eager form of polar.contract_mixed (polar.py:884-897): ``-T mu`` in
    f32 over the 3-, 4- or 5-plane tuple, returned as [A,3] f64.  It is the
    reference of both K1 and K4 on the card."""
    return -_t_mu(_unfold(planes, l), mu.to(torch.float32), 1).to(
        torch.float64)


def contract_planes(planes, mu, l: float = 0.0):
    """``-T mu`` over square f32 planes (3: masked d with in-kernel
    coefficients from damping width ``l``; 4: (cd, s); 5: (co, cd, d)),
    mu [A,3]; returns [A,3] f64."""
    if _on_cpu(planes[0]):
        return contract_planes_plain(planes, mu, l)
    mode = len(planes)
    A = planes[0].shape[0]
    if mode not in (3, 4, 5):
        raise ValueError(f"contract_planes: {mode} planes")
    for p in planes:
        _check_cuda_f32("contract_planes plane", p, (A, A))
    if tuple(mu.shape) != (A, 3) or mu.device != planes[0].device:
        raise ValueError(f"contract_planes: mu {tuple(mu.shape)} on "
                         f"{mu.device} for {A}x{A} planes")
    lib = kernels.load()
    m = mu.to(torch.float32).t().contiguous()          # [3, A] SoA
    out = torch.empty((A, 3), dtype=torch.float32, device=mu.device)
    rc = lib.mpmcxx_contract_planes(
        _void_ptrs(planes), mode, m.data_ptr(), l, out.data_ptr(), A,
        torch.cuda.current_stream(mu.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"contract_planes launch failed: CUDA error {rc}")
    contract_planes.launches += 1
    return -out.to(torch.float64)


contract_planes.launches = 0


# --------------------------------------------------------------------------
# K4: SCF contraction over the tile triangle
# --------------------------------------------------------------------------

TRI_TILE = 64     # the kernel's b (csrc/contract_planes_tri.cu kTile)


def contract_planes_tri_plain(planes, mu, l: float = 0.0):
    """K4's schedule in PyTorch: ``-T mu`` for symmetric T from the
    TRI_TILE x TRI_TILE tile pairs I <= J only, [A,3] f64.  Tile (I, J)
    adds its row sums (T_ij mu_j) to slot J of the rows of I and, off the
    diagonal, its column sums (T_ji mu_i = T_ij mu_i) to slot I of the
    columns of J; the nr slots of each atom are then added.  The last tile
    is ragged when TRI_TILE does not divide A."""
    A = planes[0].shape[0]
    b = TRI_TILE
    nr = -(-A // b)
    m = mu.to(torch.float32)
    part = torch.zeros((nr, A, 3), dtype=torch.float32, device=mu.device)
    for I in range(nr):
        ri = slice(I * b, min(A, (I + 1) * b))
        for J in range(I, nr):
            cj = slice(J * b, min(A, (J + 1) * b))
            terms = _unfold(tuple(p[ri, cj] for p in planes), l)
            part[J, ri] = _t_mu(terms, m[cj], 1)
            if J != I:
                part[I, cj] = _t_mu(terms, m[ri], 0)
    return -part.sum(dim=0).to(torch.float64)


def contract_planes_tri(planes, mu, l: float = 0.0):
    """``-T mu`` over square f32 planes of a symmetric T (antisymmetric d,
    symmetric co and cd; the modes of contract_planes), mu [A,3]; returns
    [A,3] f64.  Any A: the kernel masks the ragged last tile."""
    if _on_cpu(planes[0]):
        return contract_planes_tri_plain(planes, mu, l)
    mode = len(planes)
    A = planes[0].shape[0]
    if mode not in (3, 4, 5):
        raise ValueError(f"contract_planes_tri: {mode} planes")
    for p in planes:
        _check_cuda_f32("contract_planes_tri plane", p, (A, A))
    if tuple(mu.shape) != (A, 3) or mu.device != planes[0].device:
        raise ValueError(f"contract_planes_tri: mu {tuple(mu.shape)} on "
                         f"{mu.device} for {A}x{A} planes")
    lib = kernels.load()
    m = mu.to(torch.float32).t().contiguous()          # [3, A] SoA
    nr = -(-A // TRI_TILE)
    scratch = torch.empty((nr, A, 3), dtype=torch.float32, device=mu.device)
    out = torch.empty((A, 3), dtype=torch.float32, device=mu.device)
    rc = lib.mpmcxx_contract_planes_tri(
        _void_ptrs(planes), mode, m.data_ptr(), l, scratch.data_ptr(),
        out.data_ptr(), A, torch.cuda.current_stream(mu.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"contract_planes_tri launch failed: CUDA error {rc}")
    contract_planes_tri.launches += 1
    return -out.to(torch.float64)


contract_planes_tri.launches = 0


# --------------------------------------------------------------------------
# K2: commit row + column strips
# --------------------------------------------------------------------------

def write_plane_strips_plain(planes, blend, cols, start):
    """The row update then the column-by-column loop of
    polar_cache.write_symmetric_rows (polar_cache.py:199-201, 221-224),
    in place on each plane."""
    S = blend.shape[1]
    idx = start + torch.arange(S, dtype=torch.int64, device=start.device)
    for p, plane in enumerate(planes):
        plane.index_copy_(0, idx, blend[p])
        for s in range(S):
            plane.index_copy_(1, idx[s:s + 1], cols[p, s][:, None])


def write_plane_strips(planes, blend, cols, start):
    """In place on each [A,A] f32 plane: rows start..start+S-1 from
    ``blend[p]`` and columns start..start+S-1 from ``cols[p]`` (both
    [P,S,A]), the columns winning inside the S x S window.  ``start`` is a
    0-d integer tensor on the planes' device."""
    if _on_cpu(planes[0]):
        return write_plane_strips_plain(planes, blend, cols, start)
    A = planes[0].shape[0]
    P, S = blend.shape[0], blend.shape[1]
    if P != len(planes) or not 1 <= S <= A:
        raise ValueError(f"write_plane_strips: {P}x{S} strips for "
                         f"{len(planes)} planes of {A} rows")
    for p in planes:
        _check_cuda_f32("write_plane_strips plane", p, (A, A))
    _check_cuda_f32("write_plane_strips blend", blend, (P, S, A))
    _check_cuda_f32("write_plane_strips cols", cols, (P, S, A))
    if start.dim() != 0 or start.device != planes[0].device:
        raise ValueError("write_plane_strips: start must be a 0-d tensor "
                         "on the planes' device")
    lib = kernels.load()
    start32 = start.to(torch.int32)
    rc = lib.mpmcxx_write_plane_strips(
        _void_ptrs(planes), P, blend.data_ptr(), cols.data_ptr(),
        start32.data_ptr(), S, A,
        torch.cuda.current_stream(blend.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"write_plane_strips launch failed: CUDA error {rc}")
    write_plane_strips.launches += 1


write_plane_strips.launches = 0
