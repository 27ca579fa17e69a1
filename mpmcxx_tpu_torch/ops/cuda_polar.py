"""Hand-written CUDA kernels of the polarization path, with their plain
PyTorch versions and launch counts.

JAX twin: mpmcxx_tpu/ops/pallas_polar.py.

- K1 ``contract_planes`` (csrc/contract_planes.cu) replaces
  ``contract_pallas`` and serves the XLA branch of the JAX switch:
  ``-T mu`` over [R, A] f32 planes (square, or a slice of rows), no
  symmetry assumed, on persistent blocks fed through a ring of
  asynchronous copies.  Bound by device-memory bytes (1.39 GB per call in
  mode 3 at A = 10,752).
- K5 ``contract_planes_sym`` (csrc/contract_planes_sym.cu) replaces
  ``contract_pallas_sym``, the default schedule: the same ``-T mu`` for
  symmetric T over B2's wrapped-column tile pairing, each unordered
  64 x 64 tile pair read once, through a ring of asynchronous copies.
- K4 ``contract_planes_tri`` (csrc/contract_planes_tri.cu) replaces
  ``contract_pallas_tri``: the same ``-T mu`` for symmetric T, reading each
  unordered 64 x 64 tile pair once (about half of K1's bytes).
- K2 ``write_plane_strips`` (csrc/write_plane_strips.cu) replaces
  ``write_columns_pallas`` and the row update of
  ``polar_cache.write_symmetric_rows``: the commit's row and column strips
  on every plane in one launch, on whole planes or on one shard's row
  slices of row-sharded planes.  Bound by launch latency.

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

def contract_planes_plain(planes, mu, l: float = 0.0):
    """Eager form of polar.contract_mixed (polar.py:884-897): ``-T mu`` in
    f32 over the 3-, 4- or 5-plane tuple of [R,A] planes (square, or a
    slice of rows) with mu [A,3], returned as [R,3] f64.  It is the
    reference of K1, K4 and K5 on the card, and what K5's wrapper runs on
    CPU tensors."""
    from .polar import expand_planes, plane_sums
    return -plane_sums(expand_planes(planes, l), mu.to(torch.float32),
                       1).to(torch.float64)


def contract_planes(planes, mu, l: float = 0.0):
    """``-T mu`` over [R,A] f32 planes, square or a slice of rows, with no
    symmetry assumed (3: masked d with in-kernel coefficients from damping
    width ``l``; 4: (cd, s); 5: (co, cd, d)), mu [A,3]; returns [R,3]
    f64."""
    if _on_cpu(planes[0]):
        return contract_planes_plain(planes, mu, l)
    mode = len(planes)
    if mode not in (3, 4, 5):
        raise ValueError(f"contract_planes: {mode} planes")
    R, A = planes[0].shape if planes[0].dim() == 2 else (0, 0)
    if R < 1 or A < 1:
        raise ValueError(f"contract_planes: planes of shape "
                         f"{tuple(planes[0].shape)}")
    for p in planes:
        _check_cuda_f32("contract_planes plane", p, (R, A))
    if tuple(mu.shape) != (A, 3) or mu.device != planes[0].device:
        raise ValueError(f"contract_planes: mu {tuple(mu.shape)} on "
                         f"{mu.device} for {R}x{A} planes")
    lib = kernels.load()
    m = mu.to(torch.float64).contiguous()
    ptrs = _void_ptrs(planes)
    slots = lib.mpmcxx_contract_planes_slots(ptrs, mode, m.data_ptr(), R, A)
    if slots <= 0:
        raise RuntimeError("contract_planes: no launch configuration for "
                           f"mode {mode}, {R}x{A} planes")
    work = torch.empty((slots, R, 3), dtype=torch.float32, device=mu.device)
    out = torch.empty((R, 3), dtype=torch.float64, device=mu.device)
    rc = lib.mpmcxx_contract_planes(
        ptrs, mode, m.data_ptr(), l, work.data_ptr(), slots, out.data_ptr(),
        R, A, torch.cuda.current_stream(mu.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"contract_planes launch failed: CUDA error {rc}")
    contract_planes.launches += 1
    return out


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
    from .polar import expand_planes, plane_sums
    b = TRI_TILE
    nr = -(-A // b)
    m = mu.to(torch.float32)
    part = torch.zeros((nr, A, 3), dtype=torch.float32, device=mu.device)
    for I in range(nr):
        ri = slice(I * b, min(A, (I + 1) * b))
        for J in range(I, nr):
            cj = slice(J * b, min(A, (J + 1) * b))
            terms = expand_planes(tuple(p[ri, cj] for p in planes), l)
            part[J, ri] = plane_sums(terms, m[cj], 1)
            if J != I:
                part[I, cj] = plane_sums(terms, m[ri], 0)
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
# K5: SCF contraction over B2's wrapped-column tile pairs
# --------------------------------------------------------------------------

SYM_TILE = 64     # the kernel's b (csrc/contract_planes_sym.cu kTile)


def contract_planes_sym_plain(planes, mu, l: float = 0.0):
    """K5's schedule in PyTorch: ``-T mu`` for symmetric T, [A,3] f64,
    with A a multiple of SYM_TILE.  Row tile I is paired with the column
    tiles J = (I + c) mod nr for c = 0 .. nr // 2; when nr is even the
    c = nr/2 band is read from I < nr/2 only, so each unordered tile pair
    is read once.  Tile (I, c) adds its row sums (T_ij mu_j) to the rows
    of I and, for c > 0, its column sums (T_ji mu_i = T_ij mu_i) to slot c
    of the columns of J; the slots are then added."""
    from .polar import expand_planes, plane_sums
    A = planes[0].shape[0]
    b = SYM_TILE
    if A % b:
        raise ValueError(f"contract_planes_sym_plain: A = {A} is not a "
                         f"multiple of {b}")
    nr = A // b
    half = nr // 2
    m = mu.to(torch.float32)
    part = torch.zeros((half + 1, A, 3), dtype=torch.float32,
                       device=mu.device)
    for I in range(nr):
        ri = slice(I * b, (I + 1) * b)
        for c in range(half if nr % 2 == 0 and I >= half else half + 1):
            J = (I + c) % nr
            cj = slice(J * b, (J + 1) * b)
            terms = expand_planes(tuple(p[ri, cj] for p in planes), l)
            part[0, ri] += plane_sums(terms, m[cj], 1)
            if c:
                part[c, cj] = plane_sums(terms, m[ri], 0)
    return -part.sum(dim=0).to(torch.float64)


def contract_planes_sym(planes, mu, l: float = 0.0):
    """``-T mu`` over square f32 planes of a symmetric T (antisymmetric d,
    symmetric co and cd; the modes of contract_planes) with A a multiple
    of SYM_TILE, mu [A,3]; returns [A,3] f64.  On CPU tensors it runs
    contract_planes_plain."""
    if _on_cpu(planes[0]):
        return contract_planes_plain(planes, mu, l)
    mode = len(planes)
    A = planes[0].shape[0]
    if mode not in (3, 4, 5):
        raise ValueError(f"contract_planes_sym: {mode} planes")
    if A == 0 or A % SYM_TILE:
        raise ValueError(f"contract_planes_sym: A = {A} is not a positive "
                         f"multiple of {SYM_TILE}")
    for p in planes:
        _check_cuda_f32("contract_planes_sym plane", p, (A, A))
        if p.data_ptr() % 16:
            raise ValueError("contract_planes_sym: planes must be 16-byte "
                             "aligned")
    if tuple(mu.shape) != (A, 3) or mu.device != planes[0].device:
        raise ValueError(f"contract_planes_sym: mu {tuple(mu.shape)} on "
                         f"{mu.device} for {A}x{A} planes")
    lib = kernels.load()
    slots = lib.mpmcxx_contract_planes_sym_slots(mode, A)
    if slots <= 0:
        raise RuntimeError("contract_planes_sym: no launch configuration "
                           f"for mode {mode}, A = {A}")
    m = mu.to(torch.float64).contiguous()
    # mu's f32 [3, A] copy, then the row and column slots
    work = torch.empty((slots, A, 3), dtype=torch.float32, device=mu.device)
    out = torch.empty((A, 3), dtype=torch.float64, device=mu.device)
    rc = lib.mpmcxx_contract_planes_sym(
        _void_ptrs(planes), mode, m.data_ptr(), l, work.data_ptr(), slots,
        out.data_ptr(), A, torch.cuda.current_stream(mu.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"contract_planes_sym launch failed: CUDA error {rc}")
    contract_planes_sym.launches += 1
    return out


contract_planes_sym.launches = 0


# --------------------------------------------------------------------------
# K2: commit row + column strips
# --------------------------------------------------------------------------

def write_plane_strips_plain(planes, blend, cols, start, row0: int = 0):
    """The row update then the column-by-column loop of
    polar_cache.write_symmetric_rows (polar_cache.py:199-201, 221-224),
    in place on each plane.  A plane may be the [R, A] slice of global
    rows row0 .. row0+R-1 of a row-sharded plane: the window rows inside
    the slice take their row strip, and every row of the slice its
    columns from ``cols[:, :, row0:row0+R]``."""
    S = blend.shape[1]
    R = planes[0].shape[0]
    idx = start + torch.arange(S, dtype=torch.int64, device=start.device)
    local = idx - row0
    inside = (local >= 0) & (local < R)
    for p, plane in enumerate(planes):
        plane.index_copy_(0, local[inside], blend[p][inside])
        for s in range(S):
            plane.index_copy_(1, idx[s:s + 1],
                              cols[p, s, row0:row0 + R][:, None])


def write_plane_strips(planes, blend, cols, start, row0: int = 0):
    """In place on each [A,A] f32 plane: rows start..start+S-1 from
    ``blend[p]`` and columns start..start+S-1 from ``cols[p]`` (both
    [P,S,A]), the columns winning inside the S x S window.  ``start`` is a
    0-d int64 or int32 tensor on the planes' device, read by the kernel.
    Row-slice mode: each plane is the [R, A] slice of global rows
    row0 .. row0+R-1, which takes the window rows it holds and its rows'
    column values."""
    if _on_cpu(planes[0]):
        return write_plane_strips_plain(planes, blend, cols, start, row0)
    R, A = planes[0].shape if planes[0].dim() == 2 else (0, 0)
    P, S = blend.shape[0], blend.shape[1]
    if P != len(planes) or not 1 <= S <= A:
        raise ValueError(f"write_plane_strips: {P}x{S} strips for "
                         f"{len(planes)} planes of {A} columns")
    if not (R >= 1 and 0 <= row0 <= A - R):
        raise ValueError(f"write_plane_strips: rows {row0}..{row0 + R - 1} "
                         f"are not a slice of {A} rows")
    for p in planes:
        _check_cuda_f32("write_plane_strips plane", p, (R, A))
    _check_cuda_f32("write_plane_strips blend", blend, (P, S, A))
    _check_cuda_f32("write_plane_strips cols", cols, (P, S, A))
    if blend.device != planes[0].device or cols.device != planes[0].device:
        raise ValueError("write_plane_strips: strips and planes on "
                         f"{blend.device}, {cols.device}, {planes[0].device}")
    if start.dim() != 0 or start.device != planes[0].device or \
            start.dtype not in (torch.int64, torch.int32):
        raise ValueError("write_plane_strips: start must be a 0-d int64 or "
                         "int32 tensor on the planes' device")
    rc = kernels.load().mpmcxx_write_plane_strips(
        _void_ptrs(planes), P, blend.data_ptr(), cols.data_ptr(),
        start.data_ptr(), start.dtype == torch.int64, S, A, row0, R,
        torch.cuda.current_stream(blend.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"write_plane_strips launch failed: CUDA error {rc}")
    write_plane_strips.launches += 1


write_plane_strips.launches = 0
