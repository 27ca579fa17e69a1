"""Hand-written CUDA kernel of the cavity bias, with its plain PyTorch
version and launch count.

JAX twin: mpmcxx_tpu/ops/pallas_cavity.py.

K3 ``occupancy`` (csrc/occupancy.cu) replaces ``occupancy_pallas``: for
each point, whether any live atom lies within ``radius``.  It runs in f64
(the TPU kernel's f32 was a Mosaic limit) and agrees with the plain
version bit for bit.  mc/cavity.update_grid calls it twice per move: grid
points against atoms, and accessible-volume darts against the open grid
points.

The wrapper runs the plain version only for CPU tensors.  For CUDA
tensors it launches the kernel or raises: on a wrong dtype, shape or
contiguity, when the build fails, and when the launch reports an error.
``occupancy.launches`` counts its kernel launches.
"""

from __future__ import annotations

import torch

from . import kernels
from .cuda_polar import _on_cpu

# points per chunk of the plain version: [chunk, A, 3] f64 stays ~100 MB
_PLAIN_PAIRS = 1 << 22


def occupancy_plain(points, positions, alive, radius: float):
    """[P] bool: is any live atom within ``radius`` of each point.  Point
    chunks keep the [chunk, A] temporaries small; d^2 is summed
    (dx*dx + dy*dy) + dz*dz, the kernel's order."""
    r2 = radius * radius
    A = positions.shape[0]
    chunk = max(1, _PLAIN_PAIRS // max(A, 1))
    out = []
    for p0 in range(0, points.shape[0], chunk):
        d = points[p0:p0 + chunk, None, :] - positions[None, :, :]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        d2 = (dx * dx + dy * dy) + dz * dz
        out.append(torch.any((d2 < r2) & alive[None, :], dim=1))
    return torch.cat(out)


def _check_cuda(name, t, dtype, shape):
    if t.device.type != "cuda" or t.dtype != dtype or \
            not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want a contiguous {dtype} CUDA tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def occupancy(points, positions, alive, radius: float):
    """[P] bool occupancy of ``points`` [P,3] f64 by the ``alive`` [A]
    entries of ``positions`` [A,3] f64 within ``radius`` (a Python
    float; r^2 = radius * radius in f64)."""
    if _on_cpu(points):
        return occupancy_plain(points, positions, alive, radius)
    P, A = points.shape[0], positions.shape[0]
    _check_cuda("occupancy points", points, torch.float64, (P, 3))
    _check_cuda("occupancy positions", positions, torch.float64, (A, 3))
    _check_cuda("occupancy alive", alive, torch.bool, (A,))
    if positions.device != points.device or alive.device != points.device:
        raise ValueError("occupancy: tensors on different devices")
    if P == 0:
        return torch.zeros(0, dtype=torch.bool, device=points.device)
    lib = kernels.load()
    occ = torch.empty(P, dtype=torch.uint8, device=points.device)
    rc = lib.mpmcxx_occupancy(
        points.data_ptr(), positions.data_ptr(), alive.data_ptr(),
        float(radius) * float(radius), P, A, occ.data_ptr(),
        torch.cuda.current_stream(points.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"occupancy launch failed: CUDA error {rc}")
    occupancy.launches += 1
    return occ.view(torch.bool)


occupancy.launches = 0
