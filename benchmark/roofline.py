"""Least time of the work a kernel does, from its shapes.

Frozen copy of ``chip_smoke.py``'s bound (``_bound``,
``_contract_bound``, ``tri_elements``, ``COEFF_OPS``, ``DIRECTION_OPS``):
the larger of the bytes moved over the memory rate and the operations
over the peak rate, with the peaks of ``peaks.json``.  The SCF
contraction ``-T mu`` over symmetric planes needs one triangle of each
f32 plane, mu read and the field written; its operations are the
in-kernel coefficient recompute (mode 3: 27 per entry) and 18 per
direction, both directions from one entry of the triangle.  The work is
counted from the slot count A, whichever kernel ran: a kernel that reads
the whole planes (K1) reads more than the work needs and shows a lower
share.
"""

from __future__ import annotations

# f32 operations per plane entry: the coefficient recompute by plane mode
# and the operations of one direction's sum (d . mu 5, s 1, s d + cd mu 12)
COEFF_OPS = {3: 27, 4: 0, 5: 0}
DIRECTION_OPS = 18


def peak(peaks: dict, kind: str):
    """The peaks entry whose key the device's name holds, or None."""
    for key, entry in peaks.items():
        if key in kind:
            return entry
    return None


def least_s(nbytes: float, ops: float, pk: dict, ops_key: str) -> float:
    """Seconds: the larger of ``nbytes`` over the memory rate and ``ops``
    over the peak rate ``pk[ops_key]``."""
    return max(nbytes / pk["hbm_bytes_per_s"], ops / pk[ops_key])


def tri_elements(A: int, b: int = 1) -> int:
    """Plane entries in the tile pairs I <= J of b x b tiles of an A x A
    plane; b = 1 is the triangle with its diagonal."""
    heights = [min(b, A - i) for i in range(0, A, b)]
    return (A * A + sum(h * h for h in heights)) // 2


def contraction_least_s(A: int, mode: int, pk: dict) -> float:
    """Least seconds of one ``-T mu`` over ``mode`` symmetric f32 [A, A]
    planes: one triangle of each, mu [3, A] f32 read, [A, 3] f32 written."""
    elements = tri_elements(A)
    nbytes = mode * elements * 4 + 3 * (A + A) * 4
    ops = elements * (COEFF_OPS[mode] + 2 * DIRECTION_OPS)
    return least_s(nbytes, ops, pk, "f32_ops_per_s")
