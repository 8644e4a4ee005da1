"""Canonical shape grid of the CMVM scheduler.

The device search buckets every lane's (outputs, bit planes) onto a
``2^k / 3·2^k / 5·2^k`` grid, so a matrix lands in the same shape class no
matter what else rides in the batch. Counterpart of ``next_pow2`` and
``canon_dim`` in ``da4ml_tpu/parallel/shapes.py``, copied exactly.
"""

from __future__ import annotations


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << (max(x, 1) - 1).bit_length()


def canon_dim(x: int, lo: int = 2, even: bool = True) -> int:
    """Round a shape dim up to the canonical 2^k / 3·2^k / 5·2^k grid.

    ``even=True`` (the CMVM scheduler's setting) keeps odd 3·2^0 / 5·2^0
    rungs off the grid, since bit planes bucket to even counts.
    """
    x = max(x, lo)
    p2 = next_pow2(x)
    best = p2
    for c in ((p2 // 4) * 3, (p2 // 8) * 5):
        if x <= c and c >= lo and (not even or c % 2 == 0) and c < best:
            best = c
    return best
