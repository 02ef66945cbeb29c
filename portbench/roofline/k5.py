"""K5's least work for one row write (``csrc/row_scatter.cu``, the
sorted-dedup step's unique-row writer).

Frozen copy of the repository's K5 count (PERF.md's kernel table and
``chip_smoke.time_k5_shapes``): ``4 * (E + E * W + rows * W)`` bytes, the
E target ids and E rows of W floats read once and the distinct rows of W
floats written once; no operations to speak of."""

from __future__ import annotations

from . import peaks


def write_seconds(E: int, W: int, rows: int) -> float:
    return peaks.least_seconds(0.0, 4 * (E + E * W + rows * W))
