# Verbatim copy of svdfeature_tpu/utils/csr_builder.py; tests/test_torch_data.py keeps the two identical.
"""CSR construction utilities.

Port of SparseCSRMBuilder (apex-utils/apex_matrix_csr.h:21-115): the
5-step budget/fill construction, kept for the incremental use case, plus
a vectorized one-shot `build_csr` that replaces the whole dance when the
(row, col) pairs are already in arrays (the common case here).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def build_csr(
    rows: np.ndarray, cols: np.ndarray, num_rows: int
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot CSR build from (row, col) pairs: (rptr [num_rows+1],
    findex sorted by row, stable within)."""
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=num_rows)
    rptr = np.zeros(num_rows + 1, np.int64)
    np.cumsum(counts, out=rptr[1:])
    return rptr, np.asarray(cols)[order]


class SparseCSRMBuilder:
    """Incremental 5-step builder (same call pattern as the reference)."""

    def __init__(self, use_aclist: bool = False):
        self.use_aclist = use_aclist
        self.rptr: Optional[np.ndarray] = None
        self.findex: Optional[np.ndarray] = None
        self.aclist = []

    def init_budget(self, nrows: int) -> None:
        if not self.use_aclist:
            self.rptr = np.zeros(nrows + 1, np.int64)
        else:
            assert self.rptr is not None and len(self.rptr) == nrows + 1, (
                "rptr must be initialized already"
            )
            self.cleanup()

    def add_budget(self, row_id: int, nelem: int = 1) -> None:
        if self.use_aclist and self.rptr[row_id + 1] == 0:
            self.aclist.append(row_id)
        self.rptr[row_id + 1] += nelem

    def init_storage(self) -> None:
        start = 0
        if not self.use_aclist:
            for i in range(1, len(self.rptr)):
                rlen = self.rptr[i]
                self.rptr[i] = start
                start += rlen
        else:
            self.aclist.sort()
            for i, ridx in enumerate(self.aclist):
                rlen = self.rptr[ridx + 1]
                self.rptr[ridx + 1] = start
                if i == 0 or ridx != self.aclist[i - 1] + 1:
                    self.rptr[ridx] = start
                start += rlen
        self.findex = np.zeros(start, np.int64)

    def push_elem(self, row_id: int, col_id: int) -> None:
        self.findex[self.rptr[row_id + 1]] = col_id
        self.rptr[row_id + 1] += 1

    def cleanup(self) -> None:
        assert self.use_aclist
        for ridx in self.aclist:
            self.rptr[ridx] = 0
            self.rptr[ridx + 1] = 0
        self.aclist = []
