# Verbatim copy of svdfeature_tpu/utils/sparse_feature_array.py; tests/test_torch_data.py keeps the two identical.
"""Hierarchical side-feature table (SparseFeatureArray, apex-utils/
apex_utils.h:141-196).

Maps a feature id to a list of extra (index, value) pairs.  The reference
walks these per example inside the SGD inner loop (apex_svd_base.h:298-309,
330-334, 365-368, 399-406); we instead expand them once at batch-pack time
— each occurrence of a parent feature appends its listed ancestors as
ordinary entries (user side: value = anc_val; item side: value =
anc_val * parent_val), which reproduces the reference's forward, update,
and regularization contributions exactly.

Text format: rows of ``n idx:val idx:val ...`` where row r gives the extra
features of feature id r.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class SparseFeatureArray:
    def __init__(self, row_ptr: np.ndarray, index: np.ndarray, value: np.ndarray):
        self.row_ptr = row_ptr  # [num_row+1]
        self.index = index  # [nnz] u32
        self.value = value  # [nnz] f32

    @property
    def num_row(self) -> int:
        return len(self.row_ptr) - 1

    @classmethod
    def load(cls, path: str, text: Optional[str] = None) -> "SparseFeatureArray":
        from ..data.text import _numeric_tokens

        arr = _numeric_tokens(text if text is not None else open(path).read())
        row_ptr = [0]
        idx_parts, val_parts = [], []
        pos, n = 0, len(arr)
        while pos < n:
            cnt = int(arr[pos])
            pos += 1
            pairs = arr[pos : pos + 2 * cnt]
            idx_parts.append(pairs[0::2])
            val_parts.append(pairs[1::2])
            row_ptr.append(row_ptr[-1] + cnt)
            pos += 2 * cnt
        index = (
            np.concatenate(idx_parts).astype(np.uint32)
            if idx_parts
            else np.zeros(0, np.uint32)
        )
        value = (
            np.concatenate(val_parts).astype(np.float32)
            if val_parts
            else np.zeros(0, np.float32)
        )
        return cls(np.asarray(row_ptr, np.int64), index, value)

    def expand(
        self,
        parent_idx: np.ndarray,
        parent_val: np.ndarray,
        parent_row: np.ndarray,
        scale_by_parent: bool,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized expansion: for each parent occurrence, emit its extra
        entries.  Returns (ext_idx, ext_val, ext_row).

        scale_by_parent=True is the item-side rule (extra value multiplied
        by the parent feature's value, apex_svd_base.h:376-379); False is
        the user-side rule (raw extra value, :365-368).
        """
        pid = parent_idx.astype(np.int64)
        in_range = pid < self.num_row
        starts = np.where(in_range, self.row_ptr[np.minimum(pid, self.num_row - 1)], 0)
        counts = np.where(
            in_range,
            self.row_ptr[np.minimum(pid + 1, self.num_row)] - starts,
            0,
        ).astype(np.int64)
        total = int(counts.sum())
        if total == 0:
            return (
                np.zeros(0, np.uint32),
                np.zeros(0, np.float32),
                np.zeros(0, parent_row.dtype),
            )
        # flat positions into self.index for every expanded entry
        rep = np.repeat(np.arange(len(pid)), counts)
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        flat = np.repeat(starts, counts) + offs
        ext_idx = self.index[flat]
        ext_val = self.value[flat].astype(np.float32)
        if scale_by_parent:
            ext_val = ext_val * parent_val[rep]
        return ext_idx, ext_val, parent_row[rep]


class RunQueue:
    """Ring-buffer dedup work queue (apex-utils/apex_utils.h:91-121).

    Unused by the reference's main path (reserved for schedulers); ported
    for inventory completeness.
    """

    def __init__(self, max_size: int):
        self._buf = [None] * (max_size + 1)
        self._head = 0
        self._tail = 0
        self._members = set()

    def empty(self) -> bool:
        return self._head == self._tail

    def put(self, item) -> bool:
        if item in self._members:
            return False
        nxt = (self._tail + 1) % len(self._buf)
        if nxt == self._head:
            return False  # full
        self._buf[self._tail] = item
        self._tail = nxt
        self._members.add(item)
        return True

    def get(self):
        if self.empty():
            return None
        item = self._buf[self._head]
        self._head = (self._head + 1) % len(self._buf)
        self._members.discard(item)
        return item
