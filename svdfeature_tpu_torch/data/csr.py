# Verbatim copy of svdfeature_tpu/data/csr.py; tests/test_torch_data.py keeps the two identical.
"""Core sparse containers: 3-segment CSR dataset and user-group blocks.

Equivalent of SVDFeatureCSR / SVDPlusBlock (apex_svd_data.h:34-231, 353-465)
but array-of-rows instead of pointer views: one contiguous numpy CSR holds
the whole dataset (or one block), with ``row_ptr`` of length ``3*num_row+1``
segmenting each row into (global, user, item) index/value runs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CSRDataset:
    """3-segment CSR sparse matrix over float32 labels.

    row_ptr layout (apex_svd_data.h:116-119): for row r,
      global  run = [row_ptr[3r],   row_ptr[3r+1])
      user    run = [row_ptr[3r+1], row_ptr[3r+2])
      item    run = [row_ptr[3r+2], row_ptr[3r+3])
    """

    labels: np.ndarray  # [R] f32
    row_ptr: np.ndarray  # [3R+1] i32
    index: np.ndarray  # [V] u32
    value: np.ndarray  # [V] f32

    @property
    def num_row(self) -> int:
        return len(self.labels)

    @property
    def num_val(self) -> int:
        return int(self.row_ptr[-1]) - int(self.row_ptr[0])

    def seg_counts(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-row nnz of each segment: (ng, nu, ni), each [R]."""
        d = np.diff(self.row_ptr)
        return d[0::3], d[1::3], d[2::3]

    def row(self, r: int):
        """Debug accessor: (label, (gi, gv), (ui, uv), (ii, iv))."""
        p = self.row_ptr
        segs = []
        for s in range(3):
            a, b = p[3 * r + s], p[3 * r + s + 1]
            segs.append((self.index[a:b], self.value[a:b]))
        return self.labels[r], segs[0], segs[1], segs[2]

    def slice_rows(self, start: int, num: int) -> "CSRDataset":
        p = self.row_ptr
        a, b = int(p[3 * start]), int(p[3 * (start + num)])
        return CSRDataset(
            labels=self.labels[start : start + num],
            row_ptr=p[3 * start : 3 * (start + num) + 1] - a,
            index=self.index[a:b],
            value=self.value[a:b],
        )

    @staticmethod
    def concat(parts: List["CSRDataset"]) -> "CSRDataset":
        if not parts:
            return CSRDataset(
                np.zeros(0, np.float32),
                np.zeros(1, np.int32),
                np.zeros(0, np.uint32),
                np.zeros(0, np.float32),
            )
        labels = np.concatenate([p.labels for p in parts])
        ptrs = [parts[0].row_ptr.astype(np.int64) - parts[0].row_ptr[0]]
        off = ptrs[0][-1]
        for p in parts[1:]:
            q = p.row_ptr.astype(np.int64) - p.row_ptr[0]
            ptrs.append(q[1:] + off)
            off += q[-1]
        row_ptr = np.concatenate(ptrs).astype(np.int32)
        index = np.concatenate(
            [p.index[p.row_ptr[0] : p.row_ptr[-1]] for p in parts]
        )
        value = np.concatenate(
            [p.value[p.row_ptr[0] : p.row_ptr[-1]] for p in parts]
        )
        return CSRDataset(labels, row_ptr, index, value)


# extension tags for split user blocks (apex_svd_data.h:353-371)
TAG_DEFAULT = 0
TAG_START = 1
TAG_END = 2
TAG_MIDDLE = 3


@dataclasses.dataclass
class PlusBlock:
    """One user-group block: shared feedback vector + member rows
    (apex_svd_data.h:376-465)."""

    fb_index: np.ndarray  # [F] u32
    fb_value: np.ndarray  # [F] f32
    data: CSRDataset
    extend_tag: int = TAG_DEFAULT
    extra_info: int = 0

    @property
    def num_ufeedback(self) -> int:
        return len(self.fb_index)


@dataclasses.dataclass
class PlusDataset:
    """A sequence of user-group blocks kept as flat arrays.

    This is the whole-dataset analogue of streaming SVDPlusBlock: all rows in
    one CSRDataset, all feedback entries in one (index, value) pool, and
    per-block metadata arrays.  Feedback of split (START/MIDDLE/END) blocks
    is carried only on the START block, as in the reference serialization.
    """

    rows: CSRDataset
    fb_index: np.ndarray  # [Ftot] u32
    fb_value: np.ndarray  # [Ftot] f32
    block_row_ptr: np.ndarray  # [NB+1] i32: row range of each block
    block_fb_ptr: np.ndarray  # [NB+1] i32: feedback range of each block
    extend_tag: np.ndarray  # [NB] i8
    extra_info: Optional[np.ndarray] = None  # [NB] i8 (attach-iterator mark)

    @property
    def num_block(self) -> int:
        return len(self.extend_tag)

    def block(self, i: int) -> PlusBlock:
        r0, r1 = int(self.block_row_ptr[i]), int(self.block_row_ptr[i + 1])
        f0, f1 = int(self.block_fb_ptr[i]), int(self.block_fb_ptr[i + 1])
        return PlusBlock(
            fb_index=self.fb_index[f0:f1],
            fb_value=self.fb_value[f0:f1],
            data=self.rows.slice_rows(r0, r1 - r0),
            extend_tag=int(self.extend_tag[i]),
            extra_info=int(self.extra_info[i]) if self.extra_info is not None else 0,
        )

    def blocks(self) -> Iterator[PlusBlock]:
        for i in range(self.num_block):
            yield self.block(i)

    @staticmethod
    def from_blocks(blocks: List[PlusBlock]) -> "PlusDataset":
        rows = CSRDataset.concat([b.data for b in blocks])
        fb_index = (
            np.concatenate([b.fb_index for b in blocks])
            if blocks
            else np.zeros(0, np.uint32)
        )
        fb_value = (
            np.concatenate([b.fb_value for b in blocks])
            if blocks
            else np.zeros(0, np.float32)
        )
        brp = np.zeros(len(blocks) + 1, np.int32)
        bfp = np.zeros(len(blocks) + 1, np.int32)
        for i, b in enumerate(blocks):
            brp[i + 1] = brp[i] + b.data.num_row
            bfp[i + 1] = bfp[i] + b.num_ufeedback
        tags = np.array([b.extend_tag for b in blocks], np.int8)
        extra = np.array([b.extra_info for b in blocks], np.int8)
        return PlusDataset(rows, fb_index, fb_value, brp, bfp, tags, extra)
