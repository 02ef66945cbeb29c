# Verbatim copy of svdfeature_tpu/data/batching.py; tests/test_torch_data.py keeps the two identical.
"""Device batch packing: ragged 3-segment CSR -> fixed-shape padded arrays.

The TPU-native replacement for the reference's per-example Elem views:
examples are packed into ``[T, B, S]`` index/value tensors (T batches of B
rows, S = max nnz of the segment across the dataset) so one jit-compiled
train step processes B examples, and one ``lax.scan`` processes the whole
epoch on device with no host round-trips.

Padding uses the *dummy-row trick*: the embedding tables are allocated with
one trailing row (N+1 rows, the dummy kept at zero), padded index slots
point at the dummy row with value 0, so gathers contribute nothing and
scatter-adds/decays land harmlessly — no masks anywhere in the hot path.
Padded whole rows carry weight 0 so their gradient is zeroed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .csr import CSRDataset
from ..utils.sparse_feature_array import SparseFeatureArray


@dataclasses.dataclass
class PackedBatches:
    """Stacked device batches (still numpy; device_put once per epoch)."""

    label: np.ndarray  # [T, B]
    weight: np.ndarray  # [T, B]
    g_idx: np.ndarray  # [T, B, Sg] i32 (dummy = num_global)
    g_val: np.ndarray  # [T, B, Sg] f32
    u_idx: np.ndarray  # [T, B, Su] i32 (unified row ids; dummy = num_rows)
    u_val: np.ndarray  # [T, B, Su] f32
    i_idx: np.ndarray  # [T, B, Si] i32
    i_val: np.ndarray  # [T, B, Si] f32

    @property
    def num_batches(self) -> int:
        return self.label.shape[0]

    @property
    def batch_size(self) -> int:
        return self.label.shape[1]

    def arrays(self) -> Dict[str, np.ndarray]:
        return dataclasses.asdict(self)


def _segment_entries(
    ds: CSRDataset, seg: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat (idx, val, row_id) arrays of one segment (0=g, 1=u, 2=i)."""
    starts = ds.row_ptr[seg::3][: ds.num_row]
    ends = ds.row_ptr[seg + 1 :: 3][: ds.num_row]
    counts = (ends - starts).astype(np.int64)
    total = int(counts.sum())
    rows = np.repeat(np.arange(ds.num_row, dtype=np.int64), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    flat = np.repeat(starts.astype(np.int64), counts) + offs
    return ds.index[flat], ds.value[flat].astype(np.float32), rows


def _pad_segment(
    idx: np.ndarray,
    val: np.ndarray,
    rows: np.ndarray,
    num_row: int,
    dummy: int,
    cap: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scatter flat per-row entries into padded [num_row, S] arrays."""
    counts = np.bincount(rows, minlength=num_row).astype(np.int64)
    S = int(counts.max()) if len(counts) and counts.max() > 0 else 0
    if cap is not None:
        S = max(S, cap)
    S = max(S, 1)
    pos = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts, counts)[
        : len(rows)
    ] if len(rows) else np.zeros(0, np.int64)
    # note: `rows` must be sorted (they are: segment entries are emitted in
    # row order by _segment_entries)
    out_idx = np.full((num_row, S), dummy, np.int32)
    out_val = np.zeros((num_row, S), np.float32)
    if len(rows):
        out_idx[rows, pos] = idx
        out_val[rows, pos] = val
    return out_idx, out_val


def expand_segment(
    idx: np.ndarray,
    val: np.ndarray,
    rows: np.ndarray,
    feat: Optional[SparseFeatureArray],
    scale_by_parent: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Append hierarchical side-feature entries and re-sort by row."""
    if feat is None or feat.num_row == 0:
        return idx, val, rows
    ei, ev, er = feat.expand(idx, val, rows, scale_by_parent)
    idx = np.concatenate([idx, ei])
    val = np.concatenate([val, ev])
    rows = np.concatenate([rows, er])
    order = np.argsort(rows, kind="stable")
    return idx[order], val[order], rows[order]


def pack_csr(
    ds: CSRDataset,
    batch_size: int,
    num_rows_table: int,
    num_global: int,
    off_user: int,
    off_item: int,
    feat_user: Optional[SparseFeatureArray] = None,
    feat_item: Optional[SparseFeatureArray] = None,
    num_user: Optional[int] = None,
    num_item: Optional[int] = None,
    seg_caps: Optional[Tuple[int, int, int]] = None,
    min_batches: Optional[int] = None,
) -> PackedBatches:
    """Pack a random-order dataset into stacked fixed-shape batches.

    Feature ids are rebased into the unified table row space here (user ids
    += off_user, item ids += off_item); bounds are validated like the
    reference's assert_true checks (apex_svd_base.h:320,327,343).
    """
    R = ds.num_row
    segs = []
    for seg, (feat, scale, off, bound, name) in enumerate(
        [
            (None, False, 0, num_global, "global"),
            (feat_user, False, off_user, num_user, "user"),
            (feat_item, True, off_item, num_item, "item"),
        ]
    ):
        idx, val, rows = _segment_entries(ds, seg)
        if bound is not None and len(idx) and idx.max() >= bound:
            raise ValueError(f"{name} feature index exceed bound ({idx.max()} >= {bound})")
        idx, val, rows = expand_segment(idx, val, rows, feat, scale)
        dummy = num_global if seg == 0 else num_rows_table
        cap = seg_caps[seg] if seg_caps else None
        pi, pv = _pad_segment(
            idx.astype(np.int64) + off, val, rows, R, dummy, cap
        )
        segs.append((pi, pv))

    T = (R + batch_size - 1) // batch_size
    if min_batches is not None:
        # streaming: every chunk padded to the same batch count so one
        # compilation covers the whole stream (empty batches are weight-0)
        T = max(T, min_batches)
    Rp = T * batch_size

    def stack(a: np.ndarray, fill) -> np.ndarray:
        if len(a) < Rp:
            pad_shape = (Rp - len(a),) + a.shape[1:]
            a = np.concatenate([a, np.full(pad_shape, fill, a.dtype)])
        return a.reshape((T, batch_size) + a.shape[1:])

    weight = np.ones(R, np.float32)
    return PackedBatches(
        label=stack(ds.labels.astype(np.float32), 0.0),
        weight=stack(weight, 0.0),
        g_idx=stack(segs[0][0], num_global),
        g_val=stack(segs[0][1], 0.0),
        u_idx=stack(segs[1][0], num_rows_table),
        u_val=stack(segs[1][1], 0.0),
        i_idx=stack(segs[2][0], num_rows_table),
        i_val=stack(segs[2][1], 0.0),
    )
