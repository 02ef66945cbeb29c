# Verbatim copy of svdfeature_tpu/data/combinators.py; tests/test_torch_data.py keeps the two identical.
"""Iterator combinators: attach and filter.

Ports of AttachBlockIterator (apex_svd_data.cpp:1030-1096: interleave a
secondary block stream every ``attach_skip`` primary logical blocks,
inserting ``attach_insert`` attached blocks marked ``extra_info=1``) and
FilterBlockIterator (:1101-1159: zero out feature values in configured
``filter_ufeedback``/``filter_global`` id ranges).  Both operate on whole
datasets (the attached stream loops if shorter, like the reference's
rewind-on-exhaust) and count split block sequences by their END/DEFAULT
boundaries.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .csr import PlusBlock, PlusDataset, TAG_DEFAULT, TAG_END


def _as_dataset(src) -> PlusDataset:
    if isinstance(src, PlusDataset):
        return src
    if hasattr(src, "epoch_dataset"):  # PairSource
        return src.epoch_dataset()
    return src._mat()


def _logical_groups(ds: PlusDataset) -> List[List[int]]:
    """Group physical block indices into logical sequences ending at
    END/DEFAULT tags."""
    groups, cur = [], []
    for i in range(ds.num_block):
        cur.append(i)
        if ds.extend_tag[i] in (TAG_DEFAULT, TAG_END):
            groups.append(cur)
            cur = []
    if cur:
        groups.append(cur)
    return groups


class AttachedPlusSource:
    """Yields a PlusDataset with attached blocks interleaved."""

    def __init__(self, primary, attached, attach_skip: int = 1, attach_insert: int = 1):
        self.primary = primary
        self.attached = attached
        self.attach_skip = attach_skip
        self.attach_insert = attach_insert

    def materialize(self) -> PlusDataset:
        p, a = _as_dataset(self.primary), _as_dataset(self.attached)
        pg = _logical_groups(p)
        ag = _logical_groups(a)
        out: List[PlusBlock] = []
        ai = 0
        count = 0
        for g in pg:
            for bi in g:
                out.append(p.block(bi))
            count += 1
            if count % self.attach_skip == 0:
                for _ in range(self.attach_insert):
                    grp = ag[ai % len(ag)]
                    ai += 1
                    for bi in grp:
                        blk = a.block(bi)
                        blk.extra_info = 1
                        out.append(blk)
        return PlusDataset.from_blocks(out)

    # dataset-like duck interface
    def __getattr__(self, name):
        if name in ("rows", "num_block", "blocks", "block", "block_row_ptr",
                    "extend_tag", "fb_index", "fb_value", "block_fb_ptr",
                    "extra_info"):
            return getattr(self._mat(), name)
        raise AttributeError(name)

    def _mat(self):
        if not hasattr(self, "_cached"):
            self._cached = self.materialize()
        return self._cached


class FilteredPlusSource:
    """Zeroes values of features whose ids fall in the filter ranges."""

    def __init__(
        self,
        inner,
        filter_ufeedback: List[Tuple[int, int]],
        filter_global: List[Tuple[int, int]],
    ):
        self.inner = inner
        self.filter_ufeedback = filter_ufeedback
        self.filter_global = filter_global

    def materialize(self) -> PlusDataset:
        ds = _as_dataset(self.inner)
        fb_value = ds.fb_value.copy()
        for a, b in self.filter_ufeedback:
            fb_value[(ds.fb_index >= a) & (ds.fb_index < b)] = 0.0
        rows = ds.rows
        value = rows.value.copy()
        # global segment entries
        d = np.diff(rows.row_ptr)
        seg_id = np.repeat(np.arange(len(d)), d) % 3
        is_global = seg_id == 0
        for a, b in self.filter_global:
            m = is_global & (rows.index >= a) & (rows.index < b)
            value[m] = 0.0
        from .csr import CSRDataset

        return PlusDataset(
            rows=CSRDataset(rows.labels, rows.row_ptr, rows.index, value),
            fb_index=ds.fb_index,
            fb_value=fb_value,
            block_row_ptr=ds.block_row_ptr,
            block_fb_ptr=ds.block_fb_ptr,
            extend_tag=ds.extend_tag,
            extra_info=ds.extra_info,
        )

    def __getattr__(self, name):
        if name in ("rows", "num_block", "blocks", "block", "block_row_ptr",
                    "extend_tag", "fb_index", "fb_value", "block_fb_ptr",
                    "extra_info"):
            return getattr(self._mat(), name)
        raise AttributeError(name)

    def _mat(self):
        if not hasattr(self, "_cached"):
            self._cached = self.materialize()
        return self._cached
