# Verbatim copy of svdfeature_tpu/data/pages.py; tests/test_torch_data.py keeps the two identical.
"""Binary page format (input_type=5, BINARY_PAGE).

Port of SVDFeatureCSRPage (apex_svd_data.h:239-345): fixed pages of
``psize = 1<<20`` int32 slots.  Layout (push_back :284-316, operator[]
:333-344) — heads overlap so that each row's start is the previous row's
end:

  d[0]        row count
  d[4r+1]     start_r   (cumulative nnz before row r; d[1] = 0)
  d[4r+2]     label_r   (float bits)
  d[4r+3..5]  cumulative ends of the global/user/item segments
              (d[4r+5] == start_{r+1})
  ...data packed backward from the page end: row r's block lives at
  psize - 2*end_i_r, as n indices followed by n values (n = end_i_r -
  start_r).

A page file is a plain concatenation of pages
(SVDFeatureCSRPageFileFactory, apex_svd_data.cpp:1216-1263).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .csr import CSRDataset

PSIZE = 1 << 20  # ints per page


def read_page_file(path: str) -> CSRDataset:
    raw = np.fromfile(path, dtype="<i4")
    if len(raw) == 0 or len(raw) % PSIZE != 0:
        raise ValueError("file must have exact blocks")
    parts: List[CSRDataset] = []
    for p0 in range(0, len(raw), PSIZE):
        parts.append(decode_page(raw[p0 : p0 + PSIZE]))
    return CSRDataset.concat(parts)


def decode_page(d: np.ndarray) -> CSRDataset:
    nrow = int(d[0])
    row_ptr = np.zeros(3 * nrow + 1, np.int64)
    labels = np.zeros(nrow, np.float32)
    idx_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    out = 0
    for r in range(nrow):
        h = 4 * r + 1
        start, eg, eu, ei = int(d[h]), int(d[h + 2]), int(d[h + 3]), int(d[h + 4])
        labels[r] = d[h + 1 : h + 2].view(np.float32)[0]
        n = ei - start
        row_ptr[3 * r + 1] = out + (eg - start)
        row_ptr[3 * r + 2] = out + (eu - start)
        row_ptr[3 * r + 3] = out + n
        out += n
        lo = PSIZE - 2 * ei
        idx_parts.append(d[lo : lo + n].view(np.uint32))
        val_parts.append(d[lo + n : lo + 2 * n].view(np.float32))
    index = np.concatenate(idx_parts) if idx_parts else np.zeros(0, np.uint32)
    value = np.concatenate(val_parts) if val_parts else np.zeros(0, np.float32)
    return CSRDataset(
        labels=labels, row_ptr=row_ptr.astype(np.int32),
        index=index.copy(), value=value.copy(),
    )


def write_page_file(path: str, ds: CSRDataset) -> None:
    """Pack a dataset into consecutive pages (push_back parity)."""
    pages: List[np.ndarray] = []
    page = np.zeros(PSIZE, np.int32)
    nrow = 0
    nval = 0
    for r in range(ds.num_row):
        label, (gi, gv), (ui, uv), (ii, iv) = ds.row(r)
        n = len(gi) + len(ui) + len(ii)
        space_head = (nrow << 2) + 1
        if space_head + 5 + 2 * (n + nval) > PSIZE:
            pages.append(page)
            page = np.zeros(PSIZE, np.int32)
            nrow, nval = 0, 0
            space_head = 1
        h = space_head
        page[h + 1] = np.float32(label).view(np.int32)
        page[h + 2] = page[h] + len(gi)
        page[h + 3] = page[h + 2] + len(ui)
        page[h + 4] = page[h + 3] + len(ii)
        idx = np.concatenate([gi, ui, ii]).astype(np.uint32)
        val = np.concatenate([gv, uv, iv]).astype(np.float32)
        ei = nval + n
        lo = PSIZE - 2 * ei
        page[lo : lo + n] = idx.view(np.int32)
        page[lo + n : lo + 2 * n] = val.view(np.int32)
        nrow += 1
        nval = ei
        page[0] = nrow
    pages.append(page)
    np.concatenate(pages).astype("<i4").tofile(path)
