"""Rows of one user and one item (value 1 each) as the program's
random-order dataset: a 3-segment CSR of no global, one user and one item
entry a row."""

from __future__ import annotations

import numpy as np


def dataset(rows: dict):
    from svdfeature_tpu_torch.data.csr import CSRDataset

    n = len(rows["labels"])
    row_ptr = np.zeros(3 * n + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.tile(np.array([0, 1, 1], np.int32), n))
    index = np.empty(2 * n, np.uint32)
    index[0::2] = rows["users"]
    index[1::2] = rows["items"]
    return CSRDataset(labels=np.ascontiguousarray(rows["labels"], np.float32), row_ptr=row_ptr,
                      index=index, value=np.ones(2 * n, np.float32))
