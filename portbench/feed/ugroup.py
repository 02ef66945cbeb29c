"""User groups (consecutive rows of one user and one item, with the group's
feedback) as the program's user-group dataset."""

from __future__ import annotations

import numpy as np

from . import csr


def dataset(split: dict):
    from svdfeature_tpu_torch.data.csr import PlusDataset

    nb = len(split["sizes"])
    return PlusDataset(
        rows=csr.dataset(split),
        fb_index=split["fb_idx"].astype(np.uint32),
        fb_value=split["fb_val"].astype(np.float32),
        block_row_ptr=np.concatenate([[0], np.cumsum(split["sizes"])]).astype(np.int32),
        block_fb_ptr=split["fb_ptr"].astype(np.int32),
        extend_tag=np.zeros(nb, np.int8),
        extra_info=np.zeros(nb, np.int8),
    )
