# Verbatim copy of svdfeature_tpu/data/buffer.py; tests/test_torch_data.py keeps the two identical.
"""Binary feature-buffer IO, bit-compatible with the reference formats.

Random-order buffer (SVDFeatureCSRFactory, apex_svd_data.cpp:116-270):
  header  {num_batch, batch_size, max_batch_num} (3x int32)
  per batch: num_row, num_val, row_ptr[3*num_row+1] (rebased to 0),
             labels[num_row] f32, feat_index[num_val] u32,
             feat_value[num_val] f32

User-group buffer (SVDPlusBlockFactory, apex_svd_data.cpp:556-671):
  header  {num_batch, max_num_ufeedback, max_num_row, max_num_val} (4x int32)
  per block (SVDPlusBlock::save_to_file, apex_svd_data.h:419-431):
      num_ufeedback int32 — top bit set marks a non-default extend_tag,
      [extend_tag int32 when marked], fb index u32[], fb value f32[],
      then the CSR block as above (without the per-batch header fields
      beyond num_row/num_val).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Tuple

import numpy as np

from .csr import CSRDataset, PlusBlock, PlusDataset, TAG_DEFAULT


# ---------------------------------------------------------------------------
# random-order CSR buffer


def write_csr_buffer(path: str, ds: CSRDataset, batch_size: int = 1000) -> None:
    """Mirror of SVDFeatureCSRFactory::create_buffer (apex_svd_data.cpp:131-195)."""
    num_batch = 0
    max_batch_num = 0
    with open(path, "wb") as f:
        f.write(struct.pack("<iii", 0, 0, 0))  # placeholder header
        r = 0
        while r < ds.num_row:
            num = min(batch_size, ds.num_row - r)
            sl = ds.slice_rows(r, num)
            _write_csr_block(f, sl)
            max_batch_num = max(max_batch_num, sl.num_val)
            num_batch += 1
            r += num
        f.seek(0)
        f.write(struct.pack("<iii", num_batch, batch_size, max_batch_num))


def _write_csr_block(f: BinaryIO, sl: CSRDataset) -> None:
    base = int(sl.row_ptr[0])
    f.write(struct.pack("<ii", sl.num_row, sl.num_val))
    rp = (sl.row_ptr.astype(np.int64) - base).astype("<i4")
    f.write(rp.tobytes())
    f.write(np.ascontiguousarray(sl.labels, "<f4").tobytes())
    a, b = base, base + sl.num_val
    f.write(np.ascontiguousarray(sl.index[a:b], "<u4").tobytes())
    f.write(np.ascontiguousarray(sl.value[a:b], "<f4").tobytes())


def _read_csr_block(f: BinaryIO) -> CSRDataset:
    hdr = f.read(8)
    num_row, num_val = struct.unpack("<ii", hdr)
    row_ptr = np.frombuffer(f.read(4 * (3 * num_row + 1)), "<i4").copy()
    labels = (
        np.frombuffer(f.read(4 * num_row), "<f4").copy()
        if num_row > 0
        else np.zeros(0, np.float32)
    )
    if num_val > 0:
        index = np.frombuffer(f.read(4 * num_val), "<u4").copy()
        value = np.frombuffer(f.read(4 * num_val), "<f4").copy()
    else:
        index = np.zeros(0, np.uint32)
        value = np.zeros(0, np.float32)
    return CSRDataset(labels, row_ptr, index, value)


def read_csr_buffer(path: str) -> Tuple[CSRDataset, int]:
    """Read the whole buffer into one CSRDataset; returns (dataset, batch_size)."""
    parts: List[CSRDataset] = []
    with open(path, "rb") as f:
        num_batch, batch_size, _ = struct.unpack("<iii", f.read(12))
        for _ in range(num_batch):
            parts.append(_read_csr_block(f))
    return CSRDataset.concat(parts), batch_size


# ---------------------------------------------------------------------------
# user-group buffer

_TAG_MARK = 1 << 31


def write_plus_buffer(path: str, ds: PlusDataset) -> None:
    """Mirror of SVDPlusBlockFactory::create_buffer (apex_svd_data.cpp:573-595)."""
    num_batch = 0
    max_fb = max_row = max_val = 0
    with open(path, "wb") as f:
        f.write(struct.pack("<iiii", 0, 0, 0, 0))
        for blk in ds.blocks():
            nfb = blk.num_ufeedback
            if blk.extend_tag != TAG_DEFAULT:
                f.write(struct.pack("<I", (nfb | _TAG_MARK) & 0xFFFFFFFF))
                f.write(struct.pack("<i", blk.extend_tag))
            else:
                f.write(struct.pack("<i", nfb))
            f.write(np.ascontiguousarray(blk.fb_index, "<u4").tobytes())
            f.write(np.ascontiguousarray(blk.fb_value, "<f4").tobytes())
            _write_csr_block(f, blk.data)
            max_fb = max(max_fb, nfb)
            max_row = max(max_row, blk.data.num_row)
            max_val = max(max_val, blk.data.num_val)
            num_batch += 1
        f.seek(0)
        f.write(struct.pack("<iiii", num_batch, max_fb, max_row, max_val))


def read_plus_buffer(path: str) -> PlusDataset:
    blocks: List[PlusBlock] = []
    with open(path, "rb") as f:
        num_batch, _, _, _ = struct.unpack("<iiii", f.read(16))
        for _ in range(num_batch):
            (raw,) = struct.unpack("<i", f.read(4))
            if raw < 0:
                nfb = raw & 0x7FFFFFFF
                (tag,) = struct.unpack("<i", f.read(4))
            else:
                nfb, tag = raw, TAG_DEFAULT
            if nfb > 0:
                fb_index = np.frombuffer(f.read(4 * nfb), "<u4").copy()
                fb_value = np.frombuffer(f.read(4 * nfb), "<f4").copy()
            else:
                fb_index = np.zeros(0, np.uint32)
                fb_value = np.zeros(0, np.float32)
            data = _read_csr_block(f)
            blocks.append(PlusBlock(fb_index, fb_value, data, extend_tag=tag))
    return PlusDataset.from_blocks(blocks)
