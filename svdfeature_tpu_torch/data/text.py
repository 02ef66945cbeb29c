# Verbatim copy of svdfeature_tpu/data/text.py; tests/test_torch_data.py keeps the two identical.
"""Vectorized text-format parsers.

Replaces the reference's fscanf streaming loaders with whole-file numpy
parsing (the reference hides parse latency behind a producer pthread,
apex-utils/apex_buffer_loader.h; we parse faster than it streams):

* feature format  (SVDFeatureCSRLoader, apex_svd_data.cpp:70-112):
    ``label ng nu ni  idx:val ...`` as a free whitespace token stream.
* basic 3-column  (SVDBasicLoader, apex_svd_data.cpp:32-66):
    per line ``uid iid rate [ignored...]`` -> one user + one item feature
    with value 1.
* user-group + feedback (SVDPlusBlockLoader, apex_svd_data.cpp:316-554):
    feedback file of records ``nline nfeedback idx:val ...`` each covering
    ``nline`` rows of the feature file; rows' segments are sorted by index;
    oversize groups split into START/MIDDLE/END blocks balanced in size.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .csr import (
    CSRDataset,
    PlusBlock,
    PlusDataset,
    TAG_DEFAULT,
    TAG_END,
    TAG_MIDDLE,
    TAG_START,
)


def _numeric_tokens(text: str) -> np.ndarray:
    """Parse the whole file as a stream of numbers, treating ':' as
    whitespace.  float64 keeps u32 feature ids exact (<2**53)."""
    flat = text.replace(":", " ")
    try:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.fromstring(flat, dtype=np.float64, sep=" ")
    except (AttributeError, ValueError):
        return np.array(flat.split(), dtype=np.float64)


def _maybe_read(path_or_text: str, is_text: bool) -> str:
    if is_text:
        return path_or_text
    with open(path_or_text, "r") as f:
        return f.read()


def parse_feature_stream(
    arr: np.ndarray, scale_score: float = 1.0
) -> CSRDataset:
    """Walk the numeric token stream of the feature format into a CSR."""
    labels: List[float] = []
    seg_counts: List[Tuple[int, int, int]] = []
    spans: List[Tuple[int, int]] = []  # (start, total) token offsets of pair runs
    pos, n = 0, len(arr)
    while pos + 4 <= n:
        ng, nu, ni = int(arr[pos + 1]), int(arr[pos + 2]), int(arr[pos + 3])
        tot = ng + nu + ni
        if pos + 4 + 2 * tot > n:
            break
        labels.append(arr[pos])
        seg_counts.append((ng, nu, ni))
        spans.append((pos + 4, tot))
        pos += 4 + 2 * tot
    R = len(labels)
    counts = np.asarray(seg_counts, np.int64).reshape(R, 3)
    row_ptr = np.zeros(3 * R + 1, np.int64)
    np.cumsum(counts.reshape(-1), out=row_ptr[1:])
    total_val = int(row_ptr[-1])
    index = np.empty(total_val, np.uint32)
    value = np.empty(total_val, np.float32)
    out = 0
    for start, tot in spans:
        pairs = arr[start : start + 2 * tot]
        index[out : out + tot] = pairs[0::2]
        value[out : out + tot] = pairs[1::2]
        out += tot
    return CSRDataset(
        labels=(np.asarray(labels, np.float32) / np.float32(scale_score)),
        row_ptr=row_ptr.astype(np.int32),
        index=index,
        value=value,
    )


def load_feature_text(path: str, scale_score: float = 1.0, text: Optional[str] = None) -> CSRDataset:
    if text is None:
        text = open(path).read()
    from . import native

    out = native.parse_feature_text(text, scale_score)
    if out is not None:
        labels, row_ptr, index, value = out
        return CSRDataset(labels=labels, row_ptr=row_ptr, index=index, value=value)
    arr = _numeric_tokens(text)
    return parse_feature_stream(arr, scale_score)


def load_basic_text(path: str, scale_score: float = 1.0, text: Optional[str] = None) -> CSRDataset:
    """3-column ``uid iid rate`` lines -> rows with one user and one item
    feature of value 1 (apex_svd_data.cpp:56-62)."""
    if text is None:
        with open(path) as f:
            text = f.read()
    uids, iids, rates = [], [], []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) < 3:
            continue
        uids.append(int(parts[0]))
        iids.append(int(parts[1]))
        rates.append(float(parts[2]))
    R = len(uids)
    row_ptr = np.zeros(3 * R + 1, np.int64)
    counts = np.tile(np.array([0, 1, 1], np.int64), R)
    np.cumsum(counts, out=row_ptr[1:])
    index = np.empty(2 * R, np.uint32)
    index[0::2] = uids
    index[1::2] = iids
    value = np.ones(2 * R, np.float32)
    return CSRDataset(
        labels=np.asarray(rates, np.float32) / np.float32(scale_score),
        row_ptr=row_ptr.astype(np.int32),
        index=index,
        value=value,
    )


def _sort_segments(ds: CSRDataset) -> CSRDataset:
    """Sort each row-segment's entries by feature index (the plus-block
    loader sorts; apex_svd_data.cpp:342-350)."""
    nseg = len(ds.row_ptr) - 1
    seg_sizes = np.diff(ds.row_ptr)
    seg_id = np.repeat(np.arange(nseg, dtype=np.int64), seg_sizes)
    order = np.lexsort((ds.index, seg_id))
    return CSRDataset(ds.labels, ds.row_ptr, ds.index[order], ds.value[order])


def _split_counts(nline: int, block_max_line: int) -> List[int]:
    """The reference's "smart arrangement" that equalizes split-chunk sizes
    (apex_svd_data.cpp:486-493)."""
    out = []
    remain = nline
    while remain > block_max_line:
        pc = (remain + block_max_line - 1) // block_max_line
        num = (remain + pc - 1) // pc
        out.append(num)
        remain -= num
    out.append(remain)
    return out


def load_plus_text(
    path: str,
    feedback_path: Optional[str] = None,
    scale_score: float = 1.0,
    block_max_line: int = 10000,
    text: Optional[str] = None,
    feedback_text: Optional[str] = None,
) -> PlusDataset:
    """Load user-grouped data (with or without a feedback file)."""
    ds = load_feature_text(path, scale_score, text=text)
    ds = _sort_segments(ds)

    if feedback_path is None and feedback_text is None:
        return _group_by_uid(ds, block_max_line)

    fbtext = feedback_text if feedback_text is not None else open(feedback_path).read()
    from . import native

    nat = native.parse_feedback_text(fbtext)
    if nat is not None:
        nlines, fb_counts, fb_index_all, fb_value_all = nat
        fb_ptr = np.concatenate(([0], np.cumsum(fb_counts.astype(np.int64))))
        records = [
            (
                int(nlines[r]),
                fb_index_all[fb_ptr[r] : fb_ptr[r + 1]],
                fb_value_all[fb_ptr[r] : fb_ptr[r + 1]],
            )
            for r in range(len(nlines))
        ]
    else:
        fbtoks = _numeric_tokens(fbtext)
        records = []
        pos, n = 0, len(fbtoks)
        while pos + 2 <= n:
            nline, nfb = int(fbtoks[pos]), int(fbtoks[pos + 1])
            pos += 2
            # note: feedback entries stay in file order — the reference
            # loader sorts row segments but NOT the feedback vector
            # (apex_svd_data.cpp:472-482)
            records.append(
                (
                    nline,
                    fbtoks[pos : pos + 2 * nfb : 2].astype(np.uint32),
                    fbtoks[pos + 1 : pos + 2 * nfb : 2].astype(np.float32),
                )
            )
            pos += 2 * nfb
    blocks: List[PlusBlock] = []
    row_cursor = 0
    for nline, fb_idx, fb_val in records:
        chunks = _split_counts(nline, block_max_line)
        for ci, num in enumerate(chunks):
            if len(chunks) == 1:
                tag = TAG_DEFAULT
            elif ci == 0:
                tag = TAG_START
            elif ci == len(chunks) - 1:
                tag = TAG_END
            else:
                tag = TAG_MIDDLE
            carries_fb = tag != TAG_MIDDLE  # reference: MIDDLE has none
            blocks.append(
                PlusBlock(
                    fb_index=fb_idx if carries_fb else np.zeros(0, np.uint32),
                    fb_value=fb_val if carries_fb else np.zeros(0, np.float32),
                    data=ds.slice_rows(row_cursor, num),
                    extend_tag=tag,
                )
            )
            row_cursor += num
    return PlusDataset.from_blocks(blocks)


def _group_by_uid(ds: CSRDataset, block_max_line: int) -> PlusDataset:
    """Group consecutive rows whose first user-feature index matches
    (next_onlyfi, apex_svd_data.cpp:361-443).  No feedback in this mode.

    The reference's oversize-group handling here is a sliding half-window
    oddity used only for buffer creation; we split groups plainly at
    block_max_line with DEFAULT tags (no feedback state to carry).
    """
    d = np.diff(ds.row_ptr)
    nu = d[1::3]
    if np.any(nu == 0):
        raise ValueError("need at least one user feature in feature file")
    first_u = ds.index[ds.row_ptr[1::3]]  # first user feature id per row
    # boundaries where uid changes
    change = np.nonzero(np.diff(first_u) != 0)[0] + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [ds.num_row]))
    blocks: List[PlusBlock] = []
    empty_i = np.zeros(0, np.uint32)
    empty_v = np.zeros(0, np.float32)
    for s, e in zip(starts, ends):
        r = s
        while r < e:
            num = min(block_max_line, e - r)
            blocks.append(
                PlusBlock(
                    fb_index=empty_i,
                    fb_value=empty_v,
                    data=ds.slice_rows(int(r), int(num)),
                    extend_tag=TAG_DEFAULT,
                )
            )
            r += num
    return PlusDataset.from_blocks(blocks)
