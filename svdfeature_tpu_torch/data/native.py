# Verbatim copy of svdfeature_tpu/data/native.py; tests/test_torch_data.py keeps the two identical.
"""ctypes bindings for the native data-plane library (native/).

Auto-builds libsvdkit_native.so on first use if a toolchain is present;
every entry point has a pure-numpy fallback, so the package works without
the native library (set SVDKIT_NO_NATIVE=1 to force the fallback).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libsvdkit_native.so"
_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("SVDKIT_NO_NATIVE"):
        return None
    try:
        if not _LIB_PATH.exists():
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        lib = ctypes.CDLL(str(_LIB_PATH))
    except Exception:
        return None
    c = ctypes
    i64p = c.POINTER(c.c_int64)
    lib.count_feature_text.argtypes = [c.c_char_p, c.c_int64, i64p, i64p]
    lib.count_feature_text.restype = c.c_int
    lib.parse_feature_text.argtypes = [
        c.c_char_p, c.c_int64, c.c_double,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
    ]
    lib.parse_feature_text.restype = c.c_int
    lib.count_feedback_text.argtypes = [c.c_char_p, c.c_int64, i64p, i64p]
    lib.count_feedback_text.restype = c.c_int
    lib.parse_feedback_text.argtypes = [
        c.c_char_p, c.c_int64,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
    ]
    lib.parse_feedback_text.restype = c.c_int
    lib.pad_segment.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64,
        c.c_void_p, c.c_void_p, c.c_int64,
        c.c_int64, c.c_int64, c.c_void_p, c.c_void_p,
    ]
    lib.pad_segment.restype = None
    lib.block_shuffle.argtypes = [
        c.c_void_p, c.c_int32, c.c_void_p, c.c_int64, c.c_int64, c.c_uint64,
    ]
    lib.block_shuffle.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_feature_text(text: str, scale_score: float = 1.0):
    """Native fast path of data.text.load_feature_text.

    Returns (labels, row_ptr, index, value) or None if unavailable/failed.
    """
    lib = _load()
    if lib is None:
        return None
    raw = text.encode()
    nr, nv = ctypes.c_int64(), ctypes.c_int64()
    if lib.count_feature_text(raw, len(raw), ctypes.byref(nr), ctypes.byref(nv)):
        return None
    R, V = nr.value, nv.value
    labels = np.empty(R, np.float32)
    seg_counts = np.empty(R * 3, np.int32)
    index = np.empty(V, np.uint32)
    value = np.empty(V, np.float32)
    if lib.parse_feature_text(
        raw, len(raw), scale_score,
        labels.ctypes.data, seg_counts.ctypes.data,
        index.ctypes.data, value.ctypes.data,
    ):
        return None
    row_ptr = np.zeros(3 * R + 1, np.int64)
    np.cumsum(seg_counts.astype(np.int64), out=row_ptr[1:])
    return labels, row_ptr.astype(np.int32), index, value


def parse_feedback_text(text: str):
    """Native parse of feedback records; returns (nlines, fb_counts,
    fb_index, fb_value) or None."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode()
    nr, nf = ctypes.c_int64(), ctypes.c_int64()
    if lib.count_feedback_text(raw, len(raw), ctypes.byref(nr), ctypes.byref(nf)):
        return None
    R, F = nr.value, nf.value
    nlines = np.empty(R, np.int32)
    fb_counts = np.empty(R, np.int32)
    fb_index = np.empty(F, np.uint32)
    fb_value = np.empty(F, np.float32)
    if lib.parse_feedback_text(
        raw, len(raw),
        nlines.ctypes.data, fb_counts.ctypes.data,
        fb_index.ctypes.data, fb_value.ctypes.data,
    ):
        return None
    return nlines, fb_counts, fb_index, fb_value


def pad_segment_native(
    starts: np.ndarray, counts: np.ndarray, index: np.ndarray, value: np.ndarray,
    off: int, S: int, dummy: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    R = len(starts)
    out_idx = np.empty((R, S), np.int32)
    out_val = np.empty((R, S), np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    counts = np.ascontiguousarray(counts, np.int64)
    index = np.ascontiguousarray(index, np.uint32)
    value = np.ascontiguousarray(value, np.float32)
    lib.pad_segment(
        starts.ctypes.data, counts.ctypes.data, R,
        index.ctypes.data, value.ctypes.data, off,
        S, dummy, out_idx.ctypes.data, out_val.ctypes.data,
    )
    return out_idx, out_val


def block_shuffle_native(
    block_sizes: np.ndarray, rounds: int, seed: int, elem16: bool
) -> Optional[np.ndarray]:
    """`rounds` uniform per-block permutations as block-local offsets,
    [rounds, sum(block_sizes)] (uint16 when elem16).  None if the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    block_sizes = np.ascontiguousarray(block_sizes, np.int64)
    total = int(block_sizes.sum())
    out = np.empty((rounds, total), np.uint16 if elem16 else np.int32)
    lib.block_shuffle(
        out.ctypes.data, 1 if elem16 else 0, block_sizes.ctypes.data,
        len(block_sizes), rounds, seed & 0xFFFFFFFFFFFFFFFF,
    )
    return out
