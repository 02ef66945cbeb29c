# Verbatim copy of svdfeature_tpu/data/streaming.py; tests/test_torch_data.py keeps the two identical.
"""Out-of-core streaming input pipeline.

The reference's reason for 4 MiB pages and the producer-thread double
buffer (apex-utils/apex_buffer_loader.h:39-233, apex_svd_data.h:239-345)
is training datasets that do not fit in memory.  The TPU-native
equivalent: read the binary feature buffer incrementally in bounded
CHUNKS of examples, pack each chunk on the host, and overlap the host
read+pack+device transfer of chunk i+1 with the on-device training of
chunk i — one producer thread and a depth-2 queue, exactly the
reference's ThreadBufferIterator discipline with the device as the
consumer.

Trajectory guarantee: when ``examples_per_chunk`` is a multiple of the
solver batch size, the chunked batch partitioning is identical to the
staged whole-dataset packing, so streaming produces the SAME parameter
trajectory (padding rows carry weight 0); pinned by
tests/test_streaming.py.

Shape stability: all chunks are packed to identical [Tc, B, S] shapes
(final partial chunk padded with empty batches), and the per-row segment
widths are discovered by a cheap structure-only pre-scan of the buffer
(row_ptr arrays only, feature data skipped with seek) — one compilation
covers the whole stream.
"""

from __future__ import annotations

import struct
import threading
import queue
from typing import Iterator, Optional

import numpy as np

from .csr import CSRDataset


class StreamingCSRBuffer:
    """Bounded-memory reader over a random-order binary buffer
    (SVDFeatureCSRFactory layout, apex_svd_data.cpp:116-270)."""

    def __init__(self, path: str, examples_per_chunk: int = 1 << 20):
        self.path = path
        self.examples_per_chunk = examples_per_chunk
        self.num_row = 0
        # structure pre-scan: row counts + per-segment max nnz per row
        self.max_nnz = [1, 1, 1]
        with open(path, "rb") as f:
            (self.num_batch, self.batch_size_file, _) = struct.unpack(
                "<iii", f.read(12)
            )
            for _ in range(self.num_batch):
                num_row, num_val = struct.unpack("<ii", f.read(8))
                rp = np.frombuffer(f.read(4 * (3 * num_row + 1)), "<i4")
                seg = rp.reshape(-1)[: 3 * num_row + 1]
                lens = np.diff(seg.astype(np.int64))
                if num_row:
                    per_row = lens.reshape(num_row, 3)
                    for s in range(3):
                        m = int(per_row[:, s].max(initial=0))
                        if m > self.max_nnz[s]:
                            self.max_nnz[s] = m
                self.num_row += num_row
                f.seek(4 * num_row + 8 * num_val, 1)

    def chunks(self) -> Iterator[CSRDataset]:
        """Yield CSRDatasets of at most examples_per_chunk rows each."""
        from .buffer import _read_csr_block

        with open(self.path, "rb") as f:
            f.read(12)
            parts = []
            rows = 0
            for _ in range(self.num_batch):
                blk = _read_csr_block(f)
                parts.append(blk)
                rows += blk.num_row
                if rows >= self.examples_per_chunk:
                    yield CSRDataset.concat(parts)
                    parts, rows = [], 0
            if parts:
                yield CSRDataset.concat(parts)


def stream_train_round(trainer, source: StreamingCSRBuffer, prefetch: int = 2):
    """One training round over a streaming source with a producer thread.

    The producer reads, packs and stages chunk i+1 while chunk i trains
    on device (jax dispatch is asynchronous, so staging overlaps compute
    naturally; the queue bounds host memory to ``prefetch`` chunks).
    Staging goes through trainer.stage_chunk: data-sharded over a mesh
    (each host its own slice) or a plain device_put single-device.
    """
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    Tc = -(-min(source.examples_per_chunk, source.num_row) // trainer.batch_size)

    def produce():
        try:
            for chunk in source.chunks():
                if stop.is_set():
                    return
                arrays, nrow = trainer.pack_chunk(chunk, Tc, source.max_nnz)
                if not _put_checking_stop(q, (trainer.stage_chunk(arrays), nrow), stop):
                    return
        except BaseException as e:  # pragma: no cover
            _put_checking_stop(q, e, stop)
            return
        _put_checking_stop(q, None, stop)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            arrays, _ = item
            trainer.train_chunk(arrays)
    finally:
        _drain_and_join(q, stop, t)


def _put_checking_stop(q: queue.Queue, item, stop: threading.Event) -> bool:
    """put() that keeps observing the stop flag — a producer must never
    stay blocked on a full queue after the consumer has failed."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


def _drain_and_join(q: queue.Queue, stop: threading.Event, t: threading.Thread):
    stop.set()
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass
    t.join(timeout=30)


class StreamingPlusBuffer:
    """Bounded-memory reader over a user-group binary buffer
    (SVDPlusBlockFactory layout, apex_svd_data.cpp:556-671) — the
    streaming source for SVD++-family training.

    ``blocks_per_chunk`` counts LOGICAL user blocks: split
    START..MIDDLE..END families (apex_svd_data.h:353-371) are never cut
    across streamed chunks, so merge_split_blocks inside pack_plus sees
    complete families.  The structure pre-scan records per-logical-block
    row counts, feedback sizes and raw per-row segment widths; a
    pack-shape plan (``plan_caps``) derived from them lets every chunk
    compile to ONE program (pack_plus caps).
    """

    def __init__(self, path: str, blocks_per_chunk: int = 1 << 12):
        from .csr import TAG_DEFAULT, TAG_END

        self.path = path
        self.blocks_per_chunk = blocks_per_chunk
        self.max_nnz = [1, 1, 1]
        self._caps_cache: dict = {}
        # per PHYSICAL block: (rows, nfb, tag); logical sizes accumulated
        self.phys: list = []
        self.logical_sizes: list = []  # rows per logical block
        self.logical_fb: list = []  # feedback entries per logical block
        self.logical_phys_count: list = []  # physical blocks per logical
        pend_rows = pend_fb = pend_cnt = 0
        with open(path, "rb") as f:
            (num_batch,) = struct.unpack("<i", f.read(4))
            f.read(12)
            for _ in range(num_batch):
                (raw,) = struct.unpack("<i", f.read(4))
                if raw < 0:
                    nfb = raw & 0x7FFFFFFF
                    (tag,) = struct.unpack("<i", f.read(4))
                else:
                    nfb, tag = raw, TAG_DEFAULT
                f.seek(8 * nfb, 1)
                num_row, num_val = struct.unpack("<ii", f.read(8))
                rp = np.frombuffer(f.read(4 * (3 * num_row + 1)), "<i4")
                if num_row:
                    per_row = np.diff(rp.astype(np.int64)).reshape(num_row, 3)
                    for s in range(3):
                        m = int(per_row[:, s].max(initial=0))
                        if m > self.max_nnz[s]:
                            self.max_nnz[s] = m
                f.seek(4 * num_row + 8 * num_val, 1)
                self.phys.append((num_row, nfb, tag))
                pend_rows += num_row
                pend_fb += nfb
                pend_cnt += 1
                if tag in (TAG_DEFAULT, TAG_END):  # terminates a logical block
                    self.logical_sizes.append(pend_rows)
                    self.logical_fb.append(pend_fb)
                    self.logical_phys_count.append(pend_cnt)
                    pend_rows = pend_fb = pend_cnt = 0
        if pend_cnt:
            raise ValueError("unterminated split block sequence in buffer")
        self.num_block = len(self.logical_sizes)
        self.num_row = int(sum(self.logical_sizes))

    def plan_caps(self, G: int, M: int = 1, sort_local: bool = False) -> dict:
        """Stable pack_plus caps for chunks of ``blocks_per_chunk``
        logical blocks grouped G users per batch, M rows per user.
        Pure function of the pre-scan; cached per (G, M,
        blocks_per_chunk, sort_local) — it is re-requested every round,
        and the solver may round blocks_per_chunk between calls.

        sort_local=True mirrors sort_blocks under streaming: each
        streamed chunk is packed with pack_plus(sort_blocks=True), which
        sorts size-desc WITHIN the chunk (chunk-local — the stream never
        holds the whole dataset, matching the reference's bounded-memory
        iterator contract, apex-utils/apex_buffer_loader.h:39-233); the
        plan groups each chunk's sizes in that same stable size-desc
        order so the caps — and the compiled scan length t_cap, where
        the 2-3x sorted-packing win lives — are exact for the sorted
        layout."""
        K = self.blocks_per_chunk
        key = (G, M, K, bool(sort_local))
        if key in self._caps_cache:
            return self._caps_cache[key]
        sizes = np.asarray(self.logical_sizes, np.int64)
        fbs = np.asarray(self.logical_fb, np.int64)
        t_cap = f_cap = c_cap = 1
        for lo in range(0, self.num_block, K):
            s = sizes[lo : lo + K]
            fb = fbs[lo : lo + K]
            if sort_local:
                order = np.argsort(-s, kind="stable")
                s = s[order]
                fb = fb[order]
            t_c = f_c = 0
            n_groups = 0
            for g0 in range(0, len(s), G):
                t_c += -(-int(s[g0 : g0 + G].max()) // M)
                f_c = max(f_c, int(fb[g0 : g0 + G].sum()))
                n_groups += 1
            t_cap = max(t_cap, t_c)
            f_cap = max(f_cap, f_c)
            c_cap = max(c_cap, n_groups + 1)  # + the all-padding chunk
        caps = dict(
            t_cap=t_cap, f_cap=f_cap, c_cap=c_cap,
            seg_caps=tuple(self.max_nnz),
        )
        self._caps_cache[key] = caps
        return caps

    # ---- stacked multi-IMFB streams (tags = context push/pop protocol,
    # apex_multi_imfb.h:31-194, not the split-user protocol) -------------
    def _imfb_units(self):
        """Replay the pre-scan through the multi-IMFB tag walk: returns
        (per-block snapshots of context ids, per-context nfb, per-context
        depth, unit block indices).  Pure function of phys — no data read."""
        from .csr import TAG_DEFAULT, TAG_END, TAG_START

        ctx_nfb: list = []
        ctx_depth: list = []
        snapshots: list = []
        stack: list = []
        units: list = []
        for bi, (num_row, nfb, tag) in enumerate(self.phys):
            if tag in (TAG_DEFAULT, TAG_START):
                ctx_nfb.append(nfb)
                ctx_depth.append(len(stack))
                stack.append(len(ctx_nfb) - 1)
            snapshots.append(list(stack))
            if tag in (TAG_DEFAULT, TAG_END):
                if not stack:
                    raise ValueError(
                        "start tag,end tag error in implicit feedback"
                    )
                stack.pop()
            if num_row:
                units.append(bi)
        if stack:
            raise ValueError("unterminated feedback context in buffer")
        return snapshots, ctx_nfb, ctx_depth, units

    def plan_caps_imfb(
        self, G: int, M: int = 1, sort_local: bool = False
    ) -> dict:
        """Stable pack_imfb caps for streamed chunks of blocks_per_chunk
        UNITS (blocks with rows), grouped G units per pack-chunk, M rows
        per unit.  Mirrors exactly the packing every chunk will perform
        (local-context first-appearance order, pool sizes, the
        ceil-by-M scan length), so one compiled program covers the
        whole stream.  Keyed by blocks_per_chunk too — the solver may
        round it between calls.

        sort_local=True mirrors pack_imfb(sort_blocks=True) under
        streaming: units are stably size-desc sorted WITHIN each chunk
        before grouping (context semantics are order-free — each unit
        keeps its walk snapshot), so the caps match the sorted layout."""
        K = self.blocks_per_chunk
        key = ("imfb", G, M, K, bool(sort_local))
        if key in self._caps_cache:
            return self._caps_cache[key]
        snapshots, ctx_nfb, _, units = self._imfb_units()
        t_cap = f_cap = c_cap = d_cap = m_cap = 1
        for lo in range(0, len(units), K):
            chunk_units = units[lo : lo + K]
            if sort_local:
                usizes = np.array(
                    [self.phys[bi][0] for bi in chunk_units], np.int64
                )
                order = np.argsort(-usizes, kind="stable")
                chunk_units = [chunk_units[int(i)] for i in order]
            n_groups = 0
            t_c = 0
            for g0 in range(0, len(chunk_units), G):
                group = chunk_units[g0 : g0 + G]
                t_c += -(-max(self.phys[bi][0] for bi in group) // M)
                seen: list = []
                for bi in group:
                    d_cap = max(d_cap, len(snapshots[bi]))
                    for c in snapshots[bi]:
                        if c not in seen:
                            seen.append(c)
                m_cap = max(m_cap, len(seen))
                f_cap = max(f_cap, sum(ctx_nfb[c] for c in seen))
                n_groups += 1
            t_cap = max(t_cap, t_c)
            c_cap = max(c_cap, n_groups + 1)  # + the all-padding chunk
        caps = dict(
            t_cap=t_cap, f_cap=f_cap, c_cap=c_cap, d_cap=d_cap, m_cap=m_cap,
            seg_caps=tuple(self.max_nnz),
        )
        self._caps_cache[key] = caps
        return caps

    def chunks_imfb(self):
        """Yield (PlusDataset, initial_stack) fragments of at most
        blocks_per_chunk UNITS each; initial_stack carries the contexts
        still open at the fragment boundary as (fb_index, fb_value,
        depth), innermost last, so pack_imfb resolves carried scopes
        exactly as the whole-dataset walk."""
        from .buffer import _read_csr_block
        from .csr import (
            PlusBlock,
            PlusDataset,
            TAG_DEFAULT,
            TAG_END,
            TAG_START,
        )

        with open(self.path, "rb") as f:
            f.read(16)
            blocks: list = []
            n_units = 0
            stack: list = []  # open contexts: (fb_index, fb_value, depth)
            carry_in = []
            for num_row, nfb, tag in self.phys:
                (raw,) = struct.unpack("<i", f.read(4))
                if raw < 0:
                    f.read(4)
                if nfb > 0:
                    fb_index = np.frombuffer(f.read(4 * nfb), "<u4").copy()
                    fb_value = np.frombuffer(f.read(4 * nfb), "<f4").copy()
                else:
                    fb_index = np.zeros(0, np.uint32)
                    fb_value = np.zeros(0, np.float32)
                data = _read_csr_block(f)
                blocks.append(PlusBlock(fb_index, fb_value, data, extend_tag=tag))
                if tag in (TAG_DEFAULT, TAG_START):
                    stack.append((fb_index, fb_value, len(stack)))
                if tag in (TAG_DEFAULT, TAG_END):
                    stack.pop()
                if num_row:
                    n_units += 1
                    if n_units == self.blocks_per_chunk:
                        yield PlusDataset.from_blocks(blocks), carry_in
                        blocks, n_units = [], 0
                        carry_in = list(stack)
            if blocks:
                yield PlusDataset.from_blocks(blocks), carry_in

    def chunks(self) -> Iterator[PlusDataset]:
        """Yield PlusDatasets of at most blocks_per_chunk logical blocks."""
        from .buffer import _read_csr_block
        from .csr import PlusBlock, PlusDataset, TAG_DEFAULT, TAG_END

        with open(self.path, "rb") as f:
            f.read(16)
            blocks: list = []
            logical = 0
            for num_row, nfb, tag in self.phys:
                (raw,) = struct.unpack("<i", f.read(4))
                if raw < 0:
                    f.read(4)
                if nfb > 0:
                    fb_index = np.frombuffer(f.read(4 * nfb), "<u4").copy()
                    fb_value = np.frombuffer(f.read(4 * nfb), "<f4").copy()
                else:
                    fb_index = np.zeros(0, np.uint32)
                    fb_value = np.zeros(0, np.float32)
                data = _read_csr_block(f)
                blocks.append(PlusBlock(fb_index, fb_value, data, extend_tag=tag))
                if tag in (TAG_DEFAULT, TAG_END):  # logical block complete
                    logical += 1
                    if logical == self.blocks_per_chunk:
                        yield PlusDataset.from_blocks(blocks)
                        blocks, logical = [], 0
            if blocks:
                yield PlusDataset.from_blocks(blocks)


def stream_train_round_imfb(trainer, source: StreamingPlusBuffer, prefetch: int = 2):
    """One stacked multi-IMFB training round over a streaming user-group
    source (the reference trains extend_type=2 from its buffer iterator
    like every solver, apex-utils/apex_buffer_loader.h:39-233 feeding
    apex_multi_imfb.h:31-194).  Same producer/consumer discipline as
    stream_train_round_plus; open feedback contexts carry across chunk
    boundaries via pack_imfb's initial_stack, and the trajectory equals
    whole-dataset packing when blocks_per_chunk is a multiple of
    users_per_batch (pinned by tests/test_streaming.py)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    caps = source.plan_caps_imfb(
        trainer.users_per_batch, trainer.rows_per_user,
        sort_local=bool(getattr(trainer, "sort_blocks", 0)),
    )

    def produce():
        try:
            for chunk, carry in source.chunks_imfb():
                if stop.is_set():
                    return
                entry = trainer.pack_imfb_chunk(chunk, carry, caps)
                if not _put_checking_stop(q, trainer.stage_chunk_imfb(entry), stop):
                    return
        except BaseException as e:  # pragma: no cover
            _put_checking_stop(q, e, stop)
            return
        _put_checking_stop(q, None, stop)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            trainer.train_chunk_imfb(item)
    finally:
        _drain_and_join(q, stop, t)


def stream_train_round_plus(trainer, source: StreamingPlusBuffer, prefetch: int = 2):
    """One SVD++ training round over a streaming user-group source.

    Same producer/consumer discipline as stream_train_round; the
    trajectory equals whole-dataset packing when blocks_per_chunk is a
    multiple of users_per_batch (the chunk grouping is then identical —
    pinned by tests/test_streaming.py)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    caps = source.plan_caps(
        trainer.users_per_batch, trainer.rows_per_user,
        sort_local=bool(getattr(trainer, "sort_blocks", 0)),
    )

    def produce():
        try:
            for chunk in source.chunks():
                if stop.is_set():
                    return
                entry = trainer.pack_plus_chunk(chunk, caps)
                if not _put_checking_stop(q, trainer.stage_chunk_plus(entry), stop):
                    return
        except BaseException as e:  # pragma: no cover
            _put_checking_stop(q, e, stop)
            return
        _put_checking_stop(q, None, stop)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            trainer.train_chunk_plus(item)
    finally:
        _drain_and_join(q, stop, t)
