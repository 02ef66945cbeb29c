# Verbatim copy of svdfeature_tpu/data/batching_plus.py; tests/test_torch_data.py keeps the two identical.
"""User-group (SVD++) batch packing: one-row-per-user batches.

Why this layout (it differs deliberately from the reference's
block-at-a-time loop, and from naive global batching):

* The reference trains user blocks sequentially; its shared-feedback-row
  writebacks and per-user bias updates are stable because each update is
  visible to the next row (Gauss-Seidel).  Batching either (a) many rows
  of one user, or (b) the feedback writebacks of very many users into one
  simultaneous step multiplies the effective step size in the conflicting
  subspace and diverges.
* Layout: blocks are grouped (in data order) into chunks of G blocks;
  batch t of a chunk holds row t of each of its G users — exactly one row
  per user per batch, so per-batch scatter conflicts on user rows are 1
  and the feedback-writeback Jacobi width is G (stable for
  lr * G * overlap << 2; G defaults to 128).  sort_blocks=True sorts by
  size to cut padding (~3x on ML-100K) at a measurable early-convergence
  cost.
* The feedback pools are per-chunk [C, F]; the train step refreshes the
  per-block feedback aggregates from the live tables every batch and
  writes the per-batch feedback delta straight back — freshness is
  per-batch, i.e. better than the reference's per-block freshness.
* START/MIDDLE/END split sequences (apex_svd_data.cpp:470-505) are merged
  into logical blocks at pack time — equivalent to the reference's carried
  tmp/old_ufeedback threading (apex_svd_base.h:568-582).

Output: row arrays [T, G, ...] (T = total batches across chunks),
chunk_id [T], feedback pools [C, F].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .csr import CSRDataset, PlusBlock, PlusDataset, TAG_DEFAULT, TAG_END, TAG_START
from .batching import _pad_segment, _segment_entries, expand_segment
from ..utils.sparse_feature_array import SparseFeatureArray


@dataclasses.dataclass
class PackedPlusBatches:
    label: np.ndarray  # [T, G]
    weight: np.ndarray
    g_idx: np.ndarray  # [T, G, Sg]
    g_val: np.ndarray
    u_idx: np.ndarray
    u_val: np.ndarray
    i_idx: np.ndarray
    i_val: np.ndarray
    chunk_id: np.ndarray  # [T] i32
    fb_idx: np.ndarray  # [C, F]
    fb_val: np.ndarray  # [C, F]
    fb_block: np.ndarray  # [C, F] chunk-local block slot (pad = G)
    fb_overlap: np.ndarray  # [C, G+1, G+1]: O[u,v] = sum_f val_uf * val_vf
    perm: np.ndarray  # [R]: dataset row -> packed slot (t*G*M + g*M + m)
    num_blocks_local: int  # G
    rows_per_user: int = 1  # M

    def device_arrays(self) -> Dict[str, np.ndarray]:
        d = dataclasses.asdict(self)
        for k in (
            "perm", "num_blocks_local", "rows_per_user",
            "fb_idx", "fb_val", "fb_block", "fb_overlap",
        ):
            d.pop(k)
        return d

    def fb_arrays(self) -> Dict[str, np.ndarray]:
        return {"fb_idx": self.fb_idx, "fb_val": self.fb_val, "fb_block": self.fb_block}


def compute_fb_overlap(fb_idx, fb_val, fb_block, G: int) -> np.ndarray:
    """Per-chunk user-overlap matrices O[u,v] = sum_f val_uf * val_vf over
    shared feedback ids — the closed form of "how one user's feedback
    writeback shifts another's re-gathered feedback sum"
    (ops/svdpp.train_epoch_plus carries fb_sum with fb_sum += O @ delta
    instead of re-gathering the pool every batch).  Recompute after any
    value filtering of the pool (e.g. bilinear start_ufeedback)."""
    C = fb_idx.shape[0]
    fb_overlap = np.zeros((C, G + 1, G + 1), np.float32)
    for c in range(C):
        live = fb_val[c] != 0
        if not live.any():
            continue
        ids = fb_idx[c][live]
        _, local = np.unique(ids, return_inverse=True)
        P = np.zeros((G + 1, local.max() + 1), np.float32)
        np.add.at(P, (fb_block[c][live], local), fb_val[c][live])
        fb_overlap[c] = P @ P.T
    return fb_overlap


def compute_fb_overlap_factored(fb_idx, fb_val, fb_block, G: int):
    """Exact factored form of compute_fb_overlap for LARGE G.

    The dense O is [C, G+1, G+1] — 1.7 GB at the big-table bench's
    G=4096 — but its off-diagonal mass comes ONLY from feedback ids
    duplicated across users WITHIN a chunk.  Split by id:

        O = D1 + Pd @ Pd.T

    where D1 is the diagonal of the non-duplicated entries' val^2 and
    Pd [G+1, Ld] holds the duplicated ids' values (its product carries
    their diagonal contributions too).  At KDD scale Ld is ~1e2 per
    chunk (birthday collisions of ~1e4 entries over ~6e5 ids), so the
    per-batch correction O @ d becomes diag*d + two skinny matmuls and
    the stored arrays shrink ~1000x.

    Returns (diag [C, G+1], dup [C, G+1, Ld]) with Ld = max over
    chunks (padded with zero columns), or None when the factored form
    would not be smaller (Ld > G+1 — densely duplicated pools, e.g.
    demo-scale data; the caller falls back to the dense O)."""
    C = fb_idx.shape[0]
    diag = np.zeros((C, G + 1), np.float32)
    cols: List[np.ndarray] = []
    for c in range(C):
        live = fb_val[c] != 0
        ids = fb_idx[c][live]
        blocks_c = fb_block[c][live]
        vals = fb_val[c][live]
        if not len(ids):
            cols.append(np.zeros((G + 1, 0), np.float32))
            continue
        uniq, inv, cnt = np.unique(ids, return_inverse=True,
                                   return_counts=True)
        dup_id = cnt > 1
        solo = ~dup_id[inv]
        np.add.at(diag[c], blocks_c[solo], vals[solo] ** 2)
        ndup = int(dup_id.sum())
        P = np.zeros((G + 1, ndup), np.float32)
        if ndup:
            remap = np.full(len(uniq), -1, np.int64)
            remap[dup_id] = np.arange(ndup)
            sel = ~solo
            np.add.at(P, (blocks_c[sel], remap[inv[sel]]), vals[sel])
        cols.append(P)
    Ld = max(p.shape[1] for p in cols)
    if Ld > G + 1:
        return None  # dense is smaller; not the big-table regime
    dup = np.zeros((C, G + 1, max(Ld, 1)), np.float32)
    for c, p in enumerate(cols):
        dup[c, :, : p.shape[1]] = p
    return diag, dup


def merge_split_blocks(ds: PlusDataset) -> List[PlusBlock]:
    """Merge START..MIDDLE..END chunk sequences into logical blocks."""
    out: List[PlusBlock] = []
    pending: List[PlusBlock] = []
    for blk in ds.blocks():
        if blk.extend_tag == TAG_DEFAULT:
            assert not pending, "unterminated split block sequence"
            out.append(blk)
        elif blk.extend_tag == TAG_START:
            assert not pending, "nested split block sequence"
            pending = [blk]
        elif blk.extend_tag == TAG_END:
            pending.append(blk)
            merged = PlusBlock(
                fb_index=pending[0].fb_index,
                fb_value=pending[0].fb_value,
                data=CSRDataset.concat([p.data for p in pending]),
                extend_tag=TAG_DEFAULT,
                extra_info=pending[0].extra_info,
            )
            out.append(merged)
            pending = []
        else:  # MIDDLE
            assert pending, "MIDDLE block without START"
            pending.append(blk)
    assert not pending, "unterminated split block sequence"
    return out


def pack_plus(
    ds: PlusDataset,
    users_per_batch: int,
    num_rows_table: int,
    num_global: int,
    off_user: int,
    off_item: int,
    off_ufeedback: int,
    feat_user: Optional[SparseFeatureArray] = None,
    feat_item: Optional[SparseFeatureArray] = None,
    num_user: Optional[int] = None,
    num_item: Optional[int] = None,
    num_ufeedback: Optional[int] = None,
    sort_blocks: bool = False,
    rows_per_user: int = 1,
    t_cap: int = 0,
    f_cap: int = 0,
    c_cap: int = 0,
    seg_caps=None,
    factored_overlap: bool = False,
) -> PackedPlusBatches:
    """rows_per_user (M): consecutive rows of each user trained in the
    same batch.  M=1 is the strict one-row-per-user layout; M>1 widens
    the within-user Jacobi step to M rows (all read the same feedback
    state and user factors; gradients sum), cutting the number of scan
    steps per epoch by ~M — the per-user sequential chain is the epoch's
    critical path (T >= ceil(max block size / M)).  RMSE parity verified
    on the implicitFeedback demo up to M=8 (tests/test_svdpp_multirow).

    t_cap/f_cap/c_cap/seg_caps: pad the packed shapes to fixed caps so
    every chunk of a STREAM compiles to the same program
    (data/streaming.py).  When caps are given, G is pinned to
    users_per_batch, one extra all-padding chunk is reserved, and batch
    slots [T, t_cap) point at it (empty pool, zero weights)."""
    blocks = merge_split_blocks(ds)
    use_caps = bool(t_cap or f_cap or c_cap)
    if use_caps:
        G = max(1, users_per_batch)
    else:
        G = max(1, min(users_per_batch, len(blocks)))
    M = max(1, rows_per_user)

    sizes = np.array([b.data.num_row for b in blocks], np.int64)
    if sort_blocks:
        # size-desc sort minimizes padding (chunks hold similar-sized
        # blocks) but measurably hurts early-round convergence on ML-100K
        # (processing statistics deviate from the reference's data order),
        # so it is off by default
        order = np.argsort(-sizes, kind="stable")
    else:
        order = np.arange(len(blocks))
    chunks: List[np.ndarray] = [order[i : i + G] for i in range(0, len(order), G)]
    C = len(chunks)
    F = max(
        1,
        max(int(sum(blocks[int(bi)].num_ufeedback for bi in ch)) for ch in chunks),
    )
    Tcs = [-(-int(sizes[ch].max()) // M) for ch in chunks]
    T = sum(Tcs)
    GS = G * M  # slots per batch; slot = g*M + m
    C_out, T_out = C, T
    if use_caps:
        if f_cap:
            if F > f_cap:
                raise ValueError(f"chunk feedback pool {F} exceeds f_cap {f_cap}")
            F = f_cap
        T_out = max(T, t_cap)
        C_out = max(C + 1, c_cap)  # reserve the all-padding chunk
        if t_cap and T > t_cap:
            raise ValueError(f"packed scan length {T} exceeds t_cap {t_cap}")
        if c_cap and C + 1 > c_cap:
            raise ValueError(f"chunk count {C}+pad exceeds c_cap {c_cap}")

    rows_all = CSRDataset.concat([b.data for b in blocks])
    R = rows_all.num_row
    block_starts = np.cumsum(sizes) - sizes

    seg_padded = []
    seg_widths = []
    for seg, (feat, scale, off, bound, name) in enumerate(
        [
            (None, False, 0, num_global, "global"),
            (feat_user, False, off_user, num_user, "user"),
            (feat_item, True, off_item, num_item, "item"),
        ]
    ):
        idx, val, rws = _segment_entries(rows_all, seg)
        if bound is not None and len(idx) and idx.max() >= bound:
            raise ValueError(f"{name} feature index exceed bound")
        idx, val, rws = expand_segment(idx, val, rws, feat, scale)
        dummy = num_global if seg == 0 else num_rows_table
        pi, pv = _pad_segment(idx.astype(np.int64) + off, val, rws, R, dummy)
        if seg_caps is not None:
            cap = int(seg_caps[seg])
            if pi.shape[1] > cap:
                raise ValueError(
                    f"segment {name} width {pi.shape[1]} exceeds cap {cap}"
                )
            if pi.shape[1] < cap:
                pad = cap - pi.shape[1]
                pi = np.pad(pi, ((0, 0), (0, pad)), constant_values=dummy)
                pv = np.pad(pv, ((0, 0), (0, pad)))
        seg_padded.append((pi, pv))
        seg_widths.append(pi.shape[1])

    dummy_row = num_rows_table
    out = {
        "label": np.zeros((T_out, GS), np.float32),
        "weight": np.zeros((T_out, GS), np.float32),
        "g_idx": np.full((T_out, GS, seg_widths[0]), num_global, np.int32),
        "g_val": np.zeros((T_out, GS, seg_widths[0]), np.float32),
        "u_idx": np.full((T_out, GS, seg_widths[1]), dummy_row, np.int32),
        "u_val": np.zeros((T_out, GS, seg_widths[1]), np.float32),
        "i_idx": np.full((T_out, GS, seg_widths[2]), dummy_row, np.int32),
        "i_val": np.zeros((T_out, GS, seg_widths[2]), np.float32),
    }
    # padding batch slots point at the reserved all-padding chunk
    chunk_id = np.full(T_out, C_out - 1, np.int32)
    fb_idx = np.full((C_out, F), dummy_row, np.int32)
    fb_val = np.zeros((C_out, F), np.float32)
    fb_block = np.full((C_out, F), G, np.int32)
    perm = np.zeros(R, np.int64)

    t0 = 0
    for c, ch in enumerate(chunks):
        Tc = Tcs[c]
        chunk_id[t0 : t0 + Tc] = c
        # dataset-row grid: row j of user g -> batch t0 + j//M, slot g*M + j%M
        for g, bi in enumerate(ch):
            bi = int(bi)
            n = int(sizes[bi])
            r0 = int(block_starts[bi])
            rws = np.arange(r0, r0 + n)
            j = np.arange(n)
            t_ix = t0 + j // M
            s_ix = g * M + j % M
            out["label"][t_ix, s_ix] = rows_all.labels[rws]
            out["weight"][t_ix, s_ix] = 1.0
            for seg, key in enumerate(["g", "u", "i"]):
                pi, pv = seg_padded[seg]
                out[f"{key}_idx"][t_ix, s_ix] = pi[rws]
                out[f"{key}_val"][t_ix, s_ix] = pv[rws]
            perm[rws] = t_ix * GS + s_ix
            blk = blocks[bi]
            nf = blk.num_ufeedback
            if nf:
                if num_ufeedback is not None and blk.fb_index.max() >= num_ufeedback:
                    raise ValueError("ufeedback id exceed bound")
        # feedback pool
        f0 = 0
        for g, bi in enumerate(ch):
            blk = blocks[int(bi)]
            nf = blk.num_ufeedback
            if nf:
                fb_idx[c, f0 : f0 + nf] = blk.fb_index.astype(np.int64) + off_ufeedback
                fb_val[c, f0 : f0 + nf] = blk.fb_value
                fb_block[c, f0 : f0 + nf] = g
                f0 += nf
        t0 += Tc

    if factored_overlap:
        # big-table callers: the dense [C, G+1, G+1] O is ~1.7 GB at
        # G=4096 and dominates pack time; the factored form is exact
        # (see compute_fb_overlap_factored) and ~1000x smaller when
        # in-chunk id duplication is sparse.  Falls back to dense when
        # duplication is dense (Ld > G+1).
        fac = compute_fb_overlap_factored(fb_idx, fb_val, fb_block, G)
        if fac is not None:
            fb_overlap = {"diag": fac[0], "dup": fac[1]}
        else:
            fb_overlap = compute_fb_overlap(fb_idx, fb_val, fb_block, G)
    else:
        fb_overlap = compute_fb_overlap(fb_idx, fb_val, fb_block, G)

    return PackedPlusBatches(
        chunk_id=chunk_id,
        perm=perm,
        num_blocks_local=G,
        rows_per_user=M,
        fb_idx=fb_idx,
        fb_val=fb_val,
        fb_block=fb_block,
        fb_overlap=fb_overlap,
        **out,
    )
