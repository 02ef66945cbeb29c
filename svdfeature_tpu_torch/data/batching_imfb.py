# Verbatim copy of svdfeature_tpu/data/batching_imfb.py; tests/test_torch_data.py keeps the two identical.
"""Multi-IMFB (local implicit feedback) batch packing.

Port of the data layout implied by SVDPPMultiIMFB (solvers/multi-imfb/
apex_multi_imfb.h:31-194; Yang et al., RecSys'12): blocks push/pop a
*stack* of feedback contexts via their extend tags —

  DEFAULT: push own feedback, process rows, pop (plain SVD++)
  START:   push own feedback and keep it on the stack
  MIDDLE:  process rows under the current stack
  END:     process rows, then pop

The nesting is flattened at pack time: walking the block sequence with an
explicit stack assigns every *push* a context id and every block a stack
snapshot; a row's feedback term is then the sum of its block's active
contexts' feedback sums.  Rows are packed one-per-block like the SVD++
layout (chunks of G consecutive blocks), each chunk carrying its own
context feedback pool with chunk-local context slots and a per-slot depth
(for ufeedback_disable_level masks).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .csr import CSRDataset, PlusDataset, TAG_DEFAULT, TAG_END, TAG_MIDDLE, TAG_START
from .batching import _pad_segment, _segment_entries, expand_segment
from ..utils.sparse_feature_array import SparseFeatureArray


@dataclasses.dataclass
class PackedImfbBatches:
    label: np.ndarray  # [T, G]
    weight: np.ndarray
    g_idx: np.ndarray
    g_val: np.ndarray
    u_idx: np.ndarray
    u_val: np.ndarray
    i_idx: np.ndarray
    i_val: np.ndarray
    ctx_slots: np.ndarray  # [T, G, D] chunk-local context slots (pad = M)
    chunk_id: np.ndarray  # [T]
    fb_idx: np.ndarray  # [C, F]
    fb_val: np.ndarray  # [C, F]
    fb_ctx: np.ndarray  # [C, F] chunk-local context slot (pad = M)
    ctx_depth: np.ndarray  # [C, M] stack depth of each local context (pad -1)
    perm: np.ndarray  # [R]
    num_ctx_local: int  # M (local context count; NOT rows_per_user)
    rows_per_user: int = 1  # RM: consecutive rows of a unit per batch

    def device_arrays(self) -> Dict[str, np.ndarray]:
        d = dataclasses.asdict(self)
        for k in (
            "perm", "num_ctx_local", "rows_per_user",
            "fb_idx", "fb_val", "fb_ctx", "ctx_depth",
        ):
            d.pop(k)
        return d

    def fb_arrays(self) -> Dict[str, np.ndarray]:
        return {
            "fb_idx": self.fb_idx,
            "fb_val": self.fb_val,
            "fb_ctx": self.fb_ctx,
            "ctx_depth": self.ctx_depth,
        }


def pack_imfb(
    ds: PlusDataset,
    units_per_batch: int,
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
    initial_stack=None,
    t_cap: int = 0,
    f_cap: int = 0,
    c_cap: int = 0,
    d_cap: int = 0,
    m_cap: int = 0,
    seg_caps=None,
    rows_per_user: int = 1,
    sort_blocks: bool = False,
) -> PackedImfbBatches:
    """initial_stack: contexts open at dataset entry (streamed fragments
    of a larger tag stream, data/streaming.py) as (fb_index, fb_value,
    depth) triples, innermost last; the walk seeds its stack with them,
    so END/MIDDLE tags at the fragment head resolve against carried
    scopes exactly as in the whole-dataset walk.  Contexts still open at
    the fragment end are simply left unpopped — the next fragment
    carries them.

    t_cap/f_cap/c_cap/d_cap/m_cap/seg_caps: pad packed shapes to fixed
    caps so every streamed fragment compiles to ONE program (same
    discipline as pack_plus).  Under caps G is pinned to units_per_batch
    and one all-padding chunk is reserved.

    rows_per_user (RM>1): RM consecutive rows of each unit share a batch
    (slot = g*RM + m, like pack_plus) — the within-unit Jacobi widening;
    ctx_slots replicate the unit's stack snapshot on every present slot,
    so the per-context device accumulation is layout-free (ops/imfb.py
    applies the damping).

    sort_blocks: size-desc unit ordering before chunking (pack_plus's
    knob applied to stacked units) — chunks hold similar-sized units so
    the scan length T = sum ceil(max_c/RM) collapses toward the dense
    bound.  Context SEMANTICS are order-free (each unit keeps its walk
    snapshot; a context spanning reordered units simply appears in every
    chunk that hosts one of them), only the hogwild processing order
    changes — same contract as pack_plus's sort_blocks.  Under caps the
    sort is chunk-local by construction (each streamed fragment packs
    independently) and the stream planner mirrors it
    (StreamingPlusBuffer.plan_caps_imfb sort_local)."""
    # --- walk the tag-driven stack
    contexts = []  # (fb_index, fb_value, depth)
    snapshots: List[List[int]] = []  # per block: active context ids
    stack: List[int] = []
    for fbi_c, fbv_c, depth_c in initial_stack or ():
        contexts.append((fbi_c, fbv_c, depth_c))
        stack.append(len(contexts) - 1)
    for blk in ds.blocks():
        t = blk.extend_tag
        if t in (TAG_DEFAULT, TAG_START):
            if num_ufeedback is not None and blk.num_ufeedback and blk.fb_index.max() >= num_ufeedback:
                raise ValueError("ufeedback id exceed bound")
            contexts.append((blk.fb_index, blk.fb_value, len(stack)))
            stack.append(len(contexts) - 1)
        snapshots.append(list(stack))
        if t in (TAG_DEFAULT, TAG_END):
            assert stack, "start tag,end tag error in implicit feedback"
            stack.pop()
    # units = blocks with rows
    units = [
        (bi, snapshots[bi])
        for bi in range(ds.num_block)
        if ds.block_row_ptr[bi + 1] > ds.block_row_ptr[bi]
    ]
    use_caps = bool(t_cap or f_cap or c_cap or d_cap or m_cap)
    if sort_blocks:
        usizes = np.array(
            [int(ds.block_row_ptr[bi + 1] - ds.block_row_ptr[bi])
             for bi, _ in units],
            np.int64,
        )
        units = [units[int(i)] for i in np.argsort(-usizes, kind="stable")]
    D = max((len(s) for _, s in units), default=1)
    if use_caps:
        if d_cap and D > d_cap:
            raise ValueError(f"stack depth {D} exceeds d_cap {d_cap}")
        D = max(D, d_cap)
        G = max(1, units_per_batch)
    else:
        G = max(1, min(units_per_batch, len(units)))
    chunks = [units[i : i + G] for i in range(0, len(units), G)]
    C = len(chunks)

    # local context slots per chunk
    chunk_ctx: List[List[int]] = []
    for ch in chunks:
        seen = []
        for _, snap in ch:
            for c in snap:
                if c not in seen:
                    seen.append(c)
        chunk_ctx.append(seen)
    M = max((len(c) for c in chunk_ctx), default=1)
    F = max(
        (sum(len(contexts[c][0]) for c in cc) for cc in chunk_ctx), default=1
    )
    F = max(F, 1)
    if use_caps:
        if m_cap and M > m_cap:
            raise ValueError(f"local context count {M} exceeds m_cap {m_cap}")
        M = max(M, m_cap)
        if f_cap and F > f_cap:
            raise ValueError(f"chunk context pool {F} exceeds f_cap {f_cap}")
        F = max(F, f_cap)

    rows_all = ds.rows
    R = rows_all.num_row
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

    RM = max(1, rows_per_user)
    Tcs = [
        -(-max(int(ds.block_row_ptr[bi + 1] - ds.block_row_ptr[bi]) for bi, _ in ch) // RM)
        for ch in chunks
    ]
    T = sum(Tcs)
    C_out, T_out = C, T
    if use_caps:
        T_out = max(T, t_cap)
        C_out = max(C + 1, c_cap)  # reserve the all-padding chunk
        if t_cap and T > t_cap:
            raise ValueError(f"packed scan length {T} exceeds t_cap {t_cap}")
        if c_cap and C + 1 > c_cap:
            raise ValueError(f"chunk count {C}+pad exceeds c_cap {c_cap}")
    dummy_row = num_rows_table
    GS = G * RM  # slots per batch; slot = g*RM + m
    out = {
        "label": np.zeros((T_out, GS), np.float32),
        "weight": np.zeros((T_out, GS), np.float32),
        "g_idx": np.full((T_out, GS, seg_widths[0]), num_global, np.int32),
        "g_val": np.zeros((T_out, GS, seg_widths[0]), np.float32),
        "u_idx": np.full((T_out, GS, seg_widths[1]), dummy_row, np.int32),
        "u_val": np.zeros((T_out, GS, seg_widths[1]), np.float32),
        "i_idx": np.full((T_out, GS, seg_widths[2]), dummy_row, np.int32),
        "i_val": np.zeros((T_out, GS, seg_widths[2]), np.float32),
        "ctx_slots": np.full((T_out, GS, D), M, np.int32),
    }
    # padding batch slots point at the reserved all-padding chunk (all
    # contexts empty and depth -1, i.e. disabled; weights zero)
    chunk_id = np.full(T_out, C_out - 1, np.int32)
    fb_idx = np.full((C_out, F), dummy_row, np.int32)
    fb_val = np.zeros((C_out, F), np.float32)
    fb_ctx = np.full((C_out, F), M, np.int32)
    ctx_depth = np.full((C_out, M), -1, np.int32)
    perm = np.zeros(R, np.int64)

    t0 = 0
    for c, ch in enumerate(chunks):
        Tc = Tcs[c]
        chunk_id[t0 : t0 + Tc] = c
        slot_of = {cid: s for s, cid in enumerate(chunk_ctx[c])}
        f0 = 0
        for cid, s in slot_of.items():
            fbi, fbv, depth = contexts[cid]
            ctx_depth[c, s] = depth
            nf = len(fbi)
            if nf:
                fb_idx[c, f0 : f0 + nf] = fbi.astype(np.int64) + off_ufeedback
                fb_val[c, f0 : f0 + nf] = fbv
                fb_ctx[c, f0 : f0 + nf] = s
                f0 += nf
        for g, (bi, snap) in enumerate(ch):
            r0 = int(ds.block_row_ptr[bi])
            n = int(ds.block_row_ptr[bi + 1]) - r0
            rws = np.arange(r0, r0 + n)
            # row j of unit g -> batch t0 + j//RM, slot g*RM + j%RM
            j = np.arange(n)
            t_ix = t0 + j // RM
            s_ix = g * RM + j % RM
            out["label"][t_ix, s_ix] = rows_all.labels[rws]
            out["weight"][t_ix, s_ix] = 1.0
            for seg, key in enumerate(["g", "u", "i"]):
                pi, pv = seg_padded[seg]
                out[f"{key}_idx"][t_ix, s_ix] = pi[rws]
                out[f"{key}_val"][t_ix, s_ix] = pv[rws]
            for d_, cid in enumerate(snap):
                out["ctx_slots"][t_ix, s_ix, d_] = slot_of[cid]
            perm[rws] = t_ix * GS + s_ix
        t0 += Tc

    return PackedImfbBatches(
        chunk_id=chunk_id,
        perm=perm,
        num_ctx_local=M,
        rows_per_user=RM,
        fb_idx=fb_idx,
        fb_val=fb_val,
        fb_ctx=fb_ctx,
        ctx_depth=ctx_depth,
        **out,
    )
