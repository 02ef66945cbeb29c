"""Big-table SVD++ epoch: ops/svdpp.train_epoch_plus on the augmented
big-table layout (ops/big_embed.py), in plain PyTorch with K5 as its
writer.

Counterpart of svdfeature_tpu/ops/svdpp_big.py.  Above ``BIG_TABLE_ROWS``
the small-table SVD++ path keeps two dense tables and K2 takes neither the
augmented layout nor such tables; this module keeps the exact
chunk-carried algorithm of train_epoch_plus (pack-time overlap matrices,
``fb_sum += O @ delta``, the pool touched twice per chunk; reference
semantics prepare_ufeedback / update_ufeedback, apex_svd_base.h:523-554)
and routes all table-sized work through the big-table primitives:

  - per-step row updates: big_embed's forward with the feedback term and
    its sorted-dedup merge, one unique-row write (K5);
  - chunk-entry aggregates: row gathers of the chunk's pool and
    ops/svdpp._fb_aggregates;
  - chunk-exit flush (``_fb_writeback_big``): the pool deltas merged by
    sorted dedup and written as one unique-row write (K5).

With ``carry_users`` (the classic SVD++ layout: one constant user id per
unit, ``Su == 1``, distinct within a chunk, reg_method < 4; the solver
checks it at pack time, solvers/svdpp._carry_users_plan) the chunk's G
user rows are gathered once at chunk entry into a ``[G, W]`` slab, updated
densely each step (``_update_uslab``: apply_entries' math for user rows)
and written once at chunk exit (K5); each step's entry stream then holds
the item entries alone, and the pack ships their sorted-dedup layout
(``i_order``, ``i_si``, ``i_fpos``, ``i_last``), so a step sorts nothing.

The epoch is a host loop over the T steps with the chunk ids on the host
(as ops/svdpp.train_epoch_plus); a step has no host sync.  For a staged
pack everything it reads is fixed: its branches follow the host's chunk
ids alone, ``lr`` is a device scalar (``_fb_hyper`` derives the feedback
rate and decays from it on the card), the pool, the overlap and the carry
plan are the pack's tensors, and K5 updates the table in place.  So the
SVD++ solver runs a pack's first round eagerly, captures the second whole
as one CUDA graph and replays it after (solvers/round_graph.py); the
graph takes back what the capture counted and a replay counts the epoch's
``epoch_counts``.  K5 launches per epoch (``row_dma``): one per step for
its entries, one per chunk exit for the pool, and with ``carry_users`` one
more per chunk exit for the slab (``k5_launches``).  The chunk entry at
step 0 writes nothing: the reference's scan flushes a zero delta and
rewrites the slab it just read there, which leaves the table as it was.

The feedback overlap comes dense (``[C, G+1, G+1]``) or factored
(``{"diag": [C, G+1], "dup": [C, G+1, Ld]}``, O = diag + dup dupᵀ, exact;
ops/fb_overlap.build): the dense O is about 1.7 GB at G = 4096.  Requires
common_feedback_space=0 (feedback rows disjoint from user rows) and the
dedup write path.  The update is in
place on ``state.w``.

Traced (tracing.py) as ``chunk.entry`` (``slab.gather`` with the carry,
``aggregates``) at each chunk's first step, ``step`` a step (``forward``,
then ``merge`` / ``write`` as big_embed's, ``slab.update`` with the carry;
the entry-stream body's ``dedup_step`` spans; then ``fb.recurrence``) and
``chunk.exit`` (``pool.writeback``, ``slab.write``), with the counters
``chunks`` and ``steps``; none of them reads the card.  Spans are
recorded in eager and capture rounds only: a replay runs no host code.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from .. import losses, tracing
from .big_embed import (_global_catchup, _global_step, apply_entries, dedup_step, gather_rows,
                        sorted_dedup, write_rows_unique)
from .embed import (_PLANES, HyperParams, TrainConsts, TrainState, _apply_factor_reg,
                    _gather_sum, _touch_counts)
from .svdpp import (PlusHyper, _fb_aggregates, _fb_hyper, _fb_recurrence, _inv_norm, _is_first,
                    _pool)

F32 = torch.float32
I32 = torch.int32
# the static sorted-dedup layout of the item entries (solvers/svdpp.py ships
# it with the carry plan; big_embed.make_dedup_layout)
LAYOUT_PLANES = ("i_order", "i_si", "i_fpos", "i_last")


def _keep_rows(rows: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``rows`` where ``keep``, else zero rows; selected through the int32
    view, so the ref column's bits pass unchanged."""
    return torch.where(keep[:, None], rows.view(I32), 0).view(F32)


def _fb_writeback_big(w, cfb, delta_pad, delta_b_pad, k: int, row_dma: bool) -> torch.Tensor:
    """Accumulate a chunk's pool deltas into the augmented table in place:
    ``w[fb_idx, :k] += delta[fb_block] * fval`` (and the bias lane when
    ``delta_b_pad`` is given), update_ufeedback's writeback
    (apex_svd_base.h:539-554) summed over the chunk.  Pool rows shared by
    the chunk's users merge by sorted dedup; every non-last or padded
    entry goes to the dummy row with a zero row (K5's contract)."""
    dummy = w.shape[0] - 1
    fval = cfb["fb_val"]
    blk = cfb["fb_block"]
    dw = delta_pad[blk] * fval[:, None]
    db = delta_b_pad[blk] * fval if delta_b_pad is not None else torch.zeros_like(fval)
    _, si, acc, _, last = sorted_dedup(cfb["fb_idx"], torch.cat([dw, db[:, None]], dim=1))
    rows = gather_rows(w, si)
    rows[:, :k] += acc[:, :k]
    if delta_b_pad is not None:
        rows[:, k] += acc[:, k]
    is_real = last & (si != dummy)
    tgt = torch.where(is_real, si, dummy).to(I32)
    return write_rows_unique(w, tgt, _keep_rows(rows, is_real), row_dma=row_dma)


def _ov_slice(fb_overlap, c: int):
    """Chunk c's overlap: a dense ``[G+1, G+1]`` matrix or the factored
    pair ``(diag [G+1], dup [G+1, Ld])``."""
    if isinstance(fb_overlap, dict):
        return fb_overlap["diag"][c], fb_overlap["dup"][c]
    return fb_overlap[c]


class CarryForward(NamedTuple):
    """What the front half of a user-carry step hands on."""

    g: torch.Tensor
    ref_g: torch.Tensor
    ent_idx: torch.Tensor  # [B*Si] the item entries
    payload: torch.Tensor  # [B*Si, k+3] with cnt_u = 0
    rows_i: torch.Tensor  # [B, Si, W]
    wi: torch.Tensor  # [B, Si, k]
    nstep: torch.Tensor
    err: torch.Tensor  # [B]
    p_i: torch.Tensor  # [B, k]
    du: torch.Tensor  # [G, k] the user rows' factor updates
    dbu: torch.Tensor  # [G] their bias updates
    cu_g: torch.Tensor  # [G] their touch counts


def _forward_entries_carry(state: TrainState, batch: Dict[str, torch.Tensor], uslab: torch.Tensor,
                           lr, consts: TrainConsts, hp: HyperParams, M: int,
                           p_u_extra=None, bias_extra=None) -> CarryForward:
    """big_embed._forward_entries with the user rows read from the chunk's
    slab ``uslab [G, W]`` and only the item entries emitted; the user
    rows' updates come back dense per unit (svdpp_big.py:114-212).  Padded
    slots carry u_val = 0, so their p_u share vanishes; their touch counts
    are masked by u_idx != dummy."""
    w, g = state.w, state.g
    k = hp.num_factor
    dummy = w.shape[0] - 1
    u_idx, i_idx, g_idx = batch["u_idx"], batch["i_idx"], batch["g_idx"]
    u_val, i_val = batch["u_val"], batch["i_val"]
    B = u_idx.shape[0]
    G = B // M
    step0 = state.step
    cg = _touch_counts(g.shape[0], g_idx)
    g, ref_g = _global_catchup(g, state.ref_g, cg, step0, lr, consts, hp)

    rows_i = gather_rows(w, i_idx)  # [B, Si, W]
    wi, bi = rows_i[..., :k], rows_i[..., k]
    uv = u_val[:, 0].reshape(G, M)
    p_u = (uv[..., None] * uslab[:, None, :k]).reshape(B, k)
    p_i = (i_val[..., None] * wi).sum(dim=1)
    if p_u_extra is not None:
        p_u = p_u + p_u_extra
    score = hp.base_score + _gather_sum(g, g_idx, batch["g_val"])
    score = score + (i_val * bi).sum(dim=1)
    if not hp.no_user_bias:
        score = score + (uv * uslab[:, None, k]).reshape(B)
        if bias_extra is not None:
            score = score + bias_extra
    score = score + (p_u * p_i).sum(dim=1)
    pred = losses.map_active(score, hp.active_type)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]
    lr_err = lr * err
    g = _global_step(g, g_idx, batch["g_val"], err, cg, lr, consts, hp)

    # the item half of the entry stream (big_embed.entry_payload)
    coef_i = lr_err[:, None] * i_val
    E = coef_i.numel()
    payload = torch.cat([(coef_i[..., None] * p_u[:, None, :]).reshape(E, k),
                         coef_i.reshape(E, 1), torch.zeros((E, 1), dtype=F32, device=w.device),
                         torch.ones((E, 1), dtype=F32, device=w.device)], dim=1)
    # the user rows' updates, dense per unit
    coef_u = (lr_err * u_val[:, 0]).reshape(G, M)
    du = (coef_u[..., None] * p_i.reshape(G, M, k)).sum(dim=1)
    dbu = torch.zeros_like(coef_u[:, 0]) if hp.no_user_bias else coef_u.sum(dim=1)
    cu_g = (u_idx[:, 0] != dummy).to(F32).reshape(G, M).sum(dim=1)
    nstep = step0 + (batch["weight"] > 0).sum().to(I32)
    return CarryForward(g=g, ref_g=ref_g, ent_idx=i_idx.reshape(-1), payload=payload,
                        rows_i=rows_i, wi=wi, nstep=nstep, err=err, p_i=p_i, du=du, dbu=dbu,
                        cu_g=cu_g)


def _update_uslab(uslab: torch.Tensor, f: CarryForward, lr, wd_u_g: torch.Tensor,
                  consts: TrainConsts, hp: HyperParams) -> None:
    """One step's update of the slab's user rows in place: apply_entries'
    math for rows with ci = 0 and reg_method 0-3 (``(w + dw)`` regularized
    by the unit's touch count, the nonnegative clamp, the bias and its
    decay).  The ref lane rides through (inert outside the lazy modes)."""
    k = hp.num_factor
    zero = torch.zeros_like(f.cu_g)
    new_w = _apply_factor_reg(uslab[:, :k] + f.du, f.cu_g, zero, lr, wd_u_g, zero, hp.reg_method)
    if hp.user_nonnegative:
        new_w = torch.where((f.cu_g > 0)[:, None], torch.clamp(new_w, min=0.0), new_w)
    new_b = uslab[:, k] + f.dbu
    if not hp.no_user_bias:
        new_b = new_b * torch.pow(1.0 - lr * consts.wd_user_bias, f.cu_g)
    uslab[:, :k] = new_w
    uslab[:, k] = new_b


def epoch_counts(chunk_id: np.ndarray) -> Dict[str, int]:
    """The tracer's counters one epoch adds: its ``steps`` and ``chunks``."""
    return {"steps": len(chunk_id), "chunks": int(np.count_nonzero(_is_first(chunk_id)))}


def k5_launches(chunk_id: np.ndarray, carry_users: bool) -> int:
    """K5 launches of one epoch with ``row_dma``: a step's entry write, and
    at each chunk exit the pool writeback (and the slab's write)."""
    n = epoch_counts(chunk_id)
    return n["steps"] + n["chunks"] * (2 if carry_users else 1)


@torch.no_grad()
def train_epoch_plus_big(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    fb_overlap,
    lr: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
    carry_users: bool = False,
) -> TrainState:
    """One pass over the ``[T, G*M]`` steps on the augmented table
    (svdfeature_tpu/ops/svdpp_big.train_epoch_plus_big): the recurrence of
    ops/svdpp.train_epoch_plus with table-sized reads and writes through
    the big-table step.  ``state`` is in the augmented layout
    (big_embed.augment_state) with ``hp.big_table``; ``carry_users`` needs
    ``fb["chunk_users"] [C, G]`` (dummy where a unit names no user)."""
    if not hp.big_table or hp.sweep_table:
        raise ValueError("the big-table SVD++ epoch takes the augmented dedup layout")
    if carry_users and hp.reg_method >= 4:
        raise ValueError("the user-carry epoch takes eager regularization only (reg_method < 4)")
    T, GS = stacked["label"].shape
    M = ph.rows_per_user
    G = GS // M
    k = hp.num_factor
    dev = state.w.device
    dummy = state.w.shape[0] - 1
    lr_fb, d, db = _fb_hyper(lr, ph)
    with_bias = not hp.no_user_bias
    cid = np.asarray(chunk_id)
    first = _is_first(cid)
    dacc = torch.zeros((G + 1, k), dtype=F32, device=dev)
    dbacc = torch.zeros((G + 1,), dtype=F32, device=dev)
    planes = _PLANES + tuple(p for p in LAYOUT_PLANES if p in stacked)
    chunk_users = fb["chunk_users"] if carry_users else None
    if carry_users:
        no_rows_u = torch.zeros((0, 1, state.w.shape[1]), dtype=F32, device=dev)
        no_wu = torch.zeros((0, 1, k), dtype=F32, device=dev)

    def chunk_exit(w: torch.Tensor, c: int) -> None:
        # pool first, then the slab, then the next chunk's gather: the
        # regions are disjoint only in that order (svdpp_big.py:273-281)
        if tracing.on:
            tracing.begin("chunk.exit")
            tracing.begin("pool.writeback")
        _fb_writeback_big(w, _pool(fb, c), dacc, dbacc if with_bias else None, k, hp.row_dma)
        if carry_users:
            if tracing.on:
                tracing.then("slab.write")
            ids = chunk_users[c]
            write_rows_unique(w, ids, _keep_rows(uslab, ids != dummy), row_dma=hp.row_dma)
        if tracing.on:
            tracing.end()
            tracing.end()

    pc = int(cid[0])
    for t in range(T):
        c = int(cid[t])
        if first[t]:
            w = state.w
            if t > 0:
                chunk_exit(w, pc)
            if tracing.on:
                tracing.count("chunks")
                tracing.begin("chunk.entry")
            if carry_users:
                if tracing.on:
                    tracing.begin("slab.gather")
                ids = chunk_users[c]
                uslab = _keep_rows(gather_rows(w, ids), ids != dummy)
                wd_u_g = consts.wd_u_row[ids]
                if tracing.on:
                    tracing.end()
            if tracing.on:
                tracing.begin("aggregates")
            s, nrm, sb = _fb_aggregates(w[:, :k], w[:, k], _pool(fb, c), G + 1, with_bias)
            fb_sum, fb_bias, norm = s[:G], sb[:G], nrm[:G]
            inv = _inv_norm(norm)
            O = _ov_slice(fb_overlap, c)
            dacc.zero_()
            dbacc.zero_()
            if tracing.on:
                tracing.end()
                tracing.end()
        pc = c
        if tracing.on:
            tracing.count("steps")
            tracing.begin("step")
        batch = {p: stacked[p][t] for p in planes}
        fb_slot = fb_sum.repeat_interleave(M, dim=0) if M > 1 else fb_sum
        fbb_slot = (fb_bias.repeat_interleave(M) if M > 1 else fb_bias) if with_bias else None
        if carry_users:
            if tracing.on:
                tracing.begin("forward")
            f = _forward_entries_carry(state, batch, uslab, lr, consts, hp, M, fb_slot, fbb_slot)
            layout = tuple(batch[p] for p in LAYOUT_PLANES) if "i_order" in batch else None
            if tracing.on:
                tracing.end()
            w = apply_entries(state.w, state.step, f.ent_idx, f.payload, no_rows_u, f.rows_i,
                              no_wu, f.wi, lr, consts, hp, layout=layout)
            if tracing.on:
                tracing.begin("slab.update")
            _update_uslab(uslab, f, lr, wd_u_g, consts, hp)
            state = TrainState(w=w, b=state.b, g=f.g, step=f.nstep, ref_ui=state.ref_ui,
                               ref_g=f.ref_g)
            if tracing.on:
                tracing.end()
        else:
            state, f = dedup_step(state, batch, lr, consts, hp, fb_slot, fbb_slot)
        if tracing.on:
            tracing.begin("fb.recurrence")
        fb_sum, fb_bias = _fb_recurrence(f.err, f.p_i, batch["weight"], fb_sum, fb_bias, norm, inv,
                                         O, dacc, dbacc, lr_fb, d, db, M, with_bias)
        if tracing.on:
            tracing.end()
            tracing.end()
    chunk_exit(state.w, pc)
    return state
