"""Bilinear-extended SVD++ epochs (extend_type=15) in plain PyTorch.

Counterpart of svdfeature_tpu/ops/svdpp_bilinear.py (SVDBiLinearTrainer,
apex_svd_bilinear.h): the W_bi[item, bi_feedback] interaction added to the
SVD++ step,

  score     += sum_s i_val[g,s] * <W_bi[iid_s], up[g]>    (get_bias_plugin)
  W_bi[iid] += lr_bi * err * i_val * up[g]                 (update_bias_plugin)

where ``up[c, g]`` is the dense user-property vector of chunk c's user g
(its feedback entries with id < num_bi_feedback), made at pack time
(solvers/bilinear.py).  W_bi's regularization (reg_bi_feedback,
apex_svd_bilinear.h:93-128): 0 L2 and 1 L1 per touched (item, property)
pair, 4/5 as 1 (the reference's lazy counter has the base solver's
unsigned-subtraction fault; the per-touch threshold is what it means);
2 L2 and 3 L1 on the whole item row per item occurrence.

Four epochs, one per route of the solver:
  - ``train_epoch_bi``: the overlap-carried form of ops/svdpp.train_epoch_plus
    with the plugin term; W_bi moves after the row update and before the
    feedback recurrence;
  - ``train_epoch_bi_big``: the same on the augmented big-table layout,
    with the entry-stream step of ops/big_embed (K5) and W_bi updated on
    its touched rows alone (``_bi_step_big``: sorted dedup, one unique-row
    write through K5 with ``hp.row_dma``);
  - ``train_epoch_bi_refresh``: the per-batch refresh form of a feedback
    space shared with the user rows, on ops/svdpp._plus_step;
  - ``predict_batches_bi``.

``W_bi`` travels with one trailing dummy row (``W_bi_pad [num_item+1,
nbf]``), where padded slots and ids outside the item range point; it is
updated in place, as the tables are.  An empty property space (nbf = 0)
adds exactly 0 to every score, so the epochs then follow plain SVD++ bit
for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .big_embed import dedup_step, gather_rows, sorted_dedup, write_rows_unique
from .embed import (_PLANES, HyperParams, TrainConsts, TrainState, _soft_threshold, forward_scores,
                    general_step)
from .svdpp import (PlusHyper, _fb_aggregates, _fb_hyper, _fb_recurrence, _fb_writeback, _inv_norm,
                    _is_first, _plus_step, _pool)
from .svdpp_big import _fb_writeback_big, _ov_slice

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class BiHyper:
    """The W_bi switches: rate scale, decay, decay method, first item row."""

    slr_bi: float = 1.0
    wd_bi: float = 0.0
    reg_bi: int = 0
    off_item: int = 0


def _local_item_ids(i_idx: torch.Tensor, off_item: int, num_item: int):
    """(W_bi row of each item entry, its in-range mask): table rows outside
    the item range (padding included) go to the dummy row ``num_item``."""
    lid = i_idx - off_item
    ok = (lid >= 0) & (lid < num_item)
    return torch.where(ok, lid, num_item), ok


def _bi_bias(W_bi_pad: torch.Tensor, up_slot: torch.Tensor, lid: torch.Tensor,
             i_val: torch.Tensor) -> torch.Tensor:
    """The plugin bias ``[B]``: sum_s i_val[g,s] * <W_bi[lid[g,s]], up[g]>."""
    rows = gather_rows(W_bi_pad, lid)  # [B, S, nbf]
    per = torch.einsum("gsn,gn->gs", rows, up_slot)
    return (per * i_val).sum(dim=1)


def _bi_update(W_bi_pad, up_slot, batch, err, lr_bi, bh: BiHyper):
    """(lid, upd [B, S, nbf], lam, i_val): the pieces of a W_bi step."""
    lid, _ = _local_item_ids(batch["i_idx"], bh.off_item, W_bi_pad.shape[0] - 1)
    i_val = batch["i_val"]
    coef = (lr_bi * err)[:, None] * i_val
    return lid, coef[..., None] * up_slot[:, None, :], lr_bi * bh.wd_bi, i_val


def _bi_step(W_bi_pad: torch.Tensor, up_slot: torch.Tensor, batch: Dict[str, torch.Tensor],
             err: torch.Tensor, lr_bi, bh: BiHyper) -> None:
    """Update and regularize W_bi for one step, in place
    (svdpp_bilinear.py:50-85): the scatter of the step's updates, then the
    decay, per touched pair (reg_bi 0/1/4/5) or per item row occurrence
    (2/3), over the whole table as the JAX package does (untouched rows
    decay by exactly nothing)."""
    lid, upd, lam, i_val = _bi_update(W_bi_pad, up_slot, batch, err, lr_bi, bh)
    B, S = lid.shape
    flat = lid.reshape(-1).long()
    W_bi_pad.index_add_(0, flat, upd.reshape(B * S, -1))
    if bh.reg_bi in (0, 1, 4, 5):
        pair = (i_val.abs() > 0)[..., None] & (up_slot.abs() > 0)[:, None, :]
        touch = torch.zeros_like(W_bi_pad).index_add_(0, flat, pair.reshape(B * S, -1).to(F32))
        if bh.reg_bi == 0:
            W_bi_pad.mul_(torch.pow(1.0 - lam, touch))
        else:
            W_bi_pad.copy_(_soft_threshold(W_bi_pad, lam * touch))
    elif bh.reg_bi in (2, 3):
        occ = torch.where(i_val.abs() > 0, 1.0, 0.0).reshape(-1)
        cnt = torch.zeros(W_bi_pad.shape[0], dtype=F32, device=W_bi_pad.device).index_add_(
            0, flat, occ)
        if bh.reg_bi == 2:
            W_bi_pad.mul_(torch.pow(1.0 - lam, cnt)[:, None])
        else:
            W_bi_pad.copy_(_soft_threshold(W_bi_pad, (lam * cnt)[:, None]))
    else:
        raise ValueError(f"unknown bi feedback decay method {bh.reg_bi}")
    W_bi_pad[-1] = 0.0


def _bi_step_big(W_bi_pad: torch.Tensor, up_slot: torch.Tensor, batch: Dict[str, torch.Tensor],
                 err: torch.Tensor, lr_bi, bh: BiHyper, row_dma: bool) -> None:
    """``_bi_step`` on the touched rows alone (svdpp_bilinear.py:230-275):
    the step's updates and their touch counters as one payload ``[upd |
    touch]``, merged by sorted dedup, the touched rows gathered, updated,
    decayed and written once through ``write_rows_unique`` (K5 with
    ``row_dma``; duplicates and padding go to the dummy row as zeros).  The
    same numbers as the dense form: an untouched row decays by exactly
    nothing.  An empty property space writes nothing."""
    num_item, nbf = W_bi_pad.shape[0] - 1, W_bi_pad.shape[1]
    if nbf == 0:
        return
    lid, upd, lam, i_val = _bi_update(W_bi_pad, up_slot, batch, err, lr_bi, bh)
    B, S = lid.shape
    if bh.reg_bi in (0, 1, 4, 5):
        pair = (i_val.abs() > 0)[..., None] & (up_slot.abs() > 0)[:, None, :]
        pay = torch.cat([upd, pair.to(F32)], dim=-1).reshape(B * S, 2 * nbf)
    elif bh.reg_bi in (2, 3):
        occ = (i_val.abs() > 0).to(F32)
        pay = torch.cat([upd, occ[..., None]], dim=-1).reshape(B * S, nbf + 1)
    else:
        raise ValueError(f"unknown bi feedback decay method {bh.reg_bi}")
    _, si, acc, _, last = sorted_dedup(lid.reshape(-1), pay)
    new = gather_rows(W_bi_pad, si) + acc[:, :nbf]
    if bh.reg_bi == 0:
        new = new * torch.pow(1.0 - lam, acc[:, nbf:])
    elif bh.reg_bi in (1, 4, 5):
        new = _soft_threshold(new, lam * acc[:, nbf:])
    elif bh.reg_bi == 2:
        new = new * torch.pow(1.0 - lam, acc[:, nbf])[:, None]
    else:
        new = _soft_threshold(new, (lam * acc[:, nbf])[:, None])
    is_real = last & (si != num_item)
    tgt = torch.where(is_real, si, num_item).to(torch.int32)
    write_rows_unique(W_bi_pad, tgt, torch.where(is_real[:, None], new, 0.0), row_dma=row_dma)


def _up_slots(up: torch.Tensor, c: int, G: int, M: int) -> torch.Tensor:
    """Chunk c's user-property rows, one per slot ``[G*M, nbf]``."""
    return up[c][:G].repeat_interleave(M, dim=0)


def _plugin(W_bi_pad, up_rep, batch, off_item: int) -> torch.Tensor:
    """The step's plugin bias ``[B]`` from its item entries."""
    lid, _ = _local_item_ids(batch["i_idx"], off_item, W_bi_pad.shape[0] - 1)
    return _bi_bias(W_bi_pad, up_rep, lid, batch["i_val"])


@torch.no_grad()
def train_epoch_bi(
    state: TrainState,
    W_bi_pad: torch.Tensor,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    fb_overlap,
    up: torch.Tensor,
    lr: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
    bh: BiHyper,
) -> TrainState:
    """One pass over the ``[T, G*M]`` steps in the overlap-carried form
    (svdfeature_tpu/ops/svdpp_bilinear.train_epoch_bi): ops/svdpp.
    train_epoch_plus with the plugin bias in each step's score and W_bi's
    step between the row update and the feedback recurrence.  The overlap
    must come from the filtered pool values (start_ufeedback).  Updates
    ``state`` and ``W_bi_pad`` in place."""
    w, b = state.w, state.b
    T, GS = stacked["label"].shape
    M = ph.rows_per_user
    G = GS // M
    k = w.shape[1]
    lr_fb, d, db = _fb_hyper(lr, ph)
    lr_bi = lr * bh.slr_bi
    with_bias = not hp.no_user_bias
    cid = np.asarray(chunk_id)
    first = _is_first(cid)
    dacc = torch.zeros((G + 1, k), dtype=w.dtype, device=w.device)
    dbacc = torch.zeros((G + 1,), dtype=w.dtype, device=w.device)
    pc = int(cid[0])
    for t in range(T):
        c = int(cid[t])
        if first[t]:
            _fb_writeback(w, b, _pool(fb, pc), dacc, dbacc if with_bias else None)
            s, nrm, sb = _fb_aggregates(w, b, _pool(fb, c), G + 1, with_bias)
            fb_sum, fb_bias, norm = s[:G], sb[:G], nrm[:G]
            inv = _inv_norm(norm)
            O = fb_overlap[c]
            dacc.zero_()
            dbacc.zero_()
            up_rep = _up_slots(up, c, G, M)
        pc = c
        batch = {p: stacked[p][t] for p in _PLANES}
        plug = _plugin(W_bi_pad, up_rep, batch, bh.off_item)
        fbb_slot = fb_bias.repeat_interleave(M) if with_bias else None
        state, err, p_i = general_step(state, batch, lr, consts, hp,
                                       fb_sum.repeat_interleave(M, dim=0), fbb_slot, plug)
        _bi_step(W_bi_pad, up_rep, batch, err, lr_bi, bh)
        fb_sum, fb_bias = _fb_recurrence(err, p_i, batch["weight"], fb_sum, fb_bias, norm, inv, O,
                                         dacc, dbacc, lr_fb, d, db, M, with_bias)
    _fb_writeback(w, b, _pool(fb, pc), dacc, dbacc if with_bias else None)
    return state


def k5_launches_bi(chunk_id: np.ndarray, nbf: int) -> int:
    """K5 launches of one ``train_epoch_bi_big`` with ``row_dma``: a step's
    entry write and its W_bi write (none for an empty property space), and
    the pool writeback at each chunk exit."""
    exits = int(np.count_nonzero(_is_first(chunk_id)))
    return len(chunk_id) * (2 if nbf else 1) + exits


@torch.no_grad()
def train_epoch_bi_big(
    state: TrainState,
    W_bi_pad: torch.Tensor,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    fb_overlap,
    up: torch.Tensor,
    lr: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
    bh: BiHyper,
) -> TrainState:
    """``train_epoch_bi`` on the augmented big-table layout
    (svdfeature_tpu/ops/svdpp_bilinear.train_epoch_bi_big): each step is
    big_embed's entry-stream step with the feedback term and the plugin
    bias (K5), then ``_bi_step_big`` (K5); a chunk's pool deltas go out at
    its exit through ops/svdpp_big._fb_writeback_big (K5).  The overlap is
    dense or factored (``_ov_slice``).  The chunk entry at step 0 writes
    nothing (the reference flushes a zero delta there).  ``state`` is
    augmented (big_embed.augment_state) with ``hp.big_table``."""
    if not hp.big_table or hp.sweep_table:
        raise ValueError("the big-table bilinear epoch takes the augmented dedup layout")
    T, GS = stacked["label"].shape
    M = ph.rows_per_user
    G = GS // M
    k = hp.num_factor
    dev = state.w.device
    lr_fb, d, db = _fb_hyper(lr, ph)
    lr_bi = lr * bh.slr_bi
    with_bias = not hp.no_user_bias
    cid = np.asarray(chunk_id)
    first = _is_first(cid)
    dacc = torch.zeros((G + 1, k), dtype=F32, device=dev)
    dbacc = torch.zeros((G + 1,), dtype=F32, device=dev)
    pc = int(cid[0])
    for t in range(T):
        c = int(cid[t])
        if first[t]:
            w = state.w
            if t > 0:
                _fb_writeback_big(w, _pool(fb, pc), dacc, dbacc if with_bias else None, k,
                                  hp.row_dma)
            s, nrm, sb = _fb_aggregates(w[:, :k], w[:, k], _pool(fb, c), G + 1, with_bias)
            fb_sum, fb_bias, norm = s[:G], sb[:G], nrm[:G]
            inv = _inv_norm(norm)
            O = _ov_slice(fb_overlap, c)
            dacc.zero_()
            dbacc.zero_()
            up_rep = _up_slots(up, c, G, M)
        pc = c
        batch = {p: stacked[p][t] for p in _PLANES}
        plug = _plugin(W_bi_pad, up_rep, batch, bh.off_item)
        fbb_slot = fb_bias.repeat_interleave(M) if with_bias else None
        state, f = dedup_step(state, batch, lr, consts, hp, fb_sum.repeat_interleave(M, dim=0),
                              fbb_slot, plug)
        _bi_step_big(W_bi_pad, up_rep, batch, f.err, lr_bi, bh, hp.row_dma)
        fb_sum, fb_bias = _fb_recurrence(f.err, f.p_i, batch["weight"], fb_sum, fb_bias, norm, inv,
                                         O, dacc, dbacc, lr_fb, d, db, M, with_bias)
    _fb_writeback_big(state.w, _pool(fb, pc), dacc, dbacc if with_bias else None, k, hp.row_dma)
    return state


@torch.no_grad()
def train_epoch_bi_refresh(
    state: TrainState,
    W_bi_pad: torch.Tensor,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    up: torch.Tensor,
    lr: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
    bh: BiHyper,
) -> TrainState:
    """The per-batch refresh form (svdfeature_tpu/ops/svdpp_bilinear.
    train_epoch_bi_refresh), for a feedback space shared with the user
    rows: each step is ops/svdpp._plus_step with the plugin bias, then
    W_bi's step on the step's error."""
    M = ph.rows_per_user
    G = stacked["label"].shape[1] // M
    lr_fb, d, db = _fb_hyper(lr, ph)
    lr_bi = lr * bh.slr_bi
    for t, c in enumerate(np.asarray(chunk_id).tolist()):
        batch = {p: stacked[p][t] for p in _PLANES}
        up_rep = _up_slots(up, c, G, M)
        plug = _plugin(W_bi_pad, up_rep, batch, bh.off_item)
        state, err = _plus_step(state, batch, _pool(fb, c), lr, consts, hp, ph, lr_fb, d, db,
                                bias_plugin=plug, return_err=True)
        _bi_step(W_bi_pad, up_rep, batch, err, lr_bi, bh)
    return state


@torch.no_grad()
def predict_batches_bi(
    state: TrainState,
    W_bi_pad: torch.Tensor,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    up: torch.Tensor,
    hp: HyperParams,
    off_item: int,
    rows_per_user: int = 1,
) -> torch.Tensor:
    """Forward-only predictions -> ``[T, G*M]``, with the plugin bias; the
    tables are static, so the feedback aggregates are gathered once per
    chunk."""
    w, b, g = state.w, state.b, state.g
    T, GS = stacked["label"].shape
    M = rows_per_user
    G = GS // M
    with_bias = not hp.no_user_bias
    cid = np.asarray(chunk_id)
    first = _is_first(cid)
    preds = []
    for t in range(T):
        if first[t]:
            c = int(cid[t])
            s, _, sb = _fb_aggregates(w, b, _pool(fb, c), G + 1, with_bias)
            fb_slot = s[:G].repeat_interleave(M, dim=0)
            fbb_slot = sb[:G].repeat_interleave(M) if with_bias else None
            up_rep = _up_slots(up, c, G, M)
        batch = {p: stacked[p][t] for p in _PLANES}
        plug = _plugin(W_bi_pad, up_rep, batch, off_item)
        preds.append(forward_scores(w, b, g, batch, hp, fb_slot, fbb_slot, plug))
    return torch.stack(preds)
