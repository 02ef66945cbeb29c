"""Stacked multi-IMFB (extend_type=2) train epoch and prediction in plain
PyTorch.

Counterpart of svdfeature_tpu/ops/imfb.py (SVDPPMultiIMFB,
apex_multi_imfb.h:31-194) in f32: ``_damp_widened``,
``train_epoch_imfb_carried`` (the overlap-carried form),
``_imfb_step`` / ``train_epoch_imfb`` (the per-batch refresh form on the
standard layout, for a feedback space shared with the user rows,
common_feedback_space=1), ``train_epoch_imfb_big`` (the per-step refresh
form on the augmented big-table layout, tables over 8192 rows, writing
through K5) and ``predict_batches_imfb``.  The carried epoch is
ops/svdpp.train_epoch_plus with the chunk's local feedback contexts in
place of its users, and it reuses that module's ``_fb_aggregates`` /
``_fb_writeback`` with the pool keyed by ``fb_ctx`` (the JAX package's
``_ctx_aggregates``) and its row update, ops/embed.general_step.

Layout (data/batching_imfb.py).  Names: ``RM`` is rows_per_user (rows of
a unit, a block with rows, trained side by side in one step: slot
s = g*RM + m), ``nseg`` the local context slots of a chunk plus the pad
slot ``nseg-1``; ``D`` the stack depth.  Step t's plane ``ctx_slots
[T, G*RM, D]`` names each slot's active contexts (pad where the stack is
shallower, and on padding slots); chunk c owns a feedback pool ``[F]`` of
(row, value, context) entries, a context's entries contiguous and
ascending, padding at the end with context ``nseg-1`` and value 0; the
overlap matrix ``O[c] [nseg, nseg]``; and the gate ``enabled[c] [nseg]``.

A slot reads, and updates, the SUM of its D contexts' feedback terms
(prepare_svdpp, apex_multi_imfb.h:66-75); each context's delta is damped
by its within-unit excess only (``_damp_widened``) and masked by the
gate: a disabled depth neither accumulates nor decays (update_svdpp
:83-94).

The update is in place: ``state.w`` / ``state.b`` change (the JAX package
donates the state) and the returned TrainState holds them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .big_embed import dedup_step
from .embed import HyperParams, TrainConsts, TrainState, forward_scores, general_step
from .svdpp import (_PLANES, PlusHyper, _fb_aggregates, _fb_hyper, _fb_writeback, _inv_norm,
                    _is_first)
from .svdpp_big import _fb_writeback_big


def _ctx_pool(fb: Dict[str, torch.Tensor], c: int) -> Dict[str, torch.Tensor]:
    """Chunk c's pool in the keys of ops/svdpp's pool helpers (the
    context slot in place of the user)."""
    return {"fb_idx": fb["fb_idx"][c], "fb_val": fb["fb_val"][c], "fb_block": fb["fb_ctx"][c]}


def _damp_widened(
    S: torch.Tensor,
    S_b: Optional[torch.Tensor],
    present: torch.Tensor,
    flat_ctx: torch.Tensor,
    nrow: torch.Tensor,
    norm: torch.Tensor,
    p_i: torch.Tensor,
    lr_fb: torch.Tensor,
    rows_per_user: int,
    D: int,
    nseg: int,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Implicitly damped widened Jacobi step for rows_per_user (RM) > 1,
    per context: only the within-unit excess ``nrow - U`` is damped, where
    U = sum over the context's slots of present / m_unit (m_unit: present
    rows of the slot's unit), the distinct units feeding the context."""
    RM = rows_per_user
    m_unit = present.reshape(-1, RM).sum(dim=1)
    ind = torch.where(m_unit > 0, 1.0 / torch.clamp(m_unit, min=1.0), 0.0).repeat_interleave(RM)
    ind = ind * present
    zeros = torch.zeros((nseg,), dtype=torch.float32, device=S.device)
    U = zeros.clone().index_add_(0, flat_ctx, ind.repeat_interleave(D))
    pip2 = zeros.clone().index_add_(0, flat_ctx, (p_i * p_i).sum(dim=1).repeat_interleave(D))
    excess = torch.clamp(nrow - U, min=0.0)
    frac = torch.where(nrow > 0, excess / torch.clamp(nrow, min=1.0), 0.0)
    S = S / (1.0 + lr_fb * norm * pip2 * frac)[:, None]
    if S_b is not None:
        S_b = S_b / (1.0 + lr_fb * norm * excess)
    return S, S_b


@torch.no_grad()
def train_epoch_imfb_carried(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    fb_overlap: torch.Tensor,
    enabled: torch.Tensor,
    lr: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
) -> TrainState:
    """One pass over the ``[T, G*RM]`` steps with the pool touched twice
    per chunk (svdfeature_tpu/ops/imfb.train_epoch_imfb_carried): at a
    chunk's first step the previous chunk's accumulated context deltas are
    written back and the new chunk's context aggregates gathered; within
    the chunk they evolve in closed form, ``fb_sum += O @ delta``.
    ``chunk_id`` is host numpy."""
    w, b = state.w, state.b
    T = stacked["label"].shape[0]
    nseg = enabled.shape[1]
    k = w.shape[1]
    dev = w.device
    lr_fb, d, db = _fb_hyper(lr, ph)
    with_bias = not hp.no_user_bias
    cid = np.asarray(chunk_id)
    first = _is_first(cid)
    dacc = torch.zeros((nseg, k), dtype=torch.float32, device=dev)
    dbacc = torch.zeros((nseg,), dtype=torch.float32, device=dev)

    pc = int(cid[0])
    for t in range(T):
        c = int(cid[t])
        if first[t]:
            _fb_writeback(w, b, _ctx_pool(fb, pc), dacc, dbacc if with_bias else None)
            fb_sum, norm, fb_bias = _fb_aggregates(w, b, _ctx_pool(fb, c), nseg, with_bias)
            inv = _inv_norm(norm)
            O = fb_overlap[c]
            dacc.zero_()
            dbacc.zero_()
        pc = c
        batch = {p: stacked[p][t] for p in _PLANES}
        ctx = stacked["ctx_slots"][t].long()  # [G*RM, D]
        p_u_extra = fb_sum[ctx].sum(dim=1)
        bias_extra = fb_bias[ctx].sum(dim=1) if with_bias else None
        state, err, p_i = general_step(state, batch, lr, consts, hp, p_u_extra, bias_extra)
        delta, delta_b = _context_deltas(err, p_i, batch["weight"], ctx, fb_sum, fb_bias, norm,
                                         inv, enabled[c] * (norm > 0), lr_fb, d, db, ph, with_bias)
        dacc += delta
        fb_sum = fb_sum + O @ delta
        if with_bias:
            dbacc += delta_b
            fb_bias = fb_bias + O @ delta_b
    _fb_writeback(w, b, _ctx_pool(fb, pc), dacc, dbacc if with_bias else None)
    return state


def _context_deltas(err, p_i, weight, ctx, fb_sum, fb_bias, norm, inv, gate, lr_fb, d, db,
                    ph: PlusHyper, with_bias: bool):
    """One step's per-context deltas (delta [nseg, k], delta_b [nseg] or
    None): each slot's error and item factor summed into its D contexts,
    damped by the within-unit excess for RM > 1 (``_damp_widened``), the
    pool decay over the context's rows, masked by ``gate``."""
    nseg, k = fb_sum.shape
    D = ctx.shape[-1]
    flat_ctx = ctx.reshape(-1)
    zeros = torch.zeros((nseg,), dtype=torch.float32, device=fb_sum.device)
    S = torch.zeros((nseg, k), dtype=torch.float32, device=fb_sum.device)
    S.index_add_(0, flat_ctx, (err[:, None] * p_i).repeat_interleave(D, dim=0))
    nrow = zeros.clone().index_add_(0, flat_ctx, weight.repeat_interleave(D))
    S_b = zeros.clone().index_add_(0, flat_ctx, err.repeat_interleave(D)) if with_bias else None
    if ph.rows_per_user > 1:
        S, S_b = _damp_widened(S, S_b, weight, flat_ctx, nrow, norm, p_i, lr_fb, ph.rows_per_user,
                               D, nseg)
    dtmp = fb_sum * (torch.pow(d, nrow) - 1.0)[:, None] + lr_fb * norm[:, None] * S
    delta = dtmp * (inv * gate)[:, None]
    if not with_bias:
        return delta, None
    return delta, (fb_bias * (torch.pow(db, nrow) - 1.0) + lr_fb * norm * S_b) * inv * gate


def _imfb_step(state: TrainState, batch: Dict[str, torch.Tensor], cfb: Dict[str, torch.Tensor],
               enabled: torch.Tensor, lr, consts: TrainConsts, hp: HyperParams, ph: PlusHyper,
               lr_fb, d, db) -> TrainState:
    """One stacked step of the per-batch refresh form (svdfeature_tpu/ops/
    imfb.py:83-171), in place: the chunk's context aggregates from the
    live tables before the lazy catch-up, the row update with the
    contexts' feedback term, the step's context deltas written straight
    back between the scatters and the decays.  As in the JAX package, this
    step applies no nonnegative clamps (imfb.py:151-171), where the SVD++
    refresh step and the carried epoch do: the asymmetry is kept.  ``cfb``
    is the chunk's pool with the context slot as ``fb_block``."""
    with_bias = not hp.no_user_bias
    ctx = batch["ctx_slots"].long()  # [G*RM, D]
    nseg = enabled.shape[0]
    w, b = state.w, state.b
    fb_sum, norm, fb_bias = _fb_aggregates(w, b, cfb, nseg, with_bias)
    inv = _inv_norm(norm)

    def writeback(err, p_i):
        delta, delta_b = _context_deltas(err, p_i, batch["weight"], ctx, fb_sum, fb_bias, norm,
                                         inv, enabled * (norm > 0), lr_fb, d, db, ph, with_bias)
        _fb_writeback(w, b, cfb, delta, delta_b)

    no_clamps = dataclasses.replace(hp, user_nonnegative=0, item_nonnegative=0)
    bias_extra = fb_bias[ctx].sum(dim=1) if with_bias else None
    return general_step(state, batch, lr, consts, no_clamps, fb_sum[ctx].sum(dim=1), bias_extra,
                        after_scatter=writeback)[0]


@torch.no_grad()
def train_epoch_imfb(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    enabled: torch.Tensor,
    lr: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
) -> TrainState:
    """One pass of the stacked epoch in the per-batch refresh form
    (svdfeature_tpu/ops/imfb.train_epoch_imfb): a host loop of
    ``_imfb_step`` over the T steps with the chunk ids on the host, the
    route of a feedback space shared with the user rows."""
    lr_fb, d, db = _fb_hyper(lr, ph)
    planes = _PLANES + ("ctx_slots",)
    for t, c in enumerate(np.asarray(chunk_id).tolist()):
        batch = {p: stacked[p][t] for p in planes}
        state = _imfb_step(state, batch, _ctx_pool(fb, c), enabled[c], lr, consts, hp, ph,
                           lr_fb, d, db)
    return state


def _imfb_step_big(state: TrainState, batch: Dict[str, torch.Tensor], cfb: Dict[str, torch.Tensor],
                   enabled: torch.Tensor, lr, consts: TrainConsts, hp: HyperParams,
                   ph: PlusHyper, lr_fb, d, db) -> TrainState:
    """One stacked step on the augmented big-table layout
    (svdfeature_tpu/ops/imfb.py:343-424): the per-step refresh form.  The
    chunk's context aggregates are gathered from the table, the row
    update is big_embed's sorted-dedup step with the contexts' feedback
    term (K5), and the step's context deltas are written back at once
    through svdpp_big._fb_writeback_big keyed by the context (K5): no
    table-sized scatter or decay anywhere.  ``cfb`` is the chunk's pool
    with the context slot as ``fb_block``."""
    k = hp.num_factor
    with_bias = not hp.no_user_bias
    ctx = batch["ctx_slots"].long()  # [G*RM, D]
    nseg = enabled.shape[0]
    fb_sum, norm, fb_bias = _fb_aggregates(state.w[:, :k], state.w[:, k], cfb, nseg, with_bias)
    bias_extra = fb_bias[ctx].sum(dim=1) if with_bias else None
    state, f = dedup_step(state, batch, lr, consts, hp, fb_sum[ctx].sum(dim=1), bias_extra)
    inv = _inv_norm(norm)
    gate = enabled * (norm > 0)
    delta, delta_b = _context_deltas(f.err, f.p_i, batch["weight"], ctx, fb_sum, fb_bias, norm,
                                     inv, gate, lr_fb, d, db, ph, with_bias)
    _fb_writeback_big(state.w, cfb, delta, delta_b, k, hp.row_dma)
    return state


@torch.no_grad()
def train_epoch_imfb_big(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    enabled: torch.Tensor,
    lr: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
) -> TrainState:
    """One pass of the stacked epoch on the augmented big-table layout
    (svdfeature_tpu/ops/imfb.train_epoch_imfb_big; ``state`` from
    big_embed.augment_state, ``hp.big_table`` set), a host loop of
    ``_imfb_step_big`` over the T steps with the chunk ids on the host.
    With ``row_dma`` it launches K5 twice a step: the row update and the
    context writeback."""
    if not hp.big_table or hp.sweep_table:
        raise ValueError("the big-table stacked epoch takes the augmented dedup layout")
    lr_fb, d, db = _fb_hyper(lr, ph)
    planes = _PLANES + ("ctx_slots",)
    for t, c in enumerate(np.asarray(chunk_id).tolist()):
        batch = {p: stacked[p][t] for p in planes}
        state = _imfb_step_big(state, batch, _ctx_pool(fb, c), enabled[c], lr, consts, hp, ph,
                               lr_fb, d, db)
    return state


@torch.no_grad()
def predict_batches_imfb(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    hp: HyperParams,
) -> torch.Tensor:
    """Forward-only predictions -> ``[T, G*RM]``; the tables are static, so
    the context aggregates are gathered once per chunk."""
    w, b, g = state.w, state.b, state.g
    T = stacked["label"].shape[0]
    nseg = fb["ctx_depth"].shape[1] + 1
    with_bias = not hp.no_user_bias
    cid = np.asarray(chunk_id)
    first = _is_first(cid)
    preds = []
    for t in range(T):
        if first[t]:
            fb_sum, _, fb_bias = _fb_aggregates(w, b, _ctx_pool(fb, int(cid[t])), nseg, with_bias)
        ctx = stacked["ctx_slots"][t].long()
        batch = {p: stacked[p][t] for p in _PLANES}
        bias_extra = fb_bias[ctx].sum(dim=1) if with_bias else None
        preds.append(forward_scores(w, b, g, batch, hp, fb_sum[ctx].sum(dim=1), bias_extra))
    return torch.stack(preds)
