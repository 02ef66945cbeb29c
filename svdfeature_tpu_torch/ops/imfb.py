"""Stacked multi-IMFB (extend_type=2) train epoch and prediction in plain
PyTorch.

Counterpart of svdfeature_tpu/ops/imfb.py (SVDPPMultiIMFB,
apex_multi_imfb.h:31-194) in f32: ``_damp_widened``,
``train_epoch_imfb_carried`` (the overlap-carried form) and
``predict_batches_imfb``.  It is ops/svdpp.train_epoch_plus with the
chunk's local feedback contexts in place of its users, and it reuses that
module's ``_fb_aggregates`` / ``_fb_writeback`` with the pool keyed by
``fb_ctx`` and its row update, ops/embed.general_step.  Not ported yet, each raising
NotImplementedError: ``train_epoch_imfb`` (the per-batch refresh, for
common_feedback_space=1: ROADMAP Queue 1 item 7b) and
``train_epoch_imfb_big`` (tables over 8192 rows: item 9).

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

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .embed import HyperParams, TrainConsts, TrainState, forward_scores, general_step
from .svdpp import _PLANES, PlusHyper, _fb_aggregates, _fb_writeback, _is_first


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
    D = stacked["ctx_slots"].shape[-1]
    nseg = enabled.shape[1]
    k = w.shape[1]
    dev = w.device
    lr_fb = lr * ph.scale_lr_ufeedback
    d = 1.0 - lr_fb * ph.wd_ufeedback
    db = 1.0 - lr_fb * ph.wd_ufeedback_bias
    with_bias = not hp.no_user_bias
    cid = np.asarray(chunk_id)
    first = _is_first(cid)
    dacc = torch.zeros((nseg, k), dtype=torch.float32, device=dev)
    dbacc = torch.zeros((nseg,), dtype=torch.float32, device=dev)
    zeros = torch.zeros((nseg,), dtype=torch.float32, device=dev)

    pc = int(cid[0])
    for t in range(T):
        c = int(cid[t])
        if first[t]:
            _fb_writeback(w, b, _ctx_pool(fb, pc), dacc, dbacc if with_bias else None)
            fb_sum, norm, fb_bias = _fb_aggregates(w, b, _ctx_pool(fb, c), nseg, with_bias)
            inv = torch.where(norm > 0, 1.0 / torch.clamp(norm, min=1e-30), 0.0)
            O = fb_overlap[c]
            dacc.zero_()
            dbacc.zero_()
        pc = c
        batch = {p: stacked[p][t] for p in _PLANES}
        ctx = stacked["ctx_slots"][t].long()  # [G*RM, D]
        p_u_extra = fb_sum[ctx].sum(dim=1)
        bias_extra = fb_bias[ctx].sum(dim=1) if with_bias else None
        state, err, p_i = general_step(state, batch, lr, consts, hp, p_u_extra, bias_extra)
        # per-context sums over this step's slots, each slot into its D contexts
        flat_ctx = ctx.reshape(-1)
        S = torch.zeros((nseg, k), dtype=torch.float32, device=dev)
        S.index_add_(0, flat_ctx, (err[:, None] * p_i).repeat_interleave(D, dim=0))
        nrow = zeros.clone().index_add_(0, flat_ctx, batch["weight"].repeat_interleave(D))
        gate = enabled[c] * (norm > 0)
        S_b = zeros.clone().index_add_(0, flat_ctx, err.repeat_interleave(D)) if with_bias else None
        if ph.rows_per_user > 1:
            S, S_b = _damp_widened(S, S_b, batch["weight"], flat_ctx, nrow, norm, p_i, lr_fb,
                                   ph.rows_per_user, D, nseg)
        dtmp = fb_sum * (torch.pow(d, nrow) - 1.0)[:, None] + lr_fb * norm[:, None] * S
        delta = dtmp * (inv * gate)[:, None]
        dacc += delta
        fb_sum = fb_sum + O @ delta
        if with_bias:
            delta_b = (fb_bias * (torch.pow(db, nrow) - 1.0) + lr_fb * norm * S_b) * inv * gate
            dbacc += delta_b
            fb_bias = fb_bias + O @ delta_b
    _fb_writeback(w, b, _ctx_pool(fb, pc), dacc, dbacc if with_bias else None)
    return state


def train_epoch_imfb(*args, **kwargs):
    """The per-batch pool refresh epoch, for a feedback space shared with
    the user rows (common_feedback_space=1): not ported yet."""
    raise NotImplementedError(
        "multi-IMFB with common_feedback_space=1 (the per-batch refresh epoch) "
        "is ROADMAP Queue 1 item 7b"
    )


def train_epoch_imfb_big(*args, **kwargs):
    """The stacked epoch on the augmented big-table layout: not ported yet."""
    raise NotImplementedError("multi-IMFB on tables over 8192 rows is ROADMAP Queue 1 item 9")


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
