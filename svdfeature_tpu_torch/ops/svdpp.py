"""SVD++ (user-group) train epoch and prediction in plain PyTorch.

Counterpart of svdfeature_tpu/ops/svdpp.py (SVDPPFeature,
apex_svd_base.h:484-592) in f32: ``_fb_aggregates``, ``_fb_writeback``,
``_fb_deltas`` / ``_fb_recurrence`` (a step's feedback deltas, shared with
the big-table and bilinear epochs), ``train_epoch_plus`` (the
overlap-carried form), ``_plus_step`` / ``train_epoch_plus_refresh`` (the
per-batch refresh form, for a feedback space shared with the user rows,
common_feedback_space=1) and ``predict_batches_plus``.  The u/i/g row
update of each step, the JAX package's ``_row_update``
(svdpp.py:225-296) without its fused branch, is ops/embed.general_step
with the feedback term: every reg mode (the lazy catch-up on the
example's u/i/g ids, never on feedback pool rows), the global segment,
the clamps and every loss.  Segment sums and scatters are
``index_add_``; the one-hot matmul forms of the JAX package exist only
because TPU scatters serialize and have no counterpart here.

Layout (data/batching_plus.py): step t holds up to M rows of each of G
users (slot s = g*M + m); chunk c owns a feedback pool ``[F]`` of
(row, value, user) entries, a user's entries contiguous, padding at the
end with user G and value 0, and the overlap matrix ``O[c] [G+1, G+1]``.

The update is in place: ``state.w`` / ``state.b`` change (the JAX package
donates the state) and the returned TrainState holds them.  The working
type follows the table's (f32; f64 gives chip_smoke.py a yardstick of the
f32 rounding).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .embed import _PLANES, HyperParams, TrainConsts, TrainState, forward_scores, general_step


@dataclasses.dataclass(frozen=True)
class PlusHyper:
    """Static switches of the user-group path, beside HyperParams."""

    rows_per_user: int = 1  # M: rows of each user trained per step
    # first user row; rows [0, off_user) hold the feedback pool (0: the
    # feedback space is shared with the user rows)
    off_user: int = 0
    scale_lr_ufeedback: float = 1.0
    wd_ufeedback: float = 0.0
    wd_ufeedback_bias: float = 0.0


def _fb_aggregates(
    w: torch.Tensor, b: torch.Tensor, cfb: Dict[str, torch.Tensor], nseg: int, with_bias: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(fb_sum [nseg, k], norm [nseg], fb_bias [nseg]) of one chunk's pool:
    per user, sum val*w[row], sum val^2 and sum val*b[row]."""
    fval = cfb["fb_val"]
    idx = cfb["fb_idx"].long()
    blk = cfb["fb_block"].long()
    zeros = torch.zeros((nseg,), dtype=w.dtype, device=w.device)
    fb_sum = torch.zeros((nseg, w.shape[1]), dtype=w.dtype, device=w.device)
    fb_sum.index_add_(0, blk, w[idx] * fval[:, None])
    norm = zeros.clone().index_add_(0, blk, fval * fval)
    fb_bias = zeros.index_add_(0, blk, b[idx] * fval) if with_bias else zeros
    return fb_sum, norm, fb_bias


def _fb_writeback(
    w: torch.Tensor,
    b: torch.Tensor,
    cfb: Dict[str, torch.Tensor],
    delta: torch.Tensor,
    delta_b: Optional[torch.Tensor],
) -> None:
    """In place: w[fb_idx] += delta[fb_block] * fval (and the bias analogue
    when ``delta_b`` is given)."""
    fval = cfb["fb_val"]
    idx = cfb["fb_idx"].long()
    blk = cfb["fb_block"].long()
    w.index_add_(0, idx, delta[blk] * fval[:, None])
    if delta_b is not None:
        b.index_add_(0, idx, delta_b[blk] * fval)


def _is_first(chunk_id: np.ndarray) -> np.ndarray:
    """Whether each step starts a chunk."""
    cid = np.asarray(chunk_id)
    return np.concatenate([[True], cid[1:] != cid[:-1]])


def _ov_mul(O, d: torch.Tensor) -> torch.Tensor:
    """``O @ d`` for a chunk's overlap, dense ``[G+1, G+1]`` or the factored
    pair ``(diag, dup)`` that big tables pack (ops/svdpp_big.py):
    ``diag * d + dup @ (dupᵀ @ d)``; ``d`` is ``[G+1, k]`` or ``[G+1]``."""
    if isinstance(O, tuple):
        dg, Pd = O
        return (dg[:, None] if d.dim() == 2 else dg) * d + Pd @ (Pd.T @ d)
    return O @ d


def _fb_deltas(err, p_i, weight, fb_sum, fb_bias, norm, inv, lr_fb, d, db, M: int,
               with_bias: bool):
    """A step's per-user feedback deltas, padded to ``[G+1]``: (delta
    ``[G+1, k]``, delta_b ``[G+1]`` or None), the reference's per-row
    recurrence (update_svdpp, apex_svd_base.h:512-520) over each user's M
    rows of the step, implicitly damped for M > 1."""
    G, k = fb_sum.shape
    m_g = weight.reshape(G, M).sum(dim=1)  # present rows of each user
    errpi = (err[:, None] * p_i).reshape(G, M, k).sum(dim=1)
    err_g = err.reshape(G, M).sum(dim=1)
    if M > 1:
        # implicit damping of the M-wide within-user Jacobi step
        frac = torch.where(m_g > 0, (m_g - 1.0) / torch.clamp(m_g, min=1.0), 0.0)
        pip2 = (p_i * p_i).sum(dim=1).reshape(G, M).sum(dim=1)
        errpi = errpi / (1.0 + lr_fb * norm * pip2 * frac)[:, None]
        err_g = err_g / (1.0 + lr_fb * norm * (m_g - 1.0) * (m_g > 0))
    dtmp = fb_sum * (torch.pow(d, m_g) - 1.0)[:, None] + lr_fb * norm[:, None] * errpi
    delta_pad = torch.cat([dtmp * inv[:, None], torch.zeros_like(dtmp[:1])])
    if not with_bias:
        return delta_pad, None
    dtmp_b = fb_bias * (torch.pow(db, m_g) - 1.0) + lr_fb * norm * err_g
    return delta_pad, torch.cat([dtmp_b * inv, torch.zeros_like(dtmp_b[:1])])


def _fb_recurrence(err, p_i, weight, fb_sum, fb_bias, norm, inv, O, dacc, dbacc, lr_fb, d, db,
                   M: int, with_bias: bool):
    """The per-step feedback recurrence of train_epoch_plus: the users'
    deltas (``_fb_deltas``) accumulate in ``dacc`` / ``dbacc`` in place;
    returns the carried (fb_sum, fb_bias)."""
    G = fb_sum.shape[0]
    delta_pad, delta_b_pad = _fb_deltas(err, p_i, weight, fb_sum, fb_bias, norm, inv, lr_fb, d,
                                        db, M, with_bias)
    dacc += delta_pad
    fb_sum = fb_sum + _ov_mul(O, delta_pad)[:G]
    if with_bias:
        dbacc += delta_b_pad
        fb_bias = fb_bias + _ov_mul(O, delta_b_pad)[:G]
    return fb_sum, fb_bias


def _inv_norm(norm: torch.Tensor) -> torch.Tensor:
    """1 / norm where the norm is positive, else 0."""
    return torch.where(norm > 0, 1.0 / torch.clamp(norm, min=1e-30), 0.0)


def _fb_hyper(lr, ph: PlusHyper):
    """(lr_fb, d, db): the feedback rate and its two decay factors."""
    lr_fb = lr * ph.scale_lr_ufeedback
    return lr_fb, 1.0 - lr_fb * ph.wd_ufeedback, 1.0 - lr_fb * ph.wd_ufeedback_bias


def _pool(fb: Dict[str, torch.Tensor], c: int) -> Dict[str, torch.Tensor]:
    """Chunk c's feedback pool."""
    return {name: fb[name][c] for name in ("fb_idx", "fb_val", "fb_block")}


@torch.no_grad()
def train_epoch_plus(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    fb_overlap: torch.Tensor,
    lr: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
) -> TrainState:
    """One pass over the ``[T, G*M]`` steps with the pool touched twice
    per chunk (svdfeature_tpu/ops/svdpp.train_epoch_plus, which holds the
    derivation): at a chunk's first step the previous chunk's accumulated
    deltas are written back to the pool and the new chunk's aggregates
    gathered; within the chunk they evolve in closed form,
    ``fb_sum += O @ delta``.  ``chunk_id`` is host numpy."""
    w, b = state.w, state.b
    T, GS = stacked["label"].shape
    M = ph.rows_per_user
    G = GS // M
    k = w.shape[1]
    dev = w.device
    lr_fb, d, db = _fb_hyper(lr, ph)
    with_bias = not hp.no_user_bias
    cid = np.asarray(chunk_id)
    first = _is_first(cid)
    dacc = torch.zeros((G + 1, k), dtype=w.dtype, device=dev)
    dbacc = torch.zeros((G + 1,), dtype=w.dtype, device=dev)
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
        pc = c
        batch = {p: stacked[p][t] for p in _PLANES}
        fb_slot = fb_sum.repeat_interleave(M, dim=0)
        fbb_slot = fb_bias.repeat_interleave(M) if with_bias else None
        state, err, p_i = general_step(state, batch, lr, consts, hp, fb_slot, fbb_slot)
        fb_sum, fb_bias = _fb_recurrence(err, p_i, batch["weight"], fb_sum, fb_bias, norm, inv, O,
                                         dacc, dbacc, lr_fb, d, db, M, with_bias)
    _fb_writeback(w, b, _pool(fb, pc), dacc, dbacc if with_bias else None)
    return state


def _plus_step(state: TrainState, batch: Dict[str, torch.Tensor], cfb: Dict[str, torch.Tensor],
               lr, consts: TrainConsts, hp: HyperParams, ph: PlusHyper, lr_fb, d, db,
               bias_plugin: Optional[torch.Tensor] = None,
               return_err: bool = False):
    """One step of the per-batch refresh form (svdfeature_tpu/ops/svdpp.py:
    115-222), in place: the users' aggregates of the chunk's pool ``cfb``
    from the live tables, before the step's lazy catch-up (the reference
    prepares the feedback before the block's regularize calls,
    apex_svd_base.h:568-582); the row update with the feedback term; the
    users' deltas written straight back to the pool, between the scatters
    and the decays (``general_step``'s ``after_scatter``).  No overlap, no
    carried sums.  Returns the state, and with ``return_err`` the step's
    error as well."""
    M = ph.rows_per_user
    G = batch["label"].shape[0] // M
    with_bias = not hp.no_user_bias
    w, b = state.w, state.b
    s, nrm, sb = _fb_aggregates(w, b, cfb, G + 1, with_bias)
    fb_sum, fb_bias, norm = s[:G], sb[:G], nrm[:G]
    inv = _inv_norm(norm)

    def writeback(err, p_i):
        delta, delta_b = _fb_deltas(err, p_i, batch["weight"], fb_sum, fb_bias, norm, inv, lr_fb,
                                    d, db, M, with_bias)
        _fb_writeback(w, b, cfb, delta, delta_b)

    state, err, _ = general_step(
        state, batch, lr, consts, hp, fb_sum.repeat_interleave(M, dim=0),
        fb_bias.repeat_interleave(M) if with_bias else None, bias_plugin, writeback)
    return (state, err) if return_err else state


@torch.no_grad()
def train_epoch_plus_refresh(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    lr: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
) -> TrainState:
    """One pass over the ``[T, G*M]`` steps, each gathering its chunk's pool
    and writing straight back (``_plus_step``): the route of a feedback
    space shared with the user rows, where mid-chunk row updates alias
    pool rows and the overlap closed form of train_epoch_plus does not
    hold (svdfeature_tpu/ops/svdpp.train_epoch_plus_refresh).
    ``chunk_id`` is host numpy."""
    lr_fb, d, db = _fb_hyper(lr, ph)
    for t, c in enumerate(np.asarray(chunk_id).tolist()):
        batch = {p: stacked[p][t] for p in _PLANES}
        state = _plus_step(state, batch, _pool(fb, c), lr, consts, hp, ph, lr_fb, d, db)
    return state


@torch.no_grad()
def predict_batches_plus(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    hp: HyperParams,
    rows_per_user: int = 1,
) -> torch.Tensor:
    """Forward-only predictions -> ``[T, G*M]``; the tables are static, so
    the feedback aggregates are gathered once per chunk."""
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
        batch = {p: stacked[p][t] for p in _PLANES}
        preds.append(forward_scores(w, b, g, batch, hp, fb_slot, fbb_slot))
    return torch.stack(preds)
