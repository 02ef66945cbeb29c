"""Large-table train step: sort -> dedup -> unique-row write.

PyTorch counterpart of svdfeature_tpu/ops/big_embed.py, the route of
tables over ``BIG_TABLE_ROWS`` (ops/embed.py).  The step is the batched
SGD step of the small-table path (same reference citations:
update_no_decay apex_svd_base.h:383-427, regularize modes :188-310),
restricted to the rows the batch touches:

  1. forward (``_forward_entries``): row gathers with the lazy catch-up
     applied to the gathered copies, scores, error, the global-bias update;
     then the batch's (row, payload) entry stream (``entry_payload``), one
     entry per (example, feature slot) occurrence, payload ``[dw(k) | db |
     cnt_u | cnt_i]`` (the tile sweep forms the entries in its kernel);
  2. merge (``apply_entries``): sort the entries by row, sum duplicates
     with a cumsum and boundary differences (``sorted_dedup``), compute the
     touched rows' new values (catch-up or eager decay with per-row
     multiplicity, the nonnegative clamps, the bias decay);
  3. ONE unique-row write (``write_rows_unique``): last-entry positions
     carry the final row, duplicate positions write zeros to the dummy
     row.  On CUDA tensors with ``hp.row_dma`` that is the hand-written
     kernel K5 (ops/cuda_scatter.row_writer), else plain indexing.

The merge is the JAX package's, cumsum included, so the port tracks
``train_step_big`` (tests/test_torch_big_embed.py); on the card the
cumsum over a large batch loses low bits that the tile sweep's direct run
sums keep (ops/tile_sweep.py), as it does on the TPU.

Augmented row layout.  The route stores each row as ``[factors(k) | bias
| ref_bits | 0pad]``: the factor vector, the bias and the lazy-decay
timestamp move together.  ``ref_bits`` is the int32 sample counter stored
bit for bit in a float column (read and written through an int32 view of
the table, never through float arithmetic, which would flush its denormal
bit patterns).  The TPU rounds the row to 128 lanes for its DMA; the port
rounds ``k + 2`` up to a multiple of 4 floats (``aug_width``), so a row is
a whole number of 16-byte vectors and a step moves about half the bytes.
Tests compare de-augmented states.

The step updates ``state.w`` in place (the JAX package donates the state)
and returns the new TrainState.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from .. import losses, tracing
from .cuda_scatter import row_writer, row_writer_reference
from .embed import (TrainConsts, TrainState, _apply_factor_reg, _gather_sum, _soft_threshold,
                    _touch_counts, _update_global)

F32 = torch.float32
I32 = torch.int32


def aug_width(k: int) -> int:
    """Row width of the augmented table: factors + bias + ref, rounded up
    to a multiple of 4 floats (16-byte rows)."""
    return (k + 2 + 3) // 4 * 4


def ref_column(aug: torch.Tensor, k: int) -> torch.Tensor:
    """The int32 ref counters of an augmented table, as a view (writes land
    in the table bit for bit)."""
    return aug.view(I32)[:, k + 1]


def augment_state(state: TrainState, k: int, pad_rows_to: int = 0) -> TrainState:
    """Standard TrainState -> augmented big-route layout.

    ``w`` becomes ``[N, aug_width(k)]`` rows ``[factors | bias | ref_bits |
    0]``; ``b`` / ``ref_ui`` shrink to size 0 (the augmented table is the
    one copy).  ``pad_rows_to`` rounds the row count up to a multiple (the
    tile sweep needs whole tiles); pad rows are zero and never addressed,
    and the dummy row stays at its unpadded position."""
    n = state.w.shape[0]
    n_out = -(-n // pad_rows_to) * pad_rows_to if pad_rows_to else n
    dev = state.w.device
    aug = torch.zeros((n_out, aug_width(k)), dtype=F32, device=dev)
    aug[:n, :k] = state.w
    aug[:n, k] = state.b
    ref_column(aug, k)[:n] = state.ref_ui
    return dataclasses.replace(
        state,
        w=aug,
        b=torch.zeros((0,), dtype=F32, device=dev),
        ref_ui=torch.zeros((0,), dtype=I32, device=dev),
    )


def deaugment_state(state: TrainState, k: int, n_rows: int = 0) -> TrainState:
    """Inverse of augment_state, for checkpoints and prediction.  ``n_rows``
    slices off the sweep's pad rows (0: none).  The tables returned are
    views of the augmented one: copy them to keep them across a step."""
    aug = state.w[:n_rows] if n_rows else state.w
    return dataclasses.replace(
        state, w=aug[:, :k], b=aug[:, k], ref_ui=ref_column(aug, k)
    )


def _cumsum_rows(x: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """``torch.cumsum(x, dim=0)`` of an [E, C] payload as a blocked scan:
    prefix sums within blocks of ``chunk`` rows, plus the exclusive prefix
    of the block totals (the same scan, recursively).  The inclusive prefix
    sums are those of the JAX package's cumsum up to rounding order; the
    blocking keeps every sequential chain short, where a scan along dim 0
    of a few dozen columns runs as one sequential chain per column on the
    card (1.4 ms at E = 8192, most of a sorted-dedup step)."""
    E = x.shape[0]
    if E <= chunk:
        return torch.cumsum(x, dim=0)
    nb = -(-E // chunk)
    xb = torch.nn.functional.pad(x, (0, 0, 0, nb * chunk - E)).reshape(nb, chunk, -1)
    inner = torch.cumsum(xb, dim=1)
    totals = _cumsum_rows(inner[:, -1], chunk)
    offsets = torch.cat([torch.zeros_like(totals[:1]), totals[:-1]])
    return (inner + offsets[:, None]).reshape(nb * chunk, -1)[:E]


def sorted_dedup(ent_idx: torch.Tensor, payload: torch.Tensor, layout=None):
    """Sort entries by row id and accumulate duplicate payloads.

    Returns (order, si, acc, first, last): the stable sorting permutation,
    the sorted row ids, the cumulative payload within each row's run (the
    row's total at ``last`` positions), and the run boundary masks.  No
    scatter: duplicates merge through a cumsum (``_cumsum_rows``) and
    boundary differences, the first-position lookup is a cummax.  ``layout``: a precomputed
    (order, si, fpos, last) for a static entry schedule
    (``make_dedup_layout``); ``first`` is None on that branch.
    """
    if layout is not None:
        order, si, fpos, last = layout
        P = _cumsum_rows(payload[order])
        Pprev = torch.cat([torch.zeros_like(P[:1]), P[:-1]])
        return order, si, P - Pprev[fpos], None, last
    E = ent_idx.shape[0]
    order = torch.argsort(ent_idx, stable=True)
    si = ent_idx[order]
    P = _cumsum_rows(payload[order])
    neq = si[1:] != si[:-1]
    one = torch.ones(1, dtype=torch.bool, device=si.device)
    first = torch.cat([one, neq])
    last = torch.cat([neq, one])
    iota = torch.arange(E, device=si.device)
    fpos = torch.cummax(torch.where(first, iota, -1), dim=0).values
    Pprev = torch.cat([torch.zeros_like(P[:1]), P[:-1]])
    return order, si, P - Pprev[fpos], first, last


def make_dedup_layout(ent_idx):
    """Host-side layout for sorted_dedup over a STATIC entry schedule:
    (order, si, fpos, last) as numpy arrays, batched over any leading
    dims of ent_idx ([..., E]).  (Copy of the JAX package's numpy function,
    for the big-table SVD++ epoch.)"""
    import numpy as np

    order = np.argsort(ent_idx, axis=-1, kind="stable").astype(np.int32)
    si = np.take_along_axis(ent_idx, order, axis=-1).astype(np.int32)
    neq = si[..., 1:] != si[..., :-1]
    shape1 = si.shape[:-1] + (1,)
    first = np.concatenate([np.ones(shape1, bool), neq], axis=-1)
    last = np.concatenate([neq, np.ones(shape1, bool)], axis=-1)
    iota = np.arange(si.shape[-1], dtype=np.int32)
    fpos = np.maximum.accumulate(
        np.where(first, iota, -1), axis=-1
    ).astype(np.int32)
    return order, si, fpos, last


def gather_rows(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``w[idx]`` -> ``[*idx.shape, W]`` (``index_select``: the
    read direction needs no kernel of its own; K6, ops/cuda_scatter.row_reader,
    is its hand-written counterpart)."""
    rows = w.index_select(0, idx.reshape(-1).long())
    return rows.reshape(*idx.shape, w.shape[1])


def write_rows_unique(w, rows_idx, rows_val, *, row_dma: bool) -> torch.Tensor:
    """``w[rows_idx[j]] = rows_val[j]`` in place, targets unique except the
    dummy row, which only ever receives zeros.  ``row_dma``: the kernel
    wrapper K5 (it launches on CUDA tensors); else its plain version."""
    return (row_writer if row_dma else row_writer_reference)(w, rows_idx, rows_val)


class Forward(NamedTuple):
    """What the front half of a big-table step hands on."""

    g: torch.Tensor  # the updated global table
    ref_g: torch.Tensor
    rows_u: torch.Tensor  # [B, Su, W] gathered augmented rows
    rows_i: torch.Tensor  # [B, Si, W]
    wu: torch.Tensor  # [B, Su, k] their factors, lazily caught up
    wi: torch.Tensor  # [B, Si, k]
    nstep: torch.Tensor
    err: torch.Tensor  # [B]
    p_u: torch.Tensor  # [B, k]
    p_i: torch.Tensor  # [B, k]
    coef_u: torch.Tensor  # [B, Su] lr * err * u_val
    coef_i: torch.Tensor  # [B, Si] lr * err * i_val


def _global_catchup(g, ref_g, cg, step0, lr, consts: TrainConsts, hp):
    """The lazy global catch-up (reg_global 4/5) BEFORE the forward
    (regularize(pre), then pred, apex_svd_base.h:457) -> (g, ref_g)."""
    if hp.reg_global >= 4:
        kg = torch.where(cg > 0, (step0 - ref_g).to(F32), 0.0)
        lam_g = lr * consts.wd_g_row
        if hp.reg_global == 4:
            g = g * torch.pow(1.0 - lam_g, kg)
        else:
            g = _soft_threshold(g, lam_g * kg)
        ref_g = torch.where(cg > 0, step0, ref_g)
    return g, ref_g


def _global_step(g, g_idx, g_val, err, cg, lr, consts: TrainConsts, hp):
    """The global-bias update of a step (a small table) with its eager
    decay (reg_global 0/1); the padding slot stays 0."""
    g = _update_global(g, g_idx, g_val, err, lr, hp.exact_global)
    if hp.reg_global < 4:
        if hp.reg_global == 0:
            g = g * torch.pow(1.0 - lr * consts.wd_g_row, cg)
        elif hp.reg_global == 1:
            g = _soft_threshold(g, lr * consts.wd_g_row * cg)
        else:
            raise ValueError(f"unknown global decay method {hp.reg_global}")
    g[-1] = 0.0
    return g


def _forward_entries(state: TrainState, batch: Dict[str, torch.Tensor], lr, consts: TrainConsts,
                     hp, p_u_extra=None, bias_extra=None, bias_plugin=None) -> Forward:
    """Front half of the big-table step (big_embed.py:199-316): the lazy
    global catch-up, the forward with the lazy row catch-up applied to the
    gathered rows, the error and the global-bias update.  Shared with the
    tile-sweep step (ops/tile_sweep.py), which forms the entries from
    ``p_u``, ``p_i`` and the coefficients in its kernel; the sorted-dedup
    step builds them as a payload (``entry_payload``); and the big-table
    SVD++ / multi-IMFB epochs (ops/svdpp_big.py, ops/imfb.py).

    ``p_u_extra [B, k]`` / ``bias_extra [B]`` inject the SVD++ feedback
    term (prepare_svdpp / get_bias_svdpp, apex_svd_base.h:429-437): it
    joins ``p_u`` before the item entries are formed, so item rows move
    with the full user factor (update_no_decay, :408-416).  ``bias_plugin
    [B]`` adds a solver's plugin bias (get_bias_plugin, :436-438) after the
    item bias, outside the no_user_bias gate (big_embed.py:274-277)."""
    w, g = state.w, state.g
    k = hp.num_factor
    if not 0 < k <= w.shape[1] - 2:
        raise ValueError("the augmented layout requires hp.num_factor")
    u_idx, i_idx, g_idx = batch["u_idx"], batch["i_idx"], batch["g_idx"]
    u_val, i_val = batch["u_val"], batch["i_val"]
    step0 = state.step
    ref_g = state.ref_g
    lazy = hp.reg_method >= 4

    cg = _touch_counts(g.shape[0], g_idx)
    g, ref_g = _global_catchup(g, ref_g, cg, step0, lr, consts, hp)

    # forward: augmented-row gathers with per-entry lazy catch-up
    rows_u = gather_rows(w, u_idx)  # [B, Su, W]
    rows_i = gather_rows(w, i_idx)
    wu, bu = rows_u[..., :k], rows_u[..., k]
    wi, bi = rows_i[..., :k], rows_i[..., k]
    if lazy:
        el_u = (step0 - rows_u.view(I32)[..., k + 1]).to(F32)
        el_i = (step0 - rows_i.view(I32)[..., k + 1]).to(F32)
        lam_u = lr * consts.wd_u_row[u_idx.long()]
        lam_i = lr * consts.wd_i_row[i_idx.long()]
        if hp.reg_method == 4:
            wu = wu * torch.pow(1.0 - lam_u, el_u)[..., None]
            wi = wi * torch.pow(1.0 - lam_i, el_i)[..., None]
        else:
            wu = _soft_threshold(wu, (lam_u * el_u)[..., None])
            wi = _soft_threshold(wi, (lam_i * el_i)[..., None])
    p_u = (u_val[..., None] * wu).sum(dim=1)
    p_i = (i_val[..., None] * wi).sum(dim=1)
    if p_u_extra is not None:
        p_u = p_u + p_u_extra
    score = hp.base_score + _gather_sum(g, g_idx, batch["g_val"])
    score = score + (i_val * bi).sum(dim=1)
    if bias_plugin is not None:
        score = score + bias_plugin
    if not hp.no_user_bias:
        score = score + (u_val * bu).sum(dim=1)
        if bias_extra is not None:
            score = score + bias_extra
    score = score + (p_u * p_i).sum(dim=1)
    pred = losses.map_active(score, hp.active_type)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]
    lr_err = lr * err

    g = _global_step(g, g_idx, batch["g_val"], err, cg, lr, consts, hp)
    coef_u = lr_err[:, None] * u_val  # [B, Su]
    coef_i = lr_err[:, None] * i_val
    nstep = step0 + (batch["weight"] > 0).sum().to(I32)
    return Forward(g=g, ref_g=ref_g, rows_u=rows_u, rows_i=rows_i, wu=wu, wi=wi, nstep=nstep,
                   err=err, p_u=p_u, p_i=p_i, coef_u=coef_u, coef_i=coef_i)


def entry_payload(p_u: torch.Tensor, p_i: torch.Tensor, coef_u: torch.Tensor,
                  coef_i: torch.Tensor, no_user_bias) -> torch.Tensor:
    """The batch's entry stream as a payload ``[E, k+3]`` = ``[dw | db |
    cnt_u | cnt_i]``, one row per (example, feature slot) occurrence in the
    order of ``cat(u_idx.ravel(), i_idx.ravel())`` (big_embed.py:290-316):
    a user entry of example b carries ``coef_u * p_i[b]``, ``coef_u`` (0
    without user bias) and cnt_u = 1; an item entry ``coef_i * p_u[b]``,
    ``coef_i`` and cnt_i = 1."""
    B, Su = coef_u.shape
    Si = coef_i.shape[1]
    k = p_u.shape[1]
    dev = p_u.device
    pay_w = torch.cat([
        (coef_u[..., None] * p_i[:, None, :]).reshape(-1, k),
        (coef_i[..., None] * p_u[:, None, :]).reshape(-1, k),
    ])
    db_u = torch.zeros(B * Su, dtype=F32, device=dev) if no_user_bias else coef_u.reshape(-1)
    pay_b = torch.cat([db_u, coef_i.reshape(-1)])
    cnt_u = torch.cat([torch.ones(B * Su, dtype=F32, device=dev),
                       torch.zeros(B * Si, dtype=F32, device=dev)])
    return torch.cat([pay_w, pay_b[:, None], cnt_u[:, None], (1.0 - cnt_u)[:, None]], dim=1)


def apply_entries(w, step0, ent_idx, payload, rows_u, rows_i, wu, wi, lr, consts: TrainConsts, hp,
                  layout=None) -> torch.Tensor:
    """Back half of the big-table step (big_embed.py:319-413): sorted-dedup
    merge of the entry stream, per-touched-row regularization, ONE
    unique-row write into ``w`` (in place)."""
    n_tbl, Wd = w.shape
    k = hp.num_factor
    dummy = n_tbl - 1
    lazy = hp.reg_method >= 4

    if tracing.on:
        tracing.begin("merge")
    order, si, acc, _first, last = sorted_dedup(ent_idx, payload, layout)
    dw = acc[:, :k]
    db = acc[:, k]
    cu = acc[:, k + 1]
    ci = acc[:, k + 2]

    # new-row values in the gathered domain: the forward-gathered rows go
    # through the same permutation instead of re-reading the table
    raw_rows = torch.cat([rows_u.reshape(-1, Wd), rows_i.reshape(-1, Wd)])[order]
    raw_old_w = raw_rows[:, :k]
    old_b = raw_rows[:, k]
    raw_ref = raw_rows.view(I32)[:, k + 1]
    sil = si.long()
    wd_u = consts.wd_u_row[sil]
    wd_i = consts.wd_i_row[sil]
    if lazy:
        # writeback base: catch the raw row up once, with the same
        # row-level wd choice as the dense lazy path (cu>0 -> user rate)
        el = (step0 - raw_ref).to(F32)
        lam = lr * torch.where(cu > 0, wd_u, wd_i)
        if hp.reg_method == 4:
            base_w = raw_old_w * torch.pow(1.0 - lam, el)[:, None]
        else:
            base_w = _soft_threshold(raw_old_w, (lam * el)[:, None])
        new_w = base_w + dw
        new_ref = step0.expand(si.shape)
    else:
        fwd_w = torch.cat([wu.reshape(-1, k), wi.reshape(-1, k)])[order]
        new_w = _apply_factor_reg(fwd_w + dw, cu, ci, lr, wd_u, wd_i, hp.reg_method)
        # ref is inert outside the lazy modes: carry the stored bits through
        new_ref = raw_ref
    if hp.user_nonnegative:
        new_w = torch.where((cu > 0)[:, None], torch.clamp(new_w, min=0.0), new_w)
    if hp.item_nonnegative:
        new_w = torch.where((ci > 0)[:, None], torch.clamp(new_w, min=0.0), new_w)

    fac_b = torch.pow(1.0 - lr * consts.wd_item_bias, ci)
    if not hp.no_user_bias:
        fac_b = fac_b * torch.pow(1.0 - lr * consts.wd_user_bias, cu)
    new_b = (old_b + db) * fac_b

    # assemble the rows and write them once: duplicates and the padding
    # row collapse onto the dummy row, which only ever receives zeros (so
    # concurrent writes are benign and the dummy stays clean)
    is_real = last & (si != dummy)
    tgt = torch.where(is_real, si, dummy)
    out_rows = torch.zeros((si.shape[0], Wd), dtype=F32, device=w.device)
    out_rows[:, :k] = torch.where(is_real[:, None], new_w, 0.0)
    out_rows[:, k] = torch.where(is_real, new_b, 0.0)
    ref_column(out_rows, k)[:] = torch.where(is_real, new_ref, 0)
    if tracing.on:
        tracing.then("write")
    w = write_rows_unique(w, tgt.to(I32), out_rows, row_dma=hp.row_dma)
    if tracing.on:
        tracing.end()
    return w


def dedup_step(state: TrainState, batch: Dict[str, torch.Tensor], lr, consts: TrainConsts, hp,
               p_u_extra=None, bias_extra=None, bias_plugin=None) -> Tuple[TrainState, Forward]:
    """One sorted-dedup step, with the optional SVD++ feedback term and
    plugin bias of ``_forward_entries``; returns the new TrainState and the
    forward's outputs (the SVD++ recurrence reads ``err`` and ``p_i``).
    Traced as the spans ``forward``, ``payload``, then ``apply_entries``'s
    ``merge`` and ``write``."""
    if tracing.on:
        tracing.begin("forward")
    f = _forward_entries(state, batch, lr, consts, hp, p_u_extra, bias_extra, bias_plugin)
    if tracing.on:
        tracing.then("payload")
    ent_idx = torch.cat([batch["u_idx"].reshape(-1), batch["i_idx"].reshape(-1)])
    payload = entry_payload(f.p_u, f.p_i, f.coef_u, f.coef_i, hp.no_user_bias)
    if tracing.on:
        tracing.end()
    w = apply_entries(state.w, state.step, ent_idx, payload, f.rows_u, f.rows_i, f.wu, f.wi,
                      lr, consts, hp)
    return TrainState(w=w, b=state.b, g=f.g, step=f.nstep, ref_ui=state.ref_ui, ref_g=f.ref_g), f


@torch.no_grad()
def train_step_big(state: TrainState, batch: Dict[str, torch.Tensor], lr, consts: TrainConsts,
                   hp) -> TrainState:
    """One batched SGD step on an augmented table (``augment_state``, with
    ``hp.num_factor`` holding k); semantics of big_embed.train_step_big."""
    return dedup_step(state, batch, lr, consts, hp)[0]
