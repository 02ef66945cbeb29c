"""The mesh on big slabs: sorted-dedup row updates on row-sharded
augmented tables, written through K5.

PyTorch counterpart of svdfeature_tpu/parallel/mesh_big.py.  The small
mesh step (parallel/mesh.py) adds the all-gathered updates with
``index_add_``; above ``BIG_TABLE_ROWS`` local rows the JAX package turns
each shard's update into the single-device big-table step's sort ->
cumsum-dedup -> unique-row write on its LOCAL slab
(ops/big_embed.apply_entries), and so does the port.  On a CUDA slab with
``hp.row_dma`` that write is the hand-written kernel K5
(ops/cuda_scatter.row_writer): one launch per step on every rank, E =
the gathered stream's entries (8192 at a global batch of 4096 with one
user and one item id an example).

Layout (mesh_big.py:14-22).  A slab is ``[n_real + 1, W]`` rows of the
augmented format ``[factors | bias | ref_bits | pad]`` (ops/big_embed.py,
``aug_width``), shard ``m`` holding the logical rows ``[m * n_real, (m + 1)
* n_real)`` and, last, ONE scratch row: non-owned ids are redirected
there, and since the dedup write REPLACES rows, the redirect target must
take any overwrite (apply_entries writes zeros to it, as to the dummy row
of the single-device table).  Batch ids stay in the logical row space;
only shard / unshard interleave the scratch rows.

A step (mesh_big.py:203-304): the batch's global-slot counts and example
count psum'd over ``data``; masked local row gathers with the lazy
catch-up on the gathered copies, psum'd over ``model``; the global bias's
damped update with sums psum'd over ``data``; the entry stream's local
ids and its floats (coefficients, p-vectors) all-gathered over ``data``
(the own flags follow from the gathered ids: an id is owned when it is not
the scratch row); then every rank merges the whole stream into its slab
through ``apply_entries``, which re-reads the stream's raw rows from the
local slab (no table rows cross ranks).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .. import losses
from ..ops.big_embed import aug_width, apply_entries, deaugment_state, gather_rows, ref_column
from ..ops.embed import HyperParams, TrainConsts, TrainState, _soft_threshold, batches
from .comm import Mesh, all_gather, psum
from .mesh import (activated_score, batch_counts, global_catchup, global_decay,
                   global_update_psum, own_rows)

F32, I32 = torch.float32, torch.int32


def big_layout(n: int, n_model: int) -> Tuple[int, int]:
    """(n_real, n_phys): the real rows a shard owns and its slab's rows
    (+1 scratch row for the redirects of non-owned ids)."""
    n_real = -(-n // n_model)
    return n_real, n_real + 1


def shard_state_big(state: TrainState, mesh: Mesh, k: int) -> Tuple[TrainState, int]:
    """The single-device state (``w [n, k]``, ``b [n]``, ``ref_ui [n]``, the
    dummy row last) -> this rank's augmented slab ``[n_real + 1, W]`` with
    the scratch row last (zeros); ``b`` / ``ref_ui`` empty, ``g``
    replicated.  Returns (state, n_real)."""
    n_real, n_phys = big_layout(state.w.shape[0], mesh.n_model)
    lo, dev = mesh.m * n_real, mesh.device
    aug = torch.zeros((n_phys, aug_width(k)), dtype=F32, device=dev)
    aug[:n_real, :k] = own_rows(state.w, lo, n_real, dev)
    aug[:n_real, k] = own_rows(state.b, lo, n_real, dev)
    ref_column(aug, k)[:n_real] = own_rows(state.ref_ui, lo, n_real, dev)
    empty_f, empty_i = (torch.zeros((0,), dtype=t, device=dev) for t in (F32, I32))
    local = TrainState(w=aug, b=empty_f, g=state.g.to(dev, copy=True),
                       step=state.step.to(dev, copy=True), ref_ui=empty_i,
                       ref_g=state.ref_g.to(dev, copy=True))
    return local, n_real


def unshard_state_big(w_full: torch.Tensor, state: TrainState, n_model: int, k: int,
                      n: int) -> TrainState:
    """Inverse of shard_state_big from the gathered slabs ``w_full
    [n_model * (n_real + 1), W]``: the scratch rows stripped, the table cut
    to its ``n`` rows, de-augmented (views: copy them to keep them)."""
    n_real, n_phys = big_layout(n, n_model)
    aug = w_full.reshape(n_model, n_phys, -1)[:, :n_real].reshape(n_model * n_real, -1)[:n]
    return deaugment_state(dataclasses.replace(state, w=aug), k)


def unshard_big(state: TrainState, mesh: Mesh, k: int, n: int) -> TrainState:
    """The single-device state from the slabs of this rank's ``model``
    group (an all-gather over ``model``: every rank of the group calls
    it); the ref counters ride the slab's float column bit for bit."""
    (w_full,) = all_gather(mesh, "model", state.w)
    return unshard_state_big(w_full, state, mesh.n_model, k, n)


def shard_consts_big(consts: TrainConsts, mesh: Mesh, n_real: int) -> TrainConsts:
    """The per-row decay rates of this rank's slab (the scratch row's 0)."""
    lo, dev = mesh.m * n_real, mesh.device

    def slab(t):  # the real rows' rates, then the scratch row's 0
        return torch.cat([own_rows(t, lo, n_real, dev), torch.zeros(1, device=dev)])

    return TrainConsts(
        wd_u_row=slab(consts.wd_u_row),
        wd_i_row=slab(consts.wd_i_row),
        wd_g_row=consts.wd_g_row.to(dev, copy=True),
        wd_user_bias=consts.wd_user_bias.to(dev, copy=True),
        wd_item_bias=consts.wd_item_bias.to(dev, copy=True),
    )


def _local_entries(batch, lo: int, n_real: int):
    """Per segment: local ids (non-owned -> the scratch row ``n_real``) and
    values with the non-owned ones zeroed."""
    out = []
    for seg in ("u", "i"):
        loc = batch[f"{seg}_idx"] - lo
        own = (loc >= 0) & (loc < n_real)
        out.append((torch.where(own, loc, n_real), torch.where(own, batch[f"{seg}_val"], 0.0)))
    return out


def fwd_big_partials(w, batch, hp: HyperParams, lr, consts: TrainConsts, step0, lo: int,
                     n_real: int):
    """Masked local gathers of the augmented rows, the lazy catch-up on the
    gathered copies (reg 4/5), before their psum over ``model`` ->
    ([p_u, p_i, bias], (lu, uv), (li, iv)) (mesh_big.py:150-200)."""
    k = hp.num_factor
    (lu, uv), (li, iv) = _local_entries(batch, lo, n_real)
    rows_u, rows_i = gather_rows(w, lu), gather_rows(w, li)  # [B, S, W]
    wu, wi = rows_u[..., :k], rows_i[..., :k]
    if hp.reg_method >= 4:
        el_u = (step0 - rows_u.view(I32)[..., k + 1]).to(F32)
        el_i = (step0 - rows_i.view(I32)[..., k + 1]).to(F32)
        lam_u = lr * consts.wd_u_row[lu.long()]  # the scratch row's rate is 0
        lam_i = lr * consts.wd_i_row[li.long()]
        if hp.reg_method == 4:
            wu = wu * torch.pow(1.0 - lam_u, el_u)[..., None]
            wi = wi * torch.pow(1.0 - lam_i, el_i)[..., None]
        else:
            wu = _soft_threshold(wu, (lam_u * el_u)[..., None])
            wi = _soft_threshold(wi, (lam_i * el_i)[..., None])
    p_u = (uv[..., None] * wu).sum(dim=1)
    p_i = (iv[..., None] * wi).sum(dim=1)
    bias = (iv * rows_i[..., k]).sum(dim=1)
    if not hp.no_user_bias:
        bias = bias + (uv * rows_u[..., k]).sum(dim=1)
    return [p_u, p_i, bias], (lu, uv), (li, iv)


@torch.no_grad()
def sharded_train_step_big(state: TrainState, batch: Dict[str, torch.Tensor], lr,
                           consts: TrainConsts, hp: HyperParams, mesh: Mesh,
                           n_real: int) -> TrainState:
    """One step on this rank's augmented slab ``[n_real + 1, W]``, written
    in place (through K5 on a CUDA slab with ``hp.row_dma``): the per-shard
    body of JAX ``sharded_train_step_big`` (mesh_big.py:203-304)."""
    k = hp.num_factor
    if k <= 0:
        raise ValueError("the mesh big path requires hp.num_factor")
    w, step0 = state.w, state.step
    lo = mesh.m * n_real
    (cg, present) = batch_counts(batch, mesh, state.g.shape[0])
    g, ref_g = global_catchup(state.g, state.ref_g, cg, step0, lr, consts, hp)

    parts, u_ent, i_ent = fwd_big_partials(w, batch, hp, lr, consts, step0, lo, n_real)
    p_u, p_i, bias = psum(mesh, "model", *parts)
    pred = activated_score(p_u, p_i, bias, g, batch, hp)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]
    g = global_decay(global_update_psum(g, batch, err, lr, mesh), cg, lr, consts, hp)
    w, _ = merge_gathered(w, step0, u_ent, i_ent, lr * err, p_u, p_i, lr, consts, hp, mesh,
                          n_real)
    return TrainState(w=w, b=state.b, g=g, step=step0 + present, ref_ui=state.ref_ui,
                      ref_g=ref_g)


def merge_gathered(w, step0, u_ent, i_ent, lr_err, p_u, p_i, lr, consts: TrainConsts,
                   hp: HyperParams, mesh: Mesh, n_real: int, extra=()):
    """The row update of a big-slab step (mesh_big.py:262-300): this data
    rank's entries (``(local ids, values)`` of each segment) with their
    coefficients and p-vectors, all-gathered over ``data`` in one call,
    merged into the slab by ``apply_entries`` (one K5 write with
    ``hp.row_dma`` on a CUDA slab).  The ``extra`` tensors (4-byte dtypes:
    the bilinear step's W_bi entries) ride the same gather.  Returns the
    slab, written in place, and the extras' ``[n_data, *shape]`` stacks."""
    k = hp.num_factor
    (lu, uv), (li, iv) = u_ent, i_ent
    # the entry stream of the whole batch, gathered over data (activations,
    # not rows); an entry's own flag is its id not being the scratch row
    g_lu, g_li, g_cu, g_ci, g_pu, g_pi, *more = all_gather(
        mesh, "data", lu.to(I32), li.to(I32), lr_err[:, None] * uv, lr_err[:, None] * iv, p_u, p_i,
        *extra)
    Eu, Ei = g_lu.numel(), g_li.numel()
    ent_idx = torch.cat([g_lu.reshape(-1), g_li.reshape(-1)])
    dw = torch.cat([(g_cu[..., None] * g_pi[:, :, None, :]).reshape(-1, k),
                    (g_ci[..., None] * g_pu[:, :, None, :]).reshape(-1, k)])
    db_u = torch.zeros(Eu, dtype=F32, device=w.device) if hp.no_user_bias else g_cu.reshape(-1)
    pay_b = torch.cat([db_u, g_ci.reshape(-1)])
    zu, zi = (torch.zeros(E, dtype=F32, device=w.device) for E in (Eu, Ei))
    cnt_u = torch.cat([(g_lu.reshape(-1) < n_real).to(F32), zi])
    cnt_i = torch.cat([zu, (g_li.reshape(-1) < n_real).to(F32)])
    payload = torch.cat([dw, pay_b[:, None], cnt_u[:, None], cnt_i[:, None]], dim=1)

    # the merge needs every entry's pre-update row: the forward gathered
    # only this data rank's slice, so the whole stream is read again from
    # the local slab; the eager modes add to the raw row, the lazy ones
    # catch it up from its ref bits inside apply_entries
    raw_u, raw_i = gather_rows(w, g_lu.reshape(-1)), gather_rows(w, g_li.reshape(-1))
    return apply_entries(w, step0, ent_idx, payload, raw_u, raw_i, raw_u[:, :k], raw_i[:, :k],
                         lr, consts, hp), more


@torch.no_grad()
def sharded_train_rounds_big(state: TrainState, stacked: Dict[str, torch.Tensor], lrs,
                             consts: TrainConsts, hp: HyperParams, mesh: Mesh,
                             n_real: int) -> TrainState:
    """R rounds over the T batches of this rank's columns, round r at
    ``lrs[r]`` (mesh_big.py:342-372)."""
    bs = batches(stacked)
    for r in range(lrs.shape[0]):
        for batch in bs:
            state = sharded_train_step_big(state, batch, lrs[r], consts, hp, mesh, n_real)
    return state


def predict_partials_big(state: TrainState, batch, hp: HyperParams, mesh: Mesh,
                         n_real: int):
    """This model position's (p_u, p_i, bias) of one batch of this rank's
    columns on the augmented slabs, before their psum over ``model``
    (mesh_big.py:178-200).  Like the single-device infer path, pending lazy
    decay is not applied (the reference predicts with the stored
    parameters, svd_feature_infer.cpp:243-277)."""
    k = hp.num_factor
    (lu, uv), (li, iv) = _local_entries(batch, mesh.m * n_real, n_real)
    rows_u, rows_i = gather_rows(state.w, lu), gather_rows(state.w, li)
    p_u = (uv[..., None] * rows_u[..., :k]).sum(dim=1)
    p_i = (iv[..., None] * rows_i[..., :k]).sum(dim=1)
    bias = (iv * rows_i[..., k]).sum(dim=1)
    if not hp.no_user_bias:
        bias = bias + (uv * rows_u[..., k]).sum(dim=1)
    return [p_u, p_i, bias]


@torch.no_grad()
def sharded_predict_big(state: TrainState, stacked: Dict[str, torch.Tensor], hp: HyperParams,
                        mesh: Mesh, n_real: int) -> torch.Tensor:
    """Predictions ``[T, B / n_data]`` of this rank's columns on the
    augmented slabs (mesh_big.py:375-423)."""
    out = []
    for batch in batches(stacked):
        p_u, p_i, bias = psum(mesh, "model", *predict_partials_big(state, batch, hp, mesh, n_real))
        out.append(activated_score(p_u, p_i, bias, state.g, batch, hp))
    return torch.stack(out)
