"""The base solver on a ``(data, model)`` mesh: row-sharded tables,
data-sharded batches, one process per mesh position.

PyTorch counterpart of svdfeature_tpu/parallel/mesh.py.  The JAX module
builds ``shard_map``'d steps over one process's devices; here each rank
runs the same per-shard step body on its own slab, and the collectives of
parallel/comm.py take the places of ``jax.lax.psum`` / ``all_gather``:

* the unified table ``w`` / ``b`` (and the lazy refs) is row-sharded over
  ``model``: position ``m`` owns the rows ``[m * n_local, (m + 1) *
  n_local)`` of the table padded to a multiple of ``n_model``;
  ``g`` is replicated;
* the batch is sharded over ``data``: data position ``d`` takes the columns
  ``[d * per, (d + 1) * per)`` of every ``[T, B]`` plane
  (``put_process_sharded``, mesh.py:101-129), which are not a contiguous
  range of examples;
* lookup = masked local gather + psum over ``model``: ids a shard does not
  own hit its last local row with value 0, so they add nothing;
* update: the shard's (local ids, coefficients, factors) are all-gathered
  over ``data`` and every data replica of a shard applies the same
  ``index_add_`` (non-owned ids add a zero coefficient to the redirect
  row), so the replicas stay equal; the global bias takes the psum'd batch
  statistics over ``data``.

A step makes at most four collectives: the batch's touch counts, the
number of examples and the global slots' counts, psum'd over ``data`` in
one call (they depend on the batch alone); the forward's partial sums over
``model``; the ids and floats of the row updates, gathered over ``data``
in one call; the global update's sums over ``data`` (skipped with no
global feature: the one slot is the dummy, 0 after every step).  On a small slab the step is
plain torch, as the JAX mesh step is jnp: no kernel takes it.  Parity with
JAX's mesh step and its single-device step is held by
tests/test_torch_mesh.py within rtol 2e-5 + atol 1e-6 per step: psum and
``index_add_`` sum in another order than XLA.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import losses
from ..ops.embed import (HyperParams, TrainConsts, TrainState, _apply_factor_reg, _gather_sum,
                         _scatter_rows, _scatter_vals, _slot_sums, _soft_threshold, _touch_counts,
                         batches)
from .comm import Mesh, all_gather, psum

F32, I32 = torch.float32, torch.int32


def put_process_sharded(arrays: Dict, mesh: Mesh) -> Dict:
    """This rank's ``data`` slice of stacked ``[T, B, ...]`` planes (numpy
    arrays or tensors): the columns ``[d * per, (d + 1) * per)`` of each,
    ``per = B / n_data``, contiguous; every rank packs the whole dataset
    and keeps its slice, as each JAX host does (mesh.py:101-129)."""
    B = arrays["label"].shape[1]
    if B % mesh.n_data:
        raise ValueError(f"batch of {B} columns does not split over {mesh.n_data} data ranks")
    per = B // mesh.n_data
    cols = slice(mesh.d * per, (mesh.d + 1) * per)

    def take(x):
        x = x[:, cols]
        return x.contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)

    return {name: take(x) for name, x in arrays.items()}


def _pad_rows(n: int, shards: int) -> int:
    """Padded row count so each shard owns an equal slab (dummy included)."""
    return -(-n // shards) * shards


def own_rows(x: torch.Tensor, lo: int, count: int, device: torch.device) -> torch.Tensor:
    """Rows ``[lo, lo + count)`` of ``x`` on ``device``, zero past its end."""
    out = torch.zeros((count, *x.shape[1:]), dtype=x.dtype, device=device)
    have = max(0, min(count, x.shape[0] - lo))
    out[:have] = x[lo:lo + have].to(device)
    return out


def shard_state(state: TrainState, mesh: Mesh) -> Tuple[TrainState, int]:
    """The single-device state (dummy row last) -> this rank's row slab of
    the table padded to a multiple of ``n_model``, and the padded row
    count.  ``g`` and the refs of the globals are replicated."""
    n_pad = _pad_rows(state.w.shape[0], mesh.n_model)
    n_local = n_pad // mesh.n_model
    lo, dev = mesh.m * n_local, mesh.device
    local = TrainState(
        w=own_rows(state.w, lo, n_local, dev),
        b=own_rows(state.b, lo, n_local, dev),
        g=state.g.to(dev, copy=True),
        step=state.step.to(dev, copy=True),
        ref_ui=own_rows(state.ref_ui, lo, n_local, dev),
        ref_g=state.ref_g.to(dev, copy=True),
    )
    return local, n_pad


def shard_consts(consts: TrainConsts, mesh: Mesh, n_pad: int) -> TrainConsts:
    n_local = n_pad // mesh.n_model
    lo, dev = mesh.m * n_local, mesh.device
    return TrainConsts(
        wd_u_row=own_rows(consts.wd_u_row, lo, n_local, dev),
        wd_i_row=own_rows(consts.wd_i_row, lo, n_local, dev),
        wd_g_row=consts.wd_g_row.to(dev, copy=True),
        wd_user_bias=consts.wd_user_bias.to(dev, copy=True),
        wd_item_bias=consts.wd_item_bias.to(dev, copy=True),
    )


def unshard_state(state: TrainState, mesh: Mesh, n: int) -> TrainState:
    """The single-device state (``n`` rows, dummy included) from the row
    slabs of this rank's ``model`` group: an all-gather over ``model``
    (every rank of the group calls it)."""
    w, b = all_gather(mesh, "model", state.w, state.b)
    (ref_ui,) = all_gather(mesh, "model", state.ref_ui)
    k = state.w.shape[1]
    return TrainState(w=w.reshape(-1, k)[:n], b=b.reshape(-1)[:n], g=state.g, step=state.step,
                      ref_ui=ref_ui.reshape(-1)[:n], ref_g=state.ref_g)


# ---- the per-shard pieces of a step (mesh.py:185-385) ------------------------


def _owned(idx: torch.Tensor, lo: int, n_local: int):
    """(local index, owned mask) of global ids ``idx``."""
    loc = idx - lo
    return loc, (loc >= 0) & (loc < n_local)


def _local_ids(idx, val, lo: int, n_local: int, dummy: int):
    """Local ids with non-owned ones sent to the redirect row ``dummy``,
    and their values with the non-owned ones zeroed."""
    loc, own = _owned(idx, lo, n_local)
    return torch.where(own, loc, dummy), torch.where(own, val, 0.0)


def _local_gather_sum(tab, idx, val, lo: int, n_local: int, dummy: int) -> torch.Tensor:
    """Masked local gather: owned ids read their local rows, the others
    the redirect row with value 0."""
    li, lv = _local_ids(idx, val, lo, n_local, dummy)
    return _gather_sum(tab, li, lv)


def forward_partials(w, b, batch, hp: HyperParams, lo: int, n_local: int,
                     dummy: int) -> List[torch.Tensor]:
    """This model position's (p_u, p_i, bias): masked local gathers, before
    their psum over ``model``."""
    u_idx, u_val = batch["u_idx"], batch["u_val"]
    i_idx, i_val = batch["i_idx"], batch["i_val"]
    p_u = _local_gather_sum(w, u_idx, u_val, lo, n_local, dummy)
    p_i = _local_gather_sum(w, i_idx, i_val, lo, n_local, dummy)
    bias = _local_gather_sum(b, i_idx, i_val, lo, n_local, dummy)
    if not hp.no_user_bias:
        bias = bias + _local_gather_sum(b, u_idx, u_val, lo, n_local, dummy)
    return [p_u, p_i, bias]


def _sharded_forward(w, b, batch, hp: HyperParams, mesh: Mesh, lo: int, n_local: int,
                     dummy: int) -> List[torch.Tensor]:
    """(p_u, p_i, bias): masked local gathers psum'd over ``model``."""
    return psum(mesh, "model", *forward_partials(w, b, batch, hp, lo, n_local, dummy))


def batch_counts(batch, mesh: Mesh, n_g: int, lo: int = 0, n_local: int = 0, extra=()):
    """What a step needs of the whole batch before its forward, psum'd over
    ``data`` in one call: the touch counts of the local rows ``cu`` / ``ci``
    ([n_local] each; every occurrence of an owned id counts, value 0
    included, as ``_touch_counts_sharded`` at mesh.py:277-291; none with
    ``n_local`` 0), the global slots' counts ``cg`` and the number of
    examples of positive weight, then the sums of the ``extra`` tensors,
    which ride the same call (the user-group steps' feedback aggregates)."""
    parts = []
    for seg in ("u", "i") if n_local else ():
        loc, own = _owned(batch[f"{seg}_idx"], lo, n_local)
        # non-owned ids are weighted 0, so the last local row (a real row
        # off the tail) gets nothing from them
        parts.append(_slot_sums(n_local, torch.where(own, loc, n_local - 1), own.to(F32)))
    parts.append(_touch_counts(n_g, batch["g_idx"]))
    parts.append((batch["weight"] > 0).sum().to(F32).reshape(1))
    n = len(parts)
    summed = psum(mesh, "data", *parts, *extra)
    *counts, present = summed[:n]
    return (*counts, present[0].round().to(I32), *summed[n:])


def global_sums(g, batch, err) -> List[torch.Tensor]:
    """This rank's batch statistics of the global bias's damped update
    (S: sum err*v, C2: sum v^2 per slot), none with no global feature: the
    one slot is then the dummy, set to 0 after the step."""
    n_g = g.shape[0]
    if n_g == 1:
        return []
    return [_slot_sums(n_g, batch["g_idx"], err[:, None] * batch["g_val"]),
            _slot_sums(n_g, batch["g_idx"], batch["g_val"] * batch["g_val"])]


def global_apply(g, sums: List[torch.Tensor], lr) -> torch.Tensor:
    """The damped update from the statistics psum'd over ``data``."""
    if not sums:
        return g
    gS, gC2 = sums
    return g + lr * gS / (1.0 + lr * gC2)


def global_update_psum(g, batch, err, lr, mesh: Mesh) -> torch.Tensor:
    """The replicated global bias's damped update with the batch statistics
    psum'd over ``data`` (mesh.py:226-235); no collective with no global
    feature."""
    sums = global_sums(g, batch, err)
    return global_apply(g, psum(mesh, "data", *sums) if sums else [], lr)


def global_decay(g, cg, lr, consts: TrainConsts, hp: HyperParams) -> torch.Tensor:
    """Eager decay of the global bias (reg_global 0/1) and its dummy slot
    set to 0."""
    if hp.reg_global == 0:
        g = g * torch.pow(1.0 - lr * consts.wd_g_row, cg)
    elif hp.reg_global == 1:
        g = _soft_threshold(g, lr * consts.wd_g_row * cg)
    elif hp.reg_global < 4:
        raise ValueError(f"unknown global decay method {hp.reg_global}")
    g = g.clone()
    g[-1] = 0.0
    return g


def global_catchup(g, ref_g, cg, step0, lr, consts: TrainConsts, hp: HyperParams):
    """Lazy catch-up of the global slots (reg_global 4/5) -> (g, ref_g)."""
    if hp.reg_global >= 4:
        kg = torch.where(cg > 0, (step0 - ref_g).to(F32), 0.0)
        lam_g = lr * consts.wd_g_row
        g = g * torch.pow(1.0 - lam_g, kg) if hp.reg_global == 4 else _soft_threshold(g, lam_g * kg)
        ref_g = torch.where(cg > 0, step0, ref_g)
    return g, ref_g


def _lazy_catchup_sharded(w, ref_ui, cu, ci, step0, lr, consts: TrainConsts, hp: HyperParams):
    """Lazy decay (reg modes 4/5) of the touched local rows before the
    gradient (mesh.py:300-333) -> (w, ref_ui)."""
    if hp.reg_method >= 4:
        touched = (cu + ci) > 0
        k_ui = torch.where(touched, (step0 - ref_ui).to(F32), 0.0)
        lam = lr * torch.where(cu > 0, consts.wd_u_row, consts.wd_i_row)
        if hp.reg_method == 4:
            w = w * torch.pow(1.0 - lam, k_ui)[:, None]
        else:
            w = _soft_threshold(w, (lam * k_ui)[:, None])
        ref_ui = torch.where(touched, step0, ref_ui)
    return w, ref_ui


def _apply_row_updates(w, b, batch, lr_err, p_u, p_i, hp: HyperParams, mesh: Mesh, lo: int,
                       n_local: int, dummy: int, extra=()) -> List[torch.Tensor]:
    """The all-gathered sparse updates, applied in place and alike by every
    data replica of the shard (mesh.py:238-274): the communication is the
    batch's ids and O(B k) floats over ``data``, never table rows.  The
    ``extra`` tensors (4-byte dtypes: the bilinear step's W_bi entries)
    ride the same gather; returns their ``[n_data, *shape]`` stacks."""
    lu, lu_val = _local_ids(batch["u_idx"], batch["u_val"], lo, n_local, dummy)
    li, li_val = _local_ids(batch["i_idx"], batch["i_val"], lo, n_local, dummy)
    g_lu, g_li, g_cu, g_ci, g_pu, g_pi, *more = all_gather(
        mesh, "data", lu.to(I32), li.to(I32), lr_err[:, None] * lu_val, lr_err[:, None] * li_val,
        p_u, p_i, *extra)
    D, B, Su = g_lu.shape
    Si, k = g_li.shape[2], p_u.shape[1]
    _scatter_rows(w, g_lu.reshape(D * B, Su), g_cu.reshape(D * B, Su), g_pi.reshape(D * B, k))
    _scatter_rows(w, g_li.reshape(D * B, Si), g_ci.reshape(D * B, Si), g_pu.reshape(D * B, k))
    _scatter_vals(b, g_li.reshape(D * B, Si), g_ci.reshape(D * B, Si))
    if not hp.no_user_bias:
        _scatter_vals(b, g_lu.reshape(D * B, Su), g_cu.reshape(D * B, Su))
    return more


def _decay_clamp_scrub(w, b, cu, ci, lr, consts: TrainConsts, hp: HyperParams, lo: int,
                       n_local: int, n_pad: int):
    """Eager row regularization (modes 0-3; rows are whole on their shard),
    bias decay, the nonnegative clamps and, on the tail shard, the padded
    dummy row set to 0 (mesh.py:294-297) -> (w, b)."""
    dummy = n_local - 1
    if hp.reg_method < 4:
        w = _apply_factor_reg(w, cu, ci, lr, consts.wd_u_row, consts.wd_i_row, hp.reg_method)
    fac_b = torch.pow(1.0 - lr * consts.wd_item_bias, ci)
    if not hp.no_user_bias:
        fac_b = fac_b * torch.pow(1.0 - lr * consts.wd_user_bias, cu)
    b = b * fac_b
    if hp.user_nonnegative:
        w = torch.where((cu > 0)[:, None], torch.clamp(w, min=0.0), w)
    if hp.item_nonnegative:
        w = torch.where((ci > 0)[:, None], torch.clamp(w, min=0.0), w)
    if lo + dummy >= n_pad - 1:
        w[dummy] = 0.0
        b[dummy] = 0.0
    return w, b


def activated_score(p_u, p_i, bias, g, batch, hp: HyperParams, plug=None) -> torch.Tensor:
    """The activated prediction from the psum'd partial sums and the
    replicated global bias (mesh.py:367-371), with the bilinear plugin
    bias ``plug`` where given (added after ``bias``, as the JAX bodies do)."""
    score = hp.base_score + bias
    if plug is not None:
        score = score + plug
    score = score + (p_u * p_i).sum(dim=1)
    score = score + _gather_sum(g, batch["g_idx"], batch["g_val"])
    return losses.map_active(score, hp.active_type)


@torch.no_grad()
def sharded_train_step(state: TrainState, batch: Dict[str, torch.Tensor], lr,
                       consts: TrainConsts, hp: HyperParams, mesh: Mesh,
                       n_pad: int) -> TrainState:
    """One batched SGD step on this rank's slab and batch columns, the
    per-shard body of JAX ``sharded_train_step`` (mesh.py:336-385).  Every
    rank of the mesh calls it with its own slab and columns; ``state.w`` /
    ``state.b`` are updated in place."""
    n_local = n_pad // mesh.n_model
    lo, dummy = mesh.m * n_local, n_local - 1
    g, step0 = state.g, state.step
    cu, ci, cg, present = batch_counts(batch, mesh, g.shape[0], lo, n_local)
    w, ref_ui = _lazy_catchup_sharded(state.w, state.ref_ui, cu, ci, step0, lr, consts, hp)
    g, ref_g = global_catchup(g, state.ref_g, cg, step0, lr, consts, hp)

    b = state.b
    p_u, p_i, bias = _sharded_forward(w, b, batch, hp, mesh, lo, n_local, dummy)
    pred = activated_score(p_u, p_i, bias, g, batch, hp)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]

    _apply_row_updates(w, b, batch, lr * err, p_u, p_i, hp, mesh, lo, n_local, dummy)
    g = global_update_psum(g, batch, err, lr, mesh)
    g = global_decay(g, cg, lr, consts, hp)
    w, b = _decay_clamp_scrub(w, b, cu, ci, lr, consts, hp, lo, n_local, n_pad)
    return TrainState(w=w, b=b, g=g, step=step0 + present, ref_ui=ref_ui, ref_g=ref_g)


@torch.no_grad()
def sharded_train_rounds(state: TrainState, stacked: Dict[str, torch.Tensor], lrs,
                         consts: TrainConsts, hp: HyperParams, mesh: Mesh,
                         n_pad: int) -> TrainState:
    """R rounds over the T batches of this rank's columns, round r at
    ``lrs[r]`` (JAX ``sharded_train_rounds``, mesh.py:435-469)."""
    bs = batches(stacked)
    for r in range(lrs.shape[0]):
        for batch in bs:
            state = sharded_train_step(state, batch, lrs[r], consts, hp, mesh, n_pad)
    return state


@torch.no_grad()
def sharded_predict(state: TrainState, stacked: Dict[str, torch.Tensor], hp: HyperParams,
                    mesh: Mesh, n_pad: int) -> torch.Tensor:
    """Predictions ``[T, B / n_data]`` of this rank's columns on the
    row-sharded tables (JAX ``sharded_predict``, mesh.py:472-585)."""
    n_local = n_pad // mesh.n_model
    lo, dummy = mesh.m * n_local, n_local - 1
    out = []
    for batch in batches(stacked):
        p_u, p_i, bias = _sharded_forward(state.w, state.b, batch, hp, mesh, lo, n_local, dummy)
        out.append(activated_score(p_u, p_i, bias, state.g, batch, hp))
    return torch.stack(out)


def gather_predictions(preds: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[T, B]`` predictions in single-device order from each data rank's
    ``[T, B / n_data]`` columns: an all-gather over ``data``, so every
    rank ends with all of them (JAX ``process_allgather(tiled=True)``)."""
    (g,) = all_gather(mesh, "data", preds)  # [D, T, per]
    return g.permute(1, 0, 2).reshape(preds.shape[0], -1)
