"""Bilinear (extend_type=15) on a ``(data, model)`` mesh: the SVD++ mesh step
with the W_bi coupling.

PyTorch counterpart of svdfeature_tpu/parallel/bilinear_mesh.py.  Every
rank runs the per-shard body of the JAX module's ``shard_map`` on its own
row slabs and user slots (parallel/svdpp_mesh.py's layout):

* the unified table rides the SVD++ mesh step (masked local gathers, the
  aggregates and the forward psum'd, the all-gathered row updates, the
  replicated feedback writeback);
* ``W_bi [item, bi_feedback]`` is row-sharded over ``model``: the JAX
  layout of ``pad_bi_rows`` rows (the items, padded so each position owns
  an equal slab, the dummy row last in the last slab), position ``m``
  holding rows ``[m * nb_local, (m + 1) * nb_local)``;
* the plugin bias (get_bias_plugin, apex_svd_bilinear.h:141-168) is a
  masked local gather of this rank's W_bi rows, a ``model`` partial;
* the W_bi step takes the batch's global item ids, the coefficients
  ``lr_bi * err * i_val`` and ``i_val`` all-gathered over ``data`` (each
  entry's user is its position in data-rank order over ``M * S``); pad and
  absent items go to the global dummy row with zero values, the rows a
  rank does not own are masked through the values (never a scratch row:
  the local redirect is a real row), and every data replica of a model
  position applies the same update and decay to its slab (reg_bi 0-5 as
  ops/svdpp_bilinear._bi_step), so the replicas stay equal with no
  collective for it;
* the per-user property matrix ``up [C, G+1, nbf]`` is replicated.

A training step makes the collectives of svdpp_mesh and no more: the plug
rides the ``model`` call of the aggregates (with the forward's partials
where no lazy catch-up comes between; W_bi has no lazy decay, so the plug
rides it in every reg mode), and the W_bi entries ride the ``data``
all-gather of the row updates (parallel/mesh._apply_row_updates): four
collectives, five in the small lazy modes.  A prediction batch makes two.
No kernel takes these steps (the JAX body is jnp inside ``shard_map``).
The segment sums are ``index_add_`` where the JAX module adds one-hot
matmuls on small slabs (``_seg_add``); the two sum in another order, as
tests/test_torch_mesh_bi.py allows (rtol 2e-5 + atol 1e-6 a step).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import losses
from ..ops.big_embed import gather_rows
from ..ops.embed import HyperParams, TrainConsts, TrainState, _soft_threshold
from ..ops.svdpp import PlusHyper, _fb_writeback, _pool
from ..ops.svdpp_bilinear import BiHyper
from .comm import Mesh, all_gather, psum
from .mesh import (_apply_row_updates, _decay_clamp_scrub, _lazy_catchup_sharded,
                   _sharded_forward, activated_score, forward_partials, global_apply,
                   global_catchup, global_decay, global_sums, own_rows)
from .svdpp_mesh import (_rounds, local_pool, model_then_data, pool_partials,
                         reduce_pool_predict, user_deltas, user_partials, user_slots, users_of)

F32 = torch.float32


# copied from svdfeature_tpu/parallel/bilinear_mesh.py:43-46 (integers only)
def pad_bi_rows(num_item: int, n_model: int) -> int:
    """W_bi padded row count: dummy row appended, rounded up so each
    model shard gets an equal slab."""
    return -(-(num_item + 1) // n_model) * n_model


def shard_bi(W_bi_pad: torch.Tensor, mesh: Mesh):
    """The single-device ``W_bi_pad [num_item + 1, nbf]`` (dummy row last)
    -> this rank's slab of the JAX layout ``[pad_bi_rows / n_model, nbf]``
    (the padding and the dummy row zero), and the padded row count."""
    num_item = W_bi_pad.shape[0] - 1
    n_bi_pad = pad_bi_rows(num_item, mesh.n_model)
    nb_local = n_bi_pad // mesh.n_model
    return own_rows(W_bi_pad[:num_item], mesh.m * nb_local, nb_local, mesh.device), n_bi_pad


def unshard_bi(Wb: torch.Tensor, mesh: Mesh, num_item: int) -> torch.Tensor:
    """The single-device ``W_bi_pad`` (a zero dummy row appended) from the
    slabs of this rank's ``model`` group: an all-gather over ``model``
    (every rank of the group calls it)."""
    (full,) = all_gather(mesh, "model", Wb)
    W = full.reshape(-1, Wb.shape[1])[:num_item]
    return torch.cat([W, torch.zeros_like(W[:1])])


def bi_plug_partial(Wb: torch.Tensor, up_g: torch.Tensor, batch, off_item: int, num_item: int,
                    lo_bi: int, n_own: int, redirect: int) -> torch.Tensor:
    """This model position's plugin bias ``[B]``: sum_s i_val[g,s] *
    <W_bi[item], up[g]> over the items ``[0, num_item)`` of its slab's
    ``n_own`` rows from ``lo_bi`` (bilinear_mesh.py:168-178,
    bilinear_mesh_big.py:131-143); the others read row ``redirect``,
    zeroed."""
    lid = batch["i_idx"] - off_item
    bloc = lid - lo_bi
    bown = (bloc >= 0) & (bloc < n_own) & (lid >= 0) & (lid < num_item)
    rows = torch.where(bown[..., None], gather_rows(Wb, torch.where(bown, bloc, redirect)), 0.0)
    per = torch.einsum("gsn,gn->gs", rows, up_g)
    return (per * batch["i_val"]).sum(dim=1)


def bi_entries(batch, err, lr_bi, off_item: int):
    """This rank's W_bi entries ``[B, S]`` each, to all-gather over
    ``data``: the global item ids, ``lr_bi * err * i_val`` and ``i_val``."""
    i_val = batch["i_val"]
    return [batch["i_idx"] - off_item, (lr_bi * err)[:, None] * i_val, i_val]


def entry_users(gathered, M: int) -> torch.Tensor:
    """The user of each gathered entry ``[D, B, S]`` flattened: ``M * S``
    consecutive entries a user, in data-rank order."""
    _, _, S = gathered.shape
    return torch.arange(gathered.numel(), device=gathered.device) // (M * S)


def _bi_plug_and_update(Wb, up_c, lid_all, coef_all, vals_all, g_of_entry, lo_bi: int,
                        nb_local: int, lr_bi, wd_bi, reg_bi: int) -> None:
    """The W_bi slab's update from the all-gathered entries, in place
    (bilinear_mesh.py:48-89): the coefficients times the entries' users'
    properties added to the owned rows, then the decay, per touched pair
    (reg_bi 0/1/4/5) or per item row occurrence (2/3), over the slab (an
    untouched row decays by exactly nothing).  Non-owned entries carry
    zero values and redirect to the slab's last row."""
    dummy = nb_local - 1
    loc = lid_all - lo_bi
    own = (loc >= 0) & (loc < nb_local)
    locc = torch.where(own, loc, dummy).long()
    up_e = up_c[g_of_entry]  # [E, nbf]
    Wb.index_add_(0, locc, torch.where(own, coef_all, 0.0)[:, None] * up_e)
    touched = (vals_all.abs() > 0) & own
    lam = lr_bi * wd_bi
    if reg_bi in (0, 1, 4, 5):
        pair = (touched[:, None] & (up_e.abs() > 0)).to(F32)
        touch = torch.zeros_like(Wb).index_add_(0, locc, pair)
        if reg_bi == 0:
            Wb.mul_(torch.pow(1.0 - lam, touch))
        else:
            Wb.copy_(_soft_threshold(Wb, lam * touch))
    elif reg_bi in (2, 3):
        cnt = torch.zeros(nb_local, dtype=F32, device=Wb.device).index_add_(0, locc,
                                                                            touched.to(F32))
        if reg_bi == 2:
            Wb.mul_(torch.pow(1.0 - lam, cnt)[:, None])
        else:
            Wb.copy_(_soft_threshold(Wb, (lam * cnt)[:, None]))
    else:
        raise ValueError(f"unknown bi feedback decay method {reg_bi}")


@torch.no_grad()
def sharded_bilinear_step(state: TrainState, Wb: torch.Tensor, batch: Dict[str, torch.Tensor],
                          cfb: Dict[str, torch.Tensor], up_c: torch.Tensor, lr, fb_hyper,
                          bi_hyper, consts: TrainConsts, hp: HyperParams, mesh: Mesh, n_pad: int,
                          n_bi_pad: int, G: int, off_item: int, reg_bi: int,
                          M: int = 1) -> TrainState:
    """One bilinear step on this rank's slabs and user slots, the per-shard
    body of JAX ``_make_bilinear_body`` (bilinear_mesh.py:103-297):
    svdpp_mesh.sharded_svdpp_step with the plugin bias in the score and
    the W_bi step; ``bi_hyper`` = (lr_bi, wd_bi), ``up_c`` the chunk's
    ``[G+1, nbf]`` properties.  ``state.w`` / ``state.b`` and ``Wb`` change
    in place."""
    lr_fb, d, db = fb_hyper
    lr_bi, wd_bi = bi_hyper
    n_local = n_pad // mesh.n_model
    lo, dummy = mesh.m * n_local, n_local - 1
    nb_local = n_bi_pad // mesh.n_model
    lo_bi = mesh.m * nb_local
    with_bias = not hp.no_user_bias
    w, b, step0 = state.w, state.b, state.step
    nseg = G + 1
    slot = user_slots(G, M, mesh, w.device)

    agg = pool_partials(lambda i: (w[i], b[i]), cfb, "fb_block", nseg, lo, n_local, dummy, mesh)
    # the rows from the last item to the dummy stay 0, so the dummy's global
    # row bounds the items as well as num_item would
    plug = bi_plug_partial(Wb, up_c[slot], batch, off_item, n_bi_pad - 1, lo_bi, nb_local,
                           nb_local - 1)
    fwd, (cu, ci, cg, present, fb_sum, fb_bias, norm), (plug,) = model_then_data(
        agg, w, b, batch, hp, mesh, state.g.shape[0], lo, n_local, dummy, extra=(plug,))
    # the lazy catch-up after the block aggregates (the reference order)
    w, ref_ui = _lazy_catchup_sharded(w, state.ref_ui, cu, ci, step0, lr, consts, hp)
    g, ref_g = global_catchup(state.g, state.ref_g, cg, step0, lr, consts, hp)
    p_u, p_i, bias = fwd or _sharded_forward(w, b, batch, hp, mesh, lo, n_local, dummy)
    p_u = p_u + fb_sum[slot]
    if with_bias:
        bias = bias + fb_bias[slot]
    pred = activated_score(p_u, p_i, bias, g, batch, hp, plug)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]

    # the W_bi entries ride the row updates' gather over data
    lid_all, coef_all, vals_all = _apply_row_updates(
        w, b, batch, lr * err, p_u, p_i, hp, mesh, lo, n_local, dummy,
        extra=bi_entries(batch, err, lr_bi, off_item))
    users = entry_users(lid_all, M)
    lid_all, coef_all, vals_all = (x.reshape(-1) for x in (lid_all, coef_all, vals_all))
    # pad and absent items: the global dummy row, with zero values
    valid = (lid_all >= 0) & (lid_all < n_bi_pad - 1)
    _bi_plug_and_update(Wb, up_c, torch.where(valid, lid_all, n_bi_pad - 1),
                        torch.where(valid, coef_all, 0.0), torch.where(valid, vals_all, 0.0),
                        users, lo_bi, nb_local, lr_bi, wd_bi, reg_bi)

    *gs, red = psum(mesh, "data", *global_sums(g, batch, err),
                    user_partials(err, p_i, batch["weight"], slot, nseg))
    g = global_apply(g, gs, lr)
    delta, delta_b = user_deltas(red, fb_sum, fb_bias, norm, lr_fb, d, db, M, with_bias)
    _fb_writeback(w, b, local_pool(cfb, "fb_block", lo, n_local, dummy), delta, delta_b)

    g = global_decay(g, cg, lr, consts, hp)
    w, b = _decay_clamp_scrub(w, b, cu, ci, lr, consts, hp, lo, n_local, n_pad)
    return TrainState(w=w, b=b, g=g, step=step0 + present, ref_ui=ref_ui, ref_g=ref_g)


@torch.no_grad()
def sharded_bilinear_rounds(state: TrainState, Wb: torch.Tensor, stacked: Dict[str, torch.Tensor],
                            chunk_id: np.ndarray, fb: Dict[str, torch.Tensor], up: torch.Tensor,
                            lrs, consts: TrainConsts, hp: HyperParams, ph: PlusHyper,
                            bh: BiHyper, mesh: Mesh, n_pad: int, n_bi_pad: int) -> TrainState:
    """R rounds of bilinear steps on this rank's slabs (JAX
    ``sharded_bilinear_rounds``, bilinear_mesh.py:321-384): ``stacked``
    holds this rank's ``[T, G*M / n_data]`` columns, ``fb`` the replicated
    ``[C, F]`` pools, ``up`` the replicated ``[C, G+1, nbf]`` properties;
    ``Wb`` (this rank's W_bi slab) changes in place."""
    M = ph.rows_per_user
    G = users_of(stacked, mesh, M)

    def step(st, batch, cfb, up_c, lr, fbh):
        return sharded_bilinear_step(st, Wb, batch, cfb, up_c, lr, fbh,
                                     (lr * bh.slr_bi, bh.wd_bi), consts, hp, mesh, n_pad,
                                     n_bi_pad, G, bh.off_item, bh.reg_bi, M)

    return _rounds(step, state, stacked, chunk_id, fb, lrs, ph, extra=up)


@torch.no_grad()
def sharded_bilinear_predict(state: TrainState, Wb: torch.Tensor,
                             stacked: Dict[str, torch.Tensor], chunk_id: np.ndarray,
                             fb: Dict[str, torch.Tensor], up: torch.Tensor, hp: HyperParams,
                             mesh: Mesh, n_pad: int, n_bi_pad: int, off_item: int,
                             M: int = 1) -> torch.Tensor:
    """Predictions ``[T, G*M / n_data]`` of this rank's columns on the
    row-sharded tables (JAX ``sharded_bilinear_predict``, bilinear_mesh.py:
    387-437): the plug rides the model call of the forward's and the
    aggregates' partials, two collectives a batch."""
    n_local = n_pad // mesh.n_model
    lo, dummy = mesh.m * n_local, n_local - 1
    nb_local = n_bi_pad // mesh.n_model
    w, b = state.w, state.b
    G = users_of(stacked, mesh, M)
    slot = user_slots(G, M, mesh, w.device)
    out = []
    for t, c in enumerate(np.asarray(chunk_id).tolist()):
        batch = {name: x[t] for name, x in stacked.items()}
        fb_sum, fb_bias, p_u, p_i, bias, plug = reduce_pool_predict(
            pool_partials(lambda i: (w[i], b[i]), _pool(fb, c), "fb_block", G + 1, lo, n_local,
                          dummy, mesh, with_norm=False), mesh,
            [*forward_partials(w, b, batch, hp, lo, n_local, dummy),
             bi_plug_partial(Wb, up[c][slot], batch, off_item, n_bi_pad - 1, mesh.m * nb_local,
                             nb_local, nb_local - 1)])
        if not hp.no_user_bias:
            bias = bias + fb_bias[slot]
        out.append(activated_score(p_u + fb_sum[slot], p_i, bias, state.g, batch, hp, plug))
    return torch.stack(out)
