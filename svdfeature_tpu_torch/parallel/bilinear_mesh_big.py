"""Bilinear (extend_type=15) on a ``(data, model)`` mesh of big (augmented)
slabs, every write through K5.

PyTorch counterpart of svdfeature_tpu/parallel/bilinear_mesh_big.py: the
big-slab SVD++ step of parallel/svdpp_mesh_big.py with the bilinear
plugin:

* the unified table is svdpp_mesh_big's (aggregates gathered from the
  local augmented slab, the forward's rows caught up at gather time, the
  all-gathered entry stream merged by ``apply_entries``, the pool
  writeback merged by ``_fb_writeback_big``);
* the plugin bias is a masked local gather of this rank's W_bi rows, a
  ``model`` partial (get_bias_plugin, apex_svd_bilinear.h:141-168);
* the W_bi step takes the batch's (item, coefficient, value) entries
  all-gathered over ``data``, localized to this rank's W_bi slab (the
  entries it does not own go to the slab's scratch row with zero
  coefficient and value), merged by sorted dedup with the touch counts in
  the payload, the touched rows gathered, updated and decayed, and written
  once (``ops/big_embed.sorted_dedup`` / ``gather_rows`` /
  ``write_rows_unique``): the mesh form of ops/svdpp_bilinear._bi_step_big.

W_bi's slab layout is mesh_big's (bilinear_mesh_big.py:52-128): model
position ``s`` owns the logical item rows ``[s * nb_real, (s + 1) *
nb_real)``, held at rows ``[0, nb_real)`` of its ``[nb_real + 1, nbf]``
slab, the scratch row last (the dedup write REPLACES rows, so the redirect
target takes any overwrite; it only ever receives zeros).  Gathered whole,
the slabs are the JAX package's scratch-interleaved layout.

Each of the three writes of a step is one unique-row write: K5
(``ops/cuda_scatter.row_writer``) on a CUDA slab with ``hp.row_dma``
(``use_pallas``), so a step launches K5 three times on every rank (the
table's merge, the pool writeback, the W_bi slab; two with an empty
property space, whose W_bi step writes nothing).  A step makes the four
collectives of svdpp_mesh_big: the plug rides the model call of the
aggregates and the forward's partials, the W_bi entries ride the data
all-gather of the entry stream (mesh_big.merge_gathered).  A prediction
batch makes two.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import losses
from ..ops.big_embed import gather_rows, sorted_dedup, write_rows_unique
from ..ops.embed import HyperParams, TrainConsts, TrainState, _soft_threshold
from ..ops.svdpp import PlusHyper, _pool
from ..ops.svdpp_big import _fb_writeback_big
from ..ops.svdpp_bilinear import BiHyper
from .bilinear_mesh import bi_entries, bi_plug_partial, entry_users
from .comm import Mesh, all_gather, psum
from .mesh import activated_score, global_apply, global_catchup, global_decay, global_sums, own_rows
from .mesh_big import fwd_big_partials, merge_gathered, predict_partials_big
from .svdpp_mesh import (_rounds, local_pool, pool_partials, reduce_pool_predict,
                         reduce_pool_train, user_deltas, user_partials, user_slots, users_of)
from .svdpp_mesh_big import slab_rows

F32, I32 = torch.float32, torch.int32


# copied from svdfeature_tpu/parallel/bilinear_mesh_big.py:52-56 (integers only)
def bi_big_layout(num_item: int, n_model: int) -> Tuple[int, int]:
    """(nb_real, nb_phys): logical item rows owned per shard, physical
    slab rows (+1 scratch row per shard)."""
    nb_real = -(-num_item // n_model) if num_item else 1
    return nb_real, nb_real + 1


def shard_bi_big(W_bi_pad: torch.Tensor, mesh: Mesh):
    """The single-device ``W_bi_pad [num_item + 1, nbf]`` (dummy row last)
    -> this rank's slab ``[nb_real + 1, nbf]`` of the scratch-interleaved
    layout (bilinear_mesh_big.py:59-76; the scratch row zero), and
    ``nb_real``."""
    num_item = W_bi_pad.shape[0] - 1
    nb_real, nb_phys = bi_big_layout(num_item, mesh.n_model)
    slab = torch.zeros((nb_phys, W_bi_pad.shape[1]), dtype=F32, device=mesh.device)
    slab[:nb_real] = own_rows(W_bi_pad[:num_item], mesh.m * nb_real, nb_real, mesh.device)
    return slab, nb_real


def unshard_bi_big(Wb: torch.Tensor, mesh: Mesh, nb_real: int, num_item: int) -> torch.Tensor:
    """The single-device ``W_bi_pad`` (a zero dummy row appended) from the
    slabs of this rank's ``model`` group, scratch rows stripped
    (bilinear_mesh_big.py:79-84): an all-gather over ``model`` (every rank
    of the group calls it)."""
    (full,) = all_gather(mesh, "model", Wb)
    W = full[:, :nb_real].reshape(-1, Wb.shape[1])[:num_item]
    return torch.cat([W, torch.zeros_like(W[:1])])


def _bi_update_big(Wb, up_c, lid_all, coef_all, vals_all, g_of_entry, lo_bi: int, nb_real: int,
                   lr_bi, wd_bi, reg_bi: int, row_dma: bool) -> None:
    """W_bi's slab update from the all-gathered entries, written in place
    through one unique-row write (K5 with ``row_dma`` on a CUDA slab;
    bilinear_mesh_big.py:87-128).  Non-owned entries go to the scratch
    row with zero coefficient and value: touch count 0, so they decay
    nothing and only zeros land on the scratch row."""
    scratch, nbf = nb_real, Wb.shape[1]
    if nbf == 0:  # an empty property space: nothing to write
        return
    loc = lid_all - lo_bi
    own = (loc >= 0) & (loc < nb_real)
    locc = torch.where(own, loc, scratch)
    coef = torch.where(own, coef_all, 0.0)
    vals = torch.where(own, vals_all, 0.0)
    up_e = up_c[g_of_entry]  # [E, nbf]
    upd = coef[:, None] * up_e
    lam = lr_bi * wd_bi
    if reg_bi in (0, 1, 4, 5):
        pair = (vals.abs() > 0)[:, None] & (up_e.abs() > 0)
        pay = torch.cat([upd, pair.to(F32)], dim=1)
    elif reg_bi in (2, 3):
        pay = torch.cat([upd, (vals.abs() > 0).to(F32)[:, None]], dim=1)
    else:
        raise ValueError(f"unknown bi feedback decay method {reg_bi}")
    _, si, acc, _, last = sorted_dedup(locc, pay)
    new = gather_rows(Wb, si) + acc[:, :nbf]
    if reg_bi == 0:
        new = new * torch.pow(1.0 - lam, acc[:, nbf:])
    elif reg_bi in (1, 4, 5):
        new = _soft_threshold(new, lam * acc[:, nbf:])
    elif reg_bi == 2:
        new = new * torch.pow(1.0 - lam, acc[:, nbf])[:, None]
    else:
        new = _soft_threshold(new, (lam * acc[:, nbf])[:, None])
    is_real = last & (si != scratch)
    write_rows_unique(Wb, torch.where(is_real, si, scratch).to(I32),
                      torch.where(is_real[:, None], new, 0.0), row_dma=row_dma)


@torch.no_grad()
def sharded_bilinear_step_big(state: TrainState, Wb: torch.Tensor,
                              batch: Dict[str, torch.Tensor], cfb: Dict[str, torch.Tensor],
                              up_c: torch.Tensor, lr, fb_hyper, bi_hyper, consts: TrainConsts,
                              hp: HyperParams, mesh: Mesh, n_real: int, nb_real: int, G: int,
                              off_item: int, num_item: int, reg_bi: int,
                              M: int = 1) -> TrainState:
    """One bilinear step on this rank's augmented slab and W_bi slab, both
    written in place (through K5 three times with ``hp.row_dma`` on CUDA
    slabs): the per-shard body of JAX ``_make_bilinear_body_big``
    (bilinear_mesh_big.py:146-410), svdpp_mesh_big.sharded_svdpp_step_big
    with the plug and the W_bi step; ``bi_hyper`` = (lr_bi, wd_bi)."""
    k = hp.num_factor
    if k <= 0:
        raise ValueError("the mesh big path requires hp.num_factor")
    lr_fb, d, db = fb_hyper
    lr_bi, wd_bi = bi_hyper
    w, step0 = state.w, state.step
    lo, scratch = mesh.m * n_real, n_real
    lo_bi = mesh.m * nb_real
    with_bias = not hp.no_user_bias
    nseg = G + 1
    slot = user_slots(G, M, mesh, w.device)

    agg = pool_partials(slab_rows(w, k), cfb, "fb_block", nseg, lo, n_real, scratch, mesh)
    parts, u_ent, i_ent = fwd_big_partials(w, batch, hp, lr, consts, step0, lo, n_real)
    plug = bi_plug_partial(Wb, up_c[slot], batch, off_item, num_item, lo_bi, nb_real, nb_real)
    cg, present, fb_sum, fb_bias, norm, p_u, p_i, bias, plug = reduce_pool_train(
        agg, batch, mesh, state.g.shape[0], with_model=[*parts, plug])
    g, ref_g = global_catchup(state.g, state.ref_g, cg, step0, lr, consts, hp)
    p_u = p_u + fb_sum[slot]
    if with_bias:
        bias = bias + fb_bias[slot]
    pred = activated_score(p_u, p_i, bias, g, batch, hp, plug)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]

    *gs, red = psum(mesh, "data", *global_sums(g, batch, err),
                    user_partials(err, p_i, batch["weight"], slot, nseg))
    g = global_decay(global_apply(g, gs, lr), cg, lr, consts, hp)
    # the W_bi entries ride the entry stream's gather over data
    w, (lid_all, coef_all, vals_all) = merge_gathered(
        w, step0, u_ent, i_ent, lr * err, p_u, p_i, lr, consts, hp, mesh, n_real,
        extra=bi_entries(batch, err, lr_bi, off_item))
    users = entry_users(lid_all, M)
    lid_all, coef_all, vals_all = (x.reshape(-1) for x in (lid_all, coef_all, vals_all))
    valid = (lid_all >= 0) & (lid_all < num_item)  # the rest: owned by no position
    _bi_update_big(Wb, up_c, torch.where(valid, lid_all, -1), torch.where(valid, coef_all, 0.0),
                   torch.where(valid, vals_all, 0.0), users, lo_bi, nb_real, lr_bi, wd_bi, reg_bi,
                   hp.row_dma)
    delta, delta_b = user_deltas(red, fb_sum, fb_bias, norm, lr_fb, d, db, M, with_bias)
    w = _fb_writeback_big(w, local_pool(cfb, "fb_block", lo, n_real, scratch), delta, delta_b, k,
                          hp.row_dma)
    return TrainState(w=w, b=state.b, g=g, step=step0 + present, ref_ui=state.ref_ui,
                      ref_g=ref_g)


@torch.no_grad()
def sharded_bilinear_rounds_big(state: TrainState, Wb: torch.Tensor,
                                stacked: Dict[str, torch.Tensor], chunk_id: np.ndarray,
                                fb: Dict[str, torch.Tensor], up: torch.Tensor, lrs,
                                consts: TrainConsts, hp: HyperParams, ph: PlusHyper, bh: BiHyper,
                                mesh: Mesh, n_real: int, nb_real: int,
                                num_item: int) -> TrainState:
    """R rounds of big-slab bilinear steps (JAX
    ``sharded_bilinear_rounds_big``, bilinear_mesh_big.py:413-478), the
    arguments of bilinear_mesh.sharded_bilinear_rounds with the slabs'
    ``n_real`` and ``nb_real``; ``Wb`` changes in place."""
    M = ph.rows_per_user
    G = users_of(stacked, mesh, M)

    def step(st, batch, cfb, up_c, lr, fbh):
        return sharded_bilinear_step_big(st, Wb, batch, cfb, up_c, lr, fbh,
                                         (lr * bh.slr_bi, bh.wd_bi), consts, hp, mesh, n_real,
                                         nb_real, G, bh.off_item, num_item, bh.reg_bi, M)

    return _rounds(step, state, stacked, chunk_id, fb, lrs, ph, extra=up)


@torch.no_grad()
def sharded_bilinear_predict_big(state: TrainState, Wb: torch.Tensor,
                                 stacked: Dict[str, torch.Tensor], chunk_id: np.ndarray,
                                 fb: Dict[str, torch.Tensor], up: torch.Tensor, hp: HyperParams,
                                 mesh: Mesh, n_real: int, nb_real: int, off_item: int,
                                 num_item: int, M: int = 1) -> torch.Tensor:
    """Predictions ``[T, G*M / n_data]`` of this rank's columns on the
    augmented and W_bi slabs (JAX ``sharded_bilinear_predict_big``,
    bilinear_mesh_big.py:481-495): two collectives a batch; pending lazy
    decay is not applied, as in svdpp_mesh_big."""
    k = hp.num_factor
    lo, lo_bi = mesh.m * n_real, mesh.m * nb_real
    G = users_of(stacked, mesh, M)
    slot = user_slots(G, M, mesh, state.w.device)
    out = []
    for t, c in enumerate(np.asarray(chunk_id).tolist()):
        batch = {name: x[t] for name, x in stacked.items()}
        fb_sum, fb_bias, p_u, p_i, bias, plug = reduce_pool_predict(
            pool_partials(slab_rows(state.w, k), _pool(fb, c), "fb_block", G + 1, lo, n_real,
                          n_real, mesh, with_norm=False), mesh,
            [*predict_partials_big(state, batch, hp, mesh, n_real),
             bi_plug_partial(Wb, up[c][slot], batch, off_item, num_item, lo_bi, nb_real,
                             nb_real)])
        if not hp.no_user_bias:
            bias = bias + fb_bias[slot]
        out.append(activated_score(p_u + fb_sum[slot], p_i, bias, state.g, batch, hp, plug))
    return torch.stack(out)
