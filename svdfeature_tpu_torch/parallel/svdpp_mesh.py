"""SVD++ on a ``(data, model)`` mesh: user slots sharded over ``data``, the
table's rows over ``model``, the feedback pool replicated.

PyTorch counterpart of svdfeature_tpu/parallel/svdpp_mesh.py.  Every rank
runs the per-shard body of the JAX module's ``shard_map`` on its own row
slab (parallel/mesh.py's layout) and its own batch columns:

* the ``[T, G*M]`` planes are sharded over ``data`` contiguously: data
  position ``d`` takes users ``[d * G / n_data, (d + 1) * G / n_data)``,
  M consecutive slots a user, so a user never straddles a data shard
  (``pad_plus_for_mesh`` pads G to a multiple of ``n_data``);
* the chunk's pool ``[F]`` is replicated; each data rank reduces its
  ``F / n_data`` slice over its own model slab (masked local gather: the
  rows it does not own read its last local row with value 0), and the
  per-user sums ``fb_sum`` / ``fb_bias`` are psum'd over ``model`` and then
  ``data``; ``norm`` (sum of the RAW values squared) only over ``data``,
  since every model rank holds the same value (svdpp_mesh.py:89-91);
* the lazy catch-up runs AFTER the block aggregates, the reference order
  (apex_svd_base.h:568-582); the forward, the all-gathered row updates,
  the global update and the decays are parallel/mesh.py's;
* the per-user reduction ``[err * p_i | present | err | p_i . p_i]`` is
  psum'd over ``data`` (a user's M rows live on one rank, so the psum
  only merges ranks), with the implicitly damped Jacobi form for M > 1;
* every data replica writes the replicated delta back over the FULL pool,
  masked to the rows its model position owns (``ops/svdpp._fb_writeback``),
  so the replicas stay equal bit for bit.

A training step makes four collectives: over ``model`` the aggregates'
partial sums with the forward's (in the lazy modes the forward's follow
the catch-up, in a fifth call); over ``data`` in one call the touch
counts, the global slots' counts, the example count and the aggregates;
the row update's ids and floats, all-gathered over ``data`` in one call;
and over ``data`` in one call the global bias's statistics with the
per-user reduction.  A prediction batch makes two.  A group of one rank
makes none.  No kernel takes these steps (the JAX
body is jnp inside ``shard_map``, and K2 refuses a mesh in both
packages).  Parity with the JAX mesh and the single-device step is held
by tests/test_torch_mesh_plus.py: psum and ``index_add_`` add in another
order than XLA, within rtol 2e-5 + atol 1e-6 a step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .. import losses
from ..ops.embed import HyperParams, TrainConsts, TrainState
from ..ops.svdpp import PlusHyper, _fb_hyper, _fb_writeback, _inv_norm, _pool
from .comm import Mesh, psum
from .mesh import (_apply_row_updates, _decay_clamp_scrub, _lazy_catchup_sharded,
                   _sharded_forward, activated_score, batch_counts, forward_partials,
                   global_apply, global_catchup, global_decay, global_sums)

F32, I32 = torch.float32, torch.int32


def seg_sum(nseg: int, idx: torch.Tensor, pay: torch.Tensor) -> torch.Tensor:
    """``pay [E, C]`` summed into ``nseg`` bins by ``idx [E]`` -> ``[nseg, C]``
    (JAX ``_seg_sum_stacked``'s segment_sum)."""
    out = torch.zeros((nseg, pay.shape[1]), dtype=pay.dtype, device=pay.device)
    return out.index_add_(0, idx.reshape(-1).long(), pay)


def data_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This data rank's ``1 / n_data`` of a replicated pool plane ``[F]``."""
    f = x.shape[0] // mesh.n_data
    return x[mesh.d * f:(mesh.d + 1) * f]


def owned_pool(idx: torch.Tensor, val: torch.Tensor, lo: int, n_own: int, redirect: int):
    """Local ids of pool entries (non-owned ones sent to ``redirect``) and
    their values with the non-owned ones zeroed."""
    loc = idx - lo
    own = (loc >= 0) & (loc < n_own)
    return torch.where(own, loc, redirect), torch.where(own, val, 0.0)


def pool_partials(rows_of: Callable, cfb: Dict[str, torch.Tensor], seg_key: str, nseg: int,
                  lo: int, n_own: int, redirect: int, mesh: Mesh,
                  with_norm: bool = True) -> torch.Tensor:
    """This rank's partial aggregates ``[nseg, k+2]`` = ``[sum w*v | sum b*v
    | sum sv^2]`` of its data slice of the pool, per segment ``seg_key``
    (users, or the stacked contexts), read from its slab by ``rows_of``
    (local ids -> (factor rows, biases)); ``norm`` sums the RAW values, the
    others the owned ones.  Without ``with_norm``, ``[nseg, k+1]``."""
    sl, sv, sb = (data_slice(cfb[key], mesh) for key in ("fb_idx", "fb_val", seg_key))
    locc, v = owned_pool(sl, sv, lo, n_own, redirect)
    wr, br = rows_of(locc)
    cols = [wr * v[:, None], (br * v)[:, None]]
    if with_norm:
        cols.append((sv * sv)[:, None])
    return seg_sum(nseg, sb, torch.cat(cols, dim=1))


def reduce_pool_train(agg: torch.Tensor, batch, mesh: Mesh, n_g: int, lo: int = 0,
                      n_local: int = 0, with_model=()):
    """The aggregates summed: ``[fb_sum | fb_bias]`` over ``model`` and then
    ``data``, ``norm`` over ``data`` only, riding the batch counts' call
    (mesh.batch_counts); ``with_model``: partial sums that ride the model
    call (the forward's) -> (*counts, present, fb_sum, fb_bias, norm,
    *with_model summed)."""
    k = agg.shape[1] - 2
    fb, *more = psum(mesh, "model", agg[:, :k + 1].contiguous(), *with_model)
    *counts, both = batch_counts(batch, mesh, n_g, lo, n_local,
                                 extra=(torch.cat([fb, agg[:, k + 1:]], dim=1),))
    return (*counts, both[:, :k], both[:, k], both[:, k + 1], *more)


def reduce_pool_predict(agg: torch.Tensor, mesh: Mesh, with_model=()):
    """(fb_sum, fb_bias, *with_model summed) of ``[sum w*v | sum b*v]``
    partials psum'd over ``model`` and then ``data``, and of the partial
    sums ``with_model`` (the forward's) over ``model``."""
    agg, *more = psum(mesh, "model", agg, *with_model)
    (agg,) = psum(mesh, "data", agg)
    return (agg[:, :-1], agg[:, -1], *more)


def user_slots(G: int, M: int, mesh: Mesh, device) -> torch.Tensor:
    """The user of each of this data rank's ``G * M / n_data`` slots."""
    g_local = G // mesh.n_data
    return mesh.d * g_local + torch.arange(g_local * M, dtype=torch.int64, device=device) // M


def user_partials(err, p_i, weight, slot, nseg: int) -> torch.Tensor:
    """This rank's ``[nseg, k+3]`` per-user reduction ``[err*p_i | present |
    err | p_i.p_i]``."""
    cols = [err[:, None] * p_i, weight[:, None], err[:, None], (p_i * p_i).sum(1, keepdim=True)]
    return seg_sum(nseg, slot, torch.cat(cols, dim=1))


def user_deltas(red, fb_sum, fb_bias, norm, lr_fb, d, db, M: int, with_bias: bool):
    """The users' replicated feedback deltas ``[G+1, k]`` (and ``[G+1]``)
    from the psum'd reduction (svdpp_mesh.py:137-172), damped for M > 1."""
    k = fb_sum.shape[1]
    errpi, m_g, err_g = red[:, :k], red[:, k], red[:, k + 1]
    if M > 1:
        pip2 = red[:, k + 2]
        frac = torch.where(m_g > 0, (m_g - 1.0) / torch.clamp(m_g, min=1.0), 0.0)
        errpi = errpi / (1.0 + lr_fb * norm * pip2 * frac)[:, None]
        err_g = err_g / (1.0 + lr_fb * norm * (m_g - 1.0) * (m_g > 0))
    inv = _inv_norm(norm)
    delta = (fb_sum * (torch.pow(d, m_g) - 1.0)[:, None] + lr_fb * norm[:, None] * errpi) * \
        inv[:, None]
    if not with_bias:
        return delta, None
    return delta, (fb_bias * (torch.pow(db, m_g) - 1.0) + lr_fb * norm * err_g) * inv


def local_pool(cfb: Dict[str, torch.Tensor], seg_key: str, lo: int, n_own: int,
               redirect: int) -> Dict[str, torch.Tensor]:
    """The FULL pool in this model position's local ids, keyed as
    ops/svdpp's writebacks read it (``fb_block``: the segment)."""
    idx, val = owned_pool(cfb["fb_idx"], cfb["fb_val"], lo, n_own, redirect)
    return {"fb_idx": idx, "fb_val": val, "fb_block": cfb[seg_key]}


def model_then_data(agg, w, b, batch, hp: HyperParams, mesh: Mesh, n_g: int, lo: int,
                    n_local: int, dummy: int, extra=()):
    """The small step's first two collectives: the aggregates over
    ``model`` and ``data`` with the batch counts (reduce_pool_train), the
    forward's partials riding the model call where no lazy catch-up comes
    between (reg_method < 4: the catch-up leaves the rows as they are),
    and the ``extra`` model partials (the bilinear plug, which reads no
    row the catch-up moves) in every mode -> ((p_u, p_i, bias), or None in
    the lazy modes; (cu, ci, cg, present, fb_sum, fb_bias, norm); the
    extras summed)."""
    eager = hp.reg_method < 4
    parts = forward_partials(w, b, batch, hp, lo, n_local, dummy) if eager else []
    sums = reduce_pool_train(agg, batch, mesh, n_g, lo, n_local, [*parts, *extra])
    more = sums[7:]
    return (more[:3] if eager else None), sums[:7], more[3 if eager else 0:]


@torch.no_grad()
def sharded_svdpp_step(state: TrainState, batch: Dict[str, torch.Tensor],
                       cfb: Dict[str, torch.Tensor], lr, fb_hyper, consts: TrainConsts,
                       hp: HyperParams, mesh: Mesh, n_pad: int, G: int, M: int = 1) -> TrainState:
    """One SVD++ step on this rank's slab and user slots, the per-shard body
    of JAX ``_make_svdpp_body`` (svdpp_mesh.py:41-187); ``cfb`` is the
    chunk's replicated pool ``[F]``.  ``state.w`` / ``state.b`` change in
    place."""
    lr_fb, d, db = fb_hyper
    n_local = n_pad // mesh.n_model
    lo, dummy = mesh.m * n_local, n_local - 1
    with_bias = not hp.no_user_bias
    w, b, step0 = state.w, state.b, state.step
    nseg = G + 1
    slot = user_slots(G, M, mesh, w.device)

    agg = pool_partials(lambda i: (w[i], b[i]), cfb, "fb_block", nseg, lo, n_local, dummy, mesh)
    fwd, (cu, ci, cg, present, fb_sum, fb_bias, norm), _ = model_then_data(
        agg, w, b, batch, hp, mesh, state.g.shape[0], lo, n_local, dummy)
    # the lazy catch-up after the block aggregates (the reference order)
    w, ref_ui = _lazy_catchup_sharded(w, state.ref_ui, cu, ci, step0, lr, consts, hp)
    g, ref_g = global_catchup(state.g, state.ref_g, cg, step0, lr, consts, hp)
    # in the lazy modes the forward reads the caught-up rows
    p_u, p_i, bias = fwd or _sharded_forward(w, b, batch, hp, mesh, lo, n_local, dummy)
    p_u = p_u + fb_sum[slot]
    if with_bias:
        bias = bias + fb_bias[slot]
    pred = activated_score(p_u, p_i, bias, g, batch, hp)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]

    _apply_row_updates(w, b, batch, lr * err, p_u, p_i, hp, mesh, lo, n_local, dummy)
    *gs, red = psum(mesh, "data", *global_sums(g, batch, err),
                    user_partials(err, p_i, batch["weight"], slot, nseg))
    g = global_apply(g, gs, lr)
    delta, delta_b = user_deltas(red, fb_sum, fb_bias, norm, lr_fb, d, db, M, with_bias)
    _fb_writeback(w, b, local_pool(cfb, "fb_block", lo, n_local, dummy), delta, delta_b)

    g = global_decay(g, cg, lr, consts, hp)
    w, b = _decay_clamp_scrub(w, b, cu, ci, lr, consts, hp, lo, n_local, n_pad)
    return TrainState(w=w, b=b, g=g, step=step0 + present, ref_ui=ref_ui, ref_g=ref_g)


def _rounds(step_fn, state: TrainState, stacked: Dict[str, torch.Tensor], chunk_id: np.ndarray,
            fb: Dict[str, torch.Tensor], lrs, ph: PlusHyper, extra=None) -> TrainState:
    """R rounds over the T steps of this rank's columns, round r at
    ``lrs[r]``, step t on chunk ``chunk_id[t]``'s pool (and ``extra[c]``
    where given: the stacked solver's gates, the bilinear properties)."""
    T = stacked["label"].shape[0]
    cids = np.asarray(chunk_id).tolist()
    batches = [{name: x[t] for name, x in stacked.items()} for t in range(T)]
    for r in range(lrs.shape[0]):
        lr = lrs[r]
        fbh = _fb_hyper(lr, ph)
        for batch, c in zip(batches, cids):
            args = (_pool(fb, c),) if extra is None else (chunk_pool(fb, c), extra[c])
            state = step_fn(state, batch, *args, lr, fbh)
    return state


def chunk_pool(fb: Dict[str, torch.Tensor], c: int) -> Dict[str, torch.Tensor]:
    """Chunk c's pool, whatever its segment plane (``fb_block`` of the
    users, ``fb_ctx`` of the stacked contexts)."""
    return {name: x[c] for name, x in fb.items()}


def users_of(stacked: Dict[str, torch.Tensor], mesh: Mesh, M: int) -> int:
    """G, the users of a step, from this rank's ``G * M / n_data`` columns."""
    return stacked["label"].shape[1] * mesh.n_data // M


@torch.no_grad()
def sharded_svdpp_rounds(state: TrainState, stacked: Dict[str, torch.Tensor],
                         chunk_id: np.ndarray, fb: Dict[str, torch.Tensor], lrs,
                         consts: TrainConsts, hp: HyperParams, ph: PlusHyper, mesh: Mesh,
                         n_pad: int) -> TrainState:
    """R rounds of SVD++ steps on this rank's slab (JAX
    ``sharded_svdpp_rounds``, svdpp_mesh.py:227-285): ``stacked`` holds
    this rank's ``[T, G*M / n_data]`` columns, ``fb`` the replicated
    ``[C, F]`` pools, ``chunk_id`` (host) each step's chunk."""
    M = ph.rows_per_user
    G = users_of(stacked, mesh, M)

    def step(st, batch, cfb, lr, fbh):
        return sharded_svdpp_step(st, batch, cfb, lr, fbh, consts, hp, mesh, n_pad, G, M)

    return _rounds(step, state, stacked, chunk_id, fb, lrs, ph)


@torch.no_grad()
def sharded_svdpp_predict(state: TrainState, stacked: Dict[str, torch.Tensor],
                          chunk_id: np.ndarray, fb: Dict[str, torch.Tensor], hp: HyperParams,
                          mesh: Mesh, n_pad: int, M: int = 1) -> torch.Tensor:
    """Predictions ``[T, G*M / n_data]`` of this rank's columns on the
    row-sharded tables (JAX ``sharded_svdpp_predict``, svdpp_mesh.py:
    335-409): the forward half of the step, the aggregates gathered every
    step as JAX does."""
    n_local = n_pad // mesh.n_model
    lo, dummy = mesh.m * n_local, n_local - 1
    w, b = state.w, state.b
    G = users_of(stacked, mesh, M)
    slot = user_slots(G, M, mesh, w.device)
    out = []
    for t, c in enumerate(np.asarray(chunk_id).tolist()):
        batch = {name: x[t] for name, x in stacked.items()}
        fb_sum, fb_bias, p_u, p_i, bias = reduce_pool_predict(
            pool_partials(lambda i: (w[i], b[i]), _pool(fb, c), "fb_block", G + 1, lo, n_local,
                          dummy, mesh, with_norm=False), mesh,
            forward_partials(w, b, batch, hp, lo, n_local, dummy))
        p_u = p_u + fb_sum[slot]
        if not hp.no_user_bias:
            bias = bias + fb_bias[slot]
        out.append(activated_score(p_u, p_i, bias, state.g, batch, hp))
    return torch.stack(out)


# copied from svdfeature_tpu/parallel/svdpp_mesh.py:288-332 (numpy only)
def pad_plus_for_mesh(
    arrays, fb, G: int, n_data: int, dummy_row: int, num_global: int,
    M: int = 1,
):
    """Pad packed plus batches so G (users) and F divide the data axis.

    ``arrays``: dict of [T, G*M, ...] host arrays (M consecutive slots
    per user); ``fb``: dict of [C, F] pools.  Padded user slots are
    absent rows (weight 0, per-segment dummy ids, value 0); pool padding
    entries carry value 0 and block slot G' (the always-empty segment).
    Returns (arrays, fb, G', F').
    """
    T = arrays["label"].shape[0]
    Gp = -(-G // n_data) * n_data
    if Gp != G:
        out = {}
        for k, v in arrays.items():
            fill = 0
            if k == "g_idx":
                fill = num_global
            elif k.endswith("_idx"):
                fill = dummy_row
            pad = np.full((T, (Gp - G) * M) + v.shape[2:], fill, v.dtype)
            out[k] = np.concatenate([v, pad], axis=1)
        arrays = out
    F = fb["fb_idx"].shape[1]
    Fp = -(-F // n_data) * n_data
    if Fp != F:
        C = fb["fb_idx"].shape[0]
        fb = {
            "fb_idx": np.concatenate(
                [fb["fb_idx"], np.zeros((C, Fp - F), np.int32)], axis=1
            ),
            "fb_val": np.concatenate(
                [fb["fb_val"], np.zeros((C, Fp - F), np.float32)], axis=1
            ),
            "fb_block": np.concatenate(
                [fb["fb_block"], np.full((C, Fp - F), G, np.int32)], axis=1
            ),
        }
    if Gp != G:
        # remap pool padding block slot G -> Gp (always-empty segment)
        fb = dict(fb)
        fb["fb_block"] = np.where(fb["fb_block"] >= G, Gp, fb["fb_block"])
    return arrays, fb, Gp, Fp
