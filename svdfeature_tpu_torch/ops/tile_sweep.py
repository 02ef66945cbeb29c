"""Tile-sweep large-table step: pack-time sort plans + one write pass.

PyTorch counterpart of svdfeature_tpu/ops/tile_sweep.py.  The batch's
entry->row map is fixed across rounds (training data is packed once), so
the sort, the tile grouping and the run structure are computed ONCE on the
host at pack time (``make_sweep_plan`` / ``attach_sweep_plans``, numpy
copies of the JAX package's, and ``attach_sweep_runs``, the port's runs:
each touched row's plan positions and table row, long runs cut into
pieces).  The runtime step (``train_step_sweep``) then runs the shared
forward half (ops/big_embed._forward_entries) and hands the step's
factors, coefficients and the plan to the sweep update K4
(ops/cuda_sweep.sweep_update), which forms each run's entries, sums them
and applies the regularization / clamp math of the TPU kernel's last tile
visit, in place.  Semantics are those
of big_embed.train_step_big (same reference citations), pinned by
tests/test_torch_big_sweep.py against the JAX package's interpret-mode
``train_step_sweep``.

When it wins: the TPU sweep touched every tile holding an entry, so the
solver's auto rule (solvers/base.py) selects it for batches dense enough
that most tiles are touched anyway (e.g. B >= 256k on a 2M-row table);
sparse batches keep the sorted-dedup step.  The port keeps the rule, so
it picks the route the JAX CLI picks for the same conf.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import tracing
from .embed import TrainConsts, TrainState

# Entries per grid cell.  1-D int32 blocks narrower than ~1024 lanes
# crash the remote Mosaic compiler (measured: 256 fails, 1024 works).
SWEEP_ECAP = 1024
# Table rows per tile (VMEM block height of the sweep).
SWEEP_TILE = 2048
# K4 cuts runs of more entries than this into pieces (make_sweep_runs)
SWEEP_PIECE = 64
# K4's first kernels hold rows of up to SWEEP_NARROW factors; its wide
# kernel holds rows of up to SWEEP_WIDE in one sweep and stages
# SWEEP_WIDE_PLAN plan entries a run at once (csrc/tile_sweep.cu
# kWideSweep, kWidePlan): a wider row is swept in passes that walk the
# staged plan again, so its pieces hold at most that many entries
SWEEP_NARROW = 256
SWEEP_WIDE = 512
SWEEP_WIDE_PLAN = 64
# the batch-dict keys of a sweep plan, with the runs of the port: K4 reads
# sw_src, sw_runs and sw_pieces; the plain version sw_tids, sw_lids, sw_src
SWEEP_KEYS = ("sw_tids", "sw_lids", "sw_src", "sw_runs", "sw_pieces")


# --------------------------------------------------------------------------
# pack-time plan
# --------------------------------------------------------------------------
def make_sweep_plan(ent_idx, n_pad_rows: int, tile: int, e_cap: int):
    """Host-side sweep plan for one batch's fixed entry->row map.

    ent_idx: [E] row id per entry, batch order (concat of u_idx.ravel()
    and i_idx.ravel() — must match big_embed._forward_entries).

    Returns numpy arrays:
      sw_tids [G]        tile index per grid cell; equal tiles are
                         consecutive (the kernel derives first/last
                         visit from transitions)
      sw_lids [G*e_cap]  row id local to the cell's tile, -1 = padding
      sw_src  [G*e_cap]  batch-order entry position feeding the cell's
                         payload row, E = padding (a zero payload row)
    """
    ent = np.asarray(ent_idx).reshape(-1).astype(np.int64)
    E = ent.shape[0]
    order = np.argsort(ent, kind="stable")
    si = ent[order]
    tl = si // tile
    uniq, counts = np.unique(tl, return_counts=True)
    cells_per = -(-counts // e_cap)
    G = int(cells_per.sum())
    tids = np.repeat(uniq, cells_per).astype(np.int32)
    lids = np.full(G * e_cap, -1, np.int32)
    src = np.full(G * e_cap, E, np.int32)
    run_start = np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    r = np.arange(E, dtype=np.int64) - run_start
    cell_base = np.repeat(
        np.concatenate([[0], np.cumsum(cells_per)[:-1]]), counts
    )
    pos = (cell_base + r // e_cap) * e_cap + r % e_cap
    lids[pos] = (si - tl * tile).astype(np.int32)
    src[pos] = order.astype(np.int32)
    assert n_pad_rows % tile == 0
    return {"sw_tids": tids, "sw_lids": lids, "sw_src": src}


def attach_sweep_plans(batches, n_pad_rows: int, tile: int, e_cap: int):
    """Add stacked plan arrays to a stacked batch dict.

    batches["u_idx"]/["i_idx"] are [T, B, S]; per-batch plans are padded
    to a common cell count G with passthrough cells on the last (pad)
    tile — their finalize sees zero touch counts and rewrites the tile
    unchanged.
    """
    u = np.asarray(batches["u_idx"])
    i = np.asarray(batches["i_idx"])
    T = u.shape[0]
    E = u[0].size + i[0].size
    plans = [
        make_sweep_plan(
            np.concatenate([u[t].reshape(-1), i[t].reshape(-1)]),
            n_pad_rows,
            tile,
            e_cap,
        )
        for t in range(T)
    ]
    Gm = max(p["sw_tids"].shape[0] for p in plans)
    pad_tile = n_pad_rows // tile - 1
    tids = np.full((T, Gm), pad_tile, np.int32)
    lids = np.full((T, Gm * e_cap), -1, np.int32)
    src = np.full((T, Gm * e_cap), E, np.int32)
    for t, p in enumerate(plans):
        g = p["sw_tids"].shape[0]
        tids[t, :g] = p["sw_tids"]
        lids[t, : g * e_cap] = p["sw_lids"]
        src[t, : g * e_cap] = p["sw_src"]
    out = dict(batches)
    out["sw_tids"] = tids
    out["sw_lids"] = lids
    out["sw_src"] = src
    return out


def make_sweep_runs(tids, lids, tile: int, e_cap: int, piece: int = SWEEP_PIECE,
                    num_factor: int = 0):
    """The runs of one batch's plan for K4 -> (runs [R, 4], pieces [S, 2])
    int32.

    The plan sorts entries stably by row and groups them by tile, so each
    touched row's entries are one contiguous run of plan positions with no
    padding inside (padding only ends a tile's last cell).  ``runs`` holds a
    record per run, (first position, end position, table row, slot): the end is
    the run's last entry + 1, so a tile's trailing padding belongs to no run.
    Runs of more than ``piece`` entries (a popular row) are cut into pieces of
    max(piece, ceil(sqrt(n))) entries (at most max(piece, SWEEP_WIDE_PLAN) for
    rows of ``num_factor`` > SWEEP_WIDE, which K4 sweeps in passes), each a
    record of its own with a partial-sum slot (-1 for a whole run); the pieces
    of one run take consecutive slots, and ``pieces[s]`` = (the run's first
    slot, its number of pieces).  For rows of more than SWEEP_NARROW factors
    (K4's wide kernel) the pieces' records come first, in slot order, so that
    the longest chains of the launch (a long run's pieces, then its last piece's
    adds) start with it."""
    lids = np.asarray(lids).reshape(-1)
    rows = np.repeat(np.asarray(tids, np.int64).reshape(-1), e_cap) * tile + lids
    real = np.flatnonzero(lids >= 0)
    r = rows[real]
    brk = r[1:] != r[:-1]
    first = np.concatenate([[True], brk])
    last = np.concatenate([brk, [True]])
    p0, p1, row = real[first], real[last] + 1, r[first]
    n = p1 - p0
    long = n > piece
    plen = np.where(long, np.maximum(piece, np.ceil(np.sqrt(n))), n).astype(np.int64)
    if num_factor > SWEEP_WIDE:
        plen = np.minimum(plen, max(piece, SWEEP_WIDE_PLAN))
    cnt = np.where(long, -(-n // np.maximum(plen, 1)), 1)
    run_of = np.repeat(np.arange(n.size), cnt)
    q = np.arange(run_of.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    t0 = p0[run_of] + q * plen[run_of]
    t1 = np.minimum(t0 + plen[run_of], p1[run_of])
    is_piece = long[run_of]
    slot = np.full(run_of.size, -1, np.int64)
    slot[is_piece] = np.arange(int(is_piece.sum()))
    runs = np.stack([t0, t1, row[run_of], slot], axis=1).astype(np.int32)
    if num_factor > SWEEP_NARROW:
        runs = runs[np.argsort(slot < 0, kind="stable")]
    pieces = np.stack([slot[is_piece] - q[is_piece], cnt[run_of[is_piece]]], axis=1)
    return runs, pieces.astype(np.int32).reshape(-1, 2)


def attach_sweep_runs(batches, tile: int, e_cap: int, piece: int = SWEEP_PIECE,
                      num_factor: int = 0):
    """Add ``sw_runs`` [T, R, 4] and ``sw_pieces`` [T, S, 2]
    (``make_sweep_runs`` of each batch for rows of ``num_factor`` factors;
    R and S their largest counts, at least 1; empty runs (0, 0, 0, -1) and
    zero pieces pad them) to a batch dict that holds stacked sweep plans."""
    tids, lids = np.asarray(batches["sw_tids"]), np.asarray(batches["sw_lids"])
    made = [make_sweep_runs(tids[t], lids[t], tile, e_cap, piece, num_factor)
            for t in range(tids.shape[0])]
    runs = np.zeros((len(made), max(1, *(r.shape[0] for r, _ in made)), 4), np.int32)
    runs[..., 3] = -1
    pieces = np.zeros((len(made), max(1, *(p.shape[0] for _, p in made)), 2), np.int32)
    for t, (r, p) in enumerate(made):
        runs[t, : r.shape[0]] = r
        pieces[t, : p.shape[0]] = p
    return dict(batches, sw_runs=runs, sw_pieces=pieces)


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------
@torch.no_grad()
def train_step_sweep(state: TrainState, batch: Dict[str, torch.Tensor], lr,
                     consts: TrainConsts, hp) -> TrainState:
    """train_step_big semantics with the tile-sweep write path.

    Requires the sweep plan and runs in the batch dict
    (``attach_sweep_plans`` + ``attach_sweep_runs``), the augmented table
    padded to a multiple of hp.sweep_tile and the consts' row tables padded
    to match (solvers/base.py arranges all three).  The forward half hands
    the step's factors and coefficients, not a payload: the sweep forms each
    entry itself.  ``hp.row_dma`` routes the write to the kernel wrapper K4,
    else to its plain version.  Updates ``state.w`` in place.  Traced as
    the spans ``forward`` and ``sweep``.
    """
    from .big_embed import _forward_entries
    from .cuda_sweep import sweep_update, sweep_update_reference

    w = state.w
    if w.shape[0] % hp.sweep_tile:
        raise ValueError(f"the sweep needs whole tiles of {hp.sweep_tile} rows")
    if tracing.on:
        tracing.begin("forward")
    f = _forward_entries(state, batch, lr, consts, hp)
    if tracing.on:
        tracing.then("sweep")
    scal = torch.stack([
        torch.as_tensor(lr, dtype=torch.float32, device=w.device),
        consts.wd_user_bias, consts.wd_item_bias,
        torch.zeros((), dtype=torch.float32, device=w.device),
    ])
    stepi = state.step.reshape(1).to(torch.int32)
    plan = {key: batch[key] for key in SWEEP_KEYS}
    fn = sweep_update if hp.row_dma else sweep_update_reference
    fn(w, plan, f.p_u, f.p_i, f.coef_u, f.coef_i, consts.wd_u_row, consts.wd_i_row, scal, stepi,
       hp)
    if tracing.on:
        tracing.end()
    return TrainState(w=w, b=state.b, g=f.g, step=f.nstep, ref_ui=state.ref_ui, ref_g=f.ref_g)
