"""The port's tile-sweep step (ops/tile_sweep.py, plain K4) against the JAX
package's ``train_step_sweep``, whose Pallas kernel runs in interpret mode
on the CPU as tests/test_tile_sweep.py runs it (TILE=16, ECAP=8).

Same numpy inputs (tests/test_big_embed.py patterns), two chained steps
on each side, each with its own pack-time plan; compared de-augmented:
w / b / g within atol 1e-6 (the TPU kernel sums a tile's entries with an
f32 one-hot matmul, the plain version with ``index_add_``; measured up to
1.2e-7), refs and the counter exactly, pad rows exactly 0.  The copied
plan functions give arrays identical to the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svdfeature_tpu.ops import big_embed as jbig
from svdfeature_tpu.ops import embed as jembed
from svdfeature_tpu.ops import tile_sweep as jsw
from svdfeature_tpu_torch import convert
from svdfeature_tpu_torch.ops import big_embed as tbig
from svdfeature_tpu_torch.ops import tile_sweep as tsw

from test_torch_big_embed import CPU, K, assert_same, big_hp, two_batches

TILE = 16
ECAP = 8


def plan_for(batch, n_pad, module):
    stacked = {key: np.asarray(v)[None] for key, v in batch.items()}
    return module.attach_sweep_plans(stacked, n_pad, TILE, ECAP)


def sweep_both(st, batches, cs, hp, lr=0.05):
    """Both packages' sweep steps over the batches -> de-augmented numpy
    states (JAX, port) and the port's padded table."""
    n = st["w"].shape[0]
    n_pad = -(-n // TILE) * TILE
    hp = dataclasses.replace(hp, sweep_table=True, sweep_tile=TILE, sweep_ecap=ECAP)
    cs_p = dict(cs, wd_u_row=np.pad(cs["wd_u_row"], (0, n_pad - n)),
                wd_i_row=np.pad(cs["wd_i_row"], (0, n_pad - n)))
    js = jbig.augment_state(jembed.TrainState(**{k: jnp.asarray(v) for k, v in st.items()}), K,
                            pad_rows_to=TILE)
    jconsts = jembed.TrainConsts(**{k: jnp.asarray(v) for k, v in cs_p.items()})
    jhp = jembed.HyperParams(**dataclasses.asdict(hp))
    ts = tbig.augment_state(convert.state_from_numpy(**st, device=CPU), K, pad_rows_to=TILE)
    tconsts = convert.consts_from_numpy(**cs_p, device=CPU)
    for batch in batches:
        planned = plan_for(batch, n_pad, jsw)
        jb = {k: jnp.asarray(v[0]) for k, v in planned.items()}
        js = jsw.train_step_sweep(js, jb, jnp.float32(lr), jconsts, jhp)
        planned = tsw.attach_sweep_runs(plan_for(batch, n_pad, tsw), TILE, ECAP)
        tb = convert.stacked_from_numpy({k: v[0] for k, v in planned.items()}, CPU)
        ts = tsw.train_step_sweep(ts, tb, torch.tensor(lr), tconsts, hp)
    jo = jbig.deaugment_state(js, K, n_rows=n)
    to = tbig.deaugment_state(ts, K, n_rows=n)
    return ({k: np.asarray(getattr(jo, k)) for k in ("w", "b", "g", "step", "ref_ui", "ref_g")},
            {k: getattr(to, k).numpy() for k in ("w", "b", "g", "step", "ref_ui", "ref_g")},
            ts.w.numpy())


def check(st, batches, cs, hp):
    want, got, table = sweep_both(st, batches, cs, hp)
    assert_same(got, want)
    n = st["w"].shape[0]
    assert (table[n:] == 0).all(), "pad rows must stay untouched"
    assert not np.allclose(got["w"], st["w"])  # it trained
    return got


@pytest.mark.parametrize("reg", [0, 1, 2, 3, 4, 5])
def test_sweep_matches_jax_two_steps(reg):
    st, batches, cs = two_batches(reg + 21)
    check(st, batches, cs, big_hp(reg_method=reg))


def test_sweep_no_user_bias_nonneg_matches_jax():
    st, batches, cs = two_batches(31)
    check(st, batches, cs, big_hp(no_user_bias=1, user_nonnegative=1, item_nonnegative=1))


@pytest.mark.parametrize("reg", [0, 4])
def test_sweep_heavy_duplicates_match_jax(reg):
    """Row collisions far beyond e_cap force multi-cell tile runs and runs
    of one row across cells."""
    st, batches, cs = two_batches(33, B=64, Su=2, Si=2)
    rng = np.random.RandomState(7)
    for b in batches:
        b["u_idx"] = rng.randint(0, 3, (64, 2)).astype(np.int32)
        b["i_idx"] = rng.randint(20, 24, (64, 2)).astype(np.int32)
    check(st, batches, cs, big_hp(reg_method=reg))


@pytest.mark.parametrize("reg", [0, 4])
def test_sweep_padding_entries_match_jax(reg):
    st, batches, cs = two_batches(35)
    n, ng = st["w"].shape[0], st["g"].shape[0]
    for b in batches:
        b["weight"][-4:] = 0.0
        b["u_idx"][-4:] = n - 1
        b["i_idx"][-4:] = n - 1
        b["g_idx"][-4:] = ng - 1
    got = check(st, batches, cs, big_hp(reg_method=reg))
    assert (got["w"][n - 1] == 0).all() and got["b"][n - 1] == 0


def _plan_inputs(seed, T=3, B=40, Su=2, Si=1, n=90):
    rng = np.random.RandomState(seed)
    u = rng.randint(0, 12, (T, B, Su)).astype(np.int32)
    i = rng.randint(12, n - 1, (T, B, Si)).astype(np.int32)
    u[:, -3:] = n - 1  # padding examples on the dummy row
    i[:, -3:] = n - 1
    i[1] = rng.randint(40, 44, (B, Si))  # a dense batch: long runs
    return {"u_idx": u, "i_idx": i, "label": np.ones((T, B), np.float32)}


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_functions_identical_to_jax(seed):
    batches = _plan_inputs(seed)
    n_pad = 96
    ent = np.concatenate([batches["u_idx"][0].ravel(), batches["i_idx"][0].ravel()])
    jp = jsw.make_sweep_plan(ent, n_pad, TILE, ECAP)
    tp = tsw.make_sweep_plan(ent, n_pad, TILE, ECAP)
    ja = jsw.attach_sweep_plans(batches, n_pad, TILE, ECAP)
    ta = tsw.attach_sweep_plans(batches, n_pad, TILE, ECAP)
    for key in ("sw_tids", "sw_lids", "sw_src"):
        assert tp[key].dtype == jp[key].dtype
        np.testing.assert_array_equal(tp[key], jp[key])
        assert ta[key].dtype == ja[key].dtype
        np.testing.assert_array_equal(ta[key], ja[key])
    assert (tsw.SWEEP_TILE, tsw.SWEEP_ECAP) == (jsw.SWEEP_TILE, jsw.SWEEP_ECAP)


def test_sweep_runs_partition_the_plan():
    """Each touched row's entries form exactly one run: the run records
    cover every real plan slot once and no padding slot, a run holds one
    row, which its record names, and padded run lists end in empty runs."""
    _check_runs(piece=64)


def test_sweep_runs_cut_long_runs_into_pieces():
    """Runs of more than ``piece`` entries (2: most of this set's runs)
    are cut into pieces whose slots are consecutive and name their run's
    first slot and number of pieces; the records still partition the
    plan."""
    _check_runs(piece=2)


@pytest.mark.parametrize("num_factor", [64, 256, 257, 512, 513, 1024])
def test_sweep_runs_of_wide_rows_fit_the_stage(num_factor):
    """Rows of up to SWEEP_NARROW factors keep the runs made without a
    factor count, byte for byte; wider rows (K4's wide kernel) have the
    same records with the pieces' first, and above SWEEP_WIDE (passes over
    a staged plan) a run of ~17,000 entries is cut into pieces of at most
    SWEEP_WIDE_PLAN entries (131 without); the records still partition
    the plan."""
    rng = np.random.RandomState(4)
    B, n = 20_000, 90
    i = np.full((2, B, 1), 50, np.int32)  # one row holds most item entries
    i[:, ::7] = rng.randint(12, n - 1, (2, -(-B // 7), 1))
    batches = {"u_idx": rng.randint(0, 12, (2, B, 1)).astype(np.int32), "i_idx": i,
               "label": np.ones((2, B), np.float32)}
    planned = _check_runs(64, batches, num_factor)
    plain = tsw.attach_sweep_runs(tsw.attach_sweep_plans(batches, 96, TILE, ECAP), TILE, ECAP)
    longest = int((plain["sw_runs"][..., 1] - plain["sw_runs"][..., 0]).max())
    assert longest > tsw.SWEEP_WIDE_PLAN
    runs = planned["sw_runs"]
    if num_factor <= tsw.SWEEP_NARROW:
        for key in ("sw_runs", "sw_pieces"):
            assert planned[key].dtype == plain[key].dtype
            np.testing.assert_array_equal(planned[key], plain[key])
    elif num_factor <= tsw.SWEEP_WIDE:
        np.testing.assert_array_equal(planned["sw_pieces"], plain["sw_pieces"])
        for t in range(runs.shape[0]):
            piece = runs[t, :, 3] >= 0
            n = int(piece.sum())
            assert piece[:n].all() and not piece[n:].any()  # the pieces first
            want = plain["sw_runs"][t]
            np.testing.assert_array_equal(runs[t, :n], want[want[:, 3] >= 0])
            np.testing.assert_array_equal(runs[t, n:], want[want[:, 3] < 0])
    else:
        assert int((runs[..., 1] - runs[..., 0]).max()) == tsw.SWEEP_WIDE_PLAN


def _check_runs(piece, batches=None, num_factor=0):
    batches = _plan_inputs(2) if batches is None else batches
    planned = tsw.attach_sweep_runs(tsw.attach_sweep_plans(batches, 96, TILE, ECAP), TILE, ECAP,
                                    piece=piece, num_factor=num_factor)
    T, L = planned["sw_lids"].shape
    for t in range(T):
        tids, lids = planned["sw_tids"][t], planned["sw_lids"][t]
        runs, pieces = planned["sw_runs"][t], planned["sw_pieces"][t]
        rows = np.repeat(tids.astype(np.int64), ECAP) * TILE + lids
        covered = np.zeros(L, int)
        seen, slots = [], []
        for p0, p1, row, slot in runs:
            if p0 == p1:
                assert slot == -1
                continue
            covered[p0:p1] += 1
            assert (lids[p0:p1] >= 0).all() and (rows[p0:p1] == row).all()
            assert p1 - p0 <= max(piece, int(np.ceil(np.sqrt(L))))
            if num_factor > tsw.SWEEP_WIDE:
                assert p1 - p0 <= max(piece, tsw.SWEEP_WIDE_PLAN)
            if slot < 0:
                seen.append(row)
            else:
                lo, n_pieces = pieces[slot]
                slots.append(slot)
                if slot == lo:
                    seen.append(row)
                    assert (runs[:, 3] >= lo).sum() - (runs[:, 3] >= lo + n_pieces).sum() == n_pieces
        assert (covered == (lids >= 0)).all()
        assert slots == list(range(len(slots)))
        ent = np.concatenate([batches["u_idx"][t].ravel(), batches["i_idx"][t].ravel()])
        assert sorted(seen) == sorted(set(ent.tolist()))
    assert piece == 64 or (planned["sw_runs"][..., 3] >= 0).any()
    return planned