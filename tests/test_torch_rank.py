"""The port's pairwise-rank path against the JAX package's, on the CPU.

Pair sources (data/rank.py, a verbatim copy) and the rank keys of the
iterator registry; the pair skeleton's per-round path (update_all, one
freshly sampled epoch a round) on small and big tables and the packed
epochs of what the skeleton refuses, against the JAX solver's update_all
(its jnp epochs on the CPU), atol 1e-6 (+ rtol 1e-5 on the big table); the
multi-round host path (one K2 call on the R*T planes of a block of rounds)
against the JAX package's ``_train_pair_rounds_host`` with
``default_device_is_tpu`` patched (blocks of 2 rounds), once with the TPU kernel in interpret
mode (it reads tables in bf16: the tolerance of tests/test_torch_svdpp.py,
atol 2e-4 / 5e-4, rtol 1e-3) and once with that kernel replaced by the
JAX package's f32 epochs on the same assembled planes (atol 1e-5); the
big-table multi path, atol 1e-6 + rtol 1e-5; K2's plain version on per-
round planes against one call a round, exactly; the device sampler's law;
the ranker's rank lists and top-k; and the whole CLI slice in both
packages (checkpoints atol 1e-5, pred.txt equal).  The shapes are those of
the JAX package's tests/test_rank.py.  K2 itself on per-round planes is
held against its plain version on the card by the ``cuda`` case.
"""

import gc
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svdfeature_tpu_torch.data.rank import PairSource
from svdfeature_tpu_torch.data.registry import IteratorConfig, load_plus_source
from svdfeature_tpu_torch.data.text import load_plus_text
from svdfeature_tpu_torch.ops import _plans, cuda_svdpp

RANK_KEYS = ("pos_sample_lowerb", "neg_sample_upperb", "rank_sample_num", "rank_sample_max",
             "rank_sample_method", "rank_sample_gap", "rank_sample_pointwise",
             "seed_sampler_bytime")
# tests/test_rank.py's multi-path trainer: GS = 16 users x 8 rows = 128
MULTI = [("users_per_batch", "16"), ("num_global", "0"), ("num_user", "60"),
         ("num_item", "100"), ("num_ufeedback", "130"), ("learning_rate", "0.02")]


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here and not at the top: a GPU host
    without JAX still collects this file and runs the card case."""
    pytest.importorskip("jax")
    import jax
    from jax.experimental.pallas import tpu as pltpu

    from svdfeature_tpu.data import rank, registry, text
    from svdfeature_tpu.ops import embed, pair_sample, pallas_svdpp, svdpp
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers import ranker, svdpp as solver

    return SimpleNamespace(jax=jax, pltpu=pltpu, rank=rank, registry=registry, text=text,
                           embed=embed, pair_sample=pair_sample, pallas_svdpp=pallas_svdpp,
                           svdpp=svdpp, SVDTypeParam=SVDTypeParam, ranker=ranker, solver=solver)


def skewed_text(seed=4, n_users=12, g_feats=True, follow=False):
    """(rows, feedback) text of tests/test_rank.py's _skewed_pair_ds
    (``g_feats``) and _noglobal_pair_ds: 2..30 rows a user, the low item
    ids the positives everywhere; with ``follow`` each user also follows
    three users (feedback ids in the user space)."""
    rng = np.random.RandomState(seed)
    frng = np.random.RandomState(seed + 100)
    rows, fb = [], []
    for u in range(n_users):
        n = 2 + (7 * (u % 5))
        items = rng.choice(30, min(n, 30), replace=False)
        for i in items:
            seg = "1 1 1 0:0.5" if g_feats else "0 1 1"
            rows.append(f"{float(1 if i < 15 else 0)} {seg} {u}:1 {i}:1")
        ids = frng.choice(n_users, 3, replace=False) if follow else []
        fb.append(f"{len(items)} {len(ids)}" + "".join(f" {j}:0.5" for j in ids))
    return "\n".join(rows), "\n".join(fb)


NOGLOBAL = dict(seed=4, n_users=16, g_feats=False)


def port_source(text_kw=NOGLOBAL, seed=9, **cfg_kw):
    rows, fbs = skewed_text(**text_kw)
    cfg = IteratorConfig()
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    return PairSource(load_plus_text("x", "y", text=rows, feedback_text=fbs), cfg, seed=seed)


def jax_source(jx, text_kw=NOGLOBAL, seed=9, **cfg_kw):
    rows, fbs = skewed_text(**text_kw)
    cfg = jx.registry.IteratorConfig()
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    return jx.rank.PairSource(jx.text.load_plus_text("x", "y", text=rows, feedback_text=fbs), cfg,
                              seed=seed)


def rank_params(extra=()):
    """tests/test_rank.py's _mini_rank_trainer conf."""
    return [("learning_rate", "0.01"), ("wd_user", "0.004"), ("wd_item", "0.004"),
            ("num_user", "12"), ("num_item", "30"), ("num_global", "6"), ("num_factor", "8"),
            ("num_ufeedback", "30"), ("wd_ufeedback", "0.004"), ("no_user_bias", "1"),
            *extra]


def port_trainer(extra=(), device="cpu"):
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.svdpp import SVDPPFeatureTrainer

    tr = SVDPPFeatureTrainer(SVDTypeParam(format_type=1, active_type=3))
    for k, v in rank_params(extra) + [("device", device)]:
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    return tr


def jax_trainer(jx, extra=()):
    tr = jx.solver.SVDPPFeatureTrainer(jx.SVDTypeParam(format_type=1, active_type=3))
    for k, v in rank_params(extra):
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    return tr


def assert_models_close(ttr, jtr, atol, rtol=0.0):
    ttr._sync_model_from_state()
    jtr._sync_model_from_state()
    for name in ("w", "b"):
        np.testing.assert_allclose(getattr(ttr.model, name).numpy(),
                                   np.asarray(getattr(jtr.model, name)), atol=atol, rtol=rtol,
                                   err_msg=name)
    assert int(ttr.state.step) == int(jtr.state.step)


# ---- sources -------------------------------------------------------------------
def test_iterator_config_rank_keys(jx, tmp_path):
    """The rank sampler keys: the JAX package's defaults and parsing; input
    types 2 (buffer) and 3 (text) give a PairSource over the user-group
    input in both packages."""
    cfg, jcfg = IteratorConfig(), jx.registry.IteratorConfig()
    for k in RANK_KEYS:
        assert getattr(cfg, k) == getattr(jcfg, k), k
    for k, v in zip(RANK_KEYS, ("0.5", "0.25", "7", "9", "1", "0.125", "1", "1")):
        cfg.set_param(k, v)
        jcfg.set_param(k, v)
        assert getattr(cfg, k) == getattr(jcfg, k) and type(getattr(cfg, k)) is type(
            getattr(jcfg, k)), k
    rows, fbs = skewed_text(**NOGLOBAL)
    (tmp_path / "r.feature").write_text(rows)
    (tmp_path / "r.feedback").write_text(fbs)
    for dtype in (3, 2):
        srcs = []
        for mod in (None, jx.registry):
            c = (mod.IteratorConfig if mod else IteratorConfig)()
            for k, v in (("data_in", tmp_path / "r.feature"),
                         ("feedback_in", tmp_path / "r.feedback"),
                         ("buffer_feature", tmp_path / f"{'jt'[mod is None]}.buffer"),
                         ("silent", "1"), ("streaming", "1")):
                c.set_param(k, str(v))
            srcs.append((mod.load_plus_source if mod else load_plus_source)(dtype, c))
        assert isinstance(srcs[0], PairSource) and srcs[0].rows.num_row == len(rows.split("\n"))
        for a, b in zip(srcs[0].epoch_pairs(), srcs[1].epoch_pairs()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", [0, 1])
def test_pair_sampling_matches_jax(jx, method):
    """epoch_pairs / epoch_dataset, three epochs, and (method 0)
    pair_geometry and sample_offsets, byte for byte."""
    src, jsrc = port_source(rank_sample_method=method), jax_source(jx, rank_sample_method=method)
    for _ in range(3):
        for a, b in zip(src.epoch_pairs(), jsrc.epoch_pairs()):
            np.testing.assert_array_equal(a, b)
        ep, jep = src.epoch_dataset(), jsrc.epoch_dataset()
        for f in ("labels", "row_ptr", "index", "value"):
            a, b = getattr(ep.rows, f), getattr(jep.rows, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        np.testing.assert_array_equal(ep.block_row_ptr, jep.block_row_ptr)
    if method:
        return
    geo, jgeo = src.pair_geometry(), jsrc.pair_geometry()
    assert geo.keys() == jgeo.keys()
    for k in geo:
        np.testing.assert_array_equal(np.asarray(geo[k]), np.asarray(jgeo[k]), err_msg=k)
    for a, b in zip(src.sample_offsets(3, np.random.default_rng(5)),
                    jsrc.sample_offsets(3, np.random.default_rng(5))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---- the per-round path ------------------------------------------------------------
PER_ROUND = {
    # the skeleton (K2's gate passes: the plain version on CPU tensors)
    "skeleton": dict(extra=MULTI, text=NOGLOBAL, big=False),
    # the skeleton on a big table: the entry-stream big epoch
    "skeleton-big": dict(extra=MULTI, text=NOGLOBAL, big=True),
    # global features: a fresh packed epoch a round (_pair_entry)
    "entry-global": dict(extra=[("users_per_batch", "4")], text=dict(seed=4), big=False),
    # the rating-gap sampler (rank_sample_method=1): its pair counts are
    # deterministic too, so the skeleton takes it (not the multi paths)
    "skeleton-method1": dict(extra=MULTI, text=NOGLOBAL, big=False,
                             cfg=dict(rank_sample_method=1)),
    # pointwise rows: a fresh packed epoch a round (_pair_entry)
    "entry-pointwise": dict(extra=MULTI, text=NOGLOBAL, big=False,
                            cfg=dict(rank_sample_pointwise=1)),
    # follow feedback in a feedback space shared with the user rows: a
    # fresh packed epoch a round on the per-batch refresh epoch
    "entry-shared-space": dict(extra=MULTI + [("common_feedback_space", "1"),
                                              ("num_ufeedback", "16")],
                               text=dict(NOGLOBAL, follow=True), big=False),
}


@pytest.mark.parametrize("case", list(PER_ROUND))
def test_per_round_path_matches_jax(monkeypatch, jx, case):
    """update_all, 3 rounds, on the same PairSource stream in both packages:
    the tables after each round agree (atol 1e-6; + rtol 1e-5 on the big
    table), and so do the predictions on a fresh epoch."""
    c = PER_ROUND[case]
    if c["big"]:
        from svdfeature_tpu_torch.solvers import base as tbase

        monkeypatch.setattr(jx.embed, "ONEHOT_THRESHOLD", 4)
        monkeypatch.setattr(tbase, "BIG_TABLE_ROWS", 4)
    ttr, jtr = port_trainer(c["extra"]), jax_trainer(jx, c["extra"])
    assert ttr.hp.big_table == jtr.hp.big_table == c["big"]
    kw = dict(text_kw=c["text"], **c.get("cfg", {}))
    src, jsrc = port_source(**kw), jax_source(jx, **kw)
    tol = dict(atol=1e-6, rtol=1e-5 if c["big"] else 0.0)
    for r in range(3):
        ttr.update_all(src)
        jtr.update_all(jsrc)
        assert_models_close(ttr, jtr, **tol)
    skeleton = case.startswith("skeleton")
    assert ttr._pair_skeleton_ok(src) == jtr._pair_skeleton_ok(jsrc) == skeleton
    if skeleton:
        assert ttr._pair_sk["use_kernel"] == (not c["big"])
        assert "chunk_users" not in ttr._pair_sk["fb"]  # no carry plan, no layout planes
        assert not any(p in ttr._pair_sk["static"] for p in ("i_order", "i_si"))
    probe, jprobe = (port_source(seed=31, **kw).epoch_dataset(),
                     jax_source(jx, seed=31, **kw).epoch_dataset())
    np.testing.assert_allclose(ttr.predict_all(probe), np.asarray(jtr.predict_all(jprobe)),
                               atol=1e-5, rtol=1e-5)


def test_pair_epochs_stay_out_of_the_pack_cache():
    """Pair epochs are new datasets every round: neither the skeleton's
    throwaway pack nor _pair_entry's epochs enter the id-keyed pack cache."""
    for extra, text in ((MULTI, NOGLOBAL), ([("users_per_batch", "4")], dict(seed=4))):
        tr = port_trainer(extra)
        src = port_source(text_kw=text)
        for _ in range(3):
            tr.update_all(src)
        assert tr._plus_cache == {}


# ---- the multi-round paths ----------------------------------------------------------
def _jax_f32_kernel(jx):
    """The JAX package's f32 epochs (ops/svdpp.train_epoch_plus), one per
    round of per-round planes, in the place of its bf16 TPU kernel."""
    jnp = jx.jax.numpy

    def run(state, stacked, chunk_id, fb, overlap, lrs, consts, hp, G, M, off_user, off_item,
            *fbh):
        T = stacked["label"].shape[0]
        per_round = stacked["u_idx"].shape[0] != T
        for r in range(lrs.shape[0]):
            ep = dict(stacked)
            if per_round:
                for p in ("u_idx", "u_val", "i_idx", "i_val"):
                    ep[p] = stacked[p][r * T:(r + 1) * T]
            state = jx.svdpp.train_epoch_plus(state, ep, chunk_id, fb, overlap,
                                              jnp.float32(lrs[r]), consts, hp, *fbh,
                                              rows_per_user=M)
        return state

    return run


def multi_trainers(monkeypatch, jx):
    """A port and a JAX trainer on the multi path's conf, with blocks of 2
    rounds (PAIR_BLOCK_ROUNDS, 8 by default) in both, so that 3 rounds are
    two blocks."""
    from svdfeature_tpu_torch.solvers.svdpp import SVDPPFeatureTrainer

    monkeypatch.setattr(jx.embed, "default_device_is_tpu", lambda: True)
    monkeypatch.setattr(SVDPPFeatureTrainer, "PAIR_BLOCK_ROUNDS", 2)
    monkeypatch.setattr(jx.solver.SVDPPFeatureTrainer, "PAIR_BLOCK_ROUNDS", 2)
    return port_trainer(MULTI), jax_trainer(jx, MULTI)


@pytest.mark.parametrize("kernel", ["f32-epochs", "interpret"])
def test_multi_path_matches_jax(monkeypatch, jx, kernel):
    """update_rounds(src, 3) on the multi-round host path: two blocks
    (2 + 1 rounds), each one K2 call on its R*T planes, assembled from the
    same sample_offsets stream as the JAX package's _train_pair_rounds_host."""
    ttr, jtr = multi_trainers(monkeypatch, jx)
    src, jsrc = port_source(), jax_source(jx)
    calls = []
    ref = cuda_svdpp.train_rounds_svdpp_reference
    monkeypatch.setattr(cuda_svdpp, "train_rounds_svdpp_reference",
                        lambda *a: calls.append(a[1]["u_idx"].shape[0]) or ref(*a))
    ttr.update_rounds(src, 3)
    T = ttr._pair_sk["T"]
    assert calls == [2 * T, T] and "geo" in ttr._pair_sk
    if kernel == "interpret":
        with jx.pltpu.force_tpu_interpret_mode():
            jtr.update_rounds(jsrc, 3)
        assert_models_close(ttr, jtr, atol=5e-4, rtol=1e-3)
        return
    monkeypatch.setattr(jx.pallas_svdpp, "train_rounds_svdpp_pallas", _jax_f32_kernel(jx))
    with jx.jax.disable_jit():
        jtr.update_rounds(jsrc, 3)
    assert "geo" in jtr._pair_sk
    assert_models_close(ttr, jtr, atol=1e-5)


def test_big_multi_path_matches_jax(monkeypatch, jx):
    """The big-table multi path (a big epoch a round on the block's planes,
    the user-carry body from the candidate plan) against the JAX package's,
    thresholds forced to 4 rows, 3 rounds in two blocks: atol 1e-6 + rtol
    1e-5."""
    from svdfeature_tpu_torch.solvers import base as tbase

    monkeypatch.setattr(jx.embed, "ONEHOT_THRESHOLD", 4)
    monkeypatch.setattr(tbase, "BIG_TABLE_ROWS", 4)
    ttr, jtr = multi_trainers(monkeypatch, jx)
    assert ttr.hp.big_table and jtr.hp.big_table
    src, jsrc = port_source(), jax_source(jx)
    ttr.update_rounds(src, 3)
    with jx.pltpu.force_tpu_interpret_mode():  # the JAX package's row writer
        jtr.update_rounds(jsrc, 3)
    assert "chunk_users" in ttr._pair_sk["fb"] and "chunk_users" in jtr._pair_sk["fb"]
    np.testing.assert_array_equal(ttr._pair_sk["fb"]["chunk_users"].numpy(),
                                  np.asarray(jtr._pair_sk["fb"]["chunk_users"]))
    assert_models_close(ttr, jtr, atol=1e-6, rtol=1e-5)


def test_multi_path_learns_and_zero_rounds_noop():
    """The multi path and the device sampler learn the pair order (tests/
    test_rank.py's gate: > 0.9 of a fresh epoch's pairs ordered);
    update_rounds(src, 0) changes nothing."""
    for extra in ((), (("rank_device_sample", "1"),)):
        tr = port_trainer(MULTI + list(extra))
        src = port_source()
        w0 = tr.state.w.clone()
        tr.update_rounds(src, 0)
        assert torch.equal(tr.state.w, w0)
        tr.update_rounds(src, 10)
        assert ("sampler" in tr._pair_sk) == bool(extra)
        p = tr.predict_all(port_source(seed=31).epoch_dataset())
        assert np.mean(p > 0.5) > 0.9


# ---- K2 on per-round planes ------------------------------------------------------------
def pair_round_planes(R=3, device="cpu"):
    """A port trainer, its skeleton and R rounds of sampled pair planes
    stacked ``[R*T, GS]`` (dead user entries on the dummy row, -v_neg in the
    second item entry), with each round's planes."""
    tr = port_trainer(MULTI, device=device)
    src = port_source()
    tr._apply_pair_layout()
    sk = tr._pair_skeleton(src)
    dev = tr.state.w.device
    flats = [tr._pair_flats(src, sk) for _ in range(R)]
    fp = torch.from_numpy(np.concatenate([f[0] for f in flats])).to(dev)
    fn = torch.from_numpy(np.concatenate([f[1] for f in flats])).to(dev)
    return tr, sk, tr._pair_stacked(sk, fp, fn)


def _k2_args(tr, sk, stacked, lrs):
    return (stacked, sk["chunk_id"], sk["fb"], sk["overlap"], lrs, tr.consts, tr.hp,
            tr._plus_hyper())


def test_plain_rounds_on_round_planes_equal_one_call_a_round():
    """K2's plain version on R*T planes equals R calls of one round on each
    round's planes, bit for bit; planes of another round count raise."""
    tr, sk, stacked = pair_round_planes()
    T = sk["T"]
    assert stacked["u_idx"].shape[0] == 3 * T and stacked["i_idx"].shape[-1] == 2
    assert cuda_svdpp.gate_failure(tr.hp, tr.state, stacked, sk["fb"], tr._plus_hyper()) is None
    lrs = torch.tensor([0.02, 0.015, 0.01])
    st0 = tr.state
    clone = lambda st: type(st)(**{f: getattr(st, f).clone() for f in st.__dataclass_fields__})  # noqa: E731
    got = cuda_svdpp.train_rounds_svdpp_kernel(clone(st0), *_k2_args(tr, sk, stacked, lrs))
    want = clone(st0)
    for r in range(3):
        want = cuda_svdpp.train_rounds_svdpp_reference(
            want, *_k2_args(tr, sk, cuda_svdpp.round_planes(stacked, r), lrs[r:r + 1]))
    for name in ("w", "b", "step"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert not torch.equal(got.w, st0.w)
    with pytest.raises(ValueError, match="expected"):
        cuda_svdpp.train_rounds_svdpp_reference(clone(st0), *_k2_args(tr, sk, stacked, lrs[:2]))


@pytest.mark.cuda
def test_kernel_on_round_planes_matches_plain_on_card():
    """K2 on per-round pair planes (R=3, item width 2) against its plain
    version on the card, one launch (atomics sum in a varying order:
    atol 1e-5 / rtol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m cuda tests/)")
    tr, sk, stacked = pair_round_planes(device="cuda")
    assert sk["use_kernel"]
    lrs = torch.tensor([0.02, 0.015, 0.01], device="cuda")
    st0 = tr.state
    clone = lambda st: type(st)(**{f: getattr(st, f).clone() for f in st.__dataclass_fields__})  # noqa: E731
    before = cuda_svdpp.train_rounds_svdpp_kernel.launches
    got = cuda_svdpp.train_rounds_svdpp_kernel(clone(st0), *_k2_args(tr, sk, stacked, lrs))
    torch.cuda.synchronize()
    assert cuda_svdpp.train_rounds_svdpp_kernel.launches - before == 1
    want = cuda_svdpp.train_rounds_svdpp_reference(clone(st0), *_k2_args(tr, sk, stacked, lrs))
    for name in ("w", "b"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), atol=1e-5, rtol=1e-4)
    assert int(got.step) == int(want.step)


def test_trainer_releases_its_kept_plans():
    """The kernel wrappers' kept plans that hold a trainer's staged planes
    go when the trainer goes (a plan keeps its tensors alive)."""
    tr = port_trainer(MULTI)
    tr.update_all(port_source())
    label = tr._pair_sk["static"]["label"]
    other = torch.zeros(3)
    plans = cuda_svdpp._PLANS
    saved = list(plans)
    try:
        for t in (label, other):
            _plans.keep_plan(plans, (t,), ("test",), (), None, torch.zeros((), dtype=torch.int32))
        del tr
        gc.collect()
        held = [p.tensors[0] for p in plans if p.key == ("test",)]
        assert len(held) == 1 and held[0] is other
    finally:
        plans[:] = saved


# ---- the device sampler --------------------------------------------------------------
def test_device_sampler_law():
    """The device sampler (ops/pair_sample.py) obeys the reference's law
    (tests/test_rank.py::test_device_sampler_law): every sampled row a
    same-user candidate of the right polarity, each user's candidates read
    cyclically from a permutation (counts differ by <= 1; each negative
    exactly once when snum == n_neg), padded slots on the dummy row, fresh
    rounds, the same planes from the same seed and round."""
    from svdfeature_tpu_torch.ops.pair_sample import (build_pair_sampler_statics,
                                                      sample_pair_flats, stage_statics)

    src = port_source()
    cfg = src.cfg
    tr = port_trainer([("users_per_batch", "4"), ("num_global", "0"), ("num_user", "16")])
    tr._apply_pair_layout()
    assert tr._pair_skeleton_ok(src)
    sk = tr._pair_skeleton(src)
    st = stage_statics(build_pair_sampler_statics(src, sk["slot"], sk["TGS"]), torch.device("cpu"))
    R = 3
    fp, fn = (a.numpy() for a in sample_pair_flats(0, 0, st, R))
    assert fp.shape == fn.shape == (R, sk["TGS"])

    rows = src._rows_cat
    Rr, labels = rows.num_row, rows.labels
    row_block = np.searchsorted(np.asarray(src._row_starts, np.int64), np.arange(Rr),
                                side="right") - 1
    _, _, counts = src.epoch_pairs()
    blk_of_pair = np.repeat(np.arange(len(counts)), counts)
    slot = sk["slot"]
    pad = np.ones(sk["TGS"], bool)
    pad[slot] = False
    is_pos = labels - cfg.pos_sample_lowerb > -1e-6
    is_neg = labels - cfg.neg_sample_upperb < 1e-6
    for r in range(R):
        assert (fp[r][pad] == Rr).all() and (fn[r][pad] == Rr).all()
        p, n = fp[r][slot], fn[r][slot]
        np.testing.assert_array_equal(row_block[p], blk_of_pair)
        np.testing.assert_array_equal(row_block[n], blk_of_pair)
        assert is_pos[p].all() and is_neg[n].all()
        for b in np.unique(blk_of_pair):
            sel = blk_of_pair == b
            for plane, cond in ((p, is_pos), (n, is_neg)):
                c = np.bincount(plane[sel], minlength=Rr)[np.nonzero((row_block == b) & cond)[0]]
                assert c.max() - c.min() <= 1
        negs = np.nonzero(np.isin(row_block, np.unique(blk_of_pair)) & is_neg)[0]
        assert (np.bincount(n, minlength=Rr)[negs] == 1).all()
    assert (fp[0] != fp[1]).any() or (fn[0] != fn[1]).any()
    fp2, fn2 = sample_pair_flats(0, 0, st, R)
    assert np.array_equal(fp, fp2.numpy()) and np.array_equal(fn, fn2.numpy())
    fp3, _ = sample_pair_flats(0, 1, st, 1)  # round 1 of the stream alone
    assert np.array_equal(fp[1], fp3[0].numpy())


# ---- the ranker -----------------------------------------------------------------------
def ranker_protocol(seed=3, n_items=30, n_users=9, fb=True):
    """A tag protocol (ITEM rows, then per user USER / BAN / POS / SPEC /
    PROCESS) over a trained-looking random model: (feature text, feedback
    text)."""
    rng = np.random.RandomState(seed)
    rows, fbs = [f"0 0 0 1 {i}:1" for i in range(n_items)], [f"{n_items} 0"]
    for u in range(n_users):
        items = rng.permutation(n_items)
        ban, pos = items[:3], items[3:3 + 1 + u % 4]
        sec = [f"2 0 1 0 {u}:1", "-1 0 %d 0 %s" % (len(ban), " ".join(f"{i}:1" for i in ban)),
               "1 0 %d 0 %s" % (len(pos), " ".join(f"{i}:1" for i in pos))]
        if u % 3 == 0:
            sec.append(f"3 0 1 1 {items[-1]}:1 {items[-1]}:1")
        sec.append("4 0 0 0")
        rows += sec
        nf = 1 + u % 3
        fbs.append(f"{len(sec)} {nf} " + " ".join(f"{rng.randint(0, 30)}:{rng.rand():.3f}"
                                                 for _ in range(nf)) if fb else f"{len(sec)} 0")
    return "\n".join(rows), "\n".join(fbs)


@pytest.mark.parametrize("top_k", [0, 5])
def test_ranker_matches_jax(jx, top_k):
    """SVDFeatureRanker.process_dataset on the same model (a user-group
    model with feedback rows, random factors and biases): the rank
    positions of the positives, or the top-k lists, equal the JAX ranker's."""
    import io

    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.registry import create_svd_ranker

    tr = port_trainer([("num_item", "30"), ("num_user", "9")])
    rng = np.random.RandomState(7)
    tr.model.w = torch.from_numpy(rng.normal(0, 0.3, tuple(tr.model.w.shape)).astype(np.float32))
    tr.model.b = torch.from_numpy(rng.normal(0, 0.3, tuple(tr.model.b.shape)).astype(np.float32))
    buf = io.BytesIO()
    buf.write(tr.mtype.to_bytes())
    tr.model.save(buf)
    rows, fbs = ranker_protocol()
    out = {}
    for tag in ("torch", "jax"):
        f = io.BytesIO(buf.getvalue())
        if tag == "torch":
            mtype = SVDTypeParam.from_bytes(f.read(4))
            rk = create_svd_ranker(mtype)
            rk.set_param("device", "cpu")
            ds = load_plus_text("x", "y", text=rows, feedback_text=fbs)
        else:
            mtype = jx.SVDTypeParam.from_bytes(f.read(4))
            rk = jx.ranker.SVDFeatureRanker(mtype)
            ds = jx.text.load_plus_text("x", "y", text=rows, feedback_text=fbs)
        rk.set_param("top_k", str(top_k))
        rk.load_model(f)
        rk.init_ranker(30)
        out[tag] = np.asarray(rk.process_dataset(ds))
    assert out["torch"].dtype == np.int32 and len(out["torch"]) == (
        9 * top_k if top_k else sum(1 + u % 4 for u in range(9)))
    np.testing.assert_array_equal(out["torch"], out["jax"])


# ---- the CLI slice -------------------------------------------------------------------
CLI_CONF = """learning_rate = 0.01
wd_user = 0.004
wd_item = 0.004
num_user = 16
num_item = 30
num_item_set = 30
num_global = 0
num_factor = 8
active_type = 3
format_type = 1
model_type = 1
num_ufeedback = 30
wd_ufeedback = 0.004
use_ranker = 1
no_user_bias = 1
input_type = 2
silent = 1
"""
CLI_ROUNDS = 2


def test_cli_slice_matches_jax(tmp_path):
    """make_ugroup_buffer (train -scale_score 5, test protocol -max_block
    400) -> svd_feature 2 rounds -> svd_feature_infer pred=2 with the
    ranker, in both packages (the port with device=cpu): every checkpoint
    agrees (atol 1e-5) and pred.txt is the same file."""
    pytest.importorskip("jax")
    from svdfeature_tpu import model as jmodel
    from svdfeature_tpu.cli import make_ugroup_buffer as jbuf_cli
    from svdfeature_tpu.infer.task import SVDInferTask as JInfer
    from svdfeature_tpu.params import SVDTypeParam as JType
    from svdfeature_tpu.train.loop import SVDTrainTask as JTrain
    from svdfeature_tpu_torch.cli import make_ugroup_buffer as tbuf_cli
    from svdfeature_tpu_torch.infer.task import SVDInferTask as TInfer
    from svdfeature_tpu_torch.train.loop import SVDTrainTask as TTrain

    rows, fbs = skewed_text(**NOGLOBAL)
    # ratings 5 / 0: -scale_score 5 makes them the sampler's 1 / 0
    (tmp_path / "train.feature").write_text("\n".join(
        "5.0" + r[3:] if r.startswith("1.0") else r for r in rows.split("\n")))
    (tmp_path / "train.feedback").write_text(fbs)
    prows, pfbs = ranker_protocol(n_users=16, fb=False)
    (tmp_path / "test.feature").write_text(prows)
    (tmp_path / "test.feedback").write_text(pfbs)
    run = {"jax": (jbuf_cli, JTrain, JInfer, []),
           "torch": (tbuf_cli, TTrain, TInfer, ["device=cpu"])}
    preds, models = {}, {}
    for tag, (buf_cli, train_cls, infer_cls, dev) in run.items():
        d = tmp_path / tag
        d.mkdir()
        buf_cli.main([str(tmp_path / "train.feature"), str(d / "train.buffer"), "-fd",
                      str(tmp_path / "train.feedback"), "-scale_score", "5"])
        buf_cli.main([str(tmp_path / "test.feature"), str(d / "test.buffer"), "-fd",
                      str(tmp_path / "test.feedback"), "-scale_score", "1", "-max_block", "400"])
        (d / "t.conf").write_text(
            CLI_CONF + f'buffer_feature = "{d}/train.buffer"\ntest:buffer_feature = '
            f'"{d}/test.buffer"\nmodel_out_folder = "{d}/models"\n')
        train_cls().run(str(d / "t.conf"), [f"num_round={CLI_ROUNDS}", *dev])
        infer_cls().run(str(d / "t.conf"), [f"pred={CLI_ROUNDS}", f"name_pred={d}/pred.txt",
                                            *dev])
        preds[tag] = (d / "pred.txt").read_text()
        models[tag] = []
        for r in range(CLI_ROUNDS + 1):
            with open(d / "models" / f"{r:04d}.model", "rb") as f:
                m = jmodel.SVDModel.load(f, JType.from_bytes(f.read(4)))
            models[tag].append({n: np.asarray(getattr(m, n)) for n in ("w", "b")})
    for r in range(CLI_ROUNDS + 1):
        for n in ("w", "b"):
            np.testing.assert_allclose(models["torch"][r][n], models["jax"][r][n], atol=1e-5,
                                       rtol=0, err_msg=f"round {r} {n}")
    assert not np.allclose(models["torch"][-1]["w"], models["torch"][0]["w"])  # it trained
    lines = preds["torch"].split()
    assert len(lines) == sum(1 + u % 4 for u in range(16))
    assert preds["torch"] == preds["jax"]


# ---- the ranker under mesh keys and in a torchrun world ---------------------------------
RANK_WORLD = 4
MESH_KEYS = ["mesh_data=2", "mesh_model=2"]


def _rank_infer_args(d, name, *extra):
    return [str(d / "t.conf"), "pred=1", f"name_pred={d / name}", "device=cpu", *extra]


@pytest.fixture(scope="module")
def rank_checkpoint(tmp_path_factory):
    """A user-group model with random factors and biases saved as the
    conf's round-1 checkpoint, and the ranker protocol of 16 users (with
    feedback) as its test buffer."""
    import io

    from svdfeature_tpu_torch.cli import make_ugroup_buffer
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.svdpp import SVDPPFeatureTrainer

    d = tmp_path_factory.mktemp("rank_mesh")
    rows, fbs = ranker_protocol(n_users=16)
    (d / "test.feature").write_text(rows)
    (d / "test.feedback").write_text(fbs)
    make_ugroup_buffer.main([str(d / "test.feature"), str(d / "test.buffer"), "-fd",
                             str(d / "test.feedback"), "-scale_score", "1", "-max_block", "400"])
    (d / "t.conf").write_text(CLI_CONF + f'test:buffer_feature = "{d}/test.buffer"\n'
                              f'model_out_folder = "{d}/models"\n')
    tr = SVDPPFeatureTrainer(SVDTypeParam(format_type=1, active_type=3))
    for line in CLI_CONF.strip().splitlines():
        tr.set_param(*(s.strip() for s in line.split("=")))
    tr.set_param("device", "cpu")
    tr.init_model()
    rng = np.random.RandomState(11)
    tr.model.w = torch.from_numpy(rng.normal(0, 0.3, tuple(tr.model.w.shape)).astype(np.float32))
    tr.model.b = torch.from_numpy(rng.normal(0, 0.3, tuple(tr.model.b.shape)).astype(np.float32))
    buf = io.BytesIO()
    buf.write(tr.mtype.to_bytes())
    tr.model.save(buf)
    (d / "models").mkdir()
    (d / "models" / "0001.model").write_bytes(buf.getvalue())
    return d


def test_ranker_takes_mesh_keys_as_jax_does(rank_checkpoint):
    """svd_feature_infer use_ranker=1 with mesh_data=2 mesh_model=2 and no
    world: the JAX ranker reads no mesh key (svdfeature_tpu/solvers/
    ranker.py:39-46) and ranks with the whole model, so the port's pred
    file is byte for byte the one without the mesh keys and the JAX
    package's task_pred_rank on the same checkpoint."""
    pytest.importorskip("jax")
    from svdfeature_tpu.infer.task import SVDInferTask as JInfer
    from svdfeature_tpu_torch.infer.task import SVDInferTask as TInfer

    d = rank_checkpoint
    for name, keys in (("pred_plain.txt", []), ("pred_mesh.txt", MESH_KEYS)):
        args = _rank_infer_args(d, name, *keys)
        TInfer().run(args[0], args[1:])
    args = _rank_infer_args(d, "pred_jax.txt")
    JInfer().run(args[0], [a for a in args[1:] if a != "device=cpu"])
    plain = (d / "pred_plain.txt").read_bytes()
    assert len(plain.split()) == sum(1 + u % 4 for u in range(16))
    assert (d / "pred_mesh.txt").read_bytes() == plain
    assert (d / "pred_jax.txt").read_bytes() == plain


def test_ranker_in_a_world_writes_on_rank_zero(rank_checkpoint):
    """The same infer under torchrun (distributed=1, the mesh keys, 4 gloo
    ranks on the CPU; this file is the rank program): every rank ranks with
    the whole model and rank 0 alone writes its pred file, the bytes of the
    run without a world."""
    import os
    import pathlib
    import subprocess
    import sys

    d = rank_checkpoint
    if not (d / "pred_plain.txt").exists():
        from svdfeature_tpu_torch.infer.task import SVDInferTask as TInfer

        args = _rank_infer_args(d, "pred_plain.txt")
        TInfer().run(args[0], args[1:])
    root = pathlib.Path(__file__).resolve().parent.parent
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={RANK_WORLD}", str(pathlib.Path(__file__).resolve()), str(d)]
    proc = subprocess.run(cmd, env={**os.environ, "PYTHONPATH": str(root)}, cwd=root,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    assert sorted(p.name for p in d.glob("pred_world_r*.txt")) == ["pred_world_r0.txt"]
    assert (d / "pred_world_r0.txt").read_bytes() == (d / "pred_plain.txt").read_bytes()


if __name__ == "__main__":  # a rank of test_ranker_in_a_world_writes_on_rank_zero's world
    import os
    import pathlib
    import sys

    from svdfeature_tpu_torch.infer.task import SVDInferTask

    world_dir = pathlib.Path(sys.argv[1])
    args = _rank_infer_args(world_dir, f"pred_world_r{os.environ['RANK']}.txt", "distributed=1",
                            *MESH_KEYS)
    SVDInferTask().run(args[0], args[1:])
