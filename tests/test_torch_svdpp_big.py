"""The port's big-table SVD++ epoch (ops/svdpp_big.py) and its solver route
(solvers/svdpp.py) against the JAX package, at the tiny shapes of
tests/test_svdpp_big.py (10 users, k=8, 4 users a step).

Inputs are packed once with the port's copy of ``pack_plus`` (byte-
identical to the JAX package's, tests/test_torch_data.py) and handed as
the same numpy arrays to both packages.  On the CPU the writes take K5's
plain version (``row_dma`` off), as the JAX package's take ``.at[].set``.
The state after 3 epochs agrees within atol 1e-6 + rtol 1e-5 with the
step counter and the lazy refs exact; the solver's route and the CLI slice
agree within 1e-5.  K5 itself is held against its plain version on the
card by chip_smoke.py.
"""

import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svdfeature_tpu_torch import convert
from svdfeature_tpu_torch.data.batching_plus import pack_plus
from svdfeature_tpu_torch.data.text import load_plus_text
from svdfeature_tpu_torch.ops import big_embed, cuda_scatter, svdpp_big
from svdfeature_tpu_torch.ops.embed import HyperParams
from svdfeature_tpu_torch.ops.svdpp import PlusHyper, train_epoch_plus
from svdfeature_tpu_torch.solvers.svdpp import _chunk_users_from_slots

CPU = torch.device("cpu")
K = 8
ATOL, RTOL = 1e-6, 1e-5
EPOCHS = 3
FBH = dict(scale_lr_ufeedback=1.0, wd_ufeedback=0.003, wd_ufeedback_bias=0.002)


def synth_text(seed, n_users=10, fb_bound=15, nfb=(1, 5), g_feats=True):
    """(rows, feedback) text of JAX tests/test_svdpp_big.py's make_trainer:
    2-5 rows per user, ``nfb`` feedback ids each below ``fb_bound``."""
    rng = np.random.RandomState(seed)
    rows, fbs = [], []
    for u in range(n_users):
        nrows = int(rng.randint(2, 6))
        nf = int(rng.randint(*nfb))
        fbs.append(f"{nrows} {nf} " + " ".join(
            f"{rng.randint(0, fb_bound)}:{rng.rand():.3f}" for _ in range(nf)))
        for _ in range(nrows):
            label = rng.randint(1, 6)
            g = f"1 1 1 {rng.randint(0, 3)}:1" if g_feats else "0 1 1"
            rows.append(f"{label} {g} {u}:1 {rng.randint(0, 12)}:1")
    return "\n".join(rows), "\n".join(fbs)


def big_inputs(seed=13, M=1, carry=False, factored=False, num_fb=15, n_global=3, **hp_kw):
    """numpy (state, consts, stacked, chunk_id, fb, overlap) of one tiny case
    with the hyperparameters of the big route; ``carry`` adds the carry plan
    and the items' dedup layout as the solver packs them."""
    rows, fbs = synth_text(seed, fb_bound=num_fb, nfb=(1, 3) if factored else (1, 5),
                           g_feats=n_global > 0)
    ds = load_plus_text("x", "y", text=rows, feedback_text=fbs)
    n_user, n_item = 10, 12
    N = num_fb + n_user + n_item + 1
    off_user, off_item = num_fb, num_fb + n_user
    packed = pack_plus(ds, 4, N - 1, n_global, off_user, off_item, 0, num_user=n_user,
                       num_item=n_item, num_ufeedback=num_fb, rows_per_user=M,
                       factored_overlap=factored)
    if factored:
        assert isinstance(packed.fb_overlap, dict)
    rng = np.random.RandomState(seed + 1)
    w = rng.normal(0, 0.1, (N, K)).astype(np.float32)
    b = rng.normal(0, 0.01, (N,)).astype(np.float32)
    w[-1] = 0.0
    b[-1] = 0.0
    wd_u = np.zeros(N, np.float32)
    wd_i = np.zeros(N, np.float32)
    wd_u[off_user:off_item] = 0.004
    wd_i[off_item:N - 1] = 0.004
    NG = n_global + 1
    st = dict(w=w, b=b, g=np.zeros(NG, np.float32), step=np.int32(0),
              ref_ui=np.zeros(N, np.int32), ref_g=np.zeros(NG, np.int32))
    cs = dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=np.full(NG, 0.001, np.float32),
              wd_user_bias=np.float32(0.002), wd_item_bias=np.float32(0.003))
    stacked = packed.device_arrays()
    chunk_id = stacked.pop("chunk_id")
    fb = packed.fb_arrays()
    if carry:
        T, GS, _ = packed.u_idx.shape
        plan = _chunk_users_from_slots(
            packed.u_idx[:, :, 0].reshape(T, GS // M, M).astype(np.int64), chunk_id, N - 1)
        assert plan is not None
        fb["chunk_users"] = plan
        lay = big_embed.make_dedup_layout(packed.i_idx.reshape(T, -1).astype(np.int64))
        stacked.update(zip(svdpp_big.LAYOUT_PLANES, lay))
    hp = dict(dict(base_score=3.0, reg_global=hp_kw.pop("reg_global", 0)), **hp_kw)
    return SimpleNamespace(st=st, cs=cs, stacked=stacked, chunk_id=chunk_id, fb=fb,
                           overlap=packed.fb_overlap, hp=hp, M=M, carry=carry,
                           G=packed.num_blocks_local,
                           ph=PlusHyper(rows_per_user=M, off_user=off_user, **FBH))


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here and not at the top (the file's
    other cases need none of it)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from svdfeature_tpu.ops import big_embed as jbig
    from svdfeature_tpu.ops import embed, svdpp, svdpp_big as jsvdpp_big
    from svdfeature_tpu.solvers import svdpp as jsolver

    return SimpleNamespace(jax=jax, jnp=jnp, embed=embed, big=jbig, svdpp=svdpp,
                           svdpp_big=jsvdpp_big, solver=jsolver)


def _jtree(jx, d):
    if isinstance(d, dict):
        return {k: jx.jnp.asarray(v) for k, v in d.items()}
    return jx.jnp.asarray(d)


def run_jax_big(jx, x, epochs=EPOCHS):
    """The JAX package's train_epoch_plus_big, ``epochs`` times ->
    (w, b, ref_ui, g, step) of the de-augmented state, numpy."""
    jnp = jx.jnp
    state = jx.big.augment_state(jx.embed.TrainState(**_jtree(jx, x.st)), K)
    hp = jx.embed.HyperParams(big_table=True, num_factor=K, **x.hp)
    consts = jx.embed.TrainConsts(**_jtree(jx, x.cs))
    stacked, fb, overlap = _jtree(jx, x.stacked), _jtree(jx, x.fb), _jtree(jx, x.overlap)
    for _ in range(epochs):
        state = jx.svdpp_big.train_epoch_plus_big(
            state, stacked, jnp.asarray(x.chunk_id), fb, overlap, jnp.float32(0.01), consts, hp,
            x.ph.scale_lr_ufeedback, x.ph.wd_ufeedback, x.ph.wd_ufeedback_bias,
            rows_per_user=x.M, carry_users=x.carry)
    st = jx.big.deaugment_state(state, K)
    return tuple(np.asarray(a) for a in (st.w, st.b, st.ref_ui, st.g, st.step))


def run_port_big(x, epochs=EPOCHS, device=CPU, row_dma=False):
    """The port's train_epoch_plus_big, ``epochs`` times, same outputs."""
    state = big_embed.augment_state(convert.state_from_numpy(**x.st, device=device), K)
    hp = HyperParams(big_table=True, num_factor=K, row_dma=row_dma, **x.hp)
    consts = convert.consts_from_numpy(**x.cs, device=device)
    stacked = convert.stacked_from_numpy(x.stacked, device)
    fb, overlap = convert.pool_from_numpy(x.fb, x.overlap, device)
    lr = torch.tensor(0.01, device=device)
    for _ in range(epochs):
        state = svdpp_big.train_epoch_plus_big(state, stacked, x.chunk_id, fb, overlap, lr, consts,
                                               hp, x.ph, carry_users=x.carry)
    st = big_embed.deaugment_state(state, K)
    return tuple(a.cpu().numpy() for a in (st.w, st.b, st.ref_ui, st.g, st.step))


def assert_states_close(got, want, atol=ATOL, rtol=RTOL):
    for name, a, b in zip(("w", "b"), got[:2], want[:2]):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)
    np.testing.assert_allclose(got[3], want[3], atol=atol, rtol=rtol, err_msg="g")
    np.testing.assert_array_equal(got[2], want[2], err_msg="ref_ui")
    assert int(got[4]) == int(want[4])


CASES = {
    "noncarry": dict(),
    "carry-M1": dict(carry=True),
    "carry-M2": dict(carry=True, M=2, seed=3),
    "noncarry-M2": dict(M=2, seed=3),
    "carry-no_user_bias-clamps": dict(carry=True, seed=23, no_user_bias=1, user_nonnegative=1,
                                      item_nonnegative=1),
    "noncarry-no_user_bias-clamps": dict(seed=7, no_user_bias=1, user_nonnegative=1,
                                         item_nonnegative=1),
    "factored-overlap": dict(seed=17, factored=True, num_fb=200, n_global=0),
    "factored-overlap-carry": dict(seed=17, factored=True, num_fb=200, n_global=0, carry=True),
    **{f"reg_method{m}": dict(seed=5, reg_method=m, reg_global=m if m in (1, 4, 5) else 0)
       for m in range(6)},
    **{f"carry-reg_method{m}": dict(seed=5, carry=True, reg_method=m) for m in (1, 2, 3)},
}


@pytest.mark.parametrize("case", list(CASES))
def test_epoch_matches_jax(jx, case):
    """The port's train_epoch_plus_big against the JAX package's, 3 epochs:
    the entry-stream and the user-carry bodies, M=1 and 2, no_user_bias
    with the clamps, reg modes 0-5 (lazy refs exact), the factored
    overlap."""
    x = big_inputs(**CASES[case])
    got, want = run_port_big(x), run_jax_big(jx, x)
    assert_states_close(got, want)
    assert not np.allclose(got[0], x.st["w"])  # it trained


@pytest.mark.parametrize("case", ["noncarry", "carry-M1", "carry-M2", "factored-overlap"])
def test_big_epoch_matches_small(case):
    """The big epoch against the port's own small-table train_epoch_plus
    on the same inputs (JAX test_big_epoch_matches_small: rtol 1e-4,
    atol 1e-6)."""
    x = big_inputs(**CASES[case])
    got = run_port_big(x)
    state = convert.state_from_numpy(**x.st, device=CPU)
    hp = HyperParams(**x.hp)
    consts = convert.consts_from_numpy(**x.cs, device=CPU)
    stacked = convert.stacked_from_numpy(x.stacked, CPU)
    overlap = x.overlap
    if isinstance(overlap, dict):  # the small epoch takes the dense O
        from svdfeature_tpu_torch.data.batching_plus import compute_fb_overlap

        overlap = compute_fb_overlap(x.fb["fb_idx"], x.fb["fb_val"], x.fb["fb_block"], x.G)
    fb, overlap = convert.pool_from_numpy(
        {n: x.fb[n] for n in ("fb_idx", "fb_val", "fb_block")}, overlap, CPU)
    for _ in range(EPOCHS):
        state = train_epoch_plus(state, stacked, x.chunk_id, fb, overlap,
                                 torch.tensor(0.01), consts, hp, x.ph)
    want = tuple(a.numpy() for a in (state.w, state.b, state.ref_ui, state.g, state.step))
    assert_states_close(got, want, atol=1e-6, rtol=1e-4)


def _slots(rows):
    return np.asarray(rows, np.int64)


D = 99  # the dummy row of the plan cases
PLAN_CASES = {
    # [T, G, M] slot ids and the chunk ids of the T steps
    "classic": (_slots([[[1, 1], [2, D]], [[1, D], [2, 2]], [[5, 5], [D, D]]]), [0, 0, 1]),
    "mixed ids in a unit": (_slots([[[1, 3], [2, D]]]), [0]),
    "id changes in a chunk": (_slots([[[1, 1], [2, D]], [[4, D], [2, 2]]]), [0, 0]),
    "one user in two units": (_slots([[[1, 1], [1, D]]]), [0]),
    "same user in two chunks": (_slots([[[1, 1], [2, D]], [[1, D], [3, 3]]]), [0, 1]),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_carry_plan_matches_jax(jx, case):
    """``_chunk_users_from_slots`` accepts and refuses what the JAX
    package's does, with the same plan."""
    uid, cid = PLAN_CASES[case]
    got = _chunk_users_from_slots(uid, np.asarray(cid), D)
    want = jx.solver._chunk_users_from_slots(uid, np.asarray(cid), D)
    assert (got is None) == (want is None) == (case in ("mixed ids in a unit",
                                                        "id changes in a chunk",
                                                        "one user in two units"))
    if got is not None:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32


def _trainers(monkeypatch, jx, extra=None, text=None, forced=True):
    """A JAX and a port SVD++ trainer on the same conf (device=cpu for the
    port), both forced onto the big-table route when ``forced``."""
    from svdfeature_tpu.params import SVDTypeParam as JType
    from svdfeature_tpu_torch.params import SVDTypeParam as TType
    from svdfeature_tpu_torch.solvers import base as tbase
    from svdfeature_tpu_torch.solvers.svdpp import SVDPPFeatureTrainer

    if forced:
        monkeypatch.setattr(jx.embed, "ONEHOT_THRESHOLD", 4)
        monkeypatch.setattr(tbase, "BIG_TABLE_ROWS", 4)
    params = dict(num_user=10, num_item=12, num_ufeedback=15, num_global=3, num_factor=K,
                  base_score=3, learning_rate=0.01, wd_user=0.004, wd_item=0.004,
                  wd_ufeedback=0.003, wd_ufeedback_bias=0.002, users_per_batch=4)
    params.update(extra or {})
    out = []
    for cls, mtype, dev in ((jx.solver.SVDPPFeatureTrainer, JType(format_type=1), {}),
                            (SVDPPFeatureTrainer, TType(format_type=1), {"device": "cpu"})):
        tr = cls(mtype)
        for n, v in dict(params, **dev).items():
            tr.set_param(n, str(v))
        tr.init_model()
        tr.init_trainer()
        out.append(tr)
    return out


@pytest.mark.parametrize("case", ["classic", "reg_method4", "rows_per_user2-decay"])
def test_solver_routes_big_table(monkeypatch, jx, case):
    """With the big-table threshold forced to 4 rows both solvers take the
    augmented epoch (JAX test_solver_routes_big_table): update_rounds,
    predict_all on the de-augmented state and the checkpoint's tables
    agree, and the port's pack holds the carry plan where the JAX
    package's does."""
    extra = {"reg_method4": {"reg_method": 4},
             "rows_per_user2-decay": {"rows_per_user": 2, "decay_learning_rate": 1,
                                      "decay_rate": 0.9}}.get(case, {})
    jtr, ttr = _trainers(monkeypatch, jx, extra)
    assert ttr.hp.big_table and not ttr.hp.sweep_table and jtr.hp.big_table
    assert ttr.state.b.shape == (0,) and ttr.state.w.shape[1] == big_embed.aug_width(K)
    rows, fbs = synth_text(11)
    from svdfeature_tpu.data.text import load_plus_text as jload

    jds = jload("x", "y", text=rows, feedback_text=fbs)
    tds = load_plus_text("x", "y", text=rows, feedback_text=fbs)
    entry = ttr._pack_plus(tds)
    assert ("chunk_users" in entry.fb) == ("chunk_users" in jtr._pack_plus(jds)[2])
    assert ("chunk_users" in entry.fb) == (case != "reg_method4")
    jtr.update_rounds(jds, 2)
    before = cuda_scatter.row_writer.launches
    ttr.update_rounds(tds, 2)
    assert cuda_scatter.row_writer.launches == before  # CPU: the plain writer
    np.testing.assert_allclose(ttr.predict_all(tds), np.asarray(jtr.predict_all(jds)),
                               atol=1e-5, rtol=1e-4)
    jtr._sync_model_from_state()
    ttr._sync_model_from_state()
    for name in ("w", "b", "g"):
        np.testing.assert_allclose(getattr(ttr.model, name).numpy(),
                                   np.asarray(getattr(jtr.model, name)), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    assert ttr.learning_rate == pytest.approx(jtr.learning_rate)


def test_common_feedback_space_keeps_small_layout(monkeypatch, jx):
    """common_feedback_space=1 keeps the standard layout above the
    threshold (the JAX solver's rule) and trains on the per-batch refresh
    epoch there, as the JAX solver does: two rounds agree within 1e-5."""
    from svdfeature_tpu.data.text import load_plus_text as jload

    jtr, ttr = _trainers(monkeypatch, jx, {"common_feedback_space": 1, "num_ufeedback": 10})
    assert not ttr.hp.big_table and not jtr.hp.big_table
    assert ttr.state.b.shape[0] > 0
    rows, fbs = synth_text(9, fb_bound=10)
    jds = jload("x", "y", text=rows, feedback_text=fbs)
    tds = load_plus_text("x", "y", text=rows, feedback_text=fbs)
    before = cuda_scatter.row_writer.launches
    for _ in range(2):
        jtr.update_all(jds)
        ttr.update_all(tds)
    assert cuda_scatter.row_writer.launches == before
    for name in ("w", "b", "g"):
        np.testing.assert_allclose(getattr(ttr.state, name).numpy(),
                                   np.asarray(getattr(jtr.state, name)), atol=1e-5, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(ttr.predict_all(tds), np.asarray(jtr.predict_all(jds)),
                               atol=1e-5, rtol=0)


def test_factored_overlap_staged(monkeypatch, jx):
    """On a big table with sparse in-chunk duplication the pack stages the
    factored overlap (a dict of diag / dup) and trains as the JAX solver."""
    jtr, ttr = _trainers(monkeypatch, jx, {"num_ufeedback": 200, "num_global": 0})
    rows, fbs = synth_text(17, fb_bound=200, nfb=(1, 3), g_feats=False)
    from svdfeature_tpu.data.text import load_plus_text as jload

    jds = jload("x", "y", text=rows, feedback_text=fbs)
    tds = load_plus_text("x", "y", text=rows, feedback_text=fbs)
    entry = ttr._pack_plus(tds)
    assert isinstance(entry.fb_overlap, dict) and set(entry.fb_overlap) == {"diag", "dup"}
    assert isinstance(jtr._pack_plus(jds)[4], dict)
    jtr.update_rounds(jds, 3)
    ttr.update_rounds(tds, 3)
    np.testing.assert_allclose(ttr.predict_all(tds), np.asarray(jtr.predict_all(jds)),
                               atol=1e-5, rtol=1e-4)


# ---- the CLI slice on a big table ------------------------------------------
CLI_ROUNDS = 2
# 8100 feedback ids + 40 users + 100 items + the dummy: above the 8192
# rows where both solvers take the big-table route
CLI_CONF = """\
format_type = 1
num_user = 40
num_item = 100
num_ufeedback = 8100
num_global = 0
num_factor = 8
base_score = 3
learning_rate = 0.01
wd_user = 0.004
wd_item = 0.004
wd_ufeedback = 0.003
users_per_batch = 8
rows_per_user = 2
sort_blocks = 1
silent = 1
"""


def write_cli_sets(d, seed=0):
    """A user-group train set and a test set (its first 12 users) as
    buffers, through the port's make_ugroup_buffer."""
    from svdfeature_tpu_torch.cli import make_ugroup_buffer

    rng = np.random.RandomState(seed)
    rows, fbs = [], []
    for u in range(40):
        r = rng.randint(1, 7)
        rows += [f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 100)}:1" for _ in range(r)]
        nf = rng.randint(1, 5)
        fbs.append(f"{r} {nf} " + " ".join(f"{rng.randint(0, 8100)}:{rng.rand():.3f}"
                                            for _ in range(nf)))
    n_test = sum(int(line.split()[0]) for line in fbs[:12])
    for split, rr, ff in (("train", rows, fbs), ("test", rows[:n_test], fbs[:12])):
        (d / f"{split}.feature").write_text("\n".join(rr) + "\n")
        (d / f"{split}.feedback").write_text("\n".join(ff) + "\n")
        make_ugroup_buffer.main([str(d / f"{split}.feature"), str(d / f"{split}.buffer"),
                                 "-fd", str(d / f"{split}.feedback")])


@pytest.mark.parametrize("extra", ["", "use_pallas = 0\n", "reg_method = 4\n"])
def test_cli_slice_matches_jax(tmp_path, extra):
    """SVDTrainTask -> %04d.model per round -> SVDInferTask on a 8,241-row
    table, both packages (the port with device=cpu), 2 rounds: every
    round's eval RMSE agrees within 1e-5 and so does every checkpoint."""
    pytest.importorskip("jax")
    from svdfeature_tpu import model as jmodel
    from svdfeature_tpu.infer.task import SVDInferTask as JInfer
    from svdfeature_tpu.params import SVDTypeParam as JType
    from svdfeature_tpu.train.loop import SVDTrainTask as JTrain
    from svdfeature_tpu_torch.infer.task import SVDInferTask as TInfer
    from svdfeature_tpu_torch.train.loop import SVDTrainTask as TTrain

    write_cli_sets(tmp_path)
    rmse, models = {}, {}
    for tag, train_cls, infer_cls, dev in (("jax", JTrain, JInfer, []),
                                           ("torch", TTrain, TInfer, ["device=cpu"])):
        d = tmp_path / tag
        d.mkdir()
        (d / "t.conf").write_text(
            CLI_CONF + extra + f'buffer_feature = "{tmp_path}/train.buffer"\n'
            f'test:buffer_feature = "{tmp_path}/test.buffer"\nmodel_out_folder = "{d}/models"\n')
        task = train_cls()
        task.run(str(d / "t.conf"), [f"num_round={CLI_ROUNDS}", *dev])
        assert task.trainer.hp.big_table
        if tag == "torch":
            carry = "chunk_users" in task.trainer._pack_plus(task.dataset).fb
            assert carry == ("reg_method" not in extra)
        infer_cls().run(str(d / "t.conf"), ["start=0", f"end={CLI_ROUNDS + 1}",
                                            f"log_eval={d}/rmse.tsv", *dev])
        rmse[tag] = np.loadtxt(d / "rmse.tsv")
        models[tag] = []
        for r in range(CLI_ROUNDS + 1):
            with open(d / "models" / f"{r:04d}.model", "rb") as f:
                m = jmodel.SVDModel.load(f, JType.from_bytes(f.read(4)))
            models[tag].append({n: np.asarray(getattr(m, n)) for n in ("w", "b")})
    assert rmse["torch"].shape == (CLI_ROUNDS + 1, 2)
    np.testing.assert_allclose(rmse["torch"], rmse["jax"], atol=1e-5, rtol=0)
    for r in range(CLI_ROUNDS + 1):
        for n in ("w", "b"):
            np.testing.assert_allclose(models["torch"][r][n], models["jax"][r][n], atol=1e-5,
                                       rtol=0, err_msg=f"round {r} {n}")
    assert rmse["torch"][-1, 1] < rmse["torch"][0, 1]


def test_big_plus_arrays_match_bench(monkeypatch):
    """chip_smoke.big_plus_arrays (numpy only) equals bench.make_big_plus
    array for array at bench's small size (BENCH_SMALL=1)."""
    pytest.importorskip("jax")
    import importlib

    root = pathlib.Path(__file__).resolve().parent.parent
    monkeypatch.syspath_prepend(str(root))
    monkeypatch.setenv("BENCH_SMALL", "1")
    bench = importlib.import_module("bench")
    chip_smoke = importlib.import_module("chip_smoke")
    pds, dims = bench.make_big_plus()
    got, got_dims = chip_smoke.big_plus_arrays(small=True)
    assert got_dims == dims
    want = dict(labels=pds.rows.labels, row_ptr=pds.rows.row_ptr, index=pds.rows.index,
                value=pds.rows.value, fb_index=pds.fb_index, fb_value=pds.fb_value,
                block_row_ptr=pds.block_row_ptr, block_fb_ptr=pds.block_fb_ptr,
                extend_tag=pds.extend_tag, extra_info=pds.extra_info)
    assert set(got) == set(want)
    for name, a in want.items():
        assert got[name].dtype == a.dtype, name
        np.testing.assert_array_equal(got[name], a, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["noncarry", "carry-M2", "factored-overlap-carry", "reg_method4"])
def test_epoch_k5_matches_plain_on_card(case):
    """The big SVD++ epoch with K5 (row_dma) against its plain writer on the
    card, 3 epochs (index_add_ sums in a varying order: atol 1e-6 + rtol
    1e-5), with the launch count the plan implies
    (svdpp_big.k5_launches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m cuda tests/)")
    x = big_inputs(**CASES[case])
    dev = torch.device("cuda")
    before = cuda_scatter.row_writer.launches
    got = run_port_big(x, device=dev, row_dma=True)
    assert (cuda_scatter.row_writer.launches - before
            == EPOCHS * svdpp_big.k5_launches(x.chunk_id, x.carry))
    assert_states_close(got, run_port_big(x, device=dev))
