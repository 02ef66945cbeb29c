"""The port's bilinear solver (extend_type=15: ops/svdpp_bilinear.py,
solvers/bilinear.py) against the JAX package.

The same seeded numpy inputs go to both packages: the pack-time extras
(the pool filtered by start_ufeedback, the user properties, the overlap),
every epoch (the carried form, the refresh form under a shared feedback
space, the big-table form on the augmented layout with K5's plain version
on the CPU), the prediction, the checkpoints both ways, the registry and
the CLI slice.  State after R=2 rounds agrees within atol 1e-6 (1e-5 for
the big-table epoch, whose sorted dedup reorders sums).  K5 at an odd W_bi
width runs on the card only.
"""

import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import test_torch_svdpp as tsv
import test_torch_svdpp_big as tbig
from test_torch_refresh import follow_text

from svdfeature_tpu_torch import convert
from svdfeature_tpu_torch.data.batching_plus import compute_fb_overlap, pack_plus
from svdfeature_tpu_torch.data.text import load_plus_text
from svdfeature_tpu_torch.ops import big_embed, cuda_scatter, cuda_svdpp, fb_overlap, svdpp_bilinear
from svdfeature_tpu_torch.ops.embed import HyperParams
from svdfeature_tpu_torch.ops.svdpp import PlusHyper
from svdfeature_tpu_torch.ops.svdpp_bilinear import BiHyper
from svdfeature_tpu_torch.solvers.bilinear import SVDBiLinearTrainer

CPU = torch.device("cpu")
FBH = dict(scale_lr_ufeedback=1.0, wd_ufeedback=0.004, wd_ufeedback_bias=0.002)
BI = dict(slr_bi=0.8, wd_bi=0.01)
K = 8


def layout(kind, seed, M):
    """(packing, table rows with the dummy, global slots, items, (off_user,
    off_item)) of a synthetic case: the disjoint SVD++ layout of
    tests/test_torch_svdpp.py, the follow feedback of
    tests/test_torch_refresh.py (the pool is the user rows) or the tiny
    big-table layout of tests/test_torch_svdpp_big.py."""
    if kind == "small":
        rows, fbs = tsv.synth_text(seed, 1)
        nf, nu, ni, ng, G = tsv.NUM_FB, tsv.NUM_USER, tsv.NUM_ITEM, 0, 16
        offs = (nf, nf + nu)
    elif kind == "shared":
        rows, fbs = follow_text(seed)
        nf, nu, ni, ng, G = 40, 40, 100, 0, 16
        offs = (0, nu)
    else:
        rows, fbs = tbig.synth_text(seed, fb_bound=15)
        nf, nu, ni, ng, G = 15, 10, 12, 3, 4
        offs = (nf, nf + nu)
    n_rows = (0 if kind == "shared" else nf) + nu + ni
    ds = load_plus_text("x", "y", text=rows, feedback_text=fbs)
    packed = pack_plus(ds, G, n_rows, ng, offs[0], offs[1], 0, num_user=nu, num_item=ni,
                       num_ufeedback=nf, rows_per_user=M)
    return packed, n_rows + 1, ng, ni, offs


def extras_of(cls, packed, nbf, start):
    """``cls._bi_extras`` on a packing, with the conf's bilinear keys."""
    stub = SimpleNamespace(model=SimpleNamespace(off_ufeedback=0),
                           bparam=SimpleNamespace(num_bi_feedback=nbf, start_ufeedback=start))
    return cls._bi_extras(stub, packed)


def bi_inputs(kind="small", M=1, nbf=10, start=0, reg_bi=0, seed=0, hp=None):
    """numpy inputs of one case: state, consts, planes, the filtered pool,
    the overlap, ``up``, a seeded W_bi; 2 rounds at lr 0.01."""
    packed, N, ng, ni, (off_user, off_item) = layout(kind, seed, M)
    fb, up = extras_of(SVDBiLinearTrainer, packed, nbf, start)
    # the JAX solver's overlap: recomputed on the host from the filtered pool
    overlap = compute_fb_overlap(fb["fb_idx"], fb["fb_val"], fb["fb_block"],
                                 packed.num_blocks_local)
    rng = np.random.RandomState(seed + 1)
    w = rng.normal(0, 0.1, (N, K)).astype(np.float32)
    b = rng.normal(0, 0.01, N).astype(np.float32)
    w[-1] = b[-1] = 0.0
    wd_u = np.zeros(N, np.float32)
    wd_i = np.zeros(N, np.float32)
    wd_u[off_user:off_item] = 0.004
    wd_i[off_item:N - 1] = 0.004
    NG = ng + 1
    stacked = packed.device_arrays()
    return SimpleNamespace(
        st=dict(w=w, b=b, g=np.zeros(NG, np.float32), step=np.int32(0),
                ref_ui=np.zeros(N, np.int32), ref_g=np.zeros(NG, np.int32)),
        cs=dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=np.full(NG, 0.001, np.float32),
                wd_user_bias=np.float32(0.002), wd_item_bias=np.float32(0.003)),
        chunk_id=stacked.pop("chunk_id"), stacked=stacked, fb=fb, up=up, overlap=overlap,
        W_bi=rng.normal(0, 0.05, (ni, nbf)).astype(np.float32),
        lrs=np.full(2, 0.01, np.float32), hp=dict(base_score=3.0, **(hp or {})), M=M,
        bh=BiHyper(reg_bi=reg_bi, off_item=off_item, **BI),
        ph=PlusHyper(rows_per_user=M, off_user=off_user, **FBH))


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from svdfeature_tpu.ops import big_embed as jbig
    from svdfeature_tpu.ops import embed, svdpp_bilinear
    from svdfeature_tpu.solvers import bilinear

    return SimpleNamespace(jnp=jnp, embed=embed, big=jbig, bi=svdpp_bilinear, solver=bilinear)


def run_port(x, epoch, big=False):
    """R rounds of one of the port's epochs -> (state, W_bi) numpy, the state
    de-augmented."""
    state = convert.state_from_numpy(**x.st, device=CPU)
    hp = HyperParams(**x.hp)
    if big:
        state = big_embed.augment_state(state, K)
        hp = HyperParams(big_table=True, num_factor=K, **x.hp)
    W, up = convert.bilinear_from_numpy(x.W_bi, x.up, CPU)
    fb, overlap = convert.pool_from_numpy(x.fb, x.overlap, CPU)
    args = (convert.stacked_from_numpy(x.stacked, CPU), x.chunk_id, fb)
    args += (up,) if epoch == "refresh" else (overlap, up)
    fn = dict(carried=svdpp_bilinear.train_epoch_bi, big=svdpp_bilinear.train_epoch_bi_big,
              refresh=svdpp_bilinear.train_epoch_bi_refresh)[epoch]
    for lr in torch.tensor(x.lrs):
        state = fn(state, W, *args, lr, convert.consts_from_numpy(**x.cs, device=CPU), hp, x.ph,
                   x.bh)
    if big:
        state = big_embed.deaugment_state(state, K)
    return {n: getattr(state, n).numpy() for n in ("w", "b", "g", "ref_ui", "step")}, \
        W[:-1].numpy(), state


def run_jax(jx, x, epoch, big=False):
    jnp = jx.jnp
    tree = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    state = jx.embed.TrainState(**tree(x.st))
    hp = jx.embed.HyperParams(**x.hp)
    if big:
        state = jx.big.augment_state(state, K)
        hp = jx.embed.HyperParams(big_table=True, num_factor=K, **x.hp)
    args = ({k: jnp.asarray(v) for k, v in x.stacked.items()}, jnp.asarray(x.chunk_id), tree(x.fb))
    args += (jnp.asarray(x.up),) if epoch == "refresh" else (jnp.asarray(x.overlap),
                                                              jnp.asarray(x.up))
    fn = dict(carried=jx.bi.train_epoch_bi, big=jx.bi.train_epoch_bi_big,
              refresh=jx.bi.train_epoch_bi_refresh)[epoch]
    W = jnp.asarray(x.W_bi)
    for lr in x.lrs:
        state, W = fn(state, W, *args, jnp.float32(lr), jx.embed.TrainConsts(**tree(x.cs)), hp,
                      *FBH.values(), x.bh.slr_bi, x.bh.wd_bi, reg_bi=x.bh.reg_bi,
                      off_item=x.bh.off_item, rows_per_user=x.M)
    if big:
        state = jx.big.deaugment_state(state, K)
    return {n: np.asarray(getattr(state, n)) for n in ("w", "b", "g", "ref_ui", "step")}, \
        np.asarray(W)


def assert_close(got, want, x, atol):
    (gs, gW), (js, jW) = got[:2], want
    for name in ("w", "b", "g"):
        np.testing.assert_allclose(gs[name], js[name], atol=atol, rtol=0, err_msg=name)
    np.testing.assert_allclose(gW, jW, atol=atol, rtol=0, err_msg="W_bi")
    assert np.array_equal(gs["ref_ui"], js["ref_ui"]) and int(gs["step"]) == int(js["step"])
    assert not np.allclose(gW, x.W_bi)  # W_bi trained


CASES = {
    "reg0-start0-M1": dict(reg_bi=0),
    "reg1-start5-M4": dict(reg_bi=1, start=5, M=4),
    "reg2-start0-M4-nub": dict(reg_bi=2, M=4, hp=dict(no_user_bias=1)),
    "reg3-start5-M1": dict(reg_bi=3, start=5),
    "reg4-start0-M4-lazy": dict(reg_bi=4, M=4, hp=dict(reg_method=4)),
    "reg5-start5-M1-nonneg": dict(reg_bi=5, start=5, hp=dict(user_nonnegative=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_carried_epoch_matches_jax(jx, case):
    """train_epoch_bi against the JAX package's, R=2 (atol 1e-6)."""
    x = bi_inputs(**CASES[case])
    assert_close(run_port(x, "carried"), run_jax(jx, x, "carried"), x, 1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_refresh_epoch_matches_jax(jx, case):
    """train_epoch_bi_refresh under a shared feedback space against the
    JAX package's, R=2 (atol 1e-6)."""
    x = bi_inputs("shared", **CASES[case])
    assert_close(run_port(x, "refresh"), run_jax(jx, x, "refresh"), x, 1e-6)


BIG_CASES = {
    "reg0-M1": dict(reg_bi=0),
    "reg1-start5-M2": dict(reg_bi=1, start=5, M=2, seed=3),
    "reg2-M1": dict(reg_bi=2, seed=5),
    "reg3-start5-M2": dict(reg_bi=3, start=5, M=2),
    "reg4-M1-lazy": dict(reg_bi=4, seed=7, hp=dict(reg_method=4, reg_global=4)),
    "reg5-start5-M2-nub": dict(reg_bi=5, start=5, M=2, hp=dict(no_user_bias=1)),
}


@pytest.mark.parametrize("case", list(BIG_CASES))
def test_big_epoch_matches_jax(jx, case):
    """train_epoch_bi_big (K5's plain version on the CPU) against the JAX
    package's on the augmented layout, R=2 (atol 1e-5: sorted-dedup sums)."""
    x = bi_inputs("big", nbf=7, **BIG_CASES[case])
    before = cuda_scatter.row_writer.launches
    got = run_port(x, "big", big=True)
    assert cuda_scatter.row_writer.launches == before
    assert_close(got, run_jax(jx, x, "big", big=True), x, 1e-5)


@pytest.mark.parametrize("kind,start", [("small", 0), ("small", 5), ("shared", 4), ("big", 6)])
def test_bi_extras_match_jax(jx, kind, start):
    """The filtered pool and the user properties of a packing equal the JAX
    solver's, and the overlap built from that pool on the device equals the
    one it recomputes on the host, within float32 summation order."""
    packed = layout(kind, 2, 2)[0]
    got = extras_of(SVDBiLinearTrainer, packed, 9, start)
    want = extras_of(jx.solver.SVDBiLinearTrainer, packed, 9, start)
    for name in got[0]:
        assert np.array_equal(got[0][name], want[0][name]), name
    assert np.array_equal(got[1], want[1]) and got[1].any()
    pool, _ = convert.pool_from_numpy(got[0], None, CPU)
    built = fb_overlap.build(pool, packed.num_blocks_local, factored=False)
    # the copy's f32 product against build()'s float64 one, rounded once
    np.testing.assert_allclose(built.numpy(), want[2], rtol=1e-6, atol=1e-7)
    if start:
        assert not np.array_equal(got[0]["fb_val"], packed.fb_val)


def test_predict_matches_jax(jx):
    """predict_batches_bi on a trained state against the JAX package's."""
    x = bi_inputs(M=4, start=5, reg_bi=1)
    _, _, state = run_port(x, "carried")
    W, up = convert.bilinear_from_numpy(x.W_bi, x.up, CPU)
    fb, _ = convert.pool_from_numpy(x.fb, None, CPU)
    got = svdpp_bilinear.predict_batches_bi(state, W, convert.stacked_from_numpy(x.stacked, CPU),
                                            x.chunk_id, fb, up, HyperParams(**x.hp),
                                            x.bh.off_item, x.M).numpy()
    jnp = jx.jnp
    want = jx.bi.predict_batches_bi(
        jx.embed.TrainState(**{n: jnp.asarray(getattr(state, n).numpy()) for n in
                               ("w", "b", "g", "step", "ref_ui", "ref_g")}),
        jnp.asarray(x.W_bi), {k: jnp.asarray(v) for k, v in x.stacked.items()},
        jnp.asarray(x.chunk_id), {k: jnp.asarray(v) for k, v in x.fb.items()}, jnp.asarray(x.up),
        jx.embed.HyperParams(**x.hp), x.bh.off_item, rows_per_user=x.M)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)


def test_empty_property_space_is_plain_svdpp():
    """With nbf = 0 the carried epoch is the port's plain SVD++ rounds, bit
    for bit (COMPONENTS.md #10: the plugin adds exactly 0)."""
    x = bi_inputs(M=2, nbf=0)
    got, _, _ = run_port(x, "carried")
    fb, overlap = convert.pool_from_numpy(x.fb, x.overlap, CPU)
    out = cuda_svdpp.train_rounds_svdpp_reference(
        convert.state_from_numpy(**x.st, device=CPU), convert.stacked_from_numpy(x.stacked, CPU),
        x.chunk_id, fb, overlap, torch.tensor(x.lrs), convert.consts_from_numpy(**x.cs, device=CPU),
        HyperParams(**x.hp), x.ph)
    for name in ("w", "b", "g", "step"):
        assert np.array_equal(got[name], getattr(out, name).numpy()), name


# ---- the solver ----------------------------------------------------------------
PARAMS = dict(num_user=tsv.NUM_USER, num_item=tsv.NUM_ITEM, num_ufeedback=tsv.NUM_FB,
              num_factor=K, base_score=3, learning_rate=0.01, wd_user=0.004, wd_item=0.004,
              wd_ufeedback=0.004, users_per_batch=16, rows_per_user=2, num_bi_feedback=10,
              start_ufeedback=3, reg_bi_feedback=1, wd_bi_feedback=0.01, slr_bi_feedback=0.5)


def trainers(jx, extra=None, port_only=False):
    """A JAX and a port bilinear trainer on one conf (the port on the CPU)."""
    from svdfeature_tpu_torch.params import SVDTypeParam as TType

    pairs = [(SVDBiLinearTrainer, TType, {"device": "cpu"})]
    if not port_only:
        from svdfeature_tpu.params import SVDTypeParam as JType

        pairs.insert(0, (jx.solver.SVDBiLinearTrainer, JType, {}))
    out = []
    for cls, mtype, dev in pairs:
        tr = cls(mtype(format_type=1, extend_type=15))
        for n, v in dict(PARAMS, **(extra or {}), **dev).items():
            tr.set_param(n, str(v))
        tr.init_model()
        tr.init_trainer()
        out.append(tr)
    return out


def plus_data(jload=None, seed=0):
    rows, fbs = tsv.synth_text(seed, 1)
    return (jload or load_plus_text)("x", "y", text=rows, feedback_text=fbs)


def test_checkpoints_byte_compatible_both_ways(jx):
    """A port-saved BModel loads in the JAX trainer with equal arrays and
    the reverse; each package re-saves the other's checkpoint to the same
    bytes."""
    from svdfeature_tpu.data.text import load_plus_text as jload

    jtr, ttr = trainers(jx)
    jtr.update_all(plus_data(jload))
    ttr.update_all(plus_data())
    saved = {}
    for tag, tr in (("jax", jtr), ("torch", ttr)):
        buf = io.BytesIO()
        tr.save_model(buf)
        saved[tag] = buf.getvalue()
    for src, dst_tr in (("torch", trainers(jx)[0]), ("jax", trainers(jx, port_only=True)[0])):
        dst_tr.load_model(io.BytesIO(saved[src]))
        dst_tr.init_trainer()  # the state from the loaded model, as the infer task makes it
        assert dst_tr.bparam.num_bi_feedback == 10 and dst_tr.bparam.start_ufeedback == 3
        src_tr = ttr if src == "torch" else jtr
        for name in ("w", "b", "g"):
            assert np.array_equal(np.asarray(getattr(dst_tr.model, name)),
                                  np.asarray(getattr(src_tr.model, name))), name
        W_src = np.asarray(src_tr.W_bi)[:tsv.NUM_ITEM]
        assert np.array_equal(np.asarray(dst_tr.W_bi)[:tsv.NUM_ITEM], W_src) and W_src.any()
        buf = io.BytesIO()
        dst_tr.save_model(buf)
        assert buf.getvalue() == saved[src]


def test_registry():
    """extend_type=15 makes the bilinear trainer; 30 and 31, which train now,
    make the GBRT trainers (APLambda, Reg), as the JAX registry does."""
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.gbrt import APLambdaGBRTTrainer, RegGBRTTrainer
    from svdfeature_tpu_torch.solvers.registry import create_svd_trainer

    assert type(create_svd_trainer(SVDTypeParam(format_type=1, extend_type=15))) \
        is SVDBiLinearTrainer
    for et, cls in ((30, APLambdaGBRTTrainer), (31, RegGBRTTrainer)):
        assert type(create_svd_trainer(SVDTypeParam(format_type=1, extend_type=et))) is cls


@pytest.mark.parametrize("extra", [{}, {"common_feedback_space": 1, "num_ufeedback": 30}],
                         ids=["carried", "shared-space"])
def test_solver_matches_jax_and_never_takes_k2(jx, extra):
    """update_rounds and predict_all of both solvers agree (atol 1e-6), with
    use_pallas set; the port's K2 and K3 counts stay 0 and its trainer
    never asks K2's gate."""
    from svdfeature_tpu.data.text import load_plus_text as jload
    from svdfeature_tpu_torch.ops import cuda_imfb

    jtr, ttr = trainers(jx, extra)
    assert ttr.use_pallas and not ttr._kernel_ok(None, None)
    before = (cuda_svdpp.train_rounds_svdpp_kernel.launches,
              cuda_imfb.train_rounds_imfb_kernel.launches)
    jds, tds = plus_data(jload), plus_data()
    jtr.update_rounds(jds, 2)
    ttr.update_rounds(tds, 2)
    assert (cuda_svdpp.train_rounds_svdpp_kernel.launches,
            cuda_imfb.train_rounds_imfb_kernel.launches) == before
    np.testing.assert_allclose(ttr.predict_all(tds), np.asarray(jtr.predict_all(jds)), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(ttr.W_bi[:-1].numpy(), np.asarray(jtr.W_bi), atol=1e-6, rtol=0)


def test_solver_routes_big_table(monkeypatch, jx):
    """With the big-table thresholds forced to 4 rows both solvers take the
    big epoch (the port with the factored overlap it stages for big SVD++,
    the JAX solver with the dense one): 2 rounds agree within 1e-5."""
    from svdfeature_tpu.data.text import load_plus_text as jload
    from svdfeature_tpu_torch.solvers import base as tbase

    monkeypatch.setattr(jx.embed, "ONEHOT_THRESHOLD", 4)
    monkeypatch.setattr(tbase, "BIG_TABLE_ROWS", 4)
    extra = dict(num_ufeedback=200, num_bi_feedback=12, users_per_batch=8)
    jtr, ttr = trainers(jx, extra)
    assert ttr.hp.big_table and jtr.hp.big_table
    rows, fbs = tbig.synth_text(17, n_users=tsv.NUM_USER, fb_bound=200, nfb=(1, 3),
                                g_feats=False)
    jds = jload("x", "y", text=rows, feedback_text=fbs)
    tds = load_plus_text("x", "y", text=rows, feedback_text=fbs)
    assert isinstance(ttr._pack_plus(tds).fb_overlap, dict)
    for _ in range(2):
        jtr.update_all(jds)
        ttr.update_all(tds)
    np.testing.assert_allclose(ttr.predict_all(tds), np.asarray(jtr.predict_all(jds)), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(ttr.W_bi[:-1].numpy(), np.asarray(jtr.W_bi), atol=1e-5, rtol=0)


def test_sort_blocks_ignored_as_in_jax():
    """The staged pack is in file order whatever sort_blocks says, as the
    JAX solver's (solvers/bilinear.py:195-209 passes none): with nbf = 0
    and sort_blocks=1 the solver equals plain SVD++ at sort_blocks=0, bit
    for bit, and differs from plain SVD++ at sort_blocks=1."""
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.svdpp import SVDPPFeatureTrainer

    ds = plus_data()
    preds = {}
    for tag, cls, sort in (("bi", SVDBiLinearTrainer, 1), ("svdpp0", SVDPPFeatureTrainer, 0),
                           ("svdpp1", SVDPPFeatureTrainer, 1)):
        tr = cls(SVDTypeParam(format_type=1, extend_type=15 if tag == "bi" else 1))
        for n, v in dict(PARAMS, num_bi_feedback=0, start_ufeedback=0, sort_blocks=sort,
                         use_pallas=0, device="cpu").items():
            tr.set_param(n, str(v))
        tr.init_model()
        tr.init_trainer()
        tr.update_rounds(ds, 2)
        preds[tag] = tr.predict_all(ds)
    assert np.array_equal(preds["bi"], preds["svdpp0"])
    assert not np.array_equal(preds["bi"], preds["svdpp1"])


@pytest.mark.parametrize("extra", ["", "common_feedback_space = 1\nnum_ufeedback = 30\n"],
                         ids=["carried", "shared-space"])
def test_cli_slice_matches_jax(extra, tmp_path):
    """make_ugroup_buffer -fd -> SVDTrainTask (extend_type=15) -> %04d.model
    -> SVDInferTask eval and pred, both packages: checkpoints, every
    round's RMSE (each package reading the other's models too) and the
    pred output agree within 1e-5."""
    tsv._cli_slice(tmp_path, "extend_type = 15\nnum_bi_feedback = 10\nstart_ufeedback = 3\n"
                   "reg_bi_feedback = 2\nwd_bi_feedback = 0.01\n" + extra)
    for tag, dev in (("jax", []), ("torch", ["device=cpu"])):
        d = tmp_path / tag
        infer = __import__(f"svdfeature_tpu{'_torch' if tag == 'torch' else ''}.infer.task",
                           fromlist=["SVDInferTask"]).SVDInferTask
        infer().run(str(d / "t.conf"), [f"pred={tsv.ROUNDS}", f"name_pred={d}/pred.txt",
                                        "silent=1", *dev])
    np.testing.assert_allclose(np.loadtxt(tmp_path / "torch" / "pred.txt"),
                               np.loadtxt(tmp_path / "jax" / "pred.txt"), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nbf", [7, 1682])
def test_k5_at_odd_w_bi_width_on_card(nbf):
    """K5 bit for bit against its plain version at W_bi widths that are
    not a multiple of 4 (its scalar path, csrc/row_scatter.cu) and the
    ML-100K item-item width 1682, with one launch, on a dedup write of one
    step (unique rows, duplicates as zeros to the dummy row)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest --noconftest -m cuda)")
    rng = np.random.RandomState(3)
    ni, E = 1682, 2048
    W = rng.normal(0, 0.1, (ni + 1, nbf)).astype(np.float32)
    W[-1] = 0.0
    rows = rng.permutation(ni)[:E // 2]
    idx = np.full(E, ni, np.int32)
    pos = rng.permutation(E)[:E // 2]
    idx[pos] = rows
    vals = rng.normal(0, 0.1, (E, nbf)).astype(np.float32)
    vals[idx == ni] = 0.0
    dev = torch.device("cuda")
    w, i, v = (torch.from_numpy(a).to(dev) for a in (W, idx, vals))
    before = cuda_scatter.row_writer.launches
    got = cuda_scatter.row_writer(w.clone(), i, v)
    torch.cuda.synchronize()
    assert cuda_scatter.row_writer.launches == before + 1
    want = cuda_scatter.row_writer_reference(w.clone(), i, v)
    assert torch.equal(got, want)
