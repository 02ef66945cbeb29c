"""The port's stacked multi-IMFB path (ops/imfb.py, ops/cuda_imfb.py,
solvers/multi_imfb.py) against the JAX package.

Inputs are packed once with the port's copy of ``pack_imfb`` (byte-
identical to the JAX package's, checked here on the depth-2 ML-100K set)
and handed as the same numpy arrays to both packages.  On the CPU the
plain PyTorch version is held against the f32 jnp
``train_epoch_imfb_carried`` and against the TPU kernel
``train_rounds_imfb_pallas`` run in interpret mode, on seeded synthetic
depth-2 stacked sets (START with the user's feedback and the first half of
its rows, a DEFAULT sub-block with half the feedback and the rest, END);
the whole CLI slice is held against the JAX CLI.  The CUDA kernel is held
against the plain version on the card only.
"""

import dataclasses
import gzip
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svdfeature_tpu_torch import convert
from svdfeature_tpu_torch.data.batching_imfb import pack_imfb
from svdfeature_tpu_torch.data.batching_plus import compute_fb_overlap
from svdfeature_tpu_torch.data.csr import TAG_END, TAG_START
from svdfeature_tpu_torch.data.csr import PlusBlock as _PlusBlock
from svdfeature_tpu_torch.data.csr import PlusDataset as _PlusDataset
from svdfeature_tpu_torch.data.text import load_plus_text
from svdfeature_tpu_torch.ops import _plans, cuda_imfb
from svdfeature_tpu_torch.ops.embed import HyperParams
from svdfeature_tpu_torch.ops.imfb import predict_batches_imfb
from svdfeature_tpu_torch.ops.svdpp import PlusHyper
from svdfeature_tpu_torch.params import SVDTypeParam, svd_type
from svdfeature_tpu_torch.solvers.multi_imfb import SVDPPMultiIMFBTrainer

CPU = torch.device("cpu")
FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
# the synthetic layout: feedback rows [0, 25), users [25, 65), items [65, 165), dummy 165
NUM_FB, NUM_USER, NUM_ITEM = 25, 40, 100
FBH = dict(scale_lr_ufeedback=1.0, wd_ufeedback=0.004, wd_ufeedback_bias=0.002)
ML100K = dict(N=1682 + 943 + 1682 + 1, off_user=1682, off_item=2625)


def stack_depth2(ds, csr=None):
    """The depth-2 transform of the stacked golden (tests/test_golden_full.py
    _stack_depth2): per block of two rows or more, START (its feedback, the
    first half of its rows), a DEFAULT sub-block (half its feedback, the
    rest) and END (its feedback, no rows).  ``csr``: the module whose
    PlusBlock / PlusDataset build it (default the port's)."""
    PlusBlock, PlusDataset = (csr.PlusBlock, csr.PlusDataset) if csr else (_PlusBlock, _PlusDataset)
    blocks = []
    for blk in ds.blocks():
        n = blk.data.num_row
        if n >= 2:
            h = n // 2
            half = max(1, len(blk.fb_index) // 2)
            blocks += [
                PlusBlock(blk.fb_index, blk.fb_value, blk.data.slice_rows(0, h),
                          extend_tag=TAG_START),
                PlusBlock(blk.fb_index[:half], blk.fb_value[:half], blk.data.slice_rows(h, n - h)),
                PlusBlock(blk.fb_index, blk.fb_value, blk.data.slice_rows(n, 0), extend_tag=TAG_END),
            ]
        else:
            blocks.append(blk)
    return PlusDataset.from_blocks(blocks)


def synth_text(seed, n_users=NUM_USER):
    """(rows, feedback) text of a user-group set: 1-5 rows per user, 2-6
    feedback ids each."""
    rng = np.random.RandomState(seed)
    rows, fbs = [], []
    for u in range(n_users):
        r = rng.randint(1, 6)
        for _ in range(r):
            rows.append(f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, NUM_ITEM)}:1")
        nf = rng.randint(2, 7)
        ids = rng.choice(NUM_FB, size=nf, replace=False)
        fbs.append(f"{r} {nf} " + " ".join(f"{j}:{0.3 + 0.1 * (j % 3):.1f}" for j in ids))
    return "\n".join(rows) + "\n", "\n".join(fbs) + "\n"


def enabled_of(ctx_depth, levels=()):
    """The trainer's update gate of a packing, with depths ``levels`` disabled."""
    tr = SVDPPMultiIMFBTrainer(SVDTypeParam(format_type=svd_type.USER_GROUP_FORMAT, extend_type=2))
    tr.disable_levels = set(levels)
    return tr._imfb_enabled(ctx_depth)


def case_arrays(packed, N, k, off_user, off_item, seed, levels=(), wd_bias=0.002):
    """numpy (state, consts, stacked, chunk_id, fb, overlap, enabled) of a
    packing, with seeded factors and biases."""
    rng = np.random.RandomState(seed)
    w = rng.normal(0, 0.1 if k == 8 else 0.01, (N, k)).astype(np.float32)
    b = rng.normal(0, 0.01, (N,)).astype(np.float32)
    w[-1] = 0.0
    b[-1] = 0.0
    wd_u = np.zeros(N, np.float32)
    wd_i = np.zeros(N, np.float32)
    wd_u[off_user:off_item] = 0.004
    wd_i[off_item:N - 1] = 0.004
    stacked = packed.device_arrays()
    return dict(
        st=dict(w=w, b=b, g=np.zeros(1, np.float32), step=np.int32(0),
                ref_ui=np.zeros(N, np.int32), ref_g=np.zeros(1, np.int32)),
        cs=dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=np.zeros(1, np.float32),
                wd_user_bias=np.float32(wd_bias), wd_item_bias=np.float32(wd_bias)),
        chunk_id=stacked.pop("chunk_id"), stacked=stacked, fb=packed.fb_arrays(),
        overlap=compute_fb_overlap(packed.fb_idx, packed.fb_val, packed.fb_ctx,
                                   packed.ctx_depth.shape[1]),
        enabled=enabled_of(packed.ctx_depth, levels))


def imfb_inputs(rows_per_user=1, no_user_bias=0, ufeedback_disable_level=None, seed=0, R=2):
    """One synthetic depth-2 case: 8 units per step, k=8."""
    rows, fbs = synth_text(seed)
    ds = stack_depth2(load_plus_text("x", "y", text=rows, feedback_text=fbs))
    N = NUM_FB + NUM_USER + NUM_ITEM + 1
    off_user, off_item = NUM_FB, NUM_FB + NUM_USER
    packed = pack_imfb(ds, 8, N - 1, 0, off_user, off_item, 0, num_user=NUM_USER,
                       num_item=NUM_ITEM, num_ufeedback=NUM_FB, rows_per_user=rows_per_user)
    assert packed.fb_idx.shape[0] >= 3 and packed.ctx_slots.shape[-1] == 2
    levels = () if ufeedback_disable_level is None else (ufeedback_disable_level,)
    x = case_arrays(packed, N, 8, off_user, off_item, seed + 1, levels)
    return SimpleNamespace(
        **x, lrs=np.full((R,), 0.01, np.float32), off_item=off_item,
        hp=dict(active_type=0, no_user_bias=no_user_bias, base_score=3.0),
        ph=PlusHyper(rows_per_user=rows_per_user, off_user=off_user, **FBH))


def torch_args(x, device=CPU):
    """The port's (state, stacked, chunk_id, fb, overlap, enabled, lrs, consts, hp, ph)."""
    fb, overlap = convert.pool_from_numpy(x.fb, x.overlap, device)
    return (convert.state_from_numpy(**x.st, device=device),
            convert.stacked_from_numpy(x.stacked, device), x.chunk_id, fb, overlap,
            convert.gate_from_numpy(x.enabled, device), torch.tensor(x.lrs, device=device),
            convert.consts_from_numpy(**x.cs, device=device), HyperParams(**x.hp), x.ph)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here and not at the top: a GPU host
    without JAX still collects this file and runs the card case."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from svdfeature_tpu.ops import embed, imfb, pallas_svdpp

    return SimpleNamespace(jnp=jnp, pltpu=pltpu, embed=embed, imfb=imfb,
                           pallas_svdpp=pallas_svdpp)


def jax_args(jx, x):
    """The same arrays as the JAX package's (state, stacked, chunk_id, fb,
    overlap, enabled, consts, hp)."""
    jnp = jx.jnp
    return (jx.embed.TrainState(**{k: jnp.asarray(v) for k, v in x.st.items()}),
            {k: jnp.asarray(v) for k, v in x.stacked.items()}, jnp.asarray(x.chunk_id),
            {k: jnp.asarray(v) for k, v in x.fb.items()}, jnp.asarray(x.overlap),
            jnp.asarray(x.enabled),
            jx.embed.TrainConsts(**{k: jnp.asarray(v) for k, v in x.cs.items()}),
            jx.embed.HyperParams(**x.hp))


def jax_epochs(jx, x):
    """R rounds of the f32 jnp train_epoch_imfb_carried."""
    state, stacked, cid, fb, overlap, enabled, consts, hp = jax_args(jx, x)
    for lr in x.lrs:
        state = jx.imfb.train_epoch_imfb_carried(
            state, stacked, cid, fb, overlap, enabled, jx.jnp.float32(lr), consts, hp,
            x.ph.scale_lr_ufeedback, x.ph.wd_ufeedback, x.ph.wd_ufeedback_bias,
            rows_per_user=x.ph.rows_per_user)
    return state


def _plain(x):
    out = cuda_imfb.train_rounds_imfb_reference(*torch_args(x))
    return {n: getattr(out, n).numpy() for n in ("w", "b")}, int(out.step)


CASES = {
    "base": {},
    "no_user_bias": dict(no_user_bias=1),
    "disable_level1": dict(ufeedback_disable_level=1),
    "rows_per_user2": dict(rows_per_user=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_epoch(jx, case):
    """R=2 rounds of the plain version against R calls of the f32 jnp
    train_epoch_imfb_carried (atol 1e-6: the two differ only in summation
    order)."""
    x = imfb_inputs(**CASES[case])
    got, step = _plain(x)
    state = jax_epochs(jx, x)
    for name in ("w", "b"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(state, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    assert step == int(state.step) == 2 * int((x.stacked["weight"] > 0).sum())
    assert not np.allclose(got["w"][:NUM_FB], x.st["w"][:NUM_FB])  # the pool rows trained
    assert got["w"][-1].tolist() == [0.0] * 8 and got["b"][-1] == 0


# what K3 refuses and the plain rounds train: reg modes 1 and 4 (with
# their global modes), the clamps, the smooth hinge, all with a global
# segment (tests/test_torch_svdpp.with_general)
GENERAL_CASES = {
    "reg1-global1": dict(reg_method=1, reg_global=1),
    "reg4-global4": dict(reg_method=4, reg_global=4),
    "nonneg": dict(user_nonnegative=1, item_nonnegative=1),
    "hinge5": dict(active_type=5, base_score=0.5),
}


@pytest.mark.parametrize("rows_per_user", [1, 2])
@pytest.mark.parametrize("case", list(GENERAL_CASES))
def test_plain_general_matches_jax_epoch(jx, case, rows_per_user):
    """R=2 plain rounds against R calls of the f32 jnp
    train_epoch_imfb_carried on the configurations only the plain rounds
    take (atol 1e-6, as above): w, b, g, the lazy refs and the step."""
    from test_torch_svdpp import with_general

    x = with_general(imfb_inputs(rows_per_user), GENERAL_CASES[case])
    out = cuda_imfb.train_rounds_imfb_reference(*torch_args(x))
    state = jax_epochs(jx, x)
    for name in ("w", "b", "g"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(state, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    for name in ("ref_ui", "ref_g", "step"):
        assert np.array_equal(getattr(out, name).numpy(), np.asarray(getattr(state, name))), name
    assert not np.allclose(out.g.numpy(), x.st["g"])  # the global segment trained
    assert not np.allclose(out.w.numpy()[:NUM_FB], x.st["w"][:NUM_FB])


@pytest.mark.parametrize("case", ["base", "rows_per_user2"])
def test_plain_matches_pallas_interpret(jx, case):
    """The plain version against the TPU kernel K3 in interpret mode, to
    the tolerance tests/test_pallas_svdpp.py holds that kernel to against
    the jnp path (w 2e-4 / b 5e-4, rtol 1e-3): it reads tables and
    payloads in bf16, and that rounding is the whole difference."""
    x = imfb_inputs(**CASES[case])
    got, step = _plain(x)
    state, stacked, cid, fb, overlap, enabled, consts, hp = jax_args(jx, x)
    with jx.pltpu.force_tpu_interpret_mode():
        out = jx.pallas_svdpp.train_rounds_imfb_pallas(
            state, stacked, cid, fb, overlap, enabled, jx.jnp.asarray(x.lrs), consts, hp,
            NUM_FB, x.off_item, *FBH.values(), rows_per_user=x.ph.rows_per_user)
    np.testing.assert_allclose(got["w"], np.asarray(out.w), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got["b"], np.asarray(out.b), atol=5e-4, rtol=1e-3)
    assert step == int(out.step)


@pytest.mark.parametrize("no_user_bias", [0, 1])
def test_predict_matches_jax(jx, no_user_bias):
    """predict_batches_imfb against the JAX package's on trained tables
    (atol 1e-6)."""
    x = imfb_inputs(no_user_bias=no_user_bias)
    args = torch_args(x)
    st = cuda_imfb.train_rounds_imfb_reference(*args)
    got = predict_batches_imfb(st, args[1], x.chunk_id, args[3], args[8]).numpy()
    jstate = jx.embed.TrainState(
        w=jx.jnp.asarray(st.w.numpy()), b=jx.jnp.asarray(st.b.numpy()),
        g=jx.jnp.asarray(st.g.numpy()), step=jx.jnp.asarray(int(st.step)),
        ref_ui=jx.jnp.asarray(st.ref_ui.numpy()), ref_g=jx.jnp.asarray(st.ref_g.numpy()))
    _, stacked, cid, fb, _, _, _, hp = jax_args(jx, x)
    want = np.asarray(jx.imfb.predict_batches_imfb(jstate, stacked, cid, fb, hp))
    assert got.shape == want.shape == x.stacked["label"].shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _ml100k_text():
    def text(name):
        with gzip.open(FIXTURES / name, "rt") as f:
            return f.read()

    return dict(text=text("ml100k.base.group.feature.gz"),
                feedback_text=text("ml100k.base.feedback.gz"))


@pytest.fixture(scope="module")
def ml100k_depth2():
    """The ML-100K implicitFeedback training set in the depth-2 transform."""
    return stack_depth2(load_plus_text("x", "y", **_ml100k_text()))


def _pack_ml100k(pack, ds, rows_per_user):
    return pack(ds, 128, ML100K["N"] - 1, 0, ML100K["off_user"], ML100K["off_item"], 0,
                num_user=943, num_item=1682, num_ufeedback=1682, rows_per_user=rows_per_user)


@pytest.mark.parametrize("rows_per_user,T", [(8, 449), (1, 3536)])
def test_pack_imfb_identical(ml100k_depth2, rows_per_user, T):
    """pack_imfb of the depth-2 ML-100K set: every plane, pool and
    permutation byte-identical between the packages."""
    pytest.importorskip("jax")
    from svdfeature_tpu.data import csr as jcsr
    from svdfeature_tpu.data.batching_imfb import pack_imfb as jpack
    from svdfeature_tpu.data.text import load_plus_text as jload

    # the JAX package packs its own parse and transform of the same text
    jds = stack_depth2(jload("x", "y", **_ml100k_text()), jcsr)
    tp = _pack_ml100k(pack_imfb, ml100k_depth2, rows_per_user)
    jp = _pack_ml100k(jpack, jds, rows_per_user)
    ta, ja = dataclasses.asdict(tp), dataclasses.asdict(jp)
    assert ta.keys() == ja.keys()
    for k in ta:
        a, b = np.asarray(ta[k]), np.asarray(ja[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert tp.label.shape == (T, 128 * rows_per_user) and tp.ctx_slots.shape[-1] == 2
    assert tp.fb_idx.shape == (15, 10825) and tp.ctx_depth.shape == (15, 128)


def test_plain_matches_jax_epoch_ml100k(jx, ml100k_depth2):
    """One round on the depth-2 ML-100K set at the slice's setting (128
    units per step, rows_per_user=8, k=64): the plain version against the
    jnp epoch (atol 1e-5)."""
    packed = _pack_ml100k(pack_imfb, ml100k_depth2, 8)
    x = SimpleNamespace(
        **case_arrays(packed, ML100K["N"], 64, ML100K["off_user"], ML100K["off_item"], 10,
                      wd_bias=0.0),
        lrs=np.full((1,), 0.005, np.float32), hp=dict(base_score=3.0),
        ph=PlusHyper(rows_per_user=8, off_user=1682, wd_ufeedback=0.004))
    got, step = _plain(x)
    state = jax_epochs(jx, x)
    for name in ("w", "b"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(state, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert step == int(state.step) == 90570


def test_ctx_slots_staged_int32():
    """convert stages the context planes, pools, depths and gate with the
    dtypes the kernel takes: ctx_slots, fb_ctx and ctx_depth int32."""
    x = imfb_inputs()
    state, stacked, _, fb, overlap, enabled, *_ = torch_args(x)
    assert stacked["ctx_slots"].dtype == torch.int32
    assert np.array_equal(stacked["ctx_slots"].numpy(), x.stacked["ctx_slots"])
    assert fb["fb_ctx"].dtype == fb["ctx_depth"].dtype == fb["fb_idx"].dtype == torch.int32
    assert fb["fb_val"].dtype == overlap.dtype == enabled.dtype == torch.float32
    assert enabled.shape == (fb["fb_idx"].shape[0], fb["ctx_depth"].shape[1] + 1)


# ---- the gate and the wrapper ------------------------------------------------
# the refusal each case must name: a ROADMAP item where no route of the
# port runs it yet, else the plain rounds, which the solver takes instead
PLAIN = "the plain rounds run it"
GATE_CASES = {
    "base": ({}, None),
    "reg_method": (dict(hp=dict(reg_method=1)), PLAIN),
    "reg_global": (dict(hp=dict(reg_global=1)), PLAIN),
    "user_nonneg": (dict(hp=dict(user_nonnegative=1)), PLAIN),
    "sigmoid_l2": (dict(hp=dict(active_type=1)), None),
    "sigmoid_rank": (dict(hp=dict(active_type=3)), None),
    "hinge_smooth": (dict(hp=dict(active_type=5)), PLAIN),
    "multi_user": (dict(Su=2), PLAIN),
    "item_width2": (dict(Si=2), PLAIN),
    "item_width3": (dict(Si=3), PLAIN),
    "global": (dict(NG=7), PLAIN),
    "shared_feedback_space": (dict(off_user=0), "refresh epoch ops/imfb.train_epoch_imfb runs it"),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_agrees_with_pallas(jx, case):
    """gate_failure and pallas_imfb_supported agree on the semantic
    conditions, at shapes inside the TPU kernel's layout limits (128 slots
    per step, k=8), and each refusal names its ROADMAP item or the plain
    rounds."""
    spec, item = GATE_CASES[case]
    N, k, GS, NG = 300, 8, 128, spec.get("NG", 1)
    off_user = spec.get("off_user", 100)
    planes = dict(label=np.zeros((1, GS), np.float32), weight=np.ones((1, GS), np.float32),
                  g_idx=np.zeros((1, GS, 1), np.int32), g_val=np.zeros((1, GS, 1), np.float32),
                  ctx_slots=np.zeros((1, GS, 2), np.int32))
    for p, key in (("u", "Su"), ("i", "Si")):
        planes[f"{p}_idx"] = np.full((1, GS, spec.get(key, 1)), N - 1, np.int32)
        planes[f"{p}_val"] = np.zeros((1, GS, spec.get(key, 1)), np.float32)
    st = dict(w=np.zeros((N, k), np.float32), b=np.zeros(N, np.float32),
              g=np.zeros(NG, np.float32), step=np.int32(0), ref_ui=np.zeros(N, np.int32),
              ref_g=np.zeros(NG, np.int32))
    fb = dict(fb_idx=np.zeros((1, 4), np.int32), fb_val=np.zeros((1, 4), np.float32),
              fb_ctx=np.zeros((1, 4), np.int32))
    hp_kw = spec.get("hp", {})
    jnp = jx.jnp
    want = jx.pallas_svdpp.pallas_imfb_supported(
        jx.embed.HyperParams(**hp_kw),
        jx.embed.TrainState(**{n: jnp.asarray(v) for n, v in st.items()}),
        {n: jnp.asarray(v) for n, v in planes.items()},
        {n: jnp.asarray(v) for n, v in fb.items()}, jnp.ones((1, 3), jnp.float32), off_user)
    reason = cuda_imfb.gate_failure(
        HyperParams(**hp_kw), convert.state_from_numpy(**st, device=CPU),
        convert.stacked_from_numpy(planes, CPU), PlusHyper(off_user=off_user))
    assert (reason is None) == want, reason
    if item is None:
        assert reason is None
    else:
        assert item in reason


@pytest.mark.parametrize("N,RM,item", [
    pytest.param(8193, 1, "ops/imfb.train_epoch_imfb_big runs them", id="8193-1-item 9"),
    (300, 33, "rows_per_user above 32"),
    (300, 32, None),
])
def test_gate_port_caps(N, RM, item):
    """The port's own caps: tables over 8192 rows (K3 takes no augmented
    layout; the big-table stacked epoch runs them) and more than 32 rows
    per unit (one warp per slot of a unit's block)."""
    x = imfb_inputs()
    st = dict(x.st, w=np.zeros((N, 8), np.float32), b=np.zeros(N, np.float32),
              ref_ui=np.zeros(N, np.int32))
    reason = cuda_imfb.gate_failure(
        HyperParams(), convert.state_from_numpy(**st, device=CPU),
        convert.stacked_from_numpy(x.stacked, CPU), dataclasses.replace(x.ph, rows_per_user=RM))
    if item is None:
        assert reason is None
    else:
        assert item in reason


def _checked(x, stacked_edit=None, **fb_edit):
    """The wrapper's checks on the CPU tensors of a case (contexts and
    gate, then cuda_svdpp._check_inputs keyed by fb_ctx), with planes
    replaced."""
    from svdfeature_tpu_torch.ops.cuda_svdpp import _check_inputs

    state, stacked, _, fb, overlap, enabled, lrs, consts, _, ph = torch_args(x)
    fb = dict(fb, **fb_edit)
    stacked = dict(stacked, **(stacked_edit or {}))
    T, GS, D = stacked["ctx_slots"].shape
    cuda_imfb._check_contexts(stacked["ctx_slots"].reshape(T * GS, D), enabled, fb, T * GS, CPU)
    planes = {
        "u_idx": stacked["u_idx"][..., 0].reshape(-1).contiguous(),
        "u_val": stacked["u_val"][..., 0].reshape(-1).contiguous(),
        "i_idx": stacked["i_idx"].reshape(-1), "i_val": stacked["i_val"].reshape(-1),
        "label": stacked["label"].reshape(-1), "weight": stacked["weight"].reshape(-1),
    }
    G = enabled.shape[1] - 1
    return _check_inputs(state, planes, fb, overlap, lrs, consts, G, 1, seg_key="fb_ctx"), G


def test_kernel_input_checks():
    """Segment starts of each context's pool entries and the live entries
    per chunk, and a ValueError on a pool not grouped by context, a
    context id outside [0, nseg), a pad context with live entries, or a
    plane of the wrong type."""
    x = imfb_inputs(rows_per_user=2)
    (seg, live), G = _checked(x)
    ctx = x.fb["fb_ctx"]
    want = np.stack([np.searchsorted(c, np.arange(G + 1)) for c in ctx])
    assert seg.dtype == torch.int32 and np.array_equal(seg.numpy(), want)
    assert live == (ctx < G).sum(axis=1).tolist()
    fb_ctx = torch.from_numpy(ctx.copy())
    bad_order = fb_ctx.clone()
    bad_order[0, :2] = torch.tensor([1, 0], dtype=torch.int32)
    bad_pad = torch.from_numpy(x.fb["fb_val"].copy())
    bad_pad[0, -1] = 0.5
    slots = torch.from_numpy(x.stacked["ctx_slots"].copy())
    bad_slot = slots.clone()
    bad_slot[0, 0, 0] = G + 1
    for stacked_edit, fb_edit, match in (
            (None, dict(fb_ctx=bad_order), "grouped by context"),
            (None, dict(fb_val=bad_pad), "pad context"),
            (dict(ctx_slots=bad_slot), {}, "ctx_slots outside"),
            (dict(ctx_slots=slots.long()), {}, "dtype")):
        assert (x.fb["fb_ctx"][0, -1] == G)  # the last entry of chunk 0 is padding
        with pytest.raises(ValueError, match=match):
            _checked(x, stacked_edit, **fb_edit)


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version and launches nothing."""
    x = imfb_inputs(rows_per_user=2)
    before = cuda_imfb.train_rounds_imfb_kernel.launches
    a = cuda_imfb.train_rounds_imfb_kernel(*torch_args(x))
    b = cuda_imfb.train_rounds_imfb_reference(*torch_args(x))
    assert cuda_imfb.train_rounds_imfb_kernel.launches == before
    for name in ("w", "b", "g", "step"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    # what a call on the card launches: one cooperative launch, whatever
    # the rounds, steps and chunk starts
    assert cuda_imfb.launches_per_call(x.chunk_id, 2) == 1


def test_checked_plan_is_kept_for_the_same_tensors():
    """The wrapper's checked plan (flat planes, the context plane, segment
    starts, schedule planes, live-slot count) is made once per set of
    tensors and found again while they come unmodified; an in-place edit of
    a plane, other tensors or another chunk_id make a new one, and the new
    one is checked (a row outside the table, a context outside [0, nseg)
    raise)."""
    x = imfb_inputs(rows_per_user=2)
    state, stacked, cid, fb, overlap, enabled, lrs, consts, _, ph = torch_args(x)
    args = (state, stacked, cid, fb, overlap, enabled, lrs, consts, ph.rows_per_user)
    cuda_imfb._PLANS.clear()
    plan = cuda_imfb._plan(*args)
    assert cuda_imfb._plan(*args) is plan and len(cuda_imfb._PLANS) == 1
    assert int(plan.n_live) == int((x.stacked["weight"] > 0).sum())
    planes, ctx, seg, sched = plan.keep
    assert len(plan.ptrs) == len(cuda_imfb._ROUNDS_POINTERS) == 30
    for name, held in (("seg", seg), ("cid", sched[0]), ("first", sched[1]), ("live", sched[2]),
                       ("ctx", ctx), ("label", planes["label"]), ("fb_ctx", fb["fb_ctx"]),
                       ("O", overlap), ("enabled", enabled)):
        assert plan.ptrs[cuda_imfb._SLOT[name]] == held.data_ptr()
    G = x.enabled.shape[1] - 1
    assert seg.shape == (x.fb["fb_idx"].shape[0], G + 1)
    assert sched[2].tolist() == (x.fb["fb_ctx"] < G).sum(axis=1).tolist()
    # other tensors of equal content: checked anew
    other = torch_args(x)
    assert cuda_imfb._plan(*other[:8], ph.rows_per_user) is not plan
    # another schedule
    cid2 = cid.copy()
    cid2[-1] = cid2[0]
    assert cuda_imfb._plan(state, stacked, cid2, *args[3:]) is not plan
    assert cuda_imfb._plan(*args) is plan
    # an in-place edit bumps the version: the plan is remade, and checked
    stacked["label"].mul_(1.0)
    assert cuda_imfb._plan(*args) is not plan
    stacked["ctx_slots"][0, 0, 0] = G + 1
    with pytest.raises(ValueError, match="ctx_slots outside"):
        cuda_imfb._plan(*args)
    stacked["ctx_slots"][0, 0, 0] = 0
    stacked["i_idx"][0, 0, 0] = 10_000
    with pytest.raises(ValueError, match="outside"):
        cuda_imfb._plan(*args)
    assert len(cuda_imfb._PLANS) <= _plans.MAX_PLANS
    cuda_imfb._PLANS.clear()


# ---- the trainer and the CLI slice ----------------------------------------------
CONF = (
    "base_score = 3\nlearning_rate = 0.01\nwd_user = 0.004\nwd_item = 0.004\n"
    f"num_user = {NUM_USER}\nnum_item = {NUM_ITEM}\nnum_global = 0\nnum_factor = 8\n"
    f"active_type = 0\nformat_type = 1\nextend_type = 2\nnum_ufeedback = {NUM_FB}\n"
    "wd_ufeedback = 0.004\nusers_per_batch = 8\nrows_per_user = 2\nsilent = 1\n"
)


def _trainer(extra=(), extend_type=2):
    from svdfeature_tpu_torch.solvers.registry import create_svd_trainer

    tr = create_svd_trainer(SVDTypeParam(format_type=svd_type.USER_GROUP_FORMAT,
                                         extend_type=extend_type))
    for line in CONF.strip().splitlines():
        name, val = (s.strip() for s in line.split("="))
        tr.set_param(name, val)
    for name, val in (("device", "cpu"), *extra):
        tr.set_param(name, val)
    tr.init_model()
    tr.init_trainer()
    return tr


def test_all_default_equals_svdpp_trainer():
    """All-DEFAULT data through the multi-IMFB trainer takes the SVD++
    path and equals the SVD++ trainer bit for bit (train and predict);
    with depth 0 disabled it stays on the stacked path."""
    rows, fbs = synth_text(3)
    ds = load_plus_text("x", "y", text=rows, feedback_text=fbs)
    a, b = _trainer(), _trainer(extend_type=1)
    assert type(a).__name__ == "SVDPPMultiIMFBTrainer" and a._plain_svdpp(ds)
    for r in range(2):
        a.set_round(r)
        b.set_round(r)
        a.update_all(ds)
        b.update_all(ds)
    for name in ("w", "b", "step"):
        assert torch.equal(getattr(a.state, name), getattr(b.state, name))
    assert np.array_equal(a.predict_all(ds), b.predict_all(ds))
    c = _trainer([("ufeedback_disable_level", "0")])
    assert not c._plain_svdpp(ds)
    assert type(c._pack_plus(ds)).__name__ == "ImfbEntry"


def test_update_rounds_equals_update_all():
    """update_rounds (R rounds in one wrapper call, the lr schedule on the
    host) equals R update_all calls, bit for bit, on the CPU."""
    rows, fbs = synth_text(4)
    ds = stack_depth2(load_plus_text("x", "y", text=rows, feedback_text=fbs))
    extra = (("decay_learning_rate", "1"), ("decay_rate", "0.9"))
    a, b = _trainer(extra), _trainer(extra)
    for r in range(3):
        a.set_round(r)
        a.update_all(ds)
    b.update_rounds(ds, 3)
    for name in ("w", "b", "step"):
        assert torch.equal(getattr(a.state, name), getattr(b.state, name))
    pa, pb = a.predict_all(ds), b.predict_all(ds)
    assert pa.shape == (ds.rows.num_row,) and np.array_equal(pa, pb)


def _write_sets(d):
    """A stacked train buffer and a plain (all-DEFAULT) test buffer."""
    from svdfeature_tpu_torch.data.buffer import write_plus_buffer

    for split, seed in (("train", 0), ("test", 5)):
        rows, fbs = synth_text(seed)
        ds = load_plus_text("x", "y", text=rows, feedback_text=fbs)
        write_plus_buffer(str(d / f"{split}.buffer"), stack_depth2(ds) if split == "train" else ds)


ROUNDS = 2


def test_cli_slice_matches_jax(tmp_path):
    """SVDTrainTask -> %04d.model per round -> SVDInferTask on a stacked
    buffer, both packages (the port with device=cpu), 2 rounds: every
    checkpoint agrees (atol 1e-5), so does every round's eval RMSE on the
    plain test set and the pred output on the stacked set."""
    _cli_slice(tmp_path)


# configurations the kernels do not take: the plain rounds train them, as
# the JAX package's jnp path does, whatever use_pallas says
GENERAL_CONFS = {
    "reg_method1": "reg_method = 1\n",
    "reg_method4-nonneg": "reg_method = 4\nreg_global = 4\nuser_nonnegative = 1\nitem_nonnegative = 1\n",
    "active_type5-use_pallas0": "active_type = 5\nbase_score = 0.5\nuse_pallas = 0\n",
}


@pytest.mark.parametrize("case", list(GENERAL_CONFS))
def test_cli_general_route_matches_jax(case, tmp_path):
    """The CLI slice of test_cli_slice_matches_jax on configurations that
    the port refused before the general step: checkpoints and eval RMSE
    agree with the JAX package's (atol 1e-5)."""
    _cli_slice(tmp_path, GENERAL_CONFS[case])


def _cli_slice(tmp_path, extra=""):
    pytest.importorskip("jax")
    from svdfeature_tpu import model as jmodel
    from svdfeature_tpu.infer.task import SVDInferTask as JInfer
    from svdfeature_tpu.params import SVDTypeParam as JType
    from svdfeature_tpu.train.loop import SVDTrainTask as JTrain
    from svdfeature_tpu_torch.infer.task import SVDInferTask as TInfer
    from svdfeature_tpu_torch.train.loop import SVDTrainTask as TTrain

    _write_sets(tmp_path)
    run = {"jax": (JTrain, JInfer, []), "torch": (TTrain, TInfer, ["device=cpu"])}
    rmse, models, preds = {}, {}, {}
    for tag, (train_cls, infer_cls, dev) in run.items():
        d = tmp_path / tag
        d.mkdir()
        (d / "t.conf").write_text(
            CONF + extra + f'buffer_feature = "{tmp_path}/train.buffer"\ntest:buffer_feature = '
            f'"{tmp_path}/test.buffer"\nmodel_out_folder = "{d}/models"\n')
        before = cuda_imfb.train_rounds_imfb_kernel.launches
        task = train_cls()
        task.run(str(d / "t.conf"), [f"num_round={ROUNDS}", *dev])
        assert cuda_imfb.train_rounds_imfb_kernel.launches == before  # CPU: plain version
        assert type(task.trainer).__name__ == "SVDPPMultiIMFBTrainer"
        models[tag] = []
        for r in range(ROUNDS + 1):
            with open(d / "models" / f"{r:04d}.model", "rb") as f:
                m = jmodel.SVDModel.load(f, JType.from_bytes(f.read(4)))
            models[tag].append({n: np.asarray(getattr(m, n)) for n in ("w", "b")})
        log = d / "rmse.tsv"
        infer_cls().run(str(d / "t.conf"), ["start=0", f"end={ROUNDS + 1}", f"log_eval={log}", *dev])
        rmse[tag] = np.loadtxt(log)
        # pred on the stacked set: the stacked forward through the CLI
        infer_cls().run(str(d / "t.conf"), [f"pred={ROUNDS}", f"name_pred={d}/pred.txt", "silent=1",
                                            f"test:buffer_feature={tmp_path}/train.buffer", *dev])
        preds[tag] = np.loadtxt(d / "pred.txt")
    assert rmse["torch"].shape == (ROUNDS + 1, 2)
    np.testing.assert_allclose(rmse["torch"], rmse["jax"], atol=1e-5, rtol=0)
    assert preds["torch"].shape == preds["jax"].shape and preds["torch"].size > 100
    np.testing.assert_allclose(preds["torch"], preds["jax"], atol=1e-5, rtol=0)
    for r in range(ROUNDS + 1):
        for n in ("w", "b"):
            np.testing.assert_allclose(models["torch"][r][n], models["jax"][r][n],
                                       atol=1e-5, rtol=0, err_msg=f"round {r} {n}")
    assert not np.allclose(models["torch"][-1]["w"], models["torch"][0]["w"])  # it trained


@pytest.mark.parametrize("key,val,item", [
    # a feedback space shared with the user rows: the stacked refresh
    # epoch, which trains now
    pytest.param("common_feedback_space", "1", None, id="common_feedback_space-1-item 7b"),
    # a 8,266-row table: big-table multi-IMFB, which trains now
    pytest.param("num_ufeedback", "8100", None, id="num_ufeedback-8100-item 9"),
    # a streamed buffer (out-of-core): the stacked stream, which trains now
    pytest.param("streaming", "1", None, id="streaming-1-item 11"),
    # a mesh, which trains in a torchrun world: alone, the trainer asks for one
    pytest.param("mesh_data", "2", "torchrun", id="mesh_data-2-item 12"),
])
def test_outside_the_slice_raises_with_roadmap_item(key, val, item, tmp_path):
    """A stacked mesh (ROADMAP item 12c) trains in a torchrun world
    (tests/test_torch_mesh_plus.py); without one the trainer raises
    ValueError naming torchrun before its first tensor.  A table over 8192 rows,
    a shared feedback space and a streamed buffer (``item`` None) train, on
    the big-table stacked epoch, on the stacked refresh epoch (which
    matches the JAX CLI's checkpoints, eval RMSE and pred output) and a
    chunk at a time."""
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    _write_sets(tmp_path)
    (tmp_path / "t.conf").write_text(
        CONF + f'buffer_feature = "{tmp_path}/train.buffer"\n'
        f'model_out_folder = "{tmp_path}/models"\n')
    args = ["num_round=1", "device=cpu", f"{key}={val}"]
    if item is not None:
        with pytest.raises(ValueError, match=item):
            SVDTrainTask().run(str(tmp_path / "t.conf"), args)
        return
    task = SVDTrainTask()
    task.run(str(tmp_path / "t.conf"), args)
    tr = task.trainer
    if key == "streaming":
        assert not tr._plain_svdpp(task.dataset) and tr.chunk_stream.stats.chunks == 1
        assert (tmp_path / "models" / "0001.model").exists() and int(tr.state.step) > 0
        return
    entry = tr._pack_plus(task.dataset)
    assert type(entry).__name__ == "ImfbEntry"
    assert tr.hp.big_table == (key == "num_ufeedback")
    assert (entry.fb_overlap is None) and bool(torch.isfinite(tr.state.w).all())
    assert (tmp_path / "models" / "0001.model").exists() and int(tr.state.step) > 0
    if key == "common_feedback_space":
        (tmp_path / "cli").mkdir()
        _cli_slice(tmp_path / "cli", "common_feedback_space = 1\n")


def test_unported_epochs_raise(jx):
    """The stacked refresh epoch, which raised naming ROADMAP item 7b, now
    trains: R=2 rounds of train_epoch_imfb on the synthetic depth-2 set
    against the JAX package's (atol 1e-6; here on the disjoint layout,
    which the refresh form trains as well: tests/test_torch_refresh.py
    holds the shared one)."""
    from svdfeature_tpu_torch.ops import imfb

    x = imfb_inputs(rows_per_user=2, no_user_bias=1)
    state, stacked, cid, fb, _, enabled, lrs, consts, hp, ph = torch_args(x)
    for lr in lrs:
        state = imfb.train_epoch_imfb(state, stacked, cid, fb, enabled, lr, consts, hp, ph)
    jnp = jx.jnp
    js = jx.embed.TrainState(**{n: jnp.asarray(v) for n, v in x.st.items()})
    for lr in x.lrs:
        js = jx.imfb.train_epoch_imfb(
            js, {n: jnp.asarray(v) for n, v in x.stacked.items()}, jnp.asarray(x.chunk_id),
            {n: jnp.asarray(v) for n, v in x.fb.items()}, jnp.asarray(x.enabled),
            jnp.float32(lr), jx.embed.TrainConsts(**{n: jnp.asarray(v) for n, v in x.cs.items()}),
            jx.embed.HyperParams(**x.hp), *FBH.values(), rows_per_user=2)
    for name in ("w", "b"):
        np.testing.assert_allclose(getattr(state, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    assert int(state.step) == int(js.step)


# ---- big-table multi-IMFB (ops/imfb.train_epoch_imfb_big) -------------------
def _big_epochs(x, device=CPU, row_dma=False):
    """R rounds of the port's train_epoch_imfb_big on the augmented layout
    -> the de-augmented state."""
    from svdfeature_tpu_torch.ops import big_embed, imfb

    state, stacked, cid, fb, _, enabled, lrs, consts, hp, ph = torch_args(x, device)
    state = big_embed.augment_state(state, 8)
    hp = dataclasses.replace(hp, big_table=True, num_factor=8, row_dma=row_dma)
    for lr in lrs:
        state = imfb.train_epoch_imfb_big(state, stacked, cid, fb, enabled, lr, consts, hp, ph)
    return big_embed.deaugment_state(state, 8)


BIG_CASES = dict(CASES, **{"reg4-global4-rows_per_user2": "general"})


@pytest.mark.parametrize("case", list(BIG_CASES))
def test_big_epoch_matches_jax(jx, case):
    """R=2 rounds of the port's big-table stacked epoch against the JAX
    package's train_epoch_imfb_big on the same inputs (atol 1e-6 + rtol
    1e-5; the step counter and the lazy refs exact): RM 1 and 2,
    no_user_bias, a disabled depth, lazy decay with a global segment."""
    from svdfeature_tpu.ops import big_embed as jbig
    from test_torch_svdpp import with_general

    if BIG_CASES[case] == "general":
        x = with_general(imfb_inputs(rows_per_user=2), GENERAL_CASES["reg4-global4"])
    else:
        x = imfb_inputs(**BIG_CASES[case])
    got = _big_epochs(x)
    state, stacked, cid, fb, _, enabled, consts, hp = jax_args(jx, x)
    state = jbig.augment_state(state, 8)
    hp = dataclasses.replace(hp, big_table=True, num_factor=8)
    for lr in x.lrs:
        state = jx.imfb.train_epoch_imfb_big(
            state, stacked, cid, fb, enabled, jx.jnp.float32(lr), consts, hp,
            x.ph.scale_lr_ufeedback, x.ph.wd_ufeedback, x.ph.wd_ufeedback_bias,
            rows_per_user=x.ph.rows_per_user)
    want = jbig.deaugment_state(state, 8)
    for name in ("w", "b", "g"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=1e-5, err_msg=name)
    for name in ("ref_ui", "ref_g", "step"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
    assert not np.allclose(got.w.numpy()[:NUM_FB], x.st["w"][:NUM_FB])  # the pool rows trained


@pytest.mark.parametrize("rows_per_user", [1, 2])
def test_solver_routes_big_table(monkeypatch, rows_per_user):
    """With the big-table threshold forced to 4 rows both solvers take the
    big-table stacked epoch (JAX tests/test_side_multirow.py:226-245):
    3 rounds of update_all, then the checkpoint's tables and predict_all
    agree with the JAX solver's (atol 1e-5 + rtol 1e-4)."""
    pytest.importorskip("jax")
    from svdfeature_tpu.data.text import load_plus_text as jload
    from svdfeature_tpu.ops import embed as jembed
    from svdfeature_tpu.params import SVDTypeParam as JType
    from svdfeature_tpu.solvers.multi_imfb import SVDPPMultiIMFBTrainer as JTrainer
    from svdfeature_tpu_torch.ops import cuda_scatter
    from svdfeature_tpu_torch.solvers import base as tbase

    monkeypatch.setattr(jembed, "ONEHOT_THRESHOLD", 4)
    monkeypatch.setattr(tbase, "BIG_TABLE_ROWS", 4)
    rows, fbs = synth_text(6)
    extra = (("rows_per_user", str(rows_per_user)),)
    ttr = _trainer(extra)
    jtr = JTrainer(JType(format_type=1, extend_type=2))
    for line in CONF.strip().splitlines():
        name, val = (v.strip() for v in line.split("="))
        jtr.set_param(name, val)
    for name, val in extra:
        jtr.set_param(name, val)
    jtr.init_model()
    jtr.init_trainer()
    assert ttr.hp.big_table and not ttr.hp.sweep_table and jtr.hp.big_table
    tds = stack_depth2(load_plus_text("x", "y", text=rows, feedback_text=fbs))
    jds = stack_depth2(jload("x", "y", text=rows, feedback_text=fbs), _jax_csr())
    assert ttr._pack_plus(tds).fb_overlap is None  # the big epoch reads no overlap
    before = cuda_scatter.row_writer.launches
    for r in range(3):
        for tr, ds in ((ttr, tds), (jtr, jds)):
            tr.set_round(r)
            tr.update_all(ds)
    assert cuda_scatter.row_writer.launches == before  # CPU: the plain writer
    ttr._sync_model_from_state()
    jtr._sync_model_from_state()
    for name in ("w", "b"):
        np.testing.assert_allclose(getattr(ttr.model, name).numpy(),
                                   np.asarray(getattr(jtr.model, name)), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(ttr.predict_all(tds), np.asarray(jtr.predict_all(jds)),
                               atol=1e-5, rtol=1e-4)


def _jax_csr():
    from svdfeature_tpu.data import csr

    return csr


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["base", "rows_per_user2"])
def test_big_epoch_k5_matches_plain_on_card(case):
    """The big-table stacked epoch with K5 (row_dma) against its plain
    writer on the card, R=2 (index_add_ sums in a varying order: atol 1e-6
    + rtol 1e-5), with the launch count two a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m cuda tests/)")
    from svdfeature_tpu_torch.ops import cuda_scatter

    x = imfb_inputs(**CASES[case])
    dev = torch.device("cuda")
    before = cuda_scatter.row_writer.launches
    got = _big_epochs(x, dev, row_dma=True)
    torch.cuda.synchronize()
    assert cuda_scatter.row_writer.launches - before == 2 * 2 * len(x.chunk_id)
    want = _big_epochs(x, dev)
    for name in ("w", "b"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), atol=1e-6, rtol=1e-5)
    assert int(got.step) == int(want.step)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(case):
    """K3 against its plain version on the card, R=2 (atomics sum in a
    varying order, exp(n log d) against pow(d, n): atol 1e-5 / rtol 1e-4),
    one cooperative launch a call, and a second call on the same tensors,
    which takes the kept plan, agreeing too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m cuda tests/)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    x = imfb_inputs(**CASES[case])
    before = cuda_imfb.train_rounds_imfb_kernel.launches
    args = torch_args(x, dev)
    got = cuda_imfb.train_rounds_imfb_kernel(*args)
    torch.cuda.synchronize()
    assert (cuda_imfb.train_rounds_imfb_kernel.launches - before
            == cuda_imfb.launches_per_call(x.chunk_id, 2) == 1)
    plan = cuda_imfb._PLANS[0]
    want = cuda_imfb.train_rounds_imfb_reference(*torch_args(x, dev))
    for name in ("w", "b"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), atol=1e-5, rtol=1e-4)
    assert int(got.step) == int(want.step)
    # a second call on the same tensors: the kept plan, no new checks
    got = cuda_imfb.train_rounds_imfb_kernel(got, *args[1:])
    torch.cuda.synchronize()
    assert cuda_imfb._PLANS[0] is plan
    assert cuda_imfb.train_rounds_imfb_kernel.launches - before == 2
    want = cuda_imfb.train_rounds_imfb_reference(want, *torch_args(x, dev)[1:])
    for name in ("w", "b"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), atol=1e-5, rtol=1e-4)
    assert int(got.step) == int(want.step)
