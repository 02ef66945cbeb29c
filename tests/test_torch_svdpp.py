"""The port's SVD++ path (ops/svdpp.py, ops/cuda_svdpp.py,
solvers/svdpp.py) against the JAX package.

Inputs are packed once with the port's copy of ``pack_plus`` (byte-
identical to the JAX package's, tests/test_torch_data.py) and handed as
the same numpy arrays to both packages.  On the CPU the plain PyTorch
version is held against the f32 jnp ``train_epoch_plus`` and against the
TPU kernel ``train_rounds_svdpp_pallas`` run in interpret mode (3-chunk
synthetic user-group sets, as tests/test_pallas_svdpp.py builds them);
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
from svdfeature_tpu_torch.data.batching_plus import pack_plus
from svdfeature_tpu_torch.data.text import load_plus_text
from svdfeature_tpu_torch.ops import cuda_svdpp
from svdfeature_tpu_torch.ops.embed import HyperParams
from svdfeature_tpu_torch.ops.svdpp import PlusHyper

CPU = torch.device("cpu")
FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
# the synthetic layout: feedback rows [0, 25), users [25, 65), items [65, 165), dummy 165
NUM_FB, NUM_USER, NUM_ITEM = 25, 40, 100
FBH = dict(scale_lr_ufeedback=1.0, wd_ufeedback=0.004, wd_ufeedback_bias=0.002)


def synth_text(seed, SI, n_users=NUM_USER):
    """(rows, feedback) text of a user-group set: 1-5 rows per user, 2-6
    feedback ids each.  SI=2 rows are pairwise-rank difference rows
    ([pos, neg] items with values [+1, -1])."""
    rng = np.random.RandomState(seed)
    rows, fbs = [], []
    for u in range(n_users):
        r = rng.randint(1, 6)
        for _ in range(r):
            if SI == 1:
                rows.append(f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, NUM_ITEM)}:1")
            else:
                i1, i2 = rng.choice(NUM_ITEM, size=2, replace=False)
                rows.append(f"1 0 1 2 {u}:1 {i1}:1 {i2}:-1")
        nf = rng.randint(2, 7)
        ids = rng.choice(NUM_FB, size=nf, replace=False)
        fbs.append(f"{r} {nf} " + " ".join(f"{j}:{0.3 + 0.1 * (j % 3):.1f}" for j in ids))
    return "\n".join(rows) + "\n", "\n".join(fbs) + "\n"


def plus_inputs(M=1, SI=1, no_user_bias=0, seed=0, R=2, n_users=NUM_USER, users_per_step=16, k=8):
    """numpy (state, consts, stacked, chunk_id, fb, overlap, lrs) and the
    hyperparameters of one synthetic case (by default 40 users, 16 per
    step, 3 chunks, 8 factors; more users move the item rows up)."""
    rows, fbs = synth_text(seed, SI, n_users)
    ds = load_plus_text("x", "y", text=rows, feedback_text=fbs)
    N = NUM_FB + n_users + NUM_ITEM + 1
    off_user, off_item = NUM_FB, NUM_FB + n_users
    packed = pack_plus(ds, users_per_step, N - 1, 0, off_user, off_item, 0, num_user=n_users,
                       num_item=NUM_ITEM, num_ufeedback=NUM_FB, rows_per_user=M)
    assert packed.fb_idx.shape[0] == -(-n_users // users_per_step)
    rng = np.random.RandomState(seed + 1)
    w = rng.normal(0, 0.1, (N, k)).astype(np.float32)
    b = rng.normal(0, 0.01, (N,)).astype(np.float32)
    w[-1] = 0.0
    b[-1] = 0.0
    wd_u = np.zeros(N, np.float32)
    wd_i = np.zeros(N, np.float32)
    wd_u[off_user:off_item] = 0.004
    wd_i[off_item:N - 1] = 0.004
    st = dict(w=w, b=b, g=np.zeros(1, np.float32), step=np.int32(0),
              ref_ui=np.zeros(N, np.int32), ref_g=np.zeros(1, np.int32))
    cs = dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=np.zeros(1, np.float32),
              wd_user_bias=np.float32(0.002), wd_item_bias=np.float32(0.002))
    stacked = packed.device_arrays()
    chunk_id = stacked.pop("chunk_id")
    at, base = (0, 3.0) if SI == 1 else (3, 0.0)
    hp = dict(active_type=at, no_user_bias=no_user_bias, base_score=base)
    ph = PlusHyper(rows_per_user=M, off_user=off_user, **FBH)
    return SimpleNamespace(st=st, cs=cs, stacked=stacked, chunk_id=chunk_id,
                           fb=packed.fb_arrays(), overlap=packed.fb_overlap,
                           lrs=np.full((R,), 0.01, np.float32), hp=hp, ph=ph,
                           G=packed.num_blocks_local, off_item=off_item)


def torch_args(x, device=CPU):
    """The port's (state, stacked, chunk_id, fb, overlap, lrs, consts, hp, ph)."""
    fb, overlap = convert.pool_from_numpy(x.fb, x.overlap, device)
    return (convert.state_from_numpy(**x.st, device=device),
            convert.stacked_from_numpy(x.stacked, device), x.chunk_id, fb, overlap,
            torch.tensor(x.lrs, device=device), convert.consts_from_numpy(**x.cs, device=device),
            HyperParams(**x.hp), x.ph)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here and not at the top: a GPU host
    without JAX still collects this file and runs the card case."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from svdfeature_tpu.ops import embed, pallas_svdpp, svdpp

    return SimpleNamespace(jnp=jnp, pltpu=pltpu, embed=embed, svdpp=svdpp,
                           pallas_svdpp=pallas_svdpp)


def jax_args(jx, x):
    """The same arrays as the JAX package's (state, stacked, chunk_id, fb, overlap, consts, hp)."""
    jnp = jx.jnp
    return (jx.embed.TrainState(**{k: jnp.asarray(v) for k, v in x.st.items()}),
            {k: jnp.asarray(v) for k, v in x.stacked.items()}, jnp.asarray(x.chunk_id),
            {k: jnp.asarray(v) for k, v in x.fb.items()}, jnp.asarray(x.overlap),
            jx.embed.TrainConsts(**{k: jnp.asarray(v) for k, v in x.cs.items()}),
            jx.embed.HyperParams(**x.hp))


CASES = [
    pytest.param(M, SI, nub, id=f"M{M}-SI{SI}-nub{nub}")
    for M in (1, 2) for SI in (1, 2) for nub in (0, 1)
]


def _plain(x):
    out = cuda_svdpp.train_rounds_svdpp_reference(*torch_args(x))
    return {n: getattr(out, n).numpy() for n in ("w", "b")}, int(out.step)


@pytest.mark.parametrize("M,SI,no_user_bias", CASES)
def test_plain_matches_jax_epoch(jx, M, SI, no_user_bias):
    """R=2 rounds of the plain version against R calls of the f32 jnp
    train_epoch_plus (atol 1e-5: the two differ only in summation order;
    measured up to 5e-8)."""
    x = plus_inputs(M, SI, no_user_bias)
    got, step = _plain(x)
    state, stacked, cid, fb, overlap, consts, hp = jax_args(jx, x)
    for lr in x.lrs:
        state = jx.svdpp.train_epoch_plus(
            state, stacked, cid, fb, overlap, jx.jnp.float32(lr), consts, hp,
            *FBH.values(), rows_per_user=M)
    for name in ("w", "b"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(state, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert step == int(state.step) == 2 * int((x.stacked["weight"] > 0).sum())
    assert not np.allclose(got["w"], x.st["w"])  # it trained, the pool rows too
    assert not np.allclose(got["w"][:NUM_FB], x.st["w"][:NUM_FB])
    assert got["w"][-1].tolist() == [0.0] * 8 and got["b"][-1] == 0


def with_general(x, hp, NG=7, SG=2, seed=3):
    """The case ``x`` with a global segment (SG entries per row over NG-1
    real slots and the dummy, decaying) and the hyperparameters ``hp``:
    what only the plain rounds train."""
    rng = np.random.RandomState(seed)
    T, GS = x.stacked["label"].shape
    g_idx = rng.randint(0, NG - 1, (T, GS, SG)).astype(np.int32)
    g_val = rng.uniform(0.1, 1.0, (T, GS, SG)).astype(np.float32)
    pad = rng.rand(T, GS, SG) < 0.3
    g_idx[pad], g_val[pad] = NG - 1, 0.0
    g = rng.normal(0, 0.05, NG).astype(np.float32)
    g[-1] = 0.0
    wd_g = np.full(NG, 0.01, np.float32)
    wd_g[-1] = 0.0
    return SimpleNamespace(**dict(
        vars(x), stacked=dict(x.stacked, g_idx=g_idx, g_val=g_val),
        st=dict(x.st, g=g, ref_g=np.zeros(NG, np.int32)), cs=dict(x.cs, wd_g_row=wd_g),
        hp=dict(x.hp, **hp)))


# what the kernels refuse and the plain rounds train: reg modes 1 and 4
# (with their global modes), the clamps, the smooth hinge, all with a
# global segment
GENERAL_CASES = {
    "reg1-global1": dict(reg_method=1, reg_global=1),
    "reg4-global4": dict(reg_method=4, reg_global=4),
    "nonneg": dict(user_nonnegative=1, item_nonnegative=1),
    "hinge5": dict(active_type=5, base_score=0.5),
}


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("case", list(GENERAL_CASES))
def test_plain_general_matches_jax_epoch(jx, case, M):
    """R=2 plain rounds against R calls of the f32 jnp train_epoch_plus on
    the configurations only the plain rounds take (atol 1e-5, as above):
    w, b, g, the lazy refs and the step."""
    x = with_general(plus_inputs(M), GENERAL_CASES[case])
    out = cuda_svdpp.train_rounds_svdpp_reference(*torch_args(x))
    state, stacked, cid, fb, overlap, consts, hp = jax_args(jx, x)
    for lr in x.lrs:
        state = jx.svdpp.train_epoch_plus(
            state, stacked, cid, fb, overlap, jx.jnp.float32(lr), consts, hp,
            *FBH.values(), rows_per_user=M)
    for name in ("w", "b", "g"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(state, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    for name in ("ref_ui", "ref_g", "step"):
        assert np.array_equal(getattr(out, name).numpy(), np.asarray(getattr(state, name))), name
    assert not np.allclose(out.g.numpy(), x.st["g"])  # the global segment trained
    assert not np.allclose(out.w.numpy()[:NUM_FB], x.st["w"][:NUM_FB])


@pytest.mark.parametrize("M,SI,no_user_bias", CASES)
def test_plain_matches_pallas_interpret(jx, M, SI, no_user_bias):
    """The plain version against the TPU kernel in interpret mode, to the
    tolerance tests/test_pallas_svdpp.py holds that kernel to against the
    jnp path (w 2e-4 / b 5e-4, rtol 1e-3): it reads tables and payloads
    in bf16, and that rounding is the whole difference."""
    x = plus_inputs(M, SI, no_user_bias)
    got, step = _plain(x)
    state, stacked, cid, fb, overlap, consts, hp = jax_args(jx, x)
    with jx.pltpu.force_tpu_interpret_mode():
        out = jx.pallas_svdpp.train_rounds_svdpp_pallas(
            state, stacked, cid, fb, overlap, jx.jnp.asarray(x.lrs), consts, hp,
            x.G, M, NUM_FB, x.off_item, *FBH.values())
    np.testing.assert_allclose(got["w"], np.asarray(out.w), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got["b"], np.asarray(out.b), atol=5e-4, rtol=1e-3)
    assert step == int(out.step)


def test_plain_matches_jax_epoch_ml100k(jx):
    """The ML-100K implicitFeedback set at the band setting (sort_blocks=1,
    rows_per_user=8, 128 users per step, k=64), 2 rounds: the plain
    version against the jnp epoch (atol 1e-5)."""
    def text(name):
        with gzip.open(FIXTURES / name, "rt") as f:
            return f.read()

    ds = load_plus_text("x", "y", text=text("ml100k.base.group.feature.gz"),
                        feedback_text=text("ml100k.base.feedback.gz"))
    N = 1682 + 943 + 1682 + 1
    packed = pack_plus(ds, 128, N - 1, 0, 1682, 2625, 0, num_user=943, num_item=1682,
                       num_ufeedback=1682, sort_blocks=True, rows_per_user=8)
    assert packed.label.shape == (159, 1024) and packed.fb_idx.shape == (8, 38476)
    rng = np.random.RandomState(10)
    wd_u = np.zeros(N, np.float32)
    wd_i = np.zeros(N, np.float32)
    wd_u[1682:2625] = 0.004
    wd_i[2625:N - 1] = 0.004
    w = rng.normal(0, 0.01, (N, 64)).astype(np.float32)
    w[-1] = 0.0
    stacked = packed.device_arrays()
    x = SimpleNamespace(
        st=dict(w=w, b=np.zeros(N, np.float32), g=np.zeros(1, np.float32), step=np.int32(0),
                ref_ui=np.zeros(N, np.int32), ref_g=np.zeros(1, np.int32)),
        cs=dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=np.zeros(1, np.float32),
                wd_user_bias=np.float32(0.0), wd_item_bias=np.float32(0.0)),
        chunk_id=stacked.pop("chunk_id"), stacked=stacked, fb=packed.fb_arrays(),
        overlap=packed.fb_overlap, lrs=np.full((2,), 0.005, np.float32),
        hp=dict(base_score=3.0),
        ph=PlusHyper(rows_per_user=8, off_user=1682, wd_ufeedback=0.004))
    got, step = _plain(x)
    state, stacked, cid, fb, overlap, consts, hp = jax_args(jx, x)
    for lr in x.lrs:
        state = jx.svdpp.train_epoch_plus(state, stacked, cid, fb, overlap, jx.jnp.float32(lr),
                                          consts, hp, 1.0, 0.004, 0.0, rows_per_user=8)
    for name in ("w", "b"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(state, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert step == int(state.step) == 2 * 90570


GATE_CASES = {
    "base": {},
    "reg_method": dict(hp=dict(reg_method=1)),
    "reg_global": dict(hp=dict(reg_global=1)),
    "user_nonneg": dict(hp=dict(user_nonnegative=1)),
    "item_nonneg": dict(hp=dict(item_nonnegative=1)),
    "sigmoid_l2": dict(hp=dict(active_type=1)),
    "sigmoid_rank": dict(hp=dict(active_type=3)),
    "qsgrad": dict(hp=dict(active_type=7)),
    "hinge_smooth": dict(hp=dict(active_type=5)),
    "multi_user": dict(Su=2),
    "item_width2": dict(Si=2),
    "item_width3": dict(Si=3),
    "global": dict(NG=7),
    "shared_feedback_space": dict(off_user=0),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_agrees_with_pallas(jx, case):
    """gate_failure and pallas_svdpp_supported agree on the semantic
    conditions, at shapes inside the TPU kernel's layout limits (128
    slots per step, k=8, the feedback slab clear of the dummy row)."""
    spec = GATE_CASES[case]
    N, k, GS, NG = 300, 8, 128, spec.get("NG", 1)
    off_user = spec.get("off_user", 100)
    planes = dict(label=np.zeros((1, GS), np.float32), weight=np.ones((1, GS), np.float32),
                  g_idx=np.zeros((1, GS, 1), np.int32), g_val=np.zeros((1, GS, 1), np.float32))
    for p, key in (("u", "Su"), ("i", "Si")):
        planes[f"{p}_idx"] = np.full((1, GS, spec.get(key, 1)), N - 1, np.int32)
        planes[f"{p}_val"] = np.zeros((1, GS, spec.get(key, 1)), np.float32)
    st = dict(w=np.zeros((N, k), np.float32), b=np.zeros(N, np.float32),
              g=np.zeros(NG, np.float32), step=np.int32(0), ref_ui=np.zeros(N, np.int32),
              ref_g=np.zeros(NG, np.int32))
    fb = dict(fb_idx=np.zeros((1, 4), np.int32), fb_val=np.zeros((1, 4), np.float32),
              fb_block=np.zeros((1, 4), np.int32))
    hp_kw = spec.get("hp", {})
    jnp = jx.jnp
    want = jx.pallas_svdpp.pallas_svdpp_supported(
        jx.embed.HyperParams(**hp_kw),
        jx.embed.TrainState(**{n: jnp.asarray(v) for n, v in st.items()}),
        {n: jnp.asarray(v) for n, v in planes.items()},
        {n: jnp.asarray(v) for n, v in fb.items()}, off_user)
    reason = cuda_svdpp.gate_failure(
        HyperParams(**hp_kw), convert.state_from_numpy(**st, device=CPU),
        convert.stacked_from_numpy(planes, CPU), convert.stacked_from_numpy(fb, CPU),
        PlusHyper(off_user=off_user))
    assert (reason is None) == want, reason
    assert want == (case in ("base", "sigmoid_l2", "sigmoid_rank", "qsgrad", "item_width2"))


@pytest.mark.parametrize("N,M,k,item", [
    pytest.param(8193, 1, 8, "ops/svdpp_big.train_epoch_plus_big runs them", id="8193-1-8-item 9"),
    (300, 33, 8, "rows_per_user above 32"),
    (300, 32, 512, "shared memory"),
    (300, 8, 64, None),
])
def test_gate_port_caps(N, M, k, item):
    """The port's own caps: tables over 8192 rows (K2 takes no augmented
    layout; the big-table epoch runs them), more than 32 rows per user, the
    step block's shared memory."""
    x = plus_inputs()
    st = dict(x.st, w=np.zeros((N, k), np.float32), b=np.zeros(N, np.float32),
              ref_ui=np.zeros(N, np.int32))
    reason = cuda_svdpp.gate_failure(
        HyperParams(), convert.state_from_numpy(**st, device=CPU),
        convert.stacked_from_numpy(x.stacked, CPU), convert.stacked_from_numpy(x.fb, CPU),
        dataclasses.replace(x.ph, rows_per_user=M))
    if item is None:
        assert reason is None
    else:
        assert item in reason


def _checked(x, **fb_edit):
    """cuda_svdpp._check_inputs on the CPU tensors of a case, with pool
    planes replaced by ``fb_edit``."""
    state, stacked, _, fb, overlap, lrs, consts, _, ph = torch_args(x)
    fb = dict(fb, **fb_edit)
    SI = stacked["i_idx"].shape[-1]
    planes = {
        "u_idx": stacked["u_idx"][..., 0].reshape(-1).contiguous(),
        "u_val": stacked["u_val"][..., 0].reshape(-1).contiguous(),
        "i_idx": stacked["i_idx"].reshape(-1), "i_val": stacked["i_val"].reshape(-1),
        "label": stacked["label"].reshape(-1), "weight": stacked["weight"].reshape(-1),
    }
    G = stacked["label"].shape[1] // ph.rows_per_user
    return cuda_svdpp._check_inputs(state, planes, fb, overlap, lrs, consts, G, SI), fb, G


def test_kernel_input_checks():
    """The wrapper's one-sync check: segment starts of each user's pool
    entries and the live entries per chunk, and a ValueError on a pool
    that is not grouped by user, a row outside the table, a user id
    beyond the padding segment, or a plane of the wrong type."""
    x = plus_inputs(M=2)
    (seg, live), fb, G = _checked(x)
    blk = x.fb["fb_block"]
    want = np.stack([np.searchsorted(b, np.arange(G + 1)) for b in blk])
    assert seg.dtype == torch.int32 and np.array_equal(seg.numpy(), want)
    assert live == (blk < G).sum(axis=1).tolist()
    bad_order = fb["fb_block"].clone()
    bad_order[0, :2] = bad_order[0, :2].flip(0) + torch.tensor([1, 0], dtype=torch.int32)
    bad_row = fb["fb_idx"].clone()
    bad_row[1, 0] = 10_000
    bad_user = fb["fb_block"].clone()
    bad_user[2, -1] = G + 1
    for edit, match in ((dict(fb_block=bad_order), "grouped by user"),
                        (dict(fb_idx=bad_row), "outside"),
                        (dict(fb_block=bad_user), "fb_block outside"),
                        (dict(fb_val=fb["fb_val"].double()), "dtype")):
        with pytest.raises(ValueError, match=match):
            _checked(x, **edit)


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version and launches nothing."""
    x = plus_inputs(M=2)
    before = cuda_svdpp.train_rounds_svdpp_kernel.launches
    a = cuda_svdpp.train_rounds_svdpp_kernel(*torch_args(x))
    b = cuda_svdpp.train_rounds_svdpp_reference(*torch_args(x))
    assert cuda_svdpp.train_rounds_svdpp_kernel.launches == before
    for name in ("w", "b", "g", "step"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    # what a call on the card would launch: one cooperative launch for the
    # whole R x T run, chunk starts included
    assert cuda_svdpp.launches_per_call(x.chunk_id, 2) == 1


@pytest.mark.parametrize("M", [1, 2])
def test_device_schedule_planes(M):
    """The planes from which the kernel walks a round by itself: each
    step's chunk, the chunk-start flags (``_is_first``) and each chunk's
    live pool entries (``seg[:, G]``), int32."""
    from svdfeature_tpu_torch.ops.svdpp import _is_first

    x = plus_inputs(M=M)
    (seg, live), _, G = _checked(x)
    cid, first, live_dev = cuda_svdpp.device_schedule(x.chunk_id, seg, CPU)
    assert cid.dtype == first.dtype == live_dev.dtype == torch.int32
    assert all(t.is_contiguous() for t in (cid, first, live_dev))
    assert np.array_equal(cid.numpy(), x.chunk_id)
    assert np.array_equal(first.numpy().astype(bool), _is_first(x.chunk_id))
    assert first[0] == 1 and int(first.sum()) == 3
    assert live_dev.tolist() == seg[:, G].tolist() == live
    assert live == (x.fb["fb_block"] < G).sum(axis=1).tolist()


def test_checked_plan_is_kept_for_the_same_tensors():
    """The wrapper's checked plan (flat planes, segment starts, schedule
    planes, live-slot count) is made once per set of tensors and found
    again while they come unmodified; an in-place edit of a plane, other
    tensors, another chunk_id or another table height make a new one, and
    the new one is checked (a row outside the table raises)."""
    x = plus_inputs(M=2)
    state, stacked, cid, fb, overlap, lrs, consts, _, ph = torch_args(x)
    args = (state, stacked, cid, fb, overlap, lrs, consts, ph.rows_per_user)
    cuda_svdpp._PLANS.clear()
    plan = cuda_svdpp._plan(*args)
    assert cuda_svdpp._plan(*args) is plan and len(cuda_svdpp._PLANS) == 1
    assert int(plan.n_live) == int((x.stacked["weight"] > 0).sum())
    planes, seg, sched = plan.keep
    assert len(plan.ptrs) == len(cuda_svdpp._ROUNDS_POINTERS) == 27
    for name, held in (("seg", seg), ("cid", sched[0]), ("live", sched[2]),
                       ("label", planes["label"]), ("fb_val", fb["fb_val"]), ("O", overlap)):
        assert plan.ptrs[cuda_svdpp._SLOT[name]] == held.data_ptr()
    # other tensors of equal content: checked anew
    other = torch_args(x)
    assert cuda_svdpp._plan(other[0], *other[1:7], ph.rows_per_user) is not plan
    # another schedule
    cid2 = cid.copy()
    cid2[-1] = cid2[0]
    assert cuda_svdpp._plan(state, stacked, cid2, *args[3:]) is not plan
    assert cuda_svdpp._plan(*args) is plan
    # an in-place edit bumps the version: the plan is remade, and checked
    stacked["label"].mul_(1.0)
    remade = cuda_svdpp._plan(*args)
    assert remade is not plan
    stacked["u_idx"][0, 0, 0] = 10_000
    with pytest.raises(ValueError, match="outside"):
        cuda_svdpp._plan(*args)
    assert len(cuda_svdpp._PLANS) <= cuda_svdpp._MAX_PLANS
    cuda_svdpp._PLANS.clear()


# ---- the CLI slice -----------------------------------------------------------
CONF = (
    "base_score = 3\nlearning_rate = 0.01\nwd_user = 0.004\nwd_item = 0.004\n"
    f"num_user = {NUM_USER}\nnum_item = {NUM_ITEM}\nnum_global = 0\nnum_factor = 8\n"
    f"active_type = 0\nformat_type = 1\nnum_ufeedback = {NUM_FB}\nwd_ufeedback = 0.004\n"
    "users_per_batch = 16\nsort_blocks = 1\nrows_per_user = 2\nsilent = 1\n"
)
ROUNDS = 3


def _write_sets(d):
    for split, seed in (("train", 0), ("test", 5)):
        rows, fbs = synth_text(seed, 1)
        (d / f"{split}.feature").write_text(rows)
        (d / f"{split}.feedback").write_text(fbs)


def _read_models(jmodel, d):
    from svdfeature_tpu.params import SVDTypeParam

    out = []
    for r in range(ROUNDS + 1):
        with open(d / "models" / f"{r:04d}.model", "rb") as f:
            m = jmodel.SVDModel.load(f, SVDTypeParam.from_bytes(f.read(4)))
        out.append({n: np.asarray(getattr(m, n)) for n in ("w", "b")})
    return out


def test_cli_slice_matches_jax(tmp_path):
    """make_ugroup_buffer -fd -> SVDTrainTask -> %04d.model per round ->
    SVDInferTask, both packages (the port with device=cpu): every
    checkpoint agrees (atol 1e-5) and so does every round's eval RMSE;
    each package's infer task reads the other's checkpoints to the same
    RMSE."""
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
    from svdfeature_tpu.cli import make_ugroup_buffer as jbuf_cli
    from svdfeature_tpu.infer.task import SVDInferTask as JInfer
    from svdfeature_tpu.train.loop import SVDTrainTask as JTrain
    from svdfeature_tpu_torch.cli import make_ugroup_buffer as tbuf_cli
    from svdfeature_tpu_torch.infer.task import SVDInferTask as TInfer
    from svdfeature_tpu_torch.train.loop import SVDTrainTask as TTrain

    _write_sets(tmp_path)
    run = {"jax": (jbuf_cli, JTrain, JInfer, []), "torch": (tbuf_cli, TTrain, TInfer, ["device=cpu"])}
    rmse, models = {}, {}
    for tag, (buf_cli, train_cls, infer_cls, dev) in run.items():
        d = tmp_path / tag
        d.mkdir()
        for split in ("train", "test"):
            buf_cli.main([str(tmp_path / f"{split}.feature"), str(d / f"{split}.buffer"),
                          "-fd", str(tmp_path / f"{split}.feedback")])
        (d / "t.conf").write_text(
            CONF + extra + f'buffer_feature = "{d}/train.buffer"\ntest:buffer_feature = '
            f'"{d}/test.buffer"\nmodel_out_folder = "{d}/models"\n')
        before = cuda_svdpp.train_rounds_svdpp_kernel.launches
        train_cls().run(str(d / "t.conf"), [f"num_round={ROUNDS}", *dev])
        assert cuda_svdpp.train_rounds_svdpp_kernel.launches == before  # CPU: plain version
        models[tag] = _read_models(jmodel, d)
        for reader, (_, _, reader_cls, rdev) in run.items():
            log = d / f"rmse_by_{reader}.tsv"
            reader_cls().run(str(d / "t.conf"), ["start=0", f"end={ROUNDS + 1}",
                                                 f"log_eval={log}", *rdev])
            rmse[tag, reader] = np.loadtxt(log)
    assert rmse["torch", "torch"].shape == (ROUNDS + 1, 2)
    for key, val in rmse.items():
        np.testing.assert_allclose(val, rmse["jax", "jax"], atol=1e-5, rtol=0, err_msg=str(key))
    for r in range(ROUNDS + 1):
        for n in ("w", "b"):
            np.testing.assert_allclose(models["torch"][r][n], models["jax"][r][n],
                                       atol=1e-5, rtol=0, err_msg=f"round {r} {n}")
    assert not np.allclose(models["torch"][-1]["w"], models["torch"][0]["w"])  # it trained
    assert not np.allclose(rmse["torch", "torch"][-1, 1], rmse["torch", "torch"][0, 1])


def test_update_rounds_equals_update_all():
    """update_rounds (R rounds in one wrapper call, the lr schedule on the
    host) equals R update_all calls, bit for bit, on the CPU."""
    from svdfeature_tpu_torch.params import SVDTypeParam, svd_type
    from svdfeature_tpu_torch.solvers.svdpp import SVDPPFeatureTrainer

    rows, fbs = synth_text(3, 1)
    ds = load_plus_text("x", "y", text=rows, feedback_text=fbs)
    trainers = []
    for _ in range(2):
        tr = SVDPPFeatureTrainer(SVDTypeParam(format_type=svd_type.USER_GROUP_FORMAT))
        for line in CONF.strip().splitlines():
            name, val = (s.strip() for s in line.split("="))
            tr.set_param(name, val)
        for name, val in (("device", "cpu"), ("decay_learning_rate", "1"), ("decay_rate", "0.9")):
            tr.set_param(name, val)
        tr.init_model()
        tr.init_trainer()
        trainers.append(tr)
    a, b = trainers
    for r in range(3):
        a.set_round(r)
        a.update_all(ds)
    b.update_rounds(ds, 3)
    for name in ("w", "b", "step"):
        assert torch.equal(getattr(a.state, name), getattr(b.state, name))
    pa, pb = a.predict_all(ds), b.predict_all(ds)
    assert pa.shape == (ds.rows.num_row,) and np.array_equal(pa, pb)


@pytest.mark.parametrize("key,val,item", [
    # a feedback space shared with the user rows: the refresh epoch, which trains now
    pytest.param("common_feedback_space", "1", None, id="common_feedback_space-1-item 7b"),
    # pairwise rank (input_type=2), which trains now
    pytest.param("input_type", "2", None, id="input_type-2-item 8"),
    # a table over 8192 rows: big-table SVD++, which trains now
    pytest.param("num_ufeedback", "8100", None, id="num_ufeedback-8100-item 9"),
    # a streamed buffer (out-of-core), which trains now
    pytest.param("streaming", "1", None, id="streaming-1-item 11"),
    # a mesh, which trains in a torchrun world: alone, the trainer asks for one
    pytest.param("mesh_data", "2", "torchrun", id="mesh_data-2-item 12"),
    # the attach combinator (input_type 101: the buffer, the text attached), which trains now
    pytest.param("input_type", "101", None, id="input_type-101-item 13"),
])
def test_outside_the_slice_raises_with_roadmap_item(key, val, item, tmp_path):
    """A user-group mesh (ROADMAP items 12b, 12c) trains in a torchrun
    world (tests/test_torch_mesh_plus.py); without one the trainer raises
    ValueError naming torchrun before its first tensor.  A table over 8192 rows,
    a pairwise-rank source, a shared feedback space, an attached text
    source and a streamed buffer (``item`` None) train, on the big-table
    epoch, on the pair skeleton, on the refresh epoch, on the primary
    blocks interleaved with the attached ones (the last two match the JAX
    CLI's checkpoints and eval RMSE) and a chunk at a time."""
    from svdfeature_tpu_torch.cli import make_ugroup_buffer
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    _write_sets(tmp_path)
    make_ugroup_buffer.main([str(tmp_path / "train.feature"), str(tmp_path / "train.buffer"),
                             "-fd", str(tmp_path / "train.feedback")])
    (tmp_path / "t.conf").write_text(
        CONF + f'buffer_feature = "{tmp_path}/train.buffer"\n'
        f'model_out_folder = "{tmp_path}/models"\n')
    args = ["num_round=1", "device=cpu", f"{key}={val}"]
    if key == "input_type":  # ratings of 4 and above the positives, 2 and below the negatives
        args += ["pos_sample_lowerb=4", "neg_sample_upperb=2"]
    if val == "101":
        args += [f"attach:data_in={tmp_path}/train.feature",
                 f"attach:feedback_in={tmp_path}/train.feedback"]
    if item is not None:
        with pytest.raises(ValueError, match=item):
            SVDTrainTask().run(str(tmp_path / "t.conf"), args)
        return
    task = SVDTrainTask()
    task.run(str(tmp_path / "t.conf"), args)
    tr = task.trainer
    if val == "101":
        assert task.dataset.num_block == 2 * NUM_USER and task.dataset.extra_info.sum() == NUM_USER
    elif key == "input_type":
        assert tr._pair_src is task.dataset and tr._pair_sk["use_kernel"]
    elif key == "common_feedback_space":
        assert not tr.hp.big_table and tr.model.off_ufeedback == tr.model.off_user
    elif key == "streaming":
        assert hasattr(task.dataset, "plan_caps") and tr.chunk_stream.stats.chunks == 1
    else:
        assert tr.hp.big_table and "chunk_users" in tr._pack_plus(task.dataset).fb
    assert (tmp_path / "models" / "0001.model").exists()
    assert bool(torch.isfinite(tr.state.w).all()) and int(tr.state.step) > 0
    if key == "common_feedback_space":
        (tmp_path / "cli").mkdir()
        _cli_slice(tmp_path / "cli", "common_feedback_space = 1\n")
    if val == "101":
        cli = tmp_path / "cli"
        cli.mkdir()
        _cli_slice(cli, f'input_type = 101\nattach:data_in = "{cli}/train.feature"\n'
                   f'attach:feedback_in = "{cli}/train.feedback"\n')


def _kernel_vs_plain_on_card(x):
    """One R=2 call of the CUDA kernel against its plain version on the
    card (atomics sum in a varying order, exp(m log d) against pow(d, m):
    atol 1e-5 / rtol 1e-4), with the exact launch count: one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m cuda tests/)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    before = cuda_svdpp.train_rounds_svdpp_kernel.launches
    got = cuda_svdpp.train_rounds_svdpp_kernel(*torch_args(x, dev))
    torch.cuda.synchronize()
    assert cuda_svdpp.train_rounds_svdpp_kernel.launches - before == 1
    assert cuda_svdpp.launches_per_call(x.chunk_id, 2) == 1
    want = cuda_svdpp.train_rounds_svdpp_reference(*torch_args(x, dev))
    for name in ("w", "b"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), atol=1e-5, rtol=1e-4)
    assert int(got.step) == int(want.step)
    assert not torch.equal(got.w, torch.from_numpy(x.st["w"]).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("M,SI,no_user_bias", [(1, 1, 0), (2, 1, 1), (2, 2, 0), (16, 1, 0),
                                               (32, 2, 1)])
def test_kernel_matches_plain_on_card(M, SI, no_user_bias):
    """The persistent kernel against its plain version on the card, R=2;
    above 8 rows per user a block has a warp per row (up to 1024 threads)."""
    _kernel_vs_plain_on_card(plus_inputs(M, SI, no_user_bias))


@pytest.mark.cuda
@pytest.mark.parametrize("k,users_per_step", [(160, 16), (100, 20), (8, 20)])
def test_kernel_shapes_off_the_tiles_on_card(k, users_per_step):
    """Factor counts beyond one gather tile (64) and beyond the columns the
    step keeps in registers (128), not multiples of the product's 8-column
    tiles, and user counts that are not multiples of its 16 rows and 8
    steps of u."""
    _kernel_vs_plain_on_card(plus_inputs(M=2, seed=5, n_users=50, users_per_step=users_per_step,
                                         k=k))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2])
def test_kernel_strides_over_users_above_the_grid(M):
    """More users per step than the resident grid has blocks (256 against
    one block per SM): every block takes several users of a step."""
    x = plus_inputs(M=M, n_users=600, users_per_step=256, seed=4)
    _kernel_vs_plain_on_card(x)
    assert 0 < cuda_svdpp.train_rounds_svdpp_kernel.grid < 256 == x.G
