"""The per-batch refresh epochs of a feedback space shared with the user
rows (common_feedback_space=1) against the JAX package: ops/svdpp
``_plus_step`` / ``train_epoch_plus_refresh`` and ops/imfb ``_imfb_step`` /
``train_epoch_imfb``, and ops/embed.general_step without its two hooks
bit for bit against its form before them.

The synthetic sets model follow feedback: the feedback ids of a user's
block are user ids (rows [0, 40) of the table are both the users and the
pool), so a step's row updates move the rows its pool reads.  The same
seeded numpy inputs go to both packages; state after R=2 rounds agrees
within atol 1e-6 (the two differ only in summation order).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_general_step import make_inputs as general_inputs
from test_torch_imfb import enabled_of, stack_depth2
from test_torch_svdpp import with_general

from svdfeature_tpu_torch import convert, losses
from svdfeature_tpu_torch.data.batching_imfb import pack_imfb
from svdfeature_tpu_torch.data.batching_plus import pack_plus
from svdfeature_tpu_torch.data.text import load_plus_text
from svdfeature_tpu_torch.ops import embed, imfb, svdpp
from svdfeature_tpu_torch.ops.embed import HyperParams
from svdfeature_tpu_torch.ops.svdpp import PlusHyper

CPU = torch.device("cpu")
# users [0, 40) (also the feedback pool), items [40, 140), dummy 140
NUM_USER, NUM_ITEM = 40, 100
N = NUM_USER + NUM_ITEM + 1
FBH = dict(scale_lr_ufeedback=1.0, wd_ufeedback=0.004, wd_ufeedback_bias=0.002)
STATE = ("w", "b", "g", "ref_ui", "ref_g", "step")


def follow_text(seed, n_users=NUM_USER):
    """(rows, feedback) text: 1-6 rows per user, 2-6 followed users each
    (value 1/sqrt(n), as chip_smoke.py's follow feedback)."""
    rng = np.random.RandomState(seed)
    rows, fbs = [], []
    for u in range(n_users):
        r = rng.randint(1, 7)
        rows += [f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, NUM_ITEM)}:1"
                 for _ in range(r)]
        nf = rng.randint(2, 7)
        ids = rng.choice(n_users, size=nf, replace=False)
        fbs.append(f"{r} {nf} " + " ".join(f"{j}:{1 / np.sqrt(nf):.6f}" for j in ids))
    return "\n".join(rows) + "\n", "\n".join(fbs) + "\n"


def _arrays(packed, seed):
    rng = np.random.RandomState(seed)
    w = rng.normal(0, 0.1, (N, 8)).astype(np.float32)
    b = rng.normal(0, 0.01, N).astype(np.float32)
    w[-1] = b[-1] = 0.0
    wd_u = np.zeros(N, np.float32)
    wd_i = np.zeros(N, np.float32)
    wd_u[:NUM_USER] = 0.004
    wd_i[NUM_USER:N - 1] = 0.004
    stacked = packed.device_arrays()
    return dict(st=dict(w=w, b=b, g=np.zeros(1, np.float32), step=np.int32(0),
                        ref_ui=np.zeros(N, np.int32), ref_g=np.zeros(1, np.int32)),
                cs=dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=np.zeros(1, np.float32),
                        wd_user_bias=np.float32(0.002), wd_item_bias=np.float32(0.002)),
                chunk_id=stacked.pop("chunk_id"), stacked=stacked, fb=packed.fb_arrays(),
                lrs=np.full(2, 0.01, np.float32), overlap=None)


def plus_inputs(M, seed=0):
    """A shared-space user-group case: 16 users a step (3 chunks), k=8."""
    rows, fbs = follow_text(seed)
    packed = pack_plus(load_plus_text("x", "y", text=rows, feedback_text=fbs), 16, N - 1, 0, 0,
                       NUM_USER, 0, num_user=NUM_USER, num_item=NUM_ITEM, num_ufeedback=NUM_USER,
                       rows_per_user=M)
    assert packed.fb_idx.shape[0] == 3
    return SimpleNamespace(**_arrays(packed, seed + 1), hp=dict(base_score=3.0),
                           ph=PlusHyper(rows_per_user=M, off_user=0, **FBH))


def imfb_inputs(M, seed=0):
    """The depth-2 stacked transform of a shared-space case: 8 units a step."""
    rows, fbs = follow_text(seed)
    ds = stack_depth2(load_plus_text("x", "y", text=rows, feedback_text=fbs))
    packed = pack_imfb(ds, 8, N - 1, 0, 0, NUM_USER, 0, num_user=NUM_USER, num_item=NUM_ITEM,
                       num_ufeedback=NUM_USER, rows_per_user=M)
    assert packed.fb_idx.shape[0] >= 3 and packed.ctx_slots.shape[-1] == 2
    return SimpleNamespace(**_arrays(packed, seed + 1), enabled=enabled_of(packed.ctx_depth),
                           hp=dict(base_score=3.0),
                           ph=PlusHyper(rows_per_user=M, off_user=0, **FBH))


CASES = {
    "reg0-M1": (1, {}, False),
    "reg0-M4-global": (4, {}, True),
    "no_user_bias-M4": (4, dict(no_user_bias=1), False),
    "reg1-global1-M1": (1, dict(reg_method=1, reg_global=1), True),
    "reg4-global4-M4": (4, dict(reg_method=4, reg_global=4), True),
    "reg4-M1-no_user_bias": (1, dict(reg_method=4, no_user_bias=1), False),
    "user_nonneg-M4": (4, dict(user_nonnegative=1), False),
}


def case(make, name):
    M, hp, glob = CASES[name]
    x = make(M)
    if glob:  # a global segment (7 slots, 2 entries a row), decaying
        return with_general(x, hp)
    x.hp = dict(x.hp, **hp)
    return x


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from svdfeature_tpu.ops import embed as jembed
    from svdfeature_tpu.ops import imfb as jimfb
    from svdfeature_tpu.ops import svdpp as jsvdpp

    return SimpleNamespace(jnp=jnp, embed=jembed, svdpp=jsvdpp, imfb=jimfb)


def port_state(x):
    return convert.state_from_numpy(**x.st, device=CPU)


def port_common(x):
    fb, _ = convert.pool_from_numpy(x.fb, None, CPU)
    return (convert.stacked_from_numpy(x.stacked, CPU), x.chunk_id, fb,
            convert.consts_from_numpy(**x.cs, device=CPU))


def jax_common(jx, x):
    jnp = jx.jnp
    return (jx.embed.TrainState(**{k: jnp.asarray(v) for k, v in x.st.items()}),
            {k: jnp.asarray(v) for k, v in x.stacked.items()}, jnp.asarray(x.chunk_id),
            {k: jnp.asarray(v) for k, v in x.fb.items()},
            jx.embed.TrainConsts(**{k: jnp.asarray(v) for k, v in x.cs.items()}),
            jx.embed.HyperParams(**x.hp))


def assert_state(got, want, x):
    for name in STATE:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name in ("w", "b", "g"):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=name)
        else:
            assert np.array_equal(a, b), name
    assert not np.allclose(got.w.numpy()[:NUM_USER], x.st["w"][:NUM_USER])  # users / pool trained
    assert got.w[-1].abs().sum() == 0 and got.b[-1] == 0


def plus_refresh(x, hp=None):
    state = port_state(x)
    stacked, cid, fb, consts = port_common(x)
    for lr in torch.tensor(x.lrs):
        state = svdpp.train_epoch_plus_refresh(state, stacked, cid, fb, lr, consts,
                                               HyperParams(**(hp or x.hp)), x.ph)
    return state


def imfb_refresh(x, hp=None):
    state = port_state(x)
    stacked, cid, fb, consts = port_common(x)
    enabled = convert.gate_from_numpy(x.enabled, CPU)
    for lr in torch.tensor(x.lrs):
        state = imfb.train_epoch_imfb(state, stacked, cid, fb, enabled, lr, consts,
                                      HyperParams(**(hp or x.hp)), x.ph)
    return state


@pytest.mark.parametrize("name", list(CASES))
def test_plus_refresh_matches_jax(jx, name):
    """R=2 rounds of train_epoch_plus_refresh against the JAX package's."""
    x = case(plus_inputs, name)
    got = plus_refresh(x)
    state, stacked, cid, fb, consts, hp = jax_common(jx, x)
    for lr in x.lrs:
        state = jx.svdpp.train_epoch_plus_refresh(state, stacked, cid, fb, jx.jnp.float32(lr),
                                                  consts, hp, *FBH.values(),
                                                  rows_per_user=x.ph.rows_per_user)
    assert_state(got, state, x)
    assert int(got.step) == 2 * int((x.stacked["weight"] > 0).sum())


@pytest.mark.parametrize("name", list(CASES))
def test_imfb_refresh_matches_jax(jx, name):
    """R=2 rounds of the stacked train_epoch_imfb against the JAX package's."""
    x = case(imfb_inputs, name)
    got = imfb_refresh(x)
    state, stacked, cid, fb, consts, hp = jax_common(jx, x)
    for lr in x.lrs:
        state = jx.imfb.train_epoch_imfb(state, stacked, cid, fb, jx.jnp.asarray(x.enabled),
                                         jx.jnp.float32(lr), consts, hp, *FBH.values(),
                                         rows_per_user=x.ph.rows_per_user)
    assert_state(got, state, x)


def test_imfb_refresh_applies_no_clamps():
    """The JAX package's stacked refresh step applies no nonnegative clamps
    (ops/imfb.py:151-171), where the SVD++ refresh step does: the flags
    leave the stacked trajectory as it is and change the SVD++ one."""
    x = imfb_inputs(4)
    off = imfb_refresh(x)
    on = imfb_refresh(x, dict(x.hp, user_nonnegative=1, item_nonnegative=1))
    for name in ("w", "b"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name
    assert bool((on.w[:NUM_USER] < 0).any())
    y = plus_inputs(4)
    assert not torch.equal(plus_refresh(y).w,
                           plus_refresh(y, dict(y.hp, user_nonnegative=1)).w)


def test_refresh_differs_from_carried_under_shared_space():
    """Under a shared space the carried epoch's closed form does not hold:
    the refresh trajectory parts from train_epoch_plus run on the same
    packing (with the overlap it would need), which is why the solvers
    route the shared space to the refresh epoch."""
    from svdfeature_tpu_torch.data.batching_plus import compute_fb_overlap

    x = plus_inputs(1)
    got = plus_refresh(x)
    state = port_state(x)
    stacked, cid, fb, consts = port_common(x)
    ov = torch.from_numpy(compute_fb_overlap(x.fb["fb_idx"], x.fb["fb_val"], x.fb["fb_block"], 16))
    for lr in torch.tensor(x.lrs):
        state = svdpp.train_epoch_plus(state, stacked, cid, fb, ov, lr, consts,
                                       HyperParams(**x.hp), x.ph)
    assert np.abs(got.w.numpy() - state.w.numpy()).max() > 1e-6


# ---- general_step without its hooks, bit for bit -------------------------------
def _general_step_before(state, batch, lr, consts, hp, p_u_extra=None, bias_extra=None):
    """ops/embed.general_step as it was before ``bias_plugin`` and
    ``after_scatter`` (the same helpers, the same order of operations)."""
    w, b, g = state.w, state.b, state.g
    u_idx, i_idx, g_idx = batch["u_idx"], batch["i_idx"], batch["g_idx"]
    cu = embed._touch_counts(w.shape[0], u_idx)
    ci = embed._touch_counts(w.shape[0], i_idx)
    cg = embed._touch_counts(g.shape[0], g_idx)
    embed._lazy_catchup(state, cu, ci, cg, lr, consts, hp)
    p_u = embed._gather_sum(w, u_idx, batch["u_val"])
    p_i = embed._gather_sum(w, i_idx, batch["i_val"])
    if p_u_extra is not None:
        p_u = p_u + p_u_extra
    score = hp.base_score + embed._gather_sum(g, g_idx, batch["g_val"])
    score = score + embed._gather_sum(b, i_idx, batch["i_val"])
    if not hp.no_user_bias:
        score = score + embed._gather_sum(b, u_idx, batch["u_val"])
        if bias_extra is not None:
            score = score + bias_extra
    score = score + (p_u * p_i).sum(dim=1)
    pred = losses.map_active(score, hp.active_type)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]
    lr_err = lr * err
    g.copy_(embed._update_global(g, g_idx, batch["g_val"], err, lr, hp.exact_global))
    coef_u = lr_err[:, None] * batch["u_val"]
    coef_i = lr_err[:, None] * batch["i_val"]
    embed._scatter_rows(w, u_idx, coef_u, p_i)
    embed._scatter_rows(w, i_idx, coef_i, p_u)
    embed._scatter_vals(b, i_idx, coef_i)
    if not hp.no_user_bias:
        embed._scatter_vals(b, u_idx, coef_u)
    if hp.reg_method < 4:
        w.copy_(embed._apply_factor_reg(w, cu, ci, lr, consts.wd_u_row, consts.wd_i_row,
                                        hp.reg_method))
    if hp.reg_global == 0:
        g.mul_(torch.pow(1.0 - lr * consts.wd_g_row, cg))
    elif hp.reg_global == 1:
        g.copy_(embed._soft_threshold(g, lr * consts.wd_g_row * cg))
    fac_b = torch.pow(1.0 - lr * consts.wd_item_bias, ci)
    if not hp.no_user_bias:
        fac_b = fac_b * torch.pow(1.0 - lr * consts.wd_user_bias, cu)
    b.mul_(fac_b)
    if hp.user_nonnegative:
        w.copy_(torch.where((cu > 0)[:, None], torch.clamp(w, min=0.0), w))
    if hp.item_nonnegative:
        w.copy_(torch.where((ci > 0)[:, None], torch.clamp(w, min=0.0), w))
    w[-1] = 0.0
    b[-1] = 0.0
    g[-1] = 0.0
    nstep = state.step + (batch["weight"] > 0).sum().to(torch.int32)
    return dataclasses.replace(state, step=nstep), err, p_i


@pytest.mark.parametrize("hp", [
    dict(), dict(reg_method=1, reg_global=1), dict(reg_method=4, reg_global=4),
    dict(no_user_bias=1, user_nonnegative=1, item_nonnegative=1), dict(active_type=5)],
    ids=["reg0", "reg1", "reg4", "nub-clamps", "hinge5"])
@pytest.mark.parametrize("extra", [False, True], ids=["plain", "feedback"])
def test_general_step_without_hooks_bit_for_bit(hp, extra):
    """general_step with neither new argument gives the numbers of its form
    before them, bit for bit, over three steps (with and without the SVD++
    feedback term)."""
    st, cs, stacked, lrs = general_inputs(NG=7, SG=3)
    hp = HyperParams(base_score=0.5 if hp.get("active_type") else 3.0, **hp)
    consts = convert.consts_from_numpy(**cs, device=CPU)
    planes = convert.stacked_from_numpy(stacked, CPU)
    rng = np.random.RandomState(5)
    B, k = stacked["label"].shape[1], st["w"].shape[1]
    pue = torch.from_numpy(rng.normal(0, 0.1, (B, k)).astype(np.float32)) if extra else None
    bxe = torch.from_numpy(rng.normal(0, 0.1, B).astype(np.float32)) if extra else None
    a = convert.state_from_numpy(**st, device=CPU)
    b = convert.state_from_numpy(**st, device=CPU)
    for t in range(stacked["label"].shape[0]):
        batch = {p: planes[p][t] for p in embed._PLANES}
        lr = torch.tensor(lrs[0])
        a, err_a, pi_a = embed.general_step(a, batch, lr, consts, hp, pue, bxe)
        b, err_b, pi_b = _general_step_before(b, batch, lr, consts, hp, pue, bxe)
        assert torch.equal(err_a, err_b) and torch.equal(pi_a, pi_b)
    for name in STATE:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
