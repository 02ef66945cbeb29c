"""The port's sorted-dedup big-table step (ops/big_embed.py) against the
JAX package's ``train_step_big``.

Same numpy inputs (the patterns of tests/test_big_embed.py: a 50-row
table, k=4, 16 examples with 2-entry user and 3-entry item segments, a
global segment, random lazy refs), two chained steps on each side through
the augmented layout, compared de-augmented: w / b / g within atol 1e-6
(summation order and pow implementations; measured up to 1.2e-7), the
lazy refs and the sample counter exactly.  Also the dedup merge itself,
the carry-over of the JAX package's 128-lane augmented table, and the
route the solver picks for a conf.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svdfeature_tpu.ops import big_embed as jbig
from svdfeature_tpu.ops import embed as jembed
from svdfeature_tpu_torch import convert
from svdfeature_tpu_torch.ops import big_embed as tbig
from svdfeature_tpu_torch.ops.embed import HyperParams

from test_big_embed import make_inputs

CPU = torch.device("cpu")
K = 4
ATOL = 1e-6
STATE = ("w", "b", "g", "step", "ref_ui", "ref_g")
CONSTS = ("wd_u_row", "wd_i_row", "wd_g_row", "wd_user_bias", "wd_item_bias")


def np_inputs(seed, **kw):
    """make_inputs of tests/test_big_embed.py as numpy copies."""
    state, batch, consts = make_inputs(seed, **kw)
    return ({n: np.array(getattr(state, n)) for n in STATE},
            {n: np.array(v) for n, v in batch.items()},
            {n: np.array(getattr(consts, n)) for n in CONSTS})


def jax_steps(st, batches, cs, hp, lr=0.05):
    """JAX train_step_big over the batches -> de-augmented numpy state."""
    state = jbig.augment_state(jembed.TrainState(**{n: jnp.asarray(v) for n, v in st.items()}), K)
    consts = jembed.TrainConsts(**{n: jnp.asarray(v) for n, v in cs.items()})
    hp = jembed.HyperParams(**dataclasses.asdict(hp))
    for batch in batches:
        state = jbig.train_step_big(state, {n: jnp.asarray(v) for n, v in batch.items()},
                                    jnp.float32(lr), consts, hp)
    out = jbig.deaugment_state(state, K)
    return {n: np.asarray(getattr(out, n)) for n in STATE}


def torch_steps(st, batches, cs, hp, lr=0.05):
    """The port's plain train_step_big over the batches -> de-augmented numpy state."""
    state = tbig.augment_state(convert.state_from_numpy(**st, device=CPU), K)
    consts = convert.consts_from_numpy(**cs, device=CPU)
    for batch in batches:
        state = tbig.train_step_big(state, convert.stacked_from_numpy(batch, CPU),
                                    torch.tensor(lr), consts, hp)
    out = tbig.deaugment_state(state, K)
    return {n: getattr(out, n).numpy() for n in STATE}


def assert_same(got, want):
    for n in ("w", "b", "g"):
        np.testing.assert_allclose(got[n], want[n], atol=ATOL, rtol=0, err_msg=n)
    for n in ("ref_ui", "ref_g", "step"):
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def two_batches(seed, **kw):
    st, b1, cs = np_inputs(seed, **kw)
    _, b2, _ = np_inputs(seed + 100, **kw)
    return st, [b1, b2], cs


def big_hp(**kw):
    return HyperParams(big_table=True, num_factor=K, base_score=3.0, **kw)


@pytest.mark.parametrize("reg", [0, 1, 2, 3, 4, 5])
def test_big_step_matches_jax(reg):
    st, batches, cs = two_batches(reg + 1)
    hp = big_hp(reg_method=reg)
    got = torch_steps(st, batches, cs, hp)
    assert_same(got, jax_steps(st, batches, cs, hp))
    assert not np.allclose(got["w"], st["w"])  # it trained


@pytest.mark.parametrize("rg", [0, 1, 4, 5])
def test_big_step_global_modes_match_jax(rg):
    st, batches, cs = two_batches(11)
    hp = big_hp(reg_global=rg)
    assert_same(torch_steps(st, batches, cs, hp), jax_steps(st, batches, cs, hp))


def test_big_no_user_bias_nonneg_matches_jax():
    st, batches, cs = two_batches(3)
    hp = big_hp(no_user_bias=1, user_nonnegative=1, item_nonnegative=1)
    got = torch_steps(st, batches, cs, hp)
    assert_same(got, jax_steps(st, batches, cs, hp))
    touched = np.unique(np.concatenate([b["u_idx"].ravel() for b in batches]))
    assert (got["w"][touched] >= 0).all()


def test_big_exact_global_batch1_matches_jax():
    st, batches, cs = two_batches(5, B=1, Su=1, Si=1)
    hp = big_hp(exact_global=True)
    assert_same(torch_steps(st, batches, cs, hp), jax_steps(st, batches, cs, hp))


@pytest.mark.parametrize("reg", [0, 4])
def test_big_padding_rows_match_jax(reg):
    """Padding examples (dummy-row targets, weight 0) leave the dummy row
    at exactly 0 and do not disturb the real rows."""
    st, batches, cs = two_batches(7)
    n, ng = st["w"].shape[0], st["g"].shape[0]
    for b in batches:
        b["weight"][-4:] = 0.0
        b["u_idx"][-4:] = n - 1
        b["i_idx"][-4:] = n - 1
        b["g_idx"][-4:] = ng - 1
    hp = big_hp(reg_method=reg)
    got = torch_steps(st, batches, cs, hp)
    assert_same(got, jax_steps(st, batches, cs, hp))
    assert (got["w"][-1] == 0).all() and got["b"][-1] == 0 and got["ref_ui"][-1] == 0


def test_big_heavy_duplicates_match_jax():
    """Many entries per row: long runs in the cumsum merge."""
    st, batches, cs = two_batches(33, B=64, Su=2, Si=2)
    rng = np.random.RandomState(7)
    for b in batches:
        b["u_idx"] = rng.randint(0, 3, (64, 2)).astype(np.int32)
        b["i_idx"] = rng.randint(20, 24, (64, 2)).astype(np.int32)
    hp = big_hp(reg_method=4)
    assert_same(torch_steps(st, batches, cs, hp), jax_steps(st, batches, cs, hp))


def test_carry_over_jax_augmented_table():
    """The JAX package's 128-lane augmented table, carried into the port
    (``convert.augmented_from_numpy``) bit for bit, then one more step on
    each side (lazy mode: the refs are read as int bits)."""
    st, (b1, b2), cs = two_batches(41)
    hp = big_hp(reg_method=4)
    jhp = jembed.HyperParams(**dataclasses.asdict(hp))
    consts = jembed.TrainConsts(**{n: jnp.asarray(v) for n, v in cs.items()})
    js = jbig.augment_state(jembed.TrainState(**{n: jnp.asarray(v) for n, v in st.items()}), K)
    js = jbig.train_step_big(js, {n: jnp.asarray(v) for n, v in b1.items()}, jnp.float32(0.05),
                             consts, jhp)
    aug = np.array(js.w)
    assert aug.shape[1] == 128 and tbig.aug_width(K) == 8
    ts = convert.state_from_numpy(np.zeros((1, K)), np.zeros(1), np.array(js.g), int(js.step),
                                  np.zeros(1), np.array(js.ref_g), device=CPU)
    ts = dataclasses.replace(ts, w=convert.augmented_from_numpy(aug, K, CPU))
    w, b, ref = convert.augmented_to_numpy(ts.w, K)
    np.testing.assert_array_equal(w, aug[:, :K])
    np.testing.assert_array_equal(b, aug[:, K])
    np.testing.assert_array_equal(ref, aug[:, K + 1].view(np.int32))
    assert ref.max() > 0
    js = jbig.train_step_big(js, {n: jnp.asarray(v) for n, v in b2.items()}, jnp.float32(0.05),
                             consts, jhp)
    ts = tbig.train_step_big(ts, convert.stacked_from_numpy(b2, CPU), torch.tensor(0.05),
                             convert.consts_from_numpy(**cs, device=CPU), hp)
    jo = jbig.deaugment_state(js, K)
    to = tbig.deaugment_state(ts, K)
    assert_same({n: getattr(to, n).numpy() for n in STATE},
                {n: np.asarray(getattr(jo, n)) for n in STATE})


def test_augment_round_trip_keeps_ref_bits():
    """Ref counters below 2^23 are denormal float bit patterns: they
    survive augment -> deaugment unchanged, padding rows are zero."""
    st, _, _ = np_inputs(2)
    st["ref_ui"][:5] = [1, 2, 3, 1 << 22, (1 << 31) - 1]
    aug = tbig.augment_state(convert.state_from_numpy(**st, device=CPU), K, pad_rows_to=16)
    n = st["w"].shape[0]
    assert aug.w.shape == (64, 8) and (aug.w[n:] == 0).all()
    back = tbig.deaugment_state(aug, K, n_rows=n)
    np.testing.assert_array_equal(back.ref_ui.numpy(), st["ref_ui"])
    np.testing.assert_array_equal(back.w.numpy(), st["w"])
    np.testing.assert_array_equal(back.b.numpy(), st["b"])


@pytest.mark.parametrize("with_layout", [False, True])
def test_sorted_dedup_matches_jax(with_layout):
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 10, 64).astype(np.int32)
    pay = rng.normal(0, 1, (64, 5)).astype(np.float32)
    jl = tl = None
    if with_layout:
        jl = jbig.make_dedup_layout(idx)
        tl_np = tbig.make_dedup_layout(idx)
        for a, b in zip(jl, tl_np):
            np.testing.assert_array_equal(a, b)
        tl = tuple(torch.from_numpy(a).long() if a.dtype != bool else torch.from_numpy(a)
                   for a in tl_np)
        jl = tuple(jnp.asarray(a) for a in jl)
    jo = jbig.sorted_dedup(jnp.asarray(idx), jnp.asarray(pay), jl)
    to = tbig.sorted_dedup(torch.from_numpy(idx), torch.from_numpy(pay), tl)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))  # order
    np.testing.assert_array_equal(to[1].numpy(), np.asarray(jo[1]))  # sorted rows
    np.testing.assert_array_equal(to[4].numpy(), np.asarray(jo[4]))  # last
    # unit-scale payloads: XLA's f32 cumsum against torch's (a double
    # accumulator on the CPU) differ by a few ulp of sums up to ~8
    np.testing.assert_allclose(to[2].numpy(), np.asarray(jo[2]), atol=1e-5, rtol=0)
    want = np.zeros((10, 5), np.float32)
    np.add.at(want, idx, pay)
    last = to[4].numpy()
    np.testing.assert_allclose(to[2].numpy()[last], want[to[1].numpy()[last]], atol=1e-5)


@pytest.mark.parametrize("E", [1, 63, 64, 65, 4097, 70_000])
def test_blocked_cumsum_is_the_prefix_sum(E):
    """The dedup merge's blocked scan gives the prefix sums of the plain
    cumsum (float64 on the host as the yardstick)."""
    x = np.random.RandomState(E).normal(0, 1, (E, 3)).astype(np.float32)
    got = tbig._cumsum_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64), axis=0), atol=1e-4, rtol=0)


# (num_user + num_item, batch_size, big_sweep): both sides of 8192 table
# rows (dummy included) and of the sweep auto rule 2B >= tiles * 512
ROUTES = [
    (8190, 4096, -1), (8191, 4096, -1), (8192, 4096, -1), (8191, 64, 1),
    (10000, 1279, -1), (10000, 1280, -1), (10000, 4096, 0), (10000, 64, 1),
    (50000, 6143, -1), (50000, 6400, -1), (50000, 100000, 0),
]


@pytest.mark.parametrize("rows,batch_size,big_sweep", ROUTES)
def test_route_matches_jax_solver(rows, batch_size, big_sweep):
    """The port's solver picks the JAX solver's route for the same conf:
    hp.big_table and hp.sweep_table equal ``_build_hp``'s."""
    from svdfeature_tpu.params import SVDTypeParam as JType
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer as JTrainer
    from svdfeature_tpu_torch.params import SVDTypeParam as TType
    from svdfeature_tpu_torch.solvers.base import SVDFeatureTrainer as TTrainer

    params = [("num_user", str(rows // 2)), ("num_item", str(rows - rows // 2)),
              ("num_factor", "2"), ("batch_size", str(batch_size)),
              ("big_sweep", str(big_sweep)), ("device", "cpu")]
    hps = []
    for cls, mtype in ((JTrainer, JType()), (TTrainer, TType())):
        tr = cls(mtype)
        for k, v in params:
            tr.set_param(k, v)
        tr.init_model()
        hps.append(tr._build_hp())
    jhp, thp = hps
    assert (thp.big_table, thp.sweep_table, thp.num_factor) == (
        jhp.big_table, jhp.sweep_table, jhp.num_factor)
    assert thp.big_table == (rows + 1 > 8192)
