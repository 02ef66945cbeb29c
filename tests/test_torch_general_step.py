"""The general train step of the small-table route (ops/embed.train_rounds)
against the JAX package's jnp ``train_rounds`` (svdfeature_tpu/ops/embed.py).

Tiny shapes (N=64 rows, k=8, B=16, T=3, R=2), inputs from a numpy seed,
handed to both packages.  The cases cover what K1 does not take and only
the plain rounds train: every reg_method 0-5 against reg_global 0, 1 and
4; the nonnegative clamps; active_type 0, 2, 5 and 6; two-entry user and
item segments (hierarchical side features); 12 global entries per example
over 1100 global slots; no_user_bias.  w, b, g and the lazy refs agree
within atol 1e-6 (the two differ only in summation order), the step
counter exactly.
"""

import numpy as np
import pytest
import torch

from svdfeature_tpu_torch import convert
from svdfeature_tpu_torch.ops import embed
from svdfeature_tpu_torch.ops.embed import HyperParams

N, K, B, T, R = 64, 8, 16, 3, 2


def make_inputs(Su=2, Si=2, NG=1100, SG=12, active_type=0, seed=0):
    """numpy (state, consts, stacked, lrs): users [0, 31), items [31, 63),
    the dummy row 63; NG-1 global slots and the dummy; the last examples
    padding, as pack_csr writes it; lazy refs from earlier steps."""
    rng = np.random.RandomState(seed)
    half = (N - 1) // 2
    st = dict(
        w=rng.normal(0, 0.1, (N, K)).astype(np.float32),
        b=rng.normal(0, 0.05, N).astype(np.float32),
        g=rng.normal(0, 0.05, NG).astype(np.float32),
        step=np.int32(40),
        ref_ui=rng.randint(0, 40, N).astype(np.int32),
        ref_g=rng.randint(0, 40, NG).astype(np.int32),
    )
    st["w"][-1] = st["b"][-1] = st["g"][-1] = 0.0
    st["ref_ui"][-1] = 0
    wd_u = np.zeros(N, np.float32)
    wd_i = np.zeros(N, np.float32)
    wd_u[:half] = 0.05
    wd_i[half:N - 1] = 0.08
    wd_g = np.full(NG, 0.02, np.float32)
    wd_g[:3] = 0.0  # regfree globals
    wd_g[-1] = 0.0
    cs = dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=wd_g,
              wd_user_bias=np.float32(0.01), wd_item_bias=np.float32(0.02))
    ratings = rng.randint(1, 6, (T, B)).astype(np.float32)
    stacked = dict(
        label=ratings if active_type == 0 else (ratings >= 4).astype(np.float32),
        weight=np.ones((T, B), np.float32),
        u_idx=rng.randint(0, half, (T, B, Su)).astype(np.int32),
        u_val=rng.uniform(0.5, 1.0, (T, B, Su)).astype(np.float32),
        i_idx=(half + rng.randint(0, half, (T, B, Si))).astype(np.int32),
        i_val=rng.uniform(0.5, 1.0, (T, B, Si)).astype(np.float32),
        g_idx=rng.randint(0, max(NG - 1, 1), (T, B, SG)).astype(np.int32),
        g_val=rng.uniform(0.0, 0.3, (T, B, SG)).astype(np.float32),
    )
    pad = rng.rand(T, B, SG) < 0.25
    stacked["g_idx"][pad] = NG - 1
    stacked["g_val"][pad] = 0.0
    for p in ("u", "i"):
        stacked[f"{p}_idx"][-1, -3:] = N - 1
        stacked[f"{p}_val"][-1, -3:] = 0.0
    stacked["weight"][-1, -3:] = 0.0
    return st, cs, stacked, np.array([0.05, 0.04], np.float32)


CASES = {
    **{f"reg{m}-global{gm}": dict(hp=dict(reg_method=m, reg_global=gm))
       for m in range(6) for gm in (0, 1, 4)},
    "user_nonneg": dict(hp=dict(user_nonnegative=1)),
    "item_nonneg-reg4": dict(hp=dict(item_nonnegative=1, reg_method=4)),
    "active2": dict(hp=dict(active_type=2, base_score=0.0)),
    "active5": dict(hp=dict(active_type=5, base_score=0.5)),
    "active6-reg5": dict(hp=dict(active_type=6, base_score=0.5, reg_method=5)),
    "no_user_bias-reg3": dict(hp=dict(no_user_bias=1, reg_method=3)),
    "single-segments-reg1": dict(hp=dict(reg_method=1), Su=1, Si=1, NG=7, SG=3),
    "no-globals-reg4": dict(hp=dict(reg_method=4, reg_global=4), NG=1, SG=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_rounds_matches_jax(case):
    """R=2 rounds of the port's embed.train_rounds against the JAX
    package's jnp train_rounds."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from svdfeature_tpu.ops import embed as jembed

    spec = dict(CASES[case])
    hp_kw = {"base_score": 3.0, **spec.pop("hp")}
    NG, SG = spec.pop("NG", 1100), spec.pop("SG", 12)
    at = hp_kw.get("active_type", 0)
    st, cs, stacked, lrs = make_inputs(NG=NG, SG=SG, active_type=at, **spec)
    if NG == 1:  # no global features: every entry on the dummy slot
        stacked["g_idx"][:] = 0
        stacked["g_val"][:] = 0.0
    out = embed.train_rounds(
        convert.state_from_numpy(**st, device=torch.device("cpu")),
        convert.stacked_from_numpy(stacked, torch.device("cpu")), torch.tensor(lrs),
        convert.consts_from_numpy(**cs, device=torch.device("cpu")), HyperParams(**hp_kw))
    want = jembed.train_rounds(
        jembed.TrainState(**{n: jnp.asarray(v) for n, v in st.items()}),
        {n: jnp.asarray(v) for n, v in stacked.items()}, jnp.asarray(lrs),
        jembed.TrainConsts(**{n: jnp.asarray(v) for n, v in cs.items()}),
        jembed.HyperParams(**hp_kw))
    for name in ("w", "b", "g"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    for name in ("ref_ui", "ref_g", "step"):
        assert np.array_equal(getattr(out, name).numpy(), np.asarray(getattr(want, name))), name
    assert int(out.step) == 40 + R * int((stacked["weight"] > 0).sum())
    assert not np.allclose(out.w.numpy(), st["w"])  # it trained
    assert (out.w[-1] == 0).all() and out.b[-1] == 0 and out.g[-1] == 0
    if hp_kw.get("reg_method", 0) >= 4:
        assert out.ref_ui[-1] == 0 and (out.ref_ui.numpy() != st["ref_ui"]).any()
    if hp_kw.get("user_nonnegative") or hp_kw.get("item_nonnegative"):
        assert (out.w.numpy() < 0).any()  # untouched rows keep their sign
