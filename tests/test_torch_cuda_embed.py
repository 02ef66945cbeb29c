"""The port's batched SGD (ops/cuda_embed.py) against the JAX package.

The plain PyTorch version, the general rounds ``embed.train_rounds``
(tests/test_torch_general_step.py holds them in every configuration), is
held against the f32 jnp ``train_rounds`` and against the TPU kernel
``train_rounds_pallas(precise=True)`` run in interpret mode, on the
shapes of tests/test_pallas.py (N=256, k=8, B=128, T=4, R=2).  The
CUDA kernel is held against the plain version on the card only.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svdfeature_tpu_torch import convert
from svdfeature_tpu_torch.ops import _plans, cuda_embed, embed
from svdfeature_tpu_torch.ops.embed import HyperParams

CPU = torch.device("cpu")


def make_inputs(active_type=0, NG=1, SG=1, N=256, k=8, B=128, T=4, R=2, seed=0):
    """numpy inputs of tests/test_pallas.py's make_inputs / make_inputs_g
    (NG > 1: a global segment with NG-1 real slots + dummy, SG entries per
    example, some padded to the dummy with value 0)."""
    rng = np.random.RandomState(seed)
    half = (N - 1) // 2
    st = dict(
        w=rng.normal(0, 0.01, (N, k)).astype(np.float32),
        b=rng.normal(0, 0.01, (N,)).astype(np.float32),
        g=np.zeros((NG,), np.float32),
        step=np.int32(0),
        ref_ui=np.zeros((N,), np.int32),
        ref_g=np.zeros((NG,), np.int32),
    )
    st["w"][-1] = 0.0
    st["b"][-1] = 0.0
    cs = dict(
        wd_u_row=np.full((N,), 0.004, np.float32),
        wd_i_row=np.full((N,), 0.004, np.float32),
        wd_g_row=np.zeros((NG,), np.float32),
        wd_user_bias=np.float32(0.002),
        wd_item_bias=np.float32(0.002),
    )
    cs["wd_u_row"][-1] = cs["wd_i_row"][-1] = 0.0
    ratings = rng.randint(1, 6, (T, B)).astype(np.float32)
    label = ratings if active_type == 0 else (ratings >= 4).astype(np.float32)
    stacked = dict(
        label=label,
        weight=np.ones((T, B), np.float32),
        g_idx=np.zeros((T, B, SG), np.int32),
        g_val=np.zeros((T, B, SG), np.float32),
        u_idx=rng.randint(0, half, (T, B, 1)).astype(np.int32),
        u_val=np.ones((T, B, 1), np.float32),
        i_idx=(half + rng.randint(0, half, (T, B, 1))).astype(np.int32),
        i_val=np.ones((T, B, 1), np.float32),
    )
    # the last examples are padding, as pack_csr writes it
    for p in ("u_idx", "i_idx"):
        stacked[p][-1, -5:] = N - 1
    for p in ("u_val", "i_val"):
        stacked[p][-1, -5:] = 0.0
    stacked["weight"][-1, -5:] = 0.0
    if NG > 1:
        grng = np.random.RandomState(7)
        st["g"] = grng.normal(0, 0.01, (NG,)).astype(np.float32)
        st["g"][-1] = 0.0
        cs["wd_g_row"] = np.full((NG,), 0.001, np.float32)
        cs["wd_g_row"][-1] = 0.0
        g_idx = grng.randint(0, NG - 1, (T, B, SG)).astype(np.int32)
        g_val = grng.uniform(0.1, 1.0, (T, B, SG)).astype(np.float32)
        pad = grng.rand(T, B, SG) < 0.3
        g_idx[pad] = NG - 1
        g_val[pad] = 0.0
        stacked.update(g_idx=g_idx, g_val=g_val)
    lrs = np.full((R,), 0.01, np.float32)
    return st, cs, stacked, lrs


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here and not at the top: a GPU host
    without JAX still collects this file and runs the card case."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from svdfeature_tpu.ops import embed, pallas_embed

    return SimpleNamespace(jnp=jnp, pltpu=pltpu, embed=embed, pallas_embed=pallas_embed)


def jax_inputs(jx, st, cs, stacked, lrs):
    """(state, stacked, lrs, consts) for the JAX package's train_rounds*."""
    jnp = jx.jnp
    return (
        jx.embed.TrainState(**{k: jnp.asarray(v) for k, v in st.items()}),
        {k: jnp.asarray(v) for k, v in stacked.items()},
        jnp.asarray(lrs),
        jx.embed.TrainConsts(**{k: jnp.asarray(v) for k, v in cs.items()}),
    )


def torch_inputs(st, cs, stacked, lrs, device=CPU):
    """The same arrays as the port's (state, stacked, lrs, consts)."""
    return (
        convert.state_from_numpy(**st, device=device),
        convert.stacked_from_numpy(stacked, device),
        torch.tensor(lrs, device=device),
        convert.consts_from_numpy(**cs, device=device),
    )


CASES = [
    pytest.param(at, nub, NG, SG, ex, id=f"at{at}-nub{nub}-{tag}")
    for at in (0, 2)
    for nub in (0, 1)
    for NG, SG, ex, tag in ((1, 1, False, "noglobal"), (7, 3, False, "global"),
                            (7, 3, True, "global-exact"))
]


@pytest.mark.parametrize("active_type,no_user_bias,NG,SG,exact_global", CASES)
def test_reference_matches_jax(jx, active_type, no_user_bias, NG, SG, exact_global):
    """f32 jnp train_rounds (atol 1e-5: the two differ only in summation
    order and exp(c*log(1-x)) vs pow(1-x, c); measured up to 6e-8), and
    the precise Pallas kernel in interpret mode, to the tolerances
    tests/test_pallas.py holds that kernel to against the jnp path
    (w 2e-5 / b 2e-4 / g 2e-5, and w 5e-5 / b 5e-4 with a global segment;
    rtol 1e-3): its payload is rounded to bf16, and that rounding is all
    of the port-vs-Pallas difference (up to 2.5e-4 on b)."""
    st, cs, stacked, lrs = make_inputs(active_type, NG, SG)
    base = 3.0 if active_type == 0 else 0.0
    jhp = jx.embed.HyperParams(active_type=active_type, no_user_bias=no_user_bias,
                             base_score=base, exact_global=exact_global)
    thp = HyperParams(active_type=active_type, no_user_bias=no_user_bias,
                      base_score=base, exact_global=exact_global)

    out = embed.train_rounds(*torch_inputs(st, cs, stacked, lrs), thp)

    ref = jx.embed.train_rounds(*jax_inputs(jx, st, cs, stacked, lrs), jhp)
    state, jstacked, jlrs, consts = jax_inputs(jx, st, cs, stacked, lrs)
    assert jx.pallas_embed.pallas_supported(jhp, state, jstacked)
    with jx.pltpu.force_tpu_interpret_mode():
        pal = jx.pallas_embed.train_rounds_pallas(
            state, jstacked, jlrs, consts, jhp, precise=True
        )

    got = {n: getattr(out, n).numpy() for n in ("w", "b", "g")}
    for name in ("w", "b", "g"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)),
                                   atol=1e-5, rtol=0, err_msg=f"{name} vs jnp")
    pallas_atol = (("w", 5e-5), ("b", 5e-4), ("g", 2e-5)) if NG > 1 else (
        ("w", 2e-5), ("b", 2e-4), ("g", 2e-5))
    for name, atol in pallas_atol:
        np.testing.assert_allclose(got[name], np.asarray(getattr(pal, name)),
                                   atol=atol, rtol=1e-3, err_msg=f"{name} vs pallas")
    assert int(out.step) == int(ref.step) == int(pal.step)
    assert got["w"][-1].tolist() == [0.0] * got["w"].shape[1] and got["b"][-1] == 0
    assert not np.allclose(got["w"], st["w"])  # it trained
    if NG > 1:
        assert got["g"][-1] == 0 and np.abs(got["g"]).max() > 0


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
    "hinge_l2": dict(hp=dict(active_type=6)),
    "multi_user": dict(Su=2),
    "multi_item": dict(Si=2),
    "global8": dict(NG=7, SG=8),
    "global9": dict(NG=7, SG=9),
    "gtable1024": dict(NG=1024, SG=3),
    "gtable1025": dict(NG=1025, SG=3),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_kernel_gate_agrees_with_pallas(jx, case):
    """kernel_supported and pallas_supported agree on the semantic
    conditions (shapes chosen inside the TPU's layout limits)."""
    spec = GATE_CASES[case]
    st, cs, stacked, lrs = make_inputs(NG=spec.get("NG", 1), SG=spec.get("SG", 1),
                                       T=1, B=8)
    for p, key in (("u", "Su"), ("i", "Si")):
        s = spec.get(key, 1)
        stacked[f"{p}_idx"] = np.repeat(stacked[f"{p}_idx"], s, axis=-1)
        stacked[f"{p}_val"] = np.repeat(stacked[f"{p}_val"], s, axis=-1)
    hp_kw = spec.get("hp", {})
    state, jstacked, _, _ = jax_inputs(jx, st, cs, stacked, lrs)
    tstate, tstacked, _, _ = torch_inputs(st, cs, stacked, lrs)
    want = jx.pallas_embed.pallas_supported(jx.embed.HyperParams(**hp_kw), state, jstacked)
    assert cuda_embed.kernel_supported(HyperParams(**hp_kw), tstate, tstacked) == want
    assert want == (case in ("base", "sigmoid_l2", "sigmoid_rank", "qsgrad",
                             "global8", "gtable1024"))


def test_kernel_gate_caps_table_rows():
    """Above 8192 rows the JAX package takes its big-table route; the
    kernel path refuses and names the route that runs such tables."""
    st, cs, stacked, lrs = make_inputs(N=8193, k=2, T=1, B=8)
    tstate, tstacked, _, _ = torch_inputs(st, cs, stacked, lrs)
    reason = cuda_embed.gate_failure(HyperParams(), tstate, tstacked)
    assert reason is not None and "big-table route" in reason and "train_step_big" in reason
    assert "item" not in reason


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version and launches nothing."""
    st, cs, stacked, lrs = make_inputs()
    before = cuda_embed.train_rounds_kernel.launches
    hp = HyperParams(base_score=3.0)
    a = cuda_embed.train_rounds_kernel(*torch_inputs(st, cs, stacked, lrs), hp)
    b = embed.train_rounds(*torch_inputs(st, cs, stacked, lrs), hp)
    assert cuda_embed.train_rounds_kernel.launches == before
    for name in ("w", "b", "g", "step"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    # what a call on the card launches: one cooperative launch, whatever R
    assert cuda_embed.launches_per_call(2) == cuda_embed.launches_per_call(40) == 1


def test_checked_plan_is_kept_for_the_same_tensors():
    """The wrapper's checked plan (flat planes, live-example count, the
    kernel's pointer array) is made once per set of tensors and found
    again while they come unmodified; an in-place edit of a plane, other
    tensors or another table height make a new one, and the new one is
    checked (a row or a global slot outside its table raises)."""
    st, cs, stacked, lrs = make_inputs(0, 7, 3)
    args = torch_inputs(st, cs, stacked, lrs)
    state, tstacked = args[0], args[1]
    cuda_embed._PLANS.clear()
    plan = cuda_embed._plan(*args)
    assert cuda_embed._plan(*args) is plan and len(cuda_embed._PLANS) == 1
    assert int(plan.n_live) == int((stacked["weight"] > 0).sum())
    (planes,) = plan.keep
    assert len(plan.ptrs) == len(cuda_embed._ROUNDS_POINTERS) == 20
    for name in ("u_idx", "i_val", "label", "g_idx", "g_val"):
        assert plan.ptrs[cuda_embed._SLOT[name]] == planes[name].data_ptr()
    assert planes["g_idx"].numel() == stacked["g_idx"].size  # SG = 3 global entries
    # other tensors of equal content: checked anew
    assert cuda_embed._plan(*torch_inputs(st, cs, stacked, lrs)) is not plan
    # another table height (the row bounds depend on it)
    taller = convert.state_from_numpy(**dict(
        st, w=np.vstack([st["w"], st["w"][:1]]), b=np.append(st["b"], 0.0).astype(np.float32),
        ref_ui=np.append(st["ref_ui"], 0).astype(np.int32)), device=CPU)
    taller_consts = convert.consts_from_numpy(**dict(
        cs, wd_u_row=np.append(cs["wd_u_row"], 0.0).astype(np.float32),
        wd_i_row=np.append(cs["wd_i_row"], 0.0).astype(np.float32)), device=CPU)
    assert cuda_embed._plan(taller, args[1], args[2], taller_consts) is not plan
    assert cuda_embed._plan(*args) is plan
    # an in-place edit bumps the version: the plan is remade, and checked
    tstacked["label"].mul_(1.0)
    remade = cuda_embed._plan(*args)
    assert remade is not plan
    tstacked["g_idx"][0, 0, 0] = 7
    with pytest.raises(ValueError, match="global index outside"):
        cuda_embed._plan(*args)
    tstacked["g_idx"][0, 0, 0] = 0
    tstacked["u_idx"][0, 0, 0] = 10_000
    with pytest.raises(ValueError, match="outside the 256-row table"):
        cuda_embed._plan(*args)
    assert len(cuda_embed._PLANS) <= _plans.MAX_PLANS
    cuda_embed._PLANS.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("NG,SG,exact_global", [(1, 1, False), (7, 3, False), (7, 3, True)])
def test_kernel_matches_plain_on_card(NG, SG, exact_global):
    """The CUDA kernel against its plain version on the card (atomics sum
    in a varying order: atol 1e-5 / rtol 1e-4), one cooperative launch a
    call, and a second call on the same tensors, which takes the kept
    plan, agreeing too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m cuda tests/)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    st, cs, stacked, lrs = make_inputs(0, NG, SG, N=2626, k=64, B=4096, T=3)
    hp = HyperParams(base_score=3.0, exact_global=exact_global)
    before = cuda_embed.train_rounds_kernel.launches
    state, tstacked, tlrs, consts = torch_inputs(st, cs, stacked, lrs, dev)
    got = cuda_embed.train_rounds_kernel(state, tstacked, tlrs, consts, hp)
    torch.cuda.synchronize()
    assert cuda_embed.train_rounds_kernel.launches - before == cuda_embed.launches_per_call(2) == 1
    plan = cuda_embed._PLANS[0]
    want = embed.train_rounds(*torch_inputs(st, cs, stacked, lrs, dev), hp)
    for name in ("w", "b", "g"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   atol=1e-5, rtol=1e-4)
    assert int(got.step) == int(want.step)
    if exact_global:
        # the undamped global update is stable only while lr * sum(v^2) per
        # slot stays below 2, which these dense global features break a few
        # steps later, on both sides alike
        return
    # a second call on the same tensors: the kept plan, no new checks
    got = cuda_embed.train_rounds_kernel(got, tstacked, tlrs, consts, hp)
    torch.cuda.synchronize()
    assert cuda_embed._PLANS[0] is plan
    assert cuda_embed.train_rounds_kernel.launches - before == 2
    want = embed.train_rounds(want, *torch_inputs(st, cs, stacked, lrs, dev)[1:], hp)
    for name in ("w", "b", "g"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   atol=1e-5, rtol=1e-4)
    assert int(got.step) == int(want.step)
