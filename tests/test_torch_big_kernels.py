"""The big-table route's kernels K4 (ops/cuda_sweep.py), K5 and K6
(ops/cuda_scatter.py): their plain versions against the JAX package on
the CPU, and the CUDA kernels against their plain versions on the card.

K5's counterpart in the JAX package on the CPU is
``write_rows_unique(..., row_dma=False)`` (``.at[].set``) and K6's the row
gather (``pallas_scatter`` uses TPU-only DMA primitives and has no
interpret mode); both must agree bit for bit, repeated zero writes to the
dummy row included.  K4's plain version is held to the JAX package's
interpret-mode sweep in tests/test_torch_big_sweep.py.

The ``cuda`` cases run on the card only: K5 / K6 bit for bit against
``w[idx] = vals`` / ``index_select``, K4 within atol 1e-6 + rtol 1e-5 of
its plain version (the kernel sums a row's entries in f32 in plan order,
the plain version in f64 with ``index_add_``) with the ref bits and the
pad rows exact, and the two big-table steps with the
kernels against the same steps with the plain versions, with exact
launch counts.  This file imports jax lazily, so the card, which has no
jax, still collects it.
"""

import dataclasses
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svdfeature_tpu_torch import convert
from svdfeature_tpu_torch.ops import big_embed, cuda_scatter, cuda_sweep, tile_sweep
from svdfeature_tpu_torch.ops.embed import HyperParams

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here and not at the top: a GPU host
    without JAX still collects this file and runs the card cases."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from svdfeature_tpu.ops import big_embed as jbig
    from svdfeature_tpu.ops import embed
    from svdfeature_tpu.ops import tile_sweep as jsw

    return SimpleNamespace(jnp=jnp, jbig=jbig, jsw=jsw, embed=embed)


def row_inputs(n=257, W=8, E=120, dummy_share=0.2, seed=0):
    """A table, E targets (unique apart from ~dummy_share on the dummy
    row n-1, which receives zero rows) and their values."""
    rng = np.random.RandomState(seed)
    w = rng.normal(0, 1, (n, W)).astype(np.float32)
    w[-1] = 0.0
    idx = rng.permutation(n - 1)[:E].astype(np.int32)
    idx[rng.rand(E) < dummy_share] = n - 1
    vals = rng.normal(0, 1, (E, W)).astype(np.float32)
    vals[idx == n - 1] = 0.0
    return w, idx, vals


def test_row_writer_plain_matches_jax(jx):
    w, idx, vals = row_inputs()
    assert (idx == w.shape[0] - 1).sum() > 5
    want = jx.jbig.write_rows_unique(jx.jnp.asarray(w), jx.jnp.asarray(idx),
                                     jx.jnp.asarray(vals), row_dma=False)
    before = cuda_scatter.row_writer.launches
    got = cuda_scatter.row_writer(torch.from_numpy(w.copy()), torch.from_numpy(idx),
                                  torch.from_numpy(vals))
    assert cuda_scatter.row_writer.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[-1] == 0).all()


def test_row_reader_plain_matches_jax(jx):
    w, idx, _ = row_inputs(seed=1)
    want = jx.jbig.gather_rows(jx.jnp.asarray(w), jx.jnp.asarray(idx))
    before = cuda_scatter.row_reader.launches
    got = cuda_scatter.row_reader(torch.from_numpy(w), torch.from_numpy(idx))
    assert cuda_scatter.row_reader.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(big_embed.gather_rows(torch.from_numpy(w),
                                                        torch.from_numpy(idx)).numpy(),
                                  np.asarray(want))


WRITE_FAULTS = {
    # name: (edit of (w, idx, vals) -> the faulty triple, a word of the message)
    "idx-dtype": (lambda w, i, v: (w, i.long(), v), "idx has dtype"),
    "vals-dtype": (lambda w, i, v: (w, i, v.double()), "vals has dtype"),
    "w-dtype": (lambda w, i, v: (w.double(), i, v), "w has dtype"),
    "vals-shape": (lambda w, i, v: (w, i, v[:, :-1].contiguous()), "vals has shape"),
    "vals-rows": (lambda w, i, v: (w, i, v[:-1]), "vals has shape"),
    "vals-stride": (lambda w, i, v: (w, i, v.t().contiguous().t()), "vals is not contiguous"),
    "idx-stride": (lambda w, i, v: (w, i.repeat_interleave(2)[::2], v), "idx is not contiguous"),
    "w-stride": (lambda w, i, v: (w.t().contiguous().t(), i, v), "w is not contiguous"),
    "vals-device": (lambda w, i, v: (w, i, v.to("meta")), "vals is on meta"),
    "idx-device": (lambda w, i, v: (w, i.to("meta"), v), "idx is on meta"),
    "w-1d": (lambda w, i, v: (w[0], i, v), "2-D table"),
    "idx-2d": (lambda w, i, v: (w, i[:, None], v), "1-D indices"),
}


@pytest.mark.parametrize("fault", sorted(WRITE_FAULTS))
def test_row_writer_checks_raise_as_before(fault):
    """K5's per-call checks are direct comparisons now; each wrong dtype,
    shape, device or stride still raises, with the very message of the
    table-driven check they replace."""
    edit, word = WRITE_FAULTS[fault]
    w, idx, vals = (torch.from_numpy(a) for a in row_inputs())
    assert cuda_scatter._check_write(w, idx, vals) == (idx.shape[0], w.shape[1], w.shape[0])
    bad = edit(w, idx, vals)
    with pytest.raises(ValueError) as old:
        cuda_scatter._check(*bad, "vals")
    with pytest.raises(ValueError, match=word) as new:
        cuda_scatter._check_write(*bad)
    assert str(new.value) == str(old.value)


def test_sweep_wrapper_is_plain_version_on_cpu():
    """On CPU tensors K4's wrapper is its plain version and launches nothing."""
    x = sweep_inputs(n=200, k=4, B=64, tile=16, e_cap=8, seed=3)
    hp = x["hp"](reg_method=4)
    a, b = x["w"].clone(), x["w"].clone()
    before = cuda_sweep.sweep_update.launches
    cuda_sweep.sweep_update(a, *x["args"], hp)
    cuda_sweep.sweep_update_reference(b, *x["args"], hp)
    assert cuda_sweep.sweep_update.launches == before
    assert torch.equal(a, b) and not torch.equal(a, x["w"])


@pytest.mark.parametrize("case", ["r0", "r4-nub", "r5-seg2", "r1-k257", "r0-k300", "r2-k300",
                                  "r4-k512", "r3-k513", "r5-k1024", "r2-k1024"])
def test_sweep_plain_forms_the_payload_entries(jx, case):
    """K4's plain version given the step's pieces (p_u, p_i, coef_u,
    coef_i) computes what the payload form computed: the payload
    ``[dw | db | cnt_u | cnt_i]`` built as the forward half built it before
    (one row per entry, users then items) through the same sweep math bit
    for bit, and through the JAX package's TPU kernel (``sweep_update``,
    interpret mode, the payload gathered in plan order) within atol 1e-6,
    ref bits exact.  Rows of 257 to 1024 factors (the wide kernel's: one
    sweep up to 512, passes of 512 columns above) are cases too, and the
    kernel's checks take their arguments."""
    k = int(case.split("-k")[1]) if "-k" in case else 8
    x = sweep_inputs(n=200, k=k, B=64, tile=16, e_cap=8, seed=8, Su=2 if "seg2" in case else 1)
    hp = x["hp"](reg_method=int(case[1]), no_user_bias=int("nub" in case))
    plan, p_u, p_i, coef_u, coef_i, wdu, wdi, scal, stepi = x["args"]
    cuda_sweep._check(x["w"], *x["args"], hp)
    B, Su = coef_u.shape
    pay_w = torch.cat([(coef_u[..., None] * p_i[:, None, :]).reshape(-1, k),
                       (coef_i[..., None] * p_u[:, None, :]).reshape(-1, k)])
    db_u = torch.zeros(B * Su) if hp.no_user_bias else coef_u.reshape(-1)
    cnt_u = torch.cat([torch.ones(B * Su), torch.zeros(coef_i.numel())])
    payload = torch.cat([pay_w, torch.cat([db_u, coef_i.reshape(-1)])[:, None], cnt_u[:, None],
                         1.0 - cnt_u[:, None]], dim=1)
    got = cuda_sweep.sweep_update_reference(x["w"].clone(), *x["args"], hp)
    old = cuda_sweep._sweep_payload(x["w"].clone(), plan, payload, wdu, wdi, scal, stepi, hp)
    assert torch.equal(got, old)
    jnp = jx.jnp
    pay_plan = np.concatenate([payload.numpy(), np.zeros((1, k + 3), np.float32)])[
        plan["sw_src"].numpy()]
    W = x["w"].shape[1]
    pay_plan = np.pad(pay_plan, ((0, 0), (0, W - k - 3)))
    jhp = jx.embed.HyperParams(**dataclasses.asdict(hp))
    want = np.asarray(jx.jsw.sweep_update(
        jnp.asarray(x["w"].numpy()), jnp.asarray(plan["sw_tids"].numpy()),
        jnp.asarray(plan["sw_lids"].numpy()), jnp.asarray(pay_plan), jnp.asarray(wdu.numpy()),
        jnp.asarray(wdi.numpy()), jnp.asarray(scal.numpy()), jnp.asarray(stepi.numpy()), jhp))
    np.testing.assert_allclose(got[:, : k + 1].numpy(), want[:, : k + 1], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(big_embed.ref_column(got, k).numpy(),
                                  want.view(np.int32)[:, k + 1])
    assert not torch.equal(got, x["w"])


@pytest.mark.parametrize("k", [254, 257, 300, 512, 513, 1024])
def test_sweep_check_takes_every_factor_count(k):
    """K4's checks take every k the augmented layout holds: no limit on
    the factors (a row of more than 256 goes to the wide kernel), and they
    still refuse a layout whose width does not hold k + 2 columns, or a
    table that does not start on a 16-byte boundary."""
    x = sweep_inputs(n=200, k=k, B=64, tile=16, e_cap=8, seed=3)
    hp = x["hp"](reg_method=0)
    assert x["w"].shape[1] == big_embed.aug_width(k)
    cuda_sweep._check(x["w"], *x["args"], hp)
    narrow = x["w"][:, :-4].contiguous()  # fewer than k + 2 columns
    with pytest.raises(ValueError, match="augmented layout"):
        cuda_sweep._check(narrow, *x["args"], hp)
    flat = torch.zeros(x["w"].numel() + 1)
    shifted = flat[1:].view(x["w"].shape)  # 4 bytes past an aligned start
    shifted.copy_(x["w"])
    with pytest.raises(ValueError, match="16-byte boundary"):
        cuda_sweep._check(shifted, *x["args"], hp)


SWEEP_FAULTS = {
    # name: (edit of K4's arguments, a word of the message)
    "w-dtype": (lambda a: a.update(w=a["w"].double()), "w has dtype"),
    "w-stride": (lambda a: a.update(w=a["w"].t().contiguous().t()), "w is not contiguous"),
    "src-dtype": (lambda a: a["plan"].update(sw_src=a["plan"]["sw_src"].long()),
                  "sw_src has dtype"),
    "runs-shape": (lambda a: a["plan"].update(sw_runs=a["plan"]["sw_runs"][:, :3].contiguous()),
                   "sw_runs has shape"),
    "pieces-device": (lambda a: a["plan"].update(sw_pieces=a["plan"]["sw_pieces"].to("meta")),
                      "sw_pieces is on meta"),
    "p_u-shape": (lambda a: a.update(p_u=a["p_u"][:, :-1].contiguous()), "p_u has shape"),
    "p_i-stride": (lambda a: a.update(p_i=a["p_i"].t().contiguous().t()), "p_i is not contiguous"),
    "coef_u-1d": (lambda a: a.update(coef_u=a["coef_u"][:, 0]), "coef_u / coef_i must be"),
    "coef_i-rows": (lambda a: a.update(coef_i=a["coef_i"][:-1]), "coef_i has shape"),
    "wdu-dtype": (lambda a: a.update(wdu=a["wdu"].double()), "wdu has dtype"),
    "scal-shape": (lambda a: a.update(scal=a["scal"][:3]), "scal has shape"),
    "stepi-dtype": (lambda a: a.update(stepi=a["stepi"].long()), "stepi has dtype"),
}


@pytest.mark.parametrize("fault", sorted(SWEEP_FAULTS))
def test_sweep_check_names_each_fault(fault):
    """K4's per-call check raises on each wrong dtype, shape, device,
    stride or rank of the tensors the kernel dereferences, naming the
    tensor."""
    x = sweep_inputs(n=200, k=300, B=64, tile=16, e_cap=8, seed=3)
    hp = x["hp"](reg_method=0)
    names = ("plan", "p_u", "p_i", "coef_u", "coef_i", "wdu", "wdi", "scal", "stepi")
    args = dict(zip(names, x["args"]), w=x["w"])
    args["plan"] = dict(args["plan"])
    cuda_sweep._check(args["w"], *(args[n] for n in names), hp)
    edit, word = SWEEP_FAULTS[fault]
    edit(args)
    with pytest.raises(ValueError, match=word):
        cuda_sweep._check(args["w"], *(args[n] for n in names), hp)


def sweep_inputs(n, k, B, tile, e_cap, seed, Su=1, Si=1, device=CPU, hot=0.0, skew=0.0,
                 piece=tile_sweep.SWEEP_PIECE):
    """K4's arguments for one batch on an n-row table (users [0, n/2),
    items above, dummy n-1), padded to whole tiles: a random augmented
    table with lazy refs, the step's factors p_u / p_i and coefficients
    coef_u / coef_i of realistic size (0 on the padding examples), the
    pack-time plan and runs (``piece``: the runs' cut).  ``hot``: the share
    of item entries on one popular item, whose run K4 cuts into pieces;
    ``skew``: items drawn from a Zipf law of that exponent instead (many
    runs cut into pieces)."""
    rng = np.random.RandomState(seed)
    half = (n - 1) // 2
    n_pad = -(-n // tile) * tile
    st = dict(w=rng.normal(0, 0.05, (n, k)), b=rng.normal(0, 0.05, n), g=np.zeros(1),
              step=0, ref_ui=rng.randint(0, 5000, n), ref_g=np.zeros(1))
    st["w"][-1] = st["b"][-1] = st["ref_ui"][-1] = 0
    aug = big_embed.augment_state(convert.state_from_numpy(**st, device=device), k,
                                  pad_rows_to=tile).w
    u = rng.randint(0, half, (B, Su))
    i = half + rng.randint(0, half, (B, Si))
    if skew:
        law = np.cumsum(np.arange(1, half + 1, dtype=np.float64) ** -skew)
        ranks = np.minimum(np.searchsorted(law, rng.rand(B, Si) * law[-1]), half - 1)
        i = half + rng.permutation(half)[ranks]
    i[rng.rand(B, Si) < hot] = half + 7
    u[-3:] = i[-3:] = n - 1  # padding examples
    p_u = rng.normal(0, 0.1, (B, k)).astype(np.float32)
    p_i = rng.normal(0, 0.1, (B, k)).astype(np.float32)
    coef_u = rng.normal(0, 1e-2, (B, Su)).astype(np.float32)
    coef_i = rng.normal(0, 1e-2, (B, Si)).astype(np.float32)
    coef_u[-3:] = coef_i[-3:] = 0.0
    plan = tile_sweep.attach_sweep_plans({"u_idx": u[None], "i_idx": i[None]}, n_pad, tile, e_cap)
    plan = tile_sweep.attach_sweep_runs(plan, tile, e_cap, piece=piece, num_factor=k)
    plan = {key: torch.from_numpy(plan[key][0]).to(device) for key in tile_sweep.SWEEP_KEYS}
    wd_u = np.zeros(n_pad, np.float32)
    wd_i = np.zeros(n_pad, np.float32)
    wd_u[:half] = 0.004
    wd_i[half:n - 1] = 0.004
    f32 = dict(dtype=torch.float32, device=device)
    args = (plan, *(torch.from_numpy(a).to(device) for a in (p_u, p_i, coef_u, coef_i)),
            torch.tensor(wd_u, **f32), torch.tensor(wd_i, **f32),
            torch.tensor([0.05, 0.002, 0.003, 0.0], **f32),
            torch.tensor([6000], dtype=torch.int32, device=device))

    def hp(**kw):
        return HyperParams(big_table=True, num_factor=k, sweep_table=True, sweep_tile=tile,
                           sweep_ecap=e_cap, **kw)

    return dict(w=aug, args=args, hp=hp, n=n)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest --noconftest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W", [68, 7])
def test_row_kernels_match_plain_on_card(W):
    """K5 and K6 bit for bit against their plain versions, 16-byte rows
    (W=68, k=64's augmented width) and rows of another width (W=7)."""
    dev = _card()
    w, idx, vals = row_inputs(n=300_001, W=W, E=100_000, seed=4)
    w, idx, vals = (torch.from_numpy(a).to(dev) for a in (w, idx, vals))
    before = (cuda_scatter.row_writer.launches, cuda_scatter.row_reader.launches)
    got = cuda_scatter.row_writer(w.clone(), idx, vals)
    read = cuda_scatter.row_reader(w, idx)
    torch.cuda.synchronize()
    assert (cuda_scatter.row_writer.launches, cuda_scatter.row_reader.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, cuda_scatter.row_writer_reference(w.clone(), idx, vals))
    assert torch.equal(read, cuda_scatter.row_reader_reference(w, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dummy_row", [0.0, 1.5])
def test_row_writer_one_batch_step_on_card(dummy_row):
    """K5 at the E=8192 rows of one batch-4096 dedup step (W=68): bit for
    bit, one launch; a quarter of the positions carry zeros to the dummy
    row, which the kernel compares before it stores, so the row is tried
    holding zeros already and holding something else."""
    dev = _card()
    w, idx, vals = row_inputs(n=300_001, W=68, E=8192, dummy_share=0.25, seed=7)
    w[-1] = dummy_row
    w, idx, vals = (torch.from_numpy(a).to(dev) for a in (w, idx, vals))
    before = cuda_scatter.row_writer.launches
    got = cuda_scatter.row_writer(w.clone(), idx, vals)
    torch.cuda.synchronize()
    assert cuda_scatter.row_writer.launches == before + 1
    assert torch.equal(got, cuda_scatter.row_writer_reference(w.clone(), idx, vals))
    assert (got[-1] == 0).all() and int((idx == 300_000).sum()) > 1000
    with pytest.raises(ValueError, match="idx has dtype"):
        cuda_scatter.row_writer(w, idx.long(), vals)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["r0", "r1", "r2", "r3", "r4", "r5", "nub-nonneg", "seg2",
                                  "hot-r4", "hot-k100-r2", "k300-r0", "k300-r2", "hot-k300-r5",
                                  "k512-r4", "hot-k512-r2", "k512-nub-nonneg", "skew-r4",
                                  "skew-k300-r2", "skew-k301-r0", "skew-k512-r5", "k257-r1",
                                  "skew-k257-r3", "k513-r4", "skew-k513-r0", "k1024-r5",
                                  "skew-k1024-r2", "hot-k1024-nub-nonneg", "hot-k1024-p200-r3"])
def test_sweep_kernel_matches_plain_on_card(case):
    """K4 against its plain version on a 40,960-row table (20 tiles of
    2048, k=64), every reg mode, no_user_bias with the nonnegative clamps,
    2-entry user segments, and a popular item holding a fifth of the item
    entries (its run cut into pieces; with k=100 too, whose rows take the
    kernel's scalar loads); rows of 257 to 1024 factors (the wide kernel:
    4-byte copies at 257 and 301, 16-byte ones at 300, 512, 513 and 1024;
    one sweep up to 512, passes of 512 columns above), with and without
    pieces, reg_method 2's whole-row scale among them; items from a Zipf
    law (exponent 1.1), whose many long runs are all cut into pieces, at
    k=64, 257, 300, 301, 512, 513 and 1024; and pieces of 200 entries (p200),
    more than the wide kernel stages at once, at k=1024."""
    dev = _card()
    found = re.search(r"k(\d+)", case)
    k = int(found.group(1)) if found else 64
    x = sweep_inputs(n=40_960, k=k, B=16_384, tile=2048, e_cap=1024, seed=5,
                     Su=2 if case == "seg2" else 1, device=dev,
                     hot=0.2 if case.startswith("hot") else 0.0,
                     skew=1.1 if case.startswith("skew") else 0.0,
                     piece=200 if "-p200" in case else tile_sweep.SWEEP_PIECE)
    if "-p200" in case:  # pieces longer than the wide kernel's staged plan
        runs = x["args"][0]["sw_runs"]
        assert int((runs[:, 1] - runs[:, 0]).max()) > tile_sweep.SWEEP_WIDE_PLAN
    if case.startswith("hot"):
        assert int(x["args"][0]["sw_runs"][:, 3].max()) > 10  # pieces of the popular run
    if case.startswith("skew"):  # pieces of several runs
        runs = x["args"][0]["sw_runs"]
        assert len(set(runs[runs[:, 3] >= 0, 2].tolist())) > 3
    if case.endswith("nub-nonneg"):
        hp = x["hp"](reg_method=0, no_user_bias=1, user_nonnegative=1, item_nonnegative=1)
    else:
        hp = x["hp"](reg_method=int(case[-1]) if case[-2] == "r" else 4)
    before = cuda_sweep.sweep_update.launches
    got = cuda_sweep.sweep_update(x["w"].clone(), *x["args"], hp)
    torch.cuda.synchronize()
    assert cuda_sweep.sweep_update.launches == before + 1
    want = cuda_sweep.sweep_update_reference(x["w"].clone(), *x["args"], hp)
    k = hp.num_factor
    torch.testing.assert_close(got[:, : k + 1], want[:, : k + 1], atol=1e-6, rtol=1e-5)
    assert torch.equal(big_embed.ref_column(got, k), big_embed.ref_column(want, k))
    # the dummy row's factors and bias stay 0 (in the lazy modes its ref is
    # stamped, as the TPU kernel stamps it), the pad rows stay 0 entirely
    n = x["n"]
    assert (got[n - 1, : k + 1] == 0).all() and (got[n:] == 0).all()
    assert not torch.equal(got, x["w"])


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", [False, True])
def test_big_steps_with_kernels_match_plain_on_card(sweep):
    """Two train steps through K5 (sorted dedup) or K4 (sweep) against the
    same steps through the plain versions (use_pallas=0), one launch per
    step; de-augmented states within atol 1e-6 + rtol 1e-5."""
    dev = _card()
    n, k, B, tile, e_cap = 50_001, 64, 8192, 2048, 1024
    rng = np.random.RandomState(6)
    st = dict(w=rng.normal(0, 0.01, (n, k)), b=np.zeros(n), g=np.zeros(1), step=0,
              ref_ui=np.zeros(n), ref_g=np.zeros(1))
    st["w"][-1] = 0
    half = (n - 1) // 2
    wd = np.zeros(n, np.float32)
    wd[:-1] = 0.004
    stacked = dict(
        label=rng.randint(1, 6, (2, B)).astype(np.float32), weight=np.ones((2, B), np.float32),
        g_idx=np.zeros((2, B, 1), np.int32), g_val=np.zeros((2, B, 1), np.float32),
        u_idx=rng.randint(0, half, (2, B, 1)).astype(np.int32), u_val=np.ones((2, B, 1)),
        i_idx=(half + rng.randint(0, half, (2, B, 1))).astype(np.int32), i_val=np.ones((2, B, 1)),
    )
    n_pad = -(-n // tile) * tile if sweep else n
    if sweep:
        stacked = tile_sweep.attach_sweep_runs(
            tile_sweep.attach_sweep_plans(stacked, n_pad, tile, e_cap), tile, e_cap)
        wd = np.pad(wd, (0, n_pad - n))
    stacked = convert.stacked_from_numpy(stacked, dev)
    consts = convert.consts_from_numpy(wd, wd, np.zeros(1), 0.001, 0.002, device=dev)
    step = tile_sweep.train_step_sweep if sweep else big_embed.train_step_big
    out = []
    for row_dma in (True, False):
        hp = HyperParams(big_table=True, num_factor=k, sweep_table=sweep, row_dma=row_dma,
                         base_score=3.0, reg_method=4)
        state = big_embed.augment_state(convert.state_from_numpy(**st, device=dev), k,
                                        pad_rows_to=tile if sweep else 0)
        counter = cuda_sweep.sweep_update if sweep else cuda_scatter.row_writer
        before = counter.launches
        for t in range(2):
            state = step(state, {p: x[t] for p, x in stacked.items()},
                         torch.tensor(0.005, device=dev), consts, hp)
        torch.cuda.synchronize()
        assert counter.launches - before == (2 if row_dma else 0)
        out.append(big_embed.deaugment_state(state, k, n_rows=n))
    got, want = out
    for name in ("w", "b"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), atol=1e-6, rtol=1e-5)
    assert torch.equal(got.ref_ui, want.ref_ui) and int(got.step) == int(want.step) == 2 * B
    assert not torch.equal(got.w, torch.from_numpy(st["w"]).float().to(dev))
