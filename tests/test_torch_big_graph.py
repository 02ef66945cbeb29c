"""One CUDA graph a round for the big-table step (solvers/round_graph.py).

On the card the base solver runs a staged pack's first big-table round
eagerly, captures the second round's steps into one CUDA graph and replays
it from then on.  The ``cuda`` cases hold three rounds through the graph
(eager, capture, replay) under a decaying learning rate to the same three
rounds run eagerly, within the big-table tolerance of
tests/test_torch_big_kernels.py (atol 1e-6 + rtol 1e-5; the step counter
and the ref bits exact), on the sorted-dedup route with K5, with its plain
writer (``use_pallas=0``) and on the tile sweep with K4; a checkpoint
loaded between rounds is captured anew, and a streamed run of the same data
captures nothing.  On the CPU the branch captures nothing and equals the
loop of steps it runs, and ``_global_step`` zeroes the padding slot on the
device bit for bit as the host copy did.  This file imports no jax, so the
card collects it.
"""

import io

import numpy as np
import pytest
import torch

from svdfeature_tpu_torch import tracing
from svdfeature_tpu_torch.data.buffer import write_csr_buffer
from svdfeature_tpu_torch.data.csr import CSRDataset
from svdfeature_tpu_torch.data.streaming import StreamingCSRBuffer
from svdfeature_tpu_torch.ops import big_embed, cuda_scatter, cuda_sweep, tile_sweep
from svdfeature_tpu_torch.ops.embed import (HyperParams, TrainConsts, _soft_threshold,
                                            _touch_counts, _update_global)
from svdfeature_tpu_torch.params import SVDTypeParam, svd_type
from svdfeature_tpu_torch.solvers.registry import create_svd_trainer

# a 10,001-row table on the CPU; the card's runs take the batch of the
# benchmark's MF cell, 4096, on a 300,001-row table
MF = dict(num_user=6000, num_item=4000, num_factor=8, num_global=0, base_score=3,
          learning_rate=0.005, wd_user=0.004, wd_item=0.004, batch_size=1024,
          decay_learning_rate=1, decay_rate=0.9)
CARD = dict(MF, num_user=200_000, num_item=100_000, num_factor=64, batch_size=4096)
ROUNDS = 3


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def trainer(conf: dict, device="cpu", **keys):
    mtype = SVDTypeParam()
    keys = {**{k: str(v) for k, v in {**conf, **keys}.items()}, "device": device}
    for name, val in keys.items():
        mtype.set_param(name, val)
    mtype.decide_format(svd_type.AUTO_DETECT)
    tr = create_svd_trainer(mtype)
    for name, val in keys.items():
        tr.set_param(name, val)
    tr.init_model()
    tr.init_trainer()
    return tr


def mf_rows(conf: dict, n: int, seed=3) -> CSRDataset:
    """``n`` ratings of one user and one item each: users uniform, items
    Zipf-0.8 as in the benchmark's MF cell (the top item about 2-5% of a
    batch, so that the batched step trains and does not diverge)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, conf["num_user"], n)
    law = 1.0 / np.arange(1, conf["num_item"] + 1) ** 0.8
    items = rng.choice(conf["num_item"], n, p=law / law.sum())
    row_ptr = np.zeros(3 * n + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.tile(np.array([0, 1, 1], np.int32), n))
    index = np.empty(2 * n, np.uint32)
    index[0::2], index[1::2] = users, items
    return CSRDataset(labels=rng.uniform(1, 5, n).astype(np.float32), row_ptr=row_ptr,
                      index=index, value=np.ones(2 * n, np.float32))


def rounds(tr, ds, first: int = 0, n: int = ROUNDS) -> None:
    """The train task's rounds ``first`` .. ``first + n - 1``."""
    for r in range(first, first + n):
        tr.set_round(r)
        tr.update_all(ds)
        tr.finish_round()
        tr.synchronize()


def eager(tr):
    """``tr`` with every big-table round run eagerly."""
    tr._round_graph = lambda stacked: None
    return tr


def assert_states_close(got, want) -> None:
    got, want = got.state_or_model(), want.state_or_model()
    assert torch.isfinite(got.w).all() and torch.isfinite(want.w).all()
    for name in ("w", "b", "g"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), atol=1e-6, rtol=1e-5)
    assert torch.equal(got.ref_ui, want.ref_ui) and int(got.step) == int(want.step)


# ---- CPU --------------------------------------------------------------------------
@pytest.mark.parametrize("big_sweep", [0, 1])
@pytest.mark.parametrize("entry", ["update_all", "update_rounds"])
def test_cpu_big_rounds_capture_nothing_and_equal_the_step_loop(big_sweep, entry):
    """On CPU tensors the big-table branch makes no graph: its rounds equal
    the plain loop of steps at the decayed learning rates bit for bit."""
    ds = mf_rows(MF, 4096)
    tr = trainer(MF, big_sweep=big_sweep)
    assert tr.hp.big_table and tr.hp.sweep_table == bool(big_sweep)
    tracing.enable()
    if entry == "update_all":
        rounds(tr, ds)
    else:
        tr.update_rounds(ds, ROUNDS)
    tracing.disable()
    _, counters = tracing.drain()
    assert not any(name.startswith("graph.") for name in counters)
    assert tr._graphs == {} and counters["steps"] == ROUNDS * 4

    ref = trainer(MF, big_sweep=big_sweep)
    stacked, _ = ref._pack(ds)
    step = tile_sweep.train_step_sweep if big_sweep else big_embed.train_step_big
    state = ref.state
    for r in range(ROUNDS):
        ref.set_round(r)
        lr = torch.tensor([ref.learning_rate], dtype=torch.float32)[0]
        for t in range(stacked["label"].shape[0]):
            state = step(state, {name: x[t] for name, x in stacked.items()}, lr, ref.consts,
                         ref.hp)
    assert torch.isfinite(state.w).all()
    for name in ("w", "g", "step"):
        assert torch.equal(getattr(tr.state, name), getattr(state, name)), name


def _old_global_step(g, g_idx, g_val, err, cg, lr, consts, hp):
    """``_global_step`` as it was: the padding slot set from a host scalar."""
    g = _update_global(g, g_idx, g_val, err, lr, hp.exact_global)
    if hp.reg_global == 0:
        g = g * torch.pow(1.0 - lr * consts.wd_g_row, cg)
    elif hp.reg_global == 1:
        g = _soft_threshold(g, lr * consts.wd_g_row * cg)
    g[-1] = 0.0
    return g


@pytest.mark.parametrize("reg_global", [0, 1, 4])
def test_global_step_zeroes_the_padding_slot_bit_for_bit(reg_global):
    rng = np.random.default_rng(reg_global)
    G, B, S = 7, 64, 3
    g = torch.from_numpy(rng.normal(0, 0.3, G + 1).astype(np.float32))
    g[-1] = 0.7  # a padding slot the update does not touch keeps this unless zeroed
    g_idx = torch.from_numpy(rng.integers(0, G + 1, (B, S)).astype(np.int32))
    g_val = torch.from_numpy(rng.normal(0, 1, (B, S)).astype(np.float32))
    g_val[g_idx == G] = 0.0
    err = torch.from_numpy(rng.normal(0, 1, B).astype(np.float32))
    wd = torch.from_numpy(rng.uniform(0, 0.5, G + 1).astype(np.float32))
    wd[-1] = 0.0
    consts = TrainConsts(wd_u_row=wd, wd_i_row=wd, wd_g_row=wd,
                         wd_user_bias=torch.tensor(0.0), wd_item_bias=torch.tensor(0.0))
    hp = HyperParams(reg_global=reg_global)
    lr = torch.tensor(0.05)
    cg = _touch_counts(G + 1, g_idx)
    got = big_embed._global_step(g.clone(), g_idx, g_val, err, cg, lr, consts, hp)
    want = _old_global_step(g.clone(), g_idx, g_val, err, cg, lr, consts, hp)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert got[-1].view(torch.int32) == 0 and not torch.equal(got[:-1], g[:-1])


# ---- the card ----------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest --noconftest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


ROUTES = {  # keys of each route; the wrapper whose launches it counts
    "dedup": (dict(big_sweep=0), cuda_scatter.row_writer),
    "dedup-plain": (dict(big_sweep=0, use_pallas=0), None),
    "sweep": (dict(big_sweep=1), cuda_sweep.sweep_update),
    "dedup-update_rounds": (dict(big_sweep=0), cuda_scatter.row_writer),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_graph_rounds_match_eager_rounds_on_card(route):
    """Three rounds of 8 batch-4096 steps through the graph (eager,
    capture, replay) equal three eager rounds; a decaying learning rate
    reaches the replays; one capture, two replays, every step and launch
    counted once."""
    _card()
    keys, wrapper = ROUTES[route]
    ds = mf_rows(CARD, 8 * 4096)
    tr = trainer(CARD, "cuda", **keys)
    assert tr.hp.big_table and tr.hp.sweep_table == (keys["big_sweep"] == 1)
    before = wrapper.launches if wrapper else 0
    tracing.enable()
    if route.endswith("update_rounds"):
        tr.update_rounds(ds, ROUNDS)
        tr.synchronize()
    else:
        rounds(tr, ds)
    tracing.disable()
    _, counters = tracing.drain()
    assert counters["graph.captures"] == 1 and counters["graph.replays"] == ROUNDS - 1
    assert counters["steps"] == 8 * ROUNDS
    if wrapper:
        assert wrapper.launches - before == 8 * ROUNDS
    ref = eager(trainer(CARD, "cuda", **keys))
    if route.endswith("update_rounds"):
        ref.update_rounds(ds, ROUNDS)
        ref.synchronize()
    else:
        rounds(ref, ds)
    assert ref._graphs == {} and tr.learning_rate == ref.learning_rate < CARD["learning_rate"]
    assert_states_close(tr, ref)


@pytest.mark.cuda
def test_a_loaded_checkpoint_is_captured_anew_on_card():
    """A checkpoint loaded after the capture round gives the trainer a new
    table: its next round runs eagerly and the one after captures again, so
    no replay reads the table that went."""
    _card()
    ds = mf_rows(CARD, 8 * 4096)
    out = []
    for tr in (trainer(CARD, "cuda"), eager(trainer(CARD, "cuda"))):
        tracing.enable()
        rounds(tr, ds, 0, 2)
        f = io.BytesIO()
        tr.save_model(f)
        f.seek(0)
        old = tr.state.w
        tr.load_model(f)
        tr.init_trainer()
        assert tr.state.w is not old
        del old
        rounds(tr, ds, 2, 3)
        tracing.disable()
        out.append((tr, tracing.drain()[1]))
    (tr, counters), (ref, ref_counters) = out
    assert counters["graph.captures"] == 2 and counters["graph.replays"] == 3
    assert "graph.captures" not in ref_counters
    assert counters["steps"] == ref_counters["steps"] == 8 * 5
    assert_states_close(tr, ref)


@pytest.mark.cuda
def test_a_streamed_run_captures_nothing_on_card(tmp_path):
    """Streamed chunks are new planes each time: their rounds run eagerly
    and train as the staged rounds through the graph do."""
    _card()
    ds = mf_rows(CARD, 8 * 4096)
    path = tmp_path / "train.buffer"
    write_csr_buffer(str(path), ds, batch_size=4096)
    tr = trainer(CARD, "cuda")
    tracing.enable()
    rounds(tr, StreamingCSRBuffer(str(path), examples_per_chunk=2 * 4096))
    tracing.disable()
    _, counters = tracing.drain()
    assert "graph.captures" not in counters and tr._graphs == {}
    assert counters["steps"] == 8 * ROUNDS
    staged = trainer(CARD, "cuda")
    rounds(staged, ds)
    assert len(staged._graphs) == 1
    assert_states_close(tr, staged)
