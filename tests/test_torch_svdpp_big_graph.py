"""One CUDA graph a round for the big-table SVD++ epoch (solvers/svdpp.py,
solvers/round_graph.py).

On the card the SVD++ solver runs a staged pack's first big-table round
eagerly, captures the whole of the second (every step, chunk entry and
chunk exit of ``ops/svdpp_big.train_epoch_plus_big``) into one CUDA graph
and replays it from then on.  The data is the benchmark's
``kdd11_svdpp.carry`` cell at a test's size (portbench/tests/tiny_carry.py:
a 14,001-row table, 512 users a round in chunks of 128 users x 4 rows), on
the user-carry body and on the entry-stream body (the same pack without
its carry plan).  The ``cuda`` cases hold three rounds through the graph
(eager, capture, replay) under a decaying learning rate to three eager
rounds, within the big-table tolerance (atol 1e-6 + rtol 1e-5; the step
counter and the ref bits exact), count one capture, two replays and every
step, chunk and K5 launch once; a checkpoint loaded between rounds is
captured anew; a streamed run and pair epochs capture nothing.  On the CPU
the route captures nothing and equals the plain loop of epochs bit for
bit.  This file imports no jax, so the card collects it.
"""

import io
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.gen import kdd_groups  # noqa: E402
from portbench.harness import leaves, program  # noqa: E402
from portbench.tests import tiny_carry  # noqa: E402
from svdfeature_tpu_torch import tracing  # noqa: E402
from svdfeature_tpu_torch.data.buffer import write_plus_buffer  # noqa: E402
from svdfeature_tpu_torch.data.rank import PairSource  # noqa: E402
from svdfeature_tpu_torch.data.registry import IteratorConfig  # noqa: E402
from svdfeature_tpu_torch.data.streaming import StreamingPlusBuffer  # noqa: E402
from svdfeature_tpu_torch.data.text import load_plus_text  # noqa: E402
from svdfeature_tpu_torch.ops import cuda_scatter, svdpp_big  # noqa: E402
from svdfeature_tpu_torch.params import SVDTypeParam  # noqa: E402
from svdfeature_tpu_torch.solvers import base  # noqa: E402
from svdfeature_tpu_torch.solvers.svdpp import SVDPPFeatureTrainer  # noqa: E402

SEED = 2**31 + 77
ROUNDS = 3
DECAY = dict(decay_learning_rate="1", decay_rate="0.9")
BODIES = ("carry", "entry-stream")


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def cell():
    """The tiny carry cell's spec and its training split."""
    s = tiny_carry.carry("dense")
    return s, kdd_groups.make(s.cfg["conf"], s.traffic, SEED)["train"]


def trainer(cell, body: str, device: str):
    """The cell's trainer with a decaying learning rate, loaded from the
    seed's leaves, and the round's dataset; ``entry-stream`` packs
    without the carry plan, so its epoch takes the entry-stream body."""
    s, train = cell
    conf = {**program.conf_keys(s.cfg, s.traffic, device), **DECAY}
    tr = program.build_trainer(conf, leaves.write_checkpoint(
        s.cfg, leaves.initial(s.cfg, SEED, torch.device(device))))
    tr.init_trainer()
    if body == "entry-stream":
        tr._carry_users_plan = lambda packed: None
    return tr, program.dataset(s.cfg, train)


def rounds(tr, ds, first: int = 0, n: int = ROUNDS) -> None:
    """The train task's rounds ``first`` .. ``first + n - 1``."""
    for r in range(first, first + n):
        tr.set_round(r)
        tr.update_all(ds)
        tr.finish_round()
        tr.synchronize()


def train(tr, ds, entry: str) -> None:
    if entry == "update_all":
        rounds(tr, ds)
    else:
        tr.update_rounds(ds, ROUNDS)
        tr.synchronize()


def eager(tr):
    """``tr`` with every big-table round run eagerly."""
    tr._round_graph = lambda entry: None
    return tr


def assert_states_close(got, want) -> None:
    got, want = got.state_or_model(), want.state_or_model()
    assert torch.isfinite(got.w).all() and torch.isfinite(want.w).all()
    for name in ("w", "b", "g"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), atol=1e-6, rtol=1e-5)
    assert torch.equal(got.ref_ui, want.ref_ui) and int(got.step) == int(want.step)


# ---- CPU --------------------------------------------------------------------------
@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("entry", ["update_all", "update_rounds"])
def test_cpu_big_svdpp_rounds_capture_nothing_and_equal_the_epoch_loop(cell, body, entry):
    """On CPU tensors the big SVD++ route makes no graph: its rounds equal
    the plain loop of ``train_epoch_plus_big`` at the decayed learning
    rates bit for bit, and every step and chunk is counted once."""
    tr, ds = trainer(cell, body, "cpu")
    assert tr.hp.big_table and not tr.hp.sweep_table
    tracing.enable()
    train(tr, ds, entry)
    tracing.disable()
    _, counters = tracing.drain()
    assert not any(name.startswith("graph.") for name in counters)
    assert tr._graphs == {}
    pack = tr._plus_cache[id(ds)]
    carry = "chunk_users" in pack.fb
    assert carry == (body == "carry")
    n = svdpp_big.epoch_counts(pack.chunk_id)
    assert n["chunks"] > 1
    assert counters["steps"] == n["steps"] * ROUNDS and counters["chunks"] == n["chunks"] * ROUNDS

    ref, _ = trainer(cell, body, "cpu")
    want = ref._pack_plus(ds)
    state = ref.state
    for r in range(ROUNDS):
        ref.set_round(r)
        lr = torch.tensor([ref.learning_rate], dtype=torch.float32)[0]
        state = svdpp_big.train_epoch_plus_big(
            state, want.stacked, want.chunk_id, want.fb, want.fb_overlap, lr, ref.consts, ref.hp,
            ref._plus_hyper(), carry_users=carry)
    assert tr.learning_rate < float(tr.tparam.learning_rate) * 0.85  # decayed twice or more
    assert torch.isfinite(state.w).all()
    for name in ("w", "g", "step"):
        assert torch.equal(getattr(tr.state, name), getattr(state, name)), name


# ---- the card ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest --noconftest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("entry", ["update_all", "update_rounds"])
def test_graph_rounds_match_eager_rounds_on_card(cell, card, body, entry):
    """Three rounds through the graph (eager, capture, replay) equal three
    eager rounds; a decaying learning rate reaches the replays; one
    capture, two replays, every step, chunk and K5 launch counted once."""
    tr, ds = trainer(cell, body, "cuda")
    before = cuda_scatter.row_writer.launches
    tracing.enable()
    train(tr, ds, entry)
    tracing.disable()
    _, counters = tracing.drain()
    launches = cuda_scatter.row_writer.launches - before
    pack = tr._plus_cache[id(ds)]
    carry = "chunk_users" in pack.fb
    assert carry == (body == "carry") and len(tr._graphs) == 1
    n = svdpp_big.epoch_counts(pack.chunk_id)
    assert counters["graph.captures"] == 1 and counters["graph.replays"] == ROUNDS - 1
    assert counters["steps"] == n["steps"] * ROUNDS and counters["chunks"] == n["chunks"] * ROUNDS
    assert launches == svdpp_big.k5_launches(pack.chunk_id, carry) * ROUNDS
    ref, _ = trainer(cell, body, "cuda")
    train(eager(ref), ds, entry)
    assert ref._graphs == {} and tr.learning_rate == ref.learning_rate
    assert tr.learning_rate < float(tr.tparam.learning_rate) * 0.85
    assert_states_close(tr, ref)


@pytest.mark.cuda
def test_a_loaded_checkpoint_is_captured_anew_on_card(cell, card):
    """A checkpoint loaded after the capture round gives the trainer a new
    table: its next round runs eagerly and the one after captures again, so
    no replay reads the table that went."""
    out = []
    for graphs in (True, False):
        tr, ds = trainer(cell, "carry", "cuda")
        if not graphs:
            eager(tr)
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
        out.append((tr, ds, tracing.drain()[1]))
    (tr, ds, counters), (ref, _, ref_counters) = out
    assert counters["graph.captures"] == 2 and counters["graph.replays"] == 3
    assert "graph.captures" not in ref_counters
    n = svdpp_big.epoch_counts(tr._plus_cache[id(ds)].chunk_id)
    assert counters["steps"] == ref_counters["steps"] == n["steps"] * 5
    assert counters["chunks"] == ref_counters["chunks"] == n["chunks"] * 5
    assert_states_close(tr, ref)


@pytest.mark.cuda
def test_a_streamed_run_captures_nothing_on_card(cell, card, tmp_path):
    """Streamed chunks are new entries each time: their rounds run eagerly.
    One chunk of every user sorts as the staged pack does, so the streamed
    rounds equal the staged rounds through the graph."""
    tr, ds = trainer(cell, "carry", "cuda")
    path = tmp_path / "train.buffer"
    write_plus_buffer(str(path), ds)
    users = len(cell[1]["sizes"])
    tracing.enable()
    rounds(tr, StreamingPlusBuffer(str(path), blocks_per_chunk=users))
    tracing.disable()
    _, counters = tracing.drain()
    assert "graph.captures" not in counters and tr._graphs == {}
    assert tr.chunk_stream.stats.chunks == 1
    staged, _ = trainer(cell, "carry", "cuda")
    rounds(staged, ds)
    assert len(staged._graphs) == 1
    assert_states_close(tr, staged)


def pair_source(g_feats: bool) -> PairSource:
    """A pairwise-rank source of 16 users with 2-30 rows each over 30
    items, the low ids the positives (tests/test_rank.py's pair data)."""
    rng = np.random.RandomState(4)
    rows, fb = [], []
    for u in range(16):
        items = rng.choice(30, min(2 + 7 * (u % 5), 30), replace=False)
        seg = "1 1 1 0:0.5" if g_feats else "0 1 1"
        rows += [f"{float(i < 15)} {seg} {u}:1 {i}:1" for i in items]
        fb.append(f"{len(items)} 0")
    return PairSource(load_plus_text("x", "y", text="\n".join(rows), feedback_text="\n".join(fb)),
                      IteratorConfig(), seed=9)


PAIRS = {  # keys; the source's global features; the entry point
    # the pair skeleton: one big epoch a round from the sampled rows
    "skeleton": (dict(users_per_batch=16, num_global=0), False, "update_all"),
    # the multi-round host sampler on a big table
    "skeleton-update_rounds": (dict(users_per_batch=16, num_global=0), False, "update_rounds"),
    # global features: a freshly packed pair epoch a round (_pair_entry)
    "fresh-epoch": (dict(users_per_batch=4, num_global=6), True, "update_all"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PAIRS))
def test_pair_epochs_capture_nothing_on_card(card, monkeypatch, case):
    """Pair epochs are new planes every round: on a big table on the card
    each round runs the big epoch eagerly."""
    keys, g_feats, entry = PAIRS[case]
    monkeypatch.setattr(base, "BIG_TABLE_ROWS", 4)
    tr = SVDPPFeatureTrainer(SVDTypeParam(format_type=1, active_type=3))
    for k, v in {"learning_rate": 0.02, "wd_user": 0.004, "wd_item": 0.004, "num_user": 60,
                 "num_item": 100, "num_factor": 8, "num_ufeedback": 130, "wd_ufeedback": 0.004,
                 "no_user_bias": 1, "device": "cuda", **keys}.items():
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    assert tr.hp.big_table
    src = pair_source(g_feats)
    w0 = tr.state_or_model().w.clone()
    tracing.enable()
    if entry == "update_all":
        rounds(tr, src)
    else:
        tr.update_rounds(src, ROUNDS)
        tr.synchronize()
    tracing.disable()
    _, counters = tracing.drain()
    assert "graph.captures" not in counters and tr._graphs == {} and tr._plus_cache == {}
    assert counters["steps"] > 0
    w = tr.state_or_model().w
    assert torch.isfinite(w).all() and not torch.equal(w, w0)
