"""The port's tracer (svdfeature_tpu_torch/tracing.py): spans, counters, the
train task's ``trace`` key, and that tracing changes no trained bit.

The big-table run is the route of the benchmark's MF cell cut to a CPU
size (portbench/tests/tiny.py): a 10,001-row table, k=8, batches of 1024,
the sorted-dedup step.  The SVD++ run is one round of the ML-100K demo's
user groups (k=64, 128 users x 8 rows a step).  The tests marked ``cuda``
count the host's syncs on the card.
"""

import ast
import contextlib
import gzip
import inspect
import itertools
import json
import pathlib
import tracemalloc

import numpy as np
import pytest
import torch

from svdfeature_tpu_torch import tracing
from svdfeature_tpu_torch.data.buffer import write_csr_buffer
from svdfeature_tpu_torch.data.csr import CSRDataset
from svdfeature_tpu_torch.data.text import load_feature_text, load_plus_text
from svdfeature_tpu_torch.params import SVDTypeParam, svd_type
from svdfeature_tpu_torch.solvers.registry import create_svd_trainer
from svdfeature_tpu_torch.train.loop import SVDTrainTask

PKG = pathlib.Path(tracing.__file__).resolve().parent
FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
STEP_CHILDREN = ("forward", "payload", "merge", "write")
MF = dict(num_user=6000, num_item=4000, num_factor=8, num_global=0, base_score=3,
          learning_rate=0.005, wd_user=0.004, wd_item=0.004, batch_size=1024)
SVDPP = dict(num_user=943, num_item=1682, num_ufeedback=1682, num_factor=64, num_global=0,
             base_score=3, learning_rate=0.005, wd_user=0.004, wd_item=0.004,
             wd_ufeedback=0.004, users_per_batch=128, rows_per_user=8, sort_blocks=1)


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and drained."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def trainer(conf: dict, device="cpu", fmt=svd_type.AUTO_DETECT):
    mtype = SVDTypeParam()
    keys = {**{k: str(v) for k, v in conf.items()}, "device": device}
    for name, val in keys.items():
        mtype.set_param(name, val)
    mtype.decide_format(fmt)
    tr = create_svd_trainer(mtype)
    for name, val in keys.items():
        tr.set_param(name, val)
    tr.init_model()
    tr.init_trainer()
    return tr


def mf_rows(n=4096, seed=3) -> CSRDataset:
    """``n`` ratings of one user and one item each, Zipf-skewed items."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, MF["num_user"], n)
    items = np.minimum(rng.zipf(1.8, n) - 1, MF["num_item"] - 1)
    row_ptr = np.zeros(3 * n + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.tile(np.array([0, 1, 1], np.int32), n))
    index = np.empty(2 * n, np.uint32)
    index[0::2], index[1::2] = users, items
    return CSRDataset(labels=rng.uniform(1, 5, n).astype(np.float32), row_ptr=row_ptr,
                      index=index, value=np.ones(2 * n, np.float32))


def train(tr, ds, rounds, traced: bool):
    if traced:
        tracing.enable()
    for r in range(rounds):
        tr.set_round(r)
        tr.update_all(ds)
        tr.finish_round()
        tr.synchronize()
    tracing.disable()
    return tracing.drain()


def demo_groups():
    def text(name):
        with gzip.open(FIXTURES / name, "rt") as f:
            return f.read()

    return load_plus_text("x", text=text("ml100k.base.group.feature.gz"),
                          feedback_text=text("ml100k.base.feedback.gz"))


def test_tracing_off_records_nothing():
    tr = trainer(MF)
    spans, counters = train(tr, mf_rows(), 2, traced=False)
    assert spans == [] and counters == {} and not tracing.on


def test_spans_nest_with_parents_rounds_and_self_time():
    tracing.enable()
    tracing.set_round(3)
    tracing.begin("outer")
    tracing.begin("a")
    tracing.then("b")
    tracing.count("n", 2)
    t0 = tracing.now()
    tracing.add("measured", t0, t0 + 5)
    tracing.end()
    tracing.end()
    tracing.set_round(4)
    tracing.begin("next")
    tracing.end()
    spans, counters = tracing.drain()
    by = {s.name: s for s in spans}
    assert set(by) == {"outer", "a", "b", "measured", "next"} and counters == {"n": 2}
    outer = by["outer"]
    assert by["a"].parent == by["b"].parent == outer.id and outer.parent == -1
    assert by["measured"].parent == by["b"].id and by["next"].parent == -1
    assert by["a"].end == by["b"].start  # then(): one instant
    assert {s.round for s in spans if s.name != "next"} == {3} and by["next"].round == 4
    for s in spans:
        assert s.start <= s.end
    own = tracing.self_ns(spans)
    dur = {n: s.end - s.start for n, s in by.items()}
    assert own["outer"] == dur["outer"] - dur["a"] - dur["b"]
    assert own["b"] == dur["b"] - 5 and own["measured"] == 5
    assert tracing.total_s(spans, "outer") == dur["outer"] / 1e9
    assert tracing.drain() == ([], {})


def test_big_table_round_records_each_step_and_its_children():
    tr = trainer(MF)
    assert tr.hp.big_table and not tr.hp.sweep_table  # the sorted-dedup route
    ds = mf_rows()
    rounds, T = 2, 4096 // MF["batch_size"]
    spans, counters = train(tr, ds, rounds, traced=True)
    assert counters["steps"] == T * rounds
    names = [s.name for s in spans]
    assert names.count("pack") == 1 and names.count("batches") == rounds
    steps = [s for s in spans if s.name == "step"]
    assert len(steps) == T * rounds
    assert sorted(s.round for s in steps) == [r for r in range(rounds) for _ in range(T)]
    for step in steps:
        kids = sorted((s for s in spans if s.parent == step.id), key=lambda s: s.start)
        assert [k.name for k in kids] == list(STEP_CHILDREN)
        assert all(step.start <= k.start <= k.end <= step.end for k in kids)


def test_tracing_changes_no_trained_bit_big_table():
    ds = mf_rows()
    states = []
    for traced in (False, True):
        tr = trainer(MF)
        train(tr, ds, 2, traced)
        states.append(tr.state)
    for name in ("w", "b", "g", "step"):
        assert torch.equal(getattr(states[0], name), getattr(states[1], name)), name


def test_tracing_changes_no_trained_bit_svdpp_demo_round():
    ds = demo_groups()
    states = []
    for traced in (False, True):
        tr = trainer(SVDPP, fmt=svd_type.USER_GROUP_FORMAT)
        spans, _ = train(tr, ds, 1, traced)
        assert [s.name for s in spans] == (["pack"] if traced else [])
        states.append(tr.state)
    for name in ("w", "b", "g", "step"):
        assert torch.equal(getattr(states[0], name), getattr(states[1], name)), name


@pytest.fixture
def conf(tmp_path):
    text = "\n".join(f"{(i % 5) + 1} 0 1 1 {i % 29}:1 {(i * 7) % 37}:1" for i in range(200))
    write_csr_buffer(str(tmp_path / "train.buffer"), load_feature_text("x", text=text),
                     batch_size=64)
    path = tmp_path / "t.conf"
    path.write_text("num_user = 29\nnum_item = 37\nnum_factor = 8\nbatch_size = 32\n"
                    f'buffer_feature = "{tmp_path}/train.buffer"\n')
    return path


@pytest.mark.parametrize("trace", [0, 1])
def test_train_task_trace_key_adds_spans_to_the_json_lines(conf, trace):
    log = conf.parent / f"log{trace}.jsonl"
    SVDTrainTask().run(str(conf), [f"model_out_folder={conf.parent}/models{trace}",
                                   "num_round=2", "silent=1", "device=cpu",
                                   f"log_jsonl={log}", f"trace={trace}"])
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    plain = {"round", "elapsed_s", "round_s", "examples", "learning_rate"}
    assert len(lines) == 2 and not tracing.on
    for i, line in enumerate(lines):
        if not trace:
            assert set(line) == plain
            continue
        assert set(line) == plain | {"span_self_ms", "counters"}
        # the first round packs the buffer; no round on the CPU launches a kernel
        assert set(line["span_self_ms"]) == ({"pack"} if i == 0 else set())
        assert line["counters"] == {} and all(v >= 0 for v in line["span_self_ms"].values())


GUARDED = {"begin", "end", "then", "add", "count", "set_round", "now"}


def _unguarded_calls(tree: ast.AST):
    """Calls of ``tracing.<fn>`` that no ``if tracing.on`` (or ``... if
    tracing.on else ...``) encloses."""

    def is_flag(node):
        return (isinstance(node, ast.Attribute) and node.attr == "on"
                and isinstance(node.value, ast.Name) and node.value.id == "tracing")

    def walk(node, guarded):
        if isinstance(node, (ast.If, ast.IfExp)) and is_flag(node.test):
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                yield from walk(child, True)
            orelse = node.orelse if isinstance(node.orelse, list) else [node.orelse]
            for child in orelse:
                yield from walk(child, guarded)
            return
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name) and node.func.value.id == "tracing"
                and node.func.attr in GUARDED and not guarded):
            yield node.lineno
        for child in ast.iter_child_nodes(node):
            yield from walk(child, guarded)

    return list(walk(tree, False))


def test_every_span_site_is_one_flag_test_when_off():
    """Every call into the tracer from the port sits under ``if
    tracing.on``: the off path reads the flag and nothing else."""
    found = {}
    for path in PKG.rglob("*.py"):
        if path.name == "tracing.py":
            continue
        src = path.read_text()
        if "tracing." not in src:
            continue
        found[path.relative_to(PKG).as_posix()] = _unguarded_calls(ast.parse(src))
    assert {"solvers/base.py", "ops/big_embed.py", "ops/cuda_svdpp.py", "ops/_build.py",
            "solvers/streamed.py", "solvers/svdpp.py"} <= set(found)
    assert {p: lines for p, lines in found.items() if lines} == {}


def _site():
    if tracing.on:
        tracing.begin("x")
    if tracing.on:
        tracing.then("y")
    if tracing.on:
        tracing.end()


def _nothing():
    pass


def _object_per_call():
    return contextlib.nullcontext()


def _peak_bytes(fn, calls=10_000) -> int:
    """The most memory that ``calls`` calls of ``fn`` held at once beyond
    what was held before them (tracemalloc's peak)."""
    fn()
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, calls):
            fn()
        return tracemalloc.get_traced_memory()[1] - before
    finally:
        tracemalloc.stop()


def test_a_disabled_site_allocates_nothing():
    base = _peak_bytes(_nothing)  # the measurement's own
    assert _peak_bytes(_object_per_call) > base  # it sees one object a call
    assert _peak_bytes(_site) == base
    assert tracing.drain() == ([], {})


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: host syncs are counted on the card")


def _syncs(counters):
    return {k: v for k, v in counters.items() if k.startswith("host_syncs")}


@pytest.mark.cuda
def test_host_sync_counter_counts_a_deliberate_item(card):
    x = torch.ones(4, device="cuda")
    tracing.enable()
    tracing.begin("probe")
    x.sum().item()
    tracing.end()
    tracing.disable()
    _, counters = tracing.drain()
    assert _syncs(counters) == {"host_syncs": 1, "host_syncs.probe": 1}
    assert torch.cuda.get_sync_debug_mode() == 0  # restored


def _line_of(fn, text: str) -> str:
    lines, first = inspect.getsourcelines(fn)
    (at,) = [first + i for i, line in enumerate(lines) if line.strip() == text]
    return f"{inspect.getsourcefile(fn)}:{at}"


@pytest.mark.cuda
def test_host_syncs_in_a_batch_4096_dedup_round(card):
    """A round of 8 sorted-dedup steps at batch 4096 (K5 writes) after a
    warm round (packing and build done): each step syncs the host once, in
    ``forward``, where ``_global_step`` zeroes the global table's padding
    slot with a Python scalar (``g[-1] = 0.0``: a copy from the host)."""
    from svdfeature_tpu_torch.ops import big_embed

    conf = dict(MF, num_user=200_000, num_item=100_000, num_factor=64, batch_size=4096)
    tr = trainer(conf, device="cuda")
    ds = mf_rows(8 * 4096)
    train(tr, ds, 1, traced=False)
    spans, counters = train(tr, ds, 1, traced=True)
    assert counters["steps"] == 8 and counters.get("launches.K5") == 8
    print("dedup round:", _syncs(counters), tracing.sync_sites)
    assert _syncs(counters) == {"host_syncs": 8, "host_syncs.forward": 8}, tracing.sync_sites
    site = "forward " + _line_of(big_embed._global_step, "g[-1] = 0.0")
    assert tracing.sync_sites == {site: 8}


@pytest.mark.cuda
def test_host_syncs_in_a_k2_round(card):
    """One K2 round of the ML-100K demo after a warm round: its syncs."""
    tr = trainer(SVDPP, device="cuda", fmt=svd_type.USER_GROUP_FORMAT)
    ds = demo_groups()
    train(tr, ds, 1, traced=False)
    spans, counters = train(tr, ds, 1, traced=True)
    assert counters.get("launches.K2") == 1
    assert [s.name for s in spans if s.name.startswith("k2")] == ["k2.prepare", "k2.launch", "k2"]
    print("K2 round:", _syncs(counters), tracing.sync_sites)
    assert _syncs(counters) == {}, tracing.sync_sites
