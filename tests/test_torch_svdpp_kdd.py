"""Big-table SVD++ with real implicit feedback (N(u) = the user's rated
items), the configuration of the benchmark's ``kdd11_svdpp.carry`` cell,
at CPU sizes (portbench/tests/tiny_carry.py):

- the port's staged big-table route (``update_all`` -> ``_pack_plus`` with
  the overlap built on the training device -> the user-carry epoch)
  against the benchmark's plain reference (portbench/reference/
  svdpp_big.py), with densely and with sparsely shared feedback;
- the overlap made on the device (ops/fb_overlap.py) against the copied
  ``compute_fb_overlap`` / ``compute_fb_overlap_factored``;
- the cell's generator (portbench/gen/kdd_groups.py);
- the carry epoch's spans and counters, and (``cuda``) that its steps make
  no host sync on the card.

No JAX here: the reference is the benchmark's plain PyTorch one.
"""

import math
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.gen import kdd_groups  # noqa: E402
from portbench.harness import cell  # noqa: E402
from portbench.reference import svdpp as ref_svdpp  # noqa: E402
from portbench.reference import svdpp_big as ref_big  # noqa: E402
from portbench.tests import tiny_carry  # noqa: E402
from svdfeature_tpu_torch import tracing  # noqa: E402
from svdfeature_tpu_torch.data import batching_plus  # noqa: E402
from svdfeature_tpu_torch.data.text import load_plus_text  # noqa: E402
from svdfeature_tpu_torch.ops import fb_overlap  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 41
# The program carries each user's feedback sum through a chunk by the
# overlap (fb_sum += O @ delta) and merges a step's item rows by sorted
# dedup; the reference gathers the sums from the tables at every step and
# adds with index_add_.  The same f32 sums in another order: the readings
# are 2e-8 to 3e-6 over 2 rounds of up to 37 steps; each limit leaves more
# than 10x room above that, and the reference in bfloat16 (eps 7.8e-3)
# reads 5e-3 to 0.26.
TOL = dict(change_gap_r1=1e-5, change_gap=1e-5, state_gap=1e-4, probe_gap=1e-5)


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _readings(spec, device=CPU):
    data = kdd_groups.make(spec.cfg["conf"], spec.traffic, SEED)
    trainer, ds, side, _ = cell.program_rounds(spec, SEED, device, data)
    side["seed"] = SEED
    return trainer, ds, data, side


# ---- (a) the staged carry route against the plain reference ---------------------------

@pytest.mark.parametrize("shared", ["dense", "sparse"])
def test_carry_route_matches_the_plain_reference(shared):
    s = tiny_carry.carry(shared)
    trainer, ds, data, side = _readings(s)
    assert trainer.hp.big_table and not trainer.hp.sweep_table
    entry = trainer._plus_cache[id(ds)]
    assert "chunk_users" in entry.fb  # the user-carry epoch
    # Ld > G+1 gives the dense overlap, a few shared ids the factored one
    assert isinstance(entry.fb_overlap, dict) == (shared == "sparse")
    ref = cell.reference_readings(s, SEED, CPU, data)
    got = cell.numbers(s, side, ref, CPU)
    for n, tol in TOL.items():
        assert got[n] <= tol, (n, got[n])
    low = cell.reference_readings(s, SEED, CPU, data, dtype=torch.bfloat16)
    control = cell.numbers(s, dict(seed=SEED, n1=low["n1"], final=low["leaves"],
                                   probe=low["probe"]), ref, CPU)
    assert any(control[n] > tol for n, tol in TOL.items()), control


# ---- (b) the overlap built from the staged pool -----------------------------------------

def _pool(rng, C, G, F, id_range, empty=()):
    """``[C, F]`` pools of G users with padding (value 0, the dummy id, slot
    G) and a repeated (user, id) pair in each live chunk."""
    idx = np.full((C, F), 10**6, np.int32)
    val = np.zeros((C, F), np.float32)
    blk = np.full((C, F), G, np.int32)
    for c in range(C):
        if c in empty:
            continue
        n = int(rng.integers(F // 2, F))
        idx[c, :n] = rng.integers(0, id_range, n)
        val[c, :n] = rng.uniform(0.1, 1.0, n)
        blk[c, :n] = np.sort(rng.integers(0, G, n))
        idx[c, 1], blk[c, 1] = idx[c, 0], blk[c, 0]
    return idx, val, blk


def _copy_overlap(idx, val, blk, G):
    fac = batching_plus.compute_fb_overlap_factored(idx, val, blk, G)
    if fac is not None:
        return {"diag": fac[0], "dup": fac[1]}
    return batching_plus.compute_fb_overlap(idx, val, blk, G)


@pytest.mark.parametrize("case", ["dense", "factored", "all-empty", "forced-dense", "fb_ctx"])
def test_card_overlap_equals_the_copy(monkeypatch, case):
    """Both forms of the big tables' rule, with an empty chunk among live
    ones, and a pool with no live entry; the dense form a small table
    takes where the rule would factor; a stacked pack's context plane
    (``fb_ctx``, dense); the dense product over blocks of 5 shared ids."""
    monkeypatch.setattr(fb_overlap, "COLS", 5)
    rng = np.random.default_rng(3)
    G = 5 if case == "fb_ctx" else 16
    id_range = {"dense": 40, "factored": 100_000, "all-empty": 1, "forced-dense": 100_000,
                "fb_ctx": 60}[case]
    empty = {"dense": (1,), "factored": (2,), "all-empty": (0, 1, 2), "forced-dense": (0,),
             "fb_ctx": (2,)}[case]
    idx, val, blk = _pool(rng, 3, G, 120, id_range, empty)
    factored = case in ("dense", "factored", "all-empty")
    slots = "fb_ctx" if case == "fb_ctx" else "fb_block"
    want = (_copy_overlap(idx, val, blk, G) if factored
            else batching_plus.compute_fb_overlap(idx, val, blk, G))
    got = fb_overlap.build({"fb_idx": torch.from_numpy(idx), "fb_val": torch.from_numpy(val),
                            slots: torch.from_numpy(blk)}, G, factored=factored, slots=slots)
    assert isinstance(got, dict) == isinstance(want, dict) == (case in ("factored", "all-empty"))
    if not isinstance(want, dict):
        # the copy's f32 product sums each entry over up to 120 ids in its
        # own order; build() sums in float64 and rounds once
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        return
    assert got["dup"].shape == want["dup"].shape
    # the same entries in the same columns; a diagonal entry sums a
    # user's squares in another order
    np.testing.assert_array_equal(got["dup"].numpy(), want["dup"])
    np.testing.assert_allclose(got["diag"].numpy(), want["diag"], rtol=1e-6, atol=0)


def _groups_text(rng, users, items, fb_bound):
    rows, fbs = [], []
    for u in range(users):
        n = int(rng.integers(2, 6))
        rows += [f"{rng.integers(1, 6)} 0 1 1 {u}:1 {rng.integers(0, items)}:1" for _ in range(n)]
        nf = int(rng.integers(1, 8))
        fbs.append(f"{n} {nf} " + " ".join(f"{rng.integers(0, fb_bound)}:{rng.random():.3f}"
                                            for _ in range(nf)))
    return "\n".join(rows), "\n".join(fbs)


SMALL = dict(num_user=30, num_item=20, num_ufeedback=20, num_factor=4, base_score=3,
             users_per_batch=8, rows_per_user=2, sort_blocks=1, device="cpu")
# a stacked tag stream: a context opened, added to and closed every 6 users
STACKED_TAGS = (1, 0, 3, 2, 0, 0)  # TAG_START, DEFAULT, MIDDLE, END, DEFAULT, DEFAULT


def _small_trainer(kind="svdpp", **extra):
    """A small-table trainer of the SVD++ family on the CPU (``kind``:
    svdpp, bilinear, imfb or rank), initialised."""
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.bilinear import SVDBiLinearTrainer
    from svdfeature_tpu_torch.solvers.multi_imfb import SVDPPMultiIMFBTrainer
    from svdfeature_tpu_torch.solvers.svdpp import SVDPPFeatureTrainer

    cls, mtype = {"svdpp": (SVDPPFeatureTrainer, {}),
                  "rank": (SVDPPFeatureTrainer, dict(active_type=3)),
                  "bilinear": (SVDBiLinearTrainer, dict(extend_type=15)),
                  "imfb": (SVDPPMultiIMFBTrainer, dict(extend_type=2))}[kind]
    tr = cls(SVDTypeParam(format_type=1, **mtype))
    conf = dict(SMALL, **extra)
    if kind == "bilinear":
        conf.update(num_bi_feedback=6, start_ufeedback=2)
    if kind == "rank":
        conf.update(base_score=0.5)
    for n, v in conf.items():
        tr.set_param(n, str(v))
    tr.init_model()
    tr.init_trainer()
    return tr


def _small_ds(stacked=False):
    from svdfeature_tpu_torch.data.csr import PlusDataset

    rows, fbs = _groups_text(np.random.default_rng(5), 30, 20, 20)
    ds = load_plus_text("x", "y", text=rows, feedback_text=fbs)
    if not stacked:
        return ds
    return PlusDataset.from_blocks([type(b)(b.fb_index, b.fb_value, b.data, extend_tag=t)
                                    for b, t in zip(ds.blocks(), STACKED_TAGS * 5)])


def _pair_source():
    """A PairSource of single-(user, item) rows that the pair skeleton
    takes (tests/test_torch_rank.py's data, no global features)."""
    from svdfeature_tpu_torch.data.rank import PairSource
    from svdfeature_tpu_torch.data.registry import IteratorConfig

    rng = np.random.RandomState(4)
    rows, fbs = [], []
    for u in range(16):
        items = rng.choice(20, min(2 + 7 * (u % 5), 20), replace=False)
        rows += [f"{float(i < 10)} 0 1 1 {u}:1 {i}:1" for i in items]
        fbs.append(f"{len(items)} 0")
    return PairSource(load_plus_text("x", "y", text="\n".join(rows), feedback_text="\n".join(fbs)),
                      IteratorConfig(), seed=9)


def _stream(tmp_path, ds):
    from svdfeature_tpu_torch.data.buffer import write_plus_buffer
    from svdfeature_tpu_torch.data.streaming import StreamingPlusBuffer

    write_plus_buffer(str(tmp_path / "groups.buffer"), ds)
    return StreamingPlusBuffer(str(tmp_path / "groups.buffer"), blocks_per_chunk=16)


def _on_mesh(tr):
    """``tr`` as rank (0, 0) of a 2x1 mesh, for packing alone (no group is
    made: an entry only slices its planes)."""
    from svdfeature_tpu_torch.parallel.comm import Mesh

    tr.mesh, tr.mesh_data = Mesh(2, 1, 0, 0, {"model": None, "data": None}, CPU), 2
    return tr


def test_small_table_pack_keeps_the_copy_overlap():
    """A small table's staged pack takes the dense overlap of the copy's
    host function, built on the device from the staged pool."""
    tr = _small_trainer()
    assert not tr.hp.big_table
    ds = _small_ds()
    entry = tr._pack_plus(ds)
    packed = tr._pack_numpy(ds)
    assert packed.fb_overlap is None  # the pack leaves it to the device
    want = batching_plus.compute_fb_overlap(packed.fb_idx, packed.fb_val, packed.fb_block,
                                            packed.num_blocks_local)
    # the copy's f32 product against build()'s float64 one, rounded once
    np.testing.assert_allclose(entry.fb_overlap.numpy(), want, rtol=1e-6, atol=1e-7)


ROUTES = ["staged small", "staged big", "streamed chunk", "pair skeleton", "bilinear",
          "multi-IMFB staged", "mesh entry", "prediction"]


@pytest.mark.parametrize("route", ROUTES)
def test_big_route_pack_runs_no_host_overlap(monkeypatch, tmp_path, route):
    """No packing route calls the copy's host overlap (its ``[G+1, Ld]`` /
    ``[G+1, U]`` arrays and its GEMM): with both functions made to raise,
    every route still packs, and an entry staged for training holds the
    overlap ``fb_overlap.build`` made on the device."""
    from portbench.harness import leaves, program

    def host_overlap(*args):
        raise AssertionError("the host overlap ran")

    builds = []
    build = fb_overlap.build

    def patch():
        monkeypatch.setattr(batching_plus, "compute_fb_overlap", host_overlap)
        monkeypatch.setattr(batching_plus, "compute_fb_overlap_factored", host_overlap)
        monkeypatch.setattr(fb_overlap, "build", lambda *a, **k: builds.append(1) or build(*a, **k))

    if route == "staged big":
        s = tiny_carry.carry("dense")
        data = kdd_groups.make(s.cfg["conf"], s.traffic, SEED)
        trainer = program.build_trainer(
            program.conf_keys(s.cfg, s.traffic, "cpu"),
            leaves.write_checkpoint(s.cfg, leaves.initial(s.cfg, SEED, CPU)))
        trainer.init_trainer()
        ds = program.dataset(s.cfg, data["train"])
        patch()
        entry = trainer._pack_plus(ds)
        G = trainer.users_per_batch
        assert entry.fb_overlap.shape == (4, G + 1, G + 1) and builds == [1]
        return
    kind = {"pair skeleton": "rank", "bilinear": "bilinear", "multi-IMFB staged": "imfb"}
    tr = _small_trainer(kind.get(route, "svdpp"))
    ds = _small_ds(stacked=route == "multi-IMFB staged")
    built = []
    if route in ("streamed chunk", "prediction"):
        src = _stream(tmp_path, ds)
        with_overlap = tr._with_overlap
        monkeypatch.setattr(tr, "_with_overlap", lambda e: built.append(with_overlap(e)) or e)
    patch()
    if route == "streamed chunk":
        tracing.enable()
        tr.update_all(src)
        tracing.disable()
        spans, counters = tracing.drain()
        assert tr.chunk_stream.stats.chunks == len(built) > 1
        assert all(e.fb_overlap.shape[1:] == (9, 9) for e in built)
        assert counters["overlap.dense"] == sum(len(e.fb_overlap) for e in built)
        # the producer thread's builds leave the training thread's spans whole
        assert {s.name for s in spans} == {"stream.chunk", "stream.wait"}
        assert all(s.parent == -1 for s in spans)
    elif route == "prediction":
        assert len(tr.predict_all(src)) == ds.rows.num_row and built == []
    elif route == "pair skeleton":
        src = _pair_source()
        tr.update_all(src)
        assert tr._pair_sk is not None and tr._pair_sk["overlap"].dim() == 3
    elif route == "mesh entry":
        assert _on_mesh(tr)._stage_packed(tr._pack_numpy(ds)).fb_overlap is None
    else:
        entry = tr._pack_plus(ds)
        nseg = entry.enabled.shape[1] if route == "multi-IMFB staged" else 9
        assert entry.fb_overlap.shape[1:] == (nseg, nseg)
        tr.update_all(ds)
    assert (builds == []) == (route in ("mesh entry", "prediction"))


@pytest.mark.parametrize("route", ["mesh", "refresh", "multi-IMFB big", "prediction"])
def test_no_overlap_where_no_epoch_reads_it(monkeypatch, tmp_path, route):
    """Mesh entries, the refresh routes' entries (a shared feedback space;
    multi-IMFB's big-table epoch) and prediction entries stage no overlap
    and build none."""
    from svdfeature_tpu_torch.solvers import base as tbase

    calls = []
    build = fb_overlap.build
    monkeypatch.setattr(fb_overlap, "build", lambda *a, **k: calls.append(1) or build(*a, **k))
    if route == "multi-IMFB big":
        monkeypatch.setattr(tbase, "BIG_TABLE_ROWS", 4)
    kind = "imfb" if route == "multi-IMFB big" else "svdpp"
    tr = _small_trainer(kind, **({"common_feedback_space": 1} if route == "refresh" else {}))
    ds = _small_ds(stacked=route == "multi-IMFB big")
    if route == "mesh":
        entries = [_on_mesh(tr)._stage_packed(tr._pack_numpy(ds))]
    elif route == "prediction":
        entries = []
        predict_entry = tr._predict_entry
        monkeypatch.setattr(tr, "_predict_entry",
                            lambda st, e: entries.append(e) or predict_entry(st, e))
        tr.predict_all(_stream(tmp_path, ds))
        assert len(entries) > 1
    else:
        assert tr.hp.big_table == (route == "multi-IMFB big")
        entries = [tr._pack_plus(ds)]
        tr.update_all(ds)
    assert all(e.fb_overlap is None for e in entries) and calls == []


def test_deferred_overlap_is_this_threads_alone():
    """Inside ``deferred()`` the copy's overlap answers None to this thread
    and computes for another; after it the copy's functions are as they
    were."""
    before = (batching_plus.compute_fb_overlap, batching_plus.compute_fb_overlap_factored)
    idx, val, blk = _pool(np.random.default_rng(1), 2, 8, 40, 30)
    other = {}
    with fb_overlap.deferred():
        assert batching_plus.compute_fb_overlap(idx, val, blk, 8) is None
        assert batching_plus.compute_fb_overlap_factored(idx, val, blk, 8) is None
        t = threading.Thread(target=lambda: other.update(
            O=batching_plus.compute_fb_overlap(idx, val, blk, 8)))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    assert (batching_plus.compute_fb_overlap, batching_plus.compute_fb_overlap_factored) == before
    np.testing.assert_array_equal(other["O"], before[0](idx, val, blk, 8))


def test_deferred_packs_run_side_by_side():
    """Two threads pack at once: while one is inside its ``deferred()``
    block, another enters its own and packs to the end; neither waits on
    the other's whole pack, and both still leave the overlap out."""
    tr, ds = _small_trainer(), _small_ds()
    inside, packed = threading.Event(), threading.Event()
    seen = {}

    def first():
        with fb_overlap.deferred():
            inside.set()
            seen["waited"] = packed.wait(timeout=60)
            seen["first"] = tr._pack_numpy(ds).fb_overlap

    t = threading.Thread(target=first)
    t.start()
    assert inside.wait(timeout=60)
    seen["second"] = tr._pack_numpy(ds).fb_overlap
    packed.set()
    t.join(timeout=60)
    assert not t.is_alive() and seen == {"waited": True, "first": None, "second": None}


def test_deferred_holds_under_thread_stress():
    """Sixteen threads with a short switch interval, half inside their own
    ``deferred()`` blocks and half outside: inside, the copy's overlap
    answers None every time; outside, it computes the copy's, bit for bit."""
    import sys

    idx, val, blk = _pool(np.random.default_rng(2), 2, 8, 40, 30)
    want = batching_plus.compute_fb_overlap(idx, val, blk, 8)
    wrong = []

    def work(inside):
        for _ in range(40):
            if inside:
                with fb_overlap.deferred():
                    got = batching_plus.compute_fb_overlap(idx, val, blk, 8)
                    wrong.extend([] if got is None else ["inside"])
            elif not np.array_equal(batching_plus.compute_fb_overlap(idx, val, blk, 8), want):
                wrong.append("outside")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i % 2 == 0,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and wrong == []


# ---- (c) the cell's generator -------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 2**31 + 12345])
def test_kdd_groups_sizes_items_and_feedback(seed):
    s = tiny_carry.carry("dense")
    conf, traffic = s.cfg["conf"], s.traffic
    a = kdd_groups.make(conf, traffic, seed)
    b = kdd_groups.make(conf, traffic, seed)
    for split in ("train", "probe"):
        for key in a[split]:
            np.testing.assert_array_equal(a[split][key], b[split][key])
    other = kdd_groups.make(conf, traffic, seed + 1)
    U, P = traffic["users_per_round"], traffic["probe_users"]
    for split, n in (("train", U), ("probe", P)):
        g = a[split]
        # the same sizes on every seed, within the clip
        np.testing.assert_array_equal(np.sort(g["sizes"]), np.sort(other[split]["sizes"]))
        np.testing.assert_array_equal(np.sort(g["sizes"]), kdd_groups.counts(traffic, n))
        assert len(g["sizes"]) == n
        assert g["sizes"].min() >= traffic["ratings_min"]
        assert g["sizes"].max() <= traffic["ratings_max"]
        assert len(g["labels"]) == g["sizes"].sum() == g["fb_ptr"][-1]
        owner = np.repeat(np.arange(n), g["sizes"])
        # one user a group, distinct across groups; distinct items in a group
        assert (g["users"] == np.repeat(g["users"][g["fb_ptr"][:-1]], g["sizes"])).all()
        assert len(np.unique(g["users"][g["fb_ptr"][:-1]])) == n
        assert len(np.unique(owner * 10**6 + g["items"])) == len(owner)
        assert g["items"].max() < int(conf["num_item"]) and g["users"].max() < int(conf["num_user"])
        # N(u): the group's items, each at 1/sqrt(|N(u)|)
        np.testing.assert_array_equal(g["fb_idx"], g["items"])
        np.testing.assert_array_equal(
            g["fb_val"], np.repeat((1.0 / np.sqrt(g["sizes"])).astype(np.float32), g["sizes"]))
    assert not set(a["train"]["users"]) & set(a["probe"]["users"])
    assert not np.array_equal(a["train"]["items"], other["train"]["items"])


def test_vectorised_layout_equals_the_reference_loop():
    rng = np.random.default_rng(0)
    for trial in range(40):
        sizes = rng.integers(1, 20, int(rng.integers(1, 40)))
        G, M, sort = int(rng.integers(1, 9)), int(rng.integers(1, 4)), bool(trial % 2)
        (ca, sa), (cb, sb) = (ref_svdpp.layout(sizes, G, M, sort),
                              ref_big.layout(sizes, G, M, sort))
        assert [list(x) for x in ca] == [list(x) for x in cb]
        assert [(c, list(r), list(s)) for c, r, s in sa] == [(c, list(r), list(s))
                                                           for c, r, s in sb]


# ---- (d) spans and counters of the carry epoch --------------------------------------------

CHUNK_ENTRY = ("slab.gather", "aggregates")
CARRY_STEP = ("forward", "merge", "write", "slab.update", "fb.recurrence")
CHUNK_EXIT = ("pool.writeback", "slab.write")


def _traced_rounds(trainer, ds, rounds):
    tracing.enable()
    for r in range(rounds):
        trainer.set_round(r)
        trainer.update_all(ds)
        trainer.finish_round()
        trainer.synchronize()
    tracing.disable()
    return tracing.drain()


def _children(spans, parent):
    return [s.name for s in sorted((s for s in spans if s.parent == parent.id),
                                   key=lambda s: s.start)]


def test_carry_epoch_spans_and_counters():
    from portbench.harness import program

    s = tiny_carry.carry("dense")
    data = kdd_groups.make(s.cfg["conf"], s.traffic, SEED)
    conf = program.conf_keys(s.cfg, s.traffic, "cpu")
    from portbench.harness import leaves

    trainer = program.build_trainer(conf, leaves.write_checkpoint(
        s.cfg, leaves.initial(s.cfg, SEED, CPU)))
    trainer.init_trainer()
    ds = program.dataset(s.cfg, data["train"])
    rounds = 2
    spans, counters = _traced_rounds(trainer, ds, rounds)
    entry = trainer._plus_cache[id(ds)]
    T, GS = entry.stacked["label"].shape
    C = len(set(entry.chunk_id.tolist()))
    assert C > 1 and counters["steps"] == T * rounds and counters["chunks"] == C * rounds
    assert counters["overlap.dense"] == C and "overlap.factored" not in counters
    assert counters["overlap.ld"] > trainer.users_per_batch + 1
    assert counters["pool.live"] == len(data["train"]["fb_idx"])
    assert counters["slots"] == T * GS and counters["slots.live"] == len(data["train"]["labels"])
    assert not any(k.startswith("host_syncs") for k in counters)
    by_name = {}
    for sp in spans:
        by_name.setdefault(sp.name, []).append(sp)
    (pack,) = by_name["pack"]
    (ov,) = by_name["pack.overlap"]
    assert ov.parent == pack.id
    assert len(by_name["step"]) == T * rounds
    assert len(by_name["chunk.entry"]) == len(by_name["chunk.exit"]) == C * rounds
    for sp in by_name["step"]:
        assert _children(spans, sp) == list(CARRY_STEP)
    for sp in by_name["chunk.entry"]:
        assert _children(spans, sp) == list(CHUNK_ENTRY)
    for sp in by_name["chunk.exit"]:
        assert _children(spans, sp) == list(CHUNK_EXIT)


def test_tracing_changes_no_trained_bit_carry():
    s = tiny_carry.carry("sparse")
    got = []
    for traced in (False, True):
        if traced:
            tracing.enable()
        _, _, _, side = _readings(s)
        tracing.disable()
        got.append(side["final"])
        assert math.isfinite(float(side["probe"].sum()))
    assert got[0] == got[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: host syncs are counted on the card")


@pytest.mark.cuda
def test_host_syncs_in_a_carry_round(card):
    """A carry round on the card after its packing (which syncs: the
    overlap's sizes, the staging) and its first round: its chunk entries,
    steps and chunk exits make no host sync, and K5 launches once a step
    and twice a chunk exit.  That round is the round graph's capture (a
    sync would fail it) and its first replay."""
    from portbench.harness import leaves, program
    from svdfeature_tpu_torch.ops import cuda_scatter

    s = tiny_carry.carry("dense")
    dev = torch.device("cuda")
    data = kdd_groups.make(s.cfg["conf"], s.traffic, SEED)
    conf = program.conf_keys(s.cfg, s.traffic, "cuda")
    trainer = program.build_trainer(conf, leaves.write_checkpoint(
        s.cfg, leaves.initial(s.cfg, SEED, dev)))
    trainer.init_trainer()
    ds = program.dataset(s.cfg, data["train"])
    entry = trainer._pack_plus(ds)
    trainer._staged_lrs([trainer.learning_rate])
    trainer.update_all(ds)
    trainer.synchronize()
    T = entry.stacked["label"].shape[0]
    C = len(set(entry.chunk_id.tolist()))
    before = cuda_scatter.row_writer.launches
    spans, counters = _traced_rounds(trainer, ds, 1)
    assert counters["steps"] == T and counters["chunks"] == C
    assert cuda_scatter.row_writer.launches - before == T + 2 * C
    syncs = {k: v for k, v in counters.items() if k.startswith("host_syncs")}
    print("carry round:", syncs, tracing.sync_sites)
    assert syncs == {}, tracing.sync_sites
