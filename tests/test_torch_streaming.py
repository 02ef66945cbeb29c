"""Out-of-core training in the port (data/streaming.py, data/pages.py,
solvers/streamed.py and the trainers' stream hooks) against the JAX
package.

The non-mesh cases of tests/test_streaming.py and the page cases of
tests/test_pages_and_utils.py:15-45, at their tiny shapes: every buffer is
written from the same seeded text by each package's own writer, trained by
the JAX package's streamed trainer and by the port's (device=cpu), and the
final states agree within atol 1e-6 (the step counters exactly); where the
JAX tests pin it, the port's streamed run also equals its own staged run.
Big tables are forced with the thresholds at 4 rows (the port's
``BIG_TABLE_ROWS``, the JAX package's ``ONEHOT_THRESHOLD``).  On the CPU
the kernel wrappers take their plain versions; the ``cuda`` case streams
through K1 on the card.
"""

import dataclasses
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svdfeature_tpu_torch.data import buffer as tbuffer
from svdfeature_tpu_torch.data import csr as tcsr
from svdfeature_tpu_torch.data import registry as tregistry
from svdfeature_tpu_torch.data.buffer import write_csr_buffer, write_plus_buffer
from svdfeature_tpu_torch.data.csr import PlusDataset
from svdfeature_tpu_torch.data.streaming import StreamingCSRBuffer, StreamingPlusBuffer
from svdfeature_tpu_torch.data.text import load_feature_text, load_plus_text
from svdfeature_tpu_torch.ops import _plans
from svdfeature_tpu_torch.params import SVDTypeParam
from svdfeature_tpu_torch.solvers import base as tbase
from svdfeature_tpu_torch.solvers.base import SVDFeatureTrainer
from svdfeature_tpu_torch.solvers.bilinear import SVDBiLinearTrainer
from svdfeature_tpu_torch.solvers.multi_imfb import SVDPPMultiIMFBTrainer
from svdfeature_tpu_torch.solvers.svdpp import SVDPPFeatureTrainer

ATOL = 1e-6
BASE = dict(num_user=40, num_item=60, num_factor=8, base_score=3, learning_rate=0.01,
            wd_user=0.004, wd_item=0.004, batch_size=64)
PLUS = dict(num_user=12, num_item=12, num_ufeedback=15, num_factor=8, base_score=3,
            learning_rate=0.01, wd_user=0.004, wd_item=0.004, wd_ufeedback=0.004,
            users_per_batch=2)
BILINEAR = dict(num_user=12, num_item=30, num_factor=8, base_score=3, learning_rate=0.01,
                wd_user=0.004, wd_item=0.004, num_ufeedback=30, wd_ufeedback=0.004,
                users_per_batch=4, num_bi_feedback=10, wd_bi_feedback=0.01, start_ufeedback=2)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of every comparison, imported here and not at
    the top (the file's ``cuda`` case runs where JAX is not installed)."""
    pytest.importorskip("jax")
    from svdfeature_tpu.data import buffer, csr, pages, registry, streaming, text
    from svdfeature_tpu.ops import embed
    from svdfeature_tpu.params import SVDTypeParam as JType
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer as JBase
    from svdfeature_tpu.solvers.bilinear import SVDBiLinearTrainer as JBi
    from svdfeature_tpu.solvers.multi_imfb import SVDPPMultiIMFBTrainer as JImfb
    from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer as JPlus

    return SimpleNamespace(buffer=buffer, csr=csr, pages=pages, registry=registry,
                           streaming=streaming, text=text, embed=embed, Type=JType,
                           trainers={SVDFeatureTrainer: JBase, SVDPPFeatureTrainer: JPlus,
                                     SVDPPMultiIMFBTrainer: JImfb, SVDBiLinearTrainer: JBi})


# ---- data: the texts of tests/test_streaming.py, parsed by each package ------
def csr_text(rows=700, nu=40, ni=60, seed=0):
    rng = np.random.RandomState(seed)
    return "\n".join(f"{rng.randint(1, 6)} 0 1 1 {rng.randint(0, nu)}:1 {rng.randint(0, ni)}:1"
                     for _ in range(rows))


def plus_text(users=12, seed=3):
    rng = np.random.RandomState(seed)
    data, fbs = [], []
    for u in range(users):
        nrows = int(rng.randint(2, 7))
        nfb = int(rng.randint(1, 5))
        fbs.append(f"{nrows} {nfb} "
                   + " ".join(f"{rng.randint(0, 15)}:{rng.rand():.3f}" for _ in range(nfb)))
        data += [f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 12)}:1" for _ in range(nrows)]
    return "\n".join(data), "\n".join(fbs)


def csr_ds(pkg_text, **kw):
    return pkg_text.load_feature_text("x", text=csr_text(**kw))


def plus_ds(pkg_text, block_max_line=10000, **kw):
    data, fbs = plus_text(**kw)
    return pkg_text.load_plus_text("x", "y", text=data, feedback_text=fbs,
                                   block_max_line=block_max_line)


def stacked_ds(pkg_text, csr):
    """make_stacked_ds of tests/test_streaming.py: two START..MIDDLE..END
    scopes that streamed chunks of 4 units cut mid-scope."""
    pds = plus_ds(pkg_text)
    tags = [csr.TAG_START, csr.TAG_DEFAULT, csr.TAG_DEFAULT, csr.TAG_MIDDLE,
            csr.TAG_END, csr.TAG_DEFAULT, csr.TAG_START, csr.TAG_DEFAULT,
            csr.TAG_MIDDLE, csr.TAG_END, csr.TAG_DEFAULT, csr.TAG_DEFAULT]
    blocks = [type(b)(b.fb_index, b.fb_value, b.data, extend_tag=t)
              for b, t in zip(pds.blocks(), tags)]
    return type(pds).from_blocks(blocks)


PORT = SimpleNamespace(load_feature_text=load_feature_text, load_plus_text=load_plus_text)


# ---- trainers ------------------------------------------------------------------
def port_trainer(cls, params, extra=None, **mtype):
    tr = cls(SVDTypeParam(**mtype))
    for k, v in dict(params, **(extra or {}), device="cpu").items():
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    return tr


def jax_trainer(jx, cls, params, extra=None, **mtype):
    tr = jx.trainers[cls](jx.Type(**mtype))
    for k, v in dict(params, **(extra or {})).items():
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    return tr


PLUS_TYPE = dict(format_type=1)
IMFB_TYPE = dict(format_type=1, extend_type=2)
BI_TYPE = dict(format_type=1, extend_type=15)


def host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def tables(tr):
    """(w, b, g) of a trainer of either package in the standard layout."""
    tr._sync_model_from_state()
    return [host(getattr(tr.model, name)) for name in ("w", "b", "g")]


def assert_same(a, b, atol=ATOL):
    for name, x, y in zip(("w", "b", "g"), tables(a), tables(b)):
        np.testing.assert_allclose(x, y, atol=atol, err_msg=name)
    assert int(a.state.step) == int(b.state.step)


def force_big(monkeypatch, jx):
    monkeypatch.setattr(jx.embed, "ONEHOT_THRESHOLD", 4)
    monkeypatch.setattr(tbase, "BIG_TABLE_ROWS", 4)


def csr_sources(jx, tmp_path, chunk, rows=700, file_batch=64):
    """(jax source, port source, port dataset) of one random-order buffer
    written by each package."""
    jp, tp = tmp_path / "jax.buffer", tmp_path / "port.buffer"
    jx.buffer.write_csr_buffer(str(jp), csr_ds(jx.text, rows=rows), batch_size=file_batch)
    tds = csr_ds(PORT, rows=rows)
    write_csr_buffer(str(tp), tds, batch_size=file_batch)
    return (jx.streaming.StreamingCSRBuffer(str(jp), examples_per_chunk=chunk),
            StreamingCSRBuffer(str(tp), examples_per_chunk=chunk), tds)


def plus_sources(jx, tmp_path, blocks, make=plus_ds, **kw):
    """(jax source, port source, port dataset) of one user-group buffer."""
    jp, tp = tmp_path / "jax.pbuffer", tmp_path / "port.pbuffer"
    jx.buffer.write_plus_buffer(str(jp), make(jx.text, **kw) if make is plus_ds
                                else make(jx.text, jx.csr))
    tds = make(PORT, **kw) if make is plus_ds else make(PORT, tcsr)
    write_plus_buffer(str(tp), tds)
    return (jx.streaming.StreamingPlusBuffer(str(jp), blocks_per_chunk=blocks),
            StreamingPlusBuffer(str(tp), blocks_per_chunk=blocks), tds)


# ---- the pre-scans and the registry ---------------------------------------------
def test_prescan_structure(jx, tmp_path):
    """JAX :40: the pre-scan's counts and the chunks, equal to the JAX
    package's byte for byte."""
    jsrc, tsrc, tds = csr_sources(jx, tmp_path, 256, file_batch=100)
    assert tsrc.num_row == tds.num_row == jsrc.num_row
    assert tsrc.max_nnz == jsrc.max_nnz == [1, 1, 1]
    tchunks, jchunks = list(tsrc.chunks()), list(jsrc.chunks())
    assert sum(c.num_row for c in tchunks) == tds.num_row
    assert len(tchunks) == len(jchunks) == 3
    for a, b in zip(tchunks, jchunks):
        for f in ("labels", "row_ptr", "index", "value"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f


def test_plus_prescan_and_chunks(jx, tmp_path):
    """JAX :142: split START/MIDDLE/END families never straddle a chunk,
    and the caps plans equal the JAX package's."""
    from svdfeature_tpu_torch.data.batching_plus import merge_split_blocks

    jsrc, tsrc, tds = plus_sources(jx, tmp_path, 4, block_max_line=3)
    assert tsrc.num_block == 12 and tsrc.num_row == tds.rows.num_row
    blocks = rows = 0
    for chunk in tsrc.chunks():
        n = len(merge_split_blocks(chunk))
        assert n <= 4
        blocks += n
        rows += chunk.rows.num_row
    assert (blocks, rows) == (12, tds.rows.num_row)
    for G, M, srt in ((2, 1, False), (2, 2, True), (4, 1, True)):
        assert tsrc.plan_caps(G, M, sort_local=srt) == jsrc.plan_caps(G, M, sort_local=srt)
        assert tsrc.plan_caps_imfb(G, M, srt) == jsrc.plan_caps_imfb(G, M, srt)


def test_streaming_registry_route(tmp_path):
    """JAX :74: streaming=1 on input_type=0 gives a StreamingCSRBuffer,
    auto-creating the buffer from data_in text."""
    (tmp_path / "data.txt").write_text(csr_text(rows=130))
    cfg = tregistry.IteratorConfig()
    for k, v in (("streaming", "1"), ("stream_chunk", "50"), ("data_in", str(tmp_path / "data.txt")),
                 ("buffer_feature", str(tmp_path / "auto.buffer")), ("silent", "1")):
        cfg.set_param(k, v)
    src = tregistry.load_csr_source(0, cfg)
    assert isinstance(src, StreamingCSRBuffer) and src.examples_per_chunk == 50
    assert src.num_row == 130 and sum(c.num_row for c in src.chunks()) == 130
    again = tregistry.load_csr_source(0, cfg)  # now from the file it wrote
    assert isinstance(again, StreamingCSRBuffer) and again.num_row == 130


def test_plus_streaming_registry_route(tmp_path):
    """JAX :194: streaming=1 on the user-group buffer; an unset
    stream_chunk takes the block-count default 1 << 16."""
    path = tmp_path / "p.buffer"
    write_plus_buffer(str(path), plus_ds(PORT))
    for chunk, want in (("4", 4), (None, 1 << 16)):
        cfg = tregistry.IteratorConfig()
        cfg.set_param("streaming", "1")
        cfg.set_param("buffer_feature", str(path))
        if chunk:
            cfg.set_param("stream_chunk", chunk)
        src = tregistry.load_plus_source(0, cfg)
        assert isinstance(src, StreamingPlusBuffer)
        assert (src.num_block, src.blocks_per_chunk) == (12, want)


@pytest.mark.parametrize("dtype", [200, 2])
def test_streaming_ignored_for_composite_plus_types(tmp_path, dtype):
    """JAX :247: the filter combinator and the pair sampler load their
    inner source whole even with streaming=1."""
    path = tmp_path / "p.buffer"
    write_plus_buffer(str(path), plus_ds(PORT))
    cfg = tregistry.IteratorConfig()
    for k, v in (("streaming", "1"), ("buffer_feature", str(path)), ("filter_ufeedback", "0-5")):
        cfg.set_param(k, v)
    src = tregistry.load_plus_source(dtype, cfg)
    assert isinstance(src, PlusDataset) if dtype == 200 else hasattr(src, "epoch_dataset")
    assert not hasattr(src, "plan_caps")


def test_streaming_and_pages_in_copies():
    import test_torch_data

    assert {"data/streaming.py", "data/pages.py"} <= set(test_torch_data.COPIES)


# ---- random-order streams -------------------------------------------------------
@pytest.mark.parametrize("table", ["small", "sweep", "dedup"])
def test_streamed_matches_jax_and_staged(jx, tmp_path, monkeypatch, table):
    """JAX :51: 3 streamed rounds (chunks of 256 examples, 4 batches of 64)
    equal the staged run and the JAX package's streamed run; on a big
    table (forced) through the tile sweep or the sorted dedup, the chunks
    carry their sweep plans as the staged pack does."""
    extra = {}
    if table != "small":
        force_big(monkeypatch, jx)
        extra = {"big_sweep": int(table == "sweep")}
    jsrc, tsrc, tds = csr_sources(jx, tmp_path, 256)
    staged = port_trainer(SVDFeatureTrainer, BASE, extra)
    streamed = port_trainer(SVDFeatureTrainer, BASE, extra)
    jtr = jax_trainer(jx, SVDFeatureTrainer, BASE, extra)
    assert streamed.hp.big_table == (table != "small")
    assert streamed.hp.sweep_table == (table == "sweep") == jtr.hp.sweep_table
    for _ in range(3):
        staged.update_all(tds)
        streamed.update_all(tsrc)
        jtr.update_all(jsrc)
    assert streamed.chunk_stream.stats.chunks == 3
    assert_same(streamed, staged)
    assert_same(streamed, jtr)
    if table == "sweep":
        arrays, _ = streamed.pack_chunk(next(tsrc.chunks()), 4, tsrc.max_nnz)
        assert {"sw_tids", "sw_lids", "sw_runs", "sw_pieces"} <= set(arrays)


def test_update_rounds_streaming_csr(jx, tmp_path):
    """JAX :429: update_rounds on a stream is a streamed round at a time
    under the staged run's lr schedule."""
    jsrc, tsrc, tds = csr_sources(jx, tmp_path, 128, rows=256)
    decay = dict(decay_learning_rate=1, decay_rate=0.9)
    staged = port_trainer(SVDFeatureTrainer, BASE, decay)
    streamed = port_trainer(SVDFeatureTrainer, BASE, decay)
    jtr = jax_trainer(jx, SVDFeatureTrainer, BASE, decay)
    staged.update_rounds(tds, 3)
    streamed.update_rounds(tsrc, 3)
    jtr.update_rounds(jsrc, 3)
    assert_same(streamed, staged)
    assert_same(streamed, jtr)
    assert abs(streamed.learning_rate - staged.learning_rate) < 1e-12
    assert abs(streamed.learning_rate - jtr.learning_rate) < 1e-12


def test_stream_chunk_rounds_to_batch_multiple(jx, tmp_path):
    """JAX :637: a chunk of 250 examples is rounded to 192 with the JAX
    package's warning, and the run still equals the staged one."""
    jsrc, tsrc, tds = csr_sources(jx, tmp_path, 250)
    staged = port_trainer(SVDFeatureTrainer, BASE)
    streamed = port_trainer(SVDFeatureTrainer, BASE)
    jtr = jax_trainer(jx, SVDFeatureTrainer, BASE)
    with pytest.warns(UserWarning, match="rounding to 192"):
        for _ in range(3):
            staged.update_all(tds)
            streamed.update_all(tsrc)
            jtr.update_all(jsrc)
    assert tsrc.examples_per_chunk == jsrc.examples_per_chunk == 192
    assert_same(streamed, staged)
    assert_same(streamed, jtr)


def test_streamed_hierarchy_matches_staged(jx, tmp_path):
    """JAX test_streamed_hierarchy_matches_staged: with feature_user side
    features the pre-scan caps widen by the expansion factor; the run and
    the streamed predictions equal the staged ones and the JAX package's."""
    jsrc, tsrc, tds = csr_sources(jx, tmp_path, 128, rows=300)
    fu = tmp_path / "fu.txt"
    fu.write_text("2 3:0.5 5:0.25\n1 4:2.0\n" + "0\n" * 38)
    extra = {"feature_user": str(fu)}
    staged = port_trainer(SVDFeatureTrainer, BASE, extra)
    streamed = port_trainer(SVDFeatureTrainer, BASE, extra)
    jtr = jax_trainer(jx, SVDFeatureTrainer, BASE, extra)
    for _ in range(3):
        staged.update_all(tds)
        streamed.update_all(tsrc)
        jtr.update_all(jsrc)
    assert_same(streamed, staged)
    assert_same(streamed, jtr)
    np.testing.assert_allclose(streamed.predict_all(tsrc), staged.predict_all(tds), atol=ATOL)
    np.testing.assert_allclose(streamed.predict_all(tsrc), np.asarray(jtr.predict_all(jsrc)),
                               atol=ATOL)


# ---- user-group streams --------------------------------------------------------------
@pytest.mark.parametrize("split", [False, True])
def test_plus_streamed_matches_jax_and_staged(jx, tmp_path, split):
    """JAX :168: chunks of 4 logical blocks (2 batches of 2 users), with
    and without split families in the file, equal the staged run and the
    JAX package's streamed run; every chunk goes through the trainer's
    route (K2's plain version)."""
    jsrc, tsrc, tds = plus_sources(jx, tmp_path, 4, block_max_line=3 if split else 10000)
    staged = port_trainer(SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    streamed = port_trainer(SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    jtr = jax_trainer(jx, SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    for _ in range(3):
        staged.update_all(tds)
        streamed.update_all(tsrc)
        jtr.update_all(jsrc)
    assert streamed.chunk_stream.stats.chunks == 3
    assert_same(streamed, staged)
    assert_same(streamed, jtr)


def test_plus_streamed_big_table(jx, tmp_path, monkeypatch):
    """JAX :211: a forced big table streams through the big epoch (the
    user-carry body: every chunk carries its carry plan, padded to the
    pool's chunk rows) and equals the staged run and the JAX package's."""
    force_big(monkeypatch, jx)
    jsrc, tsrc, tds = plus_sources(jx, tmp_path, 4, block_max_line=3)
    staged = port_trainer(SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    streamed = port_trainer(SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    jtr = jax_trainer(jx, SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    assert streamed.hp.big_table and jtr.hp.big_table
    for _ in range(2):
        staged.update_all(tds)
        streamed.update_all(tsrc)
        jtr.update_all(jsrc)
    assert "chunk_users" in staged._pack_plus(tds).fb
    entry = streamed.pack_plus_chunk(next(tsrc.chunks()), tsrc.plan_caps(2, 1))
    assert entry.fb["chunk_users"].shape[0] == entry.fb["fb_idx"].shape[0]
    assert "i_order" in entry.stacked
    assert_same(streamed, staged)
    assert_same(streamed, jtr)
    np.testing.assert_allclose(streamed.predict_all(tsrc), np.asarray(jtr.predict_all(jsrc)),
                               atol=ATOL)


def test_plus_streamed_shared_space(jx, tmp_path):
    """Under common_feedback_space=1 the streamed chunks take the per-batch
    refresh epoch, as staged data does, equal to the JAX package's."""
    extra = {"common_feedback_space": 1}
    jsrc, tsrc, tds = plus_sources(jx, tmp_path, 4)
    staged = port_trainer(SVDPPFeatureTrainer, PLUS, extra, **PLUS_TYPE)
    streamed = port_trainer(SVDPPFeatureTrainer, PLUS, extra, **PLUS_TYPE)
    jtr = jax_trainer(jx, SVDPPFeatureTrainer, PLUS, extra, **PLUS_TYPE)
    for _ in range(2):
        staged.update_all(tds)
        streamed.update_all(tsrc)
        jtr.update_all(jsrc)
    assert_same(streamed, staged)
    assert_same(streamed, jtr)


def _reorder_chunklocal(pds, span):
    """The staged equivalent of chunk-local sorting (JAX :262)."""
    from svdfeature_tpu_torch.data.batching_plus import merge_split_blocks

    blocks = merge_split_blocks(pds)
    out = []
    for lo in range(0, len(blocks), span):
        window = blocks[lo: lo + span]
        sizes = np.array([b.data.num_row for b in window])
        out.extend(window[int(i)] for i in np.argsort(-sizes, kind="stable"))
    return PlusDataset.from_blocks(out)


def test_sorted_streamed_plus_matches_staged_chunklocal(jx, tmp_path):
    """JAX :280: sort_blocks under streaming sorts within each chunk; the
    run equals a staged run on the chunk-locally reordered data and the
    JAX package's sorted stream."""
    jsrc, tsrc, tds = plus_sources(jx, tmp_path, 4)
    staged = port_trainer(SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    streamed = port_trainer(SVDPPFeatureTrainer, PLUS, {"sort_blocks": 1}, **PLUS_TYPE)
    jtr = jax_trainer(jx, SVDPPFeatureTrainer, PLUS, {"sort_blocks": 1}, **PLUS_TYPE)
    ref = _reorder_chunklocal(tds, 4)
    for _ in range(3):
        staged.update_all(ref)
        streamed.update_all(tsrc)
        jtr.update_all(jsrc)
    assert_same(streamed, staged)
    assert_same(streamed, jtr)


def test_sorted_plan_caps_mirror_and_shrink(jx, tmp_path):
    """JAX :305: the sorted caps plan shrinks the scan on skewed blocks,
    fits every sorted chunk pack, and the round equals the JAX package's."""
    rng = np.random.RandomState(5)
    texts = []
    for u, n in enumerate([1, 16] * 8):
        texts.append(("\n".join(f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 12)}:1"
                                for _ in range(n)), u % 15))

    def skew(pkg_text, csr):
        return csr.PlusDataset.from_blocks([
            csr.PlusBlock(np.array([fid], np.uint32), np.ones(1, np.float32),
                          pkg_text.load_feature_text("x", text=lines)) for lines, fid in texts])

    jsrc, tsrc, _ = plus_sources(jx, tmp_path, 8, make=skew)
    plain, srt = tsrc.plan_caps(G=2, M=1), tsrc.plan_caps(G=2, M=1, sort_local=True)
    assert srt["t_cap"] < plain["t_cap"]
    params = dict(PLUS, num_user=16, sort_blocks=1)
    tr = port_trainer(SVDPPFeatureTrainer, params, **PLUS_TYPE)
    jtr = jax_trainer(jx, SVDPPFeatureTrainer, params, **PLUS_TYPE)
    tr.update_all(tsrc)
    jtr.update_all(jsrc)
    assert int(tr.state.step) > 0
    assert_same(tr, jtr)


def test_plus_stream_rounds_blocks_per_chunk(jx, tmp_path):
    """The user-group form of JAX :637: 5 blocks a chunk is rounded to 4
    (2 users a batch) with the JAX package's warning."""
    jsrc, tsrc, tds = plus_sources(jx, tmp_path, 5)
    streamed = port_trainer(SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    staged = port_trainer(SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    jtr = jax_trainer(jx, SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    with pytest.warns(UserWarning, match="rounding to 4"):
        streamed.update_all(tsrc)
        jtr.update_all(jsrc)
    staged.update_all(tds)
    assert tsrc.blocks_per_chunk == jsrc.blocks_per_chunk == 4
    assert_same(streamed, staged)
    assert_same(streamed, jtr)


def test_plan_caps_rekeyed_on_blocks_per_chunk(jx, tmp_path):
    """JAX :873: the caps are planned again when blocks_per_chunk changes,
    equal to a fresh source's and to the JAX package's."""
    jsrc, tsrc, _ = plus_sources(jx, tmp_path, 5)
    caps5 = dict(tsrc.plan_caps(2, 1))
    tsrc.blocks_per_chunk = jsrc.blocks_per_chunk = 4
    caps4, imfb4 = dict(tsrc.plan_caps(2, 1)), dict(tsrc.plan_caps_imfb(2, 1))
    fresh = StreamingPlusBuffer(tsrc.path, blocks_per_chunk=4)
    assert caps4 == fresh.plan_caps(2, 1) == jsrc.plan_caps(2, 1)
    assert imfb4 == fresh.plan_caps_imfb(2, 1) == jsrc.plan_caps_imfb(2, 1)
    assert caps4 != caps5 or caps4["c_cap"] == caps5["c_cap"]
    assert fresh.plan_caps_imfb(2, 2)["t_cap"] <= imfb4["t_cap"]


def test_streamed_predict_matches_staged(jx, tmp_path):
    """JAX :399: bounded-memory predictions over both formats equal the
    staged predictions and the JAX package's streamed ones."""
    jsrc, tsrc, tds = csr_sources(jx, tmp_path, 128, rows=300)
    tr = port_trainer(SVDFeatureTrainer, BASE)
    jtr = jax_trainer(jx, SVDFeatureTrainer, BASE)
    tr.update_all(tds)
    jtr.update_all(jx.text.load_feature_text("x", text=csr_text(rows=300)))
    got = tr.predict_all(tsrc)
    np.testing.assert_allclose(got, tr.predict_all(tds), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jtr.predict_all(jsrc)), atol=ATOL)

    jpsrc, tpsrc, tpds = plus_sources(jx, tmp_path, 4)
    ptr = port_trainer(SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    jptr = jax_trainer(jx, SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    ptr.update_all(tpds)
    jptr.update_all(plus_ds(jx.text))
    got = ptr.predict_all(tpsrc)
    np.testing.assert_allclose(got, ptr.predict_all(tpds), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jptr.predict_all(jpsrc)), atol=ATOL)


# ---- stacked and bilinear streams -------------------------------------------------
@pytest.mark.parametrize("case", ["file_order", "disable_level", "rows_per_user2"])
def test_imfb_stacked_streamed_matches_staged(jx, tmp_path, case):
    """JAX :755 / :786: stacked data streams in chunks of 4 units whose
    boundaries cut both scopes (the open contexts carry into the next
    chunk's pack); the run equals the staged run and the JAX package's
    stream, with ufeedback_disable_level applied per chunk from the
    carried depths, and so do the streamed predictions."""
    extra = {"file_order": {}, "disable_level": {"ufeedback_disable_level": 1},
             "rows_per_user2": {"rows_per_user": 2}}[case]
    jsrc, tsrc, tds = plus_sources(jx, tmp_path, 4, make=stacked_ds)
    staged = port_trainer(SVDPPMultiIMFBTrainer, PLUS, extra, **IMFB_TYPE)
    streamed = port_trainer(SVDPPMultiIMFBTrainer, PLUS, extra, **IMFB_TYPE)
    jtr = jax_trainer(jx, SVDPPMultiIMFBTrainer, PLUS, extra, **IMFB_TYPE)
    assert not streamed._plain_svdpp(tsrc)
    for _ in range(3):
        staged.update_all(tds)
        streamed.update_all(tsrc)
        jtr.update_all(jsrc)
    assert streamed.chunk_stream.stats.chunks == 3
    assert_same(streamed, staged)
    assert_same(streamed, jtr)
    got = streamed.predict_all(tsrc)
    np.testing.assert_allclose(got, staged.predict_all(tds), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jtr.predict_all(jsrc)), atol=ATOL)


@pytest.mark.parametrize("blocks", [64, 4])
def test_stacked_sorted_streamed(jx, tmp_path, blocks):
    """JAX :346 / :372: sort_blocks on a stacked stream sorts the units of
    each chunk; with one chunk the run equals the staged sorted run, with
    chunks of 4 units it stays in its caps (sorted t_cap no larger than
    file order's) and equals the JAX package's stream.  Its streamed
    predictions equal its staged ones: the port plans the predict's caps
    for the sorted chunks, where the JAX package plans them for file order
    and its pack of the sorted chunk overflows them."""
    jsrc, tsrc, tds = plus_sources(jx, tmp_path, blocks, make=stacked_ds)
    assert tsrc.plan_caps_imfb(2, 1, sort_local=True)["t_cap"] <= tsrc.plan_caps_imfb(2, 1)["t_cap"]
    sort = {"sort_blocks": 1}
    streamed = port_trainer(SVDPPMultiIMFBTrainer, PLUS, sort, **IMFB_TYPE)
    jtr = jax_trainer(jx, SVDPPMultiIMFBTrainer, PLUS, sort, **IMFB_TYPE)
    staged = port_trainer(SVDPPMultiIMFBTrainer, PLUS, sort, **IMFB_TYPE)
    for _ in range(3):
        streamed.update_all(tsrc)
        jtr.update_all(jsrc)
        staged.update_all(tds)
    assert_same(streamed, jtr)
    if blocks == 64:
        assert_same(streamed, staged)
    np.testing.assert_allclose(streamed.predict_all(tsrc), streamed.predict_all(tds), atol=1e-5)
    with pytest.raises(ValueError, match="exceeds"):
        jtr.predict_all(jsrc)


def test_all_default_stream_takes_svdpp(jx, tmp_path):
    """An all-DEFAULT stream under extend_type=2 takes the SVD++ streaming
    path (JAX multi_imfb.py:102), equal to the port's SVD++ trainer."""
    jsrc, tsrc, tds = plus_sources(jx, tmp_path, 4)
    streamed = port_trainer(SVDPPMultiIMFBTrainer, PLUS, **IMFB_TYPE)
    plus = port_trainer(SVDPPFeatureTrainer, PLUS, **PLUS_TYPE)
    jtr = jax_trainer(jx, SVDPPMultiIMFBTrainer, PLUS, **IMFB_TYPE)
    assert streamed._plain_svdpp(tsrc)
    for _ in range(2):
        streamed.update_all(tsrc)
        plus.update_all(tsrc)
        jtr.update_all(jsrc)
    assert_same(streamed, plus)
    assert_same(streamed, jtr)
    np.testing.assert_allclose(streamed.predict_all(tsrc), plus.predict_all(tds), atol=ATOL)


@pytest.mark.parametrize("table", ["small", "big"])
def test_bilinear_streamed_matches_staged(jx, tmp_path, monkeypatch, table):
    """JAX :658: the bilinear solver streams with its extras packed per
    chunk (the filtered pool, the property matrix, the filtered overlap)
    and equals the staged run and the JAX package's stream; on a forced
    big table through the big bilinear epoch (W_bi through K5's plain
    version here)."""
    if table == "big":
        force_big(monkeypatch, jx)
    jsrc, tsrc, tds = plus_sources(jx, tmp_path, 4)
    staged = port_trainer(SVDBiLinearTrainer, BILINEAR, **BI_TYPE)
    streamed = port_trainer(SVDBiLinearTrainer, BILINEAR, **BI_TYPE)
    jtr = jax_trainer(jx, SVDBiLinearTrainer, BILINEAR, **BI_TYPE)
    assert streamed.hp.big_table == (table == "big")
    for _ in range(3):
        staged.update_all(tds)
        streamed.update_all(tsrc)
        jtr.update_all(jsrc)
    assert_same(streamed, staged)
    assert_same(streamed, jtr)
    np.testing.assert_allclose(streamed.W_bi[:-1].numpy(), staged.W_bi[:-1].numpy(), atol=ATOL)
    np.testing.assert_allclose(streamed.W_bi[:-1].numpy(), np.asarray(jtr.W_bi), atol=ATOL)
    got = streamed.predict_all(tsrc)
    np.testing.assert_allclose(got, staged.predict_all(tds), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jtr.predict_all(jsrc)), atol=ATOL)


# ---- the chunks' kernel plans ---------------------------------------------------------
def test_streamed_round_keeps_no_chunk_in_plans(tmp_path, monkeypatch):
    """After a streamed round no wrapper's plan list holds a chunk tensor:
    a stand-in for K1's wrapper keeps a plan of every chunk it is given
    (as the card's wrapper does) and train_chunk drops it."""
    fake = _plans.plan_list()
    seen = []
    real = tbase.train_rounds_kernel

    def keeping(state, stacked, lrs, consts, hp):
        tensors = [stacked[name] for name in ("label", "weight", "u_idx")]
        seen.extend(weakref.ref(t) for t in tensors)
        _plans.keep_plan(fake, tensors, (), (), None, torch.zeros((), dtype=torch.int32))
        return real(state, stacked, lrs, consts, hp)

    monkeypatch.setattr(tbase, "train_rounds_kernel", keeping)
    tds = csr_ds(PORT)
    write_csr_buffer(str(tmp_path / "b.buffer"), tds, batch_size=64)
    src = StreamingCSRBuffer(str(tmp_path / "b.buffer"), examples_per_chunk=256)
    tr = port_trainer(SVDFeatureTrainer, BASE)
    try:
        for _ in range(2):
            tr.update_all(src)
            assert seen and not fake
            held = {id(t) for plans in _plans._LISTS for plan in plans for t in plan.tensors}
            assert not any(ref() is not None and id(ref()) in held for ref in seen)
        tr.update_all(tds)  # a staged dataset's plan stays, as before
        assert len(fake) == 1
    finally:
        fake.clear()
        _plans._LISTS.remove(fake)


def test_stage_moves_every_tensor_of_an_entry():
    """stage_chunk hands back the entry with every tensor of its dicts and
    dataclasses (numpy arrays left as they are), and the chunk's bytes."""
    from svdfeature_tpu_torch.solvers.streamed import ChunkStream
    from svdfeature_tpu_torch.solvers.svdpp import PlusEntry

    entry = PlusEntry(stacked={"label": torch.ones(2, 3)}, chunk_id=np.zeros(2, np.int32),
                      fb={"fb_idx": torch.zeros(1, 4, dtype=torch.int32)},
                      fb_overlap={"diag": torch.ones(1, 2)}, perm=np.arange(6))
    cs = ChunkStream()
    cs.begin_round(torch.device("cpu"))
    staged = cs.stage(entry, torch.device("cpu"))
    assert len(staged.tensors) == 3 and staged.nbytes == 24 + 16 + 8
    assert staged.entry.chunk_id is entry.chunk_id
    with cs.training(staged) as got:
        assert dataclasses.is_dataclass(got) and got.stacked["label"] is entry.stacked["label"]
    assert cs.stats.chunks == 1 and cs.stats.max_chunk_bytes == 48


# ---- pages (tests/test_pages_and_utils.py:15-45) -----------------------------------------
def test_page_roundtrip_matches_jax(jx, tmp_path):
    """The port's page writer gives the JAX package's bytes, and reading
    them back gives the dataset (pages.py is a copy)."""
    from svdfeature_tpu_torch.data.pages import PSIZE, read_page_file, write_page_file

    rng = np.random.RandomState(0)
    text = "\n".join(f"{rng.randint(1, 6)} 1 2 1 {rng.randint(0, 5)}:0.5 {rng.randint(0, 50)}:1 "
                     f"{rng.randint(0, 50)}:2 {rng.randint(0, 99)}:1" for _ in range(500))
    ds = load_feature_text("x", text=text)
    write_page_file(str(tmp_path / "t.pages"), ds)
    jx.pages.write_page_file(str(tmp_path / "j.pages"), jx.text.load_feature_text("x", text=text))
    assert (tmp_path / "t.pages").read_bytes() == (tmp_path / "j.pages").read_bytes()
    assert (tmp_path / "t.pages").stat().st_size % (PSIZE * 4) == 0
    rd = read_page_file(str(tmp_path / "t.pages"))
    for f in ("labels", "row_ptr", "index", "value"):
        np.testing.assert_array_equal(getattr(rd, f), getattr(ds, f))


def test_page_multi_page_split(tmp_path):
    from svdfeature_tpu_torch.data.pages import PSIZE, read_page_file, write_page_file

    n = PSIZE // 8 + 20000
    ds = load_feature_text("x", text="\n".join(f"1 0 1 1 {i % 7}:1 {i % 11}:1" for i in range(n)))
    write_page_file(str(tmp_path / "t.pages"), ds)
    assert (tmp_path / "t.pages").stat().st_size > PSIZE * 4
    rd = read_page_file(str(tmp_path / "t.pages"))
    assert rd.num_row == ds.num_row
    np.testing.assert_array_equal(rd.index, ds.index)


def test_pages_train_as_the_buffer(jx, tmp_path):
    """input_type=5 through the port's registry loads the pages whole, and
    a round on them equals a round on the same rows from a buffer and the
    JAX package's round on its registry's pages."""
    from svdfeature_tpu_torch.data.pages import write_page_file

    tds = csr_ds(PORT, rows=300)
    write_page_file(str(tmp_path / "t.pages"), tds)
    cfg = tregistry.IteratorConfig()
    cfg.set_param("buffer_feature", str(tmp_path / "t.pages"))
    pages = tregistry.load_csr_source(5, cfg)
    jcfg = jx.registry.IteratorConfig()
    jcfg.set_param("buffer_feature", str(tmp_path / "t.pages"))
    jpages = jx.registry.load_csr_source(5, jcfg)
    a, b = port_trainer(SVDFeatureTrainer, BASE), port_trainer(SVDFeatureTrainer, BASE)
    jtr = jax_trainer(jx, SVDFeatureTrainer, BASE)
    a.update_all(pages)
    b.update_all(tds)
    jtr.update_all(jpages)
    assert_same(a, b, atol=0)
    assert_same(a, jtr)


# ---- the slice: conf -> SVDTrainTask -> %04d.model -> SVDInferTask ------------------------
@pytest.mark.parametrize("fmt", ["csr", "plus"])
def test_streamed_slice_matches_jax(jx, tmp_path, fmt):
    """streaming=1 through both packages' tasks: train 3 rounds from a
    streamed buffer, save a checkpoint a round, evaluate every checkpoint
    on the streamed test buffer (test:streaming=1); the port's
    checkpoints and test RMSEs equal the JAX package's (1e-6)."""
    from svdfeature_tpu.infer.task import SVDInferTask as JInfer
    from svdfeature_tpu.train.loop import SVDTrainTask as JTrain
    from svdfeature_tpu_torch.infer.task import SVDInferTask
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    if fmt == "csr":
        params, chunk, keys = BASE, 128, "batch_size = 64\n"
        writes = lambda pkg, buf, p, t: (  # noqa: E731
            buf.write_csr_buffer(str(p), csr_ds(pkg, rows=300), batch_size=64),
            buf.write_csr_buffer(str(t), csr_ds(pkg, rows=128, seed=1), batch_size=64))
    else:
        params, chunk, keys = PLUS, 4, "format_type = 1\nusers_per_batch = 2\n"
        writes = lambda pkg, buf, p, t: (  # noqa: E731
            buf.write_plus_buffer(str(p), plus_ds(pkg)),
            buf.write_plus_buffer(str(t), plus_ds(pkg, seed=4)))
    out = {}
    for tag, pkg, buf, train, infer, dev in (
            ("jax", jx.text, jx.buffer, JTrain, JInfer, []),
            ("port", PORT, tbuffer, SVDTrainTask, SVDInferTask, ["device=cpu"])):
        d = tmp_path / tag
        d.mkdir()
        writes(pkg, buf, d / "train.buffer", d / "test.buffer")
        conf = d / "s.conf"
        conf.write_text(
            "".join(f"{k} = {v}\n" for k, v in params.items() if k not in ("batch_size",
                                                                          "users_per_batch"))
            + keys + f'buffer_feature = "{d}/train.buffer"\n'
            f'test:buffer_feature = "{d}/test.buffer"\nstreaming = 1\nstream_chunk = {chunk}\n'
            f"test:streaming = 1\ntest:stream_chunk = {chunk}\n"
            f'model_out_folder = "{d}/models"\nsilent = 1\n')
        task = train()
        task.run(str(conf), ["num_round=3", *dev])
        assert hasattr(task.dataset, "chunks")
        infer().run(str(conf), ["start=0", "end=4", f"log_eval={d}/rmse.tsv", *dev])
        out[tag] = (d, [float(line.split()[1]) for line in (d / "rmse.tsv").read_text().splitlines()])
    assert len(out["port"][1]) == 4
    np.testing.assert_allclose(out["port"][1], out["jax"][1], atol=ATOL)
    from svdfeature_tpu.model import SVDModel as JModel

    for r in range(4):
        models = []
        for tag in ("port", "jax"):
            with open(out[tag][0] / "models" / f"{r:04d}.model", "rb") as f:
                models.append(JModel.load(f, jx.Type.from_bytes(f.read(4))))
        for name in ("w", "b", "g"):
            np.testing.assert_allclose(np.asarray(getattr(models[0], name)),
                                       np.asarray(getattr(models[1], name)), atol=ATOL,
                                       err_msg=f"round {r} {name}")


# ---- on the card ------------------------------------------------------------------------
@pytest.mark.cuda
def test_streamed_round_on_card_matches_staged(tmp_path):
    """On the card a streamed round goes through K1 once a chunk on chunks
    copied on a side stream, equals the staged run on the card (K1 against
    itself on the same batches: atol 1e-5 + rtol 1e-4, its atomics sum in a
    varying order) and leaves no chunk tensor in any plan list."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m cuda tests/)")
    from svdfeature_tpu_torch.ops.cuda_embed import train_rounds_kernel

    tds = csr_ds(PORT)
    write_csr_buffer(str(tmp_path / "b.buffer"), tds, batch_size=64)
    src = StreamingCSRBuffer(str(tmp_path / "b.buffer"), examples_per_chunk=256)

    def trainer():
        tr = SVDFeatureTrainer(SVDTypeParam())
        for k, v in dict(BASE, device="cuda").items():
            tr.set_param(k, str(v))
        tr.init_model()
        tr.init_trainer()
        return tr

    staged, streamed = trainer(), trainer()
    refs = []
    stage = streamed.chunk_stream.stage

    def recording(entry, device):
        staged = stage(entry, device)
        refs.extend(weakref.ref(t) for t in staged.tensors)
        return staged

    streamed.chunk_stream.stage = recording
    before = train_rounds_kernel.launches
    for _ in range(3):
        streamed.update_all(src)
        held = {id(t) for plans in _plans._LISTS for plan in plans for t in plan.tensors}
        assert refs and not any(ref() is not None and id(ref()) in held for ref in refs)
    assert train_rounds_kernel.launches - before == 9  # 3 chunks a round
    for _ in range(3):
        staged.update_all(tds)
    torch.cuda.synchronize()
    for x, y in zip(tables(streamed), tables(staged)):
        np.testing.assert_allclose(x, y, atol=1e-5, rtol=1e-4)
