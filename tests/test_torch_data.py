"""The port's numpy layers and model IO against the JAX package's.

The port carries verbatim copies of the JAX package's numpy-only modules
(a GPU host need not have JAX, and importing any module of
svdfeature_tpu imports jax).  These tests keep the copies identical to
their originals, and check on the ML-100K fixtures that both give
byte-identical arrays: text parse, buffer write/read, pack_csr, pack_plus,
rand_init, and ``%04d.model`` bytes in both directions.
"""

import gzip
import io
import pathlib

import numpy as np
import pytest
import torch

from svdfeature_tpu import model as jmodel
from svdfeature_tpu.data import batching as jbatching
from svdfeature_tpu.data import batching_plus as jbatching_plus
from svdfeature_tpu.data import buffer as jbuffer
from svdfeature_tpu.data import text as jtext
from svdfeature_tpu.ops import embed as jembed
from svdfeature_tpu.params import SVDModelParam, SVDTypeParam, svd_type
from svdfeature_tpu_torch import model as tmodel
from svdfeature_tpu_torch import params as tparams
from svdfeature_tpu_torch.data import batching as tbatching
from svdfeature_tpu_torch.data import batching_plus as tbatching_plus
from svdfeature_tpu_torch.data import buffer as tbuffer
from svdfeature_tpu_torch.data import text as ttext

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
CPU = torch.device("cpu")
COPIES = [
    "config.py", "params.py", "utils/sparse_feature_array.py", "utils/apex_random.py",
    "data/csr.py", "data/text.py", "data/native.py", "data/buffer.py",
    "data/batching.py", "cli/svd_feature.py", "cli/svd_feature_infer.py",
    "cli/make_feature_buffer.py", "data/batching_plus.py", "cli/make_ugroup_buffer.py",
    "data/batching_imfb.py", "data/rank.py", "utils/evaluator.py",
    "solvers/gbrt/tree.py", "solvers/gbrt/schedulers.py", "data/combinators.py",
    "cli/line_shuffle.py", "cli/line_reorder.py", "cli/svdpp_randorder.py",
    "cli/combine_ugroup.py", "utils/csr_builder.py", "data/streaming.py", "data/pages.py",
]
ML100K = dict(num_user=943, num_item=1682, num_factor=64, base_score=3.0)


@pytest.mark.parametrize("rel", COPIES)
def test_copies_are_verbatim(rel):
    """A one-line header naming the origin, then the original unchanged."""
    header, body = (ROOT / "svdfeature_tpu_torch" / rel).read_text().split("\n", 1)
    assert header.startswith(f"# Verbatim copy of svdfeature_tpu/{rel}")
    assert body == (ROOT / "svdfeature_tpu" / rel).read_text()


def _text(name):
    with gzip.open(FIXTURES / name, "rt") as f:
        return f.read()


def _assert_csr_equal(a, b):
    for f in ("labels", "row_ptr", "index", "value"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.fixture(scope="module")
def datasets():
    """(jax, port) parses of the ML-100K train fixtures."""
    out = {}
    for name in ("ml100k.base.feature.gz", "ml100k.base.nb.feature.gz"):
        text = _text(name)
        out[name] = (jtext.load_feature_text("x", text=text),
                     ttext.load_feature_text("x", text=text))
    return out


@pytest.mark.parametrize("name", ["ml100k.base.feature.gz", "ml100k.base.nb.feature.gz"])
def test_text_parse_identical(datasets, name):
    jds, tds = datasets[name]
    assert jds.num_row == 90570
    _assert_csr_equal(jds, tds)


def test_buffer_bytes_identical(datasets, tmp_path):
    jds, tds = datasets["ml100k.base.nb.feature.gz"]
    jbuffer.write_csr_buffer(str(tmp_path / "j.buffer"), jds, 1000)
    tbuffer.write_csr_buffer(str(tmp_path / "t.buffer"), tds, 1000)
    raw = (tmp_path / "j.buffer").read_bytes()
    assert raw == (tmp_path / "t.buffer").read_bytes()
    jback, _ = jbuffer.read_csr_buffer(str(tmp_path / "t.buffer"))
    tback, _ = tbuffer.read_csr_buffer(str(tmp_path / "j.buffer"))
    _assert_csr_equal(jback, tback)
    _assert_csr_equal(tback, tds)


@pytest.mark.parametrize("name,num_global", [("ml100k.base.feature.gz", 0),
                                             ("ml100k.base.nb.feature.gz", 6)])
def test_pack_csr_identical(datasets, name, num_global):
    jds, tds = datasets[name]
    args = (4096, 943 + 1682, num_global, 0, 943)
    kw = dict(num_user=943, num_item=1682)
    ja = jbatching.pack_csr(jds, *args, **kw).arrays()
    ta = tbatching.pack_csr(tds, *args, **kw).arrays()
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and ja[k].tobytes() == ta[k].tobytes(), k
    assert ta["label"].shape == (23, 4096)


@pytest.mark.parametrize("sort_blocks,rows_per_user", [(False, 1), (True, 8)])
def test_pack_plus_identical(sort_blocks, rows_per_user):
    """The ML-100K user-group set (implicitFeedback demo) parsed and packed
    by both packages: every plane, pool and overlap byte-identical."""
    kw = dict(text=_text("ml100k.base.group.feature.gz"),
              feedback_text=_text("ml100k.base.feedback.gz"))
    args = (128, 4307, 0, 1682, 2625, 0)
    pkw = dict(num_user=943, num_item=1682, num_ufeedback=1682, sort_blocks=sort_blocks,
               rows_per_user=rows_per_user)
    jp = jbatching_plus.pack_plus(jtext.load_plus_text("x", "y", **kw), *args, **pkw)
    tp = tbatching_plus.pack_plus(ttext.load_plus_text("x", "y", **kw), *args, **pkw)
    ja = dict(jp.device_arrays(), **jp.fb_arrays(), fb_overlap=jp.fb_overlap, perm=jp.perm)
    ta = dict(tp.device_arrays(), **tp.fb_arrays(), fb_overlap=tp.fb_overlap, perm=tp.perm)
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and ja[k].tobytes() == ta[k].tobytes(), k
    T = 159 if sort_blocks else 4088
    assert ta["label"].shape == (T, 128 * rows_per_user) and ta["fb_overlap"].shape == (8, 129, 129)


@pytest.mark.parametrize("exact_rng", [False, True])
def test_rand_init_identical(exact_rng):
    """Seeded inits are byte-identical (numpy RandomState, or the bit-exact
    apex_random port on a small table: it draws in pure Python)."""
    kw = ML100K if not exact_rng else dict(num_user=11, num_item=17, num_factor=8,
                                           base_score=3.0)
    for at, base in ((0, kw["base_score"]), (2, 0.5)):
        p = dict(kw, base_score=base, num_global=6)
        jm = jmodel.SVDModel.rand_init(SVDModelParam(**p), SVDTypeParam(active_type=at),
                                       seed=10, exact_rng=exact_rng)
        tm = tmodel.SVDModel.rand_init(tparams.SVDModelParam(**p),
                                       tparams.SVDTypeParam(active_type=at),
                                       device=CPU, seed=10, exact_rng=exact_rng)
        for f in ("w", "b", "g"):
            assert np.asarray(getattr(jm, f)).tobytes() == getattr(tm, f).numpy().tobytes()
        assert jm.param.to_bytes() == tm.param.to_bytes()


@pytest.mark.parametrize("format_type,extra", [
    (svd_type.RANDOM_ORDER_FORMAT, dict(num_global=6)),
    (svd_type.USER_GROUP_FORMAT, dict(num_ufeedback=13)),
    (svd_type.USER_GROUP_FORMAT, dict(num_user=9, num_item=9, common_latent_space=1,
                                      common_feedback_space=1)),
])
def test_model_bytes_cross_load(format_type, extra):
    """A model saved by either package loads in the other and saves back
    to the same bytes (pattern: tests/test_model_io.py)."""
    p = dict(dict(num_user=11, num_item=17, num_factor=8, base_score=3.0), **extra)

    def saved(m, mt):
        buf = io.BytesIO()
        buf.write(mt.to_bytes())
        m.save(buf)
        return buf.getvalue()

    jmt = SVDTypeParam(format_type=format_type)
    tmt = tparams.SVDTypeParam(format_type=format_type)
    jm = jmodel.SVDModel.rand_init(SVDModelParam(**p), jmt, seed=3)
    jm.b = jm.b + 0.25  # non-zero biases and globals in the file
    jm.g = jm.g - 0.5
    raw = saved(jm, jmt)
    f = io.BytesIO(raw)
    tm = tmodel.SVDModel.load(f, tparams.SVDTypeParam.from_bytes(f.read(4)), device=CPU)
    assert f.read() == b""
    assert saved(tm, tmt) == raw

    tm2 = tmodel.SVDModel.rand_init(tparams.SVDModelParam(**p), tmt, device=CPU, seed=4)
    tm2.b += 0.125
    raw2 = saved(tm2, tmt)
    f = io.BytesIO(raw2)
    jm2 = jmodel.SVDModel.load(f, SVDTypeParam.from_bytes(f.read(4)))
    assert saved(jm2, jmt) == raw2
    np.testing.assert_array_equal(np.asarray(jm2.w), tm2.w.numpy())


def test_model_forward_matches_jax(datasets):
    """SVDModel.forward on a packed ML-100K batch equals the JAX package's
    forward_scores (atol 1e-6), with the global segment on."""
    jds, tds = datasets["ml100k.base.nb.feature.gz"]
    p = dict(ML100K, num_global=6)
    rng = np.random.RandomState(5)
    tm = tmodel.SVDModel.rand_init(tparams.SVDModelParam(**p), tparams.SVDTypeParam(),
                                   device=CPU, seed=10)
    tm.b = torch.from_numpy(rng.normal(0, 0.1, tm.b.shape).astype(np.float32))
    tm.g = torch.from_numpy(rng.normal(0, 0.1, tm.g.shape).astype(np.float32))
    arrays = tbatching.pack_csr(tds, 1024, 2625, 6, 0, 943).arrays()
    batch = {k: v[0] for k, v in arrays.items()}
    got = tm.forward({k: torch.from_numpy(v) for k, v in batch.items()})

    import jax.numpy as jnp

    pad = lambda a, tail: np.concatenate([a.numpy(), np.zeros(tail, np.float32)])
    state = jembed.TrainState(
        w=jnp.asarray(pad(tm.w, (1, 64))), b=jnp.asarray(pad(tm.b, 1)),
        g=jnp.asarray(pad(tm.g, 1)), step=jnp.int32(0),
        ref_ui=jnp.zeros(2626, jnp.int32), ref_g=jnp.zeros(7, jnp.int32),
    )
    hp = jembed.HyperParams(base_score=3.0)
    want, _, _ = jembed.forward_scores(state, {k: jnp.asarray(v) for k, v in batch.items()}, hp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
