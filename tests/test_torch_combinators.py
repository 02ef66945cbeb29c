"""The port's user-group combinators (data/combinators.py, a copy, and the
attach / filter routing of data/registry.py) against the JAX package.

The cases of tests/test_combinators.py (interleave, a short attached
stream looping, filter ranges, the registry's input_type encoding) run
through both packages on the same text and give byte-identical arrays;
the CLI slice trains GBRT on input_type 111 and 201 through both packages'
tasks to byte-identical checkpoints; APLambda samples ``attach:
rank_sample_num`` pairs on the attached blocks as the JAX trainer does.
"""

import numpy as np
import pytest

from svdfeature_tpu.data import combinators as jcomb
from svdfeature_tpu.data import registry as jreg
from svdfeature_tpu.data.text import load_plus_text as jload
from svdfeature_tpu.params import SVDTypeParam as JType
from svdfeature_tpu.solvers.gbrt.trainer import create_gbrt_trainer as jcreate
from svdfeature_tpu.train.loop import SVDTrainTask as JTrain
from svdfeature_tpu_torch.data import combinators as tcomb
from svdfeature_tpu_torch.data import registry as treg
from svdfeature_tpu_torch.data.text import load_plus_text as tload
from svdfeature_tpu_torch.params import SVDTypeParam as TType
from svdfeature_tpu_torch.solvers.gbrt.trainer import create_gbrt_trainer as tcreate
from svdfeature_tpu_torch.train.loop import SVDTrainTask as TTrain

FIELDS = ("fb_index", "fb_value", "block_row_ptr", "block_fb_ptr", "extend_tag", "extra_info")


def tiny_text(n_users=4, label0=1.0):
    """tests/test_combinators.py's tiny(): two rows and two feedback ids a
    user, global id 2 on every row."""
    rows, fb = [], []
    for u in range(n_users):
        for i in range(2):
            rows.append(f"{label0} 1 1 1 2:1 {u}:1 {u*2+i}:1")
        fb.append(f"2 2 {u*2}:0.7 {u*2+1}:0.7")
    return "\n".join(rows), "\n".join(fb)


def both(n_users=4, label0=1.0):
    rows, fb = tiny_text(n_users, label0)
    return (jload("x", "y", text=rows, feedback_text=fb),
            tload("x", "y", text=rows, feedback_text=fb))


def assert_same(a, b):
    """Two PlusDatasets hold byte-identical arrays."""
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f
    for f in ("labels", "row_ptr", "index", "value"):
        x, y = getattr(a.rows, f), getattr(b.rows, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("skip,insert,n_attached,n_blocks", [
    pytest.param(2, 1, 2, 6, id="interleave"),
    pytest.param(1, 1, 1, 8, id="loops-short-stream"),
    pytest.param(1, 2, 3, 12, id="insert-two"),
])
def test_attach_matches_jax(skip, insert, n_attached, n_blocks):
    """AttachedPlusSource: p p a p p a (skip 2), a one-block attached
    stream rewinding (skip 1), two attached blocks a primary one; the
    attached blocks marked extra_info=1."""
    (jp, tp), (ja, ta) = both(4, 1.0), both(n_attached, 9.0)
    want = jcomb.AttachedPlusSource(jp, ja, attach_skip=skip, attach_insert=insert).materialize()
    got = tcomb.AttachedPlusSource(tp, ta, attach_skip=skip, attach_insert=insert).materialize()
    assert got.num_block == n_blocks
    assert_same(got, want)
    extra = [got.block(i).extra_info for i in range(n_blocks)]
    assert sum(extra) == n_blocks - 4 and extra == [want.block(i).extra_info
                                                    for i in range(n_blocks)]


def test_filter_matches_jax():
    """FilteredPlusSource zeroes feedback ids [0, 2) and global id 2."""
    jds, tds = both(2)
    want = jcomb.FilteredPlusSource(jds, [(0, 2)], [(2, 3)]).materialize()
    got = tcomb.FilteredPlusSource(tds, [(0, 2)], [(2, 3)]).materialize()
    assert_same(got, want)
    assert np.all(got.block(0).fb_value == 0.0) and np.all(got.block(1).fb_value != 0.0)
    assert got.rows.row(0)[1][1][0] == 0.0


@pytest.mark.parametrize("dtype,keys,n_blocks", [
    pytest.param(111, [], 6, id="attach-text-text"),
    pytest.param(111, [("attach_skip", "3"), ("attach:data_in", "B")], 4,
                 id="attach-skip3-other-data"),
    pytest.param(201, [("filter_ufeedback", "0-1"), ("filter_global", "0-1")], 3,
                 id="filter-text"),
    pytest.param(200, [("filter_ufeedback", "1-3")], 3, id="filter-buffer"),
])
def test_registry_encoding_matches_jax(dtype, keys, n_blocks, tmp_path):
    """input_type 1xx = attach(create(x / 10 % 10), create(x % 10)), 2xx =
    filter(create(x % 100)) (apex_svd_data.cpp:1313-1324), with the
    ``attach:`` keys routed to the attached source, through both
    packages' load_plus_source."""
    for name, n in (("a", 3), ("b", 1)):
        rows = [f"1 0 1 1 {u}:1 {u}:1" for u in range(n)]
        (tmp_path / f"{name}.txt").write_text("\n".join(rows))
        (tmp_path / f"{name}.fb").write_text("\n".join(f"1 1 {u}:1" for u in range(n)))
    out = []
    for reg in (jreg, treg):
        cfg = reg.IteratorConfig()
        cfg.set_param("data_in", str(tmp_path / "a.txt"))
        cfg.set_param("feedback_in", str(tmp_path / "a.fb"))
        cfg.set_param("buffer_feature", str(tmp_path / f"a.{reg.__name__.split('.')[0]}.buffer"))
        for k, v in keys:
            if k == "attach:data_in":
                cfg.set_param(k, str(tmp_path / "b.txt"))
                cfg.set_param("attach:feedback_in", str(tmp_path / "b.fb"))
            else:
                cfg.set_param(k, v)
        out.append(reg.load_plus_source(dtype, cfg))
    assert out[1].num_block == n_blocks
    assert_same(out[1], out[0])
    if dtype == 201:
        assert out[1].fb_value[out[1].fb_index == 0].sum() == 0.0


GBRT_CONF = (
    "num_item = 12\nnum_ufeedback = 12\nnum_spec_sparse = 30\nnum_global = 0\n"
    "learning_rate = 0.3\nmin_split_loss = 0.01\nmin_split_instance = 4\n"
    "min_child_instance = 2\nmin_child_weight = 0.5\nmin_split_weight = 1\nmax_depth = 3\n"
    "rt_loss_type = 1\nbase_score = 0.5\nsilent = 1\n"
)


def gbrt_text(seed, n_users=30):
    """tests/test_gbrt.py's gbrt_dataset text (seeded)."""
    rng = np.random.RandomState(seed)
    rows, fb = [], []
    for u in range(n_users):
        items = rng.choice(12, 6, replace=False)
        for i in items:
            rows.append(f"{rng.randint(0, 2)} 0 1 1 {u}:1 {i}:1")
        fb.append("6 6 " + " ".join(f"{i}:{1 / np.sqrt(6):.5f}" for i in items))
    return "\n".join(rows), "\n".join(fb)


@pytest.mark.parametrize("et,dtype,extra", [
    pytest.param(31, 111, "attach_skip = 2\n", id="reg-attach"),
    pytest.param(30, 111, "active_type = 3\nrank_sample_num = 3\nattach:rank_sample_num = 9\n",
                 id="aplambda-attach"),
    pytest.param(31, 201, "filter_ufeedback = 0-6\nfilter_global = 0-1\n", id="reg-filter"),
])
def test_cli_matches_jax(et, dtype, extra, tmp_path):
    """GBRT through both packages' SVDTrainTask (3 rounds) on a combined
    input: every checkpoint byte for byte."""
    for name, seed, n in (("a", 0, 30), ("b", 7, 10)):
        rows, fb = gbrt_text(seed, n)
        (tmp_path / f"{name}.txt").write_text(rows)
        (tmp_path / f"{name}.fb").write_text(fb)
    models = {}
    for tag, task_cls, dev in (("jax", JTrain, []), ("torch", TTrain, ["device=cpu"])):
        conf = tmp_path / f"{tag}.conf"
        conf.write_text(
            GBRT_CONF + extra + f'extend_type = {et}\ninput_type = {dtype}\n'
            f'data_in = "{tmp_path}/a.txt"\nfeedback_in = "{tmp_path}/a.fb"\n'
            f'attach:data_in = "{tmp_path}/b.txt"\nattach:feedback_in = "{tmp_path}/b.fb"\n'
            f'model_out_folder = "{tmp_path}/{tag}"\n')
        task = task_cls()
        task.run(str(conf), ["num_round=3", *dev])
        models[tag] = [(tmp_path / tag / f"{r:04d}.model").read_bytes() for r in range(4)]
        n = task.dataset.num_block
        assert n == (30 + 15 if dtype == 111 and et == 31 else 60 if dtype == 111 else 30)
    assert models["torch"] == models["jax"]


def test_aplambda_attach_sample_num_matches_jax():
    """APLambda with rank_sample_num > 0 draws ``attach:rank_sample_num``
    pairs on a block marked extra_info=1 and rank_sample_num on the
    others: the same gradients, hessians and weights as the JAX trainer,
    and a different draw than without the attach key."""
    rows, fb = gbrt_text(0, 12)
    arows, afb = gbrt_text(5, 6)
    dsets = []
    for load, comb in ((jload, jcomb), (tload, tcomb)):
        p = load("x", "y", text=rows, feedback_text=fb)
        a = load("x", "y", text=arows, feedback_text=afb)
        dsets.append(comb.AttachedPlusSource(p, a, attach_skip=2).materialize())
    stats = {}
    for attach_num in ("9", None):
        for tag, create, ttype, ds in (("jax", jcreate, JType, dsets[0]),
                                       ("torch", tcreate, TType, dsets[1])):
            mt = ttype(format_type=1, extend_type=30)
            keys = dict(num_item=12, num_ufeedback=12, num_spec_sparse=12, active_type=3,
                        rank_sample_num=2, lambda_ap_alpha=0.5)
            if tag == "torch":
                keys["device"] = "cpu"
            if attach_num:
                keys["attach:rank_sample_num"] = attach_num
            tr = create(mt)
            for k, v in keys.items():
                mt.set_param(k, str(v))
                tr.set_param(k, str(v))
            tr.init_model()
            tr.init_trainer()
            tr.set_round(0)
            entry = tr._assemble(ds)
            stats[tag, attach_num] = tr.update_stats(tr.forward_all(ds), entry)
            assert entry["extra_info"].sum() == 6
        for j, t in zip(stats["jax", attach_num], stats["torch", attach_num]):
            assert j.dtype == t.dtype and np.array_equal(j, t)
    assert not np.array_equal(stats["torch", "9"][2], stats["torch", None][2])
