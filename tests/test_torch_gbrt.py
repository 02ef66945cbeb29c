"""The port's GBRT solvers (extend_type 30/31: solvers/gbrt/trainer.py,
solvers/gbrt/np_losses.py, ops/gbrt_forward.py) against the JAX package.

The same seeded numpy inputs go to both packages, built as
tests/test_gbrt.py builds them (``gbrt_dataset`` / ``_mk``): the loss
functions the trainers call (dtype for dtype, within 1 ulp), RegGBRT's
checkpoints byte for byte, predictions within 1e-6 (active_type 2,
APLambda, the schedulers and options), the torch walk against the JAX
package's jitted walk and the host walk (1e-5), checkpoints both ways, the
CLI slice and the first two rounds of golden/gbrt_reg.rmse.tsv.  The port
runs on the CPU here (``device=cpu``); the walk on the card is a ``cuda``
case.  JAX is imported in the ``jx`` fixture, so a host without it still
collects this file and runs the card case.
"""

import gzip
import io
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svdfeature_tpu_torch.data.text import load_plus_text
from svdfeature_tpu_torch.infer.task import SVDInferTask as TInfer
from svdfeature_tpu_torch.ops import gbrt_forward
from svdfeature_tpu_torch.params import SVDTypeParam, svd_type
from svdfeature_tpu_torch.solvers.gbrt import np_losses
from svdfeature_tpu_torch.solvers.gbrt.trainer import (APLambdaGBRTTrainer, RegGBRTTrainer,
                                                       create_gbrt_trainer)
from svdfeature_tpu_torch.train.loop import SVDTrainTask as TTrain

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
ACTIVE_TYPES = (0, 1, 2, 3, 5, 6, 7)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here and not at the top: a GPU host
    without JAX still collects this file and runs the card case."""
    pytest.importorskip("jax")
    from svdfeature_tpu import losses
    from svdfeature_tpu.data.text import load_plus_text as jload
    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.ops import gbrt_forward as jforward
    from svdfeature_tpu.params import SVDTypeParam as JType
    from svdfeature_tpu.solvers.gbrt import trainer as jtrainer
    from svdfeature_tpu.train.loop import SVDTrainTask

    return SimpleNamespace(losses=losses, load_plus_text=jload, forward=jforward, JType=JType,
                           trainer=jtrainer, Train=SVDTrainTask, Infer=SVDInferTask)


def gbrt_text(weights=False):
    """tests/test_gbrt.py's gbrt_dataset as (rows, feedback) text: 30 users
    with 6 of 12 items each, 0/1 labels, feedback 1/sqrt(6) on the rated
    items.  With ``weights``, three root-weight slots (global ids 0-2)
    and one dense global (id 3) lead every row."""
    rng = np.random.RandomState(0)
    rows, fb = [], []
    for u in range(30):
        n = 6
        items = rng.choice(12, n, replace=False)
        for i in items:
            label = rng.randint(0, 2)
            g = (f"4 1 1 0:1 1:{0.5 + (i % 3) / 2:g} 2:{1 + u % 2} 3:{i / 12:.4f}"
                 if weights else "0 1 1")
            rows.append(f"{label} {g} {u}:1 {i}:1")
        v = 1.0 / np.sqrt(n)
        fb.append(f"{n} {n} " + " ".join(f"{i}:{v:.5f}" for i in items))
    return "\n".join(rows), "\n".join(fb)


def datasets(jx, weights=False):
    """(JAX, port) parses of the same text."""
    rows, fb = gbrt_text(weights)
    return (jx.load_plus_text("x", "y", text=rows, feedback_text=fb),
            load_plus_text("x", "y", text=rows, feedback_text=fb))


BASE = dict(
    num_item=12, num_ufeedback=12, num_spec_sparse=30, num_global=0,
    learning_rate=0.3, min_split_loss=0.01, min_split_instance=4,
    min_child_instance=2, min_child_weight=0.5, min_split_weight=1,
    max_depth=3, rt_loss_type=1, base_score=0.5,
)


def trainers(jx, et, **over):
    """(JAX, port) trainers as tests/test_gbrt.py's _mk makes them, with
    the same parameters; the port's on the CPU."""
    mt_kw = dict(format_type=svd_type.USER_GROUP_FORMAT, extend_type=et)
    out = []
    for port in (False, True):
        mt = (SVDTypeParam if port else jx.JType)(**mt_kw)
        p = dict(BASE, **over)
        if port:
            p["device"] = "cpu"
        for k, v in p.items():
            mt.set_param(k, str(v))
        tr = (create_gbrt_trainer if port else jx.trainer.create_gbrt_trainer)(mt)
        for k, v in p.items():
            tr.set_param(k, str(v))
        tr.init_model()
        tr.init_trainer()
        out.append(tr)
    return out


def train_round(tr, ds, r):
    tr.set_round(r)
    tr.update_all(ds)
    tr.finish_round()


def train(tr, ds, rounds):
    for r in range(rounds):
        train_round(tr, ds, r)
    return tr


def saved(tr) -> bytes:
    buf = io.BytesIO()
    tr.save_model(buf)
    return buf.getvalue()


# ---- the loss functions ------------------------------------------------------

def _ulps(a, b):
    """Distance in float32 units in the last place (0 for equal values)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("kind", ["f32", "f64", "scalar"])
@pytest.mark.parametrize("at", ACTIVE_TYPES)
def test_loss_mirror_matches_jax(jx, at, kind):
    """map_active / cal_grad / cal_sgrad as the JAX trainers see them: the
    dtype of ``np.asarray`` of the JAX result, exact where JAX stays in
    numpy, within 1 ulp where it computes in float32; type 1's sgrad
    raises in both."""
    rng = np.random.RandomState(at * 10 + len(kind))
    if kind == "scalar":
        cases = [(float(r), float(p)) for r, p in zip(rng.randint(0, 2, 64), rng.randn(64) * 4)]
    else:
        dt = np.float32 if kind == "f32" else np.float64
        cases = [(rng.randint(0, 2, 4096).astype(dt), (rng.randn(4096) * 4).astype(dt))]
    for r, p in cases:
        for fn, args in (("map_active", (p, at)), ("cal_grad", (r, p, at)),
                         ("cal_sgrad", (r, p, at))):
            if fn == "cal_sgrad" and at == 1:
                for mod in (jx.losses, np_losses):
                    with pytest.raises(ValueError):
                        getattr(mod, fn)(*args)
                continue
            want = np.asarray(getattr(jx.losses, fn)(*args))
            got = np.asarray(getattr(np_losses, fn)(*args))
            assert got.dtype == want.dtype and got.shape == want.shape, (fn, got.dtype, want.dtype)
            if want.dtype == np.float32:
                assert _ulps(got, want).max() <= 1, fn
            else:
                assert np.array_equal(got, want), fn


def test_exp32_is_the_jax_cpu_exp(jx):
    """The float32 exp of the mirror equals jnp.exp on the CPU bit for bit,
    from the clamps inward (subnormal results flushed to zero)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    x = np.concatenate([rng.uniform(-100, 100, 200_000), rng.randn(200_000) * 3,
                        rng.randn(20_000) * 1e-3, [0.0, -0.0, 88.7, 88.8, 89.0, -87.3, -87.8,
                                                   -88.0, 1e-40, 1e30, -1e30]]).astype(np.float32)
    assert np.array_equal(np_losses.exp32(x), np.asarray(jnp.exp(x)))


# ---- training ------------------------------------------------------------------

def test_reg_gbrt_checkpoints_equal_jax(jx):
    """RegGBRT at active_type=0, 5 rounds: every round's checkpoint equals
    the JAX package's byte for byte, and so do the predictions."""
    jds, tds = datasets(jx)
    jt, tt = trainers(jx, 31)
    assert isinstance(tt, RegGBRTTrainer)
    for r in range(5):
        for tr, ds in ((jt, jds), (tt, tds)):
            train_round(tr, ds, r)
        assert saved(tt) == saved(jt), r
    assert len(tt.trees) == 5
    assert np.array_equal(tt.predict_all(tds), jt.predict_all(jds))


@pytest.mark.parametrize("et,over,rounds", [
    pytest.param(31, dict(active_type=2), 5, id="reg-active_type2"),
    pytest.param(30, dict(active_type=3, lambda_ap_alpha=0.5, lambda_ap_reject=1), 3,
                 id="aplambda"),
    pytest.param(30, dict(active_type=0, rank_sample_pointwise=1, lambda_weight_mode=0), 3,
                 id="aplambda-pointwise"),
    pytest.param(30, dict(active_type=5, rank_sample_num=4, lambda_ap_alpha=0.3), 3,
                 id="aplambda-hinge-sampled"),
])
def test_predictions_match_jax(jx, et, over, rounds):
    """Predictions of RegGBRT at active_type=2 and of APLambda within 1e-6
    of the JAX package's after the same rounds, the same trees."""
    jds, tds = datasets(jx)
    jt, tt = trainers(jx, et, **over)
    assert isinstance(tt, APLambdaGBRTTrainer if et == 30 else RegGBRTTrainer)
    train(jt, jds, rounds)
    train(tt, tds, rounds)
    got, want = tt.predict_all(tds), jt.predict_all(jds)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert len(tt.trees) == rounds and np.isfinite(got).all()


def write_taxonomy(path):
    """12 items, two labels: item % 3 (3 values) and item % 4 (4 values)."""
    rows = "\n".join(f"{i % 3} {i % 4}" for i in range(12))
    path.write_text(f"12 2 3 4\n{rows}\n")


OPTIONS = {
    "subsample_prob": dict(subsample_prob=0.6),
    "decay_learning_rate": dict(decay_learning_rate=1, decay_rate=0.7, min_learning_rate=0.15),
    "use_tax_root": dict(use_tax_root=1, rtype_chg_cycle=2, **{"rtype[0]": 0, "rtype[1]": 1}),
    "num_root_weight": dict(num_root_weight=2, num_global=1, wtype_chg_cycle=2,
                            **{"wtype[0]": 1, "wtype[1]": 2}),
    "pset": dict(pset="0-6.0-1", ptype_chg_cycle=2, **{"ptype[0]": 1}),
    "pred_tree_leaf": dict(),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_options_match_jax(jx, name, tmp_path):
    """The schedulers and options at active_type=0, 4 rounds: checkpoints
    byte for byte and predictions (for pred_tree_leaf, tree 2's leaf ids)
    equal to the JAX package's."""
    over = dict(OPTIONS[name])
    if name == "use_tax_root":
        write_taxonomy(tmp_path / "tax.txt")
        over["feature_item"] = str(tmp_path / "tax.txt")
    jds, tds = datasets(jx, weights=(name == "num_root_weight"))
    jt, tt = trainers(jx, 31, **over)
    train(jt, jds, 4)
    train(tt, tds, 4)
    assert saved(tt) == saved(jt)
    if name == "pred_tree_leaf":
        for tr in (jt, tt):
            tr.set_param("pred_tree_leaf", "2")
    got, want = tt.predict_all(tds), jt.predict_all(jds)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if name == "use_tax_root":
        assert tt.root_type == [0, 1, 0, 1]
    if name == "num_root_weight":
        assert tt.weight_type == [1, 2, 1, 2]


# ---- the walk ------------------------------------------------------------------

WALK_CASES = {"plain": {}, "use_tax_root": OPTIONS["use_tax_root"],
              "num_root_weight": OPTIONS["num_root_weight"]}


@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_walk_matches_jax_and_host(jx, name, tmp_path):
    """The torch walk (device_forward=1 on the CPU) against the host walk
    and against the JAX package's jitted walk on the CPU (1e-5), with
    missing features' default directions, one root per item and, in the
    option cases, mapped roots and per-tree row weights; stack_trees
    equals the JAX package's, and its depth is the deepest path."""
    over = dict(WALK_CASES[name])
    if name == "use_tax_root":
        write_taxonomy(tmp_path / "tax.txt")
        over["feature_item"] = str(tmp_path / "tax.txt")
    jds, tds = datasets(jx, weights=(name == "num_root_weight"))
    jt, tt = trainers(jx, 31, **over)
    train(jt, jds, 5)
    train(tt, tds, 5)
    st = gbrt_forward.stack_trees([t.tree for t in tt.trees])
    jst = jx.forward.stack_trees([t.tree for t in jt.trees])
    for k, v in jst.items():
        assert np.array_equal(st[k], v), k
    assert st["depth"] == max(t.tree.get_depth(n) for t in tt.trees
                              for n in range(t.tree.num_nodes)) > 0
    results = {}
    for tag, tr, ds, mode in (("host", tt, tds, 0), ("torch", tt, tds, 1), ("jax", jt, jds, 1)):
        tr.device_forward = mode
        tr._fwd_cache.clear()
        results[tag] = tr.forward_all(ds)
    for tag in ("torch", "jax"):
        np.testing.assert_allclose(results[tag], results["host"], atol=1e-5, rtol=1e-5,
                                   err_msg=tag)
    np.testing.assert_allclose(results["torch"], results["jax"], atol=1e-5, rtol=1e-5)
    for mode in (0, 1):
        tt.device_forward = mode
        tt._fwd_cache.clear()
        results[mode] = tt.predict_all(tds)
    np.testing.assert_allclose(results[1], results[0], atol=1e-5, rtol=1e-5)


def test_walk_incremental_cache(jx):
    """tests/test_gbrt.py:252-272: the torch walk of trees [start:] composes
    with the incremental forward cache."""
    _, tds = datasets(jx)
    _, tt = trainers(jx, 31)
    train(tt, tds, 4)
    tt.device_forward = 0
    tt._fwd_cache.clear()
    host = tt.forward_all(tds)
    tt._fwd_cache.clear()
    trees = tt.trees
    tt.trees = trees[:2]
    tt.forward_all(tds)
    tt.trees = trees
    tt.device_forward = 1
    dev = tt.forward_all(tds)
    np.testing.assert_allclose(dev, host, atol=1e-5, rtol=1e-5)
    assert tt._fwd_cache[id(tds)][1] == 4


def test_auto_walk_rule(jx):
    """device_forward=-1 takes the host walk on the CPU (the torch walk is
    for a CUDA device), 1 the torch walk for a full or partial forward, 0
    never; one tree or start == len(trees) never walk on the device."""
    _, tds = datasets(jx)
    _, tt = trainers(jx, 31)
    train(tt, tds, 3)
    entry = tt._assemble(tds)
    assert not tt._use_device_forward(entry, 0)
    tt.device_forward = 1
    assert tt._use_device_forward(entry, 0) and tt._use_device_forward(entry, 2)
    assert not tt._use_device_forward(entry, 3)
    tt.device = torch.device("cuda")  # the rule only reads the device's type
    tt.device_forward = -1
    assert tt._use_device_forward(entry, 0) and not tt._use_device_forward(entry, 1)
    tt.trees = tt.trees[:1]
    assert not tt._use_device_forward(entry, 0)
    tt.device_forward = 0
    assert not tt._use_device_forward(entry, 0)


# ---- checkpoints and the CLI -------------------------------------------------------

@pytest.mark.parametrize("et", [30, 31])
def test_checkpoints_both_ways(jx, et):
    """A model saved by either package loads in the other, saves the same
    bytes and predicts the same (the host walk: equal; the torch walk
    within 1e-5)."""
    over = dict(active_type=3, lambda_ap_alpha=0.5) if et == 30 else {}
    jds, tds = datasets(jx)
    jt, tt = trainers(jx, et, **over)
    train(jt, jds, 3)
    train(tt, tds, 3)
    for src, dst_port in ((jt, True), (tt, False)):
        blob = saved(src)
        dst = trainers(jx, et, **over)[1 if dst_port else 0]
        dst.load_model(io.BytesIO(blob))
        dst.init_trainer()
        assert saved(dst) == blob
        ds_dst, ds_src = (tds, jds) if dst_port else (jds, tds)
        assert np.array_equal(dst.predict_all(ds_dst), src.predict_all(ds_src))
        if dst_port:
            dst.device_forward = 1
            dst._fwd_cache.clear()
            np.testing.assert_allclose(dst.predict_all(tds), src.predict_all(jds), atol=1e-5)


def test_cuda_without_card_raises():
    """device=cuda (the default) without a card raises when the trainer
    starts, never a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mt = SVDTypeParam(format_type=svd_type.USER_GROUP_FORMAT, extend_type=31)
    tr = create_gbrt_trainer(mt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.init_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.init_trainer()


CLI_CONF = "".join(f"{k} = {v}\n" for k, v in BASE.items()) + "silent = 1\ninput_type = 1\n"


@pytest.mark.parametrize("et,extra", [
    pytest.param(31, [], id="reg"),
    pytest.param(30, ["active_type=3", "lambda_ap_alpha=0.5", "lambda_ap_reject=1"],
                 id="aplambda"),
    pytest.param(31, ["device_forward=1"], id="reg-device_forward1"),
])
def test_cli_matches_jax(jx, et, extra, tmp_path):
    """SVDTrainTask (3 rounds) and SVDInferTask eval through both packages'
    entry points on the same text files: every checkpoint byte for byte,
    the eval log equal (with device_forward=1, the walks on the CPU of
    both packages, within the log's 1e-6 rounding plus 1e-6)."""
    rows, fb = gbrt_text()
    (tmp_path / "d.txt").write_text(rows)
    (tmp_path / "d.fb").write_text(fb)
    logs, models = {}, {}
    for tag, train_cls, infer_cls, dev in (("jax", jx.Train, jx.Infer, []),
                                           ("torch", TTrain, TInfer, ["device=cpu"])):
        d = tmp_path / tag
        conf = tmp_path / f"{tag}.conf"
        conf.write_text(CLI_CONF + f'extend_type = {et}\ndata_in = "{tmp_path}/d.txt"\n'
                        f'feedback_in = "{tmp_path}/d.fb"\ntest:input_type = 1\n'
                        f'test:data_in = "{tmp_path}/d.txt"\ntest:feedback_in = "{tmp_path}/d.fb"\n'
                        f'model_out_folder = "{d}"\n')
        task = train_cls()
        task.run(str(conf), ["num_round=3", *extra, *dev])
        assert type(task.trainer).__name__ == ("APLambdaGBRTTrainer" if et == 30
                                               else "RegGBRTTrainer")
        log = tmp_path / f"{tag}.tsv"
        infer_cls().run(str(conf), ["start=1", "end=4", f"log_eval={log}", *extra, *dev])
        logs[tag] = log.read_text()
        models[tag] = [(d / f"{r:04d}.model").read_bytes() for r in range(4)]
    assert models["torch"] == models["jax"]
    if "device_forward=1" in extra:
        got = [float(line.split()[1]) for line in logs["torch"].splitlines()]
        want = [float(line.split()[1]) for line in logs["jax"].splitlines()]
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    else:
        assert logs["torch"] == logs["jax"] and len(logs["jax"].splitlines()) == 3


# ---- the golden ------------------------------------------------------------------

def _fixture_text(name):
    with gzip.open(FIXTURES / name, "rt") as f:
        return f.read()


def test_golden_first_rounds():
    """golden/gbrt_reg.rmse.tsv (the reference binary, extend_type=31 on the
    implicitFeedback workload): the port's first two rounds at the
    parameters of tests/test_golden_full.py:191-220, within 5e-6."""
    from svdfeature_tpu_torch.solvers.registry import create_svd_trainer

    train_ds = load_plus_text("x", "y", text=_fixture_text("ml100k.base.group.feature.gz"),
                              feedback_text=_fixture_text("ml100k.base.feedback.gz"))
    test_ds = load_plus_text("x", "y", text=_fixture_text("ml100k.test.ug.feature.gz"),
                             feedback_text=_fixture_text("ml100k.test.feedback.gz"))
    p = dict(base_score=3, learning_rate=0.3, wd_item=0.004, wd_user=0.004, num_item=1682,
             num_user=943, num_global=0, num_factor=64, format_type=1, num_ufeedback=1682,
             wd_ufeedback=0.004, extend_type=31, num_spec_sparse=943, min_split_loss=1,
             min_split_instance=100, min_child_instance=20, min_child_weight=5,
             min_split_weight=10, max_depth=5, rt_loss_type=1, device="cpu")
    mt = SVDTypeParam()
    for n, v in p.items():
        mt.set_param(n, str(v))
    mt.decide_format()
    tr = create_svd_trainer(mt)
    for n, v in p.items():
        tr.set_param(n, str(v))
    tr.init_model()
    tr.init_trainer()
    want = [float(line.split()[1]) for line in
            (ROOT / "golden" / "gbrt_reg.rmse.tsv").read_text().splitlines()]
    labels = test_ds.rows.labels
    for r in range(2):
        train_round(tr, train_ds, r)
        d = tr.predict_all(test_ds) - labels
        got = float(np.sqrt(np.mean(d * d)))
        assert abs(got - want[r]) < 5e-6, (r + 1, got, want[r])


# ---- the card ------------------------------------------------------------------

@pytest.mark.cuda
def test_card_walk_matches_host_walk():
    """The torch walk on the card against the host walk (1e-5), a 5-tree
    RegGBRT trained on the CPU; the walk counts one card walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m cuda tests/)")
    rows, fb = gbrt_text(weights=True)
    ds = load_plus_text("x", "y", text=rows, feedback_text=fb)
    mt = SVDTypeParam(format_type=svd_type.USER_GROUP_FORMAT, extend_type=31)
    for k, v in dict(BASE, **OPTIONS["num_root_weight"]).items():
        mt.set_param(k, str(v))
    tr = create_gbrt_trainer(mt)
    for k, v in dict(BASE, device="cuda", **OPTIONS["num_root_weight"]).items():
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    train(tr, ds, 5)
    tr.device_forward = 0
    tr._fwd_cache.clear()
    host = tr.forward_all(ds)
    tr.device_forward = -1
    tr._fwd_cache.clear()
    before = gbrt_forward.forward_trees.walks
    card = tr.forward_all(ds)
    assert gbrt_forward.forward_trees.walks - before == 1
    np.testing.assert_allclose(card, host, atol=1e-5, rtol=1e-5)
