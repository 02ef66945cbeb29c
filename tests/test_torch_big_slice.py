"""The big-table slice, both packages, through their user entry points.

make_feature_buffer -> SVDTrainTask (3 rounds) -> %04d.model per round ->
SVDInferTask (log_eval on the first 200 training rows) on a synthetic
table of 10,001 rows (5,000 users, 5,000 items and the dummy: above the
8192 rows where both solvers switch to the big-table route), k=8, 600
training examples, batch_size=128, with
``big_sweep=0`` (sorted dedup) and ``big_sweep=1`` (tile sweep; the JAX
package runs its Pallas kernel in interpret mode).  The port runs with
device=cpu.  Every checkpoint agrees with the JAX package's (w / b / g
atol 1e-6) and keeps the standard byte layout (same size, same header,
readable by the JAX package), and so does every round's test RMSE (1e-6).
"""

import numpy as np
import pytest

from svdfeature_tpu.cli import make_feature_buffer as jbuf_cli
from svdfeature_tpu.infer.task import SVDInferTask as JInfer
from svdfeature_tpu.model import SVDModel as JModel
from svdfeature_tpu.params import SVDModelParam, SVDTypeParam
from svdfeature_tpu.train.loop import SVDTrainTask as JTrain
from svdfeature_tpu_torch.cli import make_feature_buffer as tbuf_cli
from svdfeature_tpu_torch.infer.task import SVDInferTask as TInfer
from svdfeature_tpu_torch.ops import cuda_scatter, cuda_sweep
from svdfeature_tpu_torch.train.loop import SVDTrainTask as TTrain

ROUNDS = 3
NU = NI = 5000


def _write_feature(path, n, seed):
    """n rated (user, item) pairs with a planted rank-2 structure."""
    rng = np.random.RandomState(seed)
    pu = rng.normal(0, 0.7, (NU, 2))
    qi = rng.normal(0, 0.7, (NI, 2))
    u = rng.randint(0, NU, n)
    i = rng.randint(0, NI, n)
    r = np.clip(np.rint(3 + (pu[u] * qi[i]).sum(1)), 1, 5)
    path.write_text("".join(f"{int(a)} 0 1 1 {b}:1 {c}:1\n" for a, b, c in zip(r, u, i)))


def _read_model(path):
    with open(path, "rb") as f:
        m = JModel.load(f, SVDTypeParam.from_bytes(f.read(4)))
    return {k: np.asarray(getattr(m, k)) for k in ("w", "b", "g")}


@pytest.mark.parametrize("big_sweep", [0, 1])
def test_big_slice_matches_jax(big_sweep, tmp_path):
    _write_feature(tmp_path / "train.feature", 600, 0)
    # the probe is the first 200 training rows, as in bench.py's bigTable
    lines = (tmp_path / "train.feature").read_text().splitlines(keepends=True)
    (tmp_path / "test.feature").write_text("".join(lines[:200]))
    out = {}
    for tag, buf_cli, train_cls, infer_cls, dev in (
        ("jax", jbuf_cli, JTrain, JInfer, []),
        ("torch", tbuf_cli, TTrain, TInfer, ["device=cpu"]),
    ):
        d = tmp_path / tag
        d.mkdir()
        for split in ("train", "test"):
            buf_cli.main([str(tmp_path / f"{split}.feature"), str(d / f"{split}.buffer")])
        conf = d / "big.conf"
        conf.write_text(
            "base_score = 3\nlearning_rate = 0.05\nwd_user = 0.004\nwd_item = 0.004\n"
            "wd_item_bias = 0.002\n"
            f"num_user = {NU}\nnum_item = {NI}\nnum_factor = 8\nactive_type = 0\n"
            f'buffer_feature = "{d}/train.buffer"\ntest:buffer_feature = "{d}/test.buffer"\n'
            f'model_out_folder = "{d}/models"\nbatch_size = 128\nbig_sweep = {big_sweep}\n'
            "silent = 1\n"
        )
        before = (cuda_scatter.row_writer.launches, cuda_sweep.sweep_update.launches)
        task = train_cls()
        task.run(str(conf), [f"num_round={ROUNDS}", *dev])
        assert task.trainer.hp.big_table and task.trainer.hp.sweep_table == bool(big_sweep)
        infer_cls().run(str(conf), ["start=0", f"end={ROUNDS + 1}",
                                    f"log_eval={d}/rmse.tsv", *dev])
        # CPU: the plain versions, no launches
        assert (cuda_scatter.row_writer.launches, cuda_sweep.sweep_update.launches) == before
        out[tag] = dict(
            models=[_read_model(d / "models" / f"{r:04d}.model") for r in range(ROUNDS + 1)],
            raw=[(d / "models" / f"{r:04d}.model").read_bytes() for r in range(ROUNDS + 1)],
            rmse=np.loadtxt(d / "rmse.tsv"),
        )
    assert out["torch"]["rmse"].shape == (ROUNDS + 1, 2)
    np.testing.assert_allclose(out["torch"]["rmse"], out["jax"]["rmse"], atol=1e-6, rtol=0)
    for r in range(ROUNDS + 1):
        t, j = out["torch"]["raw"][r], out["jax"]["raw"][r]
        # the standard layout: mtype + SVDModelParam header, then the
        # user / item tables at their published shapes
        head = 4 + SVDModelParam.NBYTES
        assert len(t) == len(j) and t[:head] == j[:head]
        for k in ("w", "b", "g"):
            np.testing.assert_allclose(out["torch"]["models"][r][k], out["jax"]["models"][r][k],
                                       atol=1e-6, rtol=0, err_msg=f"round {r} {k}")
    assert out["torch"]["models"][-1]["w"].shape == (NU + NI, 8)
    # it trained, and the test RMSE improved on the init
    assert out["torch"]["rmse"][-1, 1] < out["torch"]["rmse"][0, 1]


@pytest.mark.parametrize("big_sweep", [0, 1])
def test_big_update_rounds_matches_jax(big_sweep, tmp_path):
    """update_rounds on a big table (3 rounds in one call, the lr decay
    schedule on the host) and predict_all on the de-augmented state,
    against the JAX trainer's, with lazy L2 (reg_method 4)."""
    from svdfeature_tpu.data.text import load_feature_text as jload
    from svdfeature_tpu.params import SVDTypeParam as JType
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer as JTrainer
    from svdfeature_tpu_torch.data.text import load_feature_text as tload
    from svdfeature_tpu_torch.params import SVDTypeParam as TType
    from svdfeature_tpu_torch.solvers.base import SVDFeatureTrainer as TTrainer

    _write_feature(tmp_path / "train.feature", 500, 2)
    text = (tmp_path / "train.feature").read_text()
    params = [("num_user", str(NU)), ("num_item", str(NI)), ("num_factor", "4"),
              ("base_score", "3"), ("learning_rate", "0.05"), ("wd_user", "0.004"),
              ("wd_item", "0.004"), ("reg_method", "4"), ("decay_learning_rate", "1"),
              ("decay_rate", "0.9"), ("batch_size", "100"), ("big_sweep", str(big_sweep)),
              ("device", "cpu")]
    out = {}
    for tag, trainer_cls, mtype, load in (("jax", JTrainer, JType(), jload),
                                          ("torch", TTrainer, TType(), tload)):
        tr = trainer_cls(mtype)
        for k, v in params:
            tr.set_param(k, v)
        tr.init_model()
        tr.init_trainer()
        assert tr.hp.big_table and tr.hp.sweep_table == bool(big_sweep)
        ds = load("x", text=text)
        tr.update_rounds(ds, 3)
        pred = np.asarray(tr.predict_all(ds))
        st = tr._std_state()
        out[tag] = dict(pred=pred, lr=tr.learning_rate, step=int(st.step),
                        ref=np.asarray(st.ref_ui)[: NU + NI],
                        **{k: np.asarray(getattr(st, k))[: NU + NI] for k in ("w", "b")})
    assert out["torch"]["lr"] == pytest.approx(out["jax"]["lr"])
    assert out["torch"]["step"] == out["jax"]["step"] == 3 * 500
    np.testing.assert_array_equal(out["torch"]["ref"], out["jax"]["ref"])
    for k in ("w", "b", "pred"):
        np.testing.assert_allclose(out["torch"][k], out["jax"][k], atol=1e-6, rtol=0, err_msg=k)


def test_wide_rows_sweep_trainer_matches_jax(monkeypatch, tmp_path):
    """A base trainer on the 10,001-row table at k=300 with big_sweep=1:
    rows wider than the 256 columns K4 holds in one pass.  Two rounds of
    update_all and predict_all equal the JAX trainer's (its sweep kernel
    in interpret mode) within 1e-5, the ref bits exactly, and K4's checks
    take every call the route makes (the wrapper checks them on the card
    only, so each call is checked here as it would be there)."""
    from svdfeature_tpu.data.text import load_feature_text as jload
    from svdfeature_tpu.params import SVDTypeParam as JType
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer as JTrainer
    from svdfeature_tpu_torch.data.text import load_feature_text as tload
    from svdfeature_tpu_torch.params import SVDTypeParam as TType
    from svdfeature_tpu_torch.solvers.base import SVDFeatureTrainer as TTrainer

    calls = []
    wrapper = cuda_sweep.sweep_update

    def checked(w, *args):
        cuda_sweep._check(w, *args)
        calls.append(args[-1].num_factor)
        return wrapper(w, *args)

    monkeypatch.setattr(cuda_sweep, "sweep_update", checked)
    _write_feature(tmp_path / "train.feature", 300, 3)
    text = (tmp_path / "train.feature").read_text()
    k = 300
    params = [("num_user", str(NU)), ("num_item", str(NI)), ("num_factor", str(k)),
              ("base_score", "3"), ("learning_rate", "0.05"), ("wd_user", "0.004"),
              ("wd_item", "0.004"), ("batch_size", "100"), ("big_sweep", "1"),
              ("device", "cpu")]
    out = {}
    for tag, trainer_cls, mtype, load in (("jax", JTrainer, JType(), jload),
                                          ("torch", TTrainer, TType(), tload)):
        tr = trainer_cls(mtype)
        for name, v in params:
            tr.set_param(name, v)
        tr.init_model()
        tr.init_trainer()
        assert tr.hp.big_table and tr.hp.sweep_table
        ds = load("x", text=text)
        for _ in range(2):
            tr.update_all(ds)
        st = tr._std_state()
        out[tag] = dict(pred=np.asarray(tr.predict_all(ds)), ref=np.asarray(st.ref_ui)[: NU + NI],
                        **{name: np.asarray(getattr(st, name))[: NU + NI] for name in ("w", "b")})
    assert calls == [k] * 6  # 3 steps a round, every one through K4's wrapper
    assert out["torch"]["w"].shape == (NU + NI, k)
    np.testing.assert_array_equal(out["torch"]["ref"], out["jax"]["ref"])
    for name in ("w", "b", "pred"):
        np.testing.assert_allclose(out["torch"][name], out["jax"][name], atol=1e-5, rtol=0,
                                   err_msg=name)
