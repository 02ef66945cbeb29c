"""The whole slice, both packages, through their user entry points.

make_feature_buffer -> SVDTrainTask -> %04d.model per round ->
SVDInferTask (log_eval), on the first 10k rows of ML-100K (basicMF and
neighborhoodModel confs, num_factor=16, batch_size=1024, 3 rounds; and
basicMF's random-order buffer, format_type=0, under extend_type=1 and
extend_type=2, 2 rounds, which both packages train and predict on the base
solver).  The
port runs with device=cpu (its kernel path takes the plain version
there).  Every checkpoint agrees (w/b/g atol 1e-5) and so does every
round's eval RMSE (1e-5).
"""

import gzip
import io
import pathlib

import numpy as np
import pytest

from svdfeature_tpu.cli import make_feature_buffer as jbuf_cli
from svdfeature_tpu.infer.task import SVDInferTask as JInfer
from svdfeature_tpu.model import SVDModel as JModel
from svdfeature_tpu.params import SVDTypeParam
from svdfeature_tpu.train.loop import SVDTrainTask as JTrain
from svdfeature_tpu_torch.cli import make_feature_buffer as tbuf_cli
from svdfeature_tpu_torch.infer.task import SVDInferTask as TInfer
from svdfeature_tpu_torch.ops import cuda_embed
from svdfeature_tpu_torch.train.loop import SVDTrainTask as TTrain

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
ROUNDS = 3
CONFS = {
    "basicMF": ("ml100k.base.feature.gz", "ml100k.test.feature.gz",
                "base_score = 3\nactive_type = 0\nnum_global = 0\n"),
    "neighborhoodModel": ("ml100k.base.nb.feature.gz", "ml100k.test.nb.feature.gz",
                          "base_score = 3\nactive_type = 0\nnum_global = 6\nwd_global = 0.001\n"),
    "binaryClassification": ("ml100k.base.bin.feature.gz", "ml100k.test.bin.feature.gz",
                             "base_score = 0.5\nnum_global = 0\n"),
}


def _head(name, n, dst):
    with gzip.open(FIXTURES / name, "rt") as f:
        dst.write_text("".join(line for _, line in zip(range(n), f)))


def _read_model(path):
    with open(path, "rb") as f:
        m = JModel.load(f, SVDTypeParam.from_bytes(f.read(4)))
    return {k: np.asarray(getattr(m, k)) for k in ("w", "b", "g")}


SLICE_CASES = [pytest.param(demo, 0, ROUNDS, "", id=demo)
               for demo in ("basicMF", "neighborhoodModel")] + [
    # extend_type=1 / 2 on a random-order buffer: the SVD++ and multi-IMFB
    # trainers hand it to the base solver, as the JAX package's do
    pytest.param("basicMF", et, 2, "", id=f"basicMF-extend_type{et}") for et in (1, 2)
] + [
    # the general route: configurations K1 does not take train on the plain
    # rounds whatever use_pallas says, as the JAX package's jnp path does
    pytest.param(demo, 0, 2, f"{key} = {val}\nuse_pallas = {up}\n",
                 id=f"{demo}-{key}{val}-use_pallas{up}")
    for demo, key, val in (("basicMF", "reg_method", 4), ("binaryClassification", "active_type", 5))
    for up in (0, 1)
]


@pytest.mark.parametrize("demo,extend_type,rounds,more", SLICE_CASES)
def test_slice_matches_jax(demo, extend_type, rounds, more, tmp_path):
    train_fx, test_fx, extra = CONFS[demo]
    extra += more
    if extend_type:  # format_type 0: the random-order format, not auto-detected
        extra += f"extend_type = {extend_type}\nformat_type = 0\n"
    _head(train_fx, 10000, tmp_path / "train.feature")
    _head(test_fx, 2000, tmp_path / "test.feature")
    out = {}
    for tag, buf_cli, train_cls, infer_cls, dev in (
        ("jax", jbuf_cli, JTrain, JInfer, []),
        ("torch", tbuf_cli, TTrain, TInfer, ["device=cpu"]),
    ):
        d = tmp_path / tag
        d.mkdir()
        for split in ("train", "test"):
            buf_cli.main([str(tmp_path / f"{split}.feature"), str(d / f"{split}.buffer")])
        conf = d / f"{demo}.conf"
        conf.write_text(
            "learning_rate = 0.005\nwd_user = 0.004\nwd_item = 0.004\n"
            f"num_user = 943\nnum_item = 1682\nnum_factor = 16\n{extra}"
            f'buffer_feature = "{d}/train.buffer"\ntest:buffer_feature = "{d}/test.buffer"\n'
            f'model_out_folder = "{d}/models"\nbatch_size = 1024\nsilent = 1\n'
        )
        before = cuda_embed.train_rounds_kernel.launches
        task = train_cls()
        task.run(str(conf), [f"num_round={rounds}", *dev])
        infer_cls().run(str(conf), ["start=0", f"end={rounds + 1}",
                                    f"log_eval={d}/rmse.tsv", *dev])
        assert cuda_embed.train_rounds_kernel.launches == before  # CPU: plain version
        rmse = np.loadtxt(d / "rmse.tsv")
        out[tag] = dict(
            models=[_read_model(d / "models" / f"{r:04d}.model") for r in range(rounds + 1)],
            rmse=rmse, trainer=type(task.trainer).__name__,
        )
    assert out["torch"]["trainer"] == out["jax"]["trainer"] == {
        0: "SVDFeatureTrainer", 1: "SVDPPFeatureTrainer", 2: "SVDPPMultiIMFBTrainer"}[extend_type]
    assert out["torch"]["rmse"].shape == (rounds + 1, 2)
    np.testing.assert_allclose(out["torch"]["rmse"], out["jax"]["rmse"], atol=1e-5, rtol=0)
    for r in range(rounds + 1):
        for k in ("w", "b", "g"):
            np.testing.assert_allclose(out["torch"]["models"][r][k], out["jax"]["models"][r][k],
                                       atol=1e-5, rtol=0, err_msg=f"round {r} {k}")
    # it trained, and the eval improved on the init
    assert out["torch"]["rmse"][-1, 1] < out["torch"]["rmse"][0, 1]
    if demo == "neighborhoodModel":
        assert np.abs(out["torch"]["models"][-1]["g"]).max() > 0


def test_cuda_device_without_card_raises():
    """device=cuda (the default) on a host without a card is an error,
    never a silent CPU run."""
    import torch

    from svdfeature_tpu_torch.params import SVDTypeParam as TType
    from svdfeature_tpu_torch.solvers.base import SVDFeatureTrainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tr = SVDFeatureTrainer(TType())
    for k, v in (("num_user", "3"), ("num_item", "4"), ("num_factor", "2")):
        tr.set_param(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.init_model()


@pytest.mark.parametrize("key,val,item", [
    # the bilinear solver, which trains now: on random-order data, the base solver
    pytest.param("extend_type", "15", None, id="extend_type-15-item 10"),
    # APLambda GBRT, which trains now: the user-group format, as in JAX
    pytest.param("extend_type", "30", None, id="extend_type-30-item 10"),
    # the base solver's mesh, which trains now: outside a torchrun world of
    # mesh_data * mesh_model ranks it is a ValueError naming torchrun
    pytest.param("mesh_data", "2", "torchrun", id="mesh_data-2-item 12"),
])
def test_outside_the_slice_raises_with_roadmap_item(key, val, item, tmp_path):
    """Configurations the port does not run yet raise NotImplementedError
    naming their ROADMAP item instead of training something else (a mesh
    outside a torchrun world, ValueError naming torchrun); the
    bilinear solver (``item`` None) trains random-order data on the base
    solver, as the JAX package does, and saves its BModel section; APLambda
    GBRT reads the text as user-group data (one block a user, the user id
    its spec-sparse feature, the item id its root) and writes the JAX CLI's
    checkpoints byte for byte."""
    feat = tmp_path / "train.feature"
    feat.write_text("".join(f"{i % 5 + 1} 0 1 1 {i % 7}:1 {i % 11}:1\n" for i in range(40)))
    conf = tmp_path / "t.conf"
    conf.write_text(
        f'input_type = 1\ndata_in = "{feat}"\nnum_user = 7\nnum_item = 11\n'
        f'num_factor = 4\nbase_score = 0.5\nbatch_size = 8\nsilent = 1\n'
        f'model_out_folder = "{tmp_path}/m"\n'
    )
    args = ["num_round=1", "device=cpu", f"{key}={val}"]
    if item is not None:
        with pytest.raises(ValueError if item == "torchrun" else NotImplementedError, match=item):
            TTrain().run(str(conf), args)
        return
    if val == "30":
        # the same rows a user at a time: one block each, pairs inside it
        lines = feat.read_text().splitlines(keepends=True)
        feat.write_text("".join(sorted(lines, key=lambda line: int(line.split()[4][:-2]))))
        gbrt = ["num_spec_sparse=7", "scale_score=5", "active_type=3", "min_split_instance=2",
                "min_child_instance=1", "min_split_weight=0.1", "min_child_weight=0.05"]
        TTrain().run(str(conf), ["num_round=2", "device=cpu", f"{key}={val}", *gbrt])
        port = [(tmp_path / "m" / f"{r:04d}.model").read_bytes() for r in range(3)]
        task = JTrain()
        task.run(str(conf), ["num_round=2", f"{key}={val}", *gbrt])
        assert type(task.trainer).__name__ == "APLambdaGBRTTrainer"
        assert len(task.trainer.trees) == 2
        assert np.any(np.asarray(task.trainer.trees[1].tree.split_value) != 0)
        assert port == [(tmp_path / "m" / f"{r:04d}.model").read_bytes() for r in range(3)]
        return
    task = TTrain()
    task.run(str(conf), args)
    tr = task.trainer
    assert type(tr).__name__ == "SVDBiLinearTrainer" and tuple(tr.W_bi.shape) == (12, 0)
    with open(tmp_path / "m" / "0001.model", "rb") as f:
        raw = f.read()
    assert raw.endswith(b"\0" * 128 + (0).to_bytes(4, "little") + (11).to_bytes(4, "little"))
    assert np.isfinite(tr.state.w.numpy()).all() and int(tr.state.step) == 40


@pytest.mark.parametrize("key,val", [
    ("reg_method", "1"), ("active_type", "5"), ("user_nonnegative", "1"),
    ("item_nonnegative", "1"), ("reg_global", "5"), ("active_type", "6")])
def test_once_refused_configs_train_as_jax(key, val, tmp_path):
    """Configurations the port refused before the general step train, on
    the CPU and whatever use_pallas says, to the JAX CLI's checkpoint (one
    round of the tiny text set, atol 1e-6)."""
    feat = tmp_path / "train.feature"
    feat.write_text("".join(f"{i % 5 + 1} 1 1 1 {i % 3}:0.5 {i % 7}:1 {i % 11}:1\n"
                            for i in range(40)))
    models = {}
    for tag, train_cls, dev in (("jax", JTrain, []), ("torch", TTrain, ["device=cpu"])):
        conf = tmp_path / f"{tag}.conf"
        conf.write_text(
            f'input_type = 1\ndata_in = "{feat}"\nnum_user = 7\nnum_item = 11\n'
            f'num_global = 3\nwd_global = 0.01\nwd_user = 0.02\nwd_item = 0.03\n'
            f'num_factor = 4\nbase_score = 0.5\nbatch_size = 8\nsilent = 1\n'
            f'model_out_folder = "{tmp_path}/m_{tag}"\n'
        )
        train_cls().run(str(conf), ["num_round=1", f"{key}={val}", *dev])
        models[tag] = _read_model(tmp_path / f"m_{tag}" / "0001.model")
    for k in ("w", "b", "g"):
        np.testing.assert_allclose(models["torch"][k], models["jax"][k], atol=1e-6, rtol=0,
                                   err_msg=k)
    assert not np.allclose(models["torch"]["w"], _read_model(tmp_path / "m_torch" / "0000.model")["w"])


@pytest.mark.parametrize("extend_type", [
    pytest.param(0, id="base"), pytest.param(1, id="extend_type1"),
    pytest.param(2, id="extend_type2")])
def test_update_rounds_matches_jax(extend_type, tmp_path):
    """update_rounds (R rounds in one wrapper call, the lr decay schedule
    built on the host) against the JAX trainer's update_rounds, then
    predict_all; the CLI path above covers update_all.  The SVD++ and
    multi-IMFB trainers (extend_type 1, 2) take a random-order dataset to
    the base solver in both packages."""
    from svdfeature_tpu.data.text import load_feature_text as jload
    from svdfeature_tpu.params import SVDTypeParam as JType
    from svdfeature_tpu.solvers.registry import create_svd_trainer as jcreate
    from svdfeature_tpu_torch.data.text import load_feature_text as tload
    from svdfeature_tpu_torch.params import SVDTypeParam as TType
    from svdfeature_tpu_torch.solvers.registry import create_svd_trainer as tcreate

    _head("ml100k.base.nb.feature.gz", 6000, tmp_path / "train.feature")
    text = (tmp_path / "train.feature").read_text()
    params = [("num_user", "943"), ("num_item", "1682"), ("num_global", "6"),
              ("num_factor", "8"), ("base_score", "3"), ("learning_rate", "0.01"),
              ("wd_user", "0.004"), ("wd_item", "0.004"), ("wd_global", "0.001"),
              ("wd_item_bias", "0.002"), ("decay_learning_rate", "1"),
              ("decay_rate", "0.9"), ("batch_size", "512"), ("device", "cpu")]
    out = {}
    for tag, create, mtype, load in (("jax", jcreate, JType(extend_type=extend_type), jload),
                                     ("torch", tcreate, TType(extend_type=extend_type), tload)):
        tr = create(mtype)
        for k, v in params:
            tr.set_param(k, v)
        tr.init_model()
        tr.init_trainer()
        ds = load("x", text=text)
        tr.update_rounds(ds, 3)
        pred = np.asarray(tr.predict_all(ds))
        st = tr.state
        out[tag] = dict(pred=pred, lr=tr.learning_rate, step=int(st.step), cls=type(tr).__name__,
                        **{k: np.asarray(getattr(st, k)) for k in ("w", "b", "g")})
    assert out["torch"]["cls"] == out["jax"]["cls"]
    assert out["torch"]["lr"] == pytest.approx(out["jax"]["lr"])
    assert out["torch"]["step"] == out["jax"]["step"] == 3 * 6000
    for k in ("w", "b", "g", "pred"):
        np.testing.assert_allclose(out["torch"][k], out["jax"][k], atol=1e-5, rtol=0,
                                   err_msg=k)
