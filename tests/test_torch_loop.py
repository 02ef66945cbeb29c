"""The train loop's keys (``log_jsonl``, ``debug_checks``, ``profile_dir``),
``register_trainer`` and the lite example solver (extend_type 99) in the
port, against the JAX package's (svdfeature_tpu/train/loop.py:65-79,
166-235; solvers/registry.py:13-24; solvers/example.py).

A tiny synthetic random-order set (the rows of tests/test_sharding.py) is
written as a buffer and trained through both packages' SVDTrainTask; the
port runs with device=cpu.
"""

import json
import math

import numpy as np
import pytest
import torch

from svdfeature_tpu_torch.data.buffer import write_csr_buffer
from svdfeature_tpu_torch.data.text import load_feature_text
from svdfeature_tpu_torch.params import SVDTypeParam
from svdfeature_tpu_torch.solvers import registry
from svdfeature_tpu_torch.solvers.base import SVDFeatureTrainer
from svdfeature_tpu_torch.train.loop import SVDTrainTask

PARAMS = dict(num_user=29, num_item=37, num_factor=8, base_score=3, learning_rate=0.01,
              wd_user=0.004, wd_item=0.004, batch_size=32, decay_learning_rate=1,
              decay_rate=0.9)
ROUNDS = 3


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported here, not at the top."""
    pytest.importorskip("jax")
    from svdfeature_tpu.params import SVDTypeParam as JType
    from svdfeature_tpu.solvers import registry as jregistry
    from svdfeature_tpu.train.loop import SVDTrainTask as JTrain

    return dict(Train=JTrain, Type=JType, registry=jregistry)


@pytest.fixture(scope="module")
def conf(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop")
    text = "\n".join(f"{(i % 5) + 1} 0 1 1 {i % 29}:1 {(i * 7) % 37}:1" for i in range(200))
    write_csr_buffer(str(d / "train.buffer"), load_feature_text("x", text=text), batch_size=64)
    path = d / "loop.conf"
    path.write_text("".join(f"{k} = {v}\n" for k, v in PARAMS.items())
                    + f'buffer_feature = "{d}/train.buffer"\n')
    return path


def _run(task, conf, tag, *extra, device=True):
    args = [f"model_out_folder={conf.parent}/models_{tag}", f"num_round={ROUNDS}", "silent=1",
            *extra]
    task.run(str(conf), args + (["device=cpu"] if device else []))
    return task


def test_log_jsonl_has_jax_fields(conf, jx, tmp_path):
    """One JSON line a round with JAX's fields; the round, example count and
    learning rate equal the JAX loop's, the times are positive."""
    lines = {}
    for tag, task, device in (("jax", jx["Train"](), False), ("torch", SVDTrainTask(), True)):
        log = tmp_path / f"{tag}.jsonl"
        _run(task, conf, f"log_{tag}", f"log_jsonl={log}", device=device)
        lines[tag] = [json.loads(x) for x in log.read_text().splitlines()]
    assert len(lines["torch"]) == ROUNDS
    for got, want in zip(lines["torch"], lines["jax"]):
        assert set(got) == set(want) == {"round", "elapsed_s", "round_s", "examples",
                                         "learning_rate"}
        assert (got["round"], got["examples"]) == (want["round"], want["examples"])
        assert math.isclose(got["learning_rate"], want["learning_rate"], rel_tol=1e-12)
        assert got["elapsed_s"] >= got["round_s"] >= 0


def _poison_after_first_update(monkeypatch, cls, poison):
    original = cls.update_all

    def update_all(self, ds):
        original(self, ds)
        self.state = poison(self.state)

    monkeypatch.setattr(cls, "update_all", update_all)


def test_debug_checks_raise_on_nan(conf, jx, monkeypatch):
    """debug_checks=1: a NaN in w after a round raises FloatingPointError
    with the JAX loop's message, in both packages; without the key the
    round ends and the checkpoint is written."""
    import dataclasses

    from svdfeature_tpu.solvers.base import SVDFeatureTrainer as JBase

    def poison_torch(st):
        st.w[0, 0] = float("nan")
        return st

    def poison_jax(st):
        return dataclasses.replace(st, w=st.w.at[0, 0].set(float("nan")))

    _poison_after_first_update(monkeypatch, SVDFeatureTrainer, poison_torch)
    _poison_after_first_update(monkeypatch, JBase, poison_jax)
    messages = []
    for task, device in ((jx["Train"](), False), (SVDTrainTask(), True)):
        with pytest.raises(FloatingPointError) as err:
            _run(task, conf, "nan", "debug_checks=1", device=device)
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "non-finite values in model.w after round 0"
    task = _run(SVDTrainTask(), conf, "nan_unchecked")
    assert not torch.isfinite(task.trainer.state.w).all()
    assert (conf.parent / "models_nan_unchecked" / f"{ROUNDS:04d}.model").exists()


def test_profile_dir_writes_a_trace(conf, tmp_path):
    """profile_dir: torch.profiler over the first trained round, written as
    a Chrome trace that holds the round's operators."""
    prof = tmp_path / "prof"
    _run(SVDTrainTask(), conf, "prof", f"profile_dir={prof}")
    traces = list(prof.glob("*.json"))
    assert [t.name for t in traces] == ["round0.rank0.pt.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("index_add" in e.get("name", "") for e in events)


def test_print_ratio_is_parsed_and_unused(conf):
    """print_ratio is parsed, as in JAX, and changes nothing."""
    task = SVDTrainTask()
    task.configure(str(conf), ["print_ratio=0.5", "device=cpu"])
    assert task.print_ratio == 0.5


def test_register_trainer_takes_precedence(monkeypatch, jx):
    """A registered extend_type is looked up before the built-in solvers,
    in both packages (a factory under 0 replaces the base solver)."""

    class Custom(SVDFeatureTrainer):
        pass

    monkeypatch.setitem(registry._REGISTRY, 0, Custom)
    assert type(registry.create_svd_trainer(SVDTypeParam())) is Custom
    monkeypatch.delitem(registry._REGISTRY, 0)
    assert type(registry.create_svd_trainer(SVDTypeParam())) is SVDFeatureTrainer
    jx_reg = jx["registry"]
    monkeypatch.setitem(jx_reg._REGISTRY, 0, lambda mt: "custom")
    assert jx_reg.create_svd_trainer(jx["Type"]()) == "custom"


@pytest.mark.parametrize("num_global", [0, 3])
def test_lite_solver_matches_jax(jx, num_global):
    """extend_type 99 (solvers/example.py) after tests/test_combinators.py:
    80-110: two rounds of the port's lite trainer equal the JAX lite
    trainer's on w, b and the global biases g (rtol 1e-5, atol 1e-7).
    Without global features they also equal the base solver's, as the JAX
    test holds (with them the lite update is the simpler one)."""
    import svdfeature_tpu.solvers.example  # noqa: F401  (registers 99 in JAX)
    from svdfeature_tpu.data.text import load_feature_text as jload

    import svdfeature_tpu_torch.solvers.example as texample

    rng = np.random.RandomState(0)
    ng = 1 if num_global else 0
    text = "\n".join(
        f"{rng.randint(1, 6)} {ng} 1 1 " + (f"{rng.randint(0, num_global)}:0.5 " if ng else "")
        + f"{rng.randint(0, 10)}:1 {rng.randint(0, 20)}:1" for _ in range(200))
    params = dict(num_user=10, num_item=20, num_global=num_global, num_factor=8, base_score=3,
                  learning_rate=0.01, wd_user=0.004, wd_item=0.004)

    def make(create, mt, extra=()):
        mt.decide_format(0)
        tr = create(mt)
        for k, v in [*params.items(), *extra]:
            tr.set_param(k, str(v))
        tr.init_model()
        tr.init_trainer()
        return tr

    t_jax = make(jx["registry"].create_svd_trainer, jx["Type"](extend_type=99))
    t_lite = make(registry.create_svd_trainer, SVDTypeParam(extend_type=99), [("device", "cpu")])
    t_base = make(registry.create_svd_trainer, SVDTypeParam(), [("device", "cpu")])
    assert type(t_lite) is texample.SVDFeatureLiteTrainer
    jds, tds = jload("x", text=text), load_feature_text("x", text=text)
    for _ in range(2):
        t_jax.update_all(jds)
        t_lite.update_all(tds)
        t_base.update_all(tds)
    refs = {"jax": t_jax.state} if num_global else {"jax": t_jax.state, "base": t_base.state}
    assert t_lite.state.g.shape == (num_global + 1,)
    for key in ("w", "b", "g"):  # the dummy row, last, excluded
        got = getattr(t_lite.state, key).numpy()[:-1]
        for ref, st in refs.items():
            np.testing.assert_allclose(got, np.asarray(getattr(st, key))[:-1], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{ref}/{key}")
    assert int(t_lite.state.step) == int(t_jax.state.step)
