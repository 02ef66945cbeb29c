"""The base solver on a device mesh in the port (parallel/comm.py,
parallel/mesh.py, parallel/mesh_big.py and the trainer's mesh path)
against the JAX package (tests/test_sharding.py, tests/test_mesh_big.py,
tests/test_multiprocess.py).

One torchrun world of WORLD = 4 gloo ranks on the CPU runs every case in
one launch (the module fixture ``world``; this file run as a script is a
rank's program).  Each case builds its inputs with numpy from a seed
(``toy``), runs the port's per-rank functions on a sub-mesh of the world
(``make_mesh(..., ranks=...)``), unshards the result on every data row of
the mesh and saves it per rank; the tests hand the same inputs to the JAX
package's mesh step on the 8-device CPU mesh of tests/conftest.py and to
its single-device step.  Tolerances: rtol 2e-5 + atol 1e-6 for one step
or a mesh against the JAX mesh (tests/test_sharding.py:48-50: psum and
``index_add_`` sum in another order than XLA), rtol 1e-4 + atol 1e-5 for
several steps against the single-device trajectory (tests/test_sharding.py:
94-96), 1e-5 for checkpoints after rounds.  The data copies of each model
shard must be equal bit for bit: every replica applies the same gathered
updates.  The world also drives the CLI (train, resume, pred, eval; small
and big slabs), a streamed mesh run, and the two solvers that keep no
shards under the mesh keys: the lite example solver (extend_type 99, the
whole table on every rank) and RegGBRT (which reads no mesh key), each
writing its checkpoints from rank 0 alone.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
NU, NI, K = 29, 37, 8
SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2)]
LAYOUTS = ("small", "big")
REGS = range(6)
CLI_PARAMS = dict(num_user=NU, num_item=NI, num_factor=K, base_score=3, learning_rate=0.01,
                  wd_user=0.004, wd_item=0.004, batch_size=32)
STEP_TOL = dict(rtol=2e-5, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)


# ---- inputs, made alike by the ranks and the tests --------------------------
def toy(batch_size, num_global, seed=0):
    """numpy (state, batch, consts) of a table of NU users and NI items, k=K,
    the dummy row last: one user slot and two item slots an example (the
    second half of them padded onto the dummy with value 0), two global
    slots with ``num_global``, the last example of weight 0."""
    rng = np.random.RandomState(seed)
    n = NU + NI
    f32 = np.float32
    state = dict(
        w=np.concatenate([rng.normal(0, 0.1, (n, K)), np.zeros((1, K))]).astype(f32),
        b=np.concatenate([rng.normal(0, 0.05, n), [0.0]]).astype(f32),
        g=np.concatenate([rng.normal(0, 0.05, num_global), [0.0]]).astype(f32),
        step=np.int32(3), ref_ui=np.zeros(n + 1, np.int32),
        ref_g=np.zeros(num_global + 1, np.int32))
    B = batch_size
    S = 2 if num_global else 1
    g_idx = rng.randint(0, max(num_global, 1), (B, S)) if num_global else np.zeros((B, 1))
    g_val = rng.rand(B, S) if num_global else np.zeros((B, 1))
    i2 = NU + rng.randint(0, NI, B)
    pad = np.arange(B) >= B // 2
    batch = dict(
        label=rng.randint(1, 6, B).astype(f32),
        weight=np.where(np.arange(B) == B - 1, 0.0, 1.0).astype(f32),
        g_idx=g_idx.astype(np.int32), g_val=g_val.astype(f32),
        u_idx=rng.randint(0, NU, (B, 1)).astype(np.int32), u_val=np.ones((B, 1), f32),
        i_idx=np.stack([NU + rng.randint(0, NI, B), np.where(pad, n, i2)], 1).astype(np.int32),
        i_val=np.stack([np.ones(B), np.where(pad, 0.0, 0.5)], 1).astype(f32))
    wd_u, wd_i = np.zeros(n + 1, f32), np.zeros(n + 1, f32)
    wd_u[:NU], wd_i[NU:n] = 0.004, 0.004
    wd_g = np.zeros(num_global + 1, f32)
    wd_g[:num_global] = 0.001
    consts = dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=wd_g, wd_user_bias=f32(0.001),
                  wd_item_bias=f32(0.002))
    return state, batch, consts


def cases():
    """name -> (n_data, n_model, layout, batch_size, num_global, reg_method,
    lrs, steps): one step per mesh shape and layout, five-step trajectories
    on 2x2 for every reg mode, and three rounds of three batches with the
    prediction."""
    out = {}
    for nd, nm in SHAPES:
        for ng in (0, 5):
            for lay in LAYOUTS:
                out[f"step-{nd}x{nm}-g{ng}-{lay}"] = (nd, nm, lay, 8 * nd, ng, 0, [0.005], 1)
    for reg in REGS:
        for lay in LAYOUTS:
            out[f"traj-reg{reg}-{lay}"] = (2, 2, lay, 16, 4, reg, [0.01] * 5, 1)
    for lay in LAYOUTS:
        out[f"rounds-{lay}"] = (2, 2, lay, 16, 4, 0, [0.01, 0.009, 0.008], 3)
    return out


def cli_text(rows, seed=0):
    """tests/test_sharding.py's rows (200 of them), then seeded ones."""
    rng = np.random.RandomState(seed)
    lines = [f"{(i % 5) + 1} 0 1 1 {i % NU}:1 {(i * 7) % NI}:1" for i in range(200)]
    lines += [f"{rng.randint(1, 6)} 0 1 1 {rng.randint(0, NU)}:1 {rng.randint(0, NI)}:1"
              for _ in range(rows - 200)]
    return "\n".join(lines) + "\n"


def cli_args(d, tag, *extra):
    return [str(d / "mesh.conf"), f"model_out_folder={d}/models_{tag}", "silent=1", *extra]


MESH = ("distributed=1", "mesh_data=2", "mesh_model=2", "device=cpu")
# the lite example solver (extend_type 99) on tests/test_torch_loop.py::
# test_lite_solver_matches_jax's data with 3 global features; batch 7,
# which a 2-position data axis rounds up to 8
LITE_PARAMS = dict(num_user=10, num_item=20, num_global=3, num_factor=8, base_score=3,
                   learning_rate=0.01, wd_user=0.004, wd_item=0.004, extend_type=99,
                   format_type=0)
LITE_TOL = dict(rtol=1e-5, atol=1e-7)  # test_lite_solver_matches_jax's
LITE_ROUNDS = 2
GBRT_ROUNDS = 3
OWN_KEYS = ("mesh_data=2", "mesh_model=2", "device=cpu", "silent=1")  # no distributed=1


def lite_text(seed=0):
    """test_lite_solver_matches_jax's 200 rows with num_global=3."""
    rng = np.random.RandomState(seed)
    return "\n".join(f"{rng.randint(1, 6)} 1 1 1 {rng.randint(0, 3)}:0.5 "
                     f"{rng.randint(0, 10)}:1 {rng.randint(0, 20)}:1" for _ in range(200)) + "\n"


# ---- the rank's program -------------------------------------------------------
def _port_inputs(state, batch, consts, stack):
    from svdfeature_tpu_torch import convert

    cpu = torch.device("cpu")
    st = convert.state_from_numpy(**state, device=cpu)
    cs = convert.consts_from_numpy(**consts, device=cpu)
    stacked = convert.stacked_from_numpy({k: np.stack([v] * stack) for k, v in batch.items()}, cpu)
    return st, cs, stacked


def _run_case(name, spec, out):
    from svdfeature_tpu_torch.ops.embed import HyperParams
    from svdfeature_tpu_torch.parallel import comm
    from svdfeature_tpu_torch.parallel import mesh as pmesh
    from svdfeature_tpu_torch.parallel import mesh_big as pbig

    nd, nm, lay, B, ng, reg, lrs, stack = spec
    mesh = comm.make_mesh(nd, nm, torch.device("cpu"), ranks=range(nd * nm))
    if mesh is None:
        return
    state, batch, consts = toy(B, ng)
    st, cs, stacked = _port_inputs(state, batch, consts, stack)
    stacked = pmesh.put_process_sharded(stacked, mesh)
    hp = HyperParams(base_score=3.0, reg_method=reg, num_factor=K if lay == "big" else 0)
    lrs = torch.tensor(lrs, dtype=torch.float32)
    n = st.w.shape[0]
    if lay == "big":
        local, n_real = pbig.shard_state_big(st, mesh, K)
        cs = pbig.shard_consts_big(cs, mesh, n_real)
        local = pbig.sharded_train_rounds_big(local, stacked, lrs, cs, hp, mesh, n_real)
        full = pbig.unshard_big(local, mesh, K, n)
        pred = pbig.sharded_predict_big(local, stacked, hp, mesh, n_real)
    else:
        local, n_pad = pmesh.shard_state(st, mesh)
        cs = pmesh.shard_consts(cs, mesh, n_pad)
        local = pmesh.sharded_train_rounds(local, stacked, lrs, cs, hp, mesh, n_pad)
        full = pmesh.unshard_state(local, mesh, n)
        pred = pmesh.sharded_predict(local, stacked, hp, mesh, n_pad)
    for key in ("w", "b", "g", "step", "ref_ui"):
        out[f"{name}/{key}"] = getattr(full, key).numpy().copy()
    out[f"{name}/pred"] = pmesh.gather_predictions(pred, mesh).numpy()


def _run_cli(d, out):
    from svdfeature_tpu_torch.cli import svd_feature, svd_feature_infer
    from svdfeature_tpu_torch.data.buffer import read_csr_buffer
    from svdfeature_tpu_torch.data.streaming import StreamingCSRBuffer
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.base import SVDFeatureTrainer

    svd_feature.main(cli_args(d, "mesh", *MESH, "num_round=2"))
    svd_feature.main(cli_args(d, "mesh", *MESH, "num_round=3", "continue=1"))
    svd_feature_infer.main(cli_args(d, "mesh", *MESH, "pred=3", f"name_pred={d}/pred_mesh.txt"))
    svd_feature_infer.main(cli_args(d, "mesh", *MESH, "start=0", "end=4",
                                    f"log_eval={d}/eval_mesh.tsv"))
    svd_feature.main(cli_args(d, "big", *MESH, "num_round=2", "mesh_big=1"))

    # staged against streamed through the trainer, predictions on every rank
    test_ds, _ = read_csr_buffer(str(d / "test.buffer"))
    for tag in ("staged", "streamed"):
        tr = SVDFeatureTrainer(SVDTypeParam())
        for k, v in {**CLI_PARAMS, "mesh_data": 2, "mesh_model": 2, "device": "cpu"}.items():
            tr.set_param(k, str(v))
        tr.init_model()
        tr.init_trainer()
        if tag == "staged":
            ds, _ = read_csr_buffer(str(d / "train.buffer"))
            probe = test_ds
        else:
            ds = StreamingCSRBuffer(str(d / "train.buffer"), examples_per_chunk=64)
            probe = StreamingCSRBuffer(str(d / "test.buffer"), examples_per_chunk=64)
        for _ in range(2):
            tr.update_all(ds)
        out[f"cli/{tag}/pred"] = tr.predict_all(probe)


def _join_by_mesh_keys(out):
    """A trainer given the mesh keys and no distributed=1 joins the world
    itself, before its model's first tensor; returns it, not yet sharded."""
    import torch.distributed as dist

    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.base import SVDFeatureTrainer

    before = dist.is_initialized()
    tr = SVDFeatureTrainer(SVDTypeParam())
    for k, v in {**CLI_PARAMS, "mesh_data": 2, "mesh_model": 2, "device": "cpu"}.items():
        tr.set_param(k, str(v))
    tr.init_model()
    out["join/world"] = np.array([before, dist.is_initialized(), dist.get_world_size()])
    out["join/device"] = np.array(str(tr.model.w.device))
    return tr


def _nan_on_one_rank(tr, out):
    """debug_checks on a mesh: a NaN in rank 1's slab alone; every rank
    records what its round-end check raised."""
    from svdfeature_tpu_torch.parallel import comm
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    tr.init_trainer()
    if comm.rank() == 1:
        tr.state.w[0, 0] = float("nan")
    task = SVDTrainTask()
    task.trainer = tr
    try:
        task._check_state(7)
        out["nan/raised"] = np.array("")
    except FloatingPointError as e:
        out["nan/raised"] = np.array(str(e))


def _run_whole_table_solvers(d, out):
    """The lite solver (batch 7) and RegGBRT through SVDTrainTask with the
    mesh keys and no distributed=1, each rank naming its own model folder
    (rank 0's alone may appear); each rank keeps its final model."""
    import io

    import svdfeature_tpu_torch.solvers.example  # noqa: F401  (registers 99)
    from svdfeature_tpu_torch.parallel import comm
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    r = comm.rank()
    for name, extra in (("lite", ["batch_size=7", f"num_round={LITE_ROUNDS}"]),
                        ("gbrt", [f"num_round={GBRT_ROUNDS}"])):
        task = SVDTrainTask()
        task.run(str(d / f"{name}.conf"), [f"model_out_folder={d}/models_{name}_r{r}", *OWN_KEYS,
                                           *extra])
        if name == "lite":
            lite_batch = task.trainer.batch_size
        buf = io.BytesIO()
        task.trainer.save_model(buf)
        out[f"{name}/model"] = np.frombuffer(buf.getvalue(), np.uint8)
    out["lite/batch_size"] = np.array(lite_batch)


def worker(d: pathlib.Path) -> None:
    from svdfeature_tpu_torch.parallel import comm

    out = {}
    joined = _join_by_mesh_keys(out)
    for name, spec in cases().items():
        _run_case(name, spec, out)
    _run_cli(d, out)
    _run_whole_table_solvers(d, out)
    _nan_on_one_rank(joined, out)
    np.savez(d / f"out_rank{comm.rank()}.npz", **out)


# ---- the world, launched once a module -----------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Write the CLI's buffers and conf, launch the WORLD ranks with torchrun
    (each runs ``worker``), and load every rank's results."""
    from svdfeature_tpu_torch.data.buffer import write_csr_buffer
    from svdfeature_tpu_torch.data.text import load_feature_text

    d = tmp_path_factory.mktemp("mesh_world")
    for split, rows, seed in (("train", 640, 0), ("test", 256, 1)):
        ds = load_feature_text("x", text=cli_text(rows, seed))
        write_csr_buffer(str(d / f"{split}.buffer"), ds, batch_size=64)
    conf = "".join(f"{k} = {v}\n" for k, v in CLI_PARAMS.items())
    (d / "mesh.conf").write_text(conf + f'buffer_feature = "{d}/train.buffer"\n'
                                 f'test:buffer_feature = "{d}/test.buffer"\n')
    write_csr_buffer(str(d / "lite.buffer"), load_feature_text("x", text=lite_text()), batch_size=64)
    (d / "lite.conf").write_text("".join(f"{k} = {v}\n" for k, v in LITE_PARAMS.items())
                                 + f'buffer_feature = "{d}/lite.buffer"\n')
    from test_torch_gbrt import CLI_CONF as GBRT_CONF
    from test_torch_gbrt import gbrt_text

    rows, fb = gbrt_text()
    (d / "gbrt.txt").write_text(rows)
    (d / "gbrt.fb").write_text(fb)
    (d / "gbrt.conf").write_text(GBRT_CONF + f'extend_type = 31\ndata_in = "{d}/gbrt.txt"\n'
                                 f'feedback_in = "{d}/gbrt.fb"\n')
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={WORLD}", str(pathlib.Path(__file__).resolve()), str(d)]
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    ranks = [dict(np.load(d / f"out_rank{r}.npz")) for r in range(WORLD)]
    return dict(dir=d, ranks=ranks, log=proc.stdout)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported here, not at the top."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from svdfeature_tpu.ops import embed
    from svdfeature_tpu.parallel import mesh, mesh_big

    return dict(jax=jax, jnp=jnp, NS=NamedSharding, P=P, embed=embed, mesh=mesh,
                mesh_big=mesh_big)


def _jax_inputs(jx, state, batch, consts):
    jnp, embed = jx["jnp"], jx["embed"]
    st = embed.TrainState(**{k: jnp.asarray(v) for k, v in state.items()})
    cs = embed.TrainConsts(**{k: jnp.asarray(v) for k, v in consts.items()})
    return st, {k: jnp.asarray(v) for k, v in batch.items()}, cs


def _jax_single(jx, spec):
    """The JAX single-device trajectory: the rounds of ``train_step``."""
    nd, nm, lay, B, ng, reg, lrs, stack = spec
    st, batch, cs = _jax_inputs(jx, *toy(B, ng))
    hp = jx["embed"].HyperParams(base_score=3.0, reg_method=reg)
    for lr in lrs:
        for _ in range(stack):
            st = jx["embed"].train_step(st, batch, jx["jnp"].float32(lr), cs, hp)
    return st, hp, batch


def _jax_mesh_step(jx, spec):
    """One step of the JAX mesh (``sharded_train_step`` or, big,
    ``sharded_train_step_big``) on (n_data, n_model) of the CPU devices,
    unsharded to the single-device layout."""
    nd, nm, lay, B, ng, reg, lrs, stack = spec
    jax, jnp, P = jx["jax"], jx["jnp"], jx["P"]
    st, batch, cs = _jax_inputs(jx, *toy(B, ng))
    hp = jx["embed"].HyperParams(base_score=3.0, reg_method=reg)
    mesh = jx["mesh"].make_mesh(nd, nm, jax.devices("cpu"))
    sb = {k: jax.device_put(v, jx["NS"](mesh, P("data") if v.ndim == 1 else P("data", None)))
          for k, v in batch.items()}
    n = st.w.shape[0]
    if lay == "big":
        mb = jx["mesh_big"]
        bhp = dataclasses.replace(hp, num_factor=K)
        sst, n_real = mb.shard_state_big(st, mesh, K)
        out = mb.sharded_train_step_big(mesh, bhp, n_real)(
            sst, sb, jnp.float32(lrs[0]), mb.shard_consts_big(cs, mesh, n_real))
        return mb.unshard_state_big(out, nm, K, n)
    m = jx["mesh"]
    sst, n_pad = m.shard_state(st, mesh)
    out = m.sharded_train_step(mesh, hp, n_pad)(sst, sb, jnp.float32(lrs[0]),
                                                m.shard_consts(cs, mesh, n_pad))
    return dataclasses.replace(out, w=out.w[:n], b=out.b[:n], ref_ui=out.ref_ui[:n])


def _unsharded(world, name, nd, nm):
    """Each data row's unshard of a case (rank d * nm holds row d's)."""
    return [{k.split("/")[1]: v for k, v in world["ranks"][d * nm].items()
             if k.startswith(name + "/")} for d in range(nd)]


def _close(got, want, tol, keys=("w", "b", "g")):
    for key in keys:
        np.testing.assert_allclose(got[key], np.asarray(getattr(want, key)), **tol, err_msg=key)


# ---- the tests ----------------------------------------------------------------
@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("num_global", [0, 5])
@pytest.mark.parametrize("nd,nm", SHAPES)
def test_step_matches_jax_mesh_and_single(world, jx, nd, nm, num_global, lay):
    """tests/test_sharding.py::test_sharded_step_matches_single and
    tests/test_mesh_big.py::test_big_sharded_step_matches_single: one step
    of the port's mesh equals JAX's mesh step and its single-device step."""
    name = f"step-{nd}x{nm}-g{num_global}-{lay}"
    spec = cases()[name]
    single, _, _ = _jax_single(jx, spec)
    mesh_out = _jax_mesh_step(jx, spec)
    for got in _unsharded(world, name, nd, nm):
        _close(got, single, STEP_TOL)
        _close(got, mesh_out, STEP_TOL)
        assert int(got["step"]) == int(single.step)


@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("reg", REGS)
def test_trajectory_every_reg_mode(world, jx, reg, lay):
    """tests/test_sharding.py::test_multi_step_trajectory and
    tests/test_mesh_big.py::test_big_multi_step_trajectory: five steps on
    2x2 follow the single-device trajectory in every reg mode; the lazy
    stamps ride the slabs (the global dummy row's is the one allowed
    difference)."""
    name = f"traj-reg{reg}-{lay}"
    single, _, _ = _jax_single(jx, cases()[name])
    for got in _unsharded(world, name, 2, 2):
        _close(got, single, TRAJ_TOL)
        if reg >= 4:
            np.testing.assert_array_equal(got["ref_ui"][:-1], np.asarray(single.ref_ui)[:-1])


@pytest.mark.parametrize("lay", LAYOUTS)
def test_rounds_and_predict(world, jx, lay):
    """tests/test_mesh_big.py::test_big_rounds_and_predict: three rounds of
    three batches at a decaying rate, then the prediction on the mesh, on
    every rank, against the single-device round loop."""
    name = f"rounds-{lay}"
    single, hp, batch = _jax_single(jx, cases()[name])
    want = np.asarray(jx["embed"].predict_batches(
        single, {k: jx["jnp"].stack([v] * 3) for k, v in batch.items()}, hp))
    for got in _unsharded(world, name, 2, 2):
        _close(got, single, TRAJ_TOL)
    for r in range(WORLD):
        np.testing.assert_allclose(world["ranks"][r][f"{name}/pred"], want, **TRAJ_TOL)


def test_data_copies_of_each_shard_are_equal(world):
    """Every data replica of a model shard applies the same gathered
    updates: the copies are equal bit for bit after every case."""
    for name, spec in cases().items():
        nd, nm = spec[:2]
        rows = _unsharded(world, name, nd, nm)
        for other in rows[1:]:
            for key in ("w", "b", "g", "ref_ui"):
                np.testing.assert_array_equal(other[key], rows[0][key], err_msg=f"{name}/{key}")


def test_big_layout_roundtrip():
    """tests/test_mesh_big.py::test_big_layout_roundtrip: the slabs of every
    model position, stacked, unshard to the state exactly, ref bits
    included (no collective: the meshes are built by hand)."""
    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.parallel import comm
    from svdfeature_tpu_torch.parallel import mesh_big as pbig

    cpu = torch.device("cpu")
    for n, n_model in [(10, 4), (16, 4), (7, 2), (8193, 2)]:
        rng = np.random.RandomState(0)
        st = convert.state_from_numpy(rng.rand(n, 4), rng.rand(n), rng.rand(3), 5,
                                      rng.randint(0, 9, n), np.zeros(3), device=cpu)
        slabs = []
        for m in range(n_model):
            mesh = comm.Mesh(1, n_model, 0, m, {"data": None, "model": None}, cpu)
            local, n_real = pbig.shard_state_big(st, mesh, 4)
            assert pbig.big_layout(n, n_model) == (n_real, n_real + 1)
            assert local.w.shape == (n_real + 1, 8) and not local.w[-1].any()
            slabs.append(local.w)
        back = pbig.unshard_state_big(torch.cat(slabs), local, n_model, 4, n)
        for key in ("w", "b", "ref_ui"):
            assert torch.equal(getattr(back, key), getattr(st, key)), key


def _read_model(path):
    from svdfeature_tpu_torch.model import SVDModel
    from svdfeature_tpu_torch.params import SVDTypeParam

    with open(path, "rb") as f:
        m = SVDModel.load(f, SVDTypeParam.from_bytes(f.read(4)), device=torch.device("cpu"))
    return {k: getattr(m, k).numpy() for k in ("w", "b", "g")}


@pytest.fixture(scope="module")
def references(world, jx):
    """Three rounds of the conf through the port's single-device CLI and the
    JAX package's 2x2 mesh CLI (its trainer on the CPU devices)."""
    from svdfeature_tpu.train.loop import SVDTrainTask as JTrain
    from svdfeature_tpu_torch.train.loop import SVDTrainTask as TTrain

    d = world["dir"]
    args = cli_args(d, "single", "device=cpu", "num_round=3")
    TTrain().run(args[0], args[1:])
    args = cli_args(d, "jaxmesh", "mesh_data=2", "mesh_model=2", "num_round=3")
    JTrain().run(args[0], args[1:])
    return d


@pytest.mark.parametrize("rnd", [2, 3])
def test_cli_checkpoints_match_jax_mesh_and_single(references, rnd):
    """The CLI under the 4-rank world (train 2 rounds, then resume with
    continue=1 for a third): each checkpoint within 1e-5 of JAX's 2x2 mesh
    CLI (tests/test_sharding.py::test_trainer_mesh_config_path,
    ::test_mesh_checkpoint_resume_parity) and of the port's single-device
    run; rank 0 wrote it."""
    d = references
    got = _read_model(d / "models_mesh" / f"{rnd:04d}.model")
    for ref in ("jaxmesh", "single"):
        want = _read_model(d / f"models_{ref}" / f"{rnd:04d}.model")
        for key in ("w", "b", "g"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5, err_msg=f"{ref}/{key}")


def test_cli_big_slabs_match_single(references):
    """mesh_big=1 through the CLI (tests/test_mesh_big.py::
    test_trainer_mesh_big_config_path): the augmented slabs with the
    sorted-dedup write (K5's plain version on the CPU) give the
    single-device model after 2 rounds."""
    d = references
    got = _read_model(d / "models_big" / "0002.model")
    want = _read_model(d / "models_single" / "0002.model")
    for key in ("w", "b", "g"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, err_msg=key)


def test_cli_pred_and_eval_from_the_mesh(world, references):
    """pred=3 and the eval on the 4-rank world: rank 0 wrote one pred file
    and one eval log, equal to the single-device model's predictions and
    RMSE within 1e-5."""
    from svdfeature_tpu_torch.infer.task import SVDInferTask

    d = references
    args = cli_args(d, "single", "device=cpu", "pred=3", f"name_pred={d}/pred_single.txt")
    SVDInferTask().run(args[0], args[1:])
    from svdfeature_tpu_torch.data.buffer import read_csr_buffer

    got = np.loadtxt(d / "pred_mesh.txt")
    want = np.loadtxt(d / "pred_single.txt")
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got.shape == (256,)
    evals = np.loadtxt(d / "eval_mesh.tsv")
    labels = read_csr_buffer(str(d / "test.buffer"))[0].labels
    assert evals.shape == (4, 2) and (evals[:, 0] == np.arange(4)).all()
    assert abs(evals[3, 1] - np.sqrt(np.mean((want - labels) ** 2))) < 1e-5


def test_streamed_mesh_equals_staged_on_every_rank(world):
    """Streamed chunks of whole batches under the 2x2 mesh (each rank stages
    its data columns of every chunk) train and predict as the staged mesh
    run does, and every rank ends with the same predictions."""
    preds = [world["ranks"][r][f"cli/{tag}/pred"] for r in range(WORLD)
             for tag in ("staged", "streamed")]
    assert preds[0].shape == (256,)
    for p in preds[1:]:
        np.testing.assert_array_equal(p, preds[0])


def test_wrong_world_size_is_a_value_error(monkeypatch):
    """mesh_data * mesh_model ranks or none: a missing or different
    WORLD_SIZE raises ValueError naming torchrun (JAX: "exceeds N
    devices")."""
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.base import SVDFeatureTrainer

    for world in (None, "2"):
        if world is None:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("WORLD_SIZE", world)
        tr = SVDFeatureTrainer(SVDTypeParam())
        for k, v in {**CLI_PARAMS, "mesh_data": 2, "mesh_model": 2, "device": "cpu"}.items():
            tr.set_param(k, str(v))
        with pytest.raises(ValueError, match="torchrun"):
            tr.init_model()  # the world is checked before the model's first tensor
        assert tr.model is None


def test_mesh_keys_alone_join_the_world(world):
    """mesh_data * mesh_model > 1 without distributed=1: the trainer joins
    the world of 4 ranks in init_model, before its model's first tensor,
    and every rank's model is on the rank's device."""
    for r in range(WORLD):
        got = world["ranks"][r]
        assert got["join/world"].tolist() == [0, 1, WORLD], r
        assert str(got["join/device"]) == "cpu", r


def test_debug_checks_raise_on_every_rank(world):
    """debug_checks on a mesh: a NaN in one rank's slab makes every rank
    raise JAX's FloatingPointError in the same round (the counts of
    non-finite values are summed over the world), none waits in a
    collective."""
    for r in range(WORLD):
        assert str(world["ranks"][r]["nan/raised"]) == "non-finite values in model.w after round 7"


@pytest.mark.parametrize("solver", ["bilinear", "lite-mesh_big"])
def test_other_solvers_refuse_a_mesh(solver, monkeypatch):
    """What the other solvers refuse of a mesh, before any tensor is made:
    the bilinear solver trains one (tests/test_torch_mesh_bi.py), and given
    the mesh keys outside a world of as many ranks it raises ValueError
    naming torchrun; the lite example solver trains the whole table on
    every rank and raises ValueError naming ``mesh_big`` for mesh_big=1
    (the JAX lite step fails in its gather on the augmented slabs), inside
    a world of the right size too.  RegGBRT refuses nothing: it reads no
    mesh key (test_reg_gbrt_takes_the_mesh_keys)."""
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.bilinear import SVDBiLinearTrainer
    from svdfeature_tpu_torch.solvers.example import SVDFeatureLiteTrainer

    keys = {**CLI_PARAMS, "num_ufeedback": 5, "mesh_data": 2, "mesh_model": 2, "device": "cpu"}
    if solver == "lite-mesh_big":
        tr = SVDFeatureLiteTrainer(SVDTypeParam(extend_type=99))
        keys["mesh_big"] = 1
        match = "mesh_big=1"
        monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    else:
        tr = SVDBiLinearTrainer(SVDTypeParam(format_type=1, extend_type=15))
        match = "torchrun"
        for name in ("WORLD_SIZE", "RANK"):
            monkeypatch.delenv(name, raising=False)
    for k, v in keys.items():
        tr.set_param(k, str(v))
    with pytest.raises(ValueError, match=match):
        tr.init_model()
        tr.init_trainer()
    assert tr.model is None
    if solver == "bilinear":
        assert tr.W_bi is None


@pytest.fixture(scope="module")
def whole_table_refs(world, jx):
    """Outside any world: the lite solver on the port's single device at
    batch 8 and the JAX lite trainer on its 2x2 CPU mesh at batch 7 (the
    train CLI, LITE_ROUNDS rounds); RegGBRT in the port without the mesh
    keys and with them, and in the JAX package with them (GBRT_ROUNDS)."""
    import svdfeature_tpu.solvers.example  # noqa: F401  (registers 99 in JAX)
    import svdfeature_tpu_torch.solvers.example  # noqa: F401
    from svdfeature_tpu.train.loop import SVDTrainTask as JTrain
    from svdfeature_tpu_torch.train.loop import SVDTrainTask as TTrain

    d = world["dir"]
    mesh = ["mesh_data=2", "mesh_model=2"]
    lite, gbrt = f"num_round={LITE_ROUNDS}", f"num_round={GBRT_ROUNDS}"
    for task, conf, tag, extra in (
            (TTrain, "lite", "single", ["device=cpu", "batch_size=8", lite]),
            (JTrain, "lite", "jaxmesh", [*mesh, "batch_size=7", lite]),
            (TTrain, "gbrt", "single", ["device=cpu", gbrt]),
            (TTrain, "gbrt", "keys", ["device=cpu", *mesh, gbrt]),
            (JTrain, "gbrt", "jaxmesh", [*mesh, gbrt])):
        task().run(str(d / f"{conf}.conf"), [f"model_out_folder={d}/models_{conf}_{tag}",
                                             "silent=1", *extra])
    return d


def test_lite_solver_on_the_mesh_matches_jax_mesh_and_single(world, whole_table_refs):
    """The lite example solver (extend_type 99) with mesh_data=2
    mesh_model=2 and batch_size=7 in the 4-rank world: the batch grew to
    8, as on the JAX mesh (svdfeature_tpu/solvers/base.py:243-244); every
    rank ends with the same whole table; rank 0 alone wrote checkpoints,
    each round's equal to the JAX lite trainer's on its 2x2 CPU mesh and to
    the port's single device at batch 8, within
    tests/test_torch_loop.py::test_lite_solver_matches_jax's tolerances."""
    d = whole_table_refs
    ranks = world["ranks"]
    assert sorted(p.name for p in d.glob("models_lite_r*")) == ["models_lite_r0"]
    for r in range(WORLD):
        assert int(ranks[r]["lite/batch_size"]) == 8, r
        np.testing.assert_array_equal(ranks[r]["lite/model"], ranks[0]["lite/model"])
    final = (d / "models_lite_r0" / f"{LITE_ROUNDS:04d}.model").read_bytes()
    assert final[4:] == ranks[0]["lite/model"].tobytes()
    for rnd in range(LITE_ROUNDS + 1):
        got = _read_model(d / "models_lite_r0" / f"{rnd:04d}.model")
        for ref in ("jaxmesh", "single"):
            want = _read_model(d / f"models_lite_{ref}" / f"{rnd:04d}.model")
            for key in ("w", "b", "g"):
                np.testing.assert_allclose(got[key], want[key], **LITE_TOL,
                                           err_msg=f"round {rnd} {ref}/{key}")
    first = _read_model(d / "models_lite_r0" / "0000.model")
    assert got["g"].shape == (3,) and not np.array_equal(got["w"], first["w"])


def test_reg_gbrt_takes_the_mesh_keys(world, whole_table_refs):
    """RegGBRT reads no mesh key, as the JAX trainer, where they reach only
    its ConfigSaver (svdfeature_tpu/solvers/gbrt/trainer.py:126-167): with
    mesh_data=2 mesh_model=2 outside a world every checkpoint is byte for
    byte the run without them and the JAX package's with them; in the
    4-rank world (joined without distributed=1) every rank fits the same
    trees and rank 0 alone wrote, the same bytes."""
    d = whole_table_refs
    ranks = world["ranks"]
    assert sorted(p.name for p in d.glob("models_gbrt_r*")) == ["models_gbrt_r0"]
    for rnd in range(GBRT_ROUNDS + 1):
        want = (d / "models_gbrt_single" / f"{rnd:04d}.model").read_bytes()
        for tag in ("keys", "jaxmesh", "r0"):
            assert (d / f"models_gbrt_{tag}" / f"{rnd:04d}.model").read_bytes() == want, (tag, rnd)
    assert want[4:] == ranks[0]["gbrt/model"].tobytes() and len(want) > 200
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["gbrt/model"], ranks[0]["gbrt/model"])


if __name__ == "__main__":
    worker(pathlib.Path(sys.argv[1]))
