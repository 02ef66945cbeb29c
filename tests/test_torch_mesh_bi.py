"""The bilinear solver on a device mesh in the port (parallel/bilinear_mesh.py,
bilinear_mesh_big.py and the bilinear trainer's mesh branches) against the
JAX package's mesh (tests/test_side_solvers.py, tests/test_mesh_big.py,
tests/test_side_multirow.py) and the single-device steps of both packages.

One torchrun world of WORLD = 4 gloo ranks on the CPU runs every case in
one launch (the module fixture ``world``; this file run as a script is a
rank's program), as tests/test_torch_mesh_plus.py does.  The inputs are
made with numpy from seeds: the steps' toy tables, batches, W_bi and user
properties (``toy_bi``, on test_torch_mesh_plus's ``toy_plus``), and the
text of each trainer run's user-group data.  A rank saves what it computed
(the unsharded tables and W_bi of its data row, its own W_bi slab, the
predictions gathered on every rank, rank 0 the checkpoint's bytes); the
tests hand the same inputs to the JAX package's mesh on the 8-device CPU
mesh of tests/conftest.py and to the single-device steps, lazily.
Tolerances: rtol 2e-5 + atol 1e-6 for one step, rtol 1e-4 + atol 1e-5 for
several steps or rounds, 1e-5 for checkpoints, predictions and the CLI's
evaluation.  The data copies of each model shard, W_bi's slabs included,
must be equal bit for bit.
"""

import importlib
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_mesh_plus import (FB_HYPER, K, LR, STEP_TOL, TRAJ_TOL, text_streaming,
                                        text_tiny, toy_plus)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
CLI_TOL = 1e-5
NI, OFF_ITEM, NBF = 20, 12, 6  # toy_plus's items: rows [12, 32) of its table
SLR_BI, WD_BI = 1.5, 0.01


# ---- the steps' inputs, made alike by the ranks and the tests ------------------
def toy_bi(nn, M=1, seed=0):
    """toy_plus's (state, batch, fb, consts) with W_bi ``[NI, NBF]`` and
    the users' properties ``up [1, G+1, NBF]`` (about half zero, the pad
    segment's row zero)."""
    state, batch, fb, consts = toy_plus(nn, M)
    G = batch["label"].shape[0] // M
    rng = np.random.RandomState(seed + 100)
    W = (rng.randn(NI, NBF) * 0.05).astype(np.float32)
    up = (rng.rand(1, G + 1, NBF) * (rng.rand(1, G + 1, NBF) < 0.5)).astype(np.float32)
    up[:, G] = 0.0
    return state, batch, fb, consts, W, up


def step_cases():
    """name -> (n_data, n_model, layout, nonneg, reg_method, reg_global, M,
    steps, reg_bi): one step on every mesh shape for every W_bi decay
    (small slabs; 2x2 on big slabs too), five steps of the lazy modes, four
    of M = 2."""
    out = {}
    for nd, nm in [(1, 1), (2, 1), (1, 2), (2, 2)]:
        for rb in range(6):
            out[f"step-{nd}x{nm}-bi{rb}-small"] = (nd, nm, "small", rb % 2, 0, 0, 1, 1, rb)
    for rb in range(6):
        out[f"step-2x2-bi{rb}-big"] = (2, 2, "big", rb % 2, 0, 0, 1, 1, rb)
    for reg in (4, 5):
        for lay in ("small", "big"):
            out[f"traj-reg{reg}-{lay}"] = (2, 2, lay, 0, reg, reg, 1, 5, 1)
    for lay in ("small", "big"):
        out[f"multirow-{lay}"] = (2, 2, lay, 0, 0, 0, 2, 4, 2)
    return out


def stacked_inputs(spec):
    """The toy's step repeated ``steps`` times as ``[T, G*M]`` planes, one
    chunk, and the hyperparameters' switches."""
    nd, nm, lay, nn, reg, regg, M, steps, rb = spec
    state, batch, fb, consts, W, up = toy_bi(nn, M)
    stacked = {k: np.stack([v] * steps) for k, v in batch.items()}
    return state, stacked, {k: v[None] for k, v in fb.items()}, consts, W, up, \
        dict(base_score=3.0, user_nonnegative=nn, item_nonnegative=nn, reg_method=reg,
             reg_global=regg)


# ---- the trainer runs: user-group text, the same for both packages -----------------
def text_bi_big():
    """tests/test_mesh_big.py::test_bilinear_mesh_big_config_path's data."""
    rng = np.random.RandomState(11)
    rows, fbs = [], []
    for u in range(12):
        r = rng.randint(2, 5)
        rows += [f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 24)}:1" for _ in range(r)]
        nf = rng.randint(2, 6)
        ids = rng.choice(12, size=nf, replace=False)
        fbs.append(f"{r} {nf} " + " ".join(f"{j}:0.5" for j in ids))
    return rows, fbs


DATA = {"tiny": text_tiny, "big": text_bi_big, "stream": text_streaming}
M22 = dict(mesh_data=2, mesh_model=2)
BIG = dict(M22, mesh_big=1)
BASE = dict(base_score=3, learning_rate=LR, wd_user=0.004, wd_item=0.004, wd_ufeedback=0.004,
            num_factor=K)
# tests/test_side_solvers.py's PARAMS with its bilinear keys
TINY = dict(BASE, num_item=20, num_user=8, num_global=0, num_ufeedback=20, num_bi_feedback=10,
            wd_bi_feedback=0.01, start_ufeedback=2)
# tests/test_mesh_big.py's
BIGCFG = dict(BASE, num_user=12, num_item=24, num_ufeedback=12, users_per_batch=4,
              num_bi_feedback=10, wd_bi_feedback=0.01)
# tests/test_side_multirow.py's make_bi_trainer
STREAM = dict(BASE, num_user=12, num_item=12, num_ufeedback=15, users_per_batch=2,
              num_bi_feedback=15, wd_bi_feedback=0.002)


def runs():
    """name -> (data, params, rounds, how): how is ``all`` (update_all a
    round) or ``stream`` (a streamed buffer of 4-block chunks, the probe
    streamed too)."""
    out = {f"side-reg{r}": ("tiny", dict(TINY, reg_bi_feedback=r, **M22), 3, "all")
           for r in (0, 2, 5)}
    for r, s in [(0, 0), (2, 2)]:
        out[f"big-reg{r}-start{s}"] = ("big", dict(BIGCFG, reg_bi_feedback=r, start_ufeedback=s,
                                                   **BIG), 3, "all")
    out.update({
        "multirow": ("stream", dict(STREAM, rows_per_user=2, **M22), 5, "all"),
        "multirow-staged": ("stream", dict(STREAM, rows_per_user=2, **M22), 3, "all"),
        "multirow-streamed": ("stream", dict(STREAM, rows_per_user=2, **M22), 3, "stream"),
        # the feedback ids are user rows: the mesh step gathers them every step
        "shared": ("tiny", dict(TINY, num_user=20, common_feedback_space=1, **M22), 3, "all"),
        "big-staged": ("stream", dict(STREAM, **BIG), 2, "all"),
        "big-streamed": ("stream", dict(STREAM, **BIG), 2, "stream"),
    })
    return out


MESH_KEYS = ("mesh_data", "mesh_model", "mesh_big")


def drive(pkg: str, name: str, tmp: pathlib.Path, extra=(), mesh=True) -> dict:
    """Train run ``name`` through package ``pkg``'s bilinear trainer (on its
    mesh, or with ``mesh`` False on one device) and predict its probe;
    returns (w, b, g, W_bi [num_item, nbf], pred, the checkpoint's bytes
    where this process wrote it) as numpy (on a mesh, on every rank)."""
    data, params, rounds, how = runs()[name]
    if not mesh:
        params = {k: v for k, v in params.items() if k not in MESH_KEYS}
    params_mod = importlib.import_module(f"{pkg}.params")
    bilinear = importlib.import_module(f"{pkg}.solvers.bilinear")
    text = importlib.import_module(f"{pkg}.data.text")
    tr = bilinear.SVDBiLinearTrainer(params_mod.SVDTypeParam(format_type=1, extend_type=15))
    for k, v in [*params.items(), *extra]:
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    rows, fbs = DATA[data]()
    ds = text.load_plus_text("x", "y", text="\n".join(rows), feedback_text="\n".join(fbs))
    if how == "stream":
        buffer = importlib.import_module(f"{pkg}.data.buffer")
        streaming = importlib.import_module(f"{pkg}.data.streaming")
        path = str(tmp / f"{name}.buffer")
        buffer.write_plus_buffer(path, ds)
        for _ in range(rounds):
            tr.update_all(streaming.StreamingPlusBuffer(path, blocks_per_chunk=4))
        probe = streaming.StreamingPlusBuffer(path, blocks_per_chunk=4)
    else:
        for _ in range(rounds):
            tr.update_all(ds)
        probe = ds
    out = {"pred": np.asarray(tr.predict_all(probe))}
    writer = pkg == "svdfeature_tpu" or not torch.distributed.is_initialized() or \
        torch.distributed.get_rank() == 0
    buf = io.BytesIO() if writer else None
    tr.save_model(buf)  # on a mesh, the ranks of data row 0 gather W_bi
    if buf is not None:
        out["ckpt"] = np.frombuffer(buf.getvalue(), np.uint8)
    tr._sync_model_from_state()
    out.update({key: np.asarray(getattr(tr.model, key)) for key in ("w", "b", "g")})
    ni = tr.mparam.num_item
    out["W_bi"] = np.asarray(tr._wbi_host())[:ni]
    out["big"] = np.asarray(bool(getattr(tr, "_mesh_big", False)))
    if pkg != "svdfeature_tpu" and getattr(tr, "mesh", None) is not None:
        out["Wb_local"] = tr.W_bi.numpy().copy()
    return out


def read_checkpoint(raw: np.ndarray) -> dict:
    """(w, b, g, W_bi) of a bilinear trainer's checkpoint bytes, read with
    the port."""
    from svdfeature_tpu_torch.model import SVDModel, _read_t2d
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.bilinear import BParam

    f = io.BytesIO(raw.tobytes())
    m = SVDModel.load(f, SVDTypeParam(format_type=1, extend_type=15), device=torch.device("cpu"))
    BParam().load(f)
    out = {k: getattr(m, k).numpy() for k in ("w", "b", "g")}
    out["W_bi"] = _read_t2d(f)
    assert f.read() == b""
    return out


# ---- the CLI ------------------------------------------------------------------------
CLI_CONF = "".join(f"{k} = {v}\n" for k, v in dict(
    STREAM, format_type=1, num_global=0, extend_type=15, silent=1).items())
MESH = ("distributed=1", "mesh_data=2", "mesh_model=2", "device=cpu")


def cli_args(d, tag, *extra):
    return [str(d / "bi.conf"), f"model_out_folder={d}/models_{tag}", "silent=1", *extra]


# ---- the rank's program -----------------------------------------------------------
def _run_step_case(name, spec, out):
    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.ops.embed import HyperParams
    from svdfeature_tpu_torch.ops.svdpp import PlusHyper
    from svdfeature_tpu_torch.ops.svdpp_bilinear import BiHyper
    from svdfeature_tpu_torch.parallel import bilinear_mesh, bilinear_mesh_big, comm
    from svdfeature_tpu_torch.parallel import mesh as pmesh
    from svdfeature_tpu_torch.parallel import mesh_big as pbig

    nd, nm, lay, nn, reg, regg, M, steps, rb = spec
    cpu = torch.device("cpu")
    mesh = comm.make_mesh(nd, nm, cpu, ranks=range(nd * nm))
    if mesh is None:
        return
    state, stacked, fb, consts, W, up, hkw = stacked_inputs(spec)
    st = convert.state_from_numpy(**state, device=cpu)
    cs = convert.consts_from_numpy(**consts, device=cpu)
    stacked = convert.stacked_from_numpy(pmesh.put_process_sharded(stacked, mesh), cpu)
    fb, _ = convert.pool_from_numpy(fb, None, cpu)
    W_pad, up = convert.bilinear_from_numpy(W, up, cpu)
    cid = np.zeros(steps, np.int32)
    ph = PlusHyper(rows_per_user=M, **FB_HYPER)
    bh = BiHyper(slr_bi=SLR_BI, wd_bi=WD_BI, reg_bi=rb, off_item=OFF_ITEM)
    lrs = torch.tensor([LR], dtype=torch.float32)
    n = st.w.shape[0]
    if lay == "big":
        hp = HyperParams(num_factor=K, **hkw)
        local, n_real = pbig.shard_state_big(st, mesh, K)
        cs = pbig.shard_consts_big(cs, mesh, n_real)
        Wb, nb_real = bilinear_mesh_big.shard_bi_big(W_pad, mesh)
        local = bilinear_mesh_big.sharded_bilinear_rounds_big(
            local, Wb, stacked, cid, fb, up, lrs, cs, hp, ph, bh, mesh, n_real, nb_real, NI)
        full = pbig.unshard_big(local, mesh, K, n)
        W_full = bilinear_mesh_big.unshard_bi_big(Wb, mesh, nb_real, NI)
        pred = bilinear_mesh_big.sharded_bilinear_predict_big(
            local, Wb, stacked, cid, fb, up, hp, mesh, n_real, nb_real, OFF_ITEM, NI, M)
    else:
        hp = HyperParams(**hkw)
        local, n_pad = pmesh.shard_state(st, mesh)
        cs = pmesh.shard_consts(cs, mesh, n_pad)
        Wb, n_bi_pad = bilinear_mesh.shard_bi(W_pad, mesh)
        local = bilinear_mesh.sharded_bilinear_rounds(
            local, Wb, stacked, cid, fb, up, lrs, cs, hp, ph, bh, mesh, n_pad, n_bi_pad)
        full = pmesh.unshard_state(local, mesh, n)
        W_full = bilinear_mesh.unshard_bi(Wb, mesh, NI)
        pred = bilinear_mesh.sharded_bilinear_predict(
            local, Wb, stacked, cid, fb, up, hp, mesh, n_pad, n_bi_pad, OFF_ITEM, M)
    for key in ("w", "b", "g", "step", "ref_ui", "ref_g"):
        out[f"{name}/{key}"] = getattr(full, key).numpy().copy()
    out[f"{name}/W_bi"] = W_full[:-1].numpy().copy()
    out[f"{name}/W_pad_row"] = W_full[-1].numpy().copy()
    out[f"{name}/Wb_local"] = Wb.numpy().copy()
    out[f"{name}/pred"] = pmesh.gather_predictions(pred, mesh).numpy()


def _count_collectives(out):
    """The collectives (``all_reduce`` and ``all_gather`` calls on a group
    of more than one rank) of one training step and of one prediction batch
    of the SVD++ and bilinear mesh bodies on the 2x2 mesh: small slabs in
    the eager and a lazy mode, big slabs."""
    import torch.distributed as dist

    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.ops.embed import HyperParams
    from svdfeature_tpu_torch.ops.svdpp import PlusHyper, _fb_hyper
    from svdfeature_tpu_torch.parallel import (bilinear_mesh, bilinear_mesh_big, comm,
                                               svdpp_mesh, svdpp_mesh_big)
    from svdfeature_tpu_torch.parallel import mesh as pmesh
    from svdfeature_tpu_torch.parallel import mesh_big as pbig

    cpu = torch.device("cpu")
    mesh = comm.make_mesh(2, 2, cpu)
    calls = [0]
    real = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}

    def counting(fn):
        def call(*args, **kwargs):
            calls[0] += 1
            return fn(*args, **kwargs)
        return call

    lr = torch.tensor(LR)
    fbh = _fb_hyper(lr, PlusHyper(**FB_HYPER))
    for name, fn in real.items():
        setattr(dist, name, counting(fn))
    try:
        for lay, reg in (("small", 0), ("small", 4), ("big", 0)):
            spec = (2, 2, lay, 0, reg, 0, 1, 1, 0)
            state, stacked, fb, consts, W, up, hkw = stacked_inputs(spec)
            batch = {k: v[0] for k, v in convert.stacked_from_numpy(
                pmesh.put_process_sharded(stacked, mesh), cpu).items()}
            cfb = {k: torch.from_numpy(v[0]) for k, v in fb.items()}
            W_pad, up = convert.bilinear_from_numpy(W, up, cpu)
            G = stacked["label"].shape[1]
            for solver in ("svdpp", "bilinear"):
                st = convert.state_from_numpy(**state, device=cpu)
                cs = convert.consts_from_numpy(**consts, device=cpu)
                if lay == "big":
                    hp = HyperParams(num_factor=K, **hkw)
                    st, n = pbig.shard_state_big(st, mesh, K)
                    cs = pbig.shard_consts_big(cs, mesh, n)
                    Wb, nb = bilinear_mesh_big.shard_bi_big(W_pad, mesh)
                    step = lambda: (svdpp_mesh_big.sharded_svdpp_step_big(  # noqa: E731
                        st, batch, cfb, lr, fbh, cs, hp, mesh, n, G) if solver == "svdpp" else
                        bilinear_mesh_big.sharded_bilinear_step_big(
                            st, Wb, batch, cfb, up[0], lr, fbh, (lr, WD_BI), cs, hp, mesh, n, nb,
                            G, OFF_ITEM, NI, 0))
                    one = {k: v[None] for k, v in batch.items()}
                    pred = lambda: (svdpp_mesh_big.sharded_svdpp_predict_big(  # noqa: E731
                        st, one, [0], {k: v[None] for k, v in cfb.items()}, hp, mesh, n)
                        if solver == "svdpp" else bilinear_mesh_big.sharded_bilinear_predict_big(
                            st, Wb, one, [0], {k: v[None] for k, v in cfb.items()}, up, hp,
                            mesh, n, nb, OFF_ITEM, NI))
                else:
                    hp = HyperParams(**hkw)
                    st, n = pmesh.shard_state(st, mesh)
                    cs = pmesh.shard_consts(cs, mesh, n)
                    Wb, nb = bilinear_mesh.shard_bi(W_pad, mesh)
                    step = lambda: (svdpp_mesh.sharded_svdpp_step(  # noqa: E731
                        st, batch, cfb, lr, fbh, cs, hp, mesh, n, G) if solver == "svdpp" else
                        bilinear_mesh.sharded_bilinear_step(
                            st, Wb, batch, cfb, up[0], lr, fbh, (lr, WD_BI), cs, hp, mesh, n, nb,
                            G, OFF_ITEM, 0))
                    one = {k: v[None] for k, v in batch.items()}
                    pred = lambda: (svdpp_mesh.sharded_svdpp_predict(  # noqa: E731
                        st, one, [0], {k: v[None] for k, v in cfb.items()}, hp, mesh, n)
                        if solver == "svdpp" else bilinear_mesh.sharded_bilinear_predict(
                            st, Wb, one, [0], {k: v[None] for k, v in cfb.items()}, up, hp,
                            mesh, n, nb, OFF_ITEM))
                for what, fn in (("step", step), ("predict", pred)):
                    calls[0] = 0
                    fn()
                    out[f"collectives/{solver}-{lay}-reg{reg}-{what}"] = np.asarray(calls[0])
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def _run_cli(d):
    from svdfeature_tpu_torch.cli import svd_feature, svd_feature_infer

    svd_feature.main(cli_args(d, "mesh", *MESH, "num_round=2"))
    svd_feature.main(cli_args(d, "mesh", *MESH, "num_round=3", "continue=1"))
    svd_feature_infer.main(cli_args(d, "mesh", *MESH, "pred=3", f"name_pred={d}/pred_mesh.txt"))
    svd_feature_infer.main(cli_args(d, "mesh", *MESH, "start=0", "end=4",
                                    f"log_eval={d}/eval_mesh.tsv"))


def worker(d: pathlib.Path) -> None:
    from svdfeature_tpu_torch.parallel import comm

    comm.init_distributed("cpu")
    out = {}
    for name, spec in step_cases().items():
        _run_step_case(name, spec, out)
    _count_collectives(out)
    scratch = d / f"rank{comm.rank()}"
    scratch.mkdir(exist_ok=True)
    for name in runs():
        for key, val in drive("svdfeature_tpu_torch", name, scratch, [("device", "cpu")]).items():
            out[f"{name}/{key}"] = val
    _run_cli(d)
    np.savez(d / f"out_rank{comm.rank()}.npz", **out)


# ---- the world, launched once a module ------------------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Write the CLI's buffers and conf, launch the WORLD ranks with torchrun
    (each runs ``worker``), and load every rank's results."""
    from svdfeature_tpu_torch.data.buffer import write_plus_buffer
    from svdfeature_tpu_torch.data.text import load_plus_text

    d = tmp_path_factory.mktemp("mesh_bi_world")
    for split, seed in (("train", 3), ("test", 11)):
        rows, fbs = text_streaming(seed)
        write_plus_buffer(str(d / f"{split}.buffer"), load_plus_text(
            "x", "y", text="\n".join(rows), feedback_text="\n".join(fbs)))
    (d / "bi.conf").write_text(CLI_CONF + f'buffer_feature = "{d}/train.buffer"\n'
                               f'test:buffer_feature = "{d}/test.buffer"\n')
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={WORLD}", str(pathlib.Path(__file__).resolve()), str(d)]
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return dict(dir=d, ranks=[dict(np.load(d / f"out_rank{r}.npz")) for r in range(WORLD)])


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported here, not at the top."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from svdfeature_tpu.ops import embed, svdpp_bilinear
    from svdfeature_tpu.parallel import bilinear_mesh, bilinear_mesh_big, mesh, mesh_big

    return dict(jax=jax, jnp=jnp, NS=NamedSharding, P=P, embed=embed, bi=svdpp_bilinear,
                mesh=mesh, mesh_big=mesh_big, bm=bilinear_mesh, bmb=bilinear_mesh_big)


def _jax_step_inputs(jx, spec):
    jnp, embed = jx["jnp"], jx["embed"]
    state, stacked, fb, consts, W, up, hkw = stacked_inputs(spec)
    st = embed.TrainState(**{k: jnp.asarray(v) for k, v in state.items()})
    cs = embed.TrainConsts(**{k: jnp.asarray(v) for k, v in consts.items()})
    return st, {k: jnp.asarray(v) for k, v in stacked.items()}, \
        {k: jnp.asarray(v) for k, v in fb.items()}, cs, W, jnp.asarray(up), embed.HyperParams(**hkw)


def _jax_single(jx, spec):
    """The JAX single-device trajectory (``_plus_step`` and ``_bi_step`` a
    step: train_epoch_bi_refresh) and its predictions on the same planes."""
    M, steps, rb = spec[6], spec[7], spec[8]
    st, stacked, fb, cs, W, up, hp = _jax_step_inputs(jx, spec)
    jnp = jx["jnp"]
    cid = jnp.zeros(steps, jnp.int32)
    st, Wn = jx["bi"].train_epoch_bi_refresh(
        st, jnp.asarray(W), stacked, cid, fb, up, jnp.float32(LR), cs, hp, **FB_HYPER,
        slr_bi=SLR_BI, wd_bi=WD_BI, reg_bi=rb, off_item=OFF_ITEM, rows_per_user=M)
    pred = jx["bi"].predict_batches_bi(st, Wn, stacked, cid, fb, up, hp, OFF_ITEM, rows_per_user=M)
    return st, np.asarray(Wn), np.asarray(pred)


def _jax_mesh(jx, spec):
    """The JAX mesh's rounds (``sharded_bilinear_rounds`` or, big,
    ``sharded_bilinear_rounds_big``) on (n_data, n_model) of the CPU
    devices, unsharded to the single-device layout -> (state, W_bi)."""
    import dataclasses

    nd, nm, lay, nn, reg, regg, M, steps, rb = spec
    jax, jnp, P, NS = jx["jax"], jx["jnp"], jx["P"], jx["NS"]
    st, stacked, fb, cs, W, up, hp = _jax_step_inputs(jx, spec)
    mesh = jx["mesh"].make_mesh(nd, nm, jax.devices("cpu"))
    rep = NS(mesh, P())
    sst = {k: jax.device_put(v, NS(mesh, P(None, "data") if v.ndim == 2 else P(None, "data", None)))
           for k, v in stacked.items()}
    sfb = {k: jax.device_put(v, rep) for k, v in fb.items()}
    cid = jax.device_put(jnp.zeros(steps, jnp.int32), rep)
    sup = jax.device_put(up, rep)
    lrs = jnp.asarray([LR], jnp.float32)
    G, F = stacked["label"].shape[1] // M, fb["fb_idx"].shape[1]
    n = st.w.shape[0]
    hyper = (*FB_HYPER.values(), SLR_BI, WD_BI)
    if lay == "big":
        mb, bmb = jx["mesh_big"], jx["bmb"]
        bhp = dataclasses.replace(hp, num_factor=K)
        s0, n_real = mb.shard_state_big(st, mesh, K)
        Wb, nb_real = bmb.shard_bi_big(W, mesh)
        out, Wb = bmb.sharded_bilinear_rounds_big(mesh, bhp, n_real, nb_real, G, F, OFF_ITEM, NI,
                                                  rb, *hyper, M=M)(
            s0, Wb, sst, cid, sfb, sup, lrs, mb.shard_consts_big(cs, mesh, n_real))
        return mb.unshard_state_big(out, nm, K, n), np.asarray(bmb.unshard_bi_big(Wb, nm, nb_real,
                                                                                NI))
    m, bm = jx["mesh"], jx["bm"]
    s0, n_pad = m.shard_state(st, mesh)
    n_bi_pad = bm.pad_bi_rows(NI, nm)
    Wp = np.zeros((n_bi_pad, NBF), np.float32)
    Wp[:NI] = W
    Wb = jax.device_put(jnp.asarray(Wp), NS(mesh, P("model", None)))
    out, Wb = bm.sharded_bilinear_rounds(mesh, hp, n_pad, n_bi_pad, G, F, OFF_ITEM, rb, *hyper,
                                         M=M)(s0, Wb, sst, cid, sfb, sup, lrs,
                                              m.shard_consts(cs, mesh, n_pad))
    out = dataclasses.replace(out, w=out.w[:n], b=out.b[:n], ref_ui=out.ref_ui[:n])
    return out, np.asarray(Wb)[:NI]


def _unsharded(world, name, nd, nm):
    """Each data row's results of a case (rank d * nm holds row d's)."""
    return [{k.split("/")[1]: v for k, v in world["ranks"][d * nm].items()
             if k.startswith(name + "/")} for d in range(nd)]


def _close(got, want, W_want, tol):
    for key in ("w", "b", "g"):
        np.testing.assert_allclose(got[key], np.asarray(getattr(want, key)), **tol, err_msg=key)
    np.testing.assert_allclose(got["W_bi"], W_want, **tol, err_msg="W_bi")


# ---- the tests ------------------------------------------------------------------------
@pytest.mark.parametrize("name", [n for n in step_cases() if n.startswith("step-")])
def test_step_matches_jax_mesh_and_single(world, jx, name):
    """tests/test_side_solvers.py's bilinear step on a mesh: one step of
    the port's mesh (1x1, 2x1, 1x2, 2x2 for reg_bi 0-5 with the clamps off
    and on in turn, small slabs; 2x2 on big slabs) equals the JAX mesh's
    step and the single-device ``_plus_step`` + ``_bi_step``, table, W_bi
    and predictions; W_bi's padded dummy row stays 0."""
    spec = step_cases()[name]
    single, W_single, pred = _jax_single(jx, spec)
    mesh_out, W_mesh = _jax_mesh(jx, spec)
    for got in _unsharded(world, name, spec[0], spec[1]):
        _close(got, single, W_single, STEP_TOL)
        _close(got, mesh_out, W_mesh, STEP_TOL)
        assert int(got["step"]) == int(single.step)
        assert not got["W_pad_row"].any()
    for r in range(spec[0] * spec[1]):
        np.testing.assert_allclose(world["ranks"][r][f"{name}/pred"], pred, **STEP_TOL)


@pytest.mark.parametrize("name", [n for n in step_cases() if not n.startswith("step-")])
def test_trajectory_matches_jax_mesh_and_single(world, jx, name):
    """Five steps of the lazy modes (reg_method = reg_global = 4 and 5) and
    four of M = 2 (the damped Jacobi step), on 2x2 small and big slabs,
    follow JAX's mesh and its single-device trajectory, W_bi included."""
    spec = step_cases()[name]
    single, W_single, pred = _jax_single(jx, spec)
    mesh_out, W_mesh = _jax_mesh(jx, spec)
    for got in _unsharded(world, name, 2, 2):
        _close(got, single, W_single, TRAJ_TOL)
        _close(got, mesh_out, W_mesh, TRAJ_TOL)
    for r in range(WORLD):
        np.testing.assert_allclose(world["ranks"][r][f"{name}/pred"], pred, **TRAJ_TOL)


@pytest.mark.parametrize("lay,reg,want", [("small", 0, 4), ("small", 4, 5), ("big", 0, 4)])
def test_bilinear_step_adds_no_collective(world, lay, reg, want):
    """A bilinear mesh step makes the SVD++ mesh step's collectives and no
    more (the plug rides the model call, the W_bi entries the row updates'
    gather): four, five in the small lazy modes; a prediction batch two."""
    for r in range(WORLD):
        got = {k.split("/")[1]: int(v) for k, v in world["ranks"][r].items()
               if k.startswith("collectives/")}
        for solver in ("svdpp", "bilinear"):
            assert got[f"{solver}-{lay}-reg{reg}-step"] == want, (r, solver)
            assert got[f"{solver}-{lay}-reg{reg}-predict"] == 2, (r, solver)


@pytest.fixture(scope="module")
def jax_runs(jx, tmp_path_factory):
    """The JAX package's mesh for each trainer run, computed on first use."""
    cache = {}
    tmp = tmp_path_factory.mktemp("jax_bi_runs")

    def get(name):
        if name not in cache:
            cache[name] = drive("svdfeature_tpu", name, tmp)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def single_runs(tmp_path_factory):
    """The port's single-device trainer for each run, computed on first use."""
    cache = {}
    tmp = tmp_path_factory.mktemp("single_bi_runs")

    def get(name):
        if name not in cache:
            cache[name] = drive("svdfeature_tpu_torch", name, tmp, [("device", "cpu")], mesh=False)
        return cache[name]

    return get


def _rank_run(world, r, name):
    return {k.split("/", 1)[1]: v for k, v in world["ranks"][r].items()
            if k.startswith(name + "/")}


@pytest.mark.parametrize("name", list(runs()))
def test_trainer_run_matches_jax_mesh_and_single(world, jax_runs, single_runs, name):
    """The bilinear trainer's mesh branches against the JAX package's 2x2
    mesh and the port's single device on the same conf and data:
    tests/test_side_solvers.py::test_bilinear_mesh_matches_single_device
    (reg_bi 0, 2, 5, start_ufeedback 2),
    tests/test_mesh_big.py::test_bilinear_mesh_big_config_path ((reg_bi,
    start) (0, 0) and (2, 2) on big slabs),
    tests/test_side_multirow.py's M = 2 mesh runs (staged, and streamed in
    4-block chunks), common_feedback_space=1 on the mesh, and big slabs
    staged and streamed: the model, W_bi and the predictions on every rank,
    within rtol 1e-4 + atol 1e-5."""
    want, single = jax_runs(name), single_runs(name)
    assert bool(want["big"]) == (runs()[name][1].get("mesh_big") == 1)
    for r in range(WORLD):
        got = _rank_run(world, r, name)
        assert bool(got["big"]) == bool(want["big"])
        for key in ("w", "b", "g", "W_bi", "pred"):
            np.testing.assert_allclose(got[key], want[key], **TRAJ_TOL, err_msg=f"rank {r} {key}")
            np.testing.assert_allclose(got[key], single[key], **TRAJ_TOL,
                                       err_msg=f"rank {r} {key} single")


@pytest.mark.parametrize("name", ["multirow-streamed", "big-streamed"])
def test_streamed_mesh_equals_staged_mesh(world, name):
    """A streamed buffer of whole-batch chunks trains on the mesh as the
    staged pack does (tests/test_side_multirow.py::
    test_bilinear_multirow_streamed_mesh_matches_staged): the same model,
    W_bi and predictions as the staged run of as many rounds."""
    staged = name.replace("streamed", "staged")
    for r in range(WORLD):
        got, want = _rank_run(world, r, name), _rank_run(world, r, staged)
        for key in ("w", "b", "g", "W_bi", "pred"):
            np.testing.assert_allclose(got[key], want[key], **TRAJ_TOL, err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("name", ["side-reg0", "big-reg2-start2", "multirow"])
def test_checkpoint_matches_jax_mesh(world, jax_runs, name):
    """The checkpoint a mesh writes (rank 0; W_bi gathered over ``model``
    by the ranks of data row 0, de-padded or de-interleaved) has the JAX
    mesh checkpoint's length and layout, its values within 1e-5."""
    got, want = world["ranks"][0][f"{name}/ckpt"], jax_runs(name)["ckpt"]
    assert got.shape == want.shape
    got, want = read_checkpoint(got), read_checkpoint(want)
    for key in ("w", "b", "g", "W_bi"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=CLI_TOL, err_msg=key)
    for r in range(1, WORLD):
        assert f"{name}/ckpt" not in world["ranks"][r]


def test_data_copies_of_each_shard_are_equal(world):
    """Every data replica of a model shard applies the same gathered
    updates: the unsharded tables and W_bi of the two data rows, and the
    W_bi slabs of the ranks of one model position, are equal bit for bit
    after every case and run."""
    for name, spec in step_cases().items():
        nd, nm = spec[0], spec[1]
        rows = _unsharded(world, name, nd, nm)
        for other in rows[1:]:
            for key in ("w", "b", "g", "ref_ui", "W_bi"):
                np.testing.assert_array_equal(other[key], rows[0][key], err_msg=f"{name}/{key}")
        for d in range(1, nd):
            for m in range(nm):
                np.testing.assert_array_equal(world["ranks"][d * nm + m][f"{name}/Wb_local"],
                                              world["ranks"][m][f"{name}/Wb_local"], err_msg=name)
    for name in runs():
        for r in range(1, WORLD):
            for key in ("w", "b", "g", "W_bi", "pred"):
                np.testing.assert_array_equal(world["ranks"][r][f"{name}/{key}"],
                                              world["ranks"][0][f"{name}/{key}"],
                                              err_msg=f"{name}/{key} rank {r}")
        for m in range(2):
            np.testing.assert_array_equal(world["ranks"][2 + m][f"{name}/Wb_local"],
                                          world["ranks"][m][f"{name}/Wb_local"], err_msg=name)


@pytest.fixture(scope="module")
def cli_reference(world, jx):
    """Three rounds, the prediction and the evaluation of the conf through
    the JAX package's 2x2 mesh CLI (its trainer on the CPU devices)."""
    from svdfeature_tpu.infer.task import SVDInferTask as JInfer
    from svdfeature_tpu.train.loop import SVDTrainTask as JTrain

    d = world["dir"]
    keys = ("mesh_data=2", "mesh_model=2")
    args = cli_args(d, "jaxmesh", *keys, "num_round=3")
    JTrain().run(args[0], args[1:])
    args = cli_args(d, "jaxmesh", *keys, "pred=3", f"name_pred={d}/pred_jax.txt")
    JInfer().run(args[0], args[1:])
    args = cli_args(d, "jaxmesh", *keys, "start=0", "end=4", f"log_eval={d}/eval_jax.tsv")
    JInfer().run(args[0], args[1:])
    return d


@pytest.mark.parametrize("rnd", [2, 3])
def test_cli_checkpoints_match_jax_mesh(cli_reference, rnd):
    """The bilinear CLI under the 4-rank world (train 2 rounds, resume with
    continue=1 for a third: W_bi loaded, then sharded): each checkpoint,
    written by rank 0, of the JAX mesh checkpoint's length, within 1e-5 of
    it, W_bi included."""
    d = cli_reference
    raw = {tag: (d / f"models_{tag}" / f"{rnd:04d}.model").read_bytes()
           for tag in ("mesh", "jaxmesh")}
    assert len(raw["mesh"]) == len(raw["jaxmesh"])
    got, want = (read_checkpoint(np.frombuffer(raw[tag][4:], np.uint8))
                 for tag in ("mesh", "jaxmesh"))
    for key in ("w", "b", "g", "W_bi"):
        np.testing.assert_allclose(got[key], want[key], atol=CLI_TOL, err_msg=key)


def test_cli_pred_and_eval_match_jax_mesh(cli_reference):
    """pred=3 and the evaluation of rounds 0-3 on the 4-rank world: rank 0
    wrote one pred file and one eval log, within 1e-5 of JAX's mesh CLI."""
    d = cli_reference
    got, want = np.loadtxt(d / "pred_mesh.txt"), np.loadtxt(d / "pred_jax.txt")
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=CLI_TOL)
    got, want = np.loadtxt(d / "eval_mesh.tsv"), np.loadtxt(d / "eval_jax.tsv")
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got, want, atol=CLI_TOL)


if __name__ == "__main__":
    worker(pathlib.Path(sys.argv[1]))
