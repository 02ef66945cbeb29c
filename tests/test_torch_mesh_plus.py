"""The user-group solvers on a device mesh in the port (parallel/svdpp_mesh.py,
svdpp_mesh_big.py, imfb_mesh.py, imfb_mesh_big.py and the SVD++ and
multi-IMFB trainers' mesh branches) against the JAX package's mesh
(tests/test_svdpp_sharding.py, tests/test_mesh_big.py, tests/test_side_solvers.py,
tests/test_side_multirow.py, tests/test_rank.py, tests/test_streaming.py).

One torchrun world of WORLD = 4 gloo ranks on the CPU runs every case in
one launch (the module fixture ``world``; this file run as a script is a
rank's program), as tests/test_torch_mesh.py does.  The inputs are made
with numpy from seeds: the steps' toy tables and batches (``toy_plus``),
and the text of each trainer run's user-group data, the same text the JAX
tests load.  A rank saves what it computed (the unsharded tables of its
data row, the predictions gathered on every rank); the tests hand the same
inputs to the JAX package's mesh on the 8-device CPU mesh of
tests/conftest.py (and, for the steps, to its single-device step), lazily,
one fixture a case.  Tolerances are the JAX tests': rtol 2e-5 + atol 1e-6
for one step, rtol 1e-4 + atol 1e-5 for several steps or rounds, 1e-5 for
the CLI's checkpoints, predictions and evaluation.  The data copies of
each model shard must be equal bit for bit.
"""

import dataclasses
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
K = 8
STEP_TOL = dict(rtol=2e-5, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
CLI_TOL = 1e-5
FB_HYPER = dict(scale_lr_ufeedback=1.0, wd_ufeedback=0.004, wd_ufeedback_bias=0.002)
LR = 0.01


# ---- the steps' inputs, made alike by the ranks and the tests ------------------
def toy_plus(nonneg, M=1, G=8, F=16, seed=0):
    """numpy (state, batch, fb, consts) of tests/test_svdpp_sharding.py's
    toy: 12 users, 20 items and 16 feedback rows (the dummy row last), G
    users of M slots a step (slot g*M + m, ragged for M > 1), one absent
    user, an item of value 0, and a pool of 1-2 entries a user."""
    nu, ni, nf, n_g = 12, 20, 16, 5
    n = nu + ni + nf
    rng = np.random.RandomState(seed)
    f32 = np.float32
    w = (rng.randn(n + 1, K) * 0.1).astype(f32)
    b = (rng.randn(n + 1) * 0.1).astype(f32)
    g = (rng.randn(n_g) * 0.1).astype(f32)
    w[-1], b[-1], g[-1] = 0.0, 0.0, 0.0
    state = dict(w=w, b=b, g=g, step=np.int32(0), ref_ui=np.zeros(n + 1, np.int32),
                 ref_g=np.zeros(n_g, np.int32))
    S = G * M
    slot_user = np.arange(S) // M
    batch = dict(
        label=rng.randint(1, 6, S).astype(f32), weight=np.ones(S, f32),
        g_idx=rng.randint(0, n_g - 1, (S, 1)).astype(np.int32), g_val=rng.rand(S, 1).astype(f32),
        u_idx=(slot_user % nu).astype(np.int32)[:, None], u_val=np.ones((S, 1), f32),
        i_idx=(nu + rng.randint(0, ni, (S, 2))).astype(np.int32),
        i_val=(rng.rand(S, 2) + 0.1).astype(f32))
    batch["i_val"][0, 1] = 0.0  # a real id of value 0: its touch still counts
    rows = rng.randint(1, M + 1, G)
    rows[G - 1] = 0  # one absent user
    absent = (np.arange(S) % M) >= rows[slot_user]
    for key, fill in (("weight", 0), ("label", 0), ("u_idx", n), ("u_val", 0), ("i_idx", n),
                      ("i_val", 0), ("g_idx", n_g - 1), ("g_val", 0)):
        batch[key][absent] = fill
    fb_idx, fb_val, fb_block = np.full(F, n, np.int32), np.zeros(F, f32), np.full(F, G, np.int32)
    pos = 0
    for u in range(G - 1):
        for _ in range(rng.randint(1, 3)):
            if pos < F:
                fb_idx[pos], fb_val[pos], fb_block[pos] = nu + ni + rng.randint(0, nf), \
                    rng.rand() + 0.1, u
                pos += 1
    fb = dict(fb_idx=fb_idx, fb_val=fb_val, fb_block=fb_block)
    consts = dict(wd_u_row=np.full(n + 1, 0.004, f32), wd_i_row=np.full(n + 1, 0.003, f32),
                  wd_g_row=np.append(np.full(n_g - 1, 0.002, f32), f32(0)),
                  wd_user_bias=f32(0.004), wd_item_bias=f32(0.004))
    return state, batch, fb, consts


def step_cases():
    """name -> (n_data, n_model, layout, nonneg, reg_method, reg_global, M,
    steps): one step on every mesh shape and both clamps (small slabs; 2x2
    on big slabs too), five steps of the lazy modes, four of M = 4."""
    out = {}
    for nd, nm in [(1, 1), (2, 1), (1, 2), (2, 2)]:
        for nn in (0, 1):
            for lay in ("small", "big") if (nd, nm) == (2, 2) else ("small",):
                out[f"step-{nd}x{nm}-nn{nn}-{lay}"] = (nd, nm, lay, nn, 0, 0, 1, 1)
    for reg, regg in [(4, 0), (5, 0), (4, 4), (5, 5)]:
        for lay in ("small", "big"):
            out[f"traj-reg{reg}{regg}-{lay}"] = (2, 2, lay, 0, reg, regg, 1, 5)
    for lay in ("small", "big"):
        out[f"multirow-{lay}"] = (2, 2, lay, 0, 0, 0, 4, 4)
    return out


def stacked_inputs(spec):
    """The toy's step repeated ``steps`` times as ``[T, G*M]`` planes, one
    chunk, and the hyperparameters' switches."""
    nd, nm, lay, nn, reg, regg, M, steps = spec
    state, batch, fb, consts = toy_plus(nn, M)
    stacked = {k: np.stack([v] * steps) for k, v in batch.items()}
    return state, stacked, {k: v[None] for k, v in fb.items()}, consts, \
        dict(base_score=3.0, user_nonnegative=nn, item_nonnegative=nn, reg_method=reg,
             reg_global=regg)


# ---- the trainer runs: user-group text, the same for both packages -----------------
def text_users(seed, users, nrows, nfb, fb_range, n_item):
    """tests/test_svdpp_sharding.py's config-path data: per user the block
    size and feedback count first, then its feedback ids (value 1) and rows."""
    rng = np.random.RandomState(seed)
    rows, fbs = [], []
    for u in range(users):
        r, nf = int(rng.randint(*nrows)), int(rng.randint(*nfb))
        fbs.append(f"{r} {nf} " + " ".join(f"{rng.randint(0, fb_range)}:1" for _ in range(nf)))
        rows += [f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, n_item)}:1" for _ in range(r)]
    return rows, fbs


def text_rows_first(seed, users, nrows, n_item, fb_pool):
    """tests/test_mesh_big.py's data: a user's rows first, then 1-4
    distinct feedback ids of value 0.5."""
    rng = np.random.RandomState(seed)
    rows, fbs = [], []
    for u in range(users):
        r = rng.randint(*nrows)
        rows += [f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, n_item)}:1" for _ in range(r)]
        nf = rng.randint(1, 5)
        ids = rng.choice(fb_pool, size=nf, replace=False)
        fbs.append(f"{r} {nf} " + " ".join(f"{j}:0.5" for j in ids))
    return rows, fbs


def text_tiny():
    """tests/test_side_solvers.py's tiny_plus."""
    rng = np.random.RandomState(0)
    rows, fbs = [], []
    for u in range(8):
        n = 3 + u % 3
        items = rng.choice(20, n, replace=False)
        rows += [f"{rng.randint(1, 6)} 0 1 1 {u}:1 {i}:1" for i in items]
        v = 1.0 / np.sqrt(n)
        fbs.append(f"{n} {n} " + " ".join(f"{i}:{v:.6f}" for i in items))
    return rows, fbs


def text_streaming(seed=3, users=12):
    """tests/test_streaming.py's make_plus_ds."""
    rng = np.random.RandomState(seed)
    rows, fbs = [], []
    for u in range(users):
        r, nf = int(rng.randint(2, 7)), int(rng.randint(1, 5))
        fbs.append(f"{r} {nf} " + " ".join(f"{rng.randint(0, 15)}:{rng.rand():.3f}"
                                           for _ in range(nf)))
        rows += [f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 12)}:1" for _ in range(r)]
    return rows, fbs


def text_pairs():
    """tests/test_rank.py's _skewed_pair_ds."""
    rng = np.random.RandomState(4)
    rows, fbs = [], []
    for u in range(12):
        items = rng.choice(30, min(2 + 7 * (u % 5), 30), replace=False)
        rows += [f"{float(1 if i < 15 else 0)} 1 1 1 0:0.5 {u}:1 {i}:1" for i in items]
        fbs.append(f"{len(items)} 0")
    return rows, fbs


DATA = {
    "config": lambda: text_users(3, 12, (3, 7), (2, 5), 15, 20),
    "lazy": lambda: text_users(7, 10, (3, 8), (2, 5), 15, 20),
    "big": lambda: text_rows_first(3, 16, (2, 6), 30, 12),
    "imfb-big": lambda: text_rows_first(5, 12, (2, 5), 24, 10),
    "tiny": text_tiny,
    "stream": text_streaming,
    "pairs": text_pairs,
}
NESTED = ("imfb-big", "tiny")  # the first two users under one outer context (depth 2)
STACKED_TAGS = ("START DEFAULT DEFAULT MIDDLE END DEFAULT START DEFAULT MIDDLE END DEFAULT "
                "DEFAULT").split()  # tests/test_streaming.py's make_stacked_ds

BASE = dict(num_factor=K, base_score=3, learning_rate=LR, wd_user=0.004, wd_item=0.004,
            wd_ufeedback=0.004)
STREAM = dict(BASE, num_user=12, num_item=12, num_ufeedback=15, users_per_batch=2)
M22 = dict(mesh_data=2, mesh_model=2)
BIG = dict(M22, mesh_big=1)


def runs():
    """name -> (solver, data, stacked tags, params, rounds, how): how is
    ``all`` (update_all a round), ``stream`` (a streamed buffer of 4-block
    chunks, the probe streamed too) or ``pair`` (update_rounds on a pair
    source, the probe a fresh epoch)."""
    cfg = dict(BASE, num_user=12, num_item=20, num_ufeedback=15, users_per_batch=5)
    out = {
        "svdpp-config": ("svdpp", "config", None, dict(cfg, **M22), 3, "all"),
        "svdpp-m2-lazy": ("svdpp", "lazy", None, dict(cfg, num_user=10, rows_per_user=2,
                                                      reg_method=4, **M22), 3, "all"),
        "imfb-nested": ("imfb", "tiny", None, dict(
            BASE, num_user=8, num_item=20, num_ufeedback=20, num_global=0, wd_user=0.01,
            wd_item=0.01, ufeedback_disable_level=1, **M22), 3, "all"),
        "imfb-m2": ("imfb", "stream", STACKED_TAGS, dict(STREAM, rows_per_user=2, **M22), 5,
                    "all"),
        "imfb-m2-streamed": ("imfb", "stream", STACKED_TAGS, dict(STREAM, rows_per_user=2, **M22),
                             3, "stream"),
        "imfb-all-default": ("imfb", "stream", None, dict(STREAM, **M22), 2, "all"),
        "svdpp-default": ("svdpp", "stream", None, dict(STREAM, **M22), 2, "all"),
        "svdpp-big-streamed": ("svdpp", "stream", None, dict(STREAM, **BIG), 2, "stream"),
        "pairs": ("rank", "pairs", None, dict(  # tests/test_rank.py's _mini_rank_trainer
            learning_rate=LR, wd_user=0.004, wd_item=0.004, num_user=12, num_item=30,
            num_global=6, num_factor=K, num_ufeedback=30, wd_ufeedback=0.004, no_user_bias=1,
            users_per_batch=4, **M22), 5, "pair"),
    }
    for reg, m in [(0, 1), (1, 1), (4, 1), (5, 1), (0, 2)]:
        out[f"svdpp-big-reg{reg}-m{m}"] = ("svdpp", "big", None, dict(
            BASE, num_user=16, num_item=30, num_ufeedback=12, users_per_batch=4, reg_method=reg,
            rows_per_user=m, **BIG), 3, "all")
    for reg in (0, 4):
        out[f"imfb-big-reg{reg}"] = ("imfb", "imfb-big", None, dict(
            BASE, num_user=12, num_item=24, num_ufeedback=10, users_per_batch=4, reg_method=reg,
            ufeedback_disable_level=1, **BIG), 3, "all")
    return out


def dataset(pkg: str, data: str, tags):
    """The run's PlusDataset in package ``pkg`` (svdfeature_tpu or the port)."""
    csr = importlib.import_module(f"{pkg}.data.csr")
    text = importlib.import_module(f"{pkg}.data.text")
    rows, fbs = DATA[data]()
    ds = text.load_plus_text("x", "y", text="\n".join(rows), feedback_text="\n".join(fbs))
    blocks = list(ds.blocks())
    if data in NESTED:
        blocks = [csr.PlusBlock(blocks[0].fb_index[:2], blocks[0].fb_value[:2], blocks[0].data,
                                extend_tag=csr.TAG_START),
                  csr.PlusBlock(blocks[1].fb_index, blocks[1].fb_value, blocks[1].data,
                                extend_tag=csr.TAG_END)] + blocks[2:]
    elif tags is not None:
        blocks = [csr.PlusBlock(b.fb_index, b.fb_value, b.data,
                                extend_tag=getattr(csr, f"TAG_{t}")) for b, t in zip(blocks, tags)]
    else:
        return ds
    return csr.PlusDataset.from_blocks(blocks)


def drive(pkg: str, name: str, tmp: pathlib.Path, extra=()) -> dict:
    """Train run ``name`` through package ``pkg``'s trainer and predict its
    probe; returns (w, b, g, pred) as numpy (on a mesh, on every rank)."""
    solver, data, tags, params, rounds, how = runs()[name]
    params_mod = importlib.import_module(f"{pkg}.params")
    mod = importlib.import_module(f"{pkg}.solvers.{'multi_imfb' if solver == 'imfb' else 'svdpp'}")
    cls = mod.SVDPPMultiIMFBTrainer if solver == "imfb" else mod.SVDPPFeatureTrainer
    mtype = params_mod.SVDTypeParam(format_type=1, extend_type=2 if solver == "imfb" else 0,
                                    active_type=3 if solver == "rank" else 0)
    tr = cls(mtype)
    for k, v in [*params.items(), *extra]:
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    ds = dataset(pkg, data, tags)
    if how == "pair":
        rank = importlib.import_module(f"{pkg}.data.rank")
        registry = importlib.import_module(f"{pkg}.data.registry")
        tr.update_rounds(rank.PairSource(ds, registry.IteratorConfig(), seed=9), rounds)
        probe = rank.PairSource(ds, registry.IteratorConfig(), seed=31).epoch_dataset()
    elif how == "stream":
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
    pred = np.asarray(tr.predict_all(probe))
    tr._sync_model_from_state()
    out = {key: np.asarray(getattr(tr.model, key)) for key in ("w", "b", "g")}
    out["pred"] = pred
    out["big"] = np.asarray(bool(getattr(tr, "_mesh_big", False)))
    return out


# ---- the CLI ------------------------------------------------------------------------
CLI_CONF = "".join(f"{k} = {v}\n" for k, v in dict(
    STREAM, format_type=1, num_global=0, silent=1).items())
MESH = ("distributed=1", "mesh_data=2", "mesh_model=2", "device=cpu")


def cli_args(d, tag, *extra):
    return [str(d / "plus.conf"), f"model_out_folder={d}/models_{tag}", "silent=1", *extra]


# ---- the rank's program -----------------------------------------------------------
def _run_step_case(name, spec, out):
    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.ops.embed import HyperParams
    from svdfeature_tpu_torch.ops.svdpp import PlusHyper
    from svdfeature_tpu_torch.parallel import comm
    from svdfeature_tpu_torch.parallel import mesh as pmesh
    from svdfeature_tpu_torch.parallel import mesh_big as pbig
    from svdfeature_tpu_torch.parallel import svdpp_mesh, svdpp_mesh_big

    nd, nm, lay, nn, reg, regg, M, steps = spec
    cpu = torch.device("cpu")
    mesh = comm.make_mesh(nd, nm, cpu, ranks=range(nd * nm))
    if mesh is None:
        return
    state, stacked, fb, consts, hkw = stacked_inputs(spec)
    st = convert.state_from_numpy(**state, device=cpu)
    cs = convert.consts_from_numpy(**consts, device=cpu)
    stacked = convert.stacked_from_numpy(pmesh.put_process_sharded(stacked, mesh), cpu)
    fb, _ = convert.pool_from_numpy(fb, None, cpu)
    cid = np.zeros(steps, np.int32)
    ph = PlusHyper(rows_per_user=M, **FB_HYPER)
    lrs = torch.tensor([LR], dtype=torch.float32)
    n = st.w.shape[0]
    if lay == "big":
        hp = HyperParams(num_factor=K, **hkw)
        local, n_real = pbig.shard_state_big(st, mesh, K)
        cs = pbig.shard_consts_big(cs, mesh, n_real)
        local = svdpp_mesh_big.sharded_svdpp_rounds_big(local, stacked, cid, fb, lrs, cs, hp, ph,
                                                        mesh, n_real)
        full = pbig.unshard_big(local, mesh, K, n)
        pred = svdpp_mesh_big.sharded_svdpp_predict_big(local, stacked, cid, fb, hp, mesh, n_real,
                                                        M)
    else:
        hp = HyperParams(**hkw)
        local, n_pad = pmesh.shard_state(st, mesh)
        cs = pmesh.shard_consts(cs, mesh, n_pad)
        local = svdpp_mesh.sharded_svdpp_rounds(local, stacked, cid, fb, lrs, cs, hp, ph, mesh,
                                                n_pad)
        full = pmesh.unshard_state(local, mesh, n)
        pred = svdpp_mesh.sharded_svdpp_predict(local, stacked, cid, fb, hp, mesh, n_pad, M)
    for key in ("w", "b", "g", "step", "ref_ui", "ref_g"):
        out[f"{name}/{key}"] = getattr(full, key).numpy().copy()
    out[f"{name}/pred"] = pmesh.gather_predictions(pred, mesh).numpy()


def _run_cli(d, out):
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
    scratch = d / f"rank{comm.rank()}"
    scratch.mkdir(exist_ok=True)
    for name in runs():
        for key, val in drive("svdfeature_tpu_torch", name, scratch, [("device", "cpu")]).items():
            out[f"{name}/{key}"] = val
    _run_cli(d, out)
    np.savez(d / f"out_rank{comm.rank()}.npz", **out)


# ---- the world, launched once a module ------------------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Write the CLI's buffers and conf, launch the WORLD ranks with torchrun
    (each runs ``worker``), and load every rank's results."""
    from svdfeature_tpu_torch.data.buffer import write_plus_buffer
    from svdfeature_tpu_torch.data.text import load_plus_text

    d = tmp_path_factory.mktemp("mesh_plus_world")
    for split, seed in (("train", 3), ("test", 11)):
        rows, fbs = text_streaming(seed)
        write_plus_buffer(str(d / f"{split}.buffer"), load_plus_text(
            "x", "y", text="\n".join(rows), feedback_text="\n".join(fbs)))
    (d / "plus.conf").write_text(CLI_CONF + f'buffer_feature = "{d}/train.buffer"\n'
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

    from svdfeature_tpu.ops import embed, svdpp
    from svdfeature_tpu.parallel import mesh, mesh_big, svdpp_mesh, svdpp_mesh_big

    return dict(jax=jax, jnp=jnp, NS=NamedSharding, P=P, embed=embed, svdpp=svdpp, mesh=mesh,
                mesh_big=mesh_big, svdpp_mesh=svdpp_mesh, svdpp_mesh_big=svdpp_mesh_big)


def _jax_step_inputs(jx, spec):
    jnp, embed = jx["jnp"], jx["embed"]
    state, stacked, fb, consts, hkw = stacked_inputs(spec)
    st = embed.TrainState(**{k: jnp.asarray(v) for k, v in state.items()})
    cs = embed.TrainConsts(**{k: jnp.asarray(v) for k, v in consts.items()})
    return st, {k: jnp.asarray(v) for k, v in stacked.items()}, \
        {k: jnp.asarray(v) for k, v in fb.items()}, cs, embed.HyperParams(**hkw)


def _jax_single(jx, spec):
    """The JAX single-device trajectory (``_plus_step`` a step) and its
    predictions on the same planes."""
    M, steps = spec[6], spec[7]
    st, stacked, fb, cs, hp = _jax_step_inputs(jx, spec)
    jnp = jx["jnp"]
    lr = jnp.float32(LR)
    lr_fb = LR * FB_HYPER["scale_lr_ufeedback"]
    fbh = (jnp.float32(lr_fb), jnp.float32(1.0 - lr_fb * FB_HYPER["wd_ufeedback"]),
           jnp.float32(1.0 - lr_fb * FB_HYPER["wd_ufeedback_bias"]))
    cfb = {k: v[0] for k, v in fb.items()}
    for t in range(steps):
        st = jx["svdpp"]._plus_step(st, {k: v[t] for k, v in stacked.items()}, cfb, lr, cs, hp,
                                     fbh, rows_per_user=M)
    pred = jx["svdpp"].predict_batches_plus(st, stacked, jnp.zeros(steps, jnp.int32), fb, hp,
                                            rows_per_user=M)
    return st, np.asarray(pred)


def _jax_mesh(jx, spec):
    """The JAX mesh's rounds (``sharded_svdpp_rounds`` or, big,
    ``sharded_svdpp_rounds_big``) on (n_data, n_model) of the CPU devices,
    unsharded to the single-device layout."""
    nd, nm, lay, nn, reg, regg, M, steps = spec
    jax, jnp, P, NS = jx["jax"], jx["jnp"], jx["P"], jx["NS"]
    st, stacked, fb, cs, hp = _jax_step_inputs(jx, spec)
    mesh = jx["mesh"].make_mesh(nd, nm, jax.devices("cpu"))
    rep = NS(mesh, P())
    sst = {k: jax.device_put(v, NS(mesh, P(None, "data") if v.ndim == 2 else P(None, "data", None)))
           for k, v in stacked.items()}
    sfb = {k: jax.device_put(v, rep) for k, v in fb.items()}
    cid = jax.device_put(jnp.zeros(steps, jnp.int32), rep)
    lrs = jnp.asarray([LR], jnp.float32)
    G, F = stacked["label"].shape[1] // M, fb["fb_idx"].shape[1]
    n = st.w.shape[0]
    hyper = tuple(FB_HYPER.values())
    if lay == "big":
        mb = jx["mesh_big"]
        bhp = dataclasses.replace(hp, num_factor=K)
        s0, n_real = mb.shard_state_big(st, mesh, K)
        out = jx["svdpp_mesh_big"].sharded_svdpp_rounds_big(mesh, bhp, n_real, G, F, *hyper, M=M)(
            s0, sst, cid, sfb, lrs, mb.shard_consts_big(cs, mesh, n_real))
        return mb.unshard_state_big(out, nm, K, n)
    m = jx["mesh"]
    s0, n_pad = m.shard_state(st, mesh)
    out = jx["svdpp_mesh"].sharded_svdpp_rounds(mesh, hp, n_pad, G, F, *hyper, M=M)(
        s0, sst, cid, sfb, lrs, m.shard_consts(cs, mesh, n_pad))
    return dataclasses.replace(out, w=out.w[:n], b=out.b[:n], ref_ui=out.ref_ui[:n])


def _unsharded(world, name, nd, nm):
    """Each data row's results of a case (rank d * nm holds row d's)."""
    return [{k.split("/")[1]: v for k, v in world["ranks"][d * nm].items()
             if k.startswith(name + "/")} for d in range(nd)]


def _close(got, want, tol, keys=("w", "b", "g")):
    for key in keys:
        np.testing.assert_allclose(got[key], np.asarray(getattr(want, key)), **tol, err_msg=key)


# ---- the tests ------------------------------------------------------------------------
@pytest.mark.parametrize("name", [n for n in step_cases() if n.startswith("step-")])
def test_step_matches_jax_mesh_and_single(world, jx, name):
    """tests/test_svdpp_sharding.py::test_sharded_svdpp_matches_single: one
    SVD++ step of the port's mesh (1x1, 2x1, 1x2, 2x2; the clamps off and
    on; 2x2 on big slabs too) equals the JAX mesh's step and the
    single-device ``_plus_step``, and so do its predictions."""
    spec = step_cases()[name]
    single, pred = _jax_single(jx, spec)
    mesh_out = _jax_mesh(jx, spec)
    for got in _unsharded(world, name, spec[0], spec[1]):
        _close(got, single, STEP_TOL)
        _close(got, mesh_out, STEP_TOL)
        assert int(got["step"]) == int(single.step)
    for r in range(spec[0] * spec[1]):
        np.testing.assert_allclose(world["ranks"][r][f"{name}/pred"], pred, **STEP_TOL)


@pytest.mark.parametrize("name", [n for n in step_cases() if not n.startswith("step-")])
def test_trajectory_matches_jax_mesh_and_single(world, jx, name):
    """tests/test_svdpp_sharding.py::test_sharded_svdpp_lazy_reg_trajectory
    and ::test_sharded_svdpp_multirow: five steps of the lazy modes
    (reg_method, reg_global) = (4,0)/(5,0)/(4,4)/(5,5), and four of M = 4
    (the damped Jacobi step), on 2x2 small and big slabs, follow JAX's
    mesh and its single-device trajectory; the lazy stamps of the real
    rows and of the globals ride along (the dummy row's is inert)."""
    spec = step_cases()[name]
    single, pred = _jax_single(jx, spec)
    mesh_out = _jax_mesh(jx, spec)
    for got in _unsharded(world, name, 2, 2):
        _close(got, single, TRAJ_TOL)
        _close(got, mesh_out, TRAJ_TOL)
        if spec[4] >= 4 and spec[2] == "small":
            np.testing.assert_array_equal(got["ref_ui"][:-1], np.asarray(single.ref_ui)[:-1])
            np.testing.assert_array_equal(got["ref_g"], np.asarray(single.ref_g))
    for r in range(WORLD):
        np.testing.assert_allclose(world["ranks"][r][f"{name}/pred"], pred, **TRAJ_TOL)


@pytest.fixture(scope="module")
def jax_runs(jx, tmp_path_factory):
    """The JAX package's mesh for each trainer run, computed on first use."""
    cache = {}
    tmp = tmp_path_factory.mktemp("jax_runs")

    def get(name):
        if name not in cache:
            cache[name] = drive("svdfeature_tpu", name, tmp)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(runs()))
def test_trainer_run_matches_jax_mesh(world, jax_runs, name):
    """The trainers' mesh branches against the JAX package's mesh on the same
    conf and data: tests/test_svdpp_sharding.py's config paths (G padded 5
    -> 6; M = 2 with reg_method 4), tests/test_mesh_big.py's
    ::test_svdpp_mesh_big_config_path (reg 0/1/4/5 x M 1/2) and
    ::test_imfb_mesh_big_config_path (reg 0/4, nested contexts, a disabled
    level), tests/test_side_solvers.py::test_imfb_mesh_matches_single_device,
    tests/test_side_multirow.py's stacked M = 2 runs (staged, and streamed
    in 4-unit chunks), all-DEFAULT data through the multi-IMFB trainer (the
    SVD++ mesh path), tests/test_rank.py::test_pair_mesh_matches_single
    (5 pair rounds, a fresh packed epoch a round) and
    tests/test_streaming.py's streamed SVD++ on mesh_big: the model after
    the rounds and the predictions on every rank, within rtol 1e-4 +
    atol 1e-5."""
    want = jax_runs(name)
    assert bool(want["big"]) == (runs()[name][3].get("mesh_big") == 1)
    for r in range(WORLD):
        got = {k.split("/", 1)[1]: v for k, v in world["ranks"][r].items()
               if k.startswith(name + "/")}
        assert bool(got["big"]) == bool(want["big"])
        for key in ("w", "b", "g", "pred"):
            np.testing.assert_allclose(got[key], want[key], **TRAJ_TOL, err_msg=f"rank {r} {key}")


def test_all_default_stacked_data_is_svdpp_on_the_mesh(world):
    """All-DEFAULT data under extend_type=2 takes the SVD++ mesh path: the
    multi-IMFB trainer's run equals the SVD++ trainer's on the same conf
    and data, bit for bit, on every rank."""
    for r in range(WORLD):
        for key in ("w", "b", "g", "pred"):
            np.testing.assert_array_equal(world["ranks"][r][f"imfb-all-default/{key}"],
                                          world["ranks"][r][f"svdpp-default/{key}"], err_msg=key)


def test_data_copies_of_each_shard_are_equal(world):
    """Every data replica of a model shard applies the same gathered
    updates and the same full-pool writeback: the unsharded tables of the
    two data rows are equal bit for bit after every case and run."""
    for name, spec in step_cases().items():
        rows = _unsharded(world, name, spec[0], spec[1])
        for other in rows[1:]:
            for key in ("w", "b", "g", "ref_ui"):
                np.testing.assert_array_equal(other[key], rows[0][key], err_msg=f"{name}/{key}")
    for name in runs():
        for r in range(1, WORLD):
            for key in ("w", "b", "g", "pred"):
                np.testing.assert_array_equal(world["ranks"][r][f"{name}/{key}"],
                                              world["ranks"][0][f"{name}/{key}"],
                                              err_msg=f"{name}/{key} rank {r}")


def _read_model(path):
    from svdfeature_tpu_torch.model import SVDModel
    from svdfeature_tpu_torch.params import SVDTypeParam

    with open(path, "rb") as f:
        m = SVDModel.load(f, SVDTypeParam.from_bytes(f.read(4)), device=torch.device("cpu"))
    return {k: getattr(m, k).numpy() for k in ("w", "b", "g")}


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
    """The SVD++ CLI under the 4-rank world (train 2 rounds, resume with
    continue=1 for a third): each checkpoint, written by rank 0, within
    1e-5 of JAX's 2x2 mesh CLI."""
    d = cli_reference
    got = _read_model(d / "models_mesh" / f"{rnd:04d}.model")
    want = _read_model(d / "models_jaxmesh" / f"{rnd:04d}.model")
    for key in ("w", "b", "g"):
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
