"""The multi-card dry run and the weak-scaling report of the port.

PyTorch counterpart of the JAX repository's ``__graft_entry__.dryrun_multichip``
and ``scaling_report``.  JAX runs a mesh inside one process; the port runs
one process a mesh position (parallel/comm.py), so each function launches
its own torchrun worlds (``python -m torch.distributed.run --standalone
--nproc_per_node=D -m svdfeature_tpu_torch.multichip --rank ...``) and reads
what rank 0 wrote.  The ranks join through ``comm.init_distributed``: NCCL
with a card a rank, gloo when ranks share a card, gloo with
``device="cpu"``::

    python3 -m svdfeature_tpu_torch.multichip 4               # on the cards
    python3 -m svdfeature_tpu_torch.multichip 4 --device cpu  # 4 CPU ranks

* ``dryrun_multichip(n)`` builds a ``data x model`` mesh of ``n`` ranks
  (``n_model = 2`` for even ``n``) and walks every mesh path of the port at
  tiny shapes: the base step (and its lazy form), the two-round loop, a
  checkpoint and resume, the big-slab dedup step on slabs of more than
  BIG_TABLE_ROWS rows, the SVD++ step and its big-slab rounds, the stacked
  multi-IMFB rounds, the bilinear rounds with W_bi sharded (small and big
  slabs), streamed CSR and user-group chunks with their sharded evaluation,
  pairwiseRank rounds, and the M = 2 bilinear and stacked trainers.  Then it
  prints ``scaling_report {json}`` and the ``dryrun_multichip OK: ...`` line.
* ``scaling_report(n, b_per_device, k)`` runs the base solver's rounds on
  data-only meshes of 1, 2, 4, ... n ranks with a fixed batch a rank (weak
  scaling), the best of 3 warm calls of R x T steps, and models the bytes
  a step moves from the port's own collectives (``step_comm``).  Its
  ``_meta`` says whether the wall times are a performance claim: only with
  NCCL and one card a rank.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from typing import Dict

import numpy as np

WORLD_TIMEOUT_S = 900  # of one torchrun world
SCALE_ROUNDS, SCALE_STEPS = 2, 4  # R x T steps a timed call
NUM_USER, NUM_ITEM = 943, 1682  # the toy table of the dry run and the report


# ---- the toy inputs ------------------------------------------------------------------
def toy_setup(batch_size: int, num_user: int = NUM_USER, num_item: int = NUM_ITEM,
              k: int = 64, seed: int = 0):
    """numpy (state, batch, consts) of a ``[user | item]`` table with a
    zero dummy row last and no global feature (the one slot is the dummy),
    and one batch of ``batch_size`` (user, item) examples."""
    rng = np.random.RandomState(seed)
    n = num_user + num_item
    f32, i32 = np.float32, np.int32
    w = np.concatenate([(rng.randn(n, k) * 0.01).astype(f32), np.zeros((1, k), f32)])
    state = dict(w=w, b=np.zeros(n + 1, f32), g=np.zeros(1, f32), step=np.int32(0),
                 ref_ui=np.zeros(n + 1, i32), ref_g=np.zeros(1, i32))
    B = batch_size
    batch = dict(label=rng.randint(1, 6, B).astype(f32), weight=np.ones(B, f32),
                 g_idx=np.zeros((B, 1), i32), g_val=np.zeros((B, 1), f32),
                 u_idx=rng.randint(0, num_user, (B, 1)).astype(i32), u_val=np.ones((B, 1), f32),
                 i_idx=(num_user + rng.randint(0, num_item, (B, 1))).astype(i32),
                 i_val=np.ones((B, 1), f32))
    consts = dict(wd_u_row=np.full(n + 1, 0.004, f32), wd_i_row=np.full(n + 1, 0.004, f32),
                  wd_g_row=np.zeros(1, f32), wd_user_bias=f32(0.0), wd_item_bias=f32(0.0))
    return state, batch, consts


def step_comm(D: int, B: int, k: int, n_local: int, Su: int = 1, Si: int = 1,
              n_g: int = 1) -> Dict[str, float]:
    """The bytes of one base step (parallel/mesh.sharded_train_step) on a
    data-only mesh of ``D`` ranks, ``B`` examples a rank: what a rank
    passes to ``comm.psum`` (``batch_counts``: the touch counts of its
    ``n_local`` rows, the global slots' counts and the example count, f32;
    the global update's two sums of ``n_g`` slots where there is a global
    feature) and to ``comm.all_gather`` (``_apply_row_updates``: the ids,
    int32, coefficients and p-vectors of its entries), and what it
    receives: ``D - 1`` times the gathered payload and ``2 (D - 1) / D``
    times the summed one (a ring all-reduce).  The forward's psum is over
    ``model``, a group of one rank here, so it moves nothing; a group of
    one rank makes no collective at all (D = 1)."""
    if D == 1:
        return {"psum": 0, "all_gather": 0, "received": 0.0}
    psum = 4 * (2 * n_local + n_g + 1) + (4 * 2 * n_g if n_g > 1 else 0)
    gather = 4 * B * (2 * Su + 2 * Si) + 4 * 2 * B * k
    return {"psum": psum, "all_gather": gather,
            "received": (D - 1) * gather + 2 * (D - 1) / D * psum}


# ---- launching the worlds ---------------------------------------------------------------
def _world(D: int, *args: str) -> dict:
    """Run ``--rank *args OUT`` on a torchrun world of ``D`` ranks and return
    what rank 0 wrote to OUT (json); raise with the output if it failed."""
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
    with tempfile.TemporaryDirectory(prefix="multichip") as d:
        out = pathlib.Path(d) / "rank0.json"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={D}", "-m", "svdfeature_tpu_torch.multichip", "--rank", *args,
               str(out)]
        proc = subprocess.run(cmd, env=env, cwd=d, capture_output=True, text=True,
                              timeout=WORLD_TIMEOUT_S)
        if proc.returncode != 0 or not out.exists():
            raise RuntimeError(f"the {D}-rank world {args} failed ({proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        return json.loads(out.read_text())


def _sizes(n: int):
    sizes, d = [], 1
    while d <= n:
        sizes.append(d)
        d *= 2
    return sizes if sizes[-1] == n else sizes + [n]


def scaling_report(n_devices: int, b_per_device: int = 256, k: int = 16,
                   device: str = "cuda") -> dict:
    """Weak scaling of the base solver's rounds on data-only meshes of 1, 2,
    4, ... ``n_devices`` ranks (one torchrun world each), ``b_per_device``
    examples a rank a step: per size the step's milliseconds (the best of
    3 warm calls of SCALE_ROUNDS x SCALE_STEPS steps, every rank synchronised
    before and after), the examples a step, the bytes a rank receives a step
    (``step_comm``) and ``step_ms(1) / step_ms(D)``."""
    out: dict = {}
    backends = {}
    for D in _sizes(n_devices):
        r = _world(D, "scale", device, str(b_per_device), str(k))
        backends[str(D)] = r["backend"]
        comm = step_comm(D, b_per_device, k, r["n_local"])
        out[str(D)] = {
            "step_ms": r["step_ms"],
            "examples_per_step": b_per_device * D,
            "comm_bytes_per_step": int(comm["received"]),
            "efficiency_vs_1": out["1"]["step_ms"] / r["step_ms"] if "1" in out else 1.0,
            "backend": r["backend"],
        }
    cards = r["cards"]
    one_card_each = all(cards >= int(D) for D in backends)
    out["_meta"] = {
        "platform": "gpu" if device != "cpu" else "cpu",
        "device_name": r["device_name"],
        "card": r["card"],
        "backend": backends,
        "cards": cards,
        "mode": f"weak-scaling, fixed per-rank batch {b_per_device}, k={k}, "
                f"{SCALE_ROUNDS} rounds x {SCALE_STEPS} steps a call",
        "wall_times_are_perf_claim": (device != "cpu" and one_card_each
                                      and all(b == "nccl" for b in backends.values())),
    }
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Walk every mesh path of the port on a ``data x model`` mesh of
    ``n_devices`` ranks at tiny shapes (one torchrun world), then print the
    scaling report and the OK line."""
    r = _world(n_devices, "dryrun", device)
    report = scaling_report(n_devices, device=device)
    print("scaling_report " + json.dumps(report), flush=True)
    print(
        f"dryrun_multichip OK: mesh data={r['n_data']} x model={r['n_model']} ({r['backend']}), "
        f"table rows {r['n_pad']} sharded over {r['n_model']} shards; base step and its lazy "
        f"form OK; svdpp step OK (G={r['G']}, F={r['F']}); sharded round loop OK (2 rounds x "
        f"{r['T']} batches); mesh checkpoint-resume OK; big-slab dedup path OK ({r['n_real4']} "
        f"rows/shard > {r['big_rows']}); svdpp big-slab rounds OK ({r['n_real6']} rows/shard); "
        f"multi-IMFB mesh rounds OK (nseg={r['nseg']}); bilinear mesh rounds OK (W_bi "
        f"{r['n_bi_pad']}x{r['nbf']} sharded; big slabs {r['nb_real']} rows/shard); streamed "
        f"chunks x mesh OK (CSR + plus buffers, 2 rounds each); sharded streamed eval OK "
        f"({r['pred_csr']} + {r['pred_plus']} preds); pairwiseRank mesh rounds OK "
        f"({r['pred_rank']} pair scores); multirow (M=2) bilinear + stacked multi-IMFB mesh "
        f"rounds OK", flush=True)


# ---- the ranks' programs ----------------------------------------------------------------
def card_line() -> str:
    """The cards' names and power limits, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return "nvidia-smi not run"
    return "; ".join(sorted(set(out.stdout.strip().splitlines()))) or out.stderr.strip()



def _join(device: str):
    """Join the world; (rank, world size, this rank's device)."""
    import torch
    import torch.distributed as dist

    from .parallel import comm

    comm.init_distributed(device)
    dev = (torch.device("cuda", torch.cuda.current_device()) if device != "cpu"
           else torch.device("cpu"))
    return dist.get_rank(), dist.get_world_size(), dev


def staged_toy(state, batch, consts, mesh, T: int, dev):
    """(state, this rank's ``[T, B / n_data]`` columns of the batch repeated
    T times, consts) as tensors on ``dev``."""
    from . import convert
    from .parallel import mesh as pmesh

    stacked = {name: np.repeat(v[None], T, axis=0) for name, v in batch.items()}
    return (convert.state_from_numpy(**state, device=dev),
            convert.stacked_from_numpy(pmesh.put_process_sharded(stacked, mesh), dev),
            convert.consts_from_numpy(**consts, device=dev))


def _finite(*tensors) -> None:
    import torch

    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError("non-finite values in the dry run")


def scale_rank(device: str, b: str, k: str, out: str) -> None:
    """A rank of one scaling world: the base rounds on a data-only mesh of
    the world, timed; rank 0 writes the step's milliseconds."""
    import torch
    import torch.distributed as dist

    from .ops.embed import HyperParams
    from .parallel import comm
    from .parallel import mesh as pmesh

    rank, D, dev = _join(device)
    mesh = comm.make_mesh(D, 1, dev)
    state, batch, consts = toy_setup(int(b) * D, k=int(k))
    st, stacked, cs = staged_toy(state, batch, consts, mesh, SCALE_STEPS, dev)
    st, n_pad = pmesh.shard_state(st, mesh)
    cs = pmesh.shard_consts(cs, mesh, n_pad)
    hp = HyperParams(base_score=3.0)
    lrs = torch.full((SCALE_ROUNDS,), 0.005, dtype=torch.float32, device=dev)

    def call(st):
        st = pmesh.sharded_train_rounds(st, stacked, lrs, cs, hp, mesh, n_pad)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return st

    st = call(st)  # warm
    best = float("inf")
    for _ in range(3):
        comm.barrier()
        t0 = time.perf_counter()
        st = call(st)
        comm.barrier()
        best = min(best, time.perf_counter() - t0)
    _finite(st.w)
    if rank == 0:
        pathlib.Path(out).write_text(json.dumps(dict(
            step_ms=best / (SCALE_ROUNDS * SCALE_STEPS) * 1e3, n_local=n_pad,
            backend=str(dist.get_backend()),
            cards=torch.cuda.device_count() if dev.type == "cuda" else 0,
            device_name=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            card=card_line() if dev.type == "cuda" else "cpu")))


def _plus_pool(rng, F: int, lo: int, hi: int, seg: str, nseg: int) -> Dict[str, np.ndarray]:
    """One chunk's pool ``[1, F]``: ids in ``[lo, hi)``, values, segments."""
    return {"fb_idx": rng.randint(lo, hi, (1, F)).astype(np.int32),
            "fb_val": rng.rand(1, F).astype(np.float32),
            seg: rng.randint(0, nseg, (1, F)).astype(np.int32)}


def _trainer(cls, mtype, params: dict, n_data: int, n_model: int, device: str):
    tr = cls(mtype)
    for key, val in {**params, "mesh_data": n_data, "mesh_model": n_model,
                     "device": device}.items():
        tr.set_param(key, str(val))
    tr.init_model()
    tr.init_trainer()
    if n_data * n_model > 1 and tr.mesh is None:
        raise RuntimeError(f"{cls.__name__} did not take the mesh")
    return tr


def _text_data(rng):
    """The dry run's text: 256 CSR rows, and 12 users of user-group data."""
    csr = "\n".join(f"{rng.randint(1, 6)} 0 1 1 {rng.randint(0, 16)}:1 {rng.randint(0, 24)}:1"
                    for _ in range(256))
    rows, fbs = [], []
    for u in range(12):
        nr, nf = int(rng.randint(2, 7)), int(rng.randint(1, 5))
        fbs.append(f"{nr} {nf} " + " ".join(f"{rng.randint(0, 15)}:{rng.rand():.3f}"
                                            for _ in range(nf)))
        rows += [f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 12)}:1" for _ in range(nr)]
    return csr, rows, fbs


def dryrun_rank(device: str, out: str) -> None:
    """A rank of the dry run's world (``dryrun_multichip``)."""
    import torch
    import torch.distributed as dist

    from . import convert
    from .data.buffer import write_csr_buffer, write_plus_buffer
    from .data.csr import TAG_DEFAULT, TAG_END, TAG_MIDDLE, TAG_START, PlusBlock, PlusDataset
    from .data.rank import PairSource
    from .data.registry import IteratorConfig
    from .data.streaming import StreamingCSRBuffer, StreamingPlusBuffer
    from .data.text import load_feature_text, load_plus_text
    from .model import SVDModel
    from .ops.embed import BIG_TABLE_ROWS, HyperParams
    from .ops.svdpp import PlusHyper
    from .ops.svdpp_bilinear import BiHyper
    from .params import SVDModelParam, SVDTypeParam
    from .parallel import bilinear_mesh, bilinear_mesh_big, comm, imfb_mesh
    from .parallel import mesh as pmesh
    from .parallel import mesh_big as pbig
    from .parallel import svdpp_mesh, svdpp_mesh_big
    from .solvers.base import SVDFeatureTrainer
    from .solvers.bilinear import SVDBiLinearTrainer
    from .solvers.multi_imfb import SVDPPMultiIMFBTrainer
    from .solvers.svdpp import SVDPPFeatureTrainer

    rank, n, dev = _join(device)
    n_model = 2 if n % 2 == 0 else 1
    n_data = n // n_model
    mesh = comm.make_mesh(n_data, n_model, dev)
    cuda = dev.type == "cuda"
    hp = HyperParams(base_score=3.0)
    lr = torch.tensor(0.005, device=dev)
    lrs = torch.tensor([0.005, 0.004], device=dev)
    ph = PlusHyper(wd_ufeedback=0.004)
    fbh = (lr, 1.0 - lr * 0.004, torch.tensor(1.0, device=dev))
    n_rows = NUM_USER + NUM_ITEM + 1

    # ---- the base step, its lazy form, the round loop, checkpoint-resume
    T = 3
    state, batch, consts = toy_setup(8 * n_data, k=8)
    st, stacked, cs = staged_toy(state, batch, consts, mesh, T, dev)
    st, n_pad = pmesh.shard_state(st, mesh)
    cs = pmesh.shard_consts(cs, mesh, n_pad)
    first = {name: x[0] for name, x in stacked.items()}
    st = pmesh.sharded_train_step(st, first, lr, cs, hp, mesh, n_pad)
    st = pmesh.sharded_train_step(st, first, lr, cs, dataclasses.replace(hp, reg_method=4), mesh,
                                  n_pad)
    st = pmesh.sharded_train_rounds(st, stacked, lrs, cs, hp, mesh, n_pad)
    assert st.w.shape[0] == n_pad // n_model
    full = pmesh.unshard_state(st, mesh, n_rows)
    mtype = SVDTypeParam(format_type=0)
    param = SVDModelParam(num_user=NUM_USER, num_item=NUM_ITEM, num_factor=8, base_score=3.0)
    buf = io.BytesIO()
    SVDModel(full.w[:-1].cpu(), full.b[:-1].cpu(), full.g[:-1].cpu(), param, mtype).save(buf)
    buf.seek(0)
    m2 = SVDModel.load(buf, mtype, device=dev)
    resumed = dict(state, w=np.concatenate([m2.w.cpu().numpy(), np.zeros((1, 8), np.float32)]),
                   b=np.append(m2.b.cpu().numpy(), np.float32(0)))
    st3, n_pad3 = pmesh.shard_state(convert.state_from_numpy(**resumed, device=dev), mesh)
    assert n_pad3 == n_pad
    st3 = pmesh.sharded_train_rounds(st3, stacked, lrs[:1], cs, hp, mesh, n_pad)
    _finite(st.w, st3.w)

    # ---- the SVD++ step (users over data, rows over model, pool replicated)
    G, F = 8 * n_data, 16 * n_data
    rng = np.random.RandomState(1)
    state2, batch2, consts2 = toy_setup(G, k=8)
    st2, stacked2, cs2 = staged_toy(state2, batch2, consts2, mesh, 2, dev)
    st2, n_pad2 = pmesh.shard_state(st2, mesh)
    cs2 = pmesh.shard_consts(cs2, mesh, n_pad2)
    fb_item = _plus_pool(rng, F, NUM_USER, n_rows - 1, "fb_block", G)
    cfb = {name: torch.from_numpy(x[0]).to(dev) for name, x in fb_item.items()}
    st2 = svdpp_mesh.sharded_svdpp_step(st2, {name: x[0] for name, x in stacked2.items()}, cfb,
                                        lr, fbh, cs2, hp, mesh, n_pad2, G)
    _finite(st2.w)

    # ---- big slabs (> BIG_TABLE_ROWS rows a shard): the dedup step and rounds,
    # the SVD++ rounds, bilinear with W_bi on big slabs; K5 on the card
    nu_big = ni_big = n_model * (BIG_TABLE_ROWS // 2 + 64)
    hpb = dataclasses.replace(hp, num_factor=8, row_dma=cuda)
    big = toy_setup(8 * n_data, nu_big, ni_big, k=8)
    st4, stacked4, cs4 = staged_toy(*big, mesh, 2, dev)
    st4, n_real4 = pbig.shard_state_big(st4, mesh, 8)
    assert n_real4 > BIG_TABLE_ROWS
    cs4 = pbig.shard_consts_big(cs4, mesh, n_real4)
    st4 = pbig.sharded_train_step_big(st4, {name: x[0] for name, x in stacked4.items()}, lr, cs4,
                                      hpb, mesh, n_real4)
    st4 = pbig.sharded_train_rounds_big(st4, stacked4, lrs, cs4, hpb, mesh, n_real4)
    big6 = toy_setup(G, nu_big, ni_big, k=8)
    st6, stacked6, cs6 = staged_toy(*big6, mesh, 2, dev)
    st6, n_real6 = pbig.shard_state_big(st6, mesh, 8)
    cs6 = pbig.shard_consts_big(cs6, mesh, n_real6)
    fb6 = {name: torch.from_numpy(x).to(dev) for name, x in
           _plus_pool(rng, F, 0, nu_big, "fb_block", G).items()}
    cid = np.zeros(2, np.int32)
    st6 = svdpp_mesh_big.sharded_svdpp_rounds_big(st6, stacked6, cid, fb6, lrs, cs6, hpb, ph,
                                                  mesh, n_real6)
    nbf = 4
    up = torch.from_numpy(rng.rand(1, G + 1, nbf).astype(np.float32)).to(dev)
    W_big, nb_real = bilinear_mesh_big.shard_bi_big(torch.zeros((ni_big + 1, nbf), device=dev),
                                                    mesh)
    st7, stacked7, cs7 = staged_toy(*big6, mesh, 2, dev)
    st7, _ = pbig.shard_state_big(st7, mesh, 8)
    st7 = bilinear_mesh_big.sharded_bilinear_rounds_big(
        st7, W_big, stacked7, cid, fb6, up, lrs, pbig.shard_consts_big(cs7, mesh, n_real6), hpb,
        ph, BiHyper(off_item=nu_big), mesh, n_real6, nb_real, ni_big)
    _finite(st4.w, st6.w, st7.w, W_big)

    # ---- stacked multi-IMFB and bilinear rounds on small slabs
    nseg = 4
    state5, batch5, consts5 = toy_setup(G, k=8)
    batch5["ctx_slots"] = rng.randint(0, nseg - 1, (G, 2)).astype(np.int32)
    st5, stacked5, cs5 = staged_toy(state5, batch5, consts5, mesh, 2, dev)
    st5, n_pad5 = pmesh.shard_state(st5, mesh)
    cs5 = pmesh.shard_consts(cs5, mesh, n_pad5)
    fb5 = {name: torch.from_numpy(x).to(dev) for name, x in
           _plus_pool(rng, F, NUM_USER, n_rows - 1, "fb_ctx", nseg - 1).items()}
    enabled = torch.tensor([[1.0] * (nseg - 1) + [0.0]], device=dev)
    st5 = imfb_mesh.sharded_imfb_rounds(st5, stacked5, cid, fb5, enabled, lrs, cs5, hp, ph, mesh,
                                        n_pad5)
    st8, stacked8, cs8 = staged_toy(state5, batch5, consts5, mesh, 2, dev)
    st8, n_pad8 = pmesh.shard_state(st8, mesh)
    Wb, n_bi_pad = bilinear_mesh.shard_bi(torch.zeros((NUM_ITEM + 1, nbf), device=dev), mesh)
    st8 = bilinear_mesh.sharded_bilinear_rounds(
        st8, Wb, {k: v for k, v in stacked8.items() if k != "ctx_slots"}, cid,
        {name: x[None] for name, x in cfb.items()}, up, lrs, pmesh.shard_consts(cs8, mesh, n_pad8),
        hp, ph, BiHyper(off_item=NUM_USER), mesh, n_pad8, n_bi_pad)
    _finite(st5.w, st8.w, Wb)

    # ---- the trainers: streamed chunks on the mesh, sharded streamed eval,
    # pairwiseRank rounds, M = 2 bilinear and stacked multi-IMFB
    srng = np.random.RandomState(5)
    csr_text, rows, fbs = _text_data(srng)
    scratch = pathlib.Path(out).parent / f"rank{rank}"
    scratch.mkdir(exist_ok=True)
    csr_ds = load_feature_text("x", text=csr_text)
    write_csr_buffer(str(scratch / "b.buffer"), csr_ds, batch_size=32)
    csr_src = StreamingCSRBuffer(str(scratch / "b.buffer"), examples_per_chunk=64)
    base = dict(num_factor=8, base_score=3, learning_rate=0.01, wd_user=0.004, wd_item=0.004)
    tr = _trainer(SVDFeatureTrainer, SVDTypeParam(), dict(base, num_user=16, num_item=24,
                                                          batch_size=32), n_data, n_model, device)
    for _ in range(2):
        tr.update_all(csr_src)
    pred_csr = tr.predict_all(csr_src)
    plus_ds = load_plus_text("x", "y", text="\n".join(rows), feedback_text="\n".join(fbs))
    write_plus_buffer(str(scratch / "p.buffer"), plus_ds)
    plus_src = StreamingPlusBuffer(str(scratch / "p.buffer"), blocks_per_chunk=4)
    plus = dict(base, num_user=12, num_item=12, num_ufeedback=15, wd_ufeedback=0.004,
                users_per_batch=2)
    tr = _trainer(SVDPPFeatureTrainer, SVDTypeParam(format_type=1), plus, n_data, n_model, device)
    for _ in range(2):
        tr.update_all(plus_src)
    pred_plus = tr.predict_all(plus_src)
    assert pred_csr.shape == (csr_ds.num_row,) and pred_plus.shape == (plus_ds.rows.num_row,)

    rank_rows, rank_fbs = [], []
    for u in range(12):
        items = srng.choice(30, min(2 + 7 * (u % 5), 30), replace=False)
        rank_rows += [f"{float(1 if i < 15 else 0)} 1 1 1 0:0.5 {u}:1 {i}:1" for i in items]
        rank_fbs.append(f"{len(items)} 0")
    rank_ds = load_plus_text("x", "y", text="\n".join(rank_rows),
                             feedback_text="\n".join(rank_fbs))
    tr = _trainer(SVDPPFeatureTrainer, SVDTypeParam(format_type=1, active_type=3), dict(
        learning_rate=0.01, wd_user=0.004, wd_item=0.004, num_user=12, num_item=30, num_global=6,
        num_factor=8, num_ufeedback=30, wd_ufeedback=0.004, no_user_bias=1, users_per_batch=4),
        n_data, n_model, device)
    tr.update_rounds(PairSource(rank_ds, IteratorConfig(), seed=9), 2)
    pred_rank = tr.predict_all(PairSource(rank_ds, IteratorConfig(), seed=31).epoch_dataset())

    tr = _trainer(SVDBiLinearTrainer, SVDTypeParam(format_type=1, extend_type=15), dict(
        plus, num_bi_feedback=15, wd_bi_feedback=0.002, rows_per_user=2), n_data, n_model, device)
    tr.update_all(plus_ds)
    pred_bi = tr.predict_all(plus_ds)
    tags = ([TAG_START, TAG_DEFAULT, TAG_MIDDLE, TAG_END] * 3)
    stacked_ds = PlusDataset.from_blocks([PlusBlock(b.fb_index, b.fb_value, b.data, extend_tag=t)
                                          for b, t in zip(plus_ds.blocks(), tags)])
    tr = _trainer(SVDPPMultiIMFBTrainer, SVDTypeParam(format_type=1, extend_type=2),
                  dict(plus, rows_per_user=2), n_data, n_model, device)
    tr.update_all(stacked_ds)
    pred_imfb = tr.predict_all(stacked_ds)
    for p in (pred_csr, pred_plus, pred_rank, pred_bi, pred_imfb):
        if not np.isfinite(p).all():
            raise FloatingPointError("non-finite predictions in the dry run")
    comm.barrier()
    if rank == 0:
        pathlib.Path(out).write_text(json.dumps(dict(
            n_data=n_data, n_model=n_model, backend=str(dist.get_backend()), n_pad=n_pad, G=G,
            F=F, T=T, n_real4=n_real4, big_rows=BIG_TABLE_ROWS, n_real6=n_real6, nseg=nseg,
            n_bi_pad=n_bi_pad, nbf=nbf, nb_real=nb_real, pred_csr=int(pred_csr.shape[0]),
            pred_plus=int(pred_plus.shape[0]), pred_rank=int(pred_rank.shape[0]))))


def main(argv) -> int:
    if argv[:1] == ["--rank"]:
        {"dryrun": dryrun_rank, "scale": scale_rank}[argv[1]](*argv[2:])
        return 0
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", help="cuda (a card a rank where there are "
                    "enough, else gloo on shared cards) or cpu (gloo)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
