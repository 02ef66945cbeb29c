#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (svdfeature_tpu_torch) on one NVIDIA GPU.

Usage, from the repository root:  python3 chip_smoke.py

Phases (one or more lines each; any failure exits non-zero and prints no
result line):
  0. the card's name and power limit (nvidia-smi); exit 1 without CUDA;
  1. build the CUDA kernels from svdfeature_tpu_torch/csrc/ with nvcc
     into build/kernels/;
  2. the kernel against its plain PyTorch version on identical
     numpy-seeded inputs, R=2 rounds at basicMF shapes (N=2626, k=64,
     B=4096, T=23) and neighborhoodModel shapes (+ NG=7, SG=3), for
     active_type 0/2 and exact_global 0/1, with both times;
  3. the slice through the port's entry points: make_feature_buffer, then
     SVDTrainTask (40 rounds, batch_size=4096, device=cuda) and
     SVDInferTask for basicMF, binaryClassification and
     neighborhoodModel; the final test RMSE must lie in the
     golden/GOLDEN.json band and every training step must have gone
     through the kernel (launch count 2*40*T).  basicMF runs once more
     with use_pallas=0 (the plain version) for the end-to-end comparison;
  4. the SVD++ kernel (csrc/fused_svdpp.cu) against its plain version on
     numpy-seeded inputs packed by the port's pack_plus from the ML-100K
     user-group fixtures, R=2: the RMSE-band setting (128 users x 8 rows,
     T=159, 8 chunks) and one row per user (T=4088), active_type 0/2,
     no_user_bias 0/1, and a synthetic pairwise (item width 2) case, with
     both times and a profile;
  5. the implicitFeedback slice: make_ugroup_buffer -fd, SVDTrainTask (40
     rounds, sort_blocks=1 rows_per_user=8, device=cuda), SVDInferTask;
     the final test RMSE must lie in the GOLDEN.json band and every step
     must have gone through the kernel (launch count 40*(2T + 2*chunks));
     once more with use_pallas=0.
Then one JSON line describing the kernels (with each one's bound: the
larger of its bytes over 3.35 TB/s and its f32 operations over 67 TFLOP/s,
the H100 SXM's published rates at 700 W) and, last, one JSON line naming
the device.
"""

from __future__ import annotations

import functools
import gzip
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
ROUNDS = 40
BATCH = 4096
ATOL, RTOL = 1e-5, 1e-4  # kernel vs plain: atomics sum in a varying order
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores, published
DEMOS = {
    # name: (train fixture, test fixture)
    "basicMF": ("ml100k.base.feature.gz", "ml100k.test.feature.gz"),
    "binaryClassification": ("ml100k.base.bin.feature.gz", "ml100k.test.bin.feature.gz"),
    "neighborhoodModel": ("ml100k.base.nb.feature.gz", "ml100k.test.nb.feature.gz"),
}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        return "nvidia-smi not found"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else f"nvidia-smi failed: {out.stderr.strip()}"


# ---- phase 2: kernel vs plain ------------------------------------------------
def make_inputs(active_type, NG, SG, seed, exact_global=False, N=2626, n_user=943,
                k=64, B=BATCH, n_rows=90570, R=2):
    """numpy arrays at ML-100K shapes: unified table (users, items, dummy),
    n_rows examples packed into ceil(n_rows/B) batches with weight-0
    padding at the dummy row, as pack_csr writes them.  The undamped
    (exact_global) update is stable only while lr * sum(v^2) per slot
    stays below 2, which dense global features break at B=4096 (the
    reason the batched path damps it): its inputs get values 10x smaller."""
    rng = np.random.RandomState(seed)
    T = -(-n_rows // B)
    w = rng.normal(0, 0.01, (N, k)).astype(np.float32)
    w[-1] = 0.0
    g = rng.normal(0, 0.01, (NG,)).astype(np.float32) if NG > 1 else np.zeros(1, np.float32)
    g[-1] = 0.0
    wd_u = np.zeros(N, np.float32)
    wd_i = np.zeros(N, np.float32)
    wd_u[:n_user] = 0.004
    wd_i[n_user:N - 1] = 0.004
    wd_g = np.full(NG, 0.001, np.float32)
    wd_g[-1] = 0.0
    real = (np.arange(T * B) < n_rows).reshape(T, B)
    ratings = rng.randint(1, 6, (T, B)).astype(np.float32)
    label = ratings if active_type == 0 else (ratings >= 4).astype(np.float32)
    u = np.where(real, rng.randint(0, n_user, (T, B)), N - 1)
    i = np.where(real, n_user + rng.randint(0, N - 1 - n_user, (T, B)), N - 1)
    if NG > 1:
        g_idx = rng.randint(0, NG - 1, (T, B, SG))
        g_val = rng.uniform(0.1, 1.0, (T, B, SG)).astype(np.float32)
        if exact_global:
            g_val *= 0.1
        pad = (rng.rand(T, B, SG) < 0.3) | ~real[..., None]
        g_idx[pad] = NG - 1
        g_val[pad] = 0.0
    else:
        g_idx = np.zeros((T, B, 1), np.int32)
        g_val = np.zeros((T, B, 1), np.float32)
    state = dict(w=w, b=np.zeros(N, np.float32), g=g, step=np.int32(0),
                 ref_ui=np.zeros(N, np.int32), ref_g=np.zeros(NG, np.int32))
    consts = dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=wd_g,
                  wd_user_bias=np.float32(0.0), wd_item_bias=np.float32(0.0))
    stacked = dict(
        label=np.where(real, label, 0.0).astype(np.float32),
        weight=real.astype(np.float32),
        g_idx=g_idx.astype(np.int32), g_val=g_val,
        u_idx=u[..., None].astype(np.int32), u_val=real[..., None].astype(np.float32),
        i_idx=i[..., None].astype(np.int32), i_val=real[..., None].astype(np.float32),
    )
    lrs = np.array([0.005] * R, np.float32)
    return state, consts, stacked, lrs


def bound(bytes_moved, flops, steps):
    """(least ms per step, what bounds it) of a call of ``steps`` steps."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3 / steps, ("bytes" if t_bytes >= t_ops else "operations")


def touched_rows(*idx_planes):
    """Distinct table rows each step's live entries touch (entries of
    padding are -1), summed over steps."""
    total = 0
    for t in range(idx_planes[0].shape[0]):
        rows = np.unique(np.concatenate([p[t].reshape(-1) for p in idx_planes]))
        total += int((rows >= 0).sum())
    return total


def embed_bound(arrays):
    """K1's bound for one R-round call of make_inputs' arrays: each input
    read once and each output written once; per live example 8k + 6 SG
    operations (two scaled rows, the dot, two coef*p products and their
    sums, the global terms), per touched row 2k (add, decay)."""
    st, _, stacked, lrs = arrays
    R = len(lrs)
    T, B = stacked["label"].shape
    N, k = st["w"].shape
    NG, SG = st["g"].shape[0], stacked["g_idx"].shape[-1]
    live = stacked["weight"] > 0
    rows = touched_rows(np.where(live[..., None], stacked["u_idx"], -1),
                        np.where(live[..., None], stacked["i_idx"], -1))
    flops = R * (int(live.sum()) * (8 * k + 6 * SG) + rows * 2 * k)
    moved = 4 * (2 * (N * (k + 1) + NG) + T * B * (6 + 2 * SG) + 2 * N + NG + R)
    return bound(moved, flops, R * T)


def phase_kernel(torch, dev, failures):
    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.ops.cuda_embed import (
        train_rounds_kernel, train_rounds_reference,
    )
    from svdfeature_tpu_torch.ops.embed import HyperParams

    def device_inputs(arrays):
        st, cs, stacked, lrs = arrays
        return (convert.state_from_numpy(**st, device=dev),
                convert.stacked_from_numpy(stacked, dev),
                torch.tensor(lrs, device=dev),
                convert.consts_from_numpy(**cs, device=dev))

    max_err = 0.0
    timing = {}
    for shape, NG, SG in (("basicMF", 1, 1), ("neighborhoodModel", 7, 3)):
        for at in (0, 2):
            for exact in (False, True):
                arrays = make_inputs(at, NG, SG, seed=10 + at, exact_global=exact)
                hp = HyperParams(active_type=at, base_score=3.0 if at == 0 else 0.0,
                                 exact_global=exact)
                got = train_rounds_kernel(*device_inputs(arrays), hp)
                want = train_rounds_reference(*device_inputs(arrays), hp)
                torch.cuda.synchronize()
                errs, ok = {}, True
                for name in ("w", "b", "g"):
                    a, b = getattr(got, name), getattr(want, name)
                    errs[name] = float((a - b).abs().max())
                    ok &= bool(torch.isfinite(a).all()) and bool(
                        ((a - b).abs() <= ATOL + RTOL * b.abs()).all())
                ok &= int(got.step) == int(want.step)
                max_err = max(max_err, *errs.values())
                status = "ok" if ok else "FAIL"
                if not ok:
                    failures.append(f"kernel vs plain {shape} at={at} exact_global={int(exact)}")
                print(f"phase 2 {status}: {shape} active_type={at} exact_global={int(exact)} "
                      f"max|dw|={errs['w']:.3e} max|db|={errs['b']:.3e} max|dg|={errs['g']:.3e} "
                      f"(atol {ATOL:g} + rtol {RTOL:g})", flush=True)
        # times: CUDA events around whole R=2 runs, after a warm-up, in turns
        arrays = make_inputs(0, NG, SG, seed=10)
        hp = HyperParams(base_score=3.0)
        T = arrays[2]["label"].shape[0]
        R = arrays[3].shape[0]
        fns = {"plain": train_rounds_reference, "kernel": train_rounds_kernel}
        samples = {"plain": [], "kernel": []}
        for name in ("plain", "kernel"):
            fns[name](*device_inputs(arrays), hp)
        for name in ("plain", "kernel", "kernel", "plain") * 3:
            inputs = device_inputs(arrays)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name](*inputs, hp)
            end.record()
            torch.cuda.synchronize()
            samples[name].append(start.elapsed_time(end) / (R * T))
        timing[shape] = {n: float(np.median(v)) for n, v in samples.items()}
        timing[shape]["bound"], timing[shape]["bound_by"] = embed_bound(arrays)
        print(f"phase 2 time: {shape} ms per step (B={BATCH}, median of 6 R={R} runs): "
              f"kernel {timing[shape]['kernel']:.4f} plain {timing[shape]['plain']:.4f} "
              f"bound {timing[shape]['bound']:.6f} ({timing[shape]['bound_by']})", flush=True)
        for name in ("kernel", "plain"):
            inputs = device_inputs(arrays)
            print(f"phase 2 profile: {shape} path={name} "
                  f"{device_profile(torch, lambda: fns[name](*inputs, hp), R * T)}",
                  flush=True)
    return max_err, timing


def _short(kernel_name: str) -> str:
    """A demangled kernel name without its namespace prefix, template
    arguments and parameter list."""
    name = kernel_name.replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", name, maxsplit=1)[0].strip().split(" ")[-1][-48:]


def device_profile(torch, run, steps):
    """Where one R-round run, ``run()``, spends its time on the card
    (torch.profiler): device busy time per step, its share of the run's
    elapsed time, and the device time of each of the run's busiest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    elapsed_us = start.elapsed_time(end) * 1e3
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in per_kernel.values())
    if not per_kernel:
        return "device time not measured (the profiler recorded no device events)"
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:4]
    tops = "; ".join(f"{_short(name)} {n} x {us / n:.2f} us" for name, (n, us) in top)
    return (f"device busy {busy / steps:.2f} us/step of {elapsed_us / steps:.2f} us/step "
            f"elapsed under the profiler (busy share {busy / elapsed_us:.3f}); {tops}")


# ---- phases 3 and 5: the slices ----------------------------------------------
def kernel_wrappers():
    from svdfeature_tpu_torch.ops.cuda_embed import train_rounds_kernel
    from svdfeature_tpu_torch.ops.cuda_svdpp import train_rounds_svdpp_kernel

    return {"K1": train_rounds_kernel, "K2": train_rounds_svdpp_kernel}


def run_demo(name, d, tag, extra):
    """Train and evaluate one demo through SVDTrainTask / SVDInferTask,
    with every kernel's launch count set to 0 just before training and
    read just after.  ``d`` holds its train.buffer and test.buffer."""
    from svdfeature_tpu_torch.infer.task import SVDInferTask
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    golden = json.loads((ROOT / "golden" / "GOLDEN.json").read_text())[name]
    conf = str(ROOT / "demo" / name / f"{name}.conf")
    common = [f"buffer_feature={d}/train.buffer", f"test:buffer_feature={d}/test.buffer",
              f"model_out_folder={d}/models_{tag}", "device=cuda", "silent=1"]
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    task = SVDTrainTask()
    task.run(conf, common + [f"num_round={ROUNDS}", *extra])
    launches = {kid: fn.launches for kid, fn in wrappers.items()}
    rows = task.dataset_rows()
    log = d / f"rmse_{tag}.tsv"
    SVDInferTask().run(conf, common + [f"start={ROUNDS}", f"end={ROUNDS + 1}",
                                       f"log_eval={log}"])
    rmse = float(log.read_text().split()[-1])
    secs = task.round_seconds
    eps_steady = rows * (len(secs) - 1) / sum(secs[1:])
    eps_all = rows * len(secs) / sum(secs)
    band_ok = math.isfinite(rmse) and abs(rmse - golden["final_rmse"]) < golden["rmse_band"]
    seed10 = golden["rmse_band_provenance"]["seeds"]["10"]
    return dict(rmse=rmse, band_ok=band_ok, launches=launches, rows=rows, task=task,
                eps_steady=eps_steady, eps_all=eps_all, golden=golden["final_rmse"],
                band=golden["rmse_band"], d_seed10=rmse - seed10)


def report_demo(phase, name, path, r, kid, want, how, card, failures):
    ok = r["band_ok"] and r["launches"][kid] == want
    if not ok:
        failures.append(f"slice {name} ({path})")
    print(f"phase {phase} {'ok' if ok else 'FAIL'}: {name} path={path} test RMSE {r['rmse']:.6f} "
          f"(golden {r['golden']} band {r['band']}; minus JAX seed-10 {r['d_seed10']:+.6f}) "
          f"{kid} launches {r['launches'][kid]} (want {want} = {how}) "
          f"training {r['eps_steady']:,.0f} examples/s rounds 2-{ROUNDS} "
          f"({r['eps_all']:,.0f} over all {ROUNDS}, first includes packing) "
          f"on {card}", flush=True)


def unzip_fixture(name, dst):
    with gzip.open(ROOT / "tests" / "fixtures" / name, "rb") as src, open(dst, "wb") as out:
        shutil.copyfileobj(src, out)


def phase_slice(work, card, failures):
    from svdfeature_tpu_torch.cli import make_feature_buffer

    total = 0
    for name, (train_fx, test_fx) in DEMOS.items():
        d = work / name
        d.mkdir(parents=True)
        for fx, split in ((train_fx, "train"), (test_fx, "test")):
            unzip_fixture(fx, d / f"{split}.feature")
            make_feature_buffer.main([str(d / f"{split}.feature"), str(d / f"{split}.buffer")])
        runs = [("kernel", [])] + ([("plain", ["use_pallas=0"])] if name == "basicMF" else [])
        for path, extra in runs:
            r = run_demo(name, d, path, [f"batch_size={BATCH}", *extra])
            T = -(-r["rows"] // BATCH)
            want = 2 * ROUNDS * T if path == "kernel" else 0
            total += r["launches"]["K1"]
            report_demo(3, name, path, r, "K1", want, f"2*{ROUNDS}*T, T={T}", card, failures)
    return total


def phase_svdpp_slice(work, card, failures):
    """implicitFeedback (demo/implicitFeedback/run.sh) at the RMSE band's
    setting, sort_blocks=1 rows_per_user=8 (golden/derive_rmse_bands.py)."""
    from svdfeature_tpu_torch.cli import make_ugroup_buffer
    from svdfeature_tpu_torch.ops.cuda_svdpp import launches_per_call

    name = "implicitFeedback"
    d = work / name
    d.mkdir(parents=True)
    for split, (fx, fb_fx) in (("train", ("ml100k.base.group.feature.gz", "ml100k.base.feedback.gz")),
                               ("test", ("ml100k.test.ug.feature.gz", "ml100k.test.feedback.gz"))):
        unzip_fixture(fx, d / f"{split}.feature")
        unzip_fixture(fb_fx, d / f"{split}.feedback")
        make_ugroup_buffer.main([str(d / f"{split}.feature"), str(d / f"{split}.buffer"),
                                 "-fd", str(d / f"{split}.feedback")])
    launches = 0
    for path, extra in (("kernel", []), ("plain", ["use_pallas=0"])):
        r = run_demo(name, d, path, ["sort_blocks=1", "rows_per_user=8", *extra])
        cid = r["task"].trainer._pack_plus(r["task"].dataset).chunk_id
        per_round = launches_per_call(cid, 1)
        want = ROUNDS * per_round if path == "kernel" else 0
        if path == "kernel":
            launches = r["launches"]["K2"]
        starts = per_round // 2 - len(cid)
        report_demo(5, name, path, r, "K2", want,
                    f"{ROUNDS}*(2T + 2*chunk starts), T={len(cid)}, chunk starts={starts}",
                    card, failures)
    return launches


# ---- phase 4: the SVD++ kernel vs plain ---------------------------------------
@functools.lru_cache(maxsize=None)
def ugroup_packed(sort_blocks, M):
    """The ML-100K implicitFeedback training set packed by the port's
    pack_plus: 128 users per step, M rows of each."""
    from svdfeature_tpu_torch.data.batching_plus import pack_plus
    from svdfeature_tpu_torch.data.text import load_plus_text

    def text(name):
        with gzip.open(ROOT / "tests" / "fixtures" / name, "rt") as f:
            return f.read()

    ds = load_plus_text("x", "y", text=text("ml100k.base.group.feature.gz"),
                        feedback_text=text("ml100k.base.feedback.gz"))
    return pack_plus(ds, 128, 4307, 0, 1682, 2625, 0, num_user=943, num_item=1682,
                     num_ufeedback=1682, sort_blocks=sort_blocks, rows_per_user=M)


def svdpp_inputs(sort_blocks, M, active_type, pairwise, seed):
    """numpy inputs at the implicitFeedback layout (feedback rows [0, 1682),
    users [1682, 2625), items [2625, 4307), dummy 4307; k=64).  active_type
    2 takes the ratings >= 4 as its 0/1 labels; ``pairwise`` adds a second,
    random item entry of value -1 to every live slot (the item-width-2
    difference rows of pairwise ranking) with label 1."""
    packed = ugroup_packed(sort_blocks, M)
    rng = np.random.RandomState(seed)
    N, k = 4308, 64
    w = rng.normal(0, 0.01, (N, k)).astype(np.float32)
    b = rng.normal(0, 0.01, (N,)).astype(np.float32)
    w[-1] = 0.0
    b[-1] = 0.0
    wd_u = np.zeros(N, np.float32)
    wd_i = np.zeros(N, np.float32)
    wd_u[1682:2625] = 0.004
    wd_i[2625:N - 1] = 0.004
    stacked = packed.device_arrays()
    chunk_id = stacked.pop("chunk_id")
    live = stacked["weight"] > 0
    if active_type != 0:
        stacked["label"] = (live & (stacked["label"] >= 4)).astype(np.float32)
    if pairwise:
        neg = np.where(live, 2625 + rng.randint(0, 1682, live.shape), N - 1)
        stacked["i_idx"] = np.stack([stacked["i_idx"][..., 0], neg], -1).astype(np.int32)
        stacked["i_val"] = np.stack([stacked["i_val"][..., 0], -live.astype(np.float32)], -1)
        stacked["label"] = live.astype(np.float32)
    return dict(
        st=dict(w=w, b=b, g=np.zeros(1, np.float32), step=np.int32(0),
                ref_ui=np.zeros(N, np.int32), ref_g=np.zeros(1, np.int32)),
        cs=dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=np.zeros(1, np.float32),
                wd_user_bias=np.float32(0.002), wd_item_bias=np.float32(0.002)),
        stacked=stacked, chunk_id=chunk_id, fb=packed.fb_arrays(), overlap=packed.fb_overlap,
        lrs=np.array([0.005, 0.0045], np.float32), M=M)


def svdpp_bound(x):
    """K2's bound for one R-round call: each input read once (the live
    pool entries only), each output written once; operations counted from
    this run's data: per live slot (5 + 4 SI) k (p_u, p_i, the dot, the
    u/i scatters, err*p_i and |p_i|^2), per step 2 nnz(O[c]) (k+1) for
    O @ delta over the chunk's nonzero overlaps plus 6 (k+1) per user,
    per touched row 2k, and per chunk start 4 (k+2) per live pool entry
    (gather and flush)."""
    st, stacked, fb = x["st"], x["stacked"], x["fb"]
    R = len(x["lrs"])
    N, k = st["w"].shape
    T, GS = stacked["label"].shape
    G = GS // x["M"]
    SI = stacked["i_idx"].shape[-1]
    cid = x["chunk_id"]
    live = stacked["weight"] > 0
    nnz = [np.count_nonzero(x["overlap"][c, :G, :G]) for c in range(x["overlap"].shape[0])]
    pool_live = (fb["fb_block"] < G).sum(axis=1)
    starts = np.concatenate([[True], cid[1:] != cid[:-1]])
    rows = touched_rows(np.where(live[..., None], stacked["u_idx"], -1),
                        np.where(live[..., None], stacked["i_idx"], -1))
    flops = R * (int(live.sum()) * (5 + 4 * SI) * k
                 + sum(2 * nnz[c] * (k + 1) + 6 * G * (k + 1) for c in cid)
                 + rows * 2 * k
                 + int(pool_live[cid[starts]].sum()) * 4 * (k + 2))
    moved = 4 * (2 * N * (k + 1) + T * GS * (4 + 2 * SI) + 3 * int(pool_live.sum())
                 + x["overlap"].size + 2 * N + 3 * R)
    return bound(moved, flops, R * T)


def phase_svdpp_kernel(torch, dev, failures):
    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.ops.cuda_svdpp import (
        launches_per_call, train_rounds_svdpp_kernel, train_rounds_svdpp_reference,
    )
    from svdfeature_tpu_torch.ops.embed import HyperParams
    from svdfeature_tpu_torch.ops.svdpp import PlusHyper

    def device_inputs(x):
        fb, overlap = convert.pool_from_numpy(x["fb"], x["overlap"], dev)
        return (convert.state_from_numpy(**x["st"], device=dev),
                convert.stacked_from_numpy(x["stacked"], dev), x["chunk_id"], fb, overlap,
                torch.tensor(x["lrs"], device=dev),
                convert.consts_from_numpy(**x["cs"], device=dev))

    def hyper(x, at, nub):
        return (HyperParams(active_type=at, no_user_bias=nub, base_score=3.0 if at == 0 else 0.0),
                PlusHyper(rows_per_user=x["M"], off_user=1682, wd_ufeedback=0.004,
                          wd_ufeedback_bias=0.002))

    max_err = 0.0
    cases = (  # (setting, sort_blocks, M, active_type, no_user_bias, pairwise)
        ("band", True, 8, 0, 0, False), ("band", True, 8, 2, 1, False),
        ("one-row", False, 1, 0, 1, False), ("one-row", False, 1, 2, 0, False),
        ("band-pairwise", True, 8, 3, 1, True),
    )
    for setting, sort_blocks, M, at, nub, pairwise in cases:
        x = svdpp_inputs(sort_blocks, M, at, pairwise, seed=20 + at)
        hp, ph = hyper(x, at, nub)
        before = train_rounds_svdpp_kernel.launches
        got = train_rounds_svdpp_kernel(*device_inputs(x), hp, ph)
        torch.cuda.synchronize()
        launched = train_rounds_svdpp_kernel.launches - before
        want = train_rounds_svdpp_reference(*device_inputs(x), hp, ph)
        errs, ok = {}, launched == launches_per_call(x["chunk_id"], len(x["lrs"]))
        for name in ("w", "b"):
            a, b = getattr(got, name), getattr(want, name)
            errs[name] = float((a - b).abs().max())
            ok &= bool(torch.isfinite(a).all()) and bool(((a - b).abs() <= ATOL + RTOL * b.abs()).all())
        ok &= int(got.step) == int(want.step)
        ok &= bool((got.w != torch.from_numpy(x["st"]["w"]).to(dev)).any())
        max_err = max(max_err, *errs.values())
        if not ok:
            failures.append(f"svdpp kernel vs plain {setting} at={at} nub={nub}")
        T, GS = x["stacked"]["label"].shape
        print(f"phase 4 {'ok' if ok else 'FAIL'}: {setting} (T={T}, GS={GS}, M={M}, "
              f"SI={x['stacked']['i_idx'].shape[-1]}, C={x['fb']['fb_idx'].shape[0]}, "
              f"F={x['fb']['fb_idx'].shape[1]}) active_type={at} no_user_bias={nub} "
              f"max|dw|={errs['w']:.3e} max|db|={errs['b']:.3e} (atol {ATOL:g} + rtol {RTOL:g}) "
              f"launches {launched}", flush=True)

    # times at the band setting: CUDA events around whole R=2 runs, after a
    # warm-up, in turns
    x = svdpp_inputs(True, 8, 0, False, seed=20)
    hp, ph = hyper(x, 0, 0)
    T = x["stacked"]["label"].shape[0]
    R = len(x["lrs"])
    fns = {"plain": train_rounds_svdpp_reference, "kernel": train_rounds_svdpp_kernel}
    samples = {"plain": [], "kernel": []}
    for name in ("plain", "kernel"):
        fns[name](*device_inputs(x), hp, ph)
    for name in ("plain", "kernel", "kernel", "plain") * 3:
        inputs = device_inputs(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fns[name](*inputs, hp, ph)
        end.record()
        torch.cuda.synchronize()
        samples[name].append(start.elapsed_time(end) / (R * T))
    timing = {n: float(np.median(v)) for n, v in samples.items()}
    timing["bound"], timing["bound_by"] = svdpp_bound(x)
    print(f"phase 4 time: band ms per step (GS=1024, median of 6 R={R} runs): "
          f"kernel {timing['kernel']:.4f} plain {timing['plain']:.4f} "
          f"bound {timing['bound']:.6f} ({timing['bound_by']})", flush=True)
    for name in ("kernel", "plain"):
        inputs = device_inputs(x)
        print(f"phase 4 profile: band path={name} "
              f"{device_profile(torch, lambda: fns[name](*inputs, hp, ph), R * T)}", flush=True)
    return max_err, timing


def kernel_line(name, source, replaces, launches, max_err, timing):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err, "ms": timing["kernel"],
            "plain_ms": timing["plain"], "bound_ms": timing["bound"],
            "bound_by": timing["bound_by"], "library_ms": None}


def main() -> int:
    card = card_line()
    print(f"phase 0: {card}", flush=True)
    import torch

    if not torch.cuda.is_available():
        print("phase 0 FAIL: torch.cuda.is_available() is false", flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # stated for the comparisons:
    torch.backends.cudnn.allow_tf32 = False        # full f32 on both sides
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from svdfeature_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"phase 1 ok: built {_build.BUILD_DIR / _build.LIB_NAME} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"phase 1 ptxas: {line.strip()}")

    failures = []
    k1_err, k1_timing = phase_kernel(torch, dev, failures)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        k1_launches = phase_slice(pathlib.Path(work), card, failures)
        k2_err, k2_timing = phase_svdpp_kernel(torch, dev, failures)
        k2_launches = phase_svdpp_slice(pathlib.Path(work), card, failures)

    if failures:
        print(f"FAILED phases: {failures}", flush=True)
        return 1
    print(json.dumps({"kernels": [
        kernel_line("fused_embed (sgd_accumulate + sgd_apply)",
                    "svdfeature_tpu_torch/csrc/fused_embed.cu",
                    "svdfeature_tpu/ops/pallas_embed.py:75", k1_launches, k1_err,
                    k1_timing["basicMF"]),
        kernel_line("fused_svdpp (svdpp_flush + svdpp_gather + svdpp_step + svdpp_apply)",
                    "svdfeature_tpu_torch/csrc/fused_svdpp.cu",
                    "svdfeature_tpu/ops/pallas_svdpp.py:110", k2_launches, k2_err, k2_timing),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
