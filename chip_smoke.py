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
     with use_pallas=0 (the plain version) for the end-to-end comparison.
Then one JSON line describing the kernels and, last, one JSON line
naming the device.
"""

from __future__ import annotations

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
        print(f"phase 2 time: {shape} ms per step (B={BATCH}, median of 6 R={R} runs): "
              f"kernel {timing[shape]['kernel']:.4f} plain {timing[shape]['plain']:.4f}",
              flush=True)
        for name in ("kernel", "plain"):
            print(f"phase 2 profile: {shape} path={name} "
                  f"{device_profile(torch, fns[name], device_inputs(arrays), hp, R * T)}",
                  flush=True)
    return max_err, timing


def _short(kernel_name: str) -> str:
    """A demangled kernel name without its namespace prefix, template
    arguments and parameter list."""
    name = kernel_name.replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", name, maxsplit=1)[0].strip().split(" ")[-1][-48:]


def device_profile(torch, fn, inputs, hp, steps):
    """Where one R-round run's time goes on the card (torch.profiler):
    device busy time per step, its share of the run's elapsed time, and
    the device time of each of the run's busiest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn(*inputs, hp)
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


# ---- phase 3: the slice ------------------------------------------------------
def run_demo(name, work, tag, extra, kernel_fn):
    """Train and evaluate one demo through SVDTrainTask / SVDInferTask."""
    from svdfeature_tpu_torch.infer.task import SVDInferTask
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    golden = json.loads((ROOT / "golden" / "GOLDEN.json").read_text())[name]
    conf = str(ROOT / "demo" / name / f"{name}.conf")
    d = work / name
    common = [f"buffer_feature={d}/ua.base.buffer", f"test:buffer_feature={d}/ua.test.buffer",
              f"model_out_folder={d}/models_{tag}", "device=cuda", "silent=1"]
    kernel_fn.launches = 0
    task = SVDTrainTask()
    task.run(conf, common + [f"num_round={ROUNDS}", f"batch_size={BATCH}", *extra])
    launches = kernel_fn.launches
    rows = task.dataset.num_row
    T = -(-rows // BATCH)
    log = d / f"rmse_{tag}.tsv"
    SVDInferTask().run(conf, common + [f"start={ROUNDS}", f"end={ROUNDS + 1}",
                                       f"log_eval={log}"])
    rmse = float(log.read_text().split()[-1])
    secs = task.round_seconds
    eps_steady = rows * (len(secs) - 1) / sum(secs[1:])
    eps_all = rows * len(secs) / sum(secs)
    band_ok = math.isfinite(rmse) and abs(rmse - golden["final_rmse"]) < golden["rmse_band"]
    seed10 = golden["rmse_band_provenance"]["seeds"]["10"]
    return dict(rmse=rmse, band_ok=band_ok, launches=launches, T=T, rows=rows,
                eps_steady=eps_steady, eps_all=eps_all, golden=golden["final_rmse"],
                band=golden["rmse_band"], d_seed10=rmse - seed10)


def phase_slice(work, card, failures):
    from svdfeature_tpu_torch.cli import make_feature_buffer
    from svdfeature_tpu_torch.ops.cuda_embed import train_rounds_kernel

    total = 0
    for name, (train_fx, test_fx) in DEMOS.items():
        d = work / name
        d.mkdir(parents=True)
        for fx, split in ((train_fx, "base"), (test_fx, "test")):
            with gzip.open(ROOT / "tests" / "fixtures" / fx, "rb") as src, \
                    open(d / f"ua.{split}.feature", "wb") as dst:
                shutil.copyfileobj(src, dst)
            make_feature_buffer.main([str(d / f"ua.{split}.feature"), str(d / f"ua.{split}.buffer")])
        runs = [("kernel", [])] + ([("plain", ["use_pallas=0"])] if name == "basicMF" else [])
        for path, extra in runs:
            r = run_demo(name, work, path, extra, train_rounds_kernel)
            want_launches = 2 * ROUNDS * r["T"] if path == "kernel" else 0
            ok = r["band_ok"] and r["launches"] == want_launches
            if path == "kernel":
                total += r["launches"]
            if not ok:
                failures.append(f"slice {name} ({path})")
            print(f"phase 3 {'ok' if ok else 'FAIL'}: {name} path={path} test RMSE {r['rmse']:.6f} "
                  f"(golden {r['golden']} band {r['band']}; minus JAX seed-10 {r['d_seed10']:+.6f}) "
                  f"launches {r['launches']} (want {want_launches} = 2*{ROUNDS}*T, T={r['T']}) "
                  f"training {r['eps_steady']:,.0f} examples/s rounds 2-{ROUNDS} "
                  f"({r['eps_all']:,.0f} over all {ROUNDS}, first includes packing) "
                  f"on {card}", flush=True)
    return total


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
    max_err, timing = phase_kernel(torch, dev, failures)

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        launches = phase_slice(pathlib.Path(work), card, failures)

    if failures:
        print(f"FAILED phases: {failures}", flush=True)
        return 1
    print(json.dumps({"kernels": [{
        "name": "fused_embed (sgd_accumulate + sgd_apply)",
        "route": "cuda",
        "source": "svdfeature_tpu_torch/csrc/fused_embed.cu",
        "replaces": "svdfeature_tpu/ops/pallas_embed.py:75",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing["basicMF"]["kernel"],
        "plain_ms": timing["basicMF"]["plain"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
