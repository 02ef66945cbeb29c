#!/usr/bin/env python3
"""Host / device split of the port's row writer (K5) and of its three
training rounds, K1 (base solver), K2 (SVD++) and K3 (stacked multi-IMFB),
on one NVIDIA GPU, for one tree or for two trees in turns.

Usage, from the repository root:

    python3 scripts/kernel_split.py                   # this tree
    python3 scripts/kernel_split.py --parent build/parent   # parent, change, change, parent
    python3 scripts/kernel_split.py --cases k4 --parent build/parent --out docs/kernel_split_pr7.json

Each turn is one subprocess that imports ``chip_smoke`` and
``svdfeature_tpu_torch`` from its tree, builds that tree's kernels and
prints one JSON line; the summary (medians over a tree's turns) goes to
stdout and, with ``--out``, to a file.  Two trees are compared inside one
run because step times through the wrappers move 20-55% between runs on
different machines.

What it measures, with the card's name and power limit:
  K5 at E=8192 rows of W=68 into the 2,048,577-row table (one batch-4096
  dedup step) and at E=2^21: ms per call of the wrapper and of
  ``index_copy_`` from CUDA events around back-to-back calls, the host's
  microseconds per call (host clock around 1,000 enqueues, no
  synchronise inside; where the tree has the ``row_noop`` entry point,
  also with the launch replaced by it), and the device microseconds per
  launch (torch.profiler); and the E=2^21 call once more on rows of 72
  floats (32-byte aligned), as a measurement only.
  K2 at the implicitFeedback band setting (G=128, M=8, k=64, N=4308,
  T=159), one wrapper call per round on the same device tensors as the
  trainer makes them: ms per step from CUDA events, the host's
  microseconds per call, and under the profiler the device busy time per
  step, its share of the round (the first round of a profiler session,
  when the host is slowest, and five later rounds of one session with a
  synchronise after each) and the busiest kernels, and from the kernel's
  own clock (``train_rounds_svdpp_kernel.trace``) the microseconds per
  step that its first block spends in each phase and at each grid
  barrier.
  K1 at basicMF shapes (N=2626, k=64, B=4096, T=23) and at
  neighborhoodModel shapes (+ 7 global slots, 3 entries), and K3 at the
  stacked slice's shapes (G=128 units, RM=8, nseg=129, D=2, T=449), one
  wrapper call per round on the same device tensors as the trainer makes
  them: ms per step from CUDA events (back to back, and with a
  synchronise after each call), the host's microseconds per call, the
  launches per call, the device busy time per step and its share under
  the profiler, and, where the wrapper has a ``trace`` hook, the
  microseconds per step that the kernel's first block spends in each
  phase and at each grid barrier by its own clock.
  K4 at bigTable (a)'s step: ``train_step_sweep`` on one B=2^20 batch of
  bigTable's data (the 2,048,577-row table, k=64), ms per step from CUDA
  events, the device time by kernel under torch.profiler and K4's own
  microseconds; ``--cases k4`` runs this case alone.
  bigSvdpp (``--cases bigsvdpp``, chip_smoke.py phase 11's data): the
  sorted-dedup step shared by the big-table epochs at one step's 16,384
  rows (every tree), and a round of the big SVD++ epoch, user-carry and
  entry-stream bodies (trees that have it): host against card per step.

    python3 scripts/kernel_split.py --cases bigsvdpp --parent build/parent --out docs/kernel_split_pr8.json

  K4 on rows of more than 256 factors (``--cases k4wide``): phase 6's wide
  cases (K4_WIDE), ms per call of the wrapper beside the bound, the same
  in turns with the plain version as phase 6 times it (5 and 20 calls a
  turn), the kernel's microseconds under torch.profiler, the host's
  microseconds a wrapper call, and the largest difference from the plain
  version, in each tree.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def device_times(torch, run):
    """{kernel name: (launches, device us)} and the elapsed us of one
    ``run()`` under torch.profiler.  A plain PyTorch op opens the session:
    one that opens with a ctypes launch records no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    per_kernel = {}
    for _ in range(2):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
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
        if len(per_kernel) > 1:
            break
    return per_kernel, elapsed_us


def event_ms(torch, fn, calls, sync_each=False):
    """ms per call of ``fn`` from CUDA events around ``calls`` calls."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
        if sync_each:
            torch.cuda.synchronize()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def host_us(torch, fn, calls):
    """Host microseconds per call: the host clock around ``calls``
    enqueues with no synchronise between them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / calls


def timed_pack(trainer, ds):
    """(the trainer's staged pack of ``ds``, its seconds): the tracer's
    ``pack`` spans, or on a tree before the tracer its ``pack_seconds``."""
    try:
        from svdfeature_tpu_torch import tracing
    except ImportError:  # a tree before the tracer
        entry = trainer._pack_plus(ds)
        return entry, getattr(trainer, "pack_seconds", None)
    tracing.enable()
    try:
        entry = trainer._pack_plus(ds)
    finally:
        tracing.disable()
    return entry, tracing.total_s(tracing.drain()[0], "pack")


def kernel_us(per_kernel, needle):
    """(launches, us per launch) of the kernels whose name holds ``needle``."""
    hits = [(n, us) for name, (n, us) in per_kernel.items() if needle in name]
    n = sum(h[0] for h in hits)
    return n, (sum(h[1] for h in hits) / n if n else None)


def wrapper_split(torch, call, wrapper, steps, trace_names, calls=5):
    """The split of one round's wrapper call ``call()`` (``steps`` steps):
    launches per call, ms per step from CUDA events (back to back and with a
    synchronise after each call, three turns each), host us per call, the
    device busy time per step and its share of the call under the profiler,
    the busiest kernels, and the kernel's own clock per phase where
    ``wrapper`` has a ``trace`` hook of ``len(trace_names)`` slots."""
    import chip_smoke

    call()
    before = wrapper.launches
    call()
    res = {"launches_per_call": wrapper.launches - before}
    ms = [event_ms(torch, call, calls) / steps for _ in range(3)]
    ms_sync = [event_ms(torch, call, calls, sync_each=True) / steps for _ in range(3)]
    host = host_us(torch, call, calls)
    prof, elapsed = device_times(torch, call)
    prof.pop("Memset (Device)", None)
    busy = sum(us for _, us in prof.values())
    tops = sorted(prof.items(), key=lambda kv: -kv[1][1])[:5]
    res.update({
        "ms_per_step": statistics.median(ms), "ms_per_step_turns": ms,
        "ms_per_step_sync_each_call": statistics.median(ms_sync),
        "host_us_per_call": host, "host_us_per_step": host / steps,
        "device_busy_us_per_step": busy / steps, "elapsed_us_per_step": elapsed / steps,
        "busy_share": busy / elapsed,
        "top": [[chip_smoke._short(name), cnt, us / cnt] for name, (cnt, us) in tops],
        "phase_us_per_step": None,
    })
    if hasattr(wrapper, "trace"):
        trace = torch.zeros(len(trace_names), dtype=torch.int64, device="cuda")
        wrapper.trace = trace
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        wrapper.trace = None
        res["phase_us_per_step"] = {n: v / (calls * steps) / 1e3
                                    for n, v in zip(trace_names, trace.tolist())}
    return res


def k4_split(torch, dev, chip_smoke, big):
    """bigTable (a)'s step on one batch: ``train_step_sweep`` at B=2^20 on
    the 2,048,577-row augmented table (k=64, reg_method 0, use_pallas on),
    through the tree's own plan functions, so that a parent whose K4 reads
    a payload and a change whose K4 forms its entries compare at the step
    level.  ms per step from CUDA events (three turns of five steps), the
    device time per step by kernel under torch.profiler, and K4's own
    microseconds (its ``sweep_apply`` launches)."""
    import numpy as np

    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.ops import big_embed, cuda_sweep, tile_sweep
    from svdfeature_tpu_torch.ops.embed import HyperParams

    B = 1 << 20
    k, tile, e_cap = chip_smoke.BIG_K, tile_sweep.SWEEP_TILE, tile_sweep.SWEEP_ECAP
    n = chip_smoke.BIG_NU + chip_smoke.BIG_NI + 1
    n_pad = -(-n // tile) * tile
    u = big["index"][0:2 * B:2].astype(np.int32)
    i = (chip_smoke.BIG_NU + big["index"][1:2 * B:2]).astype(np.int32)
    arrays = dict(label=big["labels"][None, :B], weight=np.ones((1, B), np.float32),
                  g_idx=np.zeros((1, B, 1), np.int32), g_val=np.zeros((1, B, 1), np.float32),
                  u_idx=u[None, :, None], u_val=np.ones((1, B, 1), np.float32),
                  i_idx=i[None, :, None], i_val=np.ones((1, B, 1), np.float32))
    arrays = tile_sweep.attach_sweep_runs(
        tile_sweep.attach_sweep_plans(arrays, n_pad, tile, e_cap), tile, e_cap)
    batch = {key: x[0] for key, x in convert.stacked_from_numpy(arrays, dev).items()}
    rng = np.random.default_rng(3)
    st = dict(w=rng.standard_normal((n, k), dtype=np.float32) * 0.01, b=np.zeros(n, np.float32),
              g=np.zeros(1, np.float32), step=np.int32(0), ref_ui=np.zeros(n, np.int32),
              ref_g=np.zeros(1, np.int32))
    st["w"][-1] = 0.0
    wd = np.zeros(n_pad, np.float32)
    wd[: n - 1] = 0.004
    consts = convert.consts_from_numpy(wd, wd, np.zeros(1, np.float32), 0.0, 0.0, device=dev)
    held = [big_embed.augment_state(convert.state_from_numpy(**st, device=dev), k,
                                    pad_rows_to=tile)]
    del st
    hp = HyperParams(big_table=True, num_factor=k, sweep_table=True, row_dma=True,
                     base_score=3.0)
    lr = torch.tensor(0.005, device=dev)

    def step():
        held[0] = tile_sweep.train_step_sweep(held[0], batch, lr, consts, hp)

    step()
    before = cuda_sweep.sweep_update.launches
    step()
    res = {"k4_launches_per_step": cuda_sweep.sweep_update.launches - before}
    ms = [event_ms(torch, step, 5) for _ in range(3)]
    prof, elapsed = device_times(torch, step)
    busy = sum(us for _, us in prof.values())
    res.update({
        "ms_per_step": statistics.median(ms), "ms_per_step_turns": ms,
        "device_busy_us_per_step": busy, "elapsed_us_per_step": elapsed,
        "k4_us": kernel_us(prof, "sweep_apply")[1],
        "kernels": sorted(([chip_smoke._short(name), cnt, us] for name, (cnt, us) in prof.items()),
                          key=lambda r: -r[2])[:12],
        "finite": bool(torch.isfinite(held[0].w).all()),
    })
    return res


def bigsvdpp_split(torch, dev):
    """bigSvdpp's steps (chip_smoke.py phase 11: the 2,248,001-row table,
    k=64, 4096 users x 4 rows a step), for one tree.  Both trees: the
    sorted-dedup step ``big_embed.train_step_big`` that the big-table
    epochs share, on one step's 16,384 (user, item) rows of the data:
    ms per step from CUDA events, host us per step, device busy us per
    step and K5's us.  Trees with ops/svdpp_big.py: a round of the
    user-carry epoch and one of the entry-stream body (reg_method=4)
    through the trainer, split as ``wrapper_split`` splits a wrapper call
    (K5 launches per round, ms per step, host us per step, device busy per
    step and its share, the busiest kernels).  The data comes from this
    script's own tree (its chip_smoke.big_plus_arrays), so a parent tree
    without it takes the same data."""
    import importlib.util

    import numpy as np

    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.ops import big_embed, cuda_scatter
    from svdfeature_tpu_torch.ops.embed import HyperParams

    spec = importlib.util.spec_from_file_location("chip_smoke_data", ROOT / "chip_smoke.py")
    data = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(data)
    arrays, dims = data.big_plus_arrays()
    k = dims["KF"]
    NU, NI, NF = dims["NU"], dims["NI"], dims["NF"]
    n = NU + NI + NF + 1
    res = {}

    # the shared dedup step: users at [NF, NF+NU), items above (the model's layout)
    B = 16384
    u = (NF + arrays["index"][0:2 * B:2]).astype(np.int32)
    i = (NF + NU + arrays["index"][1:2 * B:2]).astype(np.int32)
    one = np.ones((1, B, 1), np.float32)
    batch = {key: x[0] for key, x in convert.stacked_from_numpy(dict(
        label=arrays["labels"][None, :B], weight=one[..., 0], g_idx=np.zeros((1, B, 1), np.int32),
        g_val=np.zeros((1, B, 1), np.float32), u_idx=u[None, :, None], u_val=one,
        i_idx=i[None, :, None], i_val=one), dev).items()}
    rng = np.random.default_rng(3)
    st = dict(w=rng.standard_normal((n, k), dtype=np.float32) * 0.01, b=np.zeros(n, np.float32),
              g=np.zeros(1, np.float32), step=np.int32(0), ref_ui=np.zeros(n, np.int32),
              ref_g=np.zeros(1, np.int32))
    st["w"][-1] = 0.0
    wd = np.zeros(n, np.float32)
    wd[: n - 1] = 0.004
    consts = convert.consts_from_numpy(wd, wd, np.zeros(1, np.float32), 0.0, 0.0, device=dev)
    held = [big_embed.augment_state(convert.state_from_numpy(**st, device=dev), k)]
    del st
    hp = HyperParams(big_table=True, num_factor=k, row_dma=True, base_score=3.0)
    lr = torch.tensor(0.005, device=dev)

    def step():
        held[0] = big_embed.train_step_big(held[0], batch, lr, consts, hp)

    step()
    ms = [event_ms(torch, step, 20) for _ in range(3)]
    host = host_us(torch, step, 20)
    prof, elapsed = device_times(torch, step)
    res["dedup_step"] = {
        "B": B, "ms_per_step": statistics.median(ms), "ms_per_step_turns": ms,
        "host_us_per_step": host, "device_busy_us_per_step": sum(us for _, us in prof.values()),
        "elapsed_us_per_step": elapsed, "k5_us": kernel_us(prof, "row_write")[1],
        "launches_per_step": sum(cnt for cnt, _ in prof.values()),
    }
    del held, batch, consts
    torch.cuda.empty_cache()
    try:
        from svdfeature_tpu_torch.ops import svdpp_big  # noqa: F401  (absent before the port of it)
    except ImportError:
        return res

    from svdfeature_tpu_torch.data import csr
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.svdpp import SVDPPFeatureTrainer

    ds = data.plus_dataset(csr, arrays)
    del arrays
    for name, extra in (("carry_epoch", {}), ("entry_stream_epoch", {"reg_method": "4"})):
        tr = SVDPPFeatureTrainer(SVDTypeParam(format_type=1))
        conf = dict(base_score="3", learning_rate="0.005", wd_item="0.004", wd_user="0.004",
                    wd_ufeedback="0.004", num_user=str(NU), num_item=str(NI),
                    num_ufeedback=str(NF), num_global="0", num_factor=str(k), sort_blocks="1",
                    rows_per_user="4", users_per_batch="4096", device="cuda", **extra)
        for key, val in conf.items():
            tr.set_param(key, val)
        tr.init_model()
        tr.init_trainer()
        entry, pack_s = timed_pack(tr, ds)
        steps = len(entry.chunk_id)
        r = wrapper_split(torch, lambda: tr.update_all(ds), cuda_scatter.row_writer, steps, [],
                          calls=2)
        r.update(steps_per_round=steps, pack_s=pack_s,
                 carry="chunk_users" in entry.fb,
                 k5_us=kernel_us(device_times(torch, lambda: tr.update_all(ds))[0], "row_write")[1])
        res[name] = r
        del tr, entry
        torch.cuda.empty_cache()
    return res


# phase 6's wide cases (the change's chip_smoke.WIDE_CASES; a parent tree's
# chip_smoke may list fewer), on the inputs of chip_smoke.wide_inputs
K4_WIDE = ((257, "uniform", 1), (300, "uniform", 0), (300, "skewed", 2), (512, "uniform", 4),
           (512, "skewed", 0), (301, "skewed", 5), (1024, "uniform", 3))


def k4wide_split(torch, dev, chip_smoke):
    """K4 on rows of more than 256 factors: each of K4_WIDE on phase 6's
    WIDE_N-row table at batch WIDE_B, through the tree's own plan
    functions and wrapper: the largest difference from the plain version,
    ms per call from CUDA events (chip_smoke.timed: 20 calls a turn, 5
    turns, the median and the spread between turns) beside the bound, the
    same in turns with the plain version as phase 6 takes it (5 calls a
    turn, as it first did, and 20), the kernel's microseconds a launch under
    torch.profiler and the host's microseconds a wrapper call."""
    import numpy as np

    from svdfeature_tpu_torch.ops import cuda_sweep
    from svdfeature_tpu_torch.ops.embed import HyperParams

    rng = np.random.default_rng(15)
    half = (chip_smoke.WIDE_N - 1) // 2
    u = rng.integers(0, half, chip_smoke.WIDE_B).astype(np.int32)
    items = {"uniform": (half + rng.integers(0, half, chip_smoke.WIDE_B)).astype(np.int32),
             "skewed": (half + chip_smoke.zipf_items(half, chip_smoke.WIDE_B,
                                                     chip_smoke.SKEW_EXPONENT, seed=16)
                        ).astype(np.int32)}
    res = {}
    for k, kind, m in K4_WIDE:
        case = chip_smoke.big_sweep_case(torch, dev, chip_smoke.WIDE_N, u, items[kind], seed=17,
                                         k=k)
        hp = HyperParams(big_table=True, num_factor=k, sweep_table=True, reg_method=m)
        got = cuda_sweep.sweep_update(case["w"].clone(), *case["args"], hp)
        want = cuda_sweep.sweep_update_reference(case["w"].clone(), *case["args"], hp)
        err = float((got[:, :k + 1] - want[:, :k + 1]).abs().max())
        del got, want
        work = case["w"].clone()

        def kernel():
            cuda_sweep.sweep_update(work, *case["args"], hp)

        spread = {}
        t = chip_smoke.timed(torch, {"kernel": kernel}, inner=20, turns=5, spread=spread)
        # in turns with the plain version, 5 calls a turn (as phase 6 first
        # timed them) and 20 (as it does now)
        turns6 = {}
        for inner in (5, 20):
            turns6[inner] = chip_smoke.timed(torch, {
                "plain": lambda: cuda_sweep.sweep_update_reference(work, *case["args"], hp),
                "kernel": kernel}, inner=inner)["kernel"]
        per_kernel, _ = device_times(torch, lambda: [kernel() for _ in range(5)])
        bound_ms = chip_smoke.sweep_bound(case)[0]
        res[f"k{k}_{kind}_r{m}"] = {"ms": t["kernel"], "spread_ms": spread["kernel"],
                                    "turns5_ms": turns6[5], "turns20_ms": turns6[20],
                                    "device_us": kernel_us(per_kernel, "sweep_")[1],
                                    "host_us": host_us(torch, kernel, 50),
                                    "bound_ms": bound_ms, "share": bound_ms / t["kernel"],
                                    "max_abs_err": err}
        del case, work
        torch.cuda.empty_cache()
    return res


def worker(tree: str, cases) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke
    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.ops import _build, big_embed, cuda_imfb, cuda_scatter, cuda_svdpp
    from svdfeature_tpu_torch.ops.embed import HyperParams
    from svdfeature_tpu_torch.ops.svdpp import PlusHyper

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load_library()
    out = {"tree": tree, "build_s": time.perf_counter() - t0}
    if "k4" in cases:
        out["k4_step"] = k4_split(torch, dev, chip_smoke, chip_smoke.bigtable_arrays())
        torch.cuda.empty_cache()
    if "bigsvdpp" in cases:
        out["bigsvdpp"] = bigsvdpp_split(torch, dev)
        torch.cuda.empty_cache()
    if "k4wide" in cases:
        out["k4wide"] = k4wide_split(torch, dev, chip_smoke)
        torch.cuda.empty_cache()
    if not cases & {"k5", "k2", "k1", "k3"}:
        print("RESULT " + json.dumps(out), flush=True)
        return

    # ---- K5 -----------------------------------------------------------------
    n = chip_smoke.BIG_NU + chip_smoke.BIG_NI + 1
    W = big_embed.aug_width(chip_smoke.BIG_K)
    rng = np.random.default_rng(11)
    tbl = torch.from_numpy(rng.standard_normal((n, W), dtype=np.float32)).to(dev)
    tbl[-1] = 0.0
    big = chip_smoke.bigtable_arrays()
    ent = np.sort(np.concatenate([big["index"][0:2 * 4096:2].astype(np.int64),
                                  chip_smoke.BIG_NU + big["index"][1:2 * 4096:2].astype(np.int64)]))
    last = np.append(ent[1:] != ent[:-1], True)
    vals_np = rng.standard_normal((ent.size, W), dtype=np.float32)
    idx_c = torch.from_numpy(np.where(last, ent, n - 1).astype(np.int32)).to(dev)
    vals_c = torch.from_numpy(np.where(last[:, None], vals_np, 0.0).astype(np.float32)).to(dev)
    idx_c_long = idx_c.long()
    E = 1 << 21
    on_dummy = rng.random(E) < 0.2
    idx_np = np.full(E, n - 1, np.int32)
    idx_np[~on_dummy] = rng.permutation(n - 1)[: int((~on_dummy).sum())]
    big_vals = rng.standard_normal((E, W), dtype=np.float32)
    big_vals[idx_np == n - 1] = 0.0
    idx_b, vals_b = torch.from_numpy(idx_np).to(dev), torch.from_numpy(big_vals).to(dev)
    idx_b_long = idx_b.long()
    del big, big_vals

    def k5():
        cuda_scatter.row_writer(tbl, idx_c, vals_c)

    def lib5():
        tbl.index_copy_(0, idx_c_long, vals_c)

    for fn in (k5, lib5):
        fn()
    k5_ms, lib_ms = [], []
    for _ in range(3):
        k5_ms.append(event_ms(torch, k5, 1000))
        lib_ms.append(event_ms(torch, lib5, 1000))
        lib_ms.append(event_ms(torch, lib5, 1000))
        k5_ms.append(event_ms(torch, k5, 1000))
    prof, _ = device_times(torch, lambda: [k5() for _ in range(20)] + [lib5() for _ in range(20)])
    out["k5_8192"] = {
        "kernel_ms": statistics.median(k5_ms), "kernel_ms_turns": k5_ms,
        "library_ms": statistics.median(lib_ms), "library_ms_turns": lib_ms,
        "kernel_host_us": host_us(torch, k5, 1000), "library_host_us": host_us(torch, lib5, 1000),
        "kernel_device_us": kernel_us(prof, "row_")[1],
        "library_device_us": kernel_us(prof, "index")[1],
    }
    if hasattr(cuda_scatter, "_entry_point"):
        # the wrapper with its launch replaced by an entry point that
        # launches nothing: what the host pays outside cudaLaunchKernel
        bound = cuda_scatter._entry_point
        noop = _build.load_library().row_noop
        cuda_scatter._entry_point = lambda name: noop
        out["k5_8192"]["kernel_host_us_no_launch"] = host_us(torch, k5, 1000)
        cuda_scatter._entry_point = bound
    big_t = chip_smoke.timed(torch, {
        "kernel": lambda: cuda_scatter.row_writer(tbl, idx_b, vals_b),
        "library": lambda: tbl.index_copy_(0, idx_b_long, vals_b),
        "reader": lambda: cuda_scatter.row_reader(tbl, idx_b),
        "reader_library": lambda: torch.index_select(tbl, 0, idx_b_long)})
    out["k5_2m"] = big_t
    del tbl, vals_b, idx_c, vals_c, idx_c_long
    torch.cuda.empty_cache()
    # the same call on rows of 72 floats (32-byte aligned rows): a
    # measurement only, the table's layout stays at aug_width
    W72 = 72
    tbl72 = torch.zeros((n, W72), dtype=torch.float32, device=dev)
    vals72 = torch.randn((E, W72), dtype=torch.float32, device=dev)
    vals72[idx_b == n - 1] = 0.0
    out["k5_2m_w72"] = chip_smoke.timed(torch, {
        "kernel": lambda: cuda_scatter.row_writer(tbl72, idx_b, vals72),
        "library": lambda: tbl72.index_copy_(0, idx_b_long, vals72)})
    del tbl72, vals72, idx_b, idx_b_long
    torch.cuda.empty_cache()

    # ---- K2 -----------------------------------------------------------------
    x = chip_smoke.svdpp_inputs(True, 8, 0, False, seed=20)
    fb, overlap = convert.pool_from_numpy(x["fb"], x["overlap"], dev)
    stacked = convert.stacked_from_numpy(x["stacked"], dev)
    consts = convert.consts_from_numpy(**x["cs"], device=dev)
    hp = HyperParams(base_score=3.0)
    ph = PlusHyper(rows_per_user=8, off_user=1682, wd_ufeedback=0.004, wd_ufeedback_bias=0.002)
    lrs = torch.tensor([0.005], device=dev)
    T = x["stacked"]["label"].shape[0]
    state = convert.state_from_numpy(**x["st"], device=dev)

    def k2():
        nonlocal state
        state = cuda_svdpp.train_rounds_svdpp_kernel(
            state, stacked, x["chunk_id"], fb, overlap, lrs, consts, hp, ph)

    k2()
    before = cuda_svdpp.train_rounds_svdpp_kernel.launches
    k2()
    per_call = cuda_svdpp.train_rounds_svdpp_kernel.launches - before
    ms = [event_ms(torch, k2, 5) / T for _ in range(3)]
    ms_sync = [event_ms(torch, k2, 5, sync_each=True) / T for _ in range(3)]
    t0 = time.perf_counter()
    for _ in range(5):
        k2()
    host = (time.perf_counter() - t0) * 1e6 / 5
    torch.cuda.synchronize()
    prof, elapsed = device_times(torch, k2)
    prof.pop("Memset (Device)", None)
    busy = sum(us for _, us in prof.values())
    tops = sorted(prof.items(), key=lambda kv: -kv[1][1])[:5]
    # later rounds of one session, a synchronise after each: the elapsed
    # time of each from CUDA events, the kernels' from the profiler
    later = []

    def rounds():
        k2()
        torch.cuda.synchronize()
        for _ in range(5):
            later.append(event_ms(torch, k2, 1) * 1e3)

    later_prof, _ = device_times(torch, rounds)
    # per round: each kernel's mean time, as often as a round launches it
    # (six rounds ran; a session may drop a few events)
    later_busy = sum(us / n * -(-n // 6) for n, us in later_prof.values())
    phases = None
    if hasattr(cuda_svdpp.train_rounds_svdpp_kernel, "trace"):
        # the kernel's own clock: block 0's first thread, per phase
        trace = torch.zeros(9, dtype=torch.int64, device=dev)
        cuda_svdpp.train_rounds_svdpp_kernel.trace = trace
        for _ in range(5):
            k2()
        torch.cuda.synchronize()
        cuda_svdpp.train_rounds_svdpp_kernel.trace = None
        names = ("flush", "gather", "step", "apply", "barrier_after_flush",
                 "barrier_after_gather", "barrier_after_step", "barrier_after_apply",
                 "product_in_apply")
        phases = {n: v / (5 * T) / 1e3 for n, v in zip(names, trace.tolist())}
    out["k2"] = {
        "phase_us_per_step": phases,
        "launches_per_call": per_call,
        "ms_per_step": statistics.median(ms), "ms_per_step_turns": ms,
        "ms_per_step_sync_each_round": statistics.median(ms_sync),
        "host_us_per_call": host, "host_us_per_step": host / T,
        "device_busy_us_per_step": busy / T, "elapsed_us_per_step": elapsed / T,
        "busy_share_first_round": busy / elapsed,
        "busy_share_later_rounds": later_busy / statistics.median(later),
        "later_rounds_elapsed_us": later,
        "top": [[chip_smoke._short(name), cnt, us / cnt] for name, (cnt, us) in tops],
        "finite": bool(torch.isfinite(state.w).all()),
    }

    # ---- K1 and K3: one call per round on held tensors ------------------------
    from svdfeature_tpu_torch.ops import cuda_embed

    for shape, NG, SG in (("basicMF", 1, 1), ("neighborhoodModel", 7, 3)):
        st, cs, stk, _ = chip_smoke.make_inputs(0, NG, SG, seed=10, R=1)
        held = [convert.state_from_numpy(**st, device=dev), convert.stacked_from_numpy(stk, dev),
                lrs, convert.consts_from_numpy(**cs, device=dev)]

        def k1(held=held):
            held[0] = cuda_embed.train_rounds_kernel(*held, hp)

        out[f"k1_{shape}"] = wrapper_split(
            torch, k1, cuda_embed.train_rounds_kernel, stk["label"].shape[0],
            ("accumulate", "apply", "barrier_after_accumulate", "barrier_after_apply"))
        out[f"k1_{shape}"]["finite"] = bool(torch.isfinite(held[0].w).all())

    y = chip_smoke.imfb_inputs(8, 38, False)
    fb3, overlap3 = convert.pool_from_numpy(y["fb"], y["overlap"], dev)
    held3 = [convert.state_from_numpy(**y["st"], device=dev),
             convert.stacked_from_numpy(y["stacked"], dev), y["chunk_id"], fb3, overlap3,
             convert.gate_from_numpy(y["enabled"], dev), lrs,
             convert.consts_from_numpy(**y["cs"], device=dev)]

    def k3():
        held3[0] = cuda_imfb.train_rounds_imfb_kernel(*held3, hp, ph)

    out["k3"] = wrapper_split(
        torch, k3, cuda_imfb.train_rounds_imfb_kernel, y["stacked"]["label"].shape[0],
        ("flush", "gather", "step", "delta", "apply", "barrier_after_flush",
         "barrier_after_gather", "barrier_after_step", "barrier_after_delta",
         "barrier_after_apply", "product_in_apply"))
    out["k3"]["finite"] = bool(torch.isfinite(held3[0].w).all())
    print("RESULT " + json.dumps(out), flush=True)


def medians(results):
    """Per-key medians over a tree's turns (numbers only, nested dicts)."""
    first = results[0]
    if isinstance(first, dict):
        return {k: medians([r[k] for r in results if k in r]) for k in first}
    if isinstance(first, (int, float)) and not isinstance(first, bool):
        return statistics.median(results)
    return first


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a second tree (the parent commit, unpacked) to run in turns")
    ap.add_argument("--out", help="write the summary JSON here too")
    ap.add_argument("--cases", default="k5,k2,k1,k3,k4",
                    help="comma-separated subset of k5,k2,k1,k3 (together), k4, k4wide and "
                         "bigsvdpp")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, set(args.cases.split(",")))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_split: torch.cuda.is_available() is false", flush=True)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    trees = {"change": str(ROOT)}
    order = ["change"]
    if args.parent:
        trees["parent"] = str(pathlib.Path(args.parent).resolve())
        order = ["parent", "change", "change", "parent"]
    turns = {name: [] for name in trees}
    for name in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", trees[name],
                               "--cases", args.cases],
                              capture_output=True, text=True, cwd=trees[name])
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(f"turn {name} failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}",
                  flush=True)
            return 1
        res = json.loads(lines[-1][len("RESULT "):])
        turns[name].append(res)
        print(f"turn {name}: {json.dumps(res)}", flush=True)
    summary = {"card": card, "torch": torch.__version__,
               "trees": {name: medians(rs) for name, rs in turns.items()}}
    text = json.dumps(summary, indent=1)
    print(text, flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
