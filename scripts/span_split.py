#!/usr/bin/env python3
"""The port's own spans in a benchmark cell: where the host's time goes, and
what the tracer costs.

    python3 scripts/span_split.py --cell kdd11_mf.b4k_zipf --seed 101 --seconds 12 \\
        --modes off,spans,profiler,both,both,profiler,spans,off --out split.jsonl

from the repository's root, on a CUDA card.  Each mode is one run of the
cell through the benchmark's own ``portbench/harness/cell.run``, in this
process, on the same seed and window length:

- ``off``: the benchmark's untraced run (``--trace 0``);
- ``spans``: the same with the port's tracer on (``svdfeature_tpu_torch/
  tracing.py``) and the profiler off;
- ``profiler``: the benchmark's traced run as it is (``--trace 1``);
- ``both``: the traced run with the tracer on, from the set-up's start.

The benchmark's own host spans and device trace are picked up from its
``trace`` module as the run makes them.  Each run prints one JSON line:
the window's rate, its rounds' host enqueue (``update_all`` +
``finish_round``) and round times, and with the tracer on the set-up's
``pack`` seconds, the step's host milliseconds and its children's self
time a step, ``batches`` a round, K2's host microseconds a launch, the
host syncs a round and where they came from; with the profiler on the
device records a step and the idle time by host span, the harness's
alone (``trace.idle_by_span``) and down to the program's innermost span
(``portbench/harness/program_spans.idle_by_program_span``), by the
harness's clock offset and by a second marker's.

    python3 scripts/span_split.py --site-cost

prints what a span site costs the host, off and on, and what a counted
host sync costs beyond the sync itself.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MODES = ("off", "spans", "profiler", "both")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def one_run(spec, seed: int, seconds: float, mode: str, device: str, rows: int) -> dict:
    """One run of the cell in ``mode`` (``rows`` training rows a round);
    its JSON line's fields."""
    import numpy as np

    from portbench.harness import cell, program, program_spans, trace
    from svdfeature_tpu_torch import tracing

    got = {"drains": []}
    plain = trace.Spans, trace.DeviceTrace, program.launch_counts

    class Spans(trace.Spans):
        def __init__(self) -> None:
            super().__init__()
            got["spans"] = self

    class DeviceTrace(trace.DeviceTrace):
        def __enter__(self):
            got["trace"] = self
            out = super().__enter__()
            # a second marker: the harness's is the first launch under the
            # profiler, which can start late on the card
            self.torch.zeros(1, device="cuda")
            self.second_marker = time.perf_counter_ns()
            self.torch.cuda.synchronize()
            return out

    def launch_counts():
        # read as the window starts and as it ends: the set-up's and the
        # window's program spans, counts and syncs part there
        got["drains"].append((*tracing.drain(), dict(tracing.sync_sites)))
        return plain[2]()

    trace.Spans, trace.DeviceTrace, program.launch_counts = Spans, DeviceTrace, launch_counts
    traced = mode in ("profiler", "both")
    if mode in ("spans", "both"):
        tracing.enable()
    try:
        result = cell.run(spec, seed, seconds, traced, time.perf_counter(), device_name=device,
                          log=sys.stderr)
    finally:
        tracing.disable()
        trace.Spans, trace.DeviceTrace, program.launch_counts = plain
    (setup_spans, _, sites0), (window, counters, sites1) = got["drains"]
    hs = got["spans"]
    rounds = hs.names.count("update_all")
    enqueue = [e - s for n, s, e in zip(hs.names, hs.starts, hs.ends)
               if n in ("update_all", "finish_round")]
    win0, win1 = hs.starts[0], hs.ends[-1]
    round_ms = (np.asarray(hs.ends[3::4]) - np.asarray(hs.starts[0::4])) / 1e6
    out = dict(cell=spec.name, seed=seed, mode=mode, correct=result["correct"], rounds=rounds,
               window_s=(win1 - win0) / 1e9, examples_per_s=rounds * rows / ((win1 - win0) / 1e9),
               round_ms_p95=float(np.percentile(round_ms, 95)),
               host_ms_per_round=sum(enqueue) / rounds / 1e6)
    if mode in ("spans", "both"):
        out.update(
            pack_s=program_spans.pack_s(setup_spans),
            step_host_ms=program_spans.step_host_ms(window, counters),
            step_split_ms=program_spans.step_split(window, counters, rounds),
            k2_host_us=program_spans.k2_host_us(window, counters),
            host_syncs_per_round=counters.get("host_syncs", 0) / rounds,
            sync_sites={k: v - sites0.get(k, 0) for k, v in sites1.items()
                        if v > sites0.get(k, 0)},
            counters=counters,
            spans_per_round=len(window) / rounds)
    tr = got.get("trace")  # none off the card
    if tr is not None and tr.offset is not None:
        lo, hi = win0 + tr.offset, win1 + tr.offset
        evs = [e for e in tr.events if e[1] < hi and e[1] + e[2] > lo]
        busy = trace.busy_intervals(evs, lo, hi)
        idle = trace.idle_by_span(busy, lo, hi, hs, tr.offset)
        out.update(device_records=len(evs), idle_s=sum(idle.values()),
                   busy_s=sum(b - a for a, b in busy) / 1e9,
                   idle_by_span=_top(idle))
        # the second marker's record comes first among the events
        offset2 = tr.events[0][1] - tr.second_marker
        out.update(marker_skew_us=(tr.offset - offset2) / 1e3)
        if mode == "both":
            split = program_spans.idle_by_program_span(busy, lo, hi, hs, window, tr.offset)
            again = program_spans.idle_by_program_span(busy, lo, hi, hs, window, offset2)
            out.update(idle_by_program_span=_top(split, 16),
                       idle_by_program_span_second_marker=_top(again, 16),
                       idle_split_total_s=sum(split.values()),
                       step_launches=program_spans.step_launches(len(evs), counters))
    return out


def site_cost(n: int = 200_000) -> dict:
    """Host ns of three span sites (``begin``, ``then``, ``end``: two
    spans) with the tracer off and on; on a card, ns of the dedup step's
    padding-slot write (``g[-1] = 0.0``, one host sync) uncounted and
    counted."""
    import torch

    from svdfeature_tpu_torch import tracing

    def sites():
        if tracing.on:
            tracing.begin("a")
        if tracing.on:
            tracing.then("b")
        if tracing.on:
            tracing.end()

    def per_call(fn, k):
        fn()
        t = time.perf_counter_ns()
        for _ in range(k):
            fn()
        return (time.perf_counter_ns() - t) / k

    out = {"three_sites_off_ns": per_call(sites, n)}
    tracing.enable()
    out["three_sites_on_ns"] = per_call(sites, n)
    tracing.disable()
    tracing.drain()
    if torch.cuda.is_available():
        g = torch.zeros(8, device="cuda")

        def zero():
            g[-1] = 0.0

        out["padding_write_ns"] = per_call(zero, 5000)
        tracing.enable()
        out["padding_write_counted_ns"] = per_call(zero, 5000)
        tracing.disable()
        out["counted"] = tracing.drain()[1].get("host_syncs", 0)
    return out


def _rows(spec, seed) -> int:
    """The training rows of a round (the cell's data, made from its seed)."""
    import importlib

    gen = importlib.import_module(f"portbench.gen.{spec.traffic['generator']}")
    return len(gen.make(spec.cfg["conf"], spec.traffic, seed)["train"]["labels"])


def _top(d: dict, n: int = 10) -> list:
    return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--site-cost", action="store_true", help="time the span sites and exit")
    ap.add_argument("--cell")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--modes", default="off,spans,profiler,both,both,profiler,spans,off")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="append the JSON lines to this file as well")
    args = ap.parse_args(argv)
    if args.site_cost:
        print(json.dumps(dict(site_cost(), card=card() if args.device == "cuda" else "cpu")))
        return 0
    if args.cell is None or args.seed is None:
        ap.error("--cell and --seed are required")
    from portbench.harness import spec as bench_spec

    modes = args.modes.split(",")
    if not set(modes) <= set(MODES):
        ap.error(f"modes are {MODES}")
    spec = bench_spec.load(args.cell)
    limit = card() if args.device == "cuda" else "cpu"
    rows = _rows(spec, args.seed)
    for mode in modes:
        line = dict(one_run(spec, args.seed, args.seconds, mode, args.device, rows), card=limit)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
