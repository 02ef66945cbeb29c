#!/usr/bin/env python3
"""chip_smoke.py with a timeline: where the script's seconds go.

First times two torch.profiler sessions over the same 3,000 small ops
(6,000 kernels): one recording the host's ops and the card's, one the
card's only (the first session also pays the profiler's start-up), and
reads their device events raw and through ``prof.events()``.  Then runs
chip_smoke.main() in this process with every line it prints stamped with
the seconds since start, and prints, for each of a set of its functions
and of the port's entry points, its calls and their seconds in all (a
call inside another counts in both).  The kernels' wrappers are left
alone (their launch counts are the script's gates).

    python3 scripts/smoke_timeline.py > chiprun_out/timeline.log 2>&1
"""

from __future__ import annotations

import builtins
import collections
import functools
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# chip_smoke.py's own functions and the port's entry points that hold its time
SMOKE_FUNCTIONS = [
    "device_profile", "steady_busy_share", "timed", "svdpp_inputs", "imfb_inputs", "run_demo",
    "demo_rmse_at", "big_run", "big_plus_run", "rank_run", "task_run", "stream_run",
    "time_k5_shapes", "k5_first_calls", "write_bigtable", "write_big_plus", "write_rank",
    "write_implicit", "write_imfb", "write_follow", "write_big_bilinear", "big_sweep_case",
    "make_inputs", "mesh_call", "bigtable_arrays", "big_plus_arrays", "big_rank_arrays",
]


def profiler_probe():
    """The two sessions' seconds: the run and the stop, reading the raw
    device events, building the event list."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1024, device="cuda")

    def work():
        for _ in range(3000):
            x.add_(1.0).mul_(0.5)

    work()
    torch.cuda.synchronize()
    for acts, name in (([ProfilerActivity.CPU, ProfilerActivity.CUDA], "cpu+cuda"),
                       ([ProfilerActivity.CUDA], "cuda")):
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            work()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        raw = prof.profiler.kineto_results.events()
        n_raw = sum(1 for e in raw if e.device_type() == DeviceType.CUDA)
        t2 = time.perf_counter()
        events = prof.events()
        n = sum(1 for e in events if e.device_type == DeviceType.CUDA)
        t3 = time.perf_counter()
        print(f"probe {name}: run+stop {t1 - t0:.2f} s, raw events {len(raw)} cuda {n_raw} in "
              f"{t2 - t1:.2f} s, events() {len(events)} cuda {n} in {t3 - t2:.2f} s", flush=True)


def main() -> int:
    t_start = time.perf_counter()
    real_print = builtins.print

    def stamped(*args, **kwargs):
        if kwargs.get("file") is None:
            real_print(f"[{time.perf_counter() - t_start:7.1f}]", *args, **kwargs)
        else:
            real_print(*args, **kwargs)

    builtins.print = stamped
    profiler_probe()
    import chip_smoke
    from svdfeature_tpu_torch.infer.task import SVDInferTask
    from svdfeature_tpu_torch.ops import cuda_embed, cuda_imfb, cuda_svdpp, cuda_sweep
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    totals = collections.defaultdict(lambda: [0, 0.0])

    def wrap(owner, name, label):
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def timed_call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                entry = totals[label]
                entry[0] += 1
                entry[1] += time.perf_counter() - t0

        setattr(owner, name, timed_call)

    for name in SMOKE_FUNCTIONS:
        if hasattr(chip_smoke, name):
            wrap(chip_smoke, name, name)
    wrap(SVDTrainTask, "run", "SVDTrainTask.run")
    wrap(SVDTrainTask, "save_model", "SVDTrainTask.save_model")
    wrap(SVDInferTask, "run", "SVDInferTask.run")
    for mod in (cuda_embed, cuda_svdpp, cuda_imfb, cuda_sweep):  # the plain versions
        for name in dir(mod):
            if name.endswith("_reference"):
                wrap(mod, name, name if mod is not cuda_embed else f"cuda_embed.{name}")
    sys.argv = [str(ROOT / "chip_smoke.py")]
    try:
        return chip_smoke.main()
    finally:
        builtins.print = real_print
        for label, (calls, secs) in sorted(totals.items(), key=lambda kv: -kv[1][1]):
            print(f"TIMED {label}: {calls} calls {secs:.1f} s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
