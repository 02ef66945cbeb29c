"""One run of one cell: set-up, the timed window, the traced reading and the
check against the plain reference.

Set-up: the trainer built from the configuration's keys, the data and
the initial leaves made from the seed, the leaves loaded into the trainer
as a checkpoint, then the compared rounds (the first packs the data: the
warm round), a checkpoint after each and the probe's scores after the
last.  The window then repeats the train task's round (``set_round``,
``update_all``, ``finish_round``, ``synchronize``) until its seconds have
passed.  After it the program's state is freed and the reference trains
the same rounds from the same leaves and data on the same device.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import math
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from . import compare, guard, leaves, program, trace
from .spec import Spec, reader

NUMBERS = ("change_gap_r1", "change_gap", "state_gap", "probe_gap")


class Context:
    """What a per-layer metric reader reads (metrics/<name>.py)."""

    def __init__(self, spec: Spec, conf: dict, data: dict) -> None:
        self.cfg, self.conf, self.data = spec.cfg, conf, data
        self.rounds = 0
        self.window_s = 0.0
        self.round_s: List[float] = []
        self.enqueue_s: List[float] = []
        self.warm_round_s = 0.0
        self.busy_s: Optional[float] = None
        self.kernels: Dict[str, tuple] = {}  # K id -> (launches, device seconds)
        self.power_limit = "not measured"
        self.notes: List[str] = []

    def note(self, line: str) -> None:
        self.notes.append(line)

    def kernel_time(self, kid: str):
        """(launches, device seconds) of a kernel in the window."""
        return self.kernels.get(kid, (0, 0.0))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def program_rounds(spec: Spec, seed: int, device, data: dict,
                   break_program: Optional[Callable] = None,
                   mark: Callable[[str], None] = lambda name: None):
    """The set-up through the compared rounds: (trainer, its dataset, the
    side's readings: change norms after the first round, the checkpoint
    after the last, the probe's scores), and the warm round's seconds.
    ``mark(step)`` is called as each step of the set-up ends."""
    import torch

    conf = program.conf_keys(spec.cfg, spec.traffic, device.type)
    init = leaves.initial(spec.cfg, seed, device)
    checkpoint = leaves.write_checkpoint(spec.cfg, init)
    del init
    mark("initial leaves")
    trainer = program.build_trainer(conf, checkpoint)
    if break_program is not None:
        break_program(trainer)
    ds = program.dataset(spec.cfg, data["train"])
    probe_ds = program.dataset(spec.cfg, data["probe"])
    trainer.init_trainer()
    mark("trainer")
    side = {}
    warm = 0.0
    R = int(spec.traffic["compared_rounds"])
    for r in range(R):
        t0 = time.perf_counter()
        trainer.set_round(r)
        trainer.update_all(ds)
        trainer.finish_round()
        trainer.synchronize()
        if r == 0:
            warm = time.perf_counter() - t0
        mark(f"round {r}")
        ck = program.checkpoint(trainer)
        if r == 0:
            side["n1"] = compare.norms(leaves.read_checkpoint(spec.cfg, ck, device),
                                       leaves.initial(spec.cfg, seed, device))
        side["final"] = ck
        mark(f"checkpoint {r}")
    side["probe"] = torch.as_tensor(np.asarray(trainer.predict_all(probe_ds), np.float32))
    mark("probe")
    return trainer, ds, side, warm


def reference_readings(spec: Spec, seed: int, device, data: dict, dtype=None,
                       fault: Optional[str] = None):
    """The reference's trained leaves, its change norms after the first and
    the last compared round, and its probe scores; with ``dtype`` (the
    control) or ``fault`` in the program's place, the same as a side's
    readings."""
    import torch

    ref = importlib.import_module(f"portbench.reference.{spec.cfg['model']}")
    conf = program.conf_keys(spec.cfg, spec.traffic, device.type)
    init = leaves.initial(spec.cfg, seed, device)
    L = {n: t.to(dtype or torch.float32).clone() for n, t in init.items()}
    out = {}

    def after(r):
        if r == 0:
            out["n1"] = compare.norms(L, init)

    ref.train(L, data, conf, int(spec.traffic["compared_rounds"]), after, fault)
    out["leaves"] = {n: t.float() for n, t in L.items()}
    out["change"] = compare.norms(L, init)
    out["probe"] = ref.predict(L, data, conf).float().cpu()
    return out


def numbers(spec: Spec, side: dict, ref: dict, device) -> Dict[str, float]:
    """The compared numbers of a side (its ``n1``, its ``final`` leaves or
    checkpoint, its ``probe``) against the reference's readings."""
    final = side["final"]
    if isinstance(final, (bytes, bytearray)):
        final = leaves.read_checkpoint(spec.cfg, final, device)
    init = leaves.initial(spec.cfg, side["seed"], device)
    return dict(
        change_gap_r1=compare.change_gap(side["n1"], ref["n1"]),
        change_gap=compare.change_gap(compare.norms(final, init), ref["change"]),
        state_gap=compare.state_gap(final, ref["leaves"], ref["change"]),
        probe_gap=compare.probe_gap(side["probe"], ref["probe"]),
    )


def _arm_clocks(torch, device) -> dict:
    """The persistent kernels' own clocks, zeroed, for the traced window."""
    armed = {}
    for kid, k in program.kernels().items():
        if k.CLOCK is not None:
            armed[kid] = torch.zeros(k.CLOCK[0], dtype=torch.int64, device=device)
            program.wrapper(k).trace = armed[kid]
    return armed


def _read_trace(ctx: Context, tr, spans, lo_host: int, hi_host: int, launches, armed) -> dict:
    """Busy time, kernel times and the breakdown of the traced window."""
    lo, hi = lo_host + tr.offset, hi_host + tr.offset
    evs = [e for e in tr.events if e[1] < hi and e[1] + e[2] > lo]
    busy = trace.busy_intervals(evs, lo, hi)
    busy_s = sum(b - a for a, b in busy) / 1e9
    by_name = trace.per_kernel(evs)
    for kid, k in program.kernels().items():
        seen = [(n, s) for name, (n, s) in by_name.items() if any(x in name for x in k.NAMES)]
        n_seen, s_seen = sum(n for n, _ in seen), sum(s for _, s in seen)
        counted = launches.get(kid, 0)
        if counted and n_seen < counted and kid in armed:
            # the profiler lost launches: the kernel's own clock stands in
            clock_s = float(armed[kid][:k.CLOCK[1]].sum()) / 1e9
            missing = clock_s * (counted - n_seen) / counted
            busy_s += missing
            s_seen += missing
            ctx.note(f"{kid}: the profiler saw {n_seen} of {counted} launches; "
                     f"{missing:.6f} s from its own clock")
        if counted or n_seen:
            ctx.kernels[kid] = (max(counted, n_seen), s_seen)
    ctx.busy_s = busy_s if busy_s > 0 else None
    idle = trace.idle_by_span(busy, lo, hi, spans, tr.offset)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[n, s] for n, (_, s) in top],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()), key=lambda x: -x[1])[:10]}


def run(spec: Spec, seed: int, seconds: float, traced: bool, t_start: float, device_name="cuda",
        break_program: Optional[Callable] = None, log=sys.stderr,
        t_imports: Optional[float] = None) -> dict:
    """One run; returns the result line's object.  ``t_start`` is the
    process's start on the host clock, ``t_imports`` the moment torch had
    been imported, where the caller took it."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device_name)
    on_card = device.type == "cuda"
    if on_card:
        torch.zeros(1, device=device)
    stamps = [("start", t_start)] + ([("imports", t_imports)] if t_imports else [])

    def mark(name):
        stamps.append((name, time.perf_counter()))

    mark("the card" if t_imports else "imports and the card")
    gen = importlib.import_module(f"portbench.gen.{spec.traffic['generator']}")
    data = gen.make(spec.cfg["conf"], spec.traffic, seed)
    mark("data")
    trainer, ds, side, warm = program_rounds(spec, seed, device, data, break_program, mark)
    side["seed"] = seed
    conf = program.conf_keys(spec.cfg, spec.traffic, device.type)
    ctx = Context(spec, conf, data)
    ctx.warm_round_s = warm

    # the window
    spans = trace.Spans()
    before = program.launch_counts()
    armed = _arm_clocks(torch, device) if traced and on_card else {}
    r = int(spec.traffic["compared_rounds"])
    tracer = trace.DeviceTrace(torch) if traced and on_card else contextlib.nullcontext()
    ns = time.perf_counter_ns
    with tracer as tr:
        win0 = ns()
        setup_s = time.perf_counter() - t_start
        while True:
            t0 = ns()
            trainer.set_round(r)
            t1 = ns()
            trainer.update_all(ds)
            t2 = ns()
            trainer.finish_round()
            t3 = ns()
            trainer.synchronize()
            t4 = ns()
            spans.add("set_round", t0, t1)
            spans.add("update_all", t1, t2)
            spans.add("finish_round", t2, t3)
            spans.add("synchronize", t3, t4)
            ctx.round_s.append((t4 - t0) / 1e9)
            ctx.enqueue_s.append((t3 - t0) / 1e9)
            r += 1
            if t4 - win0 >= seconds * 1e9:
                break
        win1 = t4
    for kid in armed:
        program.wrapper(program.kernels()[kid]).trace = None
    launches = {k: v - before[k] for k, v in program.launch_counts().items()}
    ctx.rounds = len(ctx.round_s)
    ctx.window_s = (win1 - win0) / 1e9
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    found = guard.forbidden_modules()
    if found:
        raise guard.Forbidden(found)
    breakdown = None
    if traced and on_card and tr.offset is not None:
        breakdown = _read_trace(ctx, tr, spans, win0, win1, launches, armed)
    ctx.power_limit = power_limit() if on_card else "not measured"

    del trainer, ds
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    ref = reference_readings(spec, seed, device, data)
    got = numbers(spec, side, ref, device)
    # a number that is not finite (a diverged side) is no number: it fails
    checks = {n: {"value": got[n] if math.isfinite(got[n]) else None,
                  "limit": spec.limits[n]["limit"]} for n in NUMBERS}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())

    if traced:
        metrics = {}
        for m in spec.per_layer:
            v = importlib.import_module(f"portbench.metrics.{reader(m)}").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        examples = ctx.rounds * len(data["train"]["labels"])
        values = dict(examples_per_s=examples / ctx.window_s,
                      round_ms_p95=1e3 * float(np.percentile(ctx.round_s, 95)),
                      setup_s=setup_s)
        metrics = {m["name"]: {"value": values[reader(m)], "unit": m["unit"]}
                   for m in spec.end_to_end}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    if traced:
        device_info.update(busy_s=ctx.busy_s or 0.0, window_s=ctx.window_s)
    result = {"correct": correct, "attempted": ctx.rounds, "failed": 0, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print("set-up: " + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b)
                                 in zip(stamps, stamps[1:])), file=log)
    for line in ctx.notes:
        print(line, file=log)
    print(f"{spec.name} seed {seed}: {ctx.rounds} rounds in {ctx.window_s:.3f} s, "
          f"launches {launches}, {ctx.power_limit}", file=log)
    for n, c in checks.items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})", file=log)
    return result
