"""The program's own spans and counters (``svdfeature_tpu_torch/tracing.py``)
read for a cell: the idle gaps of a device trace put down to the host code
that was running, and the readings of the step, the packing and K2's host
side.

The program's spans are on the host clock of the benchmark's own spans
(``time.perf_counter_ns``), so the device trace's offset maps both.  A
``--trace 1`` run would enable the tracer from the start of its set-up,
drain it when the window starts (the set-up's spans and counts) and after
the window, and hand both to these functions.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .trace import Spans

# the children of the big-table step (ops/big_embed.dedup_step,
# ops/tile_sweep.train_step_sweep)
STEP_CHILDREN = ("forward", "payload", "merge", "write", "sweep")


def innermost(program: Sequence) -> List[Tuple[int, int, str]]:
    """The program's nested spans as disjoint segments (start, end, name of
    the innermost span open there), in order; where none is open, none."""
    out: List[Tuple[int, int, str]] = []
    stack: list = []
    cur = 0

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for s in sorted(program, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1].end <= s.start:
            top = stack.pop()
            emit(cur, top.end, top.name)
            cur = top.end
        if stack:
            emit(cur, s.start, stack[-1].name)
        cur = s.start
        stack.append(s)
    while stack:
        top = stack.pop()
        emit(cur, top.end, top.name)
        cur = top.end
    return out


def idle_by_program_span(busy: List[Tuple[int, int]], lo: int, hi: int, spans: Spans,
                         program: Sequence, offset: int) -> Dict[str, float]:
    """Seconds the card was idle inside [lo, hi) (profiler clock), split
    instant by instant over what the host was in: ``<harness span>`` where
    no program span was open, else ``<harness span>/<innermost program
    span>``.  The names' seconds add up to the window's idle time, as
    ``trace.idle_by_span``'s do."""
    ga, gb = [], []
    t = lo
    for a, b in busy + [(hi, hi)]:
        if a > t:
            ga.append(t - offset)
            gb.append(a - offset)
        t = max(t, b)
    if not ga:
        return {}
    ga_a, gb_a = np.asarray(ga, np.int64), np.asarray(gb, np.int64)
    cum = np.concatenate([[0], np.cumsum(gb_a - ga_a)])

    segs = innermost(program)
    h_lo, h_hi = lo - offset, hi - offset
    cuts = {h_lo, h_hi}
    for x in (*spans.starts, *spans.ends, *(a for a, _, _ in segs), *(b for _, b, _ in segs)):
        if h_lo < x < h_hi:
            cuts.add(x)
    x = np.asarray(sorted(cuts), np.int64)
    # idle ns in [h_lo, x) at every cut
    j = np.searchsorted(ga_a, x, side="right") - 1
    jj = np.maximum(j, 0)
    inside = np.clip(x - ga_a[jj], 0, gb_a[jj] - ga_a[jj])
    before = np.where(j >= 0, cum[jj] + inside, 0)
    idle = np.diff(before)

    seg_starts = [a for a, _, _ in segs]
    out: Dict[str, float] = {}
    for i in np.flatnonzero(idle):
        t0 = int(x[i])
        h = bisect.bisect_right(spans.starts, t0) - 1
        name = spans.names[h] if h >= 0 and t0 < spans.ends[h] else "loop"
        k = bisect.bisect_right(seg_starts, t0) - 1
        if k >= 0 and t0 < segs[k][1]:
            name = f"{name}/{segs[k][2]}"
        out[name] = out.get(name, 0.0) + int(idle[i]) / 1e9
    return out


def step_host_ms(window: Sequence, counters: Dict[str, int]) -> Optional[float]:
    """The mean ``step`` span of the window, over its ``steps``."""
    steps = counters.get("steps", 0)
    if not steps:
        return None
    return sum(s.end - s.start for s in window if s.name == "step") / steps / 1e6


def step_split(window: Sequence, counters: Dict[str, int], rounds: int) -> Dict[str, float]:
    """Each child's mean self milliseconds a step, the step's own, and
    ``batches`` a round."""
    steps = counters.get("steps", 0)
    inner: Dict[int, int] = {}
    for s in window:
        if s.parent >= 0:
            inner[s.parent] = inner.get(s.parent, 0) + s.end - s.start
    own: Dict[str, int] = {}
    for s in window:
        own[s.name] = own.get(s.name, 0) + s.end - s.start - inner.get(s.id, 0)
    out = {n: own[n] / steps / 1e6 for n in (*STEP_CHILDREN, "step") if n in own and steps}
    if "batches" in own and rounds:
        out["batches_per_round"] = own["batches"] / rounds / 1e6
    return out


def pack_s(setup: Sequence) -> Optional[float]:
    """Seconds of the set-up's ``pack`` spans."""
    secs = sum(s.end - s.start for s in setup if s.name == "pack")
    return secs / 1e9 if secs else None


def k2_host_us(window: Sequence, counters: Dict[str, int]) -> Optional[float]:
    """The mean ``k2`` span per K2 launch (the card only)."""
    n = counters.get("launches.K2", 0)
    if not n:
        return None
    return sum(s.end - s.start for s in window if s.name == "k2") / n / 1e3


def step_launches(device_records: int, counters: Dict[str, int]) -> Optional[float]:
    """The window's device records a step (the card only)."""
    steps = counters.get("steps", 0)
    if not steps or not device_records:
        return None
    return device_records / steps
