"""The device trace of a window: torch.profiler recording the card's
activity only, read from its raw records, and the benchmark's own host
spans.

A plain PyTorch op opens the recording (one whose first launch is a
ctypes one has been seen to record nothing); its kernel is also the marker
that maps the host clock onto the profiler's clock.  Recording the host's
ops as well would cost far more than the window.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Tuple

Event = Tuple[str, int, int]  # (kernel name, start ns, duration ns), profiler clock


def short_name(name: str) -> str:
    """A demangled kernel name without namespaces, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", name, maxsplit=1)[0].strip().split(" ")[-1].split("::")[-1][-64:]


class Spans:
    """The host's spans of the window, as (name, start, end) on
    ``time.perf_counter_ns``."""

    def __init__(self) -> None:
        self.names: List[str] = []
        self.starts: List[int] = []
        self.ends: List[int] = []

    def add(self, name: str, start: int, end: int) -> None:
        self.names.append(name)
        self.starts.append(start)
        self.ends.append(end)

    def at(self, t: int) -> str:
        """The span the host was in at ``t`` (between spans: ``loop``)."""
        j = bisect.bisect_right(self.starts, t) - 1
        return self.names[j] if j >= 0 and self.ends[j] >= t else "loop"


class DeviceTrace:
    """``with DeviceTrace(torch) as tr:`` records the card while the block
    runs; afterwards ``tr.events`` holds the device records and
    ``tr.offset`` the profiler clock minus the host clock (ns)."""

    def __init__(self, torch) -> None:
        self.torch = torch
        self.events: List[Event] = []
        self.offset: Optional[int] = None
        self._marker_host = 0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._marker_host = time.perf_counter_ns()
        self.torch.zeros(1, device="cuda")
        self.torch.cuda.synchronize()
        return self

    def __exit__(self, *exc) -> None:
        self.torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        from torch.autograd import DeviceType

        evs = [(e.name(), int(e.start_ns()), int(e.duration_ns()))
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        evs.sort(key=lambda e: e[1])
        if evs:
            self.offset = evs[0][1] - self._marker_host
            self.events = evs[1:]


def busy_intervals(events: List[Event], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the records' intervals inside [lo, hi), merged."""
    out: List[Tuple[int, int]] = []
    for _, s, d in events:
        a, b = max(s, lo), min(s + d, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def per_kernel(events: List[Event]) -> Dict[str, Tuple[int, float]]:
    """(launches, seconds) of each kernel by its short name."""
    out: Dict[str, Tuple[int, float]] = {}
    for name, _, d in events:
        n, s = out.get(short_name(name), (0, 0.0))
        out[short_name(name)] = (n + 1, s + d / 1e9)
    return out


def idle_by_span(busy: List[Tuple[int, int]], lo: int, hi: int, spans: Spans,
                 offset: int) -> Dict[str, float]:
    """Seconds the card was idle inside [lo, hi), summed by the host span
    each idle gap began in."""
    out: Dict[str, float] = {}
    t = lo
    for a, b in busy + [(hi, hi)]:
        if a > t:
            name = spans.at(t - offset)
            out[name] = out.get(name, 0.0) + (a - t) / 1e9
        t = max(t, b)
    return out
