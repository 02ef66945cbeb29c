"""The port's tracer: host spans and counters, off by default.

A span is a named interval of the host's work on ``time.perf_counter_ns``,
the clock of the benchmark's own spans and of its device trace's marker
(``portbench/harness/trace.py``), so a span maps onto the profiler's clock
by the same offset.  A span records the id of the span it opened inside
(its parent, -1 at the top) and the round it belongs to, which the
trainer's ``set_round`` sets.  Spans are kept in memory until ``drain()``
hands them over; counters are named integers beside them.  ``drain()``
also reads the hand-written kernels' own launch counters (the wrappers'
``.launches``, K1-K6), which stay where they are.

A span site is written

    if tracing.on:
        tracing.begin("name")
    ...
    if tracing.on:
        tracing.end()

so that with tracing off it costs one test of a module flag and makes no
object and no clock read.  ``then(name)`` ends the innermost span and opens
its next sibling at the same instant.  A span is closed by the ``end()``
of its own site: an exception between the two leaves it open until
``enable()`` or ``disable()`` clears the stack.

While tracing is on, a CUDA process counts the host's implicit
synchronisations with the card (``host_syncs``, and
``host_syncs.<innermost span>``): torch's sync debug mode warns at each,
and the warning is counted, and its Python line in ``sync_sites``, instead
of shown.  An explicit ``torch.cuda.synchronize()`` is no such
warning; the trainers span it (``sync.wait``).
"""

from __future__ import annotations

import importlib
import itertools
import time
import warnings
from typing import Dict, List, NamedTuple, Tuple

# the flag every span site tests
on = False

now = time.perf_counter_ns

# the kernel wrappers whose .launches counters drain() reads, by kernel id
KERNELS = {
    "K1": ("svdfeature_tpu_torch.ops.cuda_embed", "train_rounds_kernel"),
    "K2": ("svdfeature_tpu_torch.ops.cuda_svdpp", "train_rounds_svdpp_kernel"),
    "K3": ("svdfeature_tpu_torch.ops.cuda_imfb", "train_rounds_imfb_kernel"),
    "K4": ("svdfeature_tpu_torch.ops.cuda_sweep", "sweep_update"),
    "K5": ("svdfeature_tpu_torch.ops.cuda_scatter", "row_writer"),
    "K6": ("svdfeature_tpu_torch.ops.cuda_scatter", "row_reader"),
}
_SYNC_MESSAGE = "called a synchronizing CUDA operation"


class Span(NamedTuple):
    name: str
    start: int  # ns, time.perf_counter_ns
    end: int
    id: int
    parent: int  # the id of the span it opened inside, -1 at the top
    round: int  # the round set by set_round, -1 before the first


_spans: List[tuple] = []  # closed spans as plain tuples of Span's fields (cheaper to make)
_stack: List[Tuple[int, str, int]] = []  # the open spans: (id, name, start)
_ids = itertools.count()
_counters: Dict[str, int] = {}
_launch_base: Dict[str, int] = {}
sync_sites: Dict[str, int] = {}  # counted syncs by "<innermost span> <file>:<line>"
_round = -1
_warnings = None  # the catch_warnings that sync counting entered
_shown = None  # warnings.showwarning before it
_sync_mode = None  # torch's sync debug mode before enable()


def begin(name: str) -> None:
    """Open span ``name`` inside the innermost open span."""
    _stack.append((next(_ids), name, now()))


def end() -> None:
    """Close the innermost open span."""
    if _stack:
        _close(now())


def then(name: str) -> None:
    """Close the innermost open span and open ``name`` in its place, at the
    same instant."""
    t = now()
    if _stack:
        _close(t)
    _stack.append((next(_ids), name, t))


def _close(t: int) -> None:
    sid, name, t0 = _stack.pop()
    _spans.append((name, t0, t, sid, _stack[-1][0] if _stack else -1, _round))


def add(name: str, start: int, end_ns: int) -> None:
    """Record a span measured by the caller (two ``now()`` readings) inside
    the innermost open span."""
    _spans.append((name, start, end_ns, next(_ids), _stack[-1][0] if _stack else -1, _round))


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def set_round(r: int) -> None:
    global _round
    _round = r


def _launches() -> Dict[str, int]:
    out = {}
    for kid, (module, wrapper) in KERNELS.items():
        out[kid] = int(getattr(importlib.import_module(module), wrapper).launches)
    return out


def _count_sync(message, category, filename, lineno, file=None, line=None) -> None:
    if str(message).startswith(_SYNC_MESSAGE):
        where = _stack[-1][1] if _stack else "-"
        count("host_syncs")
        count(f"host_syncs.{where}")
        site = f"{where} {filename}:{lineno}"
        sync_sites[site] = sync_sites.get(site, 0) + 1
        return
    _shown(message, category, filename, lineno, file, line)


def _count_syncs() -> None:
    """Torch's sync debug mode set to warn, its warnings counted (every
    one: the filter is ``always``) and not shown; a process without CUDA
    makes no such warning."""
    global _warnings, _shown, _sync_mode
    import torch

    if _warnings is not None or not torch.cuda.is_available():
        return
    _warnings = warnings.catch_warnings()
    _warnings.__enter__()
    _shown = warnings.showwarning
    warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
    warnings.filterwarnings("always", message=_SYNC_MESSAGE)
    warnings.showwarning = _count_sync
    _sync_mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")


def _stop_counting_syncs() -> None:
    global _warnings
    if _warnings is None:
        return
    import torch

    torch.cuda.set_sync_debug_mode(_sync_mode)
    _warnings.__exit__(None, None, None)
    _warnings = None


def enable() -> None:
    """Start recording, from empty buffers and the kernels' launch counts
    as they stand."""
    global on, _launch_base, _round
    _spans.clear()
    _stack.clear()
    _counters.clear()
    sync_sites.clear()
    _round = -1
    _launch_base = _launches()
    _count_syncs()
    on = True


def disable() -> None:
    """Stop recording; what was recorded stays for ``drain()``."""
    global on
    on = False
    _stack.clear()
    _stop_counting_syncs()


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The spans closed and the counts made since the last drain (or
    ``enable()``), each kernel's launches among the counts as
    ``launches.K<n>`` where it launched; the buffers start again empty."""
    global _launch_base
    spans = list(map(Span._make, _spans))
    _spans.clear()
    counters = dict(_counters)
    _counters.clear()
    launches = _launches()
    for kid, n in launches.items():
        if n > _launch_base.get(kid, 0):
            counters[f"launches.{kid}"] = n - _launch_base.get(kid, 0)
    _launch_base = launches
    return spans, counters


def self_ns(spans: List[Span]) -> Dict[str, int]:
    """Nanoseconds by span name, each span's duration less its children's
    (children and parents drained together)."""
    inner: Dict[int, int] = {}
    for s in spans:
        if s.parent >= 0:
            inner[s.parent] = inner.get(s.parent, 0) + s.end - s.start
    out: Dict[str, int] = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + s.end - s.start - inner.get(s.id, 0)
    return out


def total_s(spans: List[Span], name: str) -> float:
    """Seconds in the spans named ``name``."""
    return sum(s.end - s.start for s in spans if s.name == name) / 1e9
