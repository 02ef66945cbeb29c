"""Streamed chunks on the training device: what the trainers' stream hooks
share (out-of-core training, svdfeature_tpu/solvers/base.py:411-505).

data/streaming.py drives a streamed round: a producer thread reads a chunk
of the buffer, packs it (``pack_chunk`` / ``pack_plus_chunk`` /
``pack_imfb_chunk``, numpy) and stages it (``stage_chunk*``), and the
caller's thread trains it (``train_chunk*``) while the next one is read.
The trainers build a chunk's entry with its tensors on the CPU;
``ChunkStream`` moves them to the card and hands them over:

- **stage** (producer thread): each tensor is copied into pinned host
  memory and from there to the device with ``non_blocking=True`` on a side
  stream of that device (one per device), and an event is recorded after
  the copies.  The producer thread's current stream is that thread's
  default stream, so the side stream is set explicitly
  (``torch.cuda.device`` and ``torch.cuda.stream``): the copy overlaps the
  training stream's work.
- **claim** (caller's thread, entering ``train_chunk*``): the current
  (training) stream waits on that event before any work on the chunk is
  enqueued, and every staged tensor is ``record_stream``-ed on it, so that
  the caching allocator does not hand the tensor's memory back to the side
  stream while the training stream still reads it.  Without the wait the
  kernels may read a chunk that is still being copied: a silent race,
  wrong on some runs and right on others.
- **release** (leaving ``train_chunk*``): the kernel wrappers' kept plans
  of the chunk's tensors are dropped (ops/_plans.release_plans).  A plan
  keeps its tensors alive, so without this each wrapper would keep its
  last MAX_PLANS chunks on the device and the stream's memory bound would
  be gone.  A fresh chunk's plan is checked once, which ends in a host
  sync per wrapper call: once a chunk, by design.

Nothing falls back: a failed copy or launch raises, and an exception on the
producer thread reaches the caller through the copy's queue.  On a CPU
training device a chunk's tensors stay where they are.

``ChunkStream.stats`` is what the hooks count of the last streamed round:
its chunks, and on a CUDA device the device memory held beyond the
round's start at each chunk's entry against the largest chunk's bytes.
With the tracer on (``tracing.py``), the caller's thread's wait for each
chunk (from the round's start or the last ``train_chunk*`` to the next) is
the span ``stream.wait``, and its time in a chunk the span
``stream.chunk``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from .. import tracing
from ..ops._plans import release_plans


def map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``obj`` with ``fn`` applied to every tensor in it, through dicts and
    dataclasses (the trainers' entries); anything else (numpy arrays such
    as chunk ids and row permutations, None) as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: map_tensors(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj)})
    return obj


@dataclasses.dataclass
class Staged:
    """One chunk's entry, its tensors on the training device."""

    entry: object
    tensors: List[torch.Tensor]  # every tensor of ``entry``
    device: torch.device
    event: Optional[torch.cuda.Event]  # recorded on the side stream after the copies
    nbytes: int


@dataclasses.dataclass
class StreamStats:
    """What the hooks counted of the last streamed round (see the module
    docstring); the byte counts stay 0 off the card."""

    chunks: int = 0
    max_chunk_bytes: int = 0
    base_bytes: int = 0  # device memory allocated at the round's start
    max_excess_bytes: int = 0  # the most allocated beyond it at a chunk's entry


class ChunkStream:
    """A trainer's staging of streamed chunks (one per trainer)."""

    def __init__(self) -> None:
        self.stats = StreamStats()
        self._side: Dict[torch.device, torch.cuda.Stream] = {}
        self._mark = 0  # where the caller's wait for the next chunk began (tracer's clock)

    def begin_round(self, device: torch.device) -> None:
        """Start a streamed round's measurements."""
        base = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
        self.stats = StreamStats(base_bytes=base)
        self._mark = tracing.now() if tracing.on else 0

    def stage(self, entry, device: torch.device) -> Staged:
        """``entry`` (its tensors on the CPU) staged on ``device``; on a
        CUDA device through pinned memory on the device's side stream."""
        tensors: List[torch.Tensor] = []

        def keep(t: torch.Tensor) -> torch.Tensor:
            tensors.append(t)
            return t

        if device.type != "cuda":
            out = map_tensors(entry, keep)
            return Staged(out, tensors, device, None, sum(t.nbytes for t in tensors))
        side = self._side.get(device)
        if side is None:
            side = self._side[device] = torch.cuda.Stream(device=device)
        with torch.cuda.device(device), torch.cuda.stream(side):
            out = map_tensors(entry, lambda t: keep(t.pin_memory().to(device, non_blocking=True)))
            event = torch.cuda.Event()
            event.record(side)
        return Staged(out, tensors, device, event, sum(t.nbytes for t in tensors))

    @contextlib.contextmanager
    def training(self, staged: Staged):
        """Claim a staged chunk for the training stream, yield its entry,
        and release its kernel plans when the launches are enqueued."""
        if tracing.on:
            if self._mark:
                tracing.add("stream.wait", self._mark, tracing.now())
            tracing.begin("stream.chunk")
        st = self.stats
        if staged.event is not None:
            current = torch.cuda.current_stream(staged.device)
            current.wait_event(staged.event)
            for t in staged.tensors:
                t.record_stream(current)
            st.max_excess_bytes = max(st.max_excess_bytes,
                                      torch.cuda.memory_allocated(staged.device) - st.base_bytes)
        st.max_chunk_bytes = max(st.max_chunk_bytes, staged.nbytes)
        try:
            yield staged.entry
        finally:
            release_plans(map(id, staged.tensors))
            st.chunks += 1
            if tracing.on:
                tracing.end()
                self._mark = tracing.now()
