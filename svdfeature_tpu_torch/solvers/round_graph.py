"""One CUDA graph a round for the big-table epochs on a staged pack.

Two big-table rounds are host loops of T small steps: the base solver's
(solvers/base._train: ``ops/big_embed.train_step_big``, about 140 device
ops a step, a few µs of the card's time apiece; ``ops/tile_sweep.
train_step_sweep``) and the SVD++ solver's (solvers/svdpp._train:
``ops/svdpp_big.train_epoch_plus_big``, about 25 torch calls a step, the
chunk entries and exits between them).  While the staged planes, the table
and the decay tables stay where they are, every op of a round has the same
shapes and addresses: the planes of a pack stay put in the trainer's pack
cache (the SVD++ entry with its pool, overlap and carry plan; its chunk
ids, on the host, choose the branches of the epoch), K5 and K4 update the
table in place, and the learning rate is a device scalar.  So the host's
dispatch of the ops can be recorded once and replayed.  The trainer runs
the first round on a pack eagerly (packing, the kernels' build and torch's
lazy set-up happen there), captures the whole of the second round into one
``torch.cuda.CUDAGraph`` (a side stream, a memory pool of the graph's own)
and replays it; each later round is one replay.

The graph reads the learning rate from a 0-d buffer of its own, which the
round's entry of the schedule is copied into on the device before each
replay, and it starts from and ends in its own ``g``, ``step`` and
``ref_g`` buffers: its last nodes copy the round's outputs back into them,
and the trainer's state points at them after a replay (the state's own are
copied in first where they are other tensors).  It holds what it reads by
address (the pack), and its key is what the captured ops read by address
or have baked in: the table's pointer and shape, the decay tables'
pointers and the step's switches (``hp``; on the SVD++ route also its
``PlusHyper`` and the carry flag).  A round whose key differs (a
checkpoint loaded, a state made anew) runs eagerly, and the round after it
captures again.

A capture counts nothing, since it runs nothing: what the captured round
counted is taken back, and a replay counts what the trainer says a round
counts (the base round's T ``steps``; the SVD++ epoch's T ``steps`` and C
``chunks``) and the kernel launches it holds (each wrapper's
``.launches``).  With the tracer on, ``graph.captures`` and
``graph.replays`` count, and the spans ``graph.capture`` and
``graph.replay`` cover a capture and a replay's enqueue.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Optional

import torch

from .. import tracing
from ..ops.embed import TrainState


def _wrappers():
    """The kernel wrappers that count their launches (``tracing.KERNELS``)."""
    return [getattr(importlib.import_module(module), name)
            for module, name in tracing.KERNELS.values()]


class RoundGraph:
    """The big-table rounds of one staged pack: eager until one round has
    run under the key, then one captured graph, replayed once a round."""

    def __init__(self, pack: Any, key: tuple, counts: Dict[str, int]) -> None:
        self.pack = pack  # held: what the graph reads stays, and the pack's id its own
        self.key = key
        self.counts = counts  # the tracer's counters a replay adds
        self.warm = False  # a round has run eagerly under this key
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.lr = self.g = self.step = self.ref_g = None  # the graph's static buffers
        self.launches: Dict[Callable, int] = {}  # kernel launches a replay makes

    def round(self, state: TrainState, lr: torch.Tensor,
              run: Callable[..., TrainState]) -> TrainState:
        """One round from ``state`` at learning rate ``lr`` (0-d, on the
        card): ``run(state, lr)`` eagerly the first time, else the graph of
        it, captured the first time it is needed."""
        if not self.warm:
            self.warm = True
            return run(state, lr)
        if self.graph is None:
            self._capture(state, run)
        return self._replay(state, lr)

    def _capture(self, state: TrainState, run: Callable[..., TrainState]) -> None:
        if tracing.on:
            tracing.count("graph.captures")
            tracing.begin("graph.capture")
        dev = state.w.device
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.g, self.step, self.ref_g = map(torch.empty_like, (state.g, state.step, state.ref_g))
        wrappers = _wrappers()
        before = [w.launches for w in wrappers]
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(dev)
        with tracing.uncounted(self.counts), torch.cuda.graph(graph, stream=stream):
            out = run(dataclasses.replace(state, g=self.g, step=self.step, ref_g=self.ref_g),
                      self.lr)
            if out.w is not state.w:
                raise RuntimeError("a captured round must update the table in place")
            self.g.copy_(out.g)
            self.step.copy_(out.step)
            self.ref_g.copy_(out.ref_g)
        # the wrappers counted launches that only the replays make
        self.launches = {}
        for w, n in zip(wrappers, before):
            if w.launches != n:
                self.launches[w] = w.launches - n
                w.launches = n
        self.graph = graph
        if tracing.on:
            tracing.end()

    def _replay(self, state: TrainState, lr: torch.Tensor) -> TrainState:
        if tracing.on:
            tracing.begin("graph.replay")
        for mine, now in ((self.g, state.g), (self.step, state.step), (self.ref_g, state.ref_g)):
            if now is not mine:
                mine.copy_(now)
        self.lr.copy_(lr)
        self.graph.replay()
        for w, n in self.launches.items():
            w.launches += n
        if tracing.on:
            tracing.count("graph.replays")
            for name, n in self.counts.items():
                tracing.count(name, n)
            tracing.end()
        return dataclasses.replace(state, g=self.g, step=self.step, ref_g=self.ref_g)
