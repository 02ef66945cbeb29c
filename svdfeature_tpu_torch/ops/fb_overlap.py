"""The feedback overlap of a user-group pack, built on the training device:
the one place the port makes it.

``data/batching_plus.pack_plus`` (a verbatim copy of the JAX package's)
ends by computing each chunk's overlap ``O[u, v] = sum_f val_uf * val_vf``
over its pool's slots on the host (``compute_fb_overlap``: a host ``[G+1,
U]`` array a chunk, U the chunk's distinct ids, and ``P @ P.T``; or the
factored ``compute_fb_overlap_factored``).  With SVD++'s own implicit
feedback at KDD-Cup scale a chunk of 4096 users holds about 1e6 pool
entries over 3e5 ids, 1.5e5 of them shared: 2.5 GB and 5 GB of host arrays
and 10 TFLOP of host GEMM a chunk.

The trainers pack with that step deferred (``deferred()``: the copy's two
overlap functions answer None to this thread inside the block), and
``build`` makes O where an entry's pool reaches its training device, from
the staged pool with torch operations there, chunk by chunk, by the
copy's rule and in its forms:

  - an id held once in a chunk adds ``val^2`` to its slot's diagonal;
  - the ids held more than once (Ld of them, in ascending order) are the
    columns of ``dup [S, Ld]``, so ``O = diag + dup dupᵀ`` exactly;
  - with ``factored`` (big tables) the factored pair is returned where the
    largest Ld of a chunk is at most S (``dup`` padded with zero columns
    to that Ld), else the dense ``[C, S, S]``, whose product is taken over
    blocks of ``COLS`` shared ids in float64 (exact counts and sums
    whatever the process's TF32 setting) and rounded to float32 once.

The result equals the copy's within float32 summation order
(tests/test_torch_svdpp_kdd.py).  Traced as the span ``pack.overlap`` (on
the main thread only), with the counters ``overlap.dense`` / ``overlap.factored`` (chunks),
``overlap.ld`` (the largest Ld) and ``pool.live`` (live pool entries).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Union

import torch

from .. import tracing
from ..data import batching_plus

F32 = torch.float32
# shared ids a block of the dense product takes: [G+1, COLS] float64, 268 MB at G = 4096
COLS = 8192

_deferring = threading.local()
_HOST = ("compute_fb_overlap", "compute_fb_overlap_factored")


def _or_none(host_fn):
    """``host_fn``, or None inside a ``deferred()`` block of this thread."""

    def overlap(fb_idx, fb_val, fb_block, G):
        if getattr(_deferring, "on", False):
            return None
        return host_fn(fb_idx, fb_val, fb_block, G)

    overlap.defers = True
    return overlap


def _install() -> None:
    """Swap the copy's overlap functions for ``_or_none`` wrappers of
    themselves (at import, and again where a caller has replaced one)."""
    for name in _HOST:
        fn = getattr(batching_plus, name)
        if not getattr(fn, "defers", False):
            setattr(batching_plus, name, _or_none(fn))


_install()


@contextlib.contextmanager
def deferred():
    """Within the block, ``pack_plus`` called by this thread leaves its
    ``fb_overlap`` None: the copy's ``compute_fb_overlap`` and
    ``compute_fb_overlap_factored`` answer None to this thread and compute
    for any other (a streaming producer may pack meanwhile).  Nothing is
    held across the block: threads pack side by side."""
    _install()
    outer = getattr(_deferring, "on", False)
    _deferring.on = True
    try:
        yield
    finally:
        _deferring.on = outer


def _chunk_parts(idx: torch.Tensor, val: torch.Tensor, blk: torch.Tensor, S: int):
    """One chunk's pool split by the copy's rule: (diag ``[S]`` of the ids
    held once, the shared entries' user slots, their columns among the
    shared ids in ascending id order, their values, the number of shared
    ids)."""
    live = val != 0
    ids, v, b = idx[live], val[live], blk[live].long()
    _, inv, cnt = torch.unique(ids, return_inverse=True, return_counts=True)
    shared = cnt > 1
    solo = ~shared[inv]
    diag = torch.zeros(S, dtype=F32, device=val.device).index_add_(0, b[solo], v[solo] * v[solo])
    col = (torch.cumsum(shared, 0) - 1)[inv[~solo]]
    return diag, b[~solo], col, v[~solo], int(shared.sum())


def _dense(diag: torch.Tensor, b: torch.Tensor, col: torch.Tensor, v: torch.Tensor,
           ld: int) -> torch.Tensor:
    """``diag + dup dupᵀ`` as a dense ``[S, S]`` float32, the product over
    blocks of ``COLS`` shared ids in float64."""
    S = diag.shape[0]
    acc = torch.diag(diag.double())
    col, order = torch.sort(col)
    b, v = b[order], v[order].double()
    bounds = torch.searchsorted(col, torch.arange(0, ld + COLS, COLS, device=col.device)).tolist()
    for j, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        if lo == hi:
            continue
        block = torch.zeros((S, min(COLS, ld - j * COLS)), dtype=torch.float64,
                            device=diag.device)
        block.index_put_((b[lo:hi], col[lo:hi] - j * COLS), v[lo:hi], accumulate=True)
        acc.addmm_(block, block.T)
    return acc.to(F32)


@torch.no_grad()
def build(fb: Dict[str, torch.Tensor], G: int, *, factored: bool,
          slots: str = "fb_block") -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """Each chunk's overlap over ``S = G+1`` slots from the staged pool
    ``fb`` (``fb_idx``, ``fb_val`` and the slot plane ``slots``, ``[C, F]``:
    ``fb_block``, or ``fb_ctx`` with G the stacked pack's
    ``ctx_depth.shape[1]``) on its device: with ``factored`` the factored
    ``{"diag": [C, S], "dup": [C, S, Ld]}`` where every chunk shares at
    most S ids, else the dense ``[C, S, S]``; the forms of the copy's
    ``compute_fb_overlap_factored`` and ``compute_fb_overlap``."""
    # spans are the training (main) thread's; a streaming producer's build only counts
    main = threading.current_thread() is threading.main_thread()
    if tracing.on:
        if main:
            tracing.begin("pack.overlap")
    S = G + 1
    parts = [_chunk_parts(i, v, b, S)
             for i, v, b in zip(fb["fb_idx"], fb["fb_val"], fb[slots])]
    ld = max(p[4] for p in parts)
    if factored and ld <= S:
        dup = torch.zeros((len(parts), S, max(ld, 1)), dtype=F32, device=fb["fb_val"].device)
        for c, (_, b, col, v, _) in enumerate(parts):
            dup[c].index_put_((b, col), v, accumulate=True)
        out = {"diag": torch.stack([p[0] for p in parts]), "dup": dup}
    else:
        out = torch.stack([_dense(*p) for p in parts])
    if tracing.on:
        tracing.count("overlap.factored" if isinstance(out, dict) else "overlap.dense", len(parts))
        tracing.count("overlap.ld", ld)
        tracing.count("pool.live", int((fb["fb_val"] != 0).sum()))
        if main:
            tracing.end()
    return out
