"""What the wrappers of the persistent kernels (K1 ops/cuda_embed.py, K2
ops/cuda_svdpp.py, K3 ops/cuda_imfb.py) keep from call to call.

A round of these kernels takes 0.1-5 ms on the card, so a wrapper's own
host work counts.  The checks of the packed planes (which end in a host
sync) and the device tensors derived from them are made once per set of
tensors and kept as a ``Plan`` while the same, unmodified tensors
(``_version``) come again, as they do round after round; the kernel's
scratch is one zeroed allocation kept per layout, device and stream.
A plan keeps its tensors alive; a trainer drops the plans of its tensors
when it goes (``release_plans``, solvers/base.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

MAX_PLANS = 4  # plans (and scratch buffers) kept per wrapper


@dataclasses.dataclass
class Plan:
    """What one set of packed tensors needs checked and derived once."""

    tensors: tuple  # kept alive, so their ids stay theirs
    ids: Tuple[int, ...]
    versions: List[int]
    key: tuple  # what else the checks depended on (table height, schedule, ...)
    keep: tuple  # the derived device tensors, kept alive for their pointers
    ptrs: ctypes.Array  # the kernel's pointer arguments; the per-call ones are set at each call
    n_live: torch.Tensor  # 0-d int32: slots of weight > 0
    scalars: tuple = ()  # the kernel's int and float arguments of the last call ...
    scalar_args: tuple = ()  # ... and their ctypes arrays, with the grid's int


_LISTS: List[List[Plan]] = []  # every wrapper's kept plans


def plan_list() -> List[Plan]:
    """A wrapper's list of kept plans, known to ``release_plans``."""
    plans: List[Plan] = []
    _LISTS.append(plans)
    return plans


def release_plans(ids: Iterable[int]) -> None:
    """Drop every kept plan that holds a tensor whose id is in ``ids`` (a
    trainer's staged tensors, when the trainer goes)."""
    ids = set(ids)
    for plans in _LISTS:
        plans[:] = [plan for plan in plans if ids.isdisjoint(plan.ids)]


def find_plan(plans: List[Plan], tensors: Sequence[torch.Tensor], key: tuple) -> Optional[Plan]:
    """The kept plan of these very tensors, unmodified, and ``key``, or None."""
    ids = tuple(map(id, tensors))
    versions = [x._version for x in tensors]
    for plan in plans:
        if plan.ids == ids and plan.versions == versions and plan.key == key:
            return plan
    return None


def keep_plan(plans: List[Plan], tensors: Sequence[torch.Tensor], key: tuple, keep: tuple,
              ptrs: ctypes.Array, n_live: torch.Tensor) -> Plan:
    """A new plan of ``tensors``, kept first in ``plans`` (at most MAX_PLANS)."""
    tensors = tuple(tensors)
    plan = Plan(tensors, tuple(map(id, tensors)), [x._version for x in tensors], key, keep, ptrs,
                n_live)
    plans.insert(0, plan)
    del plans[MAX_PLANS:]
    return plan


def launch_args(plan: Plan, scalars: tuple, n_ints: int) -> tuple:
    """(ints, floats, grid) ctypes arguments of a launch with ``scalars``
    (``n_ints`` ints, then floats), made again only when they change."""
    if plan.scalars != scalars:
        plan.scalars = scalars
        n_floats = len(scalars) - n_ints
        plan.scalar_args = ((ctypes.c_int * n_ints)(*scalars[:n_ints]),
                            (ctypes.c_float * n_floats)(*scalars[n_ints:]), ctypes.c_int(0))
    return plan.scalar_args


_SCRATCH: Dict[tuple, Tuple[torch.Tensor, Dict[str, int]]] = {}


def kept_scratch(sizes: Dict[str, int], device: torch.device, stream: int) -> Dict[str, int]:
    """The pointer of each part of a call's scratch, ``sizes`` floats each
    (16-byte aligned).

    One zeroed allocation per (layout, device, stream), kept from call to
    call: the kernels leave their accumulators cleared, as they found
    them, and write every other part before they read it, and calls on one
    stream run one after the other.  Under a CUDA graph's capture the call
    gets a zeroed allocation of its own, not kept: it comes from the graph's
    pool, which keeps its memory for the graph's replays, whereas a kept
    buffer could be freed while a graph still holds its address.  No
    capture runs on the default stream (handle 0), so a call there does not
    ask."""
    key = (tuple(sizes.items()), device, stream)
    capturing = stream != 0 and torch.cuda.is_current_stream_capturing()
    hit = None if capturing else _SCRATCH.get(key)
    if hit is None:
        offsets, total = {}, 0
        for name, size in sizes.items():
            offsets[name] = total
            total += -(-size // 4) * 4
        buf = torch.zeros((total,), dtype=torch.float32, device=device)
        base = buf.data_ptr()
        hit = (buf, {name: base + 4 * off for name, off in offsets.items()})
        if not capturing:
            if len(_SCRATCH) >= 3 * MAX_PLANS:
                _SCRATCH.pop(next(iter(_SCRATCH)))
            _SCRATCH[key] = hit
    return hit[1]
