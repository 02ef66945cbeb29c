"""Multi-round stacked multi-IMFB training: the Hopper kernel and its plain
PyTorch version.

Replaces the TPU kernel svdfeature_tpu/ops/pallas_svdpp.py::_make_kernel
with D>0 (``train_rounds_imfb_pallas``): K2's whole-run Pallas call with
the segments changed from a chunk's users to its local feedback contexts,
a multi-hot slot->context selector matrix, a per-chunk depth gate and the
within-unit damping.  On the H100 csrc/fused_imfb.cu runs a wrapper call
as one persistent cooperative launch, ``imfb_rounds``, built from K2's
pieces (the pool flush and context gather keyed by ``fb_ctx``, the row
apply and O @ delta, with G := nseg - 1): a grid of one block per SM
walks rounds, steps and chunk starts from int32 planes and puts a
grid-wide barrier after each phase of a step, the step (a block per unit,
a warp per slot; the per-context sums by atomics, because contexts are
shared across units), the delta (a warp per context) and the apply.  The
wrapper keeps K2's form: a checked plan per set of tensors, a kept
scratch, one ctypes call (ops/_plans.py).

Semantics (f32 throughout) are those of ops/imfb.train_epoch_imfb_carried
per round; the TPU kernel reads tables and payloads in bf16, so the port
is held to the f32 path.  Both versions update ``state.w`` / ``state.b``
in place and return the new TrainState.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ._plans import Plan, find_plan, keep_plan, kept_scratch, launch_args, plan_list
from .cuda_scatter import _entry_point, _raw_stream, check_tensors
from .cuda_svdpp import (_PLAIN, MAX_ROWS_PER_USER, _check_inputs, big_table_failure,
                         device_schedule, kernel_failure, shared_space_failure)
from .embed import HyperParams, TrainConsts, TrainState
from .imfb import train_epoch_imfb_carried
from .svdpp import PlusHyper


def gate_failure(hp: HyperParams, state: TrainState, stacked, ph: PlusHyper) -> Optional[str]:
    """Why K3 does not take this stacked configuration, or None.

    The semantic conditions of ``pallas_imfb_supported``
    (pallas_svdpp.py:653-682) without its TPU layout limits: those of the
    SVD++ path (``cuda_svdpp.shared_space_failure``, whose configurations
    the stacked refresh epoch runs, ``big_table_failure``, whose tables the
    big-table stacked epoch runs, and ``kernel_failure``) and an item width
    of 1; plus at most 32 rows per unit.  The solver sends the kernel's
    other refusals to the plain rounds."""
    reason = (shared_space_failure(ph, "ops/imfb.train_epoch_imfb")
              or big_table_failure(hp, state, "ops/imfb.train_epoch_imfb_big")
              or kernel_failure(hp, state, stacked))
    if reason is not None:
        return reason
    if stacked["i_idx"].shape[-1] != 1:
        return f"K3 takes single-entry item segments; {_PLAIN}"
    if ph.rows_per_user > MAX_ROWS_PER_USER:
        return (f"K3 takes no rows_per_user above {MAX_ROWS_PER_USER} (one warp per slot of a "
                f"unit's block); {_PLAIN}")
    return None


@torch.no_grad()
def train_rounds_imfb_reference(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    fb_overlap: torch.Tensor,
    enabled: torch.Tensor,
    lrs: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
) -> TrainState:
    """The plain version of the kernel: R rounds of
    ops/imfb.train_epoch_imfb_carried, round r at lr ``lrs[r]``."""
    for r in range(lrs.shape[0]):
        state = train_epoch_imfb_carried(
            state, stacked, chunk_id, fb, fb_overlap, enabled, lrs[r], consts, hp, ph)
    return state


def _check_contexts(
    ctx: torch.Tensor, enabled: torch.Tensor, fb: Dict[str, torch.Tensor], n: int, dev
) -> None:
    """The context planes and the gate: int32 ``ctx [n, D]`` with ids in
    [0, nseg), f32 ``enabled [C, nseg]``, and an empty pad context (every
    pool entry of context nseg-1 has value 0); raises ValueError."""
    C, nseg = enabled.shape
    for name, x, dtype, shape in (("ctx_slots", ctx, torch.int32, (n, ctx.shape[-1])),
                                  ("enabled", enabled, torch.float32, (C, nseg))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the table on {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, the kernel takes {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if fb["fb_idx"].shape[0] != C:
        raise ValueError(f"enabled has {C} chunks, the pool {fb['fb_idx'].shape[0]}")
    if nseg < 2 or ctx.shape[-1] < 1:
        raise ValueError("no feedback context (nseg < 2) or no context plane")
    pad_live = ((fb["fb_ctx"] == nseg - 1) & (fb["fb_val"] != 0)).any()
    lo, hi, bad_pad = torch.stack([ctx.min(), ctx.max(), pad_live.to(torch.int32)]).tolist()
    if lo < 0 or hi >= nseg:
        raise ValueError(f"ctx_slots outside [0, {nseg})")
    if bad_pad:
        raise ValueError(f"the pad context {nseg - 1} holds pool entries of nonzero value")


_PLANS = plan_list()
_STATIC = ("u_idx", "u_val", "i_idx", "i_val", "label", "weight", "ctx_slots")
_POOL = ("fb_idx", "fb_val", "fb_ctx")
# the order of csrc/fused_imfb.cu's struct ImfbRounds
_ROUNDS_POINTERS = (
    "w", "b", "acc", "agg", "inv", "dacc", "delta", "cacc",
    "u_idx", "i_idx", "ctx", "fb_idx", "fb_ctx", "seg", "cid", "first", "live",
    "u_val", "i_val", "label", "weight", "fb_val", "O", "enabled",
    "lrs", "wd_u", "wd_i", "wd_ub", "wd_ib", "trace",
)
_SLOT = {name: i for i, name in enumerate(_ROUNDS_POINTERS)}
TRACE_SLOTS = 11


def _plan(state, stacked, chunk_id, fb, fb_overlap, enabled, lrs, consts, RM: int) -> Plan:
    """The checked planes of this call: from the kept plans when the very
    same tensors come again unmodified for the same table height, rows per
    unit and schedule, else checked now (two host syncs)."""
    tensors = (*[stacked[p] for p in _STATIC], *[fb[p] for p in _POOL], fb_overlap, enabled)
    cid = np.asarray(chunk_id)
    key = (state.w.shape[0], RM, cid.tobytes())
    plan = find_plan(_PLANS, tensors, key)
    if plan is not None:
        return plan
    T, GS = stacked["label"].shape
    C = fb["fb_idx"].shape[0]
    D = stacked["ctx_slots"].shape[-1]
    if GS % RM:
        raise ValueError(f"{GS} slots per step are not {RM} rows of whole units")
    if cid.shape != (T,) or cid.min() < 0 or cid.max() >= C:
        raise ValueError(f"chunk_id must have shape ({T},) and values in [0, {C})")
    planes = {
        "u_idx": stacked["u_idx"][..., 0].reshape(-1),
        "u_val": stacked["u_val"][..., 0].reshape(-1),
        "i_idx": stacked["i_idx"].reshape(-1),
        "i_val": stacked["i_val"].reshape(-1),
        "label": stacked["label"].reshape(-1),
        "weight": stacked["weight"].reshape(-1),
    }
    planes = {p: x.contiguous() for p, x in planes.items()}
    ctx = stacked["ctx_slots"].reshape(T * GS, D)
    # the context pool in K2's terms: G := nseg - 1 segments plus the pad
    G = enabled.shape[1] - 1
    _check_contexts(ctx, enabled, fb, T * GS, state.w.device)
    seg, _ = _check_inputs(state, planes, fb, fb_overlap, lrs, consts, G, 1, seg_key="fb_ctx")
    sched = device_schedule(cid, seg, state.w.device)
    ptrs = (ctypes.c_void_p * len(_ROUNDS_POINTERS))()
    for name, x in planes.items():
        ptrs[_SLOT[name]] = x.data_ptr()
    for name in _POOL:
        ptrs[_SLOT[name]] = fb[name].data_ptr()
    for name, x in zip(("ctx", "O", "enabled", "seg", "cid", "first", "live"),
                       (ctx, fb_overlap, enabled, seg, *sched)):
        ptrs[_SLOT[name]] = x.data_ptr()
    return keep_plan(_PLANS, tensors, key, (planes, ctx, seg, sched), ptrs,
                     (stacked["weight"] > 0).sum().to(torch.int32))


@torch.no_grad()
def train_rounds_imfb_kernel(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    fb_overlap: torch.Tensor,
    enabled: torch.Tensor,
    lrs: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
) -> TrainState:
    """R rounds of the stacked steps through csrc/fused_imfb.cu.

    On CUDA tensors this makes one cooperative launch (counted in
    ``train_rounds_imfb_kernel.launches``; its grid is left in ``.grid``)
    and raises on anything it cannot run; there is no fallback.  Tensors
    on the CPU take the plain version, ``train_rounds_imfb_reference``."""
    if state.w.device.type == "cpu":
        return train_rounds_imfb_reference(
            state, stacked, chunk_id, fb, fb_overlap, enabled, lrs, consts, hp, ph)
    if state.w.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.w.device}")
    reason = gate_failure(hp, state, stacked, ph)
    if reason is not None:
        raise ValueError(f"kernel cannot run this configuration: {reason}")
    T, GS = stacked["label"].shape
    N, k = state.w.shape
    RM = ph.rows_per_user
    R = lrs.shape[0]
    nseg = enabled.shape[1]
    dev = state.w.device
    plan = _plan(state, stacked, chunk_id, fb, fb_overlap, enabled, lrs, consts, RM)
    # what changes from call to call (a kept plan's tensors were checked)
    check_tensors({
        "w": (state.w, torch.float32, (N, k)), "b": (state.b, torch.float32, (N,)),
        "lrs": (lrs, torch.float32, (R,)),
        "wd_u_row": (consts.wd_u_row, torch.float32, (N,)),
        "wd_i_row": (consts.wd_i_row, torch.float32, (N,)),
        "wd_user_bias": (consts.wd_user_bias, torch.float32, ()),
        "wd_item_bias": (consts.wd_item_bias, torch.float32, ()),
    }, dev)
    if k == 0 or R == 0:
        raise ValueError("empty batch, table or round schedule")
    stream = _raw_stream(dev.index)
    ptrs = plan.ptrs
    scratch = kept_scratch({"acc": N * (k + 3), "agg": nseg * (k + 2), "inv": nseg,
                            "dacc": nseg * (k + 1), "delta": nseg * (k + 1),
                            "cacc": nseg * (k + 4)}, dev, stream)
    for name, ptr in scratch.items():
        ptrs[_SLOT[name]] = ptr
    trace = train_rounds_imfb_kernel.trace
    if trace is not None:
        check_tensors({"trace": (trace, torch.int64, (TRACE_SLOTS,))}, dev)
    for name, x in (("w", state.w), ("b", state.b), ("lrs", lrs), ("wd_u", consts.wd_u_row),
                    ("wd_i", consts.wd_i_row), ("wd_ub", consts.wd_user_bias),
                    ("wd_ib", consts.wd_item_bias), ("trace", trace)):
        ptrs[_SLOT[name]] = None if x is None else x.data_ptr()
    scalars = (N, k, GS // RM, RM, stacked["ctx_slots"].shape[-1], nseg, T, R,
               fb["fb_idx"].shape[1], hp.active_type, 0 if hp.no_user_bias else 1,
               hp.base_score, ph.scale_lr_ufeedback, ph.wd_ufeedback, ph.wd_ufeedback_bias)
    ints, floats, grid = launch_args(plan, scalars, 11)
    err = _entry_point("imfb_rounds")(ptrs, ints, floats, ctypes.byref(grid), stream)
    if err:
        raise RuntimeError(f"imfb_rounds launch failed: CUDA error {err}")
    train_rounds_imfb_kernel.launches += 1
    train_rounds_imfb_kernel.grid = grid.value
    return dataclasses.replace(state, step=torch.add(state.step, plan.n_live, alpha=R))


train_rounds_imfb_kernel.launches = 0
train_rounds_imfb_kernel.grid = 0
# None, or an int64 [11] tensor on the device into which the kernel adds the
# nanoseconds its first block spends in each phase (flush, gather, step,
# delta, apply), at the barrier after each, and in the product
# (csrc/fused_imfb.cu, struct ImfbRounds; scripts/kernel_split.py and
# chip_smoke.py read it)
train_rounds_imfb_kernel.trace = None


def launches_per_call(chunk_id: np.ndarray, rounds: int) -> int:
    """The kernel launches of one wrapper call: one cooperative launch,
    whatever the rounds, steps and chunk starts."""
    return 1
