"""Multi-round stacked multi-IMFB training: the Hopper kernel and its plain
PyTorch version.

Replaces the TPU kernel svdfeature_tpu/ops/pallas_svdpp.py::_make_kernel
with D>0 (``train_rounds_imfb_pallas``): K2's whole-run Pallas call with
the segments changed from a chunk's users to its local feedback contexts,
a multi-hot slot->context selector matrix, a per-chunk depth gate and the
within-unit damping.  On the H100 (csrc/fused_imfb.cu) each step is three
launches, ``imfb_step`` (one block per unit, one warp per slot, the
per-context sums by atomics because contexts are shared across units),
``imfb_delta`` (one block per context) and K2's ``svdpp_apply``; each chunk
start is K2's ``svdpp_flush`` and ``svdpp_gather`` keyed by ``fb_ctx``,
all issued on PyTorch's current stream by a host loop.

Semantics (f32 throughout) are those of ops/imfb.train_epoch_imfb_carried
per round; the TPU kernel reads tables and payloads in bf16, so the port
is held to the f32 path.  Both versions update ``state.w`` / ``state.b``
in place and return the new TrainState.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .cuda_embed import MAX_TABLE_ROWS
from .cuda_svdpp import MAX_ROWS_PER_USER, _check_inputs, _round_logs, semantic_failure
from .embed import HyperParams, TrainConsts, TrainState
from .imfb import train_epoch_imfb_carried
from .svdpp import PlusHyper, _is_first


def gate_failure(hp: HyperParams, state: TrainState, stacked, ph: PlusHyper) -> Optional[str]:
    """Why the stacked multi-IMFB path cannot run this configuration, or
    None.

    The semantic conditions of ``pallas_imfb_supported``
    (pallas_svdpp.py:653-682) without its TPU layout limits: those of the
    SVD++ path (cuda_svdpp.semantic_failure) and an item width of 1; plus
    the port's caps, tables of at most 8192 rows and at most 32 rows per
    unit."""
    reason = semantic_failure(hp, state, stacked, ph)
    if reason is not None:
        return reason
    width = stacked["i_idx"].shape[-1]
    if width == 2:
        return (
            "item width 2 (pairwise-rank difference rows) on stacked data needs "
            "the pairwise-rank slice (ROADMAP Queue 1 item 8)"
        )
    if width != 1:
        return (
            "multi-entry item segments (hierarchical side features) need "
            "the general train step (ROADMAP Queue 1 item 4)"
        )
    if state.w.shape[0] > MAX_TABLE_ROWS:
        return (
            f"tables over {MAX_TABLE_ROWS} rows need big-table multi-IMFB "
            "(ops/imfb.train_epoch_imfb_big): ROADMAP Queue 1 item 9"
        )
    if ph.rows_per_user > MAX_ROWS_PER_USER:
        return f"rows_per_user above {MAX_ROWS_PER_USER} (one warp per slot of a unit's block)"
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
    """R rounds of the stacked steps through csrc/fused_imfb.cu (with K2's
    flush, gather and apply from csrc/fused_svdpp.cu).

    On CUDA tensors this launches the kernels (3 per step and 2 per chunk
    start, each counted in ``train_rounds_imfb_kernel.launches``) and
    raises on anything it cannot run; there is no fallback.  Tensors on
    the CPU take the plain version, ``train_rounds_imfb_reference``."""
    if state.w.device.type == "cpu":
        return train_rounds_imfb_reference(
            state, stacked, chunk_id, fb, fb_overlap, enabled, lrs, consts, hp, ph)
    if state.w.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.w.device}")
    reason = gate_failure(hp, state, stacked, ph)
    if reason is not None:
        raise ValueError(f"kernel cannot run this configuration: {reason}")
    from ._build import load_library

    lib = load_library()
    T, GS = stacked["label"].shape
    N, k = state.w.shape
    RM = ph.rows_per_user
    R = lrs.shape[0]
    C, F = fb["fb_idx"].shape
    nseg = enabled.shape[1]
    D = stacked["ctx_slots"].shape[-1]
    dev = state.w.device
    cid = np.asarray(chunk_id)
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
    if GS % RM:
        raise ValueError(f"{GS} slots per step are not {RM} rows of whole units")
    if cid.shape != (T,) or cid.min() < 0 or cid.max() >= C:
        raise ValueError(f"chunk_id must have shape ({T},) and values in [0, {C})")
    # the context pool in K2's terms: G := nseg - 1 segments plus the pad
    G = nseg - 1
    _check_contexts(ctx, enabled, fb, T * GS, dev)
    seg, live = _check_inputs(state, planes, fb, fb_overlap, lrs, consts, G, 1, seg_key="fb_ctx")
    logs = _round_logs(lrs, consts, ph)
    # the dummy row stays exactly 0 (padding slots scatter nothing into it)
    state.w[-1] = 0.0
    state.b[-1] = 0.0
    f32 = dict(dtype=torch.float32, device=dev)
    acc = torch.zeros((N, k + 3), **f32)
    agg = torch.zeros((nseg, k + 2), **f32)
    inv = torch.zeros((nseg,), **f32)
    dacc = torch.zeros((nseg, k + 1), **f32)
    delta = torch.zeros((nseg, k + 1), **f32)
    cacc = torch.zeros((nseg, k + 4), **f32)
    p = {name: x.data_ptr() for name, x in planes.items()}
    lp = {name: x.data_ptr() for name, x in logs.items()}
    f = {name: x.data_ptr() for name, x in fb.items()}
    w, b = state.w.data_ptr(), state.b.data_ptr()
    acc_p, agg_p, inv_p, cacc_p = acc.data_ptr(), agg.data_ptr(), inv.data_ptr(), cacc.data_ptr()
    dacc_p, delta_p, seg_p, O_p = dacc.data_ptr(), delta.data_ptr(), seg.data_ptr(), fb_overlap.data_ptr()
    ctx_p, en_p = ctx.data_ptr(), enabled.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with_ub = 0 if hp.no_user_bias else 1

    def launched(name: str, err: int) -> None:
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        train_rounds_imfb_kernel.launches += 1

    def flush(c: int) -> None:
        launched("svdpp_flush", lib.svdpp_flush(
            w, b, f["fb_idx"], f["fb_val"], f["fb_ctx"], dacc_p, F, k, c, live[c], with_ub,
            stream))

    first = _is_first(cid)
    for r in range(R):
        for t in range(T):
            c = int(cid[t])
            if first[t]:
                if r or t:
                    flush(int(cid[t - 1]))  # t = 0: the previous round's last chunk
                launched("svdpp_gather", lib.svdpp_gather(
                    w, b, f["fb_idx"], f["fb_val"], seg_p, agg_p, inv_p, dacc_p, F, k, G, c,
                    with_ub, stream))
            launched("imfb_step", lib.imfb_step(
                w, b, p["u_idx"], p["u_val"], p["i_idx"], p["i_val"], p["label"], p["weight"],
                ctx_p, agg_p, lrs.data_ptr(), acc_p, cacc_p, N, k, GS, RM, D, nseg, t, r,
                hp.active_type, with_ub, hp.base_score, stream))
            launched("imfb_delta", lib.imfb_delta(
                agg_p, inv_p, en_p, lp["lr_fb"], lp["d"], lp["db"], cacc_p, dacc_p, delta_p, k,
                nseg, RM, c, r, with_ub, stream))
            launched("svdpp_apply", lib.svdpp_apply(
                w, b, acc_p, agg_p, delta_p, O_p, lp["u"], lp["i"], lp["bu"], lp["bi"],
                N, k, G, c, r, with_ub, stream))
    flush(int(cid[-1]))
    nstep = state.step + (stacked["weight"] > 0).sum().to(torch.int32) * R
    return dataclasses.replace(state, step=nstep)


train_rounds_imfb_kernel.launches = 0


def launches_per_call(chunk_id: np.ndarray, rounds: int) -> int:
    """The kernel launches of one wrapper call: R * (3T + 2 * chunk starts)."""
    return rounds * (3 * len(chunk_id) + 2 * int(_is_first(chunk_id).sum()))
