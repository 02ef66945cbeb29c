"""Multi-round SVD++ (user-group) training: the Hopper kernel and its
plain PyTorch version.

Replaces the TPU kernel svdfeature_tpu/ops/pallas_svdpp.py::_make_kernel
with D=0 (``train_rounds_svdpp_pallas``), which runs the whole R x T run
as one Pallas call with the table in VMEM, one-hot MXU matmuls for every
gather and scatter and a slot->user selector matrix for the per-user sums
(Mosaic cannot gather rows).  None of that carries over: on the H100 the
table, the pools and the overlap matrices sit in L2, and
csrc/fused_svdpp.cu runs each chunk boundary as two launches
(``svdpp_flush``, ``svdpp_gather``) and each step as two (``svdpp_step``:
one block per user, one warp per slot; ``svdpp_apply``: the row apply plus
``agg += O @ delta``), issued on PyTorch's current stream by a host loop
whose chunk starts are known from the host-side ``chunk_id``.  It is
bound by the f32 arithmetic of that O @ delta product; see the source.

Semantics (f32 throughout) are those of ops/svdpp.train_epoch_plus per
round; the TPU kernel reads tables and payloads in bf16, so the port is
held to the f32 path.  Both versions update ``state.w`` / ``state.b`` in
place and return the new TrainState.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .cuda_embed import KERNEL_ACTIVE_TYPES, MAX_TABLE_ROWS, _decay_logs, _log1m
from .embed import HyperParams, TrainConsts, TrainState
from .svdpp import PlusHyper, _is_first, train_epoch_plus

# the step launch runs one warp per slot of a user in one block
MAX_ROWS_PER_USER = 32
# its dynamic shared memory, M * (k + 3) floats, stays under the default cap
MAX_STEP_SMEM_BYTES = 48 * 1024
_GENERAL_STEP = "the general train step (ROADMAP Queue 1 item 4)"


def semantic_failure(hp: HyperParams, state: TrainState, stacked, ph: PlusHyper) -> Optional[str]:
    """The conditions of ``pallas_svdpp_supported`` (pallas_svdpp.py:80-107)
    that are semantic, not TPU layout limits, other than the item width:
    why the user-group kernels (K2, and K3 in ops/cuda_imfb.py) cannot run
    this configuration, or None."""
    if ph.off_user <= 0:
        return (
            "a feedback space shared with the user rows (common_feedback_space=1) "
            "needs the per-batch refresh path (ROADMAP Queue 1 item 7b)"
        )
    if hp.reg_method != 0 or hp.reg_global != 0:
        return f"reg_method/reg_global other than 0 (eager L2) need {_GENERAL_STEP}"
    if hp.user_nonnegative or hp.item_nonnegative:
        return f"nonnegative factors need {_GENERAL_STEP}"
    if hp.active_type not in KERNEL_ACTIVE_TYPES:
        return f"active_type {hp.active_type} needs {_GENERAL_STEP}"
    if stacked["u_idx"].shape[-1] != 1:
        return f"multi-entry user segments (hierarchical side features) need {_GENERAL_STEP}"
    if stacked["g_idx"].shape[-1] != 1 or state.g.shape[0] != 1:
        return f"global features on the user-group path need {_GENERAL_STEP}"
    return None


def gate_failure(
    hp: HyperParams, state: TrainState, stacked, fb, ph: PlusHyper
) -> Optional[str]:
    """Why the SVD++ path cannot run this configuration, or None.

    ``semantic_failure``, item width 1 or 2 (pairwise-rank difference
    rows), plus the port's caps: tables of at most 8192 rows, at most 32
    rows per user, and the step's shared memory."""
    n, k = state.w.shape
    M = ph.rows_per_user
    reason = semantic_failure(hp, state, stacked, ph)
    if reason is not None:
        return reason
    if stacked["i_idx"].shape[-1] not in (1, 2):
        return (
            "item segments of more than 2 entries (hierarchical side features) "
            f"need {_GENERAL_STEP}"
        )
    if n > MAX_TABLE_ROWS:
        return (
            f"tables over {MAX_TABLE_ROWS} rows need big-table SVD++ "
            "(ops/svdpp_big.py, the user-carry epoch): the next slice of "
            "ROADMAP Queue 1 item 9"
        )
    if M > MAX_ROWS_PER_USER:
        return f"rows_per_user above {MAX_ROWS_PER_USER} (one warp per slot of a user's block)"
    if 4 * M * (k + 3) > MAX_STEP_SMEM_BYTES:
        return (
            f"rows_per_user={M} with num_factor={k} needs more than "
            f"{MAX_STEP_SMEM_BYTES} bytes of shared memory per user block"
        )
    return None


def _round_logs(lrs: torch.Tensor, consts: TrainConsts, ph: PlusHyper) -> Dict[str, torch.Tensor]:
    """Per-round tables of the kernel: the row/bias decay logs of
    cuda_embed plus lr_fb = lr * scale_lr_ufeedback and log(d), log(db) of
    the feedback decay d = 1 - lr_fb * wd_ufeedback (bias: wd_ufeedback_bias)."""
    logs = _decay_logs(lrs, consts)
    lr_fb = (lrs * ph.scale_lr_ufeedback).contiguous()
    logs["lr_fb"] = lr_fb
    logs["d"] = _log1m(lr_fb * ph.wd_ufeedback).contiguous()
    logs["db"] = _log1m(lr_fb * ph.wd_ufeedback_bias).contiguous()
    return logs


@torch.no_grad()
def train_rounds_svdpp_reference(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    fb_overlap: torch.Tensor,
    lrs: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
) -> TrainState:
    """The plain version of the kernel: R rounds of
    ops/svdpp.train_epoch_plus, round r at lr ``lrs[r]``."""
    for r in range(lrs.shape[0]):
        state = train_epoch_plus(state, stacked, chunk_id, fb, fb_overlap, lrs[r], consts, hp, ph)
    return state


def _check_inputs(
    state: TrainState,
    planes: Dict[str, torch.Tensor],
    fb: Dict[str, torch.Tensor],
    fb_overlap: torch.Tensor,
    lrs: torch.Tensor,
    consts: TrainConsts,
    G: int,
    SI: int,
    seg_key: str = "fb_block",
) -> Tuple[torch.Tensor, List[int]]:
    """Device, dtype, shape, contiguity and index bounds of everything the
    kernel dereferences; raises ValueError on what it does not take.

    Returns the segment starts of each user in each chunk's pool, ``seg
    [C, G+1]`` (user g owns entries [seg[c, g], seg[c, g+1]); a user's
    entries are contiguous, data/batching_plus.py), and the live entries
    of each chunk, ``seg[:, G]``, on the host (one host sync per call).
    ``seg_key`` names the pool's segment plane: ``fb_block`` (users) or,
    for K3, ``fb_ctx`` (local contexts, G of them plus the pad)."""
    dev = state.w.device
    N, k = state.w.shape
    C, F = fb["fb_idx"].shape
    n = planes["label"].numel()
    want = {
        "w": (state.w, torch.float32, (N, k)),
        "b": (state.b, torch.float32, (N,)),
        "lrs": (lrs, torch.float32, (lrs.shape[0],)),
        "wd_u_row": (consts.wd_u_row, torch.float32, (N,)),
        "wd_i_row": (consts.wd_i_row, torch.float32, (N,)),
        "fb_idx": (fb["fb_idx"], torch.int32, (C, F)),
        "fb_val": (fb["fb_val"], torch.float32, (C, F)),
        seg_key: (fb[seg_key], torch.int32, (C, F)),
        "fb_overlap": (fb_overlap, torch.float32, (C, G + 1, G + 1)),
        "u_idx": (planes["u_idx"], torch.int32, (n,)),
        "u_val": (planes["u_val"], torch.float32, (n,)),
        "i_idx": (planes["i_idx"], torch.int32, (n * SI,)),
        "i_val": (planes["i_val"], torch.float32, (n * SI,)),
        "label": (planes["label"], torch.float32, (n,)),
        "weight": (planes["weight"], torch.float32, (n,)),
    }
    for name, (x, dtype, shape) in want.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the table on {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, the kernel takes {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if n == 0 or k == 0 or lrs.shape[0] == 0:
        raise ValueError("empty batch, table or round schedule")
    blk = fb[seg_key]
    users = torch.arange(G + 1, dtype=torch.int32, device=dev).expand(C, G + 1).contiguous()
    seg = torch.searchsorted(blk, users).to(torch.int32).contiguous()
    ui = torch.cat([planes["u_idx"], planes["i_idx"], fb["fb_idx"].reshape(-1)])
    ordered = (blk[:, 1:] >= blk[:, :-1]).all()
    stats = torch.stack([ui.min(), ui.max(), blk.min(), blk.max(), ordered.to(torch.int32)])
    got = torch.cat([stats.to(torch.int64), seg[:, G].to(torch.int64)]).tolist()  # one host sync
    if got[0] < 0 or got[1] >= N:
        raise ValueError(f"user/item/pool index outside the {N}-row table")
    if got[2] < 0 or got[3] > G:
        raise ValueError(f"{seg_key} outside [0, {G}]")
    if not got[4]:
        owner = "user" if seg_key == "fb_block" else "context"
        raise ValueError(f"a chunk's pool entries are not grouped by {owner} ({seg_key} not ascending)")
    return seg, got[5:]


@torch.no_grad()
def train_rounds_svdpp_kernel(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    chunk_id: np.ndarray,
    fb: Dict[str, torch.Tensor],
    fb_overlap: torch.Tensor,
    lrs: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
    ph: PlusHyper,
) -> TrainState:
    """R rounds of the user-group steps through csrc/fused_svdpp.cu.

    On CUDA tensors this launches the kernels (2 per step and 2 per chunk
    start, each counted in ``train_rounds_svdpp_kernel.launches``) and
    raises on anything it cannot run; there is no fallback.  Tensors on
    the CPU take the plain version, ``train_rounds_svdpp_reference``."""
    if state.w.device.type == "cpu":
        return train_rounds_svdpp_reference(
            state, stacked, chunk_id, fb, fb_overlap, lrs, consts, hp, ph)
    if state.w.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.w.device}")
    reason = gate_failure(hp, state, stacked, fb, ph)
    if reason is not None:
        raise ValueError(f"kernel cannot run this configuration: {reason}")
    from ._build import load_library

    lib = load_library()
    T, GS = stacked["label"].shape
    N, k = state.w.shape
    M = ph.rows_per_user
    G = GS // M
    R = lrs.shape[0]
    SI = stacked["i_idx"].shape[-1]
    C, F = fb["fb_idx"].shape
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
    if GS % M:
        raise ValueError(f"{GS} slots per step are not {M} rows of whole users")
    if cid.shape != (T,) or cid.min() < 0 or cid.max() >= C:
        raise ValueError(f"chunk_id must have shape ({T},) and values in [0, {C})")
    seg, live = _check_inputs(state, planes, fb, fb_overlap, lrs, consts, G, SI)
    logs = _round_logs(lrs, consts, ph)
    # the dummy row stays exactly 0 (padding slots scatter nothing into it)
    state.w[-1] = 0.0
    state.b[-1] = 0.0
    acc = torch.zeros((N, k + 3), dtype=torch.float32, device=dev)
    agg = torch.zeros((G + 1, k + 2), dtype=torch.float32, device=dev)
    inv = torch.zeros((G + 1,), dtype=torch.float32, device=dev)
    dacc = torch.zeros((G + 1, k + 1), dtype=torch.float32, device=dev)
    delta = torch.zeros((G + 1, k + 1), dtype=torch.float32, device=dev)
    p = {name: x.data_ptr() for name, x in planes.items()}
    lp = {name: x.data_ptr() for name, x in logs.items()}
    f = {name: x.data_ptr() for name, x in fb.items()}
    w, b = state.w.data_ptr(), state.b.data_ptr()
    acc_p, agg_p, inv_p = acc.data_ptr(), agg.data_ptr(), inv.data_ptr()
    dacc_p, delta_p, seg_p, O_p = dacc.data_ptr(), delta.data_ptr(), seg.data_ptr(), fb_overlap.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with_ub = 0 if hp.no_user_bias else 1

    def launched(name: str, err: int) -> None:
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        train_rounds_svdpp_kernel.launches += 1

    def flush(c: int) -> None:
        launched("svdpp_flush", lib.svdpp_flush(
            w, b, f["fb_idx"], f["fb_val"], f["fb_block"], dacc_p, F, k, c, live[c], with_ub,
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
            launched("svdpp_step", lib.svdpp_step(
                w, b, p["u_idx"], p["u_val"], p["i_idx"], p["i_val"], p["label"],
                p["weight"], agg_p, inv_p, lrs.data_ptr(), lp["lr_fb"], lp["d"], lp["db"],
                acc_p, dacc_p, delta_p, N, k, G, M, SI, t, r, hp.active_type, with_ub,
                hp.base_score, stream))
            launched("svdpp_apply", lib.svdpp_apply(
                w, b, acc_p, agg_p, delta_p, O_p, lp["u"], lp["i"], lp["bu"], lp["bi"],
                N, k, G, c, r, with_ub, stream))
    flush(int(cid[-1]))
    nstep = state.step + (stacked["weight"] > 0).sum().to(torch.int32) * R
    return dataclasses.replace(state, step=nstep)


train_rounds_svdpp_kernel.launches = 0


def launches_per_call(chunk_id: np.ndarray, rounds: int) -> int:
    """The kernel launches of one wrapper call: R * (2T + 2 * chunk starts)."""
    return rounds * (2 * len(chunk_id) + 2 * int(_is_first(chunk_id).sum()))
