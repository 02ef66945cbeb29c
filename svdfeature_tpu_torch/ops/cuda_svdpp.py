"""Multi-round SVD++ (user-group) training: the Hopper kernel and its
plain PyTorch version.

Replaces the TPU kernel svdfeature_tpu/ops/pallas_svdpp.py::_make_kernel
with D=0 (``train_rounds_svdpp_pallas``), which runs the whole R x T run
as one Pallas call with the table in VMEM, one-hot MXU matmuls for every
gather and scatter and a slot->user selector matrix for the per-user sums
(Mosaic cannot gather rows).  None of that carries over: on the H100 the
table, the pools and the overlap matrices sit in L2, and
csrc/fused_svdpp.cu runs a wrapper call as one persistent cooperative
launch, ``svdpp_rounds``: a grid of one block per SM walks the rounds, the
steps and the chunk starts itself and puts a grid-wide barrier where a
dependency stands (flush -> gather -> step -> apply -> next step), so every
read of a step precedes any write of it.  The chunk ids, the chunk-start
flags and the live pool entries of each chunk go to the device once per
call as int32 planes.  It is bound by latency (L2 round trips and two
barriers a step); see the source.

A round of the band setting is about 1.5 ms on the card, so the wrapper's
own host work counts: the checks of the packed planes and the pool (which
end in a host sync) are made once per set of tensors and kept while the
same, unmodified tensors come again, as they do round after round; the
decay logs are formed in the kernel; the scratch is one allocation.

Semantics (f32 throughout) are those of ops/svdpp.train_epoch_plus per
round; the TPU kernel reads tables and payloads in bf16, so the port is
held to the f32 path.  As in the TPU kernel (pallas_svdpp.py:488-497,
``round_spec``), the user and item planes may carry one epoch per round,
leading dim R*T instead of T (pairwise-rank epochs sampled afresh every
round, solvers/svdpp.py); round r then reads rows [r*T, (r+1)*T) of them,
while labels, weights, the chunk ids, the pools and the overlaps are the
epoch's.  Both versions update ``state.w`` / ``state.b`` in
place and return the new TrainState.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ._plans import MAX_PLANS, Plan, find_plan, keep_plan, kept_scratch, launch_args, plan_list
from .cuda_embed import KERNEL_ACTIVE_TYPES, MAX_TABLE_ROWS
from .cuda_scatter import _raw_stream, check_tensors
from .embed import HyperParams, TrainConsts, TrainState
from .svdpp import PlusHyper, _is_first, train_epoch_plus

# the step runs one warp per slot of a user in one block
MAX_ROWS_PER_USER = 32
# its shared memory, M * (k + 3) floats, stays under the default cap
MAX_STEP_SMEM_BYTES = 48 * 1024
# the kernels' own refusals end in this: the solvers route them to the
# plain rounds
_PLAIN = "the plain rounds run it"


def shared_space_failure(ph: PlusHyper, epoch: str) -> Optional[str]:
    """K2's and K3's refusal of a feedback space shared with the user rows
    (common_feedback_space=1), naming the per-batch refresh ``epoch`` that
    runs it, at any table size: their chunk closed form needs pool rows
    that no step writes (pallas_svdpp.py:80-107 refuses it too)."""
    if ph.off_user <= 0:
        return ("a feedback space shared with the user rows (common_feedback_space=1) aliases "
                "the pool rows that the kernel's chunk closed form keeps apart; the per-batch "
                f"refresh epoch {epoch} runs it")
    return None


def big_table_failure(hp: HyperParams, state: TrainState, epoch: str) -> Optional[str]:
    """K2's and K3's refusal of a big table, naming the big-table ``epoch``
    that runs it: neither kernel takes the augmented layout, whose solver
    route goes before their gates."""
    if hp.big_table or state.w.shape[0] > MAX_TABLE_ROWS:
        return (f"tables over {MAX_TABLE_ROWS} rows take the augmented big-table layout, which "
                f"the kernel does not take; the big-table epoch {epoch} runs them")
    return None


def kernel_failure(hp: HyperParams, state: TrainState, stacked) -> Optional[str]:
    """The semantic conditions of ``pallas_svdpp_supported``
    (pallas_svdpp.py:80-107) that K2 and K3 share, other than the item
    width: why they do not take this configuration, or None.  The solvers
    send it to the plain rounds instead, as the JAX solver sends it to its
    jnp path."""
    if hp.reg_method != 0 or hp.reg_global != 0:
        return f"the kernels take eager L2 only (reg_method/reg_global 0); {_PLAIN}"
    if hp.user_nonnegative or hp.item_nonnegative:
        return f"the kernels have no nonnegative clamps; {_PLAIN}"
    if hp.active_type not in KERNEL_ACTIVE_TYPES:
        return f"the kernels have no active_type {hp.active_type}; {_PLAIN}"
    if stacked["u_idx"].shape[-1] != 1:
        return f"the kernels take single-entry user segments; {_PLAIN}"
    if stacked["g_idx"].shape[-1] != 1 or state.g.shape[0] != 1:
        return f"the kernels take no global features on the user-group path; {_PLAIN}"
    return None


def gate_failure(
    hp: HyperParams, state: TrainState, stacked, fb, ph: PlusHyper
) -> Optional[str]:
    """Why K2 does not take this configuration, or None.

    ``shared_space_failure``, ``big_table_failure``, ``kernel_failure``, item width 1 or 2
    (pairwise-rank difference rows), at most 32 rows per user, and the
    step's shared memory."""
    n, k = state.w.shape
    M = ph.rows_per_user
    reason = (shared_space_failure(ph, "ops/svdpp.train_epoch_plus_refresh")
              or big_table_failure(hp, state, "ops/svdpp_big.train_epoch_plus_big")
              or kernel_failure(hp, state, stacked))
    if reason is not None:
        return reason
    if stacked["i_idx"].shape[-1] not in (1, 2):
        return f"K2 takes item segments of at most 2 entries; {_PLAIN}"
    if M > MAX_ROWS_PER_USER:
        return (f"K2 takes no rows_per_user above {MAX_ROWS_PER_USER} (one warp per slot of "
                f"a user's block); {_PLAIN}")
    if 4 * M * (k + 3) > MAX_STEP_SMEM_BYTES:
        return (
            f"rows_per_user={M} with num_factor={k} needs more than "
            f"{MAX_STEP_SMEM_BYTES} bytes of K2's shared memory per user block; {_PLAIN}"
        )
    return None


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
    ops/svdpp.train_epoch_plus, round r at lr ``lrs[r]`` on round r's
    user and item planes where they are per-round."""
    R = lrs.shape[0]
    plane_rounds(stacked, R)
    for r in range(R):
        state = train_epoch_plus(state, round_planes(stacked, r), chunk_id, fb, fb_overlap,
                                 lrs[r], consts, hp, ph)
    return state


ROUND_PLANES = ("u_idx", "u_val", "i_idx", "i_val")


def plane_rounds(stacked: Dict[str, torch.Tensor], R: int) -> int:
    """The rounds the user and item planes hold: 1 (``[T, ...]``, every
    round trains the same epoch) or R (``[R*T, ...]``); raises on another
    shape."""
    T = stacked["label"].shape[0]
    n = {stacked[p].shape[0] for p in ROUND_PLANES}
    if n == {T}:
        return 1
    if n == {R * T}:
        return R
    raise ValueError(f"user/item planes of leading dims {sorted(n)}: expected {T} or "
                     f"{R} rounds x {T} steps")


def round_planes(stacked: Dict[str, torch.Tensor], r: int) -> Dict[str, torch.Tensor]:
    """Round r's epoch of ``stacked``: its slice of per-round user and item
    planes, the epoch's other planes."""
    T = stacked["label"].shape[0]
    if stacked["u_idx"].shape[0] == T:
        return stacked
    return dict(stacked, **{p: stacked[p][r * T:(r + 1) * T] for p in ROUND_PLANES})


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
    UR: int = 1,
) -> Tuple[torch.Tensor, List[int]]:
    """Device, dtype, shape, contiguity and index bounds of everything the
    kernel dereferences; raises ValueError on what it does not take.
    ``UR`` is the rounds the user and item planes hold (1, or R).

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
        "u_idx": (planes["u_idx"], torch.int32, (UR * n,)),
        "u_val": (planes["u_val"], torch.float32, (UR * n,)),
        "i_idx": (planes["i_idx"], torch.int32, (UR * n * SI,)),
        "i_val": (planes["i_val"], torch.float32, (UR * n * SI,)),
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


def device_schedule(
    chunk_id: np.ndarray, seg: torch.Tensor, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The planes from which the kernel walks a round by itself, int32 on
    ``device``: ``cid [T]`` (each step's chunk), ``first [T]`` (1 where a
    step starts a chunk: flush the previous chunk, gather this one) and
    ``live [C]`` (each chunk's live pool entries, ``seg[:, G]``, which the
    flush covers).  No host sync."""
    cid = np.ascontiguousarray(chunk_id, dtype=np.int32)
    first = _is_first(cid).astype(np.int32)
    return (torch.from_numpy(cid).to(device), torch.from_numpy(first).to(device),
            seg[:, -1].contiguous())


_PLANS = plan_list()
_MAX_PLANS = MAX_PLANS
_STATIC = ("u_idx", "u_val", "i_idx", "i_val", "label", "weight")
_POOL = ("fb_idx", "fb_val", "fb_block")
# the order of csrc/fused_svdpp.cu's struct Rounds
_ROUNDS_POINTERS = (
    "w", "b", "acc", "agg", "inv", "dacc", "delta",
    "u_idx", "i_idx", "fb_idx", "fb_block", "seg", "cid", "first", "live",
    "u_val", "i_val", "label", "weight", "fb_val", "O",
    "lrs", "wd_u", "wd_i", "wd_ub", "wd_ib", "trace",
)
_SLOT = {name: i for i, name in enumerate(_ROUNDS_POINTERS)}


def _plan(state, stacked, chunk_id, fb, fb_overlap, lrs, consts, M: int) -> Plan:
    """The checked planes of this call: from the cache when the very same
    tensors come again unmodified, else checked now (one host sync).
    Fresh per-round planes (a pair epoch sampled each round) are new
    tensors, so each is checked once: the check guards the index bounds."""
    tensors = (*[stacked[p] for p in _STATIC], *[fb[p] for p in _POOL], fb_overlap)
    cid = np.asarray(chunk_id)
    UR = plane_rounds(stacked, lrs.shape[0])
    key = (state.w.shape[0], M, UR, cid.tobytes())
    plan = find_plan(_PLANS, tensors, key)
    if plan is not None:
        return plan
    T, GS = stacked["label"].shape
    C = fb["fb_idx"].shape[0]
    SI = stacked["i_idx"].shape[-1]
    if GS % M:
        raise ValueError(f"{GS} slots per step are not {M} rows of whole users")
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
    seg, _ = _check_inputs(state, planes, fb, fb_overlap, lrs, consts, GS // M, SI, UR=UR)
    sched = device_schedule(cid, seg, state.w.device)
    ptrs = (ctypes.c_void_p * len(_ROUNDS_POINTERS))()
    for name, x in planes.items():
        ptrs[_SLOT[name]] = x.data_ptr()
    for name in _POOL:
        ptrs[_SLOT[name]] = fb[name].data_ptr()
    for name, x in zip(("O", "seg", "cid", "first", "live"), (fb_overlap, seg, *sched)):
        ptrs[_SLOT[name]] = x.data_ptr()
    return keep_plan(_PLANS, tensors, key, (planes, seg, sched), ptrs,
                     (stacked["weight"] > 0).sum().to(torch.int32))


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

    On CUDA tensors this makes one cooperative launch (counted in
    ``train_rounds_svdpp_kernel.launches``; its grid is left in ``.grid``)
    and raises on anything it cannot run; there is no fallback.  Tensors
    on the CPU take the plain version, ``train_rounds_svdpp_reference``.
    The card's path is traced as the span ``k2``: ``k2.prepare`` (the gate,
    the plan, the checks, the scratch and the arguments) then ``k2.launch``
    (the launch and the step counter's add)."""
    if state.w.device.type == "cpu":
        return train_rounds_svdpp_reference(
            state, stacked, chunk_id, fb, fb_overlap, lrs, consts, hp, ph)
    if state.w.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.w.device}")
    if tracing.on:
        tracing.begin("k2")
        tracing.begin("k2.prepare")
    reason = gate_failure(hp, state, stacked, fb, ph)
    if reason is not None:
        raise ValueError(f"kernel cannot run this configuration: {reason}")
    from ._build import load_library

    lib = load_library()
    T, GS = stacked["label"].shape
    N, k = state.w.shape
    M = ph.rows_per_user
    R = lrs.shape[0]
    dev = state.w.device
    plan = _plan(state, stacked, chunk_id, fb, fb_overlap, lrs, consts, M)
    G = GS // M
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
    scratch = kept_scratch({"acc": N * (k + 3), "agg": (G + 1) * (k + 2), "inv": G + 1,
                            "dacc": (G + 1) * (k + 1), "delta": (G + 1) * (k + 1)}, dev, stream)
    for name, ptr in scratch.items():
        ptrs[_SLOT[name]] = ptr
    trace = train_rounds_svdpp_kernel.trace
    if trace is not None:
        check_tensors({"trace": (trace, torch.int64, (9,))}, dev)
    for name, x in (("w", state.w), ("b", state.b), ("lrs", lrs), ("wd_u", consts.wd_u_row),
                    ("wd_i", consts.wd_i_row), ("wd_ub", consts.wd_user_bias),
                    ("wd_ib", consts.wd_item_bias), ("trace", trace)):
        ptrs[_SLOT[name]] = None if x is None else x.data_ptr()
    scalars = (N, k, G, M, stacked["i_idx"].shape[-1], T, R, fb["fb_idx"].shape[1],
               hp.active_type, 0 if hp.no_user_bias else 1, plane_rounds(stacked, R),
               hp.base_score, ph.scale_lr_ufeedback, ph.wd_ufeedback, ph.wd_ufeedback_bias)
    ints, floats, grid = launch_args(plan, scalars, 11)
    if tracing.on:
        tracing.then("k2.launch")
    err = lib.svdpp_rounds(ptrs, ints, floats, ctypes.byref(grid), stream)
    if err:
        raise RuntimeError(f"svdpp_rounds launch failed: CUDA error {err}")
    train_rounds_svdpp_kernel.launches += 1
    train_rounds_svdpp_kernel.grid = grid.value
    state = dataclasses.replace(state, step=torch.add(state.step, plan.n_live, alpha=R))
    if tracing.on:
        tracing.end()
        tracing.end()
    return state


train_rounds_svdpp_kernel.launches = 0
train_rounds_svdpp_kernel.grid = 0
# None, or an int64 [9] tensor on the device into which the kernel adds the
# nanoseconds its first block spends in each phase, at each barrier and in
# the product (csrc/fused_svdpp.cu, struct Rounds; scripts/kernel_split.py
# reads it)
train_rounds_svdpp_kernel.trace = None


def launches_per_call(chunk_id: np.ndarray, rounds: int) -> int:
    """The kernel launches of one wrapper call: one cooperative launch,
    whatever the rounds, steps and chunk starts."""
    return 1
