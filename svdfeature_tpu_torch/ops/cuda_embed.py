"""Multi-round batched SGD of the base solver: the Hopper kernel and its
plain PyTorch version.

Replaces the TPU kernel svdfeature_tpu/ops/pallas_embed.py::_make_kernel
(``train_rounds_pallas``), which runs the whole R x T training run as one
Pallas call with the table resident in VMEM and one-hot MXU matmuls for
gathers and scatters (Mosaic cannot gather rows).  None of that carries
over: on the H100 the table and a ``[N, k+3]`` accumulator sit in L2, and
csrc/fused_embed.cu runs a wrapper call as one persistent cooperative
launch, ``sgd_rounds``: a grid of one block per SM walks the rounds and
steps itself, half a warp per example in the accumulate phase (gather,
dot, error, atomic scatter; the global segment's sums per block in shared
memory) and a warp per touched row in the apply phase (add, decay, clear
the accumulator), with a grid-wide barrier after each, so every read of a
step precedes any write of it.  It is bound by latency (L2 round trips
and two barriers a step), not by bytes or arithmetic; see the source.

A round of the demos is 23 steps, so the wrapper's own host work counts:
the checks of the packed planes (which end in a host sync) are made once
per set of tensors and kept while the same, unmodified tensors come
again (ops/_plans.py); the decay logs are formed in the kernel; the
scratch is one kept allocation.

Semantics (per step, f32 throughout) are those of the JAX package's fused
step (ops/embed.py:393-478 with ``_update_global``):
  score = base + sum_s g[g_idx]*g_val + i_val*b[i] (+ u_val*b[u]) + p_u.p_i
  err = cal_grad(label, map_active(score)) * weight
  w[u] += lr*err*u_val*p_i ; w[i] += lr*err*i_val*p_u   (duplicates sum)
  b[i] += lr*err*i_val (; b[u] += lr*err*u_val)
  w *= exp(cu*log(1-lr*wd_u) + ci*log(1-lr*wd_i))  (cu/ci: touch counts)
  b *= exp(ci*log(1-lr*wd_ib) (+ cu*log(1-lr*wd_ub)))
  g = (g + lr*S/(1 + lr*C2)) * exp(cg*log(1-lr*wd_g))  (S: sum err*v,
      C2: sum v^2; ``exact_global`` drops the damping)
and the dummy row / slot stays exactly 0.  The TPU kernel reads the table
in bf16 by default; the port is f32 everywhere, so ``pallas_precise`` has
no counterpart.

The plain version is ops/embed.train_rounds, the general step that also
runs every configuration the kernel does not take; on the kernel's subset
it holds the kernel within atol 1e-5 + rtol 1e-4 after R=2 rounds on the
card (atomics order; pow against exp·log), chip_smoke.py phase 2.  Both
update ``state.w``, ``state.b`` and ``state.g`` in place (the JAX package
donates the state) and return the new TrainState.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import torch

from .. import losses
from ._plans import Plan, find_plan, keep_plan, kept_scratch, launch_args, plan_list
from .cuda_scatter import _entry_point, _raw_stream, check_tensors
from .embed import BIG_TABLE_ROWS, HyperParams, TrainConsts, TrainState, train_rounds

# tables above this many rows (dummy included) take the big-table route
# (ops/big_embed.py, ops/tile_sweep.py), which the base solver selects by
# itself; the cap only guards direct callers of this kernel
MAX_TABLE_ROWS = BIG_TABLE_ROWS
MAX_GLOBAL_ENTRIES = 8
MAX_GLOBAL_SLOTS = 1024
KERNEL_ACTIVE_TYPES = (
    losses.LINEAR, losses.SIGMOID_L2, losses.SIGMOID_LIKELIHOOD,
    losses.SIGMOID_RANK, losses.SIGMOID_QSGRAD,
)
# the kernel's refusals end in this: the solver routes them to the plain rounds
_PLAIN = "the general plain rounds (ops/embed.train_rounds) run it"


def gate_failure(hp: HyperParams, state: TrainState, stacked) -> Optional[str]:
    """Why K1 does not take this configuration, or None.

    The semantic conditions of ``pallas_supported`` (pallas_embed.py:47-68)
    without its TPU layout limits: eager L2, no clamps, the kernel's loss
    types, single-entry user/item segments, at most 8 global entries and
    1024 global slots; plus the table-size cap above which the solver takes
    the big-table route.  The solver sends every other small-table
    configuration to ``embed.train_rounds``, as the JAX solver sends it to
    its jnp path (solvers/base.py:546-555).
    """
    n = state.w.shape[0]
    if hp.reg_method != 0 or hp.reg_global != 0:
        return f"K1 takes eager L2 only (reg_method/reg_global 0); {_PLAIN}"
    if hp.user_nonnegative or hp.item_nonnegative:
        return f"K1 has no nonnegative clamps; {_PLAIN}"
    if hp.active_type not in KERNEL_ACTIVE_TYPES:
        return f"K1 has no active_type {hp.active_type}; {_PLAIN}"
    if stacked["u_idx"].shape[-1] != 1 or stacked["i_idx"].shape[-1] != 1:
        return f"K1 takes single-entry user/item segments; {_PLAIN}"
    if stacked["g_idx"].shape[-1] > MAX_GLOBAL_ENTRIES:
        return f"K1 takes at most {MAX_GLOBAL_ENTRIES} global entries per example; {_PLAIN}"
    if state.g.shape[0] > MAX_GLOBAL_SLOTS:
        return f"K1 takes a global table of at most {MAX_GLOBAL_SLOTS} slots; {_PLAIN}"
    if n > MAX_TABLE_ROWS:
        return (
            f"tables over {MAX_TABLE_ROWS} rows take the big-table route "
            "(ops/big_embed.train_step_big, ops/tile_sweep.train_step_sweep), "
            "which the base solver selects for them"
        )
    return None


def kernel_supported(hp: HyperParams, state: TrainState, stacked) -> bool:
    return gate_failure(hp, state, stacked) is None


def _log1m(x: torch.Tensor) -> torch.Tensor:
    # clamp at a tiny positive so lr*wd == 1 decays to exactly 0 instead
    # of giving -inf * 0 = nan for untouched rows (pallas_embed.py:310-314)
    return torch.log(torch.clamp(1.0 - x, min=1e-38))


def _check_inputs(state: TrainState, planes: Dict[str, torch.Tensor],
                  lrs: torch.Tensor, consts: TrainConsts) -> None:
    """Device, dtype, shape, contiguity and index bounds of everything
    the kernel dereferences; raises ValueError on what it does not take."""
    dev = state.w.device
    N, k = state.w.shape
    NG = state.g.shape[0]
    n = planes["label"].numel()
    want = {
        "w": (state.w, torch.float32, (N, k)),
        "b": (state.b, torch.float32, (N,)),
        "g": (state.g, torch.float32, (NG,)),
        "lrs": (lrs, torch.float32, (lrs.shape[0],)),
        "wd_u_row": (consts.wd_u_row, torch.float32, (N,)),
        "wd_i_row": (consts.wd_i_row, torch.float32, (N,)),
        "wd_g_row": (consts.wd_g_row, torch.float32, (NG,)),
    }
    for p in ("u_idx", "i_idx"):
        want[p] = (planes[p], torch.int32, (n,))
    for p in ("u_val", "i_val", "label", "weight"):
        want[p] = (planes[p], torch.float32, (n,))
    SG = planes["g_idx"].numel() // max(n, 1)
    want["g_idx"] = (planes["g_idx"], torch.int32, (n * SG,))
    want["g_val"] = (planes["g_val"], torch.float32, (n * SG,))
    check_tensors(want, dev)
    if n == 0 or k == 0 or lrs.shape[0] == 0:
        raise ValueError("empty batch, table or round schedule")
    ui = torch.cat([planes["u_idx"], planes["i_idx"]])
    bounds = torch.stack([ui.min(), ui.max()])
    if SG:
        bounds = torch.cat([bounds, torch.stack([planes["g_idx"].min(), planes["g_idx"].max()])])
    bounds = bounds.tolist()  # one host sync per plan
    if bounds[0] < 0 or bounds[1] >= N:
        raise ValueError(f"user/item index outside the {N}-row table")
    if SG and (bounds[2] < 0 or bounds[3] >= NG):
        raise ValueError(f"global index outside the {NG}-slot table")


_PLANS = plan_list()
_STATIC = ("u_idx", "u_val", "i_idx", "i_val", "label", "weight", "g_idx", "g_val")
# the order of csrc/fused_embed.cu's struct EmbedRounds
_ROUNDS_POINTERS = (
    "w", "b", "g", "acc", "gacc", "u_idx", "i_idx", "g_idx",
    "u_val", "i_val", "label", "weight", "g_val",
    "lrs", "wd_u", "wd_i", "wd_g", "wd_ub", "wd_ib", "trace",
)
_SLOT = {name: i for i, name in enumerate(_ROUNDS_POINTERS)}


def _plan(state: TrainState, stacked: Dict[str, torch.Tensor], lrs: torch.Tensor,
          consts: TrainConsts) -> Plan:
    """The checked planes of this call: from the kept plans when the very
    same tensors come again unmodified for a table of the same height and
    global width, else checked now (one host sync)."""
    tensors = [stacked[p] for p in _STATIC]
    NG = state.g.shape[0]
    key = (state.w.shape[0], NG)
    plan = find_plan(_PLANS, tensors, key)
    if plan is not None:
        return plan
    SG = stacked["g_idx"].shape[-1] if NG > 1 else 0
    planes = {
        "u_idx": stacked["u_idx"][..., 0].reshape(-1),
        "i_idx": stacked["i_idx"][..., 0].reshape(-1),
        "u_val": stacked["u_val"][..., 0].reshape(-1),
        "i_val": stacked["i_val"][..., 0].reshape(-1),
        "label": stacked["label"].reshape(-1),
        "weight": stacked["weight"].reshape(-1),
        "g_idx": stacked["g_idx"][..., :SG].reshape(-1),
        "g_val": stacked["g_val"][..., :SG].reshape(-1),
    }
    planes = {p: x.contiguous() for p, x in planes.items()}
    _check_inputs(state, planes, lrs, consts)
    ptrs = (ctypes.c_void_p * len(_ROUNDS_POINTERS))()
    for name, x in planes.items():
        ptrs[_SLOT[name]] = x.data_ptr()
    return keep_plan(_PLANS, tensors, key, (planes,), ptrs,
                     (stacked["weight"] > 0).sum().to(torch.int32))


@torch.no_grad()
def train_rounds_kernel(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    lrs: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
) -> TrainState:
    """R rounds of the stacked batches through csrc/fused_embed.cu.

    On CUDA tensors this makes one cooperative launch (counted in
    ``train_rounds_kernel.launches``; its grid is left in ``.grid``) and
    raises on anything it cannot run; there is no fallback.  Tensors on
    the CPU take the plain version, ``embed.train_rounds``.
    """
    if state.w.device.type == "cpu":
        return train_rounds(state, stacked, lrs, consts, hp)
    if state.w.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.w.device}")
    reason = gate_failure(hp, state, stacked)
    if reason is not None:
        raise ValueError(f"kernel cannot run this configuration: {reason}")
    T, B = stacked["label"].shape
    N, k = state.w.shape
    NG = state.g.shape[0]
    R = lrs.shape[0]
    dev = state.w.device
    plan = _plan(state, stacked, lrs, consts)
    # what changes from call to call (a kept plan's planes were checked)
    check_tensors({
        "w": (state.w, torch.float32, (N, k)), "b": (state.b, torch.float32, (N,)),
        "g": (state.g, torch.float32, (NG,)), "lrs": (lrs, torch.float32, (R,)),
        "wd_u_row": (consts.wd_u_row, torch.float32, (N,)),
        "wd_i_row": (consts.wd_i_row, torch.float32, (N,)),
        "wd_g_row": (consts.wd_g_row, torch.float32, (NG,)),
        "wd_user_bias": (consts.wd_user_bias, torch.float32, ()),
        "wd_item_bias": (consts.wd_item_bias, torch.float32, ()),
    }, dev)
    if k == 0 or R == 0:
        raise ValueError("empty batch, table or round schedule")
    stream = _raw_stream(dev.index)
    ptrs = plan.ptrs
    for name, ptr in kept_scratch({"acc": N * (k + 3), "gacc": NG * 3}, dev, stream).items():
        ptrs[_SLOT[name]] = ptr
    trace = train_rounds_kernel.trace
    if trace is not None:
        check_tensors({"trace": (trace, torch.int64, (4,))}, dev)
    for name, x in (("w", state.w), ("b", state.b), ("g", state.g), ("lrs", lrs),
                    ("wd_u", consts.wd_u_row), ("wd_i", consts.wd_i_row), ("wd_g", consts.wd_g_row),
                    ("wd_ub", consts.wd_user_bias), ("wd_ib", consts.wd_item_bias),
                    ("trace", trace)):
        ptrs[_SLOT[name]] = None if x is None else x.data_ptr()
    SG = stacked["g_idx"].shape[-1] if NG > 1 else 0
    scalars = (N, k, NG, SG, B, T, R, hp.active_type, 0 if hp.no_user_bias else 1,
               int(hp.exact_global), hp.base_score)
    ints, floats, grid = launch_args(plan, scalars, 10)
    err = _entry_point("sgd_rounds")(ptrs, ints, floats, ctypes.byref(grid), stream)
    if err:
        raise RuntimeError(f"sgd_rounds launch failed: CUDA error {err}")
    train_rounds_kernel.launches += 1
    train_rounds_kernel.grid = grid.value
    return TrainState(w=state.w, b=state.b, g=state.g,
                      step=torch.add(state.step, plan.n_live, alpha=R),
                      ref_ui=state.ref_ui, ref_g=state.ref_g)


train_rounds_kernel.launches = 0
train_rounds_kernel.grid = 0
# None, or an int64 [4] tensor on the device into which the kernel adds the
# nanoseconds its first block spends in each phase and at each barrier
# (csrc/fused_embed.cu, struct EmbedRounds; scripts/kernel_split.py and
# chip_smoke.py read it)
train_rounds_kernel.trace = None


def launches_per_call(rounds: int) -> int:
    """The kernel launches of one wrapper call: one cooperative launch,
    whatever the rounds and steps."""
    return 1
