"""The tile-sweep update: the Hopper kernel K4 and its plain PyTorch version.

Replaces the TPU kernel svdfeature_tpu/ops/tile_sweep.py
::_make_sweep_kernel (``sweep_update``), which walks the plan's grid
cells in tile order, lands each cell's [1024, W] payload on its [2048, W]
table tile with a one-hot MXU matmul (Mosaic has no row gather), keeps the
tile's sum in VMEM scratch and applies the regularization on the tile's
last visit.  None of that carries over: a [2048, 128] f32 tile is 1 MiB,
a block has 227 KB of shared memory, and the one-hot matmul only worked
around the missing gather.  csrc/tile_sweep.cu instead runs 16 lanes per
run of a touched row's entries (pack-time records, each with the run's
table row: ops/tile_sweep.attach_sweep_runs), forms each entry from the
step's factors ``p_u`` / ``p_i`` and coefficients (no ``[E, k+3]``
payload is built), sums them in plan order (deterministic, no atomics on
the row; a long run's pieces leave partial sums that the last-arriving
piece adds in slot order), and writes the touched row in place.  A row
of more than 256 factors goes to a kernel of its own: a warp a run, each
lane holding float4 columns across the whole row up to 512 factors, the
run's plan staged in shared memory and its entries' rows brought in by a
ring of cp.async stages (float4 adds from shared memory in both the
16-byte and the 4-byte copy forms); wider rows take passes of 512 columns
over the staged plan, so every k the augmented layout holds is taken.
Untouched rows are left alone, which is what the TPU kernel's rewrite of
them amounts to.  It is bound by bytes (the factors read once per entry,
the plan, the touched rows read and written once); a skewed batch's long
runs add chains of dependent waits (pieces, then their last piece's adds).

Entries (``cat(u_idx.ravel(), i_idx.ravel())`` order, big_embed.entry_payload):
a user entry e < B*Su of example e // Su adds dw = coef_u[e] * p_i[e // Su],
db = coef_u[e] (0 without user bias), cu = 1; an item entry adds
dw = coef_i * p_u, db = coef_i, ci = 1.  Then, per touched row with sums dw,
db, cu, ci (reg_method m, the TPU kernel's exp(c * log1m(.)) forms,
tile_sweep.py:137-140,190-271):
  m 4/5 (lazy): base = x * exp(el * log1m(lam)) | soft(x, lam * el),
      el = step - ref, lam = lr * (cu > 0 ? wd_u : wd_i); w = base + dw;
      ref = step (the int32 bits of the ref column)
  m 0: w = (x + dw) * exp(cu log1m(lr wd_u) + ci log1m(lr wd_i))
  m 1: w = soft(x + dw, lr (wd_u cu + wd_i ci))
  m 2: w = (x + dw) scaled onto the ball |w|^2 <= (cu > 0 ? wd_u : wd_i)
  m 3: w = soft(x + dw, lr wd_u cu) * exp(ci log1m(lr wd_i))
  then the nonnegative clamps (cu > 0 / ci > 0) and
  b = (b + db) * exp(ci log1m(lr wd_ib) (+ cu log1m(lr wd_ub))).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ._plans import kept_scratch
from .big_embed import entry_payload
from .cuda_embed import _log1m
from .cuda_scatter import _device, _raw_stream, check_tensors
from .embed import _soft_threshold


@torch.no_grad()
def sweep_update_reference(w: torch.Tensor, plan: Dict[str, torch.Tensor], p_u: torch.Tensor,
                           p_i: torch.Tensor, coef_u: torch.Tensor, coef_i: torch.Tensor,
                           wdu: torch.Tensor, wdi: torch.Tensor, scal: torch.Tensor,
                           stepi: torch.Tensor, hp) -> torch.Tensor:
    """The plain version of K4: what ``_make_sweep_kernel`` computes, on the
    whole (padded) table at once.  Forms the entries with torch ops
    (``big_embed.entry_payload``), gathers them in plan order, sums them
    per row with ``index_add_`` (in f64), applies the last-visit math to
    every touched row in place; returns ``w``.

    w [n_pad, W] augmented table; plan ``sw_tids`` [G], ``sw_lids`` /
    ``sw_src`` [G*e_cap] (``sw_runs`` / ``sw_pieces`` are the kernel's);
    p_u / p_i [B, k]; coef_u [B, Su], coef_i [B, Si]; wdu / wdi [n_pad];
    scal [4] f32 (lr, wd_user_bias, wd_item_bias, 0); stepi [1] i32, the
    pre-batch sample counter.
    """
    payload = entry_payload(p_u, p_i, coef_u, coef_i, hp.no_user_bias)
    return _sweep_payload(w, plan, payload, wdu, wdi, scal, stepi, hp)


def _sweep_payload(w, plan, payload, wdu, wdi, scal, stepi, hp) -> torch.Tensor:
    """The sweep of an entry payload ``[E, k+3]`` = ``[dw | db | cu | ci]``
    in the plan's order: the TPU kernel's function, in place."""
    k = hp.num_factor
    m = hp.reg_method
    C = k + 3
    lids = plan["sw_lids"].long()
    pay = torch.cat([payload, torch.zeros((1, C), dtype=payload.dtype, device=payload.device)])
    pay_plan = pay[plan["sw_src"].long()]
    rows = plan["sw_tids"].long().repeat_interleave(hp.sweep_ecap) * hp.sweep_tile + lids
    real = lids >= 0
    # a row's sum in f64, rounded to f32 once: f32 index_add_ adds in an
    # order that varies on the card, and over a popular row's 10^5 entries
    # its rounding, not the kernel's, would decide a comparison
    acc = torch.zeros((w.shape[0], C), dtype=torch.float64, device=w.device)
    acc = acc.index_add_(0, rows[real], pay_plan[real].double()).float()
    dw, db, cu, ci = acc[:, :k], acc[:, k], acc[:, k + 1], acc[:, k + 2]
    touched = (cu + ci) > 0.0
    lr, wd_ub, wd_ib = scal[0], scal[1], scal[2]
    x_w = w[:, :k]
    ref = w.view(torch.int32)[:, k + 1]

    if m >= 4:
        el = (stepi[0] - ref).to(torch.float32)
        lam = lr * torch.where(cu > 0.0, wdu, wdi)
        if m == 4:
            base = x_w * torch.exp(el * _log1m(lam))[:, None]
        else:
            base = _soft_threshold(x_w, (lam * el)[:, None])
        new_w = base + dw
    else:
        new_w = x_w + dw
        if m == 0:
            new_w = new_w * torch.exp(cu * _log1m(lr * wdu) + ci * _log1m(lr * wdi))[:, None]
        elif m == 1:
            new_w = _soft_threshold(new_w, (lr * (wdu * cu + wdi * ci))[:, None])
        elif m == 2:
            wd_row = torch.where(cu > 0.0, wdu, wdi)
            sq = torch.sum(new_w * new_w, dim=1)
            scale = torch.where(sq > wd_row, torch.sqrt(wd_row / torch.clamp(sq, min=1e-30)), 1.0)
            new_w = new_w * scale[:, None]
        elif m == 3:
            new_w = _soft_threshold(new_w, (lr * wdu * cu)[:, None])
            new_w = new_w * torch.exp(ci * _log1m(lr * wdi))[:, None]
        else:
            raise ValueError(f"unknown reg_method {m}")
    if hp.user_nonnegative:
        new_w = torch.where((cu > 0.0)[:, None], torch.clamp(new_w, min=0.0), new_w)
    if hp.item_nonnegative:
        new_w = torch.where((ci > 0.0)[:, None], torch.clamp(new_w, min=0.0), new_w)
    logb = ci * _log1m(lr * wd_ib)
    if not hp.no_user_bias:
        logb = logb + cu * _log1m(lr * wd_ub)
    new_b = (w[:, k] + db) * torch.exp(logb)

    w[:, :k] = torch.where(touched[:, None], new_w, x_w)
    w[:, k] = torch.where(touched, new_b, w[:, k])
    if m >= 4:
        ref.copy_(torch.where(touched, stepi[0], ref))
    return w


def _check(w, plan, p_u, p_i, coef_u, coef_i, wdu, wdi, scal, stepi, hp) -> None:
    """Device, dtype, shape and contiguity of everything the kernel
    dereferences; raises ValueError on what it does not take.  Plan
    indices outside their ranges fault on the device (the kernel traps)."""
    n_pad, W = w.shape
    k = hp.num_factor
    B = p_u.shape[0]
    if coef_u.dim() != 2 or coef_i.dim() != 2:
        raise ValueError("coef_u / coef_i must be [B, Su] / [B, Si]")
    want = {
        "w": (w, torch.float32, (n_pad, W)),
        "sw_src": (plan["sw_src"], torch.int32, (plan["sw_src"].shape[0],)),
        "sw_runs": (plan["sw_runs"], torch.int32, (plan["sw_runs"].shape[0], 4)),
        "sw_pieces": (plan["sw_pieces"], torch.int32, (plan["sw_pieces"].shape[0], 2)),
        "p_u": (p_u, torch.float32, (B, k)),
        "p_i": (p_i, torch.float32, (B, k)),
        "coef_u": (coef_u, torch.float32, (B, coef_u.shape[1])),
        "coef_i": (coef_i, torch.float32, (B, coef_i.shape[1])),
        "wdu": (wdu, torch.float32, (n_pad,)),
        "wdi": (wdi, torch.float32, (n_pad,)),
        "scal": (scal, torch.float32, (4,)),
        "stepi": (stepi, torch.int32, (1,)),
    }
    check_tensors(want, w.device)
    if hp.reg_method not in range(6):
        raise ValueError(f"unknown reg_method {hp.reg_method}")
    if not 0 < k <= W - 2 or W % 4:
        raise ValueError("the augmented layout requires 0 < hp.num_factor <= W - 2, W % 4 == 0")
    if n_pad % hp.sweep_tile or n_pad >= 2**31 or B * (coef_u.shape[1] + coef_i.shape[1]) >= 2**31:
        raise ValueError(f"the table must hold whole tiles of {hp.sweep_tile} rows, under 2^31")
    if w.data_ptr() % 16:
        raise ValueError("w must start on a 16-byte boundary (the kernel reads its rows as float4)")


def sweep_update(w: torch.Tensor, plan: Dict[str, torch.Tensor], p_u: torch.Tensor,
                 p_i: torch.Tensor, coef_u: torch.Tensor, coef_i: torch.Tensor,
                 wdu: torch.Tensor, wdi: torch.Tensor, scal: torch.Tensor,
                 stepi: torch.Tensor, hp) -> torch.Tensor:
    """The sweep update through csrc/tile_sweep.cu: one launch per call,
    counted in ``sweep_update.launches``; the arguments of
    ``sweep_update_reference``, which CPU tensors take instead.  Raises on
    anything the kernel does not take; there is no fallback."""
    if not _device(w):
        return sweep_update_reference(w, plan, p_u, p_i, coef_u, coef_i, wdu, wdi, scal, stepi, hp)
    _check(w, plan, p_u, p_i, coef_u, coef_i, wdu, wdi, scal, stepi, hp)
    runs, pieces = plan["sw_runs"], plan["sw_pieces"]
    n_runs, n_slots = runs.shape[0], pieces.shape[0]
    if n_runs == 0:
        return w
    k = hp.num_factor
    stream = _raw_stream(w.device.index)
    # partial sums of long runs' pieces, and their arrival counters, which
    # the kernel leaves at 0
    scratch = kept_scratch({"part": n_slots * (64 * -(-k // 64) + 4), "count": n_slots},
                           w.device, stream)
    vec = k % 4 == 0 and p_u.data_ptr() % 16 == 0 and p_i.data_ptr() % 16 == 0
    ptrs = (ctypes.c_void_p * 14)(
        w.data_ptr(), runs.data_ptr(), pieces.data_ptr(), plan["sw_src"].data_ptr(),
        p_u.data_ptr(), p_i.data_ptr(), coef_u.data_ptr(), coef_i.data_ptr(), wdu.data_ptr(),
        wdi.data_ptr(), scal.data_ptr(), stepi.data_ptr(), scratch["part"], scratch["count"])
    ints = (ctypes.c_int * 14)(
        n_runs, n_slots, plan["sw_src"].shape[0], p_u.shape[0], coef_u.shape[1],
        coef_i.shape[1], w.shape[0], w.shape[1], k, hp.reg_method, int(hp.user_nonnegative),
        int(hp.item_nonnegative), 0 if hp.no_user_bias else 1, int(vec))
    from ._build import load_library

    err = load_library().sweep_apply(ptrs, ints, stream)
    if err:
        raise RuntimeError(f"sweep_apply launch failed: CUDA error {err}")
    sweep_update.launches += 1
    return w


sweep_update.launches = 0
