"""numpy -> port containers, on an explicit device.

The trainer builds its state, decay tables and staged batches through
these, and the tests hand the same numpy arrays to the JAX package's
``TrainState`` / ``TrainConsts`` / stacked batches and to the port's, so
both compute the same thing.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .ops.big_embed import aug_width, ref_column
from .ops.embed import TrainConsts, TrainState


def _f32(x, device: torch.device) -> torch.Tensor:
    # a fresh copy: the state is updated in place, the input stays as it was
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def _i32(x, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.int32)).to(device)


def state_from_numpy(w, b, g, step, ref_ui, ref_g, device: torch.device) -> TrainState:
    """TrainState from dummy-padded ``w [N+1,k]``, ``b [N+1]``, ``g [G+1]``,
    the sample counter and the lazy-decay refs."""
    return TrainState(
        w=_f32(w, device),
        b=_f32(b, device),
        g=_f32(g, device),
        step=_i32(step, device).reshape(()),
        ref_ui=_i32(ref_ui, device),
        ref_g=_i32(ref_g, device),
    )


def consts_from_numpy(
    wd_u_row, wd_i_row, wd_g_row, wd_user_bias, wd_item_bias, device: torch.device
) -> TrainConsts:
    return TrainConsts(
        wd_u_row=_f32(wd_u_row, device),
        wd_i_row=_f32(wd_i_row, device),
        wd_g_row=_f32(wd_g_row, device),
        wd_user_bias=_f32(wd_user_bias, device).reshape(()),
        wd_item_bias=_f32(wd_item_bias, device).reshape(()),
    )


_INT_PLANES = ("ctx_slots", "i_order", "i_si", "i_fpos")


def stacked_from_numpy(
    arrays: Dict[str, np.ndarray], device: torch.device
) -> Dict[str, torch.Tensor]:
    """Stage ``PackedBatches.arrays()`` (``[T, B(, S)]`` planes: int32
    indices, sweep plans, context ids ``ctx_slots`` and the item entries'
    sorted-dedup layout ``i_order`` / ``i_si`` / ``i_fpos``; f32 values;
    the layout's run ends ``i_last`` as bool) on ``device``."""
    def stage(name, a):
        if name == "i_last":
            return torch.from_numpy(np.array(a, bool)).to(device)
        if name.endswith("_idx") or name.startswith("sw_") or name in _INT_PLANES:
            return _i32(a, device)
        return _f32(a, device)

    return {name: stage(name, a) for name, a in arrays.items()}


def augmented_from_numpy(aug, k: int, device: torch.device) -> torch.Tensor:
    """The port's augmented big-route table from any augmented numpy table
    ``[N, >= k+2]`` rows ``[factors | bias | ref_bits | ...]``, the JAX
    package's 128-lane one included: factors and bias as floats, the ref
    column as its int32 bits, exactly."""
    aug = np.asarray(aug, np.float32)
    out = torch.zeros((aug.shape[0], aug_width(k)), dtype=torch.float32)
    out[:, : k + 1] = torch.from_numpy(np.ascontiguousarray(aug[:, : k + 1]))
    ref_column(out, k)[:] = torch.from_numpy(np.ascontiguousarray(aug[:, k + 1]).view(np.int32))
    return out.to(device)


def augmented_to_numpy(aug: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(w [N, k], b [N], ref_ui [N] int32)`` of an augmented table, the
    ref counters bit for bit."""
    a = aug.detach().cpu()
    return (a[:, :k].numpy().copy(), a[:, k].numpy().copy(), ref_column(a, k).numpy().copy())


def pool_from_numpy(fb: Dict[str, np.ndarray], fb_overlap, device: torch.device):
    """Stage the feedback pools of ``PackedPlusBatches`` or
    ``PackedImfbBatches`` (``fb_arrays()``: ``fb_idx`` / ``fb_val`` and
    ``fb_block`` or ``fb_ctx`` ``[C, F]``, with ``ctx_depth [C, M]``; the
    user-carry plan ``chunk_users [C, G]``) and the overlap on ``device``:
    f32 values, everything else (rows, users, contexts, depths) int32.
    The overlap (a host one: the trainers build theirs on the device,
    ops/fb_overlap.py) is the dense ``fb_overlap [C, S, S]``, the factored
    ``{"diag": [C, S], "dup": [C, S, Ld]}`` (staged as a dict of f32
    tensors), or None (none staged).  Returns (pool, overlap)."""
    pool = {name: (_f32 if name == "fb_val" else _i32)(a, device) for name, a in fb.items()}
    if fb_overlap is None:
        return pool, None
    if isinstance(fb_overlap, dict):
        return pool, {name: _f32(a, device) for name, a in fb_overlap.items()}
    return pool, _f32(fb_overlap, device)


def gate_from_numpy(enabled: np.ndarray, device: torch.device) -> torch.Tensor:
    """Stage the multi-IMFB update gate ``enabled [C, nseg]`` (1.0 where a
    chunk's local context trains, 0.0 for disabled depths, unused slots
    and the pad context) on ``device`` as f32."""
    return _f32(enabled, device)


def bilinear_from_numpy(W_bi, up, device: torch.device):
    """Stage the bilinear solver's arrays on ``device`` as f32: ``W_bi
    [num_item, nbf]`` with one zero dummy row appended (the port's
    ``W_bi_pad``, ops/svdpp_bilinear.py) and the per-slot user properties
    ``up [C, G+1, nbf]``; either may be None (none staged).  Returns
    (W_bi_pad, up)."""
    W_pad = None
    if W_bi is not None:
        W = np.asarray(W_bi, np.float32)
        W_pad = _f32(np.concatenate([W, np.zeros((1, W.shape[1]), np.float32)]), device)
    return W_pad, None if up is None else _f32(up, device)
