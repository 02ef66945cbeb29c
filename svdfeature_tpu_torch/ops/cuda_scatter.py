"""Indexed row copies of the big-table route: the Hopper kernels K5 (row
writer) and K6 (row reader), with their plain PyTorch versions.

Replace the TPU kernels svdfeature_tpu/ops/pallas_scatter.py
``row_writer`` (``_writer_kernel``: ``w[idx[j]] = vals[j]`` in place) and
``row_reader`` (``_reader_kernel``: ``out[j] = w[idx[j]]``), per-row DMA
kernels that existed because XLA's TPU scatter serializes.  On the H100
both are csrc/row_scatter.cu: a group of W/4 threads per row moving
16-byte vectors, one launch per call (the TPU's 131,072-row slices came
from its SMEM size and have no counterpart).  They are bound by bytes.

The writer lands the sorted-dedup step's rows (ops/big_embed.
write_rows_unique); its targets are unique except the dummy row, which
only ever receives zeros.  The reader has no caller on the training path,
as in the JAX package (the forward gathers with ``index_select``);
chip_smoke.py holds it against its plain version.

Each wrapper takes the plain version on CPU tensors, launches the kernel
on CUDA tensors (counting each launch in its ``launches``) and raises on
anything the kernel does not take; there is no fallback.
"""

from __future__ import annotations

import torch


def row_writer_reference(w: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """The plain version of K5: ``w[idx] = vals`` in place; returns ``w``."""
    w[idx.long()] = vals
    return w


def row_reader_reference(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version of K6: ``w[idx]`` -> ``[E, W]``."""
    return w.index_select(0, idx.long())


def check_tensors(want, device: torch.device) -> None:
    """Raise ValueError unless every ``name: (tensor, dtype, shape)`` of
    ``want`` lies on ``device`` with that dtype and shape, contiguous."""
    for name, (x, dtype, shape) in want.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the table on {device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, the kernel takes {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _check(w: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, rows_name: str) -> None:
    """Device, dtype, shape and contiguity of a K5/K6 call; indices outside
    the table fault on the device (the kernel traps)."""
    if w.dim() != 2 or idx.dim() != 1 or w.shape[0] >= 2**31:
        raise ValueError("the kernels take a 2-D table of fewer than 2^31 rows and 1-D indices")
    E, W = idx.shape[0], w.shape[1]
    check_tensors({"w": (w, torch.float32, tuple(w.shape)), "idx": (idx, torch.int32, (E,)),
                   rows_name: (rows, torch.float32, (E, W))}, w.device)


def _device(w: torch.Tensor) -> bool:
    """True for a CUDA table, False for a CPU one; raises for any other."""
    if w.device.type == "cpu":
        return False
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    return True


def row_writer(w: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``w[idx[j]] = vals[j]`` in place through csrc/row_scatter.cu (one
    launch, counted in ``row_writer.launches``); ``idx`` unique apart from
    a dummy row that receives only zeros.  Returns ``w``."""
    if not _device(w):
        return row_writer_reference(w, idx, vals)
    _check(w, idx, vals, "vals")
    E, W = vals.shape
    if E == 0:
        return w
    from ._build import load_library

    err = load_library().row_write(
        w.data_ptr(), idx.data_ptr(), vals.data_ptr(), E, W, w.shape[0],
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"row_write launch failed: CUDA error {err}")
    row_writer.launches += 1
    return w


def row_reader(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[j] = w[idx[j]]`` through csrc/row_scatter.cu (one launch,
    counted in ``row_reader.launches``) -> ``[E, W]``."""
    if not _device(w):
        return row_reader_reference(w, idx)
    out = torch.empty((idx.shape[0], w.shape[-1]), dtype=torch.float32, device=w.device)
    _check(w, idx, out, "out")
    E, W = out.shape
    if E == 0:
        return out
    from ._build import load_library

    err = load_library().row_read(
        w.data_ptr(), idx.data_ptr(), out.data_ptr(), E, W, w.shape[0],
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"row_read launch failed: CUDA error {err}")
    row_reader.launches += 1
    return out


row_writer.launches = 0
row_reader.launches = 0
