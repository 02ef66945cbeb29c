"""Indexed row copies of the big-table route: the Hopper kernels K5 (row
writer) and K6 (row reader), with their plain PyTorch versions.

Replace the TPU kernels svdfeature_tpu/ops/pallas_scatter.py
``row_writer`` (``_writer_kernel``: ``w[idx[j]] = vals[j]`` in place) and
``row_reader`` (``_reader_kernel``: ``out[j] = w[idx[j]]``), per-row DMA
kernels that existed because XLA's TPU scatter serializes.  On the H100
both are csrc/row_scatter.cu: a 2-D block, a row per ``threadIdx.y`` and a
16-byte column per ``threadIdx.x``, streaming loads and stores, one launch
per call (the TPU's 131,072-row slices came from its SMEM size and have
no counterpart).  They are bound by bytes; a call of one batch-4096 step
(8192 rows) is bound by the host, so the writer's per-call path is a
handful of attribute reads and one ctypes call.

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

import functools

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


# The current CUDA stream of a device index as a raw handle: the private
# call returns the integer itself, the public route builds a Stream object
# per call.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
_F32, _I32 = torch.float32, torch.int32


@functools.cache
def _entry_point(name: str):
    """A C entry point of the kernel library, built and bound at first use."""
    from ._build import load_library

    return getattr(load_library(), name)


def _check_write(w: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor):
    """The conditions of ``_check(w, idx, vals, "vals")`` as one chain of
    direct comparisons, no dict and no loop (a step of batch 4096 is bound
    by the host); when one fails, ``_check`` names it with its own message.
    Returns (E, W, n)."""
    shape, ishape, dev = w.shape, idx.shape, w.device
    if len(shape) == 2 and len(ishape) == 1:
        n, W = shape
        E = ishape[0]
        if (n < 2**31 and w.dtype is _F32 and idx.dtype is _I32 and vals.dtype is _F32
                and vals.shape == (E, W) and idx.device == dev and vals.device == dev
                and w.is_contiguous() and idx.is_contiguous() and vals.is_contiguous()):
            return E, W, n
    _check(w, idx, vals, "vals")
    raise ValueError("w, idx or vals failed the kernel's input checks")


def row_writer(w: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``w[idx[j]] = vals[j]`` in place through csrc/row_scatter.cu (one
    launch, counted in ``row_writer.launches``); ``idx`` unique apart from
    a dummy row that receives only zeros.  Returns ``w``.  Indices outside
    the table trap on the device."""
    if not w.is_cuda:
        if w.device.type != "cpu":
            raise ValueError(f"no kernel for device {w.device}")
        return row_writer_reference(w, idx, vals)
    E, W, n = _check_write(w, idx, vals)
    if E == 0:
        return w
    err = _entry_point("row_write")(
        w.data_ptr(), idx.data_ptr(), vals.data_ptr(), E, W, n, _raw_stream(w.device.index))
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
    err = _entry_point("row_read")(
        w.data_ptr(), idx.data_ptr(), out.data_ptr(), E, W, w.shape[0],
        _raw_stream(w.device.index))
    if err:
        raise RuntimeError(f"row_read launch failed: CUDA error {err}")
    row_reader.launches += 1
    return out


row_writer.launches = 0
row_reader.launches = 0
