"""The model's tables as named leaves, their seeded initial values, and the
checkpoint format both sides read and write.

A leaf is one table of the model.  Each model's leaves, their shapes,
which of them are factors and the order of the checkpoint's sections are
in ``portbench/layout/<model>.py``, found by the configuration's
``model``.  The benchmark makes the initial leaves on the device from the
seed and hands the same values to the program (as a checkpoint it loads)
and to the plain reference.

The checkpoint is SVDFeature's binary model section (apex_svd_model.h,
SVDModel::SaveModel / LoadModel): the 1056-byte SVDModelParam, then each
section in the layout's order, ``[n:int32][n f32]`` for a vector and
``[x:int32][y:int32][y rows of x f32]`` for a table.
"""

from __future__ import annotations

import importlib
import io
import struct
from typing import Dict

import numpy as np
import torch

PARAM_DTYPE = np.dtype([
    ("num_user", "<i4"), ("num_item", "<i4"), ("num_factor", "<i4"), ("num_global", "<i4"),
    ("u_init_sigma", "<f4"), ("i_init_sigma", "<f4"), ("base_score", "<f4"),
    ("no_user_bias", "<i4"), ("num_ufeedback", "<i4"), ("ufeedback_init_sigma", "<f4"),
    ("num_randinit_ufactor", "<i4"), ("num_randinit_ifactor", "<i4"),
    ("common_latent_space", "<i4"), ("user_nonnegative", "<i4"),
    ("common_feedback_space", "<i4"), ("extend_flag", "<i4"), ("item_nonnegative", "<i4"),
    ("reserved", "<i4", (247,)),
])
PARAM_DEFAULTS = dict(u_init_sigma=0.01, i_init_sigma=0.01, base_score=0.5,
                      ufeedback_init_sigma=0.0)


def layout(cfg: dict):
    """The model's leaf layout (``portbench/layout/<model>.py``)."""
    return importlib.import_module(f"portbench.layout.{cfg['model']}")


def shapes(cfg: dict) -> Dict[str, tuple]:
    """Each leaf's shape."""
    return layout(cfg).shapes(cfg["conf"])


def _param(cfg: dict, name: str) -> float:
    return float(cfg["conf"].get(name, PARAM_DEFAULTS.get(name, 0)))


def initial(cfg: dict, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The initial leaves, from ``seed`` on ``device``: the factor leaves
    normal with their init sigmas (one draw for all their rows), the other
    leaves zero."""
    sh = shapes(cfg)
    factors = layout(cfg).FACTORS
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    rows = sum(sh[n][0] for n in factors)
    width = sh[next(iter(factors))][1]
    z = torch.randn((rows, width), generator=gen, device=device, dtype=torch.float32)
    out, r0 = {}, 0
    for n, sigma in factors.items():
        out[n] = (z[r0:r0 + sh[n][0]] * _param(cfg, sigma)).to(dtype)
        r0 += sh[n][0]
    for n, s in sh.items():
        if n not in out:
            out[n] = torch.zeros(s, device=device, dtype=dtype)
    return out


def write_checkpoint(cfg: dict, leaves: Dict[str, torch.Tensor]) -> io.BytesIO:
    """The leaves as a model section, ready to load."""
    p = np.zeros((), PARAM_DTYPE)
    for name in PARAM_DTYPE.names[:-1]:
        p[name] = _param(cfg, name)
    f = io.BytesIO()
    f.write(p.tobytes())
    for name in layout(cfg).SECTIONS:
        a = leaves[name].detach().to("cpu", torch.float32).contiguous().numpy()
        f.write(struct.pack("<i", a.shape[0]) if a.ndim == 1 else struct.pack("<ii", a.shape[1],
                                                                               a.shape[0]))
        f.write(a.tobytes())
    f.seek(0)
    return f


def read_checkpoint(cfg: dict, data: bytes, device) -> Dict[str, torch.Tensor]:
    """The leaves of a model section written by the program, on ``device``."""
    sh = shapes(cfg)
    pos = PARAM_DTYPE.itemsize
    out = {}
    for name in layout(cfg).SECTIONS:
        if len(sh[name]) == 1:
            (n,) = struct.unpack_from("<i", data, pos)
            pos += 4
            shape = (n,)
        else:
            x, y = struct.unpack_from("<ii", data, pos)
            pos += 8
            shape = (y, x)
        if shape != sh[name]:
            raise ValueError(f"checkpoint leaf {name} has shape {shape}, {sh[name]} expected")
        count = int(np.prod(shape))
        a = np.frombuffer(data, "<f4", count, pos).reshape(shape)
        pos += 4 * count
        out[name] = torch.from_numpy(a.copy()).to(device)
    return out
