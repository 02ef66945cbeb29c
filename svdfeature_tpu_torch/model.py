"""SVDModel: the parameter store, as a torch ``nn.Module``.

PyTorch counterpart of svdfeature_tpu/model.py (struct SVDModel,
apex_svd_model.h:481-706).  Same unified row space: one factor table
``w: [N, k]``, one bias table ``b: [N]`` and the global bias ``g: [G]``,
held as buffers (training is hand-written SGD, so nothing here is an
autograd parameter).  ``rand_init`` draws with the same numpy (or
bit-exact apex_random) generator in the same order, and ``save`` /
``load`` write and read the reference's binary checkpoint format, so a
seeded init and every ``%04d.model`` are byte-identical to the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Dict, Tuple

import numpy as np
import torch
from torch import nn

from . import losses
from .ops.embed import HyperParams, forward_scores
from .params import SVDModelParam, SVDTypeParam, svd_type


def _write_t1d(f: BinaryIO, arr: np.ndarray) -> None:
    """CTensor1D serialization: [x_max:int32][x_max float32]."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    f.write(struct.pack("<i", arr.shape[0]))
    f.write(arr.tobytes())


def _write_t2d(f: BinaryIO, arr: np.ndarray) -> None:
    """CTensor2D serialization: [x_max:int32][y_max:int32][rows of x_max f32]
    (x_max first, apex_tensor_cpu.h:102-106)."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    y, x = arr.shape
    f.write(struct.pack("<ii", x, y))
    f.write(arr.tobytes())


def _read_t1d(f: BinaryIO) -> np.ndarray:
    (x,) = struct.unpack("<i", f.read(4))
    return np.frombuffer(f.read(4 * x), dtype="<f4").copy() if x > 0 else np.zeros(0, np.float32)


def _read_t2d(f: BinaryIO) -> np.ndarray:
    x, y = struct.unpack("<ii", f.read(8))
    n = x * y
    if n > 0:
        return np.frombuffer(f.read(4 * n), dtype="<f4").reshape(y, x).copy()
    return np.zeros((y, x), np.float32)


class SVDModel(nn.Module):
    """Unified-table model.

    Row space of ``w`` / ``b``:
      [0, off_user)            user-feedback rows (if separate feedback space)
      [off_user, off_item)     user rows
      [off_item, num_rows)     item rows
    With common_latent_space=1 the whole table is shared (all offsets 0);
    with common_feedback_space=1 feedback rows alias user rows.
    """

    w: torch.Tensor
    b: torch.Tensor
    g: torch.Tensor

    def __init__(
        self,
        w: torch.Tensor,
        b: torch.Tensor,
        g: torch.Tensor,
        param: SVDModelParam,
        mtype: SVDTypeParam,
    ):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", b)
        self.register_buffer("g", g)
        self.param = param
        self.mtype = mtype

    # ---- layout ----------------------------------------------------------
    @staticmethod
    def layout(param: SVDModelParam, mtype: SVDTypeParam) -> Tuple[int, int, int, int]:
        """Return (num_rows, off_ufeedback, off_user, off_item).

        Mirrors SVDModel::alloc_space (apex_svd_model.h:511-556).
        """
        ustart = (
            param.num_ufeedback
            if (
                param.common_feedback_space == 0
                and mtype.format_type == svd_type.USER_GROUP_FORMAT
            )
            else 0
        )
        if param.common_latent_space == 0:
            n = ustart + param.num_user + param.num_item
            return n, 0, ustart, ustart + param.num_user
        if param.num_user != param.num_item:
            raise ValueError("num_user and num_item must be the same to use common latent space")
        if param.common_feedback_space == 0:
            raise ValueError("common latent space must enforce common feedback space")
        return param.num_item, 0, 0, 0

    @property
    def num_rows(self) -> int:
        return self.layout(self.param, self.mtype)[0]

    @property
    def off_ufeedback(self) -> int:
        return self.layout(self.param, self.mtype)[1]

    @property
    def off_user(self) -> int:
        return self.layout(self.param, self.mtype)[2]

    @property
    def off_item(self) -> int:
        return self.layout(self.param, self.mtype)[3]

    @property
    def num_factor(self) -> int:
        return self.param.num_factor

    # ---- forward -------------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Activated predictions ``[B]`` for one packed batch (``[B, S]``
        index/value planes of ``data.batching.pack_csr``, whose padding
        slots point at the dummy ids ``num_rows`` / ``num_global``)."""
        dev = self.w.device
        w = torch.cat([self.w, torch.zeros((1, self.num_factor), dtype=torch.float32, device=dev)])
        b = torch.cat([self.b, torch.zeros((1,), dtype=torch.float32, device=dev)])
        g = torch.cat([self.g, torch.zeros((1,), dtype=torch.float32, device=dev)])
        hp = HyperParams(
            active_type=self.mtype.active_type,
            no_user_bias=self.param.no_user_bias,
            base_score=float(self.param.base_score),
        )
        return forward_scores(w, b, g, batch, hp)

    # ---- construction ----------------------------------------------------
    @classmethod
    def rand_init(
        cls,
        param: SVDModelParam,
        mtype: SVDTypeParam,
        *,
        device: torch.device,
        seed: int = 10,
        exact_rng: bool = False,
    ) -> "SVDModel":
        """Gaussian init with the reference's ordering semantics
        (apex_svd_model.h:665-705), drawn on the host exactly as the JAX
        package draws it (numpy RandomState, or the bit-exact apex_random
        port with ``exact_rng``), then placed on ``device``.

        Transforms base_score through the inverse link exactly once.
        """
        n, off_fb, off_u, off_i = cls.layout(param, mtype)
        k = param.num_factor
        if exact_rng:
            from .utils.apex_random import ApexRandom

            rng = ApexRandom(seed)

            def normal(sigma, shape):
                # sd is a C float in the reference (SVDModelParam), so the
                # double multiply sees the f32-rounded sigma
                return rng.gaussian_array(shape, float(np.float32(sigma)))
        else:
            nprng = np.random.RandomState(seed)

            def normal(sigma, shape):
                return nprng.normal(0.0, sigma, shape)

        w = np.zeros((n, k), np.float32)

        # user factors
        nu = param.num_randinit_ufactor or param.num_user
        w[off_u : off_u + nu] = normal(param.u_init_sigma, (nu, k))
        if param.user_nonnegative:
            w[off_u : off_u + param.num_user] = np.abs(w[off_u : off_u + param.num_user])
        # item factors (skipped entirely when the latent space is shared)
        if param.common_latent_space == 0:
            ni = param.num_randinit_ifactor or param.num_item
            w[off_i : off_i + ni] = normal(param.i_init_sigma, (ni, k))
            if param.item_nonnegative:
                w[off_i : off_i + ni] = np.abs(w[off_i : off_i + ni])
        # feedback factors last — with a shared feedback space this
        # overwrites the user rows, exactly as the reference does
        if mtype.format_type == svd_type.USER_GROUP_FORMAT:
            nf = param.num_ufeedback
            if param.common_feedback_space == 0:
                w[off_fb : off_fb + nf] = normal(param.ufeedback_init_sigma, (nf, k))
            else:
                w[off_u : off_u + nf] = normal(param.ufeedback_init_sigma, (nf, k))

        param = dataclasses.replace(
            param,
            base_score=losses.calc_base_score(param.base_score, mtype.active_type),
        )
        return cls(
            w=torch.from_numpy(w).to(device),
            b=torch.zeros((n,), dtype=torch.float32, device=device),
            g=torch.zeros((param.num_global,), dtype=torch.float32, device=device),
            param=param,
            mtype=mtype,
        )

    # ---- reference-format binary IO ---------------------------------------
    def save(self, f: BinaryIO) -> None:
        """Write the SVDModel section (apex_svd_model.h:638-660)."""
        f.write(self.param.to_bytes())
        w = self.w.detach().cpu().numpy()
        b = self.b.detach().cpu().numpy()
        p = self.param
        _, off_fb, off_u, off_i = self.layout(p, self.mtype)
        if p.common_latent_space == 0:
            _write_t1d(f, b[off_u : off_u + p.num_user])
            _write_t2d(f, w[off_u : off_u + p.num_user])
            _write_t1d(f, b[off_i : off_i + p.num_item])
            _write_t2d(f, w[off_i : off_i + p.num_item])
        else:
            _write_t1d(f, b)
            _write_t2d(f, w)
        _write_t1d(f, self.g.detach().cpu().numpy())
        if self.mtype.format_type == svd_type.USER_GROUP_FORMAT and p.common_feedback_space == 0:
            _write_t1d(f, b[off_fb : off_fb + p.num_ufeedback])
            _write_t2d(f, w[off_fb : off_fb + p.num_ufeedback])

    @classmethod
    def load(cls, f: BinaryIO, mtype: SVDTypeParam, *, device: torch.device) -> "SVDModel":
        """Read the SVDModel section (apex_svd_model.h:570-633) onto ``device``."""
        param = SVDModelParam.from_bytes(f.read(SVDModelParam.NBYTES))
        n, off_fb, off_u, off_i = cls.layout(param, mtype)
        w = np.zeros((n, param.num_factor), np.float32)
        b = np.zeros((n,), np.float32)
        if param.common_latent_space == 0:
            b[off_u : off_u + param.num_user] = _read_t1d(f)
            w[off_u : off_u + param.num_user] = _read_t2d(f)
            b[off_i : off_i + param.num_item] = _read_t1d(f)
            w[off_i : off_i + param.num_item] = _read_t2d(f)
        else:
            b[:] = _read_t1d(f)
            w[:] = _read_t2d(f)
        g = _read_t1d(f)
        if len(g) != param.num_global:
            raise ValueError("global bias size mismatch")
        if mtype.format_type == svd_type.USER_GROUP_FORMAT and param.common_feedback_space == 0:
            b[off_fb : off_fb + param.num_ufeedback] = _read_t1d(f)
            w[off_fb : off_fb + param.num_ufeedback] = _read_t2d(f)
        return cls(
            w=torch.from_numpy(w).to(device),
            b=torch.from_numpy(b).to(device),
            g=torch.from_numpy(g).to(device),
            param=param,
            mtype=mtype,
        )
